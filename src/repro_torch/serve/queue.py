"""FIFO admission queue for the serve engine (DESIGN.md §6, §11); port
of ``repro.serve.queue``.

Deliberately minimal: arrival order is service order (head-of-line), which
matches the paper's streaming-input model — the window pipeline consumes
pixels in raster order; the engine consumes requests in arrival order.
Priority policies belong in the front-end's ``SchedulerCore``
(repro_torch.serve.frontend), not here.

``maxlen`` makes the queue a backpressure point: a full queue refuses the
add with a typed ``QueueFullError`` instead of growing without bound (or
worse, silently dropping) — the caller decides whether to shed, retry, or
surface the rejection upstream.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

from repro_torch.serve.request import Request, RequestState

__all__ = ["QueueFullError", "RequestQueue"]


class QueueFullError(RuntimeError):
    """Typed intake rejection: the queue is at ``maxlen``. Raised instead
    of blocking (a hang) or dropping (a lie) — backpressure the caller
    can catch, count, and act on."""

    def __init__(self, size: int, maxlen: int):
        super().__init__(
            f"request queue full ({size}/{maxlen}): admission refused — "
            f"retry after completions free space or raise max_queue")
        self.size = size
        self.maxlen = maxlen


class RequestQueue:
    def __init__(self, requests: Iterable[Request] = (),
                 maxlen: int | None = None):
        if maxlen is not None and maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        self._q: deque[Request] = deque()
        for r in requests:
            self.add(r)

    def add(self, request: Request) -> None:
        if request.state is not RequestState.QUEUED:
            raise ValueError(f"request {request.uid} is {request.state}, "
                             "only QUEUED requests can be enqueued")
        if self.maxlen is not None and len(self._q) >= self.maxlen:
            raise QueueFullError(len(self._q), self.maxlen)
        self._q.append(request)

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request | None:
        return self._q[0] if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self) -> Iterator[Request]:
        return iter(self._q)
