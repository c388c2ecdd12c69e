"""Slot scheduler: admit queued requests into free KV slots, evict finished
ones (DESIGN.md §6); port of ``repro.serve.scheduler``.

The scheduling objective is the paper's pipeline-occupancy argument lifted
from clock cycles to requests: the batched decode step costs the same
whether 1 or C slots are live, so throughput is proportional to occupancy,
and the scheduler's whole job is to keep occupancy at C. Admission is FIFO
(head-of-line from the ``RequestQueue``); eviction is immediate on finish,
with the freed slot eligible for refill in the *same* engine step —
in-flight batch refill, the continuous-batching property.

Request-level ordering policy (deadlines, EDF, backpressure) lives one
layer up in the front-end's ``SchedulerCore`` (repro_torch.serve.frontend,
DESIGN.md §11): the front-end injects at most ``free_slots`` requests per
step in its chosen order, so this slot allocator stays a pure
capacity/occupancy mechanism.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import Request, RequestState

__all__ = ["SchedulerStats", "Scheduler"]


@dataclass
class SchedulerStats:
    admitted: int = 0
    finished: int = 0
    truncated: int = 0
    occupancy_ticks: list[int] = field(default_factory=list)

    def mean_occupancy(self) -> float:
        if not self.occupancy_ticks:
            return 0.0
        return sum(self.occupancy_ticks) / len(self.occupancy_ticks)


class Scheduler:
    """Fixed-capacity slot allocator over the engine's KV cache ring.

    Free slots are recycled LIFO so a just-evicted slot (whose cache lines
    are hottest) is reused first; correctness never depends on slot history
    because admission overwrites positions [0, prompt_len) and the
    per-slot ``kv_len`` mask hides everything beyond the write head.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self._running: dict[int, Request] = {}
        self._rejected: list[Request] = []
        self.stats = SchedulerStats()

    # ---------- inspection ----------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def num_running(self) -> int:
        return len(self._running)

    def running(self) -> dict[int, Request]:
        return dict(self._running)

    def request_in(self, slot: int) -> Request | None:
        return self._running.get(slot)

    # ---------- transitions ----------
    def admit(self, queue: RequestQueue, *, max_prompt_len: int | None = None
              ) -> list[Request]:
        """Pop queued requests into free slots until either runs out.

        ``max_prompt_len``: prompts that cannot fit a slot at all are
        rejected — FINISHED with truncated=True and zero generated tokens,
        collected via ``drain_rejected`` so the caller can report them
        rather than lose them.
        """
        admitted = []
        while self._free and queue:
            req = queue.pop()
            if (max_prompt_len is not None
                    and req.prompt_len > max_prompt_len):
                req.state = RequestState.FINISHED
                req.truncated = True
                self.stats.truncated += 1
                self._rejected.append(req)
                continue
            slot = self._free.pop()
            req.slot = slot
            req.state = RequestState.RUNNING
            self._running[slot] = req
            self.stats.admitted += 1
            admitted.append(req)
        return admitted

    def drain_rejected(self) -> list[Request]:
        """Requests rejected at admission since the last drain."""
        out, self._rejected = self._rejected, []
        return out

    def evict(self, slot: int) -> Request:
        """Release a finished (or force-evicted) request's slot."""
        req = self._running.pop(slot)
        req.state = RequestState.FINISHED
        req.slot = None
        self._free.append(slot)
        self.stats.finished += 1
        if req.truncated:
            self.stats.truncated += 1
        return req

    def tick(self) -> None:
        """Record occupancy for this engine step (throughput accounting)."""
        self.stats.occupancy_ticks.append(self.num_running)
