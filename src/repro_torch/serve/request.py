"""Request objects flowing through the continuous-batching engine (port
of ``repro.serve.request``).

A request's life (DESIGN.md §6): QUEUED in the ``RequestQueue`` ->
admitted by the ``Scheduler`` into a KV-cache slot (RUNNING) -> one
generated token per engine step -> FINISHED (max tokens, EOS, or slot
budget exhausted) and its slot immediately refilled from the queue.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

__all__ = ["RequestState", "Request"]


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class Request:
    """One generation request.

    ``prompt`` is a 1-D int32 token array; ``max_new_tokens`` bounds the
    decode budget. ``generated``/``slot``/timing fields are engine-owned.
    """

    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token: int | None = None

    state: RequestState = RequestState.QUEUED
    slot: int | None = None
    generated: list[int] = field(default_factory=list)
    truncated: bool = False          # hit the slot's max_seq before budget
    enqueue_step: int = -1           # engine step counters, for latency stats
    admit_step: int = -1
    finish_step: int = -1

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array, "
                             f"got shape {self.prompt.shape}")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def num_generated(self) -> int:
        return len(self.generated)

    def is_done(self) -> bool:
        if self.num_generated >= self.max_new_tokens:
            return True
        if (self.eos_token is not None and self.generated
                and self.generated[-1] == self.eos_token):
            return True
        return self.truncated
