"""Typed intake rejection (DESIGN.md §11).

Port of ``repro.serve.queue``'s ``QueueFullError``; the LM engine's FIFO
``RequestQueue`` waits for the LM slice (ROADMAP §A.11).
"""
from __future__ import annotations

__all__ = ["QueueFullError"]


class QueueFullError(RuntimeError):
    """The queue is at ``maxlen``: raised instead of blocking (a hang) or
    dropping (a lie) — backpressure the caller can catch and count."""

    def __init__(self, size: int, maxlen: int):
        super().__init__(
            f"request queue full ({size}/{maxlen}): admission refused — "
            f"retry after completions free space or raise max_queue")
        self.size = size
        self.maxlen = maxlen
