"""One ``ServeStats`` shape for every serving stack (DESIGN.md §11).

Port of ``repro.serve.stats``. Engines populate the same core counters
— steps, items of real work, issued real/pad lanes, timed wall
seconds — and the front-end layers its request-level
accounting (latency percentiles, goodput, deadline misses, backpressure
rejections) onto the *same object*, so one dataclass describes a serving
stack end to end.

Semantics of the core counters:

* ``items`` — units of served work: tokens for the LM engine (prompt
  tokens prefilled + tokens decoded), images for the vision engine.
* ``lane_steps`` — issued compute lanes that carried real work (active
  decode lanes / real image lanes).
* ``pad_lanes`` — issued dead lanes (idle KV slots in a decode step,
  batch padding in a vision step). ``lane_steps + pad_lanes`` is total
  issued work; ``lane_utilization`` is the paper's occupancy argument as
  a single number.
* ``wall_s`` — clock time inside timed engine steps (via the Clock seam,
  ``repro_torch.serve.clock``; under a ``VirtualClock`` this is virtual
  time).

Latency percentiles use the nearest-rank method — deterministic, no
interpolation, so virtual-time tests can assert them exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["percentile", "ServeStats"]


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of an unsorted list.
    Empty input returns 0.0 — stats objects start life with no samples."""
    if not values:
        return 0.0
    if not 0 <= q <= 100:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    ordered = sorted(values)
    rank = max(1, -(-len(ordered) * q // 100))      # ceil without floats
    return ordered[int(rank) - 1]


@dataclass
class ServeStats:
    # ---- engine-populated core (every engine fills all of these) ----
    steps: int = 0                # timed engine steps
    items: int = 0                # units of served work (tokens | images)
    lane_steps: int = 0           # issued lanes carrying real work
    pad_lanes: int = 0            # issued dead lanes (idle slots | padding)
    wall_s: float = 0.0           # clock time inside engine steps

    # ---- front-end-populated request accounting (serve.frontend) ----
    submitted: int = 0            # accepted into the intake queue
    rejected: int = 0             # refused at intake (QueueFullError)
    completed: int = 0            # results delivered
    deadline_misses: int = 0      # completed after their deadline
    latencies: list = field(default_factory=list)   # seconds, per request
    first_t: float | None = None  # first submit (clock timestamp)
    last_t: float | None = None   # last completion (clock timestamp)

    # ---- engine-core derived ----
    @property
    def items_per_s(self) -> float:
        return self.items / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def lane_utilization(self) -> float:
        """Fraction of issued lanes that carried real work."""
        issued = self.lane_steps + self.pad_lanes
        return self.lane_steps / issued if issued else 0.0

    @property
    def pad_fraction(self) -> float:
        """Fraction of issued lanes that were dead padding."""
        issued = self.lane_steps + self.pad_lanes
        return self.pad_lanes / issued if issued else 0.0

    # ---- front-end derived (SLO report) ----
    @property
    def span_s(self) -> float:
        """First submit → last completion, in clock time — the window
        goodput is measured over."""
        if self.first_t is None or self.last_t is None:
            return 0.0
        return max(0.0, self.last_t - self.first_t)

    def latency_p(self, q: float) -> float:
        return percentile(self.latencies, q)

    @property
    def p50_s(self) -> float:
        return self.latency_p(50)

    @property
    def p95_s(self) -> float:
        return self.latency_p(95)

    @property
    def p99_s(self) -> float:
        return self.latency_p(99)

    @property
    def miss_rate(self) -> float:
        return self.deadline_misses / self.completed if self.completed else 0.0

    @property
    def goodput_rps(self) -> float:
        """Completed-within-deadline requests per second of serving span —
        the number the paper's occupancy argument ultimately cashes out
        as: work the *user* got, per unit time."""
        good = self.completed - self.deadline_misses
        return good / self.span_s if self.span_s > 0 else 0.0
