"""The Clock seam: every serving-layer timestamp goes through here
(DESIGN.md §11).

Port of ``repro.serve.clock``, unchanged in behaviour.

The front-end's whole job is time-sensitive scheduling — arrival
timestamps, deadlines, hold-for-top-up decisions, latency percentiles —
and none of that is testable against the wall clock: a test that sleeps
is slow, and a test that races real time is flaky. So the serving layer
never calls ``time.*`` directly; this module is the one place that
does. Everything takes an injectable ``Clock``:

* ``MonotonicClock`` — production: ``time.monotonic`` / ``time.sleep``.
* ``VirtualClock`` — tests and simulation: time is a number that moves
  only when somebody calls ``sleep``/``advance``. The entire request
  lifecycle (arrival → queue wait → dispatch → completion) becomes a
  deterministic, replayable function of the workload script: run it
  twice, get bitwise-identical latency traces.

This is the paper's clock-domain discipline in software: the window
pipeline is specified in *cycles*, not seconds, which is exactly what
makes its timing analyzable; ``VirtualClock`` gives the scheduler the
same property.
"""
from __future__ import annotations

import time

__all__ = ["Clock", "MonotonicClock", "VirtualClock"]


class Clock:
    """Interface: ``now() -> float`` seconds and ``sleep(dt)``."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        raise NotImplementedError


class MonotonicClock(Clock):
    """Wall time. ``now`` is monotonic (never steps backward on NTP
    adjustments — latency math must not see negative durations)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class VirtualClock(Clock):
    """Deterministic simulated time: ``now`` returns a counter that
    advances only via ``sleep``/``advance``. Negative advances raise —
    virtual time is monotonic like the real thing."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        self.advance(dt)

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"virtual time cannot move backward (dt={dt})")
        self._t += float(dt)
