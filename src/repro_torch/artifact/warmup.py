"""Time-to-ready attribution for plan boot (DESIGN.md §12).

Port of ``repro.artifact.warmup``. A serving replica's cold start is a
fixed pipeline — trace → fuse → place → tune → compile → first dispatch —
and the plan artifact store drives the first four phases to **zero**. On
the card ``compile`` is the kernels' nvcc build plus each bucket's CUDA
graph capture, and ``first_dispatch`` the first replay. An ambient
``WarmupReport`` (a contextvar) collects what the pipeline writes through
``phase(name)`` blocks.

Outside a ``collect_warmup()`` block every ``phase`` is a no-op with no
ambient state touched, so the hooks in ``repro_torch.graph.plan`` and
``repro_torch.serve.vision`` cost nothing on the hot path.

``launch/serve.py --warmup-report`` prints the breakdown; a replica
booted with ``--plan-artifact`` shows ``trace``/``fuse``/``place``/
``tune`` at 0 calls — the "zero-compilation boot".

Stdlib-only: it sits below the graph compiler in the import graph
(``repro_torch.graph.plan`` imports it), the rest of
``repro_torch.artifact`` above.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass, field

__all__ = ["PHASES", "WarmupReport", "collect_warmup", "phase",
           "current_report"]

# the canonical cold-start pipeline, in execution order. "artifact" is
# the phase the store adds (manifest + payload load, AOT deserialize);
# it replaces the first five when a replica boots from an artifact.
PHASES = ("trace", "fuse", "place", "tune", "compile", "artifact",
          "first_dispatch")


@dataclass
class WarmupReport:
    """Per-phase wall seconds + call counts for one boot."""

    seconds: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    total_s: float = 0.0

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def phase_s(self, name: str) -> float:
        return self.seconds.get(name, 0.0)

    def phase_calls(self, name: str) -> int:
        return self.counts.get(name, 0)

    def zero_compile(self) -> bool:
        """True when no derivation work ran: the artifact-boot invariant
        (trace/fuse/place/tune never invoked)."""
        return all(self.phase_calls(p) == 0
                   for p in ("trace", "fuse", "place", "tune"))

    def pretty(self) -> str:
        lines = ["time-to-ready breakdown:"]
        for name in PHASES:
            lines.append(f"  {name:<14} {self.phase_s(name) * 1e3:9.1f} ms"
                         f"  ({self.phase_calls(name)} calls)")
        accounted = sum(self.seconds.values())
        lines.append(f"  {'other':<14} "
                     f"{max(self.total_s - accounted, 0.0) * 1e3:9.1f} ms")
        lines.append(f"  {'total':<14} {self.total_s * 1e3:9.1f} ms")
        return "\n".join(lines)


_ACTIVE: contextvars.ContextVar[WarmupReport | None] = \
    contextvars.ContextVar("repro_torch_warmup_report", default=None)


def current_report() -> WarmupReport | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def collect_warmup():
    """Collect phase timings for the dynamic extent of the block. Nested
    collectors shadow the outer one (each boot gets its own report)."""
    report = WarmupReport()
    token = _ACTIVE.set(report)
    t0 = time.perf_counter()
    try:
        yield report
    finally:
        report.total_s = time.perf_counter() - t0
        _ACTIVE.reset(token)


@contextlib.contextmanager
def phase(name: str):
    """Attribute the block's wall time to ``name`` in the ambient report
    (no-op when no ``collect_warmup`` is active)."""
    report = _ACTIVE.get()
    if report is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        report.add(name, time.perf_counter() - t0)
