"""The traced stretch: a ``torch.profiler`` run of the cell's own loop, read
back from its Chrome trace into device operations, host events, busy
time, idle gaps and a breakdown.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. The stretch runs the loop between two syncs; where
the device ran anything, the span is from its first operation's start to
its last one's end, else the host span ``SPAN`` around the loop. Host
events are the CUDA runtime's calls and, where the profile records the
host (``host=True``), PyTorch's operators and the harness's spans: that
costs some microseconds an operator, enough to make the host the
bottleneck of a loop of small batches, so the resident cells record the
device and the runtime's calls alone.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import torch

__all__ = ["SPAN", "DEVICE_CATS", "Op", "Trace", "profile", "parse",
           "union_seconds"]

SPAN = "chipbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclass(frozen=True)
class Op:
    name: str
    cat: str
    ts: float       # microseconds, the trace's clock
    dur: float      # microseconds


def union_seconds(ops: list[Op], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] (microseconds) covered by at least one op."""
    return sum(b - a for a, b in _union(ops, lo, hi)) * 1e-6


def _union(ops, lo, hi) -> list[tuple[float, float]]:
    spans = sorted((max(o.ts, lo), min(o.ts + o.dur, hi)) for o in ops)
    out: list[list[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Trace:
    """The device and host events of one traced stretch."""

    device_ops: list = field(default_factory=list)   # [Op], in the span
    host_ops: list = field(default_factory=list)     # [Op], in the span
    start: float = 0.0                               # the span, microseconds
    end: float = 0.0
    replays: int = 0                                 # batches in the span

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_seconds(self.device_ops, self.start, self.end)

    def seconds(self, match) -> float:
        """Device seconds of the ops whose name ``match`` accepts."""
        return sum(o.dur for o in self.device_ops if match(o.name)) * 1e-6

    def idle_gaps(self, top: int = TOP) -> list[tuple[str, float]]:
        """The ``top`` longest stretches of the span with no device op,
        longest first, each named by the innermost host event under its
        middle."""
        edges = [self.start]
        for a, b in _union(self.device_ops, self.start, self.end):
            edges += [a, b]
        edges.append(self.end)
        gaps = sorted(((b - a, a) for a, b in zip(edges[::2], edges[1::2])
                       if b > a), reverse=True)[:top]
        return [(self._host_at(a + d / 2), d * 1e-6) for d, a in gaps]

    def _host_at(self, t: float) -> str:
        best = None
        for o in self.host_ops:
            if o.ts <= t <= o.ts + o.dur and o.name != SPAN and (
                    best is None or o.dur < best.dur):
                best = o
        return best.name if best is not None else "host: no event"

    def breakdown(self) -> dict:
        """The device ops that took most time (summed by name) and the
        longest idle gaps, at most ``TOP`` of each, in seconds."""
        by_name: dict[str, float] = {}
        for o in self.device_ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + o.dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": [[_short(n), s]
                              for n, s in self.idle_gaps()]}


def _short(name: str, keep: int = 160) -> str:
    return name if len(name) <= keep else name[:keep] + "..."


def parse(doc: dict) -> Trace:
    """The stretch of a Chrome trace and the events inside it."""
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    ops = [Op(e["name"], e.get("cat", ""), float(e["ts"]), float(e["dur"]))
           for e in events]
    dev = [o for o in ops if o.cat in DEVICE_CATS]
    if dev:
        lo = min(o.ts for o in dev)
        hi = max(o.ts + o.dur for o in dev)
    else:
        span = [o for o in ops if o.name == SPAN]
        lo, hi = (span[0].ts, span[0].ts + span[0].dur) if span else (0, 0)
    host = [o for o in ops if o.cat in HOST_CATS
            and o.ts + o.dur >= lo and o.ts <= hi]
    return Trace(device_ops=dev, host_ops=host, start=lo, end=hi)


def profile(fn, device, path: Path, host: bool = False) -> Trace:
    """Run ``fn()`` between two syncs under ``torch.profiler``, write the
    Chrome trace to ``path`` and read it back. On the card it records the
    device's operations and the CUDA runtime's calls, and with ``host``
    PyTorch's host operators too; on the CPU, the host."""
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if cuda:
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            fn()
            if cuda:
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return parse(json.load(f))
