"""The benchmark's harness: finds a cell's files by name, builds the
program under test from the seed, drives it for a fixed window and judges
its outputs against the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``chipbench/configs/<config>.json``: the model's sizes, the port's model
  class that runs them, and its execution policy;
* ``chipbench/traffic/<traffic>.json``: one of the kinds in ``KINDS``
  with its parameters (batch, ring, rates, clients, ...);
* ``chipbench/metrics/<metric>.py``: a reader with ``read(ctx)`` that
  returns the metric from the run's spans, counters and trace, or None
  where it finds nothing to read.

The program is ``repro_torch`` alone: its model classes, its compile and
bind, and its CUDA graph capture. The reference (``chipbench.reference``)
imports nothing of it.
"""
from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from chipbench import reference

__all__ = ["ROOT", "HERE", "KINDS", "Cell", "Context", "load_manifest",
           "find_cell", "load_metric", "param_shapes", "make_params",
           "make_images", "build_model", "policy", "compile_bound",
           "capture", "sync", "compare_logits", "reference_logits",
           "per_layer", "run_cell", "device_doc", "host_bursts",
           "await_steady"]

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
KINDS = ("resident", "served_closed", "served_open")
# where a traced run writes its profile (inside the checkout, ignored by git)
TRACE_DIR = Path("build") / "chipbench"
# host spans of BucketGraph.run: bursts of calls from an idle device
HOST_BURSTS, HOST_CALLS = 20, 32
# seconds of the profiled stretch after a resident window
TRACE_S = 0.25
# A fresh CUDA context on the H100 the cells were measured on replays
# every graph 2-7% slower until it is 5-70 s old, under load or idle
# alike (PERF.md). A resident window opens once the replay rate has risen
# by STEP_RISE for two seconds in a row, or once the context is
# CONTEXT_AGE_S old, whichever comes first; set-up ends before that wait.
CONTEXT_AGE_S = 120.0
STEP_RISE = 0.015


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int = 1
    # names of the per-layer metrics this cell reports
    metrics: list = field(default_factory=list)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return _read_json(Path(root) / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest, with its configuration's and its
    traffic's files read."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    traffic = _read_json(Path(root) / "chipbench" / "traffic"
                         / f"{entry['traffic']}.json")
    if traffic.get("kind") not in KINDS:
        raise ValueError(f"traffic {entry['traffic']!r}: kind "
                         f"{traffic.get('kind')!r} is not one of {KINDS}")
    return Cell(name=name, config=_read_json(Path(root) / cfg_entry["file"]),
                traffic=traffic, chips=int(entry.get("chips", 1)),
                metrics=[m["name"] for m in manifest["per_layer"]
                         if _applies(m, name)])


def load_metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``."""
    path = Path(root) / "chipbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "chipbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- inputs

def param_shapes(config: dict) -> dict[tuple[str, ...], tuple[int, ...]]:
    """{leaf path: shape} of the configuration's weights, in the layout the
    port's models take: conv ``w`` (M, N, K, K), ``b`` (M,); fc ``w``
    (K, N), ``b`` (N,)."""
    c, h, w = config["input"]
    shapes = {}
    for layer in config["layers"]:
        m, k = layer["out_channels"], layer["kernel"]
        shapes[(layer["param"], "w")] = (m, c, k, k)
        shapes[(layer["param"], "b")] = (m,)
        c, h, w = m, (h - k + 1) // 2, (w - k + 1) // 2
    fc = config["fc"]
    shapes[(fc["w"],)] = (c * h * w, fc["out_features"])
    shapes[(fc["b"],)] = (fc["out_features"],)
    return shapes


def make_params(config: dict, gen: torch.Generator, device) -> dict:
    """Random fp32 weights from ``gen`` in one draw on ``device``: weights
    N(0, 1/fan_in), biases N(0, 0.1^2)."""
    shapes = param_shapes(config)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    params: dict = {}
    start = 0
    for (path, shape), n in zip(shapes.items(), sizes):
        leaf = flat[start:start + n].view(shape)
        start += n
        fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
        leaf = leaf * (fan_in ** -0.5 if len(shape) > 1 else 0.1)
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return params


def make_images(config: dict, gen: torch.Generator, batches: int,
                batch: int, device) -> torch.Tensor:
    """(batches, batch, C, H, W) fp32 pixels uniform in [0, 1), one draw."""
    return torch.rand((batches, batch, *config["input"]), generator=gen,
                      device=device)


# ---------------------------------------------------------------- program

def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def build_model(config: dict):
    """The port's model of the configuration: ``program.model`` of
    ``program.module``, over its config class built from ``fields``."""
    prog = config["program"]
    mod = importlib.import_module(prog["module"])
    fields = {k: _tuples(v) for k, v in prog["fields"].items()}
    return getattr(mod, prog["model"])(getattr(mod, prog["config"])(**fields))


def policy(config: dict):
    from repro_torch.ops.policy import ExecPolicy
    return ExecPolicy(**config["policy"])


def compile_bound(config: dict, params: dict, batch: int):
    """``model.compile(...).bind(params)``: the compile ``VisionEngine``
    runs for a bucket of ``batch`` images."""
    model = build_model(config)
    plan = model.compile(policy=policy(config), fuse=config["fuse"],
                         batch=batch, autotune=config["autotune"],
                         stream_budget=config["stream_budget"])
    return plan.bind(params)


class EagerReplay:
    """``capture``'s stand-in off the card: the bound plan called on a
    static input. Used where the tests drive a run on the CPU."""

    def __init__(self, bound, shape):
        self.bound = bound
        self.x = torch.zeros(shape, dtype=torch.float32, device=bound.device)
        self.out = None

    def run(self, batch):
        self.x.copy_(batch)
        self.out = self.bound(self.x)
        return self.out


def capture(bound, shape):
    """The program's CUDA graph of one bucket (``BucketGraph``)."""
    if bound.device.type != "cuda":
        return EagerReplay(bound, shape)
    from repro_torch.artifact.aot import capture_graph
    return capture_graph(bound, shape)


def sync(device) -> None:
    """Wait for the card; nothing to wait for on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- check

def compare_logits(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The widest gap between the program's logits and the reference's,
    and how many rows differ at all."""
    diff = (got.to(torch.float32) - want).abs()
    return {"gap": float(diff.max()),
            "rows_off": int((diff.amax(dim=-1) > 0).sum())}


def reference_logits(params, images, config, bits):
    """The reference's logits of one batch, with TF32 off."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            return reference.forward(params, images, config, bits=bits)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


# ---------------------------------------------------------------- context

@dataclass
class Context:
    """What a per-layer reader may read."""

    config: dict
    traffic: dict
    batch: int
    images: int = 0             # completed in the window
    window_s: float = 0.0       # the measured window, host clock
    replays: int = 0            # batches issued in the window
    trace: object = None        # chipbench.trace.Trace of the traced stretch
    host_us: list = field(default_factory=list)   # per-call host spans


def per_layer(cell: Cell, ctx: Context, root: Path = ROOT) -> dict:
    """Every per-layer metric of the cell that its reader finds, with its
    unit from the manifest."""
    units = {m["name"]: m["unit"] for m in load_manifest(root)["per_layer"]}
    out = {}
    for name in cell.metrics:
        value = load_metric(name, root).read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": units.get(name, "")}
    return out


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- runs

def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device="cuda", t_process: float | None = None,
             t_context: float | None = None, control: bool = False,
             root: Path = ROOT) -> dict:
    """One run of ``cell``: set-up, the wait for the steady rate (with
    ``t_context``), the window, the traced stretch (with ``trace``), then
    the check. Returns the result's dict, with the compared numbers under
    ``check``. ``control`` puts the reference in the 4-bit format in the
    program's place, which the check must refuse (the control of
    ``chipbench/control.py``; no benchmark run sets it). ``t_process`` and
    ``t_context`` are the process's start and the CUDA context's creation
    on ``time.perf_counter``'s clock; set-up is measured from the first,
    and a resident window waits for the steady rate (``await_steady``)
    only where the second is given, as ``run.py`` gives it."""
    kind = cell.traffic["kind"]
    if t_process is None:
        t_process = time.perf_counter()
    if kind == "resident":
        return _run_resident(cell, seed, seconds, trace, device, t_process,
                             t_context, control, root)
    from chipbench import served
    return served.run(cell, seed=seed, seconds=seconds, trace=trace,
                      device=device, t_process=t_process, control=control,
                      root=root)


def device_doc(device, count: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def host_bursts(step, *, bursts: int, calls: int, device) -> list[float]:
    """Host seconds of each of ``bursts`` x ``calls`` calls of ``step(i)``,
    each burst started on an idle device and short enough that the launch
    queue never fills, so a span is the host's own cost of the call."""
    spans = []
    for b in range(bursts):
        sync(device)
        for i in range(calls):
            t = time.perf_counter()
            step(b * calls + i)
            spans.append(time.perf_counter() - t)
    sync(device)
    return spans


def await_steady(step, n: int, t_context: float,
                 max_age: float = CONTEXT_AGE_S) -> int:
    """Run ``step(n)``, ``step(n + 1)``, ... until the steps a second have
    risen by ``STEP_RISE`` over the median of the seconds before (the
    first second, which fills the launch queue, left out) for two seconds
    in a row, or until the context is ``max_age`` seconds old. A median,
    so that one slow second is no step. Logs the rates and the wait;
    returns the next step's index."""
    rates, k = [], 0
    t = start = time.perf_counter()
    rose = False
    while time.perf_counter() - t_context < max_age:
        step(n)
        n, k = n + 1, k + 1
        now = time.perf_counter()
        if now - t < 1.0:
            continue
        rates.append(k / (now - t))
        t, k = now, 0
        if len(rates) >= 4:
            level = statistics.median(rates[1:-2])
            if min(rates[-2:]) > level * (1.0 + STEP_RISE):
                rose = True
                break
    _log(f"steady: {'rate rose' if rose else 'no rise seen'} at context "
         f"age {time.perf_counter() - t_context:.1f} s after a wait of "
         f"{time.perf_counter() - start:.1f} s; steps a second: "
         f"{[round(r, 1) for r in rates]}")
    return n


def _run_resident(cell, seed, seconds, trace, device, t_process, t_context,
                  control, root) -> dict:
    """Batches already on the card, replayed back to back: the ring of
    ``ring`` distinct input batches of ``batch`` images, each replay's
    logits copied into a ring of logits on the card, one sync at the end
    of the window. Set-up ends with the first replay; with ``t_context``
    the window waits for the steady rate (``await_steady``)."""
    cfg, trf = cell.config, cell.traffic
    b, r = int(trf["batch"]), int(trf["ring"])
    n_out = cfg["fc"]["out_features"]
    marks = [("start", t_process),
             ("imports and context", time.perf_counter())]
    gen = torch.Generator(device=device).manual_seed(seed)
    params = make_params(cfg, gen, device)
    ring = make_images(cfg, gen, r, b, device)
    sync(device)
    marks.append(("weights and ring", time.perf_counter()))
    with torch.inference_mode():
        bound = compile_bound(cfg, params, b)
        marks.append(("compile and bind", time.perf_counter()))
        replay = capture(bound, (b, *cfg["input"]))
        marks.append(("build and capture", time.perf_counter()))
        logits = torch.zeros((r, b, n_out), device=device)

        inputs, outputs = list(ring), list(logits)

        def step(i):
            outputs[i % r].copy_(replay.run(inputs[i % r]))

        step(0)
        sync(device)
        marks.append(("first replay", time.perf_counter()))
        setup_s = marks[-1][1] - t_process
        _log("setup: " + ", ".join(
            f"{name} {t - marks[i][1]:.3f} s"
            for i, (name, t) in enumerate(marks[1:])))
        w = await_steady(step, 1, t_context) if t_context is not None else 1
        sync(device)
        t0 = time.perf_counter()
        n = w
        while True:
            step(n)
            n += 1
            # a window ends after whole passes of the ring at least once
            if n - w >= r and time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        window_s = time.perf_counter() - t0
        # the last pass wrote every slot once
        last = n % r
        n -= w
        ctx = Context(cfg, trf, b, images=n * b, window_s=window_s,
                      replays=n)
        out = {"correct": False, "attempted": n * b, "failed": 0}
        if trace:
            from chipbench.trace import profile
            reps = max(r, math.ceil(TRACE_S * n / window_s / r) * r)

            def stretch():
                for i in range(reps):
                    step(last + i)

            ctx.trace = profile(stretch, device, root / TRACE_DIR
                                / f"{cell.name}.json")
            ctx.trace.replays = reps
            ctx.host_us = [1e6 * s for s in host_bursts(
                lambda i: replay.run(inputs[i % r]), device=device,
                bursts=HOST_BURSTS, calls=HOST_CALLS)]
        dev = device_doc(device, cell.chips)
        del replay, bound
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    t_check = time.perf_counter()
    out["failed"], check = _check_resident(cfg, params, ring, logits,
                                           control)
    _log(f"check: {time.perf_counter() - t_check:.3f} s")
    out["correct"] = all(c["value"] <= c["limit"] for c in check.values())
    if trace:
        out["metrics"] = per_layer(cell, ctx, root)
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        out["device"] = dev
        out["breakdown"] = ctx.trace.breakdown()
    else:
        out["metrics"] = {
            "images_per_s": {"value": n * b / window_s, "unit": "images/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        out["device"] = dev
    out["check"] = check
    return out


# the widest gap allowed between the program's and the reference's
# logits: the int8 datapath is exact integer sums under fp32 epilogues
# with the same roundings, so the program must reproduce it bit for bit
LOGIT_GAP_LIMIT = 0.0


def _check_resident(cfg, params, ring, logits, control) -> tuple[int, dict]:
    """Every ring batch's logits from the window's last pass against the
    reference's for that batch, one batch at a time."""
    gap, off = 0.0, 0
    for slot in range(ring.shape[0]):
        want = reference_logits(params, ring[slot], cfg, 8)
        got = (reference_logits(params, ring[slot], cfg, 4) if control
               else logits[slot])
        c = compare_logits(got, want)
        gap, off = max(gap, c["gap"]), off + c["rows_off"]
    return off, {"logit_gap": {"value": gap, "limit": LOGIT_GAP_LIMIT},
                 "rows_off": {"value": off, "limit": 0}}
