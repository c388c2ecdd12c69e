"""Step graphs: the port's counterpart of the reference's ``jax.jit``
around its LM and train steps.

The reference compiles each step once for each static shape: the
engine's prefill (one executable per prompt length) and decode step, the
train step, each over donated buffers that XLA updates in place. On the
card the cost that compilation removes is host dispatch, so the port's
compiled step is a ``torch.cuda.CUDAGraph``: ``StepGraph`` holds a step
function and its static input and state buffers, and on its first call

* builds the kernels (nvcc) and runs the step once on a side stream,
  so every kernel launch shape has run (its ``cudaFuncSetAttribute``
  shared-memory opt-in included, which must never run inside a capture)
  and cuBLAS and cuDNN have their handles and workspaces;
* puts back the state buffers the warm-up wrote (a clone taken before
  it), so the first replay is the first step;
* captures one call into a graph, in an optional memory pool shared with
  the other graphs of one owner (they never run at once).

Each call then copies new inputs into the static buffers, replays, and
returns the static outputs, which the next replay of this graph or of a
graph that shares its pool overwrites: read them first. The step
function writes its new state into the state buffers itself
(``copy_tree``), which is the port's ``donate_argnums``: the buffers
stay at fixed addresses, so a caller must never rebind them.

Nothing falls back: on a CUDA device a capture or replay that fails
raises. On the CPU the same object calls the step function on the same
static buffers without any capture, so the CPU tests exercise the buffer
logic the graph relies on. A policy that autotunes is refused: the tuner
measures launches, which a capture cannot hold; tune first (a
``TuningCache``), then serve the tuned tiles.

Launches are counted as the vision graphs count theirs
(``artifact/aot.py``): the kernel wrappers' counters tick at the
warm-up and at the capture, ``kernels`` holds the launches one replay
makes, and ``calls`` counts the replays, so the launches the replays made
are their product (``graph_launches``).
"""
from __future__ import annotations

import gc
from typing import Any, Callable

import torch

from repro_torch.artifact.aot import kernel_launch_counts
from repro_torch.artifact.warmup import phase
from repro_torch.serve.clock import MonotonicClock

__all__ = ["StepGraph", "copy_tree", "tree_tensors", "graph_launches",
           "train_graph"]


def tree_tensors(tree) -> list[torch.Tensor]:
    """Every tensor of a nest of dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def copy_tree(dst, src) -> None:
    """Write each tensor of ``src`` into the same leaf of ``dst`` in
    place (dtype and device converted as ``copy_`` does); a leaf that
    already is ``dst``'s is left alone."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"tree keys differ: {sorted(dst)} vs "
                             f"{sorted(src)}")
        for k in dst:
            copy_tree(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        if len(dst) != len(src):
            raise ValueError(f"{len(dst)} leaves vs {len(src)}")
        for d, s in zip(dst, src):
            copy_tree(d, s)
    elif isinstance(dst, torch.Tensor):
        if dst is not src:
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"a static buffer of shape "
                                 f"{tuple(dst.shape)} cannot take "
                                 f"{tuple(src.shape)}")
            dst.copy_(src)
    elif dst != src:
        raise ValueError(f"a static non-tensor leaf {dst!r} cannot take "
                         f"{src!r}")


class StepGraph:
    """``fn(**inputs)`` over static buffers, captured once on the card.

    inputs: name -> a tensor or a tree of tensors (dicts, tuples), the
    static buffers ``fn`` reads; a call's keyword arguments are copied
    into them. state: the tensors ``fn`` writes in place (a subset of the
    inputs' trees), put back after the warm-up. pool: a
    ``torch.cuda.graph_pool_handle()`` shared with graphs that never run
    at the same time as this one."""

    def __init__(self, fn: Callable[..., Any], inputs: dict, *,
                 device: torch.device, state=(), pool=None, policy=None,
                 compiled: bool = True, name: str = "step"):
        self.fn = fn
        self.inputs = inputs
        self.device = torch.device(device)
        # a graph on the card; False (or the CPU): fn on the same buffers
        self.compiled = compiled and self.device.type == "cuda"
        self.state = tree_tensors(state)
        self.pool = pool
        self.name = name
        if self.compiled and policy is not None and policy.autotune:
            raise ValueError(
                f"{name}: a CUDA graph cannot capture an autotuning policy "
                f"(the tuner measures launches); tune first and serve the "
                f"TuningCache's tiles with autotune=False")
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: Any = None
        self.kernels: dict[str, int] = {}   # launches one replay makes
        self.calls = 0                      # replays (the CPU: calls)
        self.capture_s = 0.0
        self.pool_bytes = 0                 # memory the capture reserved
        self.released = False

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def release(self) -> None:
        """Drop the graph, its outputs and its static buffers (an evicted
        graph: its counts stay readable, and a call raises)."""
        self.graph = self.out = None
        self.inputs, self.state = {}, []
        self.released = True

    def __call__(self, **new) -> Any:
        if self.released:
            raise RuntimeError(f"{self.name}: called after release(); "
                               f"build the graph again")
        unknown = set(new) - set(self.inputs)
        if unknown:
            raise TypeError(f"{self.name}: no static input named "
                            f"{sorted(unknown)}")
        for k, v in new.items():
            copy_tree(self.inputs[k], v)
        self.calls += 1
        if not self.compiled:
            return self.fn(**self.inputs)
        if self.graph is None:
            self.capture()
        self.graph.replay()
        return self.out

    def capture(self) -> None:
        """Build, warm on a side stream, restore the state, capture."""
        from repro_torch.kernels.build import build
        if not self.compiled:
            raise ValueError(f"{self.name}: not a compiled step (a CUDA "
                             f"graph needs the card; buffers on "
                             f"{self.device})")
        clock = MonotonicClock()
        t0 = clock.now()
        with phase("compile"), torch.cuda.device(self.device):
            build()
            cur = torch.cuda.current_stream(self.device)
            saved = [t.clone() for t in self.state]
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.fn(**self.inputs)
            cur.wait_stream(side)
            for t, s in zip(self.state, saved):
                t.copy_(s)
            del saved
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            before = kernel_launch_counts()
            graph = torch.cuda.CUDAGraph()
            # the cycle collector must not run inside the capture: a
            # dropped graph it frees there (an engine left in a reference
            # cycle) destroys its executable, which invalidates the capture
            collecting = gc.isenabled()
            gc.collect()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    self.out = self.fn(**self.inputs)
            finally:
                if collecting:
                    gc.enable()
            self.kernels = {k: v - before[k]
                            for k, v in kernel_launch_counts().items()}
            self.pool_bytes = torch.cuda.memory_reserved(self.device) \
                - reserved
            self.graph = graph
        self.capture_s = clock.now() - t0


def graph_launches(graphs) -> dict[str, int]:
    """Kernel launches made by the replays of ``graphs``: each one's
    captured launches × its calls."""
    out: dict[str, int] = {}
    for g in graphs:
        for k, v in g.kernels.items():
            out[k] = out.get(k, 0) + v * g.calls
    return out


def train_graph(step_fn: Callable, params: dict, opt_state: dict,
                batch: dict, *, device, compiled: bool = True
                ) -> StepGraph:
    """A train step as one ``StepGraph`` for this (batch, seq,
    microbatches): the static buffers are ``params``, ``opt_state`` and
    a copy of ``batch`` on ``device`` (each call copies the next batch
    in, from the host or the device); the step ends by
    copying the new params, moments and step counter into them, and
    returns the metrics. ``params`` and ``opt_state`` therefore always
    hold the latest step's values, where a checkpoint reads them.
    ``compiled`` False runs the step eagerly on the same buffers."""

    def step(params, opt_state, batch):
        new_params, new_opt, metrics = step_fn(params, opt_state, batch)
        copy_tree(params, new_params)
        copy_tree(opt_state, new_opt)
        return metrics

    batch = {k: v.to(device, copy=True) for k, v in batch.items()}
    return StepGraph(step, {"params": params, "opt_state": opt_state,
                            "batch": batch},
                     state=(params, opt_state), device=device,
                     compiled=compiled, name="train")
