"""A CUDA graph per bucket: the port's counterpart of the AOT executable
cache (DESIGN.md §12).

The reference serves each bucket through an XLA executable compiled
ahead of time (``repro.artifact.aot``). On the card the cost it removes
is not compilation but dispatch: a bound plan's call walks the graph in
Python and launches every kernel (and every small PyTorch op) one by
one. ``capture_graph`` records one bucket's whole bound-plan call into a
``torch.cuda.CUDAGraph`` on a static input buffer, after the kernels are
built (nvcc) and the plan has run once on a side stream; serving then
copies a micro-batch in, replays the graph, and copies the static output
out. The graph lives in-process only, cached under
``executable_key(fingerprint, shape)``, so every engine of the process
that boots the same plan for the same bucket replays one graph.

Nothing falls back: a capture or replay that fails raises. The kernels'
C launchers launch on the current PyTorch stream (``kernels.common``),
opt in to large shared memory once per device and size (never during a
capture), and no op on a plan's path syncs with the host, which is what
capture needs.

The wrappers' launch counters tick when a kernel is captured, not when a
replay runs it: ``BucketGraph.kernels`` records how many launches of
each kernel one replay makes, and the serving engine counts its
replays, so the launches a served workload made are their product.
"""
from __future__ import annotations

import torch

from repro_torch.artifact.warmup import phase

__all__ = ["BucketGraph", "capture_graph", "executable_key",
           "cached_graph", "cache_graph", "clear_graph_cache",
           "kernel_launch_counts"]


def kernel_launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch counter, by kernel name, and the conv
    kernels' int8-route launches (``<kernel>_int8``, included in the
    kernel's own)."""
    import repro_torch.kernels.addtree.ops as at
    import repro_torch.kernels.conv_window.ops as cw
    import repro_torch.kernels.fused_cwp.ops as fc
    import repro_torch.kernels.qmatmul.ops as qm
    return {"fused_cwp": fc.launches, "conv_window": cw.launches,
            "qmatmul": qm.launches, "addtree": at.launches,
            "fused_cwp_int8": fc.launches_int8,
            "conv_window_int8": cw.launches_int8}


class BucketGraph:
    """One bucket's captured bound-plan call: a static input of the
    bucket's shape, the graph, and the static output it writes."""

    def __init__(self, bound, shape: tuple[int, ...]):
        self.bound = bound          # keeps the captured tensors alive
        self.shape = tuple(shape)
        self.x = torch.zeros(self.shape, dtype=torch.float32,
                             device=bound.device)
        self.graph = torch.cuda.CUDAGraph()
        self.out: torch.Tensor | None = None
        # kernel launches one replay makes (counted at capture)
        self.kernels: dict[str, int] = {}

    def run(self, batch) -> torch.Tensor:
        """Copy ``batch`` (k ≤ bucket images) into the static input, zero
        the pad lanes behind it, replay, and return the static output.
        The next replay overwrites it: copy what you keep first. Fresh
        zeros in every pad lane keep a short batch's result independent
        of an earlier, fuller one (an int8 activation scale is the absmax
        of the whole padded batch)."""
        batch = torch.as_tensor(batch)
        k = batch.shape[0]
        if k > self.shape[0] or tuple(batch.shape[1:]) != self.shape[1:]:
            raise ValueError(f"batch of shape {tuple(batch.shape)} does not "
                             f"fit the bucket's static input {self.shape}")
        self.x[:k].copy_(batch)
        self.x[k:].zero_()
        self.graph.replay()
        return self.out


def capture_graph(bound, shape) -> BucketGraph:
    """Build the kernels, run ``bound`` once on a side stream (first
    launches, cuBLAS workspaces), then capture one call on a static
    input; all timed as the warmup report's ``compile`` phase. Raises if
    the plan's params are not on a CUDA device, or if any step fails."""
    from repro_torch.kernels.build import build
    if bound.device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a plan bound on the card; "
                         f"its params are on {bound.device}")
    g = BucketGraph(bound, shape)
    with phase("compile"), torch.inference_mode():
        build()
        side = torch.cuda.Stream(device=g.x.device)
        side.wait_stream(torch.cuda.current_stream(g.x.device))
        with torch.cuda.stream(side):
            bound(g.x)
        torch.cuda.current_stream(g.x.device).wait_stream(side)
        before = kernel_launch_counts()
        with torch.cuda.graph(g.graph):
            g.out = bound(g.x)
        g.kernels = {k: v - before[k]
                     for k, v in kernel_launch_counts().items()}
    return g


# ---------------------------------------------------------------------------
# in-process per-fingerprint graph cache

_GRAPH_CACHE: dict[tuple, BucketGraph] = {}


def executable_key(fingerprint: str, input_shape, device) -> tuple:
    """The graph cache's key: one plan (by content) at one float32 input
    shape on one device."""
    return (fingerprint, tuple(int(s) for s in input_shape),
            str(torch.device(device)))


def cached_graph(key: tuple) -> BucketGraph | None:
    return _GRAPH_CACHE.get(key)


def cache_graph(key: tuple, graph: BucketGraph) -> None:
    _GRAPH_CACHE[key] = graph


def clear_graph_cache() -> None:
    _GRAPH_CACHE.clear()
