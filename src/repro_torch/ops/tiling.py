"""Launch-shape heuristics for the hand-written CUDA kernels.

The JAX package sizes Pallas blocks against a TPU VMEM budget. The CUDA
kernels of this port compute one output element per thread and mask their
own ragged edge, so the one launch parameter is the thread-block size,
and the constraint is filling an H100's 132 streaming multiprocessors:

  * a block is a whole number of 32-thread warps;
  * 256 threads (8 warps) per block once the grid has at least one such
    block per SM — enough resident warps to hide memory latency;
  * below that, the smallest warp multiple that spreads the outputs
    over as many SMs as they fill, so a small serving batch is not
    packed onto a few SMs while the rest idle (with fewer than 132 warps
    of outputs, some SMs get none).

The addition tree (``tree_reduce_sum``) is the exception to one thread
per output: one block reduces one row, so its block is the smallest warp
multiple that gives each of the tree's first-level pairs a thread. The
JAX ``rb`` row block has no counterpart: the grid is one block per row,
so no row padding is needed.

Resolution order: ``ExecPolicy.tiling`` overrides (bare ``threads`` or
namespaced ``<op>.threads``) > these heuristics. The JAX ``TuningCache``
waits for the measured autotuner (ROADMAP §A.7).
"""
from __future__ import annotations

from typing import Mapping

__all__ = ["H100_SMS", "WARP", "MAX_THREADS", "TREE_MAX_ETA",
           "launch_threads", "choose_conv_blocks", "choose_fused_blocks",
           "choose_qmatmul_blocks", "choose_tree_blocks", "tile_params",
           "block_threads"]

H100_SMS = 132
WARP = 32
MAX_THREADS = 256
# the addtree kernel stages a row in two ping-pong fp32 buffers of η in
# dynamic shared memory: 2·4·6144 bytes is the 48 KB a block gets without
# opting in to more
TREE_MAX_ETA = 6144


def launch_threads(outputs: int, sms: int = H100_SMS) -> int:
    """Threads per block for a one-thread-per-output kernel."""
    per_sm = -(-max(outputs, 1) // sms)
    return min(MAX_THREADS, max(WARP, -(-per_sm // WARP) * WARP))


def choose_conv_blocks(bsz: int, m: int, ho: int, wo: int) -> dict[str, int]:
    """conv_window: one thread per (b, m, oh, ow) conv output."""
    return {"threads": launch_threads(bsz * m * ho * wo)}


def choose_fused_blocks(bsz: int, m: int, ho: int, wo: int
                        ) -> dict[str, int]:
    """fused_cwp: one thread per *pooled* output; each thread computes
    the 2×2 conv window behind it, so the grid is a quarter of the conv's."""
    return {"threads": launch_threads(bsz * m * (ho // 2) * (wo // 2))}


def choose_qmatmul_blocks(m: int, n: int) -> dict[str, int]:
    """qmatmul: one thread per (row, column) of the (M, N) output."""
    return {"threads": launch_threads(m * n)}


def choose_tree_blocks(eta: int) -> dict[str, int]:
    """addtree: one block per row, whatever the row count; one thread per
    first-level pair (⌈η/2⌉), rounded up to whole warps and capped at
    ``MAX_THREADS`` (wider levels loop over the block)."""
    pairs = -(-max(eta, 1) // 2)
    return {"threads": min(MAX_THREADS, -(-pairs // WARP) * WARP)}


def tile_params(op: str, defaults: Mapping[str, int],
                overrides: Mapping[str, int] | None = None
                ) -> dict[str, int]:
    """Heuristic ``defaults`` with ``overrides`` applied: bare keys apply
    to any op that knows them, ``"<op>.<key>"`` keys to one op and win."""
    merged = dict(defaults)
    ov = dict(overrides or {})
    for k, v in ov.items():
        if "." not in k and k in defaults:
            merged[k] = int(v)
    for k, v in ov.items():
        name = k.split(".", 1)
        if len(name) == 2 and name[0] == op and name[1] in defaults:
            merged[name[1]] = int(v)
    return merged


def block_threads(op: str, defaults: Mapping[str, int],
                  overrides: Mapping[str, int] | None = None) -> int:
    """The resolved ``threads`` of ``tile_params``, checked against what
    a launch takes: whole warps, at most 1024 threads."""
    t = tile_params(op, defaults, overrides)["threads"]
    if t < WARP or t > 1024 or t % WARP:
        raise ValueError(f"{op}: threads per block {t} must be a multiple "
                         f"of {WARP} in [{WARP}, 1024]")
    return t
