"""Wrapper of the odd-even addition-tree CUDA kernel.

Registered as the ``cuda`` backend of the ``tree_reduce_sum`` op family
(repro_torch.ops). On a CUDA tensor ``tree_reduce_sum`` checks its
argument and launches ``csrc/addtree.cu`` on the current stream, or
raises; on a CPU tensor it runs the plain version (``ref.py``).
``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.addtree.ref import tree_reduce_sum_ref
from repro_torch.kernels.build import load
from repro_torch.kernels.common import (check_tensor, launch, launch_args,
                                       ptr, refuse_grad)
from repro_torch.ops.policy import ExecPolicy, current_policy
from repro_torch.ops.tiling import TREE_MAX_ETA, tree_tiles

__all__ = ["tree_reduce_sum", "launches"]

launches = 0
_MAX_ROWS = 2 ** 31 - 1          # R travels to the kernel as a 32-bit int


@functools.cache
def _launcher():
    fn = load("addtree").addtree_launch
    fn.argtypes = launch_args(2, 6)
    fn.restype = ctypes.c_int
    return fn


def tree_reduce_sum(x: torch.Tensor, *,
                    policy: ExecPolicy | None = None) -> torch.Tensor:
    """(R, η) f32 -> (R,) f32: odd-even pairwise tree sum along the last
    axis, 1 <= η <= ``TREE_MAX_ETA``."""
    global launches
    dev = x.device
    check_tensor(x, "x", dtype=torch.float32, ndim=2, device=dev)
    r, eta = x.shape
    if not 1 <= eta <= TREE_MAX_ETA:
        raise ValueError(f"row width {eta}: the kernel takes 1 <= eta <= "
                         f"{TREE_MAX_ETA}")
    if r > _MAX_ROWS:
        raise ValueError(f"{r} rows: the kernel takes at most {_MAX_ROWS}")
    refuse_grad("tree_reduce_sum", x)
    if dev.type == "cpu":
        return tree_reduce_sum_ref(x)
    pol = policy if policy is not None else current_policy()
    t = tree_tiles(r, eta, pol.tile_overrides)
    out = torch.empty((r,), dtype=torch.float32, device=dev)
    if r == 0:
        return out
    launch(_launcher(), "addtree", dev, ptr(x), ptr(out), r, eta,
           t["threads"], t["rows"], t["short_eta"], t["row_lanes"])
    launches += 1
    return out
