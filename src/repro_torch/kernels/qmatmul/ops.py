"""Wrapper of the int8 GEMM CUDA kernel.

Registered as the ``cuda`` backend of the ``qmatmul`` op family
(repro_torch.ops). On a CUDA tensor ``qmatmul`` checks its arguments and
launches ``csrc/qmatmul.cu`` on the current stream, or raises; on a CPU
tensor it runs the plain version (``ref.py``). ``launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import (check_tensor, launch, launch_args,
                                       ptr, refuse_grad)
from repro_torch.kernels.qmatmul.ref import qmatmul_ref
from repro_torch.ops.policy import ExecPolicy, current_policy
from repro_torch.ops.tiling import platform_key, qmatmul_tiles

__all__ = ["qmatmul", "launches"]

launches = 0


@functools.cache
def _launcher():
    fn = load("qmatmul").qmatmul_launch
    fn.argtypes = launch_args(5, 9)
    fn.restype = ctypes.c_int
    return fn


def _scale(s, shape: tuple[int, int], dev: torch.device) -> torch.Tensor:
    """A scalar or ``shape``-shaped f32 scale as a contiguous ``shape``."""
    s = torch.as_tensor(s, dtype=torch.float32, device=dev)
    if s.ndim < 2:
        s = s.reshape(-1)
        if s.numel() != 1:
            raise ValueError(f"scale of {s.numel()} entries; expected a "
                             f"scalar or shape {shape}")
        return s.expand(shape).contiguous()
    if tuple(s.shape) != shape:
        raise ValueError(f"scale shape {tuple(s.shape)}, expected {shape}")
    return s.contiguous()


def qmatmul(x_codes: torch.Tensor, w_codes: torch.Tensor, x_scale,
            w_scale, *, out_dtype: torch.dtype = torch.float32,
            policy: ExecPolicy | None = None) -> torch.Tensor:
    """(M,K) int8 · (K,N) int8 -> (M,N) ``out_dtype`` = (acc · x_scale) ·
    w_scale with an int32 accumulator; x_scale (M,1)|scalar, w_scale
    (1,N)|scalar. The kernel writes f32; another dtype is a cast after
    it, as the reference's ``.astype`` after its epilogue."""
    global launches
    dev = x_codes.device
    check_tensor(x_codes, "x_codes", dtype=torch.int8, ndim=2, device=dev)
    check_tensor(w_codes, "w_codes", dtype=torch.int8, ndim=2, device=dev)
    m, k = x_codes.shape
    k2, n = w_codes.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x_codes {tuple(x_codes.shape)}"
                         f" · w_codes {tuple(w_codes.shape)}")
    xs = _scale(x_scale, (m, 1), dev)
    ws = _scale(w_scale, (1, n), dev)
    refuse_grad("qmatmul", xs, ws)
    if dev.type == "cpu":
        return qmatmul_ref(x_codes, w_codes, xs, ws, out_dtype)
    pol = policy if policy is not None else current_policy()
    if pol.autotune:
        from repro_torch.ops.autotune import ensure_tuned
        ensure_tuned("qmatmul", x_codes, w_codes, xs, ws, policy=pol)
    t = qmatmul_tiles(m, k, n, pol.tile_overrides,
                      platform=platform_key(dev))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out.to(out_dtype)
    launch(_launcher(), "qmatmul", dev, ptr(x_codes), ptr(w_codes), ptr(xs),
           ptr(ws), ptr(out), m, n, k, t["threads"], t["rows"], t["cols"],
           t["kslice"], t["ld"], t["smem"])
    launches += 1
    return out.to(out_dtype)
