"""Wrapper of the fused conv+requant+bias+relu+pool CUDA kernel.

Registered as the ``cuda`` backend of the ``fused_conv_block`` op family
(repro_torch.ops). On a CUDA tensor ``fused_cwp`` checks its arguments
and launches ``csrc/fused_cwp.cu`` on the current stream, or raises; on a
CPU tensor it runs the plain version (``ref.py``); on a meta tensor it
returns an empty output and charges the kernel's work (``charge_meta``:
2 operations a window MAC, fp32 or int8 by the operands' dtype, each
input read and the pooled output written once).

Two routes of one kernel source: fp32 operands (fp32, Q8.8 values, or
int8 codes held as fp32) take the fp32 route on the CUDA cores; int8
codes (``torch.int8`` x and w, with the requant ``scale``) take the int8
route on the s8 tensor cores, with no cast. ``launches`` counts kernel
launches of either route and nothing else; ``launches_int8`` counts those
of the int8 route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.window import pool_output_size
from repro_torch.kernels.build import load
from repro_torch.kernels.common import (charge_meta, check_conv_operands,
                                       check_tensor, launch, launch_args,
                                       ptr, refuse_grad)
from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
from repro_torch.ops.policy import ExecPolicy, current_policy
from repro_torch.ops.tiling import conv_s8_tiles, fused_tiles, platform_key

__all__ = ["fused_cwp", "launches", "launches_int8"]

launches = 0
launches_int8 = 0


@functools.cache
def _launcher():
    fn = load("fused_cwp").fused_cwp_launch
    fn.argtypes = launch_args(5, 17)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher_s8():
    fn = load("fused_cwp").fused_cwp_s8_launch
    fn.argtypes = launch_args(5, 14)
    fn.restype = ctypes.c_int
    return fn


def fused_cwp(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
              *, stride: tuple[int, int] = (1, 1),
              scale: torch.Tensor | None = None, odd: str = "raise",
              policy: ExecPolicy | None = None) -> torch.Tensor:
    """x: (B,N,H,W) · w: (M,N,Kh,Kw), both f32 or both int8 codes ->
    (B,M,Po,Qo) f32: VALID conv, ``×scale`` (M,) when given (the int8
    requant epilogue on integer-valued codes; required with int8 codes),
    ``+b`` (M,) when given, relu, 2×2/2 max pool. An odd conv output dim
    follows ``odd`` as ``core.window.maxpool2`` does: ``'raise'`` raises
    ValueError before any launch, ``'drop'`` drops the last row/column,
    ``'pad'`` pools it against -inf."""
    global launches, launches_int8
    dev = x.device
    check_conv_operands("fused_cwp", x, w, scale, needs_scale=True)
    dt = getattr(x, "dtype", torch.float32)
    check_tensor(x, "x", dtype=dt, ndim=4, device=dev)
    check_tensor(w, "w", dtype=dt, ndim=4, device=dev)
    bsz, n, h, wd = x.shape
    m, n2, kh, kw = w.shape
    for name, v in (("b", b), ("scale", scale)):
        if v is not None:
            check_tensor(v, name, dtype=torch.float32, ndim=1, device=dev)
            if v.shape[0] != m:
                raise ValueError(f"{name} has {v.shape[0]} entries for "
                                 f"{m} output channels")
    sh, sw = stride
    if n != n2 or h < kh or wd < kw or sh < 1 or sw < 1:
        raise ValueError(f"conv shapes x={tuple(x.shape)} "
                         f"w={tuple(w.shape)} stride={tuple(stride)}")
    refuse_grad("fused_cwp", x, w, b, scale)
    ho, wo = (h - kh) // sh + 1, (wd - kw) // sw + 1
    po, qo = pool_output_size(ho, odd), pool_output_size(wo, odd)
    codes = x.dtype == torch.int8
    if dev.type == "cpu":
        return fused_cwp_ref(x, w, b, tuple(stride), odd=odd, scale=scale)
    if dev.type == "meta":
        vec = sum(m for v in (b, scale) if v is not None)
        size = 1 if codes else 4
        charge_meta("fused_cwp", ops=2 * bsz * m * ho * wo * n * kh * kw,
                    dtype=x.dtype,
                    nbytes=size * (x.numel() + w.numel())
                    + 4 * (vec + bsz * m * po * qo))
        return torch.empty((bsz, m, po, qo), dtype=torch.float32,
                           device=dev)
    pol = policy if policy is not None else current_policy()
    if pol.autotune:
        from repro_torch.ops.autotune import ensure_tuned
        ensure_tuned("fused_conv_block", x, w, b, stride=tuple(stride),
                     odd=odd, scale=scale, policy=pol)
    out = torch.empty((bsz, m, po, qo), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if codes:
        t = conv_s8_tiles(bsz, n, h, wd, m, kh, kw, sh, sw,
                          pol.tile_overrides, odd=odd,
                          platform=platform_key(dev))
        launch(_launcher_s8(), "fused_cwp", dev, ptr(x), ptr(w), ptr(scale),
               ptr(b), ptr(out), bsz, n, h, wd, m, kh, kw, sh, sw, t["cpb"],
               t["band"], t["items"], t["smem"], int(odd == "pad"))
        launches += 1
        launches_int8 += 1
        return out
    t = fused_tiles(bsz, n, h, wd, m, kh, kw, sh, sw, pol.tile_overrides,
                    odd=odd, platform=platform_key(dev))
    launch(_launcher(), "fused_cwp", dev, ptr(x), ptr(w), ptr(scale), ptr(b),
           ptr(out), bsz, n, h, wd, m, kh, kw, sh, sw, t["threads"], t["cpb"],
           t["band"], t["split"], t["ipb"], t["ld"], t["smem"],
           int(odd == "pad"))
    launches += 1
    return out
