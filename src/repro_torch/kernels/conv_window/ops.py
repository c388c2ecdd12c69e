"""Wrapper of the window conv CUDA kernel.

Registered as the ``cuda`` backend of the ``conv2d`` op family
(repro_torch.ops). On a CUDA tensor ``conv_window`` checks its arguments
and launches ``csrc/conv_window.cu`` on the current stream, or raises; on
a CPU tensor it runs the plain version (``ref.py``). ``launches`` counts
kernel launches and nothing else.

Every call goes through ``ConvWindowFn``: its forward is the kernel
launch (or, on the CPU, the plain version), so the training forward of
the CNN runs on the kernel; its backward is the VALID strided conv's
gradient in plain PyTorch ops. Outside autograd (no grad, or no input
that requires it) the Function records nothing. The reference has no backward Pallas kernel (JAX
differentiates its conv), so neither is there a backward kernel here; a
hand-written one is kernel work for later (ROADMAP §B).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import check_tensor, launch, launch_args, ptr
from repro_torch.kernels.conv_window.ref import conv2d_window_ref
from repro_torch.ops.policy import ExecPolicy, current_policy
from repro_torch.ops.tiling import fused_tiles, platform_key

__all__ = ["conv_window", "ConvWindowFn", "launches"]

launches = 0


@functools.cache
def _launcher():
    fn = load("conv_window").conv_window_launch
    fn.argtypes = launch_args(4, 16)
    fn.restype = ctypes.c_int
    return fn


class ConvWindowFn(torch.autograd.Function):
    """The window conv with a gradient: forward = ``conv_window``'s launch
    (the plain version on the CPU); backward = the input and weight
    gradients of a VALID strided conv (``torch.nn.grad``; cuDNN on the
    card, TF32 off as ``repro_torch.ops.impls`` sets it) and the bias
    gradient as a sum over batch and space."""

    @staticmethod
    def forward(ctx, x, w, b, stride, policy):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.has_b = stride, b is not None
        return _conv_window(x, w, b, stride=stride, policy=policy)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w, g, ctx.stride)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(x, w.shape, g, ctx.stride)
        if ctx.has_b and ctx.needs_input_grad[2]:
            gb = g.sum(dim=(0, 2, 3))
        return gx, gw, gb, None, None


def conv_window(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None = None, *,
                stride: tuple[int, int] = (1, 1),
                policy: ExecPolicy | None = None) -> torch.Tensor:
    """x: (B,N,H,W) f32 · w: (M,N,Kh,Kw) f32 -> (B,M,Ho,Wo) f32, VALID
    padding, ``+b`` (M,) when given. Differentiable (``ConvWindowFn``)."""
    return ConvWindowFn.apply(x, w, b, tuple(stride), policy)


def _conv_window(x, w, b, *, stride, policy) -> torch.Tensor:
    """The launch (or, on the CPU, the plain version)."""
    global launches
    dev = x.device
    check_tensor(x, "x", dtype=torch.float32, ndim=4, device=dev)
    check_tensor(w, "w", dtype=torch.float32, ndim=4, device=dev)
    bsz, n, h, wd = x.shape
    m, n2, kh, kw = w.shape
    if b is not None:
        check_tensor(b, "b", dtype=torch.float32, ndim=1, device=dev)
        if b.shape[0] != m:
            raise ValueError(f"b has {b.shape[0]} entries for {m} output "
                             f"channels")
    sh, sw = stride
    if n != n2 or h < kh or wd < kw or sh < 1 or sw < 1:
        raise ValueError(f"conv shapes x={tuple(x.shape)} "
                         f"w={tuple(w.shape)} stride={tuple(stride)}")
    if dev.type == "cpu":
        return conv2d_window_ref(x, w, b, stride=tuple(stride))
    ho, wo = (h - kh) // sh + 1, (wd - kw) // sw + 1
    pol = policy if policy is not None else current_policy()
    if pol.autotune:
        from repro_torch.ops.autotune import ensure_tuned
        ensure_tuned("conv2d", x, w, b, stride=tuple(stride), policy=pol)
    t = fused_tiles(bsz, n, h, wd, m, kh, kw, sh, sw, pol.tile_overrides,
                    pool=False, platform=platform_key(dev))
    out = torch.empty((bsz, m, ho, wo), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    launch(_launcher(), "conv_window", dev, ptr(x), ptr(w), ptr(b), ptr(out),
           bsz, n, h, wd, m, kh, kw, sh, sw, t["threads"], t["cpb"],
           t["band"], t["split"], t["ipb"], t["ld"], t["smem"])
    launches += 1
    return out
