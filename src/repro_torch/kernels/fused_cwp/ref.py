"""Plain PyTorch version of the fused_cwp kernel: the unfused chain.

conv (im2col fp32 contraction) → [requant ``scale``] → ``+bias`` → relu →
2×2/2 max pool, each step a separate PyTorch op, so the epilogue rounds
twice exactly like the kernel's ``__fadd_rn(__fmul_rn(acc, s), b)``.
int8 codes are contracted as the integer-valued fp32 the reference takes
(``f32_codes``), bitwise to the kernel's exact int32 sums.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import conv_epilogue, f32_codes
from repro_torch.core.window import conv2d_im2col, maxpool2

__all__ = ["fused_cwp_ref"]


def fused_cwp_ref(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None,
                  stride: tuple[int, int] = (1, 1), odd: str = "raise",
                  scale: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B,N,H,W) · w: (M,N,Kh,Kw) -> (B,M,Po,Qo); odd conv output dims
    per ``core.window.maxpool2``."""
    out = conv_epilogue(conv2d_im2col(f32_codes(x), f32_codes(w), None,
                                      tuple(stride)), scale, b)
    return maxpool2(torch.relu(out), odd=odd)
