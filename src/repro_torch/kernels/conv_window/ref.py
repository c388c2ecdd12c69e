"""Plain PyTorch version of the conv_window kernel.

The same function as ``csrc/conv_window.cu``: VALID strided conv through
the im2col contraction (one fp32 matmul, feature order N, Kh, Kw), then
``+bias``. The CPU tests hold it against the JAX Pallas kernel and
``chip_smoke.py`` holds the CUDA kernel against it on the card. Nothing
on the main path calls it when a card is present.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import f32_codes
from repro_torch.core.window import conv2d_im2col

__all__ = ["conv2d_window_ref"]


def conv2d_window_ref(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None = None, *,
                      stride: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """x: (B, N, H, W), w: (M, N, Kh, Kw), b: (M,)|None -> (B, M, Ho, Wo);
    int8 codes contract as their integer-valued fp32 (``f32_codes``)."""
    return conv2d_im2col(f32_codes(x), f32_codes(w), b, tuple(stride))
