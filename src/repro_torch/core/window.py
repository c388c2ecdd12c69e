"""Convolution-window pipeline — paper §III.B.2 (C3).

Port of ``repro.core.window``: the size laws (Eq. 1–2), the 2×2/2 pool
with its explicit odd-size modes, ``extract_windows`` with the feature
order (N, Kh, Kw), the paper-dataflow oracle ``conv2d_ref`` (windows →
odd-even addition tree → bias) and the im2col form ``conv2d_im2col``.

Layouts follow the paper: input (B, N, H, W), weight (M, N, Kh, Kw),
output (B, M, Ho, Wo).
"""
from __future__ import annotations

import torch

from repro_torch.core.addtree import pairwise_sum

__all__ = ["conv_output_size", "pool_output_size", "maxpool2",
           "extract_windows", "conv2d_ref", "conv2d_im2col"]


def conv_output_size(in_size: int, k: int, stride: int) -> int:
    """Paper Eq. (1)/(2): floor((H - Hk)/Hs) + 1, VALID padding only."""
    if in_size < k:
        raise ValueError(f"input {in_size} smaller than kernel {k}")
    return (in_size - k) // stride + 1


def pool_output_size(in_size: int, odd: str = "raise") -> int:
    """Output size of a 2×2/stride-2 VALID pool. ``odd`` is ``"raise"``
    (odd inputs are a sizing bug), ``"drop"`` (the Eq. 1–2 floor) or
    ``"pad"`` (extend with -inf to ceil(H/2))."""
    if odd not in ("raise", "drop", "pad"):
        raise ValueError(f"odd mode {odd!r}; expected raise|drop|pad")
    if in_size % 2 and odd == "raise":
        raise ValueError(
            f"2x2/2 maxpool over an odd size {in_size} drops the last "
            f"row/column (paper Eq. 1-2 floor); pass odd='drop' to accept "
            f"that or odd='pad' to keep a ceil-sized output")
    if in_size % 2 and odd == "pad":
        return (in_size + 1) // 2
    return in_size // 2


def maxpool2(x: torch.Tensor, *, odd: str = "raise") -> torch.Tensor:
    """2×2 max pool, stride 2, over the last two dims. A ``TracedArray``
    (repro_torch.graph.trace) records a MaxPool2 node instead."""
    hook = getattr(x, "graph_maxpool2", None)
    if hook is not None:
        return hook(odd=odd)
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = pool_output_size(h, odd), pool_output_size(w, odd)
    if odd == "pad" and (h % 2 or w % 2):
        x = torch.nn.functional.pad(x, (0, w % 2, 0, h % 2),
                                    value=float("-inf"))
    x = x[..., :2 * ph, :2 * pw]
    return x.unflatten(-1, (pw, 2)).unflatten(-3, (ph, 2)).amax(dim=(-3, -1))


def extract_windows(x: torch.Tensor, k: tuple[int, int],
                    stride: tuple[int, int]) -> torch.Tensor:
    """All VALID windows of ``x`` (B, N, H, W) -> (B, Ho, Wo, N·Kh·Kw),
    feature dim ordered (N, Kh, Kw) like the paper's Eq. (3)."""
    kh, kw = k
    sh, sw = stride
    win = x.unfold(2, kh, sh).unfold(3, kw, sw)        # (B, N, Ho, Wo, Kh, Kw)
    bsz, n, ho, wo = win.shape[:4]
    return win.permute(0, 2, 3, 1, 4, 5).reshape(bsz, ho, wo, n * kh * kw)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
               stride: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Paper-dataflow convolution oracle (Eq. 3–8): per window, all
    N·Kh·Kw products, the odd-even tree over them, then the bias.
    Memory-hungry — small shapes only."""
    m, n, kh, kw = w.shape
    win = extract_windows(x, (kh, kw), stride)            # (B,Ho,Wo,η)
    prod = win[:, :, :, None, :] * w.reshape(m, n * kh * kw)  # (B,Ho,Wo,M,η)
    out = pairwise_sum(prod, axis=-1)
    if b is not None:
        out = out + b
    return out.permute(0, 3, 1, 2)                        # (B, M, Ho, Wo)


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None,
                  stride: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Windows as the contracting operand of one fp32 matmul."""
    m, n, kh, kw = w.shape
    win = extract_windows(x, (kh, kw), stride)            # (B,Ho,Wo,η)
    out = torch.einsum("bhwe,me->bmhw", win, w.reshape(m, n * kh * kw))
    if b is not None:
        out = out + b[None, :, None, None].to(out.dtype)
    return out
