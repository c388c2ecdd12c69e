"""Convolution-window pipeline — paper §III.B.2 (C3).

Port of ``repro.core.window``: the size laws (Eq. 1–2), the 2×2/2 pool
with its explicit odd-size modes, the window-buffer model (``fill_latency``,
``reuse_ratio`` and the cycle-level ``LineBufferSim``, in numpy),
``extract_windows`` with the feature order (N, Kh, Kw), the per-window
products ``window_products``, the paper-dataflow oracle ``conv2d_ref``
(products → odd-even addition tree → bias) and the im2col form
``conv2d_im2col``.

Layouts follow the paper: input (B, N, H, W), weight (M, N, Kh, Kw),
output (B, M, Ho, Wo).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.addtree import pairwise_sum

__all__ = ["conv_output_size", "pool_output_size", "maxpool2",
           "fill_latency", "reuse_ratio", "LineBufferSim",
           "extract_windows", "window_products", "conv2d_ref",
           "conv2d_im2col"]


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


def fill_latency(k: int, w: int, kw: int | None = None) -> int:
    """Paper Fig. 8: invalid/fill cycles T_u = (K-1)·W + K - 1; for a
    Kh×Kw window (``k`` rows, ``kw`` columns, square by default)
    T_u = (Kh-1)·W + Kw - 1: Kh-1 full rows resident plus Kw-1 pixels of
    the current row."""
    kw = k if kw is None else kw
    return (k - 1) * w + kw - 1


def reuse_ratio(k: int) -> float:
    """Paper Fig. 6: fraction of data shared between horizontally adjacent
    windows, (K-1)/K."""
    return (k - 1) / k


class LineBufferSim:
    """Cycle-level model of the paper's window cache (Fig. 7).

    Registers:
      WB: Kh rows × Kw cols. The stream enters WB[Kh-1][0]; every row
          shifts right each cycle (col 0 -> col Kw-1).
      SB: (Kh-1) rows × (W-Kw) cols, also right-shifting. The value leaving
          WB row r (r >= 1) at col Kw-1 enters SB[r-1][0]; the value leaving
          SB row j at col W-Kw-1 enters WB[j][0]. With W == Kw there is no
          shift buffer and WB row exits feed the row above directly.

    WB shifts right, so the newest pixel of each row sits at col 0 and the
    readout reverses columns to recover image order. The five steps of
    §III.B.2 happen in parallel: each cycle reads the previous cycle's
    registers. ``k`` is an int (square) or a (Kh, Kw) pair.
    """

    def __init__(self, k: int | tuple[int, int], w: int):
        kh, kw = (k, k) if isinstance(k, int) else k
        if kh < 1 or kw < 1 or w < kw:
            raise ValueError(f"need Kh >= 1 and 1 <= Kw <= W, "
                             f"got Kh={kh} Kw={kw} W={w}")
        self.k = k
        self.kh, self.kw, self.w = kh, kw, w
        self.wb = np.full((kh, kw), np.nan)
        self.sb = np.full((max(kh - 1, 0), max(w - kw, 0)), np.nan)
        self.cycle = 0                    # pixels streamed so far

    def step(self, value: float) -> None:
        """Stream one pixel (row-major image order): one clock cycle."""
        kh, kw, w = self.kh, self.kw, self.w
        wb_old, sb_old = self.wb.copy(), self.sb.copy()
        self.wb[:, 1:] = wb_old[:, :-1]
        if kh > 1:
            if w > kw:
                self.sb[:, 1:] = sb_old[:, :-1]
                self.sb[:, 0] = wb_old[1:, kw - 1]
                self.wb[:kh - 1, 0] = sb_old[:, w - kw - 1]
            else:
                self.wb[:kh - 1, 0] = wb_old[1:, kw - 1]
        self.wb[kh - 1, 0] = value
        self.cycle += 1

    @property
    def window(self) -> np.ndarray:
        """The current Kh×Kw window in image orientation."""
        return self.wb[:, ::-1].copy()

    def window_valid(self) -> bool:
        """True when WB holds a whole in-image window: past the fill
        latency and not wrapping a row boundary (Fig. 8's valid region)."""
        t = self.cycle
        if t <= fill_latency(self.kh, self.w, self.kw):
            return False
        col = (t - 1) % self.w + 1        # 1-indexed column of the newest
        return col >= self.kw

    def run(self, image: np.ndarray, stride: tuple[int, int] = (1, 1)):
        """Stream an (H, W) image; yield (cycle, row, col, window) for every
        valid window in paper order. The buffers shift every cycle whatever
        the stride; ``stride`` only gates the readout to windows whose
        top-left corner sits on the VALID-conv stride grid (Eq. 1-2)."""
        h, w = image.shape
        sh, sw = stride
        if w != self.w:
            raise ValueError(f"image width {w}, buffer built for {self.w}")
        for i in range(h):
            for j in range(w):
                self.step(float(image[i, j]))
                if self.window_valid():
                    r, c = i - self.kh + 1, j - self.kw + 1
                    if r % sh == 0 and c % sw == 0:
                        yield self.cycle, r, c, self.window


def extract_windows(x: torch.Tensor, k: tuple[int, int],
                    stride: tuple[int, int]) -> torch.Tensor:
    """All VALID windows of ``x`` (B, N, H, W) -> (B, Ho, Wo, N·Kh·Kw),
    feature dim ordered (N, Kh, Kw) like the paper's Eq. (3)."""
    kh, kw = k
    sh, sw = stride
    win = x.unfold(2, kh, sh).unfold(3, kw, sw)        # (B, N, Ho, Wo, Kh, Kw)
    bsz, n, ho, wo = win.shape[:4]
    return win.permute(0, 2, 3, 1, 4, 5).reshape(bsz, ho, wo, n * kh * kw)


def window_products(x: torch.Tensor, w: torch.Tensor,
                    stride: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Every window's N·Kh·Kw products with every output channel's
    weights, (B, Ho, Wo, M, η): the addends of the paper's tree."""
    m, n, kh, kw = w.shape
    win = extract_windows(x, (kh, kw), stride)            # (B,Ho,Wo,η)
    return win[:, :, :, None, :] * w.reshape(m, n * kh * kw)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
               stride: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Paper-dataflow convolution oracle (Eq. 3–8): per window, all
    N·Kh·Kw products, the odd-even tree over them, then the bias.
    Memory-hungry — small shapes only."""
    out = pairwise_sum(window_products(x, w, stride), axis=-1)
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
