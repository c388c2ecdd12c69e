"""Streaming executors: run one conv/fused stage as halo-overlapped bands.

Port of ``repro.stream.executor``. ``stream_conv2d`` /
``stream_fused_conv_block`` mirror the ``repro_torch.ops.conv2d`` /
``fused_conv_block`` entry points exactly — same operand convention
(floats, or QTensors, or pre-split codes + ``scale``), same quantization
discipline, same registry dispatch — but the spatial loop over output
rows is outside the kernel: each band slices ``band_input_rows`` input
rows (adjacent bands overlapping on the halo) and dispatches the
*untiled* op on the slice, so the resident working set is
``band_working_set`` bytes regardless of H. On the card every band is
one launch of the op's kernel (``conv_window`` / ``fused_cwp``). A
band's slice of a (B, N, H, W) tensor is not contiguous for N > 1, so
the ``cuda`` backend copies it (``.contiguous()``) before the launch, and
``torch.cat`` along H copies the bands' outputs once more, as the
reference's concatenation does.

Every step that could differ from the untiled call is hoisted out of the
band loop:

  * operand quantization (``_conv_quant_operands``) runs ONCE on the full
    image — the int8 per-tensor activation scale sees all of H, so each
    band slices exact integer codes rather than re-quantizing;
  * the per-channel requant epilogue and the qformat output snap are
    elementwise, so applying them per band equals applying them untiled;
  * the conv itself is windowed VALID: a band's output element is the
    same η-length dot product either way.

So int8 and qformat (integer-valued sums, exact in fp32) are bitwise
equal to the untiled entry points. Under int8 the bands slice the int8
codes themselves (``split_int8``): on the card each band is one launch of
the kernel's int8 route, with no cast. In fp32 the CUDA conv template picks
its launch shape from H (``ops/tiling.py``, ``choose_fused_blocks``), so
a band may sum in another order than the untiled launch.

Tile height resolves through ``repro_torch.ops.tiling.tile_params`` under
the op names ``stream_conv2d`` / ``stream_fused_conv_block`` with the
single key ``th`` (the stream's band height, distinct from the conv
kernels' own ``conv2d.band`` / ``fused_conv_block.band``), as in the
reference: a policy override (``"stream_conv2d.th"``) beats a
``TUNING_CACHE`` row for this call's signature, which beats the
``SpatialTiling`` spec's budget-derived default.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import conv_epilogue
from repro_torch.core.window import pool_output_size
from repro_torch.ops.impls import _conv_quant_operands, split_int8
from repro_torch.ops.policy import ExecPolicy, current_policy
from repro_torch.ops.registry import dispatch
from repro_torch.ops.tiling import conv_signature, platform_key, tile_params
from repro_torch.stream.tiling import SpatialTiling, conv_bands, pooled_bands

__all__ = ["stream_conv2d", "stream_fused_conv_block", "resolve_tile_rows"]


def resolve_tile_rows(op: str, x, w, stride, tiling: SpatialTiling,
                      policy: ExecPolicy) -> int:
    """Tile height for this call: policy tiling (``"<op>.th"``) >
    ``TUNING_CACHE`` entry for (op, conv signature, dtype, platform) >
    the SpatialTiling's budget-derived default."""
    th = tile_params(op, {"th": tiling.tile_rows}, policy.tile_overrides,
                     signature=conv_signature(x.shape, w.shape, stride),
                     dtype=x.dtype, platform=platform_key(x.device))["th"]
    return max(int(th), 1)


def stream_conv2d(x, w, b=None, *, stride=(1, 1), scale=None,
                  tiling: SpatialTiling,
                  policy: ExecPolicy | None = None) -> torch.Tensor:
    """Halo-banded ``repro_torch.ops.conv2d``: (B, N, H, W) ·
    (M, N, Kh, Kw) -> (B, M, Ho, Wo)."""
    pol = policy if policy is not None else current_policy()
    x, w, b = _conv_quant_operands(pol, x, w, b)
    x, w, s = split_int8(x, w)
    if scale is None:
        scale = s
    kh = w.shape[2]
    sh, _ = stride
    ho = (x.shape[2] - kh) // sh + 1
    th = resolve_tile_rows("stream_conv2d", x, w, stride, tiling, pol)
    outs = []
    for _, _, in_lo, in_hi in conv_bands(ho, th, kh, sh):
        xb = x[:, :, in_lo:in_hi, :]
        out = dispatch("conv2d", xb, w, None if scale is not None else b,
                       stride=tuple(stride), policy=pol)
        if scale is not None:
            out = conv_epilogue(out, scale, b)
        if pol.quant == "qformat":
            out = pol.qformat.quantize(out)
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def stream_fused_conv_block(x, w, b=None, *, stride=(1, 1), odd="raise",
                            scale=None, tiling: SpatialTiling,
                            policy: ExecPolicy | None = None
                            ) -> torch.Tensor:
    """Halo-banded ``repro_torch.ops.fused_conv_block``: bands count
    *pooled* rows (even conv-row cuts — no 2×2 pool window ever straddles
    bands; only the image's own ragged last rows see the ``odd`` mode,
    exactly as untiled). On the card the fused kernel pools a band's odd
    last conv row as the untiled call does (``odd='pad'``)."""
    pol = policy if policy is not None else current_policy()
    x, w, b = _conv_quant_operands(pol, x, w, b)
    x, w, s = split_int8(x, w)
    if scale is None:
        scale = s
    kh = w.shape[2]
    sh, _ = stride
    h = x.shape[2]
    ho = (h - kh) // sh + 1
    po = pool_output_size(ho, odd)
    th = resolve_tile_rows("stream_fused_conv_block", x, w, stride,
                           tiling, pol)
    outs = []
    for _, _, in_lo, in_hi in pooled_bands(po, th, kh, sh, h):
        xb = x[:, :, in_lo:in_hi, :]
        out = dispatch("fused_conv_block", xb, w, b, stride=tuple(stride),
                       odd=odd, scale=scale, policy=pol)
        if pol.quant == "qformat":
            out = pol.qformat.quantize(out)
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
