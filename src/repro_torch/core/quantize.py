"""Fixed-point / integer quantization — paper C4 ("16 bit fixed" in Tab. III).

Port of ``repro.core.quantize``:

1. ``QFormat`` — the paper's Qm.n fixed-point lattice (default Q8.8):
   round half to even, saturate; ``quantize_int`` gives the integer codes.
2. int8 symmetric quantization — ``quantize_int8`` produces the codes and
   scales the ``qmatmul`` kernel and the int8 conv epilogue consume;
   ``dequantize_int8`` maps them back; ``fake_quant_int8`` is the pair
   with a straight-through gradient (quantization-aware training) and
   ``quantize_tree`` quantizes a params tree's matrices.

``requant_epilogue`` keeps the multiply-round-then-add-round order that
the JAX reference pins with an optimization barrier: PyTorch's eager ops
never contract the pair into an FMA, and the CUDA kernels spell it
``__fadd_rn(__fmul_rn(acc, s), b)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

__all__ = ["QFormat", "QTensor", "quantize_int8", "dequantize_int8",
           "fake_quant_int8", "quantize_tree", "requant_epilogue",
           "conv_epilogue", "f32_codes"]

# fp32(1 / 127), the constant ``quantize_int8`` multiplies by
_INV127 = torch.tensor(1.0, dtype=torch.float32) / 127.0


@dataclass(frozen=True)
class QFormat:
    """Qm.n two's-complement fixed point with saturation; ``int_bits``
    includes the sign bit (Q8.8: int_bits=8, frac_bits=8)."""

    int_bits: int = 8
    frac_bits: int = 8

    @property
    def total_bits(self) -> int:
        return self.int_bits + self.frac_bits

    @property
    def step(self) -> float:
        return 2.0 ** -self.frac_bits

    @property
    def max_val(self) -> float:
        return 2.0 ** (self.int_bits - 1) - self.step

    @property
    def min_val(self) -> float:
        return -(2.0 ** (self.int_bits - 1))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Snap to the fixed-point lattice (round half to even, saturate)."""
        scaled = torch.round(x.to(torch.float32) / self.step)
        lo = self.min_val / self.step
        hi = self.max_val / self.step
        return torch.clamp(scaled, lo, hi) * self.step

    def quantize_int(self, x: torch.Tensor) -> torch.Tensor:
        """Integer codes (int32) for hardware-exact arithmetic."""
        scaled = torch.round(x.to(torch.float32) / self.step)
        lo = self.min_val / self.step
        hi = self.max_val / self.step
        return torch.clamp(scaled, lo, hi).to(torch.int32)

    def dequantize_int(self, codes: torch.Tensor) -> torch.Tensor:
        return codes.to(torch.float32) * self.step


class QTensor(NamedTuple):
    """int8 codes + fp32 scales; ``values = codes * scale``."""

    codes: torch.Tensor   # int8
    scale: torch.Tensor   # fp32, broadcastable against codes


def quantize_int8(x: torch.Tensor, axis: int | None = -1,
                  amax: torch.Tensor | None = None) -> QTensor:
    """Symmetric int8 quantization, one scale per slice along the dims
    other than ``axis`` (``axis`` is reduced away, kept as size 1);
    ``axis=None`` is per-tensor with a 0-d scale. ``amax`` replaces the
    absmax where the tensor's parts lie on several ranks (the mesh
    executor passes the max over all of them).

    scale = max(absmax, 1e-8) / 127; codes = clip(round(x / scale), ±127).
    The reference's compiler folds the division by the constant 127 into
    a multiplication by its fp32 reciprocal, so the scale is spelled that
    way here: a true division rounds some scales one ulp apart, and int8
    parity is bitwise.
    """
    xf = x.to(torch.float32)
    if amax is None:
        amax = (xf.abs().amax() if axis is None
                else xf.abs().amax(dim=axis, keepdim=True))
    scale = torch.clamp(amax, min=1e-8) * _INV127
    codes = torch.clamp(torch.round(xf / scale), -127, 127)
    return QTensor(codes.to(torch.int8), scale)


def f32_codes(t: torch.Tensor | None) -> torch.Tensor | None:
    """int8 codes as the integer-valued fp32 the reference contracts
    (exact: the η·127² < 2²⁴ sums of a conv are exact in fp32); any other
    tensor, or None, as it is."""
    if t is not None and t.dtype == torch.int8:
        return t.to(torch.float32)
    return t


def dequantize_int8(q: QTensor, dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """``codes · scale`` in fp32, cast to ``dtype``."""
    return (q.codes.to(torch.float32) * q.scale).to(dtype)


class _FakeQuantInt8(torch.autograd.Function):
    """quantize → dequantize forward, identity backward (the reference's
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, axis):
        return dequantize_int8(quantize_int8(x, axis), x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant_int8(x: torch.Tensor, axis: int | None = -1) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient — used for
    quantization-aware training of the paper CNN."""
    return _FakeQuantInt8.apply(x, axis)


def quantize_tree(params, axis: int | None = -1, min_size: int = 16):
    """Every float tensor leaf of a nested-dict tree of ndim >= 2 and at
    least ``min_size`` elements as an int8 ``QTensor``; the small leaves
    (biases, norms, scalars) stay in float, as deployment keeps them and
    as the paper keeps its accumulators at full width."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, axis, min_size)
                for k, v in params.items()}
    if (isinstance(params, torch.Tensor) and params.is_floating_point()
            and params.ndim >= 2 and params.numel() >= min_size):
        return quantize_int8(params, axis)
    return params


def requant_epilogue(acc: torch.Tensor, scale: torch.Tensor,
                     b: torch.Tensor | None = None) -> torch.Tensor:
    """Dequantize an integer accumulator: ``acc·scale [+ b]``, two
    roundings (multiply, then add). ``scale``/``b`` are pre-broadcast."""
    out = acc * scale
    if b is None:
        return out
    return out + b


def conv_epilogue(out: torch.Tensor, scale: torch.Tensor | None,
                  b: torch.Tensor | None = None) -> torch.Tensor:
    """``requant_epilogue`` broadcast over NCHW conv outputs: per-channel
    ``scale`` (M,)|None, then bias (M,)|None cast to the output dtype."""
    if scale is not None:
        return requant_epilogue(
            out, scale[None, :, None, None],
            None if b is None else b[None, :, None, None].to(out.dtype))
    if b is not None:
        out = out + b[None, :, None, None].to(out.dtype)
    return out
