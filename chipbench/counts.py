"""The yardstick's arithmetic: useful work of a CNN configuration, counted
from its shapes, and the peaks of one NVIDIA H100 SXM.

A conv block is a VALID k x k convolution with bias, ReLU and a 2x2/2 max
pool; the classifier is one dense layer. Counts are the least work any
implementation must do, so a kernel that fuses more or stores narrower
types still reads at most 100% of its bound:

* operations are 2 x MACs;
* a conv block reads its input once as 1-byte codes, its int8 weights and
  fp32 bias once, and writes its pooled output once as 1-byte codes;
  bands and halos are not counted;
* the classifier reads int8 codes and int8 weights and writes fp32
  logits.

The bound of a launch is max(bytes / HBM bandwidth, operations / peak).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HBM_BYTES_PER_S", "INT8_OPS_PER_S", "Stage", "stages",
           "ops_per_image", "bound_seconds", "stage_bound_seconds"]

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


@dataclass(frozen=True)
class Stage:
    """One layer of the plan as the yardstick sees it."""

    kind: str              # "conv_block" | "dense"
    macs: int              # per image
    in_bytes: int          # activation bytes read per image (1-byte codes)
    out_bytes: int         # bytes written per image
    weight_bytes: int      # int8 weights + fp32 bias, read once a launch


def stages(config: dict) -> list[Stage]:
    """The conv blocks and the classifier of a configuration file's
    ``input``, ``layers`` and ``fc``, in order."""
    c, h, w = config["input"]
    out: list[Stage] = []
    for layer in config["layers"]:
        m, k = layer["out_channels"], layer["kernel"]
        ho, wo = h - k + 1, w - k + 1
        if ho < 2 or wo < 2 or ho % 2 or wo % 2:
            raise ValueError(f"layer {layer['param']}: conv map {ho}x{wo} "
                             f"is not even")
        po, qo = ho // 2, wo // 2
        out.append(Stage("conv_block", macs=m * c * k * k * ho * wo,
                         in_bytes=c * h * w, out_bytes=m * po * qo,
                         weight_bytes=m * c * k * k + 4 * m))
        c, h, w = m, po, qo
    n = config["fc"]["out_features"]
    kdim = c * h * w
    out.append(Stage("dense", macs=kdim * n, in_bytes=kdim, out_bytes=4 * n,
                     weight_bytes=kdim * n + 4 * n))
    return out


def ops_per_image(config: dict) -> int:
    """Useful int8 operations of one image: 2 x MACs of every layer."""
    return 2 * sum(s.macs for s in stages(config))


def stage_bound_seconds(stage: Stage, batch: int) -> float:
    """The least time one launch of ``stage`` over ``batch`` images can
    take on the card."""
    nbytes = batch * (stage.in_bytes + stage.out_bytes) + stage.weight_bytes
    return max(nbytes / HBM_BYTES_PER_S,
               2 * stage.macs * batch / INT8_OPS_PER_S)


def bound_seconds(config: dict, batch: int, kind: str) -> float:
    """Sum of the bounds of every stage of ``kind`` for one batch."""
    return sum(stage_bound_seconds(s, batch) for s in stages(config)
               if s.kind == kind)
