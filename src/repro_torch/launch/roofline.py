"""Three-term roofline of one step on NVIDIA H100 terms (port of
``repro.launch.roofline``, whose terms are the TPU's):

  compute    = Σ over dtypes of FLOPs in that dtype / the card's peak for it
  memory     = bytes accessed / 3.35 TB/s HBM
  collective = collective bytes / 450 GB/s NVLink per direction

The counts come from ``launch/op_stats.py`` (the step run on the meta
device), not from a compiled program's cost analysis. Unlike the
reference, which charges every FLOP at the bf16 peak, ``compute_s``
charges each dtype at its own peak: the chunked cross entropy's fp32
matmuls run on the CUDA cores at 67 TFLOP/s (the port refuses TF32), not
on the bf16 tensor cores at 989. ``mfu`` keeps the reference's
definition (useful FLOPs at the bf16 peak); ``measured`` divides by a
step's wall on the card instead of the model's step time.

The reference's ``parse_collective_bytes`` reads collectives out of HLO
text; the port has no HLO and is not ported: ``launch/op_stats.py``
counts a mesh's collectives as it runs the step (the mesh dry run), by
kind (``collective_bytes_by_op``, ``collective_count_by_op``), and the
collective term prices their bytes with each all-reduce counted twice,
as the reference's parser weights them.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["HW", "PEAK_FLOPS", "ALL_REDUCE_WEIGHT", "roofline_terms",
           "RooflineReport"]


class HW:
    """One NVIDIA H100 SXM (NVIDIA's H100 data sheet: dense rates
    without sparsity, at the full 700 W power limit)."""
    PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores; fp16 the same
    PEAK_FLOPS_INT8 = 1979e12       # OP/s, tensor cores
    PEAK_FLOPS_FP32 = 67e12         # FLOP/s, CUDA cores (no TF32)
    HBM_BW = 3.35e12                # B/s
    NVLINK_BW = 450e9               # B/s per direction, to each other card
    HBM_BYTES = 80e9


# the collective term counts an all-reduce's bytes twice: a ring
# all-reduce is a reduce-scatter and an all-gather (the reference's
# weighting of its HLO's all-reduces)
ALL_REDUCE_WEIGHT = 2.0

# the peak a FLOP in each dtype runs at (op_stats' dtype names)
PEAK_FLOPS = {"bfloat16": HW.PEAK_FLOPS_BF16,
              "float16": HW.PEAK_FLOPS_BF16,
              "int8": HW.PEAK_FLOPS_INT8,
              "float32": HW.PEAK_FLOPS_FP32}


def roofline_terms(flops_by_dtype: dict, bytes_accessed: float,
                   collective_bytes: float = 0.0) -> dict:
    """{"compute_s", "memory_s", "collective_s"} on one card. A dtype
    without a peak above raises: a count must not be priced at a guess."""
    unknown = set(flops_by_dtype) - set(PEAK_FLOPS)
    if unknown:
        raise KeyError(f"no H100 peak for FLOPs in {sorted(unknown)}; "
                       f"known: {sorted(PEAK_FLOPS)}")
    return {"compute_s": sum(f / PEAK_FLOPS[d]
                             for d, f in flops_by_dtype.items()),
            "memory_s": bytes_accessed / HW.HBM_BW,
            "collective_s": collective_bytes / HW.NVLINK_BW}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float                  # useful FLOPs (6·N·D or 2·N·tokens)
    flops_by_dtype: dict                # flops_per_device by dtype name
    peak_memory_per_device: float | None = None
    # a mesh's collectives by kind: bytes and calls a device
    collective_bytes_by_op: dict = field(default_factory=dict)
    collective_count_by_op: dict = field(default_factory=dict)

    def _terms(self) -> dict:
        return roofline_terms(self.flops_by_dtype, self.bytes_per_device,
                              self.collective_bytes_per_device)

    @property
    def compute_s(self) -> float:
        return self._terms()["compute_s"]

    @property
    def memory_s(self) -> float:
        return self._terms()["memory_s"]

    @property
    def collective_s(self) -> float:
        return self._terms()["collective_s"]

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/padding/dispatch waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline-model step time: max of the three terms (assumes
        perfect overlap; the no-overlap bound is their sum)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline-model step time."""
        denom = self.step_time_s * self.chips * HW.PEAK_FLOPS_BF16
        return self.model_flops / denom if denom else 0.0

    def measured(self, wall_s: float) -> dict:
        """Against a step's measured wall on the card: ``mfu`` =
        model_flops / (wall × chips × the bf16 peak), and
        ``bound_share`` = step_time_s / wall (above 1 the count lets the
        step beat its own bound: the count is wrong)."""
        return {"wall_s": wall_s,
                "mfu": self.model_flops / (wall_s * self.chips
                                           * HW.PEAK_FLOPS_BF16),
                "bound_share": self.step_time_s / wall_s}

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "flops_by_dtype": self.flops_by_dtype,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_bytes_by_op": dict(self.collective_bytes_by_op),
            "collective_count_by_op": dict(self.collective_count_by_op),
            "model_flops": self.model_flops,
            "peak_memory_per_device": self.peak_memory_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "step_time_s": self.step_time_s, "mfu": self.mfu,
        }
