"""fused_cwp: plain version (ref.py), CUDA wrapper (ops.py).

The reference's ``fused_conv_window`` and ``fused_conv_block_ref`` are
``fused_cwp`` and ``fused_cwp_ref`` here."""
from repro_torch.kernels.fused_cwp.ops import fused_cwp
from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref

__all__ = ["fused_cwp", "fused_cwp_ref"]
