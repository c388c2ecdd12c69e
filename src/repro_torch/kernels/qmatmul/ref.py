"""Plain PyTorch version of the qmatmul kernel (paper C4 deployment path).

int8 codes widen to int32, the products are summed in int32 (exact, as
the kernel's accumulator is), and the scales apply in fp32 as
``(acc · x_scale) · w_scale``. The contraction is a broadcast multiply and
sum rather than ``torch.matmul`` because CUDA has no int32 matmul.
"""
from __future__ import annotations

import torch

__all__ = ["qmatmul_ref"]


def qmatmul_ref(x_codes: torch.Tensor, w_codes: torch.Tensor,
                x_scale: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M,K) int8 · (K,N) int8 -> (M,N) ``out_dtype``; x_scale
    (M,1)|scalar, w_scale (1,N)|scalar. The epilogue is fp32, then cast."""
    acc = (x_codes.to(torch.int32)[:, :, None]
           * w_codes.to(torch.int32)[None, :, :]).sum(dim=1, dtype=torch.int32)
    return (acc.to(torch.float32) * x_scale * w_scale).to(out_dtype)
