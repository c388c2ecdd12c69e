"""Plain PyTorch version of the qmatmul kernel (paper C4 deployment path).

int8 codes widen to int32, the products are summed in int32 (exact, as
the kernel's accumulator is), and the scales apply in fp32 as
``(acc · x_scale) · w_scale``. The contraction is a broadcast multiply and
sum rather than ``torch.matmul`` because CUDA has no int32 matmul.

The broadcast product is taken over K in chunks whose (M, k, N) int32
temporary stays under ``TEMP_BYTES``, and the chunks' int32 partials are
added: integer sums are exact in any order, so the result is the same
bits as one (M, K, N) product (which at M = 64, K = 8,192, N = 22,528
would be 47 GB).
"""
from __future__ import annotations

import torch

__all__ = ["qmatmul_ref", "k_chunk", "TEMP_BYTES"]

# the largest (M, k, N) int32 product one chunk of K may hold
TEMP_BYTES = 256 << 20


def k_chunk(m: int, n: int) -> int:
    """The rows of K one chunk takes: at least 1, and as many as fit
    their (M, k, N) int32 product in ``TEMP_BYTES``."""
    return max(1, TEMP_BYTES // max(1, 4 * m * n))


def qmatmul_ref(x_codes: torch.Tensor, w_codes: torch.Tensor,
                x_scale: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M,K) int8 · (K,N) int8 -> (M,N) ``out_dtype``; x_scale
    (M,1)|scalar, w_scale (1,N)|scalar. The epilogue is fp32, then cast."""
    m, k = x_codes.shape
    n = w_codes.shape[1]
    acc = torch.zeros((m, n), dtype=torch.int32, device=x_codes.device)
    step = k_chunk(m, n)
    for k0 in range(0, k, step):
        xs = x_codes[:, k0:k0 + step].to(torch.int32)
        ws = w_codes[k0:k0 + step].to(torch.int32)
        acc += (xs[:, :, None] * ws[None, :, :]).sum(dim=1,
                                                     dtype=torch.int32)
    return (acc.to(torch.float32) * x_scale * w_scale).to(out_dtype)
