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

``tc_stage_w`` restates, in plain PyTorch, how the kernel's tensor-core
body stages a 64 × 128 step of w: its 16-byte chunks as they land (row r's
chunk c at c ^ (r / 4 % 8)), then the transposition pass that turns each
4 k × 4 n byte block into K-major words with ``transpose4`` (the
kernel's eight ``__byte_perm``), into the [n][k] tile at the 80-byte
stride that the fragment loads read. It returns the shared-memory byte
address of every lane's load and store too, so the CPU tests hold the
layout against a transpose and the banks against conflicts.
``add_split`` restates how blocks that share an output entry's K add
their int32 sums into its 64-bit slot, and how the last one knows it is.
"""
from __future__ import annotations

import torch

__all__ = ["qmatmul_ref", "qmatmul_acc_ref", "k_chunk", "TEMP_BYTES",
           "byte_perm", "transpose4", "tc_stage_w", "add_split", "TC_BK",
           "TC_BN", "TC_LD"]

# the largest (M, k, N) int32 product one chunk of K may hold
TEMP_BYTES = 256 << 20
# the tensor-core body's step: K bytes, columns, staged row stride (bytes)
TC_BK, TC_BN, TC_LD = 64, 128, 80


def k_chunk(m: int, n: int) -> int:
    """The rows of K one chunk takes: at least 1, and as many as fit
    their (M, k, N) int32 product in ``TEMP_BYTES``."""
    return max(1, TEMP_BYTES // max(1, 4 * m * n))


def qmatmul_ref(x_codes: torch.Tensor, w_codes: torch.Tensor,
                x_scale: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M,K) int8 · (K,N) int8 -> (M,N) ``out_dtype``; x_scale
    (M,1)|scalar, w_scale (1,N)|scalar. The epilogue is fp32, then cast."""
    acc = qmatmul_acc_ref(x_codes, w_codes)
    return (acc.to(torch.float32) * x_scale * w_scale).to(out_dtype)


def qmatmul_acc_ref(x_codes: torch.Tensor, w_codes: torch.Tensor
                    ) -> torch.Tensor:
    """(M,K) int8 · (K,N) int8 -> the (M,N) int32 accumulator."""
    m, k = x_codes.shape
    n = w_codes.shape[1]
    acc = torch.zeros((m, n), dtype=torch.int32, device=x_codes.device)
    step = k_chunk(m, n)
    for k0 in range(0, k, step):
        xs = x_codes[:, k0:k0 + step].to(torch.int32)
        ws = w_codes[k0:k0 + step].to(torch.int32)
        acc += (xs[:, :, None] * ws[None, :, :]).sum(dim=1,
                                                     dtype=torch.int32)
    return acc


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 words held in int64:
    byte i of the result is byte ``sel``'s nibble i of (y:x)."""
    v = (x & 0xFFFFFFFF) | ((y & 0xFFFFFFFF) << 32)
    out = torch.zeros_like(v)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((v >> (8 * b)) & 0xFF) << (8 * i)
    return out


def transpose4(r0, r1, r2, r3):
    """Words r[i] = bytes (w[k+i][n..n+3]) -> o[j] = bytes (w[k..k+3][n+j]),
    the kernel's eight permutations."""
    t0, t1 = byte_perm(r0, r1, 0x5140), byte_perm(r0, r1, 0x7362)
    t2, t3 = byte_perm(r2, r3, 0x5140), byte_perm(r2, r3, 0x7362)
    return (byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632))


def tc_stage_w(tile: torch.Tensor):
    """A (64, 128) int8 step of w through the tensor-core body's staging.

    Returns (kmajor, reads, writes): the [n][k] tile (128 rows of
    ``TC_LD`` bytes, uint8; bytes 0..63 of row n are w[:, n]), and the
    byte addresses each of the 256 threads reads from the landed stage
    and writes into the tile: (8 warps, 2 blocks, 4 words, 32 lanes)."""
    if tuple(tile.shape) != (TC_BK, TC_BN):
        raise ValueError(f"a step of w is ({TC_BK}, {TC_BN}), got "
                         f"{tuple(tile.shape)}")
    src = tile.to(torch.uint8).to(torch.int64)
    # the stage as it lands: row r's 16-byte chunk c at c ^ (r / 4 % 8)
    raw = torch.zeros(TC_BK * TC_BN, dtype=torch.int64)
    for r in range(TC_BK):
        for c in range(TC_BN // 16):
            at = r * TC_BN + ((c ^ ((r >> 2) & 7)) << 4)
            raw[at:at + 16] = src[r, 16 * c:16 * c + 16]
    warp = torch.arange(8).view(8, 1, 1)
    u = torch.arange(2).view(1, 2, 1)
    lane = torch.arange(32).view(1, 1, 32)
    al, bl = lane & 3, lane >> 2
    p = 2 * warp + u
    g, h = p & 7, p >> 3
    a, b = 4 * g + al, 8 * h + bl          # n = 4a.., k = 4b..
    reads = torch.stack([(4 * b + i) * TC_BN + ((g ^ bl) << 4) + 4 * al
                         for i in range(4)], dim=2)
    words = sum(raw[reads + j] << (8 * j) for j in range(4))
    o = list(transpose4(*words.unbind(2)))
    s = al & 2                              # rows in the order 2, 3, 0, 1
    swap = s.bool().expand_as(o[0])
    o[0], o[2] = torch.where(swap, o[2], o[0]), torch.where(swap, o[0], o[2])
    o[1], o[3] = torch.where(swap, o[3], o[1]), torch.where(swap, o[1], o[3])
    writes = torch.stack([(4 * a + (j ^ s)) * TC_LD + 4 * b
                          for j in range(4)], dim=2)
    kmajor = torch.zeros(TC_BN * TC_LD, dtype=torch.int64)
    for j in range(4):
        for byte in range(4):
            kmajor[writes[:, :, j] + byte] = (o[j] >> (8 * byte)) & 0xFF
    return (kmajor.to(torch.uint8).view(TC_BN, TC_LD), reads.view(8, 2, 4,
                                                                  32),
            writes.view(8, 2, 4, 32))


def add_split(slot: int, v: int) -> tuple[int, int, int]:
    """The kernel's ``add_split`` on a 64-bit slot (an int mod 2**64):
    adds 2**48 + v and returns (the new slot, the count of adds it holds,
    the int32 sum of its low 32 bits). The count is right while the sum
    stays within ±2**47, which int32 adds from fewer than 2**16 blocks
    do."""
    now = (slot + (1 << 48) + v) % (1 << 64)
    count = ((now + (1 << 47)) % (1 << 64)) >> 48
    low = now & 0xFFFFFFFF
    return now, count, low - (1 << 32) if low >= 1 << 31 else low
