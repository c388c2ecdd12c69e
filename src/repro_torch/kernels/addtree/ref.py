"""Plain PyTorch versions of the addtree kernel: the odd-even pairwise
tree over the last axis, in the kernel's summation order, so the kernel
must equal it bitwise. The CPU tests hold it against the JAX Pallas kernel
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.

``tree_reduce_sum_levels`` restates the order the CUDA kernel actually
follows on long rows: level k of the odd-even tree is the perfect binary
tree of every aligned 2**k chunk, except its last element, which is the
odd-even tree of the remainder; the levels above k run over that vector
as usual. The kernel's lanes reach level 6 (16-byte loads, then four
shuffles) or level 4 (4-byte loads) that way before shared memory
finishes the tree; its short rows run the levels one by one (k = 0).
"""
from __future__ import annotations

import torch

from repro_torch.core.addtree import pairwise_sum

__all__ = ["tree_reduce_sum_ref", "tree_reduce_sum_levels"]


def tree_reduce_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """(R, η) -> (R,): odd-even pairwise tree sum along the last axis."""
    return pairwise_sum(x, axis=-1)


def tree_reduce_sum_levels(x: torch.Tensor, k: int) -> torch.Tensor:
    """(R, η) -> (R,): the same sum built from level ``k``: each aligned
    2**k chunk reduced as a perfect binary tree (adjacent halves first),
    the remainder by the odd-even tree, then the odd-even tree over the
    level-k vector."""
    r, eta = x.shape
    c = 1 << k
    full = eta // c if eta % c else eta // c - 1   # the last one is apart
    parts = []
    if full:
        chunks = x[:, :full * c].reshape(r, full, c)
        while chunks.shape[-1] > 1:
            chunks = chunks[..., 0::2] + chunks[..., 1::2]
        parts.append(chunks[..., 0])
    parts.append(pairwise_sum(x[:, full * c:], axis=-1).reshape(r, 1))
    return pairwise_sum(torch.cat(parts, dim=-1), axis=-1)
