"""Plain PyTorch version of the addtree kernel: the odd-even pairwise
tree over the last axis, in the kernel's summation order, so the kernel
must equal it bitwise. The CPU tests hold it against the JAX Pallas kernel
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.addtree import pairwise_sum

__all__ = ["tree_reduce_sum_ref"]


def tree_reduce_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """(R, η) -> (R,): odd-even pairwise tree sum along the last axis."""
    return pairwise_sum(x, axis=-1)
