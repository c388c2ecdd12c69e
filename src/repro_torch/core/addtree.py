"""Odd-even pairwise addition tree — paper §III.B.1 (C2).

Port of ``repro.core.addtree.pairwise_sum``: each level adds adjacent
pairs (0,1), (2,3), …; an odd tail is forwarded unchanged, so the level
width goes η → ⌈η/2⌉ → … → 1 with no power-of-two padding. The summation
order is the contract, so results are bitwise equal to the reference.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_sum"]


def _pair_reduce_once(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    if n == 1:
        return x
    even = n - (n % 2)
    lo = x.narrow(axis, 0, even).unflatten(axis, (even // 2, 2))
    summed = lo.select(axis + 1, 0) + lo.select(axis + 1, 1)
    if n % 2:
        summed = torch.cat([summed, x.narrow(axis, even, 1)], dim=axis)
    return summed


def pairwise_sum(x: torch.Tensor, axis: int = -1,
                 keepdim: bool = False) -> torch.Tensor:
    """Odd-even pairwise tree sum along ``axis`` (paper Fig. 5)."""
    axis = axis % x.ndim
    while x.shape[axis] > 1:
        x = _pair_reduce_once(x, axis)
    return x if keepdim else x.squeeze(axis)
