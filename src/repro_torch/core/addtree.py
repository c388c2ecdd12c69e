"""Odd-even pairwise addition tree — paper §III.B.1 (C2).

Port of ``repro.core.addtree``: each level adds adjacent pairs (0,1),
(2,3), …; an odd tail is forwarded unchanged, so the level width goes
η → ⌈η/2⌉ → … → 1 with no power-of-two padding. The summation order is
the contract, so ``pairwise_sum`` is bitwise equal to the reference.

Resource model (paper Fig. 4/5 and its worked example):
  * classic tree:   adders = 2**ceil(log2 eta) - 1,  registers = 2**(c+1)-1,
                    cycles = ceil(log2 eta)
  * odd-even tree:  adders = eta - 1, registers = sum of level widths,
                    cycles = ceil(log2 eta)   (identical depth)
For η = 9 the paper reports ours: 8 adders / 20 registers / 4 cycles vs
classic: 15 / 31 / 4, which ``tree_resources`` and
``classic_tree_resources`` reproduce.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["TreeResources", "tree_resources", "classic_tree_resources",
           "level_widths", "pairwise_sum", "classic_padded_sum"]


@dataclass(frozen=True)
class TreeResources:
    """Hardware-resource model of a reduction tree (paper Tab.-II analogue)."""

    eta: int            # number of addends
    adders: int         # total 2-input adders instantiated
    registers: int      # pipeline registers (incl. input regs), paper counting
    cycles: int         # pipeline depth in clock cycles
    padded_inputs: int  # inputs after padding (== eta for the odd-even tree)

    @property
    def padding_waste(self) -> float:
        """Fraction of tree inputs that are zero padding (0.0 for ours)."""
        return 1.0 - self.eta / self.padded_inputs


def level_widths(eta: int) -> list[int]:
    """Widths of each odd-even tree level, η, ⌈η/2⌉, …, 1: the input level
    and the final sum included."""
    if eta < 1:
        raise ValueError(f"eta must be >= 1, got {eta}")
    widths = [eta]
    while widths[-1] > 1:
        widths.append((widths[-1] + 1) // 2)
    return widths


def tree_resources(eta: int) -> TreeResources:
    """Resources of the paper's odd-even tree (§III.B.1, Fig. 5)."""
    widths = level_widths(eta)
    adders = sum(w // 2 for w in widths[:-1])     # one adder per pair
    # the paper counts every level's slots as registers, the input level
    # included (Fig. 5: eta=9 -> 9+5+3+2+1 = 20)
    return TreeResources(eta=eta, adders=adders, registers=sum(widths),
                         cycles=len(widths) - 1, padded_inputs=eta)


def classic_tree_resources(eta: int) -> TreeResources:
    """Resources of the classic zero-padded tree (paper Fig. 4): η padded
    to p = 2**ceil(log2 η), then p-1 adders, 2p-1 registers, log2 p
    cycles. η = 9 gives 15/31/4; η = 144 and 256 both give 255/511/8."""
    if eta < 1:
        raise ValueError(f"eta must be >= 1, got {eta}")
    c = math.ceil(math.log2(eta)) if eta > 1 else 0
    p = 2 ** c
    return TreeResources(eta=eta, adders=p - 1, registers=2 * p - 1,
                         cycles=c, padded_inputs=p)


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


def classic_padded_sum(x: torch.Tensor, axis: int = -1,
                       keepdim: bool = False) -> torch.Tensor:
    """Classic tree baseline: zero-pad ``axis`` to the next power of two,
    then halve exactly. Same value as ``pairwise_sum``; it exists to count
    the padding waste the paper's design removes."""
    axis = axis % x.ndim
    n = x.shape[axis]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        pad = [0, 0] * (x.ndim - 1 - axis) + [0, p - n]
        x = torch.nn.functional.pad(x, pad)
    while x.shape[axis] > 1:
        pairs = x.unflatten(axis, (x.shape[axis] // 2, 2))
        x = pairs.select(axis + 1, 0) + pairs.select(axis + 1, 1)
    return x if keepdim else x.squeeze(axis)
