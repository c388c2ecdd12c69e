"""Gradient-norm utilities (port of ``repro.optim.clip``). The norm sums
the leaves in the reference's order (sorted keys, ``core.tree``): fp32
addition is not associative, so another order gives another norm."""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in fp32, leaf by leaf in sorted key order."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """Returns (the tree scaled by min(1, max_norm / norm), each leaf in
    its dtype; the pre-clip norm)."""
    norm = global_norm(tree)
    cap = torch.full((), max_norm, dtype=torch.float32, device=norm.device)
    scale = torch.clamp(cap / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                    tree), norm
