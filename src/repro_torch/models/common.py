"""Shared model building blocks (port of ``repro.models.common``,
``dense_init`` only for now)."""
from __future__ import annotations

import torch

__all__ = ["dense_init"]


def dense_init(gen: torch.Generator, shape: tuple[int, ...], fan_in: int,
               device: torch.device) -> torch.Tensor:
    """Truncated-normal fan-in init (std = 1/sqrt(fan_in), cut at ±2σ),
    drawn on the CPU from ``gen``."""
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * fan_in ** -0.5).to(device)
