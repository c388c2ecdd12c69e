"""Learning-rate schedules, pure functions of the step counter (port of
``repro.optim.schedule``). ``step`` is a 0-d tensor on the device the
update runs on; the result is a 0-d fp32 tensor there. Every division
is by a 0-d device tensor, a true division on the card too."""
from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def linear_warmup(step: torch.Tensor, base_lr: float,
                  warmup_steps: int) -> torch.Tensor:
    frac = torch.clamp(step.to(torch.float32)
                       / _c(max(warmup_steps, 1), step), max=1.0)
    return base_lr * frac


def cosine_schedule(step: torch.Tensor, base_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_ratio`` × base_lr."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / _c(max(warmup_steps, 1), step), max=1.0)
    prog = torch.clamp((step - warmup_steps)
                       / _c(max(total_steps - warmup_steps, 1), step),
                       0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (
        1 + torch.cos(_c(math.pi, step) * prog))
    return base_lr * warm * cos
