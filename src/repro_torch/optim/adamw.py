"""AdamW with decoupled weight decay, global-norm clipping and a cosine
LR schedule (port of ``repro.optim.adamw``), written out as the
reference writes it: no ``torch.optim``, so the state is the reference's
tree ({"m", "v", "step"}) and a checkpoint of it restores in either
package.

The update is functional, as the reference's: it returns new params and
a new state and leaves its arguments as they were. Its math runs in fp32
whatever the storage dtypes (``m_dtype``, ``v_dtype``, the params'). The
bias corrections are 0-d device tensors, so ``m / bc1`` is a true
division on the card (CUDA turns a division by a host scalar into a
multiplication by its reciprocal).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # storage dtype of the first moment (bf16 is the low-memory variant:
    # the first moment tolerates it, the second does not); the math
    # always runs in fp32
    m_dtype: Any = torch.float32
    v_dtype: Any = torch.float32


def adamw_init(params, cfg: AdamWConfig | None = None) -> dict:
    """Zero moments shaped as ``params`` (on each leaf's device) and a
    0-d int32 step counter on the first leaf's device."""
    m_dt = cfg.m_dtype if cfg is not None else torch.float32
    v_dt = cfg.v_dtype if cfg is not None else torch.float32

    def zeros(dt):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                              device=p.device), params)
    first = tree_leaves(params)[0]
    return {"m": zeros(m_dt), "v": zeros(v_dt),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig):
    """Returns (new_params, new_opt_state, {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(step, cfg.lr, cfg.warmup_steps, cfg.total_steps,
                         cfg.min_lr_ratio)
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)

    b1, b2 = cfg.b1, cfg.b2
    m = tree_map(lambda m_, g: (b1 * m_.to(torch.float32)
                                + (1 - b1) * g).to(cfg.m_dtype),
                 opt_state["m"], grads)
    v = tree_map(lambda v_, g: (b2 * v_.to(torch.float32)
                                + (1 - b2) * g * g).to(cfg.v_dtype),
                 opt_state["v"], grads)
    t = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=t.device)
    bc1 = 1 - torch.pow(b1 * one, t)
    bc2 = 1 - torch.pow(b2 * one, t)

    def upd(p, m_, v_):
        u = (m_.to(torch.float32) / bc1) / (
            torch.sqrt(v_.to(torch.float32) / bc2) + cfg.eps)
        if p.ndim >= 2:        # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
