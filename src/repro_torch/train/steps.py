"""train_step factory: gradients (+ microbatched accumulation) and the
AdamW update (port of ``repro.train.steps``).

Gradients come from ``torch.autograd.grad`` over the parameter leaves:
each leaf is detached (no copy) and marked as requiring grad for the one
call, so the caller's params stay plain tensors and the step stays the
reference's pure function ``(params, opt_state, batch) -> (params,
opt_state, metrics)``. A parameter the loss does not reach (command-r's
``ln2`` under its parallel block) gets a zero gradient, as ``jax.grad``
gives it. Microbatches split the batch's leading dim into contiguous
slices, run one after another (the reference's ``lax.scan``) and
accumulate fp32 gradients. Collectives and the cross-pod compression
(``repro.train.compression``) wait for the mesh, ROADMAP §A.10.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tree import tree_from_items, tree_items, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update

__all__ = ["loss_and_grads", "make_train_step"]


def loss_and_grads(model, params, batch: dict, ctx=None):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: loss and
    metrics detached, grads a tree shaped as ``params`` whose leaf is
    None where the loss does not depend on the parameter."""
    items = tree_items(params)
    leaves = [p.detach().requires_grad_(True) for _, p in items]
    with torch.enable_grad():
        loss, metrics = model.loss(
            tree_from_items([(path, leaf) for (path, _), leaf
                             in zip(items, leaves)]), batch, ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_from_items([(path, g) for (path, _), g
                             in zip(items, grads)]))


def make_train_step(model, opt_cfg: AdamWConfig, ctx=None,
                    microbatches: int = 1,
                    cast_params_once: bool = False) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). ``batch`` leaves have a leading global-batch dim divisible
    by ``microbatches``.

    cast_params_once: cast the fp32 matrices to the model's compute dtype
    once, before the microbatch loop, so each use's cast is a no-op; the
    gradients then come back in that dtype and are accumulated in fp32
    (standard mixed precision)."""
    compute_dtype = getattr(model.cfg, "dtype", None)

    def maybe_cast(params):
        if not cast_params_once or compute_dtype is None:
            return params
        return tree_map(lambda p: p.to(compute_dtype)
                        if (p.dtype == torch.float32 and p.ndim >= 2)
                        else p, params)

    def grads_of(params, mb):
        loss, metrics, grads = loss_and_grads(model, params, mb, ctx)
        return loss, metrics, tree_map(
            lambda g, p: torch.zeros_like(p) if g is None else g,
            grads, params)

    def train_step(params, opt_state, batch):
        cast = maybe_cast(params)
        if microbatches == 1:
            loss, metrics, grads = grads_of(cast, batch)
        else:
            n = torch.full((), microbatches, dtype=torch.float32,
                           device=tree_items(params)[0][1].device)
            acc = tree_map(lambda p: torch.zeros(p.shape, device=p.device),
                           params)
            loss_sum, per_mb = None, []
            for i in range(microbatches):
                mb = {k: _slice(x, i, microbatches) for k, x in batch.items()}
                loss, metrics, grads = grads_of(cast, mb)
                tree_map(lambda a, g: a.add_(g.to(torch.float32)), acc,
                         grads)
                del grads
                loss_sum = loss if loss_sum is None else loss_sum + loss
                per_mb.append(metrics)
            grads = tree_map(lambda g: g / n, acc)
            loss = loss_sum / n
            metrics = {k: torch.stack([m[k] for m in per_mb]).sum() / n
                       for k in per_mb[0]}
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def _slice(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n``: rows [i·b/n, (i+1)·b/n) of ``x``."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"global batch {b} does not split into {n} "
                         f"microbatches")
    return x[i * (b // n):(i + 1) * (b // n)]
