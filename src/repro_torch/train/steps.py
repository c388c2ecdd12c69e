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
accumulate fp32 gradients.

On a mesh (a ``ShardingCtx`` with one) the params and the optimizer
state are DTensors laid out by the model's ``axes()``; the batch is the
global one on every rank (the model slices its rows), the gradients are
laid out as their params (a partial gradient reduced where DTensor left
one), and AdamW's moments follow. The loss and metrics come back whole.
The cross-pod compression (``train/compression.py``) stays outside the
step, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_from_items, tree_items, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.sharding.logical import is_dtensor, redistribute, whole

__all__ = ["loss_and_grads", "make_train_step", "TrainStep"]


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
    grads = [g if g is None or not is_dtensor(g)
             else redistribute(g, p.placements)
             for g, (_, p) in zip(grads, items)]
    return (whole(loss.detach()),
            {k: whole(v.detach()) for k, v in metrics.items()},
            tree_from_items([(path, g) for (path, _), g
                             in zip(items, grads)]))


class TrainStep:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, in the parts the dry run counts apart
    (``launch/dryrun.py``: one microbatch counted and multiplied by
    their number, as the reference's HLO walk multiplies a ``while``
    body by its trip count). A call runs ``cast``, then either ``grads``
    on the whole batch or, for each microbatch of ``split``,
    ``accumulate`` into one ``accumulator`` and then ``mean``, and last
    ``update``."""

    def __init__(self, model, opt_cfg: AdamWConfig, ctx=None,
                 microbatches: int = 1, cast_params_once: bool = False):
        self.model, self.opt_cfg, self.ctx = model, opt_cfg, ctx
        self.microbatches = microbatches
        self.cast_params_once = cast_params_once
        self.compute_dtype = getattr(model.cfg, "dtype", None)

    def cast(self, params):
        if not self.cast_params_once or self.compute_dtype is None:
            return params
        return tree_map(lambda p: p.to(self.compute_dtype)
                        if (p.dtype == torch.float32 and p.ndim >= 2)
                        else p, params)

    def grads(self, params, mb):
        """(loss, metrics, grads), a zero gradient where the loss does
        not reach a parameter."""
        loss, metrics, grads = loss_and_grads(self.model, params, mb,
                                              self.ctx)
        return loss, metrics, tree_map(
            lambda g, p: torch.zeros_like(p) if g is None else g,
            grads, params)

    def split(self, batch: dict) -> list[dict]:
        n = self.microbatches
        return [{k: _slice(whole(x), i, n) for k, x in batch.items()}
                for i in range(n)]

    def accumulator(self, params) -> dict:
        """fp32 zeros shaped as ``params`` and a 0-d loss sum (0 + the
        first loss is that loss, bit for bit)."""
        dev = tree_items(params)[0][1].device
        return {"grads": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32,
                    memory_format=torch.contiguous_format), params),
                "loss": torch.zeros((), device=dev)}

    def accumulate(self, params, acc: dict, mb: dict) -> dict:
        """One microbatch: its gradients added into ``acc`` in fp32 and
        its loss into the running sum; returns its metrics."""
        loss, metrics, grads = self.grads(params, mb)
        tree_map(lambda a, g: a.add_(g.to(torch.float32)), acc["grads"],
                 grads)
        del grads
        acc["loss"] = acc["loss"] + loss
        return metrics

    def mean(self, acc: dict, per_mb: list[dict]):
        """(loss, metrics, grads): the microbatches' means."""
        n = torch.full((), self.microbatches, dtype=torch.float32,
                       device=acc["loss"].device)
        grads = tree_map(lambda g: g / n, acc["grads"])
        metrics = {k: torch.stack([m[k] for m in per_mb]).sum() / n
                   for k in per_mb[0]}
        return acc["loss"] / n, metrics, grads

    def update(self, params, opt_state, grads, loss, metrics):
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, self.opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    def __call__(self, params, opt_state, batch):
        cast = self.cast(params)
        if self.microbatches == 1:
            loss, metrics, grads = self.grads(cast, batch)
        else:
            acc = self.accumulator(params)
            per_mb = [self.accumulate(cast, acc, mb)
                      for mb in self.split(batch)]
            loss, metrics, grads = self.mean(acc, per_mb)
        return self.update(params, opt_state, grads, loss, metrics)


def make_train_step(model, opt_cfg: AdamWConfig, ctx=None,
                    microbatches: int = 1,
                    cast_params_once: bool = False) -> TrainStep:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). ``batch`` leaves have a leading global-batch dim divisible
    by ``microbatches``.

    cast_params_once: cast the fp32 matrices to the model's compute dtype
    once, before the microbatch loop, so each use's cast is a no-op; the
    gradients then come back in that dtype and are accumulated in fp32
    (standard mixed precision)."""
    return TrainStep(model, opt_cfg, ctx, microbatches, cast_params_once)


def _slice(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n``: rows [i·b/n, (i+1)·b/n) of ``x``."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"global batch {b} does not split into {n} "
                         f"microbatches")
    return x[i * (b // n):(i + 1) * (b // n)]
