"""Serve-step factories: prefill + single-token decode (+ greedy
sampling); port of ``repro.serve.steps``.

Each factory takes an ``ExecPolicy`` (repro_torch.ops, DESIGN.md §7) that
is active around the model call, so every registry-routed op inside the
model (the MLP's ``dense`` → ``qmatmul`` under int8) follows it — no
flag threading through model code. The steps never read the clock; the
engine's step loop times them through the Clock seam.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.ops import ExecPolicy, use_policy

__all__ = ["make_prefill_step", "make_decode_step", "greedy_sample"]


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """The first index of the largest logit, int32. On near-equal logits
    two devices (or two reduction shapes) may pick different tokens:
    hold tokens only where the computation is the same."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _policy_scope(policy: ExecPolicy | None):
    return use_policy(policy) if policy is not None \
        else contextlib.nullcontext()


def make_prefill_step(model, ctx=None,
                      policy: ExecPolicy | None = None) -> Callable:
    """prefill_step(params, batch, cache) -> (first tokens (B,), cache)."""

    def prefill_step(params, batch, cache):
        with _policy_scope(policy), torch.no_grad():
            logits, cache = model.prefill(params, batch, cache, ctx)
        return greedy_sample(logits), cache

    return prefill_step


def make_decode_step(model, ctx=None, sample: bool = True,
                     policy: ExecPolicy | None = None) -> Callable:
    """decode_step(params, tokens (B,), pos () | (B,), cache) ->
    (next tokens (B,) | logits, cache)."""

    def decode_step(params, tokens, pos, cache):
        with _policy_scope(policy), torch.no_grad():
            logits, cache = model.decode_step(params, tokens, pos, cache,
                                              ctx)
        out = greedy_sample(logits) if sample else logits
        return out, cache

    return decode_step
