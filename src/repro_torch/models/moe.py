"""Mixture-of-Experts with capacity-bounded top-k routing, GShard-style
(port of ``repro.models.moe``, its local path).

Dispatch is scatter-based (no (T, E, C) one-hot tensor): each (token, k)
assignment takes its position within its expert from a cumulative count,
drops past capacity, and scatters its features into a (B, E, C, D)
buffer, so the expert matmuls cost E·C·D·F, the active experts' compute.
Each batch row is its own dispatch group with capacity
``C = _capacity(S)``.

Shared (always-on) experts (llama4-scout) and top-k renorm (dbrx) are
supported. The auxiliary load-balance loss (Switch-style) is returned
beside the output; serving discards it.

The semantics are the reference's to the rounding, and these are the
places they hide:

* routing runs in fp32 (``x`` upcast, the router weight upcast, the
  softmax), and the fp32 router matmul must not run in TF32, which flips
  experts: ``moe_apply`` refuses a float32 matmul precision other than
  ``"highest"``;
* ties in the top-k go to the lowest expert index first, as
  ``jax.lax.top_k`` orders them (``torch.topk`` does not): a stable
  descending sort;
* positions count a row's ``S·k`` assignments token-major, then k
  (what gets dropped past capacity depends on that order); a dropped
  assignment writes slot ``C``, which is cut away, and only that slot
  takes duplicate writes;
* the buffer, the expert matmuls and the combine run in ``x.dtype`` (the
  expert weights cast per call, as the reference's ``.astype``), the
  routing weights cast to it before the multiply, and the sum over k
  accumulates in fp32 and rounds once, as ``jnp.sum`` does for bf16.

The experts do not go through the op registry, so an
``ExecPolicy(quant="int8")`` leaves them in ``x.dtype``, as the
reference's einsums do. Expert parallelism over a mesh (the reference's
``_moe_apply_ep``) and the logical axes (``moe_axes``) wait for the LM
half of ROADMAP §A.10: a ``ShardingCtx`` with a mesh raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.common import ACTIVATIONS, dense_init
from repro_torch.sharding.logical import ShardingCtx, shard

__all__ = ["MoEConfig", "moe_init", "moe_apply"]


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden size
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    n_shared: int = 0         # always-on shared experts (llama4: 1)
    act: str = "silu"
    gated: bool = True
    router_aux_weight: float = 0.01


def moe_init(gen: torch.Generator, cfg: MoEConfig,
             device: torch.device) -> dict:
    """Random fp32 expert params from ``gen``, in the reference's layout.
    The reference draws ``shared_wg`` from ``shared_wi``'s key, so the two
    are equal there; here ``shared_wg`` is a copy of ``shared_wi``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(gen, (d, e), d, device),
        "wi": dense_init(gen, (e, d, f), d, device),
        "wo": dense_init(gen, (e, f, d), f, device),
    }
    if cfg.gated:
        p["wg"] = dense_init(gen, (e, d, f), d, device)
    if cfg.n_shared:
        p["shared_wi"] = dense_init(gen, (d, cfg.n_shared * f), d, device)
        p["shared_wo"] = dense_init(gen, (cfg.n_shared * f, d),
                                    cfg.n_shared * f, device)
        if cfg.gated:
            p["shared_wg"] = p["shared_wi"].clone()
    return p


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # a multiple of 8, never pow2-padded


def _top_k(probs: torch.Tensor, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, ties to the
    lowest index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """fp32 routing: (probs (B, S, E), top_w renormed (B, S, k), top_e
    (B, S, k), aux loss ())."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "moe routing needs float32 matmul precision 'highest': a TF32 "
            "router matmul flips experts (torch.get_float32_matmul_"
            f"precision() is {torch.get_float32_matmul_precision()!r})")
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                          params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    # Switch aux loss: E · Σ_e (token fraction_e × mean prob_e)
    assign = F.one_hot(top_e[..., 0], e).to(torch.float32)
    aux = e * torch.mean(assign.mean((0, 1)) * probs.mean((0, 1))) \
        * cfg.router_aux_weight
    return probs, top_w, top_e, aux


def _slots(flat_e: torch.Tensor, e: int, cap: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's slot within its (row, expert): flat_e (B, S·k),
    counted token-major then k. Returns (slot, capped at ``cap`` for a
    dropped assignment; keep (B, S·k) bool)."""
    onehot = F.one_hot(flat_e, e)                          # (B, S·k, E)
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    keep = pos < cap
    return torch.where(keep, pos, cap), keep


def _combine(gathered: torch.Tensor, w: torch.Tensor, b: int, s: int,
             k: int) -> torch.Tensor:
    """Σ_k (expert output × routing weight) in the model dtype: each
    product rounds to it, the sum over k runs in fp32 and rounds once."""
    d = gathered.shape[-1]
    prod = (gathered * w[..., None]).reshape(b, s, k, d)
    return prod.sum(dim=2, dtype=torch.float32).to(gathered.dtype)


def _ffn(x: torch.Tensor, wi, wg, wo, act, eq_in: str, eq_out: str
         ) -> torch.Tensor:
    hid = torch.einsum(eq_in, x, wi.to(x.dtype))
    hid = act(torch.einsum(eq_in, x, wg.to(x.dtype))) * hid \
        if wg is not None else act(hid)
    return torch.einsum(eq_out, hid, wo.to(x.dtype))


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig,
              ctx: ShardingCtx | None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in ``x.dtype``, aux loss () fp32).

    The local path (the reference's ``_moe_apply_local``): group-wise
    dispatch, each batch row a group with its own capacity. A mesh
    raises: expert parallelism waits for the LM half of ROADMAP §A.10."""
    if ctx is not None and ctx.mesh is not None:
        raise NotImplementedError(
            "moe_apply over a mesh (the reference's expert-parallel "
            "_moe_apply_ep) is not ported yet (ROADMAP §A.10, the LM "
            "half: expert parallelism)")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, cfg)
    act = ACTIVATIONS[cfg.act]
    dev = x.device

    _, top_w, top_e, aux = _route(params, x, cfg)

    # --- group-local dispatch: position within (row, expert) ---
    flat_e = top_e.reshape(b, s * k)
    pos_c, keep = _slots(flat_e, e, cap)
    src = torch.arange(s, device=dev).repeat_interleave(k)
    brow = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    buf = torch.zeros((b, e, cap + 1, d), dtype=x.dtype, device=dev)
    buf[brow, flat_e, pos_c] = x[:, src, :]
    buf = shard(buf[:, :, :cap, :], ctx, "batch", "act_expert", None, None)

    # --- expert FFN (B, E, C, D) ---
    y = _ffn(buf, params["wi"], params.get("wg") if cfg.gated else None,
             params["wo"], act, "becd,edf->becf", "becf,efd->becd")

    # --- combine: row-local gather + routing weights ---
    y = F.pad(y, (0, 0, 0, 1))                          # the drop slot
    gathered = y[brow, flat_e, pos_c]                   # (B, S·k, D)
    w = (top_w.reshape(b, s * k) * keep).to(x.dtype)
    out = _combine(gathered, w, b, s, k)

    # --- shared experts (always on) ---
    if cfg.n_shared:
        out = out + _ffn(x, params["shared_wi"],
                         params.get("shared_wg") if cfg.gated else None,
                         params["shared_wo"], act, "bsd,df->bsf",
                         "bsf,fd->bsd")
    return shard(out, ctx, "batch", "act_seq", "act_embed"), aux
