"""Attention and MLP layers (port of ``repro.models.layers``): GQA,
qk-norm, softcap, sliding window, QKV biases.

Attention has three entry modes on one code path, as in the reference:
train / prefill (full-sequence queries, causal, optionally writing a KV
cache), decode (one query token against a cache, masked by position),
and cross-attention (``kv_x`` from an encoder, bidirectional mask).

The projections are plain matmuls, as the reference's einsums are; only
the MLP goes through the policy-aware ``repro_torch.ops.dense``, so an
active ``ExecPolicy(quant="int8")`` runs every MLP matmul through the
``qmatmul`` kernel. ``attn_axes`` and ``mlp_axes`` are the params'
logical axes (``repro_torch.sharding``).

On a mesh (a ``ShardingCtx`` with one) the tensors are DTensors and the
``shard`` calls sit where the reference's do. Three steps are explicit
here, each a mesh-only branch: the KV-cache write lands in the rank
that holds the written positions (``_write_cache_mesh``); K/V are
gathered to q's heads layout, whole in the sequence, and the attention
runs on the local tensors (every rank holds whole rows of its heads, so
the softmax is the unsharded one); and the attention output's heads are
gathered before ``wo``, whose contraction then runs whole on every rank.
The last two keep every float sum in one rank and one order, so an int8
engine on a mesh is bitwise to the unsharded one; the one row-parallel
product is the MLP's ``wo`` (``ops.dense``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.common import (ACTIVATIONS, _const, apply_rope,
                                       dense_init, rms_norm, rope_freqs,
                                       softcap)
from repro_torch.ops import dense as dense_op
from repro_torch.sharding.logical import (A, ShardingCtx, gathered,
                                          is_dtensor, local_part, on_mesh,
                                          redistribute, row_placements,
                                          shard)

__all__ = ["AttnConfig", "attn_init", "attn_axes", "attention",
           "make_attn_mask", "MLPConfig", "mlp_init", "mlp_axes",
           "mlp_apply"]

# masked scores, in fp32; the softmax runs in fp32 before the cast back
_NEG_INF = -1e30


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float | None = None
    rope_theta: float = 10000.0
    use_rope: bool = True


def attn_init(gen: torch.Generator, cfg: AttnConfig,
              device: torch.device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h, hd), d, device),
        "wk": dense_init(gen, (d, kv, hd), d, device),
        "wv": dense_init(gen, (d, kv, hd), d, device),
        "wo": dense_init(gen, (h, hd, d), h * hd, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), device=device)
        p["bk"] = torch.zeros((kv, hd), device=device)
        p["bv"] = torch.zeros((kv, hd), device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device)
        p["k_norm"] = torch.ones((hd,), device=device)
    return p


def attn_axes(cfg: AttnConfig) -> dict:
    ax = {
        "wq": A("embed", "heads", "head"),
        "wk": A("embed", "kv_heads", "head"),
        "wv": A("embed", "kv_heads", "head"),
        "wo": A("heads", "head", "embed"),
    }
    if cfg.qkv_bias:
        ax["bq"] = A("heads", "head")
        ax["bk"] = A("kv_heads", "head")
        ax["bv"] = A("kv_heads", "head")
    if cfg.qk_norm:
        ax["q_norm"] = A(None)
        ax["k_norm"] = A(None)
    return ax


def make_attn_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                   causal: bool, window: int | None,
                   kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean mask (B, Sq, Skv): True = attend.

    q_pos: (B, Sq); kv_pos: (Skv,) or (B, Skv); kv_len: (B,) number of
    valid cache slots (decode) or None (dense)."""
    if kv_pos.ndim == 1:
        kv_pos = kv_pos[None, :]
    qp = q_pos[:, :, None]                       # (B, Sq, 1)
    kp = kv_pos[:, None, :]                      # (B, 1, Skv)
    shape = torch.broadcast_shapes(qp.shape, kp.shape)
    mask = torch.ones(shape, dtype=torch.bool, device=qp.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    if kv_len is not None:
        mask &= kp < kv_len[:, None, None]
    return mask


def _write_cache(c: torch.Tensor, new: torch.Tensor, index) -> None:
    """Write ``new`` (B, s, …) into ``c`` (B, T, …) in place at sequence
    offset ``index``, clamped into [0, T - s] as the reference's
    ``dynamic_update_slice`` clamps. A Python int is one slice write; a
    (B,) index writes each row at its own offset (the reference's
    ``vmap(dynamic_update_slice)``), as one advanced-index assignment. A
    0-d tensor (the reference's decode ``pos``) takes the per-row path,
    expanded to (B,): the same writes, and no read of the index on the
    host (a sync on the card; impossible on the meta device)."""
    t, s = c.shape[1], new.shape[1]
    new = new.to(c.dtype)
    if not torch.is_tensor(index):
        i = min(max(int(index), 0), t - s)
        c[:, i:i + s] = new
        return
    start = index.to(device=c.device, dtype=torch.long).expand(c.shape[0])
    start = start.clamp(0, t - s)
    cols = start[:, None] + torch.arange(s, device=c.device)
    rows = torch.arange(c.shape[0], device=c.device)[:, None]
    c[rows, cols] = new


def _cache_part(c):
    """(the local tensor of a cache view, its offset in each dim): the
    rows, positions and heads this rank holds (a seam of its own: the
    mesh tests plant a rank that takes the wrong positions here)."""
    return local_part(c)


def _write_cache_mesh(c, new, index) -> None:
    """``_write_cache`` on a mesh: ``c`` (B, T, …) and ``new`` (B, s, …)
    are DTensors. ``new`` is gathered to ``c``'s batch layout, whole in
    every other dim and cut to the heads this rank holds, and each rank
    writes only the positions it holds (``_cache_part``): a Python index
    by slicing, a (B,) or 0-d tensor index row by row on the device. A
    one-token write (decode) scatters
    each row's one position, where a rank that does not hold it writes
    back the value it read; a longer write takes, for each held position,
    the new value it falls on or the old one."""
    from torch.distributed.tensor import Replicate, Shard
    t, s = c.shape[1], new.shape[1]
    target = tuple(Shard(0) if (p.is_shard() and p.dim == 0)
                   else Replicate() for p in c.placements)
    new = redistribute(new.to(c.dtype), target).to_local()
    loc, off = _cache_part(c)
    b0, t0 = off[0], off[1]
    tl = loc.shape[1]
    new = new[(slice(None), slice(None)) + tuple(
        slice(o, o + n) for o, n in zip(off[2:], loc.shape[2:]))]
    if not torch.is_tensor(index):
        i = min(max(int(index), 0), t - s)
        lo, hi = max(i, t0), min(i + s, t0 + tl)
        if lo < hi:
            loc[:, lo - t0:hi - t0] = new[:, lo - i:hi - i]
        return
    start = index.to(device=loc.device, dtype=torch.long).expand(c.shape[0])
    start = start.clamp(0, t - s)[b0:b0 + loc.shape[0]]
    rows = torch.arange(loc.shape[0], device=loc.device)[:, None]
    if s == 1:
        j = start[:, None] - t0
        held = (j >= 0) & (j < tl)
        j = j.clamp(0, tl - 1)
        keep = held.reshape(held.shape + (1,) * (new.ndim - 2))
        loc[rows, j] = torch.where(keep, new, loc[rows, j])
        return
    o = t0 + torch.arange(tl, device=loc.device)[None, :] - start[:, None]
    hit = (o >= 0) & (o < s)
    picked = new[rows, o.clamp(0, s - 1)]
    keep = hit.reshape(hit.shape + (1,) * (new.ndim - 2))
    loc.copy_(torch.where(keep, picked, loc))


def _kv_len(cache_index, s: int, b: int, device) -> torch.Tensor:
    """The number of valid cache entries a row after the write; a 0-d
    tensor index is expanded to (B,) on its device, never read."""
    if torch.is_tensor(cache_index):
        return cache_index.to(device).expand(b) + s
    return torch.full((b,), int(cache_index) + s, dtype=torch.int32,
                      device=device)


def attention(params: dict, x: torch.Tensor, cfg: AttnConfig,
              ctx: ShardingCtx | None, *,
              q_pos: torch.Tensor,
              causal: bool = True,
              window: int | None = None,
              window_active: torch.Tensor | bool | None = None,
              kv_x: torch.Tensor | None = None,
              kv_pos: torch.Tensor | None = None,
              cache_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
              cache_index=None,
              precomputed_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
              kv_valid_len: torch.Tensor | None = None,
              ) -> tuple[torch.Tensor,
                         tuple[torch.Tensor, torch.Tensor] | None]:
    """Returns (out (B, S, D), the (k_cache, v_cache) written, or None).

    cache_kv: (B, S_max, KV, hd) ×2. With ``cache_index`` — a scalar (all
    rows at one offset) or a (B,) tensor (per-row offsets: the serve
    engine's slots, DESIGN.md §6) — the new K/V are written into these
    tensors IN PLACE at that offset, and attention runs over the whole
    cache with position masking (decode / chunked prefill).

    ``window``: sliding-window size; ``window_active``: a per-layer flag
    choosing between the windowed and the full mask (gemma2's
    local/global alternation).
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    mesh = on_mesh(ctx)
    if mesh:
        # the projections over rows whole in the sequence: DTensor's
        # einsum flattens (B, S), which a sequence split over ``model``
        # (``act_seq``) refuses on the card's torch
        x = redistribute(x, row_placements(x))
        if kv_x is not None:
            kv_x = redistribute(kv_x, row_placements(kv_x))

    src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
    if precomputed_kv is not None:
        k, v = (t.to(dt) for t in precomputed_kv)
    else:
        k = torch.einsum("btd,dhk->bthk", src, params["wk"].to(dt))
        v = torch.einsum("btd,dhk->bthk", src, params["wv"].to(dt))
        if cfg.qkv_bias:
            k = k + params["bk"].to(dt)
            v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        if precomputed_kv is None:
            k = rms_norm(k, params["k_norm"])

    q = shard(q, ctx, "attn_batch", "act_seq", "act_heads", None)
    k = shard(k, ctx, "attn_batch", "act_seq", "act_kv", None)
    v = shard(v, ctx, "attn_batch", "act_seq", "act_kv", None)

    if kv_pos is None:
        kv_pos = (torch.arange(k.shape[1], device=x.device)[None, :]
                  if (precomputed_kv is not None or kv_x is not None)
                  else q_pos)
    if cfg.use_rope and kv_x is None and precomputed_kv is None:
        qc, qs_ = rope_freqs(q_pos, hd, cfg.rope_theta)
        kc, ks_ = rope_freqs(kv_pos, hd, cfg.rope_theta)
        if mesh:   # the positions are global: their rotations as q's rows
            qc, qs_, kc, ks_ = (shard(r, ctx, "attn_batch", "act_seq", None)
                                for r in (qc, qs_, kc, ks_))
        q = apply_rope(q, qc, qs_)
        k = apply_rope(k, kc, ks_)

    new_cache = None
    if cache_kv is not None:
        ck, cv = cache_kv
        kv_len = None
        if cache_index is not None:
            write = _write_cache_mesh if mesh else _write_cache
            write(ck, k, cache_index)
            write(cv, v, cache_index)
            kv_len = _kv_len(cache_index, s, b, x.device)
        k, v = ck.to(dt), cv.to(dt)
        k = shard(k, ctx, "batch", "kv_seq", "act_kv", None)
        v = shard(v, ctx, "batch", "kv_seq", "act_kv", None)
        new_cache = (ck, cv)
        mask_pos = torch.arange(ck.shape[1], device=x.device)
        mask_len = kv_len
    else:
        mask_pos, mask_len = kv_pos, kv_valid_len
    mask = make_attn_mask(q_pos, mask_pos, causal=causal, window=None,
                          kv_len=mask_len)
    if window is not None:
        wmask = make_attn_mask(q_pos, mask_pos, causal=causal,
                               window=window, kv_len=mask_len)
        active = True if window_active is None else window_active
        if isinstance(active, bool):
            mask = wmask if active else mask
        else:
            mask = torch.where(active.to(mask.device), wmask, mask)

    # KV repeated to full heads, as the reference does (the standard TP
    # treatment of GQA, where a (kv, groups) factorization cannot shard)
    g = h // kvh
    if g > 1:
        k = _repeat_heads(k, g)
        v = _repeat_heads(v, g)
        seq_name = "kv_seq" if cache_kv is not None else "act_seq"
        k = shard(k, ctx, "attn_batch", seq_name, "act_heads", None)
        v = shard(v, ctx, "attn_batch", seq_name, "act_heads", None)
    if mesh:
        # K/V to q's heads layout, whole in the sequence: every rank holds
        # whole rows of its heads' scores, so the attention runs on the
        # local tensors, the unsharded softmax and sums of those rows
        k, v = (_like_q(t, q, seq=False) for t in (k, v))
        mask = shard(mask, ctx, "attn_batch", "act_seq", None)
        from torch.distributed.tensor import DTensor
        out = DTensor.from_local(
            _attend(q.to_local(), k.to_local(), v.to_local(),
                    mask.to_local(), cfg.attn_softcap),
            q.device_mesh, q.placements, run_check=False)
    else:
        out = _attend(q, k, v, mask, cfg.attn_softcap)
    wo = params["wo"]
    if mesh:
        # the heads gathered before wo: its contraction whole on every
        # rank (and the sequence whole, as for the projections)
        out, wo = (_like_q(out, q, seq=False, heads=False),
                   gathered(wo, None))
    out = torch.einsum("bshk,hkd->bsd", out, wo.to(dt))
    out = shard(out, ctx, "batch", "act_seq", "act_embed")
    return out, new_cache


def _attend(q, k, v, mask, attn_softcap) -> torch.Tensor:
    """softmax(q·kᵀ / √hd, masked) · v over (B, S|T, H, hd) tensors, KV
    already repeated to full heads."""
    s, hd, dt = q.shape[1], q.shape[3], q.dtype
    if s > _Q_BLOCK:
        return _blockwise_attn(q, k, v, mask, attn_softcap)
    # the scale is sqrt(hd) rounded to the model dtype, and the division
    # runs in that dtype: in bf16 this rounds differently from
    # _blockwise_attn's fp32 multiply by 1/sqrt(hd). A device divisor
    # keeps it a true division on the card
    root = float(torch.sqrt(torch.tensor(float(hd))).to(dt))
    scores = torch.einsum("bshd,bthd->bhst", q, k) / _const(root, q, dt)
    scores = softcap(scores, attn_softcap)
    scores = torch.where(mask[:, None, :, :], scores.to(torch.float32),
                         _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _repeat_heads(t: torch.Tensor, g: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, KV·g, hd), each head ``g`` times in a row
    (``repeat_interleave``). A DTensor repeats its local heads: a shard
    of the KV heads repeated is the shard of the repeated heads."""
    if is_dtensor(t):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(_repeat_heads(t.to_local(), g),
                                  t.device_mesh, t.placements,
                                  run_check=False)
    return torch.repeat_interleave(t, g, dim=2)


def _like_q(t, q, *, seq: bool = True, heads: bool = True):
    """``t`` (B, ·, H, hd) in ``q``'s layout: its batch shards, and its
    sequence and heads shards where ``seq`` / ``heads``; Replicate on
    every other mesh dim."""
    from torch.distributed.tensor import Replicate
    keep = {0} | ({1} if seq else set()) | ({2} if heads else set())
    target = tuple(p if (p.is_shard() and p.dim in keep) else Replicate()
                   for p in q.placements)
    return redistribute(t, target)


_Q_BLOCK = 512


def _pick_q_block(s: int, cap: int = _Q_BLOCK) -> int:
    qb = min(cap, s)
    while s % qb:
        qb -= 1
    return qb


def _blockwise_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, attn_softcap: float | None
                    ) -> torch.Tensor:
    """Query-blockwise attention: never holds the whole (S, T) score map,
    only (B, H, qb, T) a block. q, k, v: (B, S|T, H, hd), KV already
    repeated to full heads.

    The reference multiplies a model-dtype score by the numpy float64
    ``1/sqrt(hd)``, which JAX takes as an fp32 constant and promotes the
    product to fp32: so the scale here is that fp32 value, and a bf16
    score is widened before the multiply."""
    b, s, h, hd = q.shape
    qb = _pick_q_block(s)
    scale = _const(1.0 / np.sqrt(hd), q)
    outs = []
    for i in range(0, s, qb):
        scores = torch.einsum("bshd,bthd->bhst", q[:, i:i + qb], k)
        scores = scores.to(torch.float32) * scale
        scores = softcap(scores, attn_softcap)
        scores = torch.where(mask[:, None, i:i + qb, :], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhst,bthd->bshd", probs, v))
    return torch.cat(outs, dim=1)


@dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    act: str = "silu"
    gated: bool = True
    use_bias: bool = False


def mlp_init(gen: torch.Generator, cfg: MLPConfig,
             device: torch.device) -> dict:
    p = {"wi": dense_init(gen, (cfg.d_model, cfg.d_ff), cfg.d_model, device),
         "wo": dense_init(gen, (cfg.d_ff, cfg.d_model), cfg.d_ff, device)}
    if cfg.gated:
        p["wg"] = dense_init(gen, (cfg.d_model, cfg.d_ff), cfg.d_model,
                             device)
    if cfg.use_bias:
        p["bi"] = torch.zeros((cfg.d_ff,), device=device)
        p["bo"] = torch.zeros((cfg.d_model,), device=device)
    return p


def mlp_axes(cfg: MLPConfig) -> dict:
    ax = {"wi": A("embed", "mlp"), "wo": A("mlp", "embed")}
    if cfg.gated:
        ax["wg"] = A("embed", "mlp")
    if cfg.use_bias:
        ax["bi"] = A("mlp")
        ax["bo"] = A(None)
    return ax


def mlp_apply(params: dict, x: torch.Tensor, cfg: MLPConfig,
              ctx: ShardingCtx | None) -> torch.Tensor:
    """The matmuls go through ``repro_torch.ops.dense``: under an active
    ``use_policy(ExecPolicy(quant="int8"))`` each one is a ``qmatmul``
    (on the card, one kernel launch: ``wi``, ``wg``, ``wo``)."""
    act = ACTIVATIONS[cfg.act]
    dt = x.dtype
    if is_dtensor(x):       # rows whole in the sequence, as attention's
        x = redistribute(x, row_placements(x))
    hid = dense_op(x, params["wi"].to(dt),
                   params["bi"].to(dt) if cfg.use_bias else None)
    if cfg.gated:
        gate = dense_op(x, params["wg"].to(dt))
        hid = act(gate) * hid
    else:
        hid = act(hid)
    hid = shard(hid, ctx, "batch", "act_seq", "act_mlp")
    out = dense_op(hid, params["wo"].to(dt),
                   params["bo"].to(dt) if cfg.use_bias else None)
    return shard(out, ctx, "batch", "act_seq", "act_embed")
