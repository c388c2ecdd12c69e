"""Mamba2 (SSD) block, the chunked state-space duality scan
[arXiv:2405.21060]; port of ``repro.models.mamba2``.

The block's causal conv1d is the ``causal_conv1d`` op family, the paper's
C3 window pipeline in one dimension (decode keeps a (K-1)-deep ring
state, literally a WINDOW_BUFFER; DESIGN.md §5, zamba2 row).

SSD semantics (ngroups=1, following the paper's minimal reference):
  h_t = exp(dt_t · A) · h_{t-1} + dt_t · B_t ⊗ x_t        (per head)
  y_t = C_t · h_t + D · x_t
computed chunkwise: intra-chunk via a masked attention-like contraction,
inter-chunk via a scan over per-chunk states, O(T·P·N) not O(T²). The
reference's ``lax.scan`` over chunks is a Python loop over them here.

Where the semantics hide in the rounding:

* ``softplus`` is JAX's, ``logaddexp(x, 0)`` for every x
  (``F.softplus`` returns x itself above 20);
* ``_segsum`` puts -inf above the diagonal, whose ``exp`` is an exact 0;
* the silu rounds after each op of x / (1 + exp(-x)), as XLA's does
  (``common.silu_per_op``);
* the SSD contractions run in fp32 unless ``ssd_bf16``, and the result
  is cast back to the model dtype before the gated ``rms_norm``;
* each multi-operand einsum is contracted pairwise in the reference's
  operand order: the intra-chunk one as (C·B)·L, then ·X, never through
  a (B, nc, q, q, H, P) product (3.8 GB at zamba2's 512-token prefill).

``mamba2_axes`` is the block's logical axes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.conv import causal_conv1d_step
from repro_torch.models.common import (chunk_scan, dense_init, rms_norm,
                                       silu_per_op)
from repro_torch.ops import causal_conv1d
from repro_torch.sharding.logical import (A, ShardingCtx, gathered,
                                          is_dtensor, local_offset,
                                          matmul_rows, redistribute,
                                          row_placements,
                                          shard, split_over, spmd_global,
                                          spmd_local)

__all__ = ["Mamba2Config", "mamba2_init", "mamba2_axes", "mamba2_apply",
           "mamba2_decode_step", "mamba2_mesh", "mamba2_state_shape"]


@dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    # contraction dtype of the SSD einsums; the decay accumulation
    # (cumsum, segsum, exp) always runs in fp32
    ssd_bf16: bool = False

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


def mamba2_init(gen: torch.Generator, cfg: Mamba2Config,
                device: torch.device) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    u = torch.rand((h,), generator=gen, device=gen.device).to(device)
    # in_proj -> [z (di), x (di), B (n), C (n), dt (h)]
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * n + h), d, device),
        "conv_w": dense_init(gen, (cfg.d_conv, cfg.conv_dim), cfg.d_conv,
                             device),
        "conv_b": torch.zeros((cfg.conv_dim,), device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "D": torch.ones((h,), device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(u * 3.0 - 5.0))),
        "norm": torch.ones((di,), device=device),
        "out_proj": dense_init(gen, (di, d), di, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)) at every x."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(…, q) -> (…, q, q) lower-triangular segment sums:
    out[..., i, j] = Σ_{k=j+1..i} x[..., k] for i >= j, -inf above the
    diagonal (so that its ``exp`` is an exact 0)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def _ssd_chunked(x, dt, a, b, c, cfg: Mamba2Config):
    """Chunked SSD. x: (B,T,H,P); dt: (B,T,H); a: (H,) (negative);
    b, c: (B,T,N). Returns (y (B,T,H,P), final_state (B,H,P,N)). T must
    be a whole number of chunks: the scan never pads."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    q = cfg.chunk
    if t % q:
        raise ValueError(f"SSD scan over {t} tokens: not a whole number of "
                         f"chunks of {q} (prompts must be)")
    nc = t // q

    # discretize: decay log per step = dt * a (a < 0); input scaled by dt
    da = dt * a[None, None, :]                          # (B,T,H)
    xs = x * dt[..., None]                              # (B,T,H,P)
    da_c = da.reshape(bsz, nc, q, h)
    xs_c = xs.reshape(bsz, nc, q, h, p)
    b_c = b.reshape(bsz, nc, q, n)
    c_c = c.reshape(bsz, nc, q, n)

    cdt = torch.bfloat16 if cfg.ssd_bf16 else torch.float32
    bq, cq, xq = b_c.to(cdt), c_c.to(cdt), xs_c.to(cdt)

    # 1. intra-chunk (diagonal blocks): attention-like with a decay kernel;
    # "bzin,bzjn,bzhij,bzjhp->bzihp" as ((C·B)·L)·X
    l = torch.exp(_segsum(da_c.movedim(-1, 2)))        # (B,nc,H,q,q)
    cb = torch.einsum("bzin,bzjn->bzij", cq, bq)
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", cb[:, :, None] * l.to(cdt),
                          xq).to(torch.float32)

    # 2. per-chunk final states: "bzjn,bzjh,bzjhp->bzhpn"
    da_cum = torch.cumsum(da_c, dim=2)                  # (B,nc,q,H)
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)
    states = torch.einsum("bzjn,bzjhp->bzhpn", bq,
                          decay_states.to(cdt)[..., None] * xq
                          ).to(torch.float32)

    # 3. inter-chunk recurrence over chunk states, emitting the state
    # BEFORE each chunk
    chunk_decay = torch.exp(da_cum[:, :, -1, :])        # (B,nc,H)
    prev_states, final = chunk_scan(
        torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device),
        chunk_decay[..., None, None], states)           # (B,nc,H,P,N)

    # 4. chunk-input contribution: "bzin,bzih,bzhpn->bzihp"
    state_decay = torch.exp(da_cum)                     # (B,nc,q,H)
    y_off = (torch.einsum("bzin,bzhpn->bzihp", cq, prev_states.to(cdt))
             * state_decay.to(cdt)[..., None]).to(torch.float32)

    y = (y_diag + y_off).reshape(bsz, t, h, p)
    return y, final


def mamba2_axes(cfg: Mamba2Config) -> dict:
    return {
        "in_proj": A("embed", "ssm_inner"),
        "conv_w": A(None, "ssm_inner"),
        "conv_b": A("ssm_inner"),
        "A_log": A("ssm_heads"),
        "D": A("ssm_heads"),
        "dt_bias": A("ssm_heads"),
        "norm": A("ssm_inner"),
        "out_proj": A("ssm_inner", "embed"),
    }


def _mix(z, xb, b, c, dt, p: dict, cfg: Mamba2Config, heads: int,
         state: dict | None, want_state: bool):
    """The block between the ``in_proj`` and the gated norm, over
    ``heads`` heads: z, xb (B,T,heads·P), b, c (B,T,N), dt (B,T,heads)
    in the model dtype; ``p`` holds ``conv_w``/``conv_b`` of the xb|B|C
    channels and ``A_log``, ``D``, ``dt_bias`` of these heads. With a
    ``state`` (T = 1) the recurrent step, else the chunked scan from a
    zero state. Returns (y · silu(z) in the model dtype, the new state
    {"ssm", "conv"} or None): a decode step's, or with ``want_state``
    the scan's final state and the pre-conv tail."""
    bsz, t, _ = xb.shape
    n, hp = cfg.d_state, cfg.head_dim
    dil = heads * hp
    dt_ = xb.dtype
    xbc_pre = torch.cat([xb, b, c], dim=-1)
    new = None
    if state is not None:
        xbc, conv_state = causal_conv1d_step(
            xbc_pre[:, 0], state["conv"], p["conv_w"].to(dt_),
            p["conv_b"].to(dt_))
        xbc = silu_per_op(xbc)[:, None]
    else:
        xbc = silu_per_op(causal_conv1d(xbc_pre, p["conv_w"].to(dt_),
                                        p["conv_b"].to(dt_)))
    xb, b, c = torch.split(xbc, [dil, n, n], dim=-1)

    dt = softplus(dt.to(torch.float32)
                  + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["A_log"].to(torch.float32))
    if state is not None:
        decay = torch.exp(dt[:, 0] * a[None, :])               # (B,H)
        xh = xb[:, 0].reshape(bsz, heads, hp).to(torch.float32)
        ssm = state["ssm"].to(torch.float32)
        # "bh,bn,bhp->bhpn"
        ssm = ssm * decay[:, :, None, None] \
            + (dt[:, 0, :, None] * xh)[..., None] \
            * b[:, 0].to(torch.float32)[:, None, None, :]
        y = torch.einsum("bn,bhpn->bhp", c[:, 0].to(torch.float32), ssm)
        y = y + p["D"].to(torch.float32)[None, :, None] * xh
        new = {"ssm": ssm.to(state["ssm"].dtype), "conv": conv_state}
    else:
        xh = xb.reshape(bsz, t, heads, hp).to(torch.float32)
        y, final = _ssd_chunked(xh, dt, a, b.to(torch.float32),
                                c.to(torch.float32), cfg)
        y = y + p["D"].to(torch.float32)[None, None, :, None] * xh
        if want_state:
            km1 = cfg.d_conv - 1
            tail = xbc_pre[:, -km1:, :] if t >= km1 else F.pad(
                xbc_pre, (0, 0, km1 - t, 0))
            new = {"ssm": final.to(dt_), "conv": tail}
    y = y.reshape(bsz, t, dil).to(dt_)
    return y * silu_per_op(z), new


def _split_zxbcdt(zxbcdt, cfg: Mamba2Config):
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    return torch.split(zxbcdt, [di, di, n, n, h], dim=-1)


def mamba2_apply(params: dict, x: torch.Tensor, cfg: Mamba2Config,
                 ctx: ShardingCtx | None, *, return_state: bool = False):
    """x: (B,T,D) -> (B,T,D) [, final state]. Train/prefill (chunked scan).

    return_state: also return {"ssm", "conv"} so serving can continue with
    ``mamba2_decode_step`` after a prefill (states start from zero). On a
    mesh ``x`` is a DTensor and the state comes back as this rank's
    blocks (``mamba2_mesh``)."""
    if is_dtensor(x):
        out, new = mamba2_mesh(params, x, cfg, ctx, None, return_state)
        return (out, new) if return_state else out
    dt_ = x.dtype
    zxbcdt = torch.matmul(x, params["in_proj"].to(dt_))
    z, xb, b, c, dt = _split_zxbcdt(zxbcdt, cfg)
    y, state = _mix(z, xb, b, c, dt, params, cfg, cfg.n_heads, None,
                    return_state)
    y = rms_norm(y, params["norm"])
    out = torch.matmul(y, params["out_proj"].to(dt_))
    out = shard(out, ctx, "batch", "act_seq", "act_embed")
    return (out, state) if return_state else out


def mamba2_mesh(params: dict, x, cfg: Mamba2Config, ctx: ShardingCtx,
                state: dict | None, want_state: bool, norm=rms_norm):
    """The block on a mesh: ``x`` (B,T,D) a DTensor, its rows split over
    the data axes. The packed ``in_proj`` runs column-parallel over its
    even split, and its output is joined whole on every rank (an
    all-gather of activations, never of the weight); each rank then takes
    its heads' ``z``, ``xb`` and ``dt`` columns and the whole ``B``, ``C``
    (an even split of the packed dim cuts through ``xb``, so the weight's
    shards are not the segments' heads). The conv runs on the rank's xb
    channels plus B, C, the SSD scan or its step on its heads. y·silu(z)
    is gathered over ``model`` before the gated norm and ``out_proj``:
    the norm's sum of squares over the whole ``d_inner`` and the
    contraction then run whole on every rank, in the unsharded order (an
    int8 hybrid on a mesh stays bitwise to one device). Heads that do
    not split over ``model`` run whole on every rank. ``norm`` is the
    gated norm (the mesh tests plant one that each rank takes over its
    own heads only).

    ``state`` (this layer's cache views, DTensors laid out by the cache
    axes) makes it a decode step. Returns (out DTensor, the new state as
    {"ssm": (block, offset), "conv": (block, offset)}: this rank's rows
    and heads of the scan state, and the whole conv tail of its rows,
    each with its global offset; or None)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = ctx.mesh
    names = tuple(mesh.mesh_dim_names)
    di, n, h, hp = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    ns, j = split_over(ctx, "model", h)
    hl = h // ns
    dil = hl * hp
    dt_ = x.dtype
    rows = row_placements(x)
    div = {a for a, p in zip(names, rows) if p.is_shard()}
    if ns > 1:
        div.add("model")
    def on_heads(dim, base):
        """``base`` with the heads (tensor dim ``dim``) split over
        ``model`` where they split."""
        return tuple(Shard(dim) if (a == "model" and ns > 1) else r
                     for a, r in zip(names, base))

    rep = (Replicate(),) * len(names)
    heads = on_heads(0, rep)

    zx = spmd_local(matmul_rows(x, params["in_proj"]), mesh, rows, div)
    z = zx[..., j * dil:(j + 1) * dil]
    xb = zx[..., di + j * dil:di + (j + 1) * dil]
    b, c = zx[..., 2 * di:2 * di + n], zx[..., 2 * di + n:2 * di + 2 * n]
    dt = zx[..., 2 * di + 2 * n + j * hl:2 * di + 2 * n + (j + 1) * hl]
    p = {k: spmd_local(params[k], mesh, heads, div)
         for k in ("A_log", "D", "dt_bias")}
    for k in ("conv_w", "conv_b"):
        w = spmd_local(params[k], mesh, rep, div)
        p[k] = torch.cat([w[..., j * dil:(j + 1) * dil], w[..., di:]], -1)
    local_state = None
    if state is not None:
        conv = redistribute(state["conv"], rows).to_local()
        local_state = {
            "ssm": redistribute(state["ssm"], on_heads(1, rows)
                                ).to_local(),
            "conv": torch.cat([conv[..., j * dil:(j + 1) * dil],
                               conv[..., di:]], -1)}
    y, new = _mix(z, xb, b, c, dt, p, cfg, hl, local_state, want_state)

    split = on_heads(2, rows)
    y = redistribute(spmd_global(y, mesh, split), rows)
    y = norm(y, gathered(params["norm"], None))
    out = shard(matmul_rows(y, params["out_proj"]), ctx, "batch",
                "act_seq", "act_embed")
    if new is None:
        return out, None
    row0 = local_offset(x, rows)[0]
    # the conv tail whole in its channels: the xb channels of every rank
    xbt = new["conv"]
    xs = redistribute(spmd_global(xbt[..., :dil].contiguous(), mesh, split),
                      rows).to_local()
    tail = torch.cat([xs, xbt[..., dil:]], -1)
    return out, {"ssm": (new["ssm"], (row0, j * hl, 0, 0)),
                 "conv": (tail, (row0, 0, 0))}


def mamba2_state_shape(cfg: Mamba2Config, batch: int) -> dict:
    return {
        "ssm": (batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
        "conv": (batch, cfg.d_conv - 1, cfg.conv_dim),
    }


def mamba2_decode_step(params: dict, x_t: torch.Tensor, state: dict,
                       cfg: Mamba2Config, ctx: ShardingCtx | None
                       ) -> tuple[torch.Tensor, dict]:
    """Single-token recurrent step. x_t: (B,D); state: {"ssm", "conv"}.
    Returns (y (B,D), the new state); ``state`` is not written. On a
    mesh (``x_t`` a DTensor) the new state is this rank's blocks with
    their offsets (``mamba2_mesh``)."""
    if is_dtensor(x_t):
        out, new = mamba2_mesh(params, x_t.unsqueeze(1), cfg, ctx, state,
                               False)
        return out.squeeze(1), new
    dt_ = x_t.dtype
    zxbcdt = torch.matmul(x_t, params["in_proj"].to(dt_))[:, None]
    z, xb, b, c, dt = _split_zxbcdt(zxbcdt, cfg)
    y, new = _mix(z, xb, b, c, dt, params, cfg, cfg.n_heads, state, False)
    y = rms_norm(y[:, 0], params["norm"])
    out = torch.matmul(y, params["out_proj"].to(dt_))
    return out, new
