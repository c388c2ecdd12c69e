"""RWKV-6 "Finch", data-dependent-decay linear attention
[arXiv:2404.05892]; port of ``repro.models.rwkv6``.

The per-channel decay w_t is a function of the input (a small LoRA), so
the recurrence
  S_t = diag(w_t) · S_{t-1} + k_tᵀ · v_t
  y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
has token-dependent forgetting. Token shift (x_{t-1} ↔ x_t lerp) is a
K=2 causal window, the degenerate form of the paper's line buffer;
decode carries a single-sample shift state (DESIGN.md §5).

Time mixing runs as a chunked scan: within a chunk of q tokens the
contributions are cumulative-decay contractions (GLA-style), across
chunks a loop carries the (H, dk, dv) state: O(T·q) work in T/q
sequential steps. T must be a whole number of chunks; a 1-token call
with a state takes the recurrent path instead.

Where the semantics hide:

* a prefill starts the scan from the state it is given, but shifts its
  tokens from zeros (the shift states are only read by a decode step);
* a prefill stores ``wkv`` in the activation dtype, a decode step in the
  state's dtype;
* the decay LoRA runs in fp32, and ``_group_norm`` (RWKV's ``ln_x``)
  normalizes each head in fp32 with eps 1e-5;
* the sigmoid and silu round after each op of 1 / (1 + exp(-x)), as
  XLA's do (``common.sigmoid_per_op``), so a bf16 block is bitwise to
  the reference run op by op.

``rwkv6_axes`` is the block's logical axes; ``rwkv6_mesh`` runs the
block on a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.common import (chunk_scan, dense_init, layer_norm,
                                       sigmoid_per_op, silu_per_op)
from repro_torch.sharding.logical import (A, ShardingCtx, is_dtensor,
                                          local_offset, matmul_rows,
                                          redistribute, row_placements,
                                          shard, split_over, spmd_global,
                                          spmd_local)

__all__ = ["RWKV6Config", "rwkv6_init", "rwkv6_axes", "rwkv6_apply",
           "rwkv6_decode_step", "rwkv6_mesh", "rwkv6_state_shape"]


@dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    d_ff: int
    head_dim: int = 64
    lora_rank: int = 64
    chunk: int = 64

    @property
    def n_heads(self) -> int:
        assert self.d_model % self.head_dim == 0
        return self.d_model // self.head_dim


def rwkv6_init(gen: torch.Generator, cfg: RWKV6Config,
               device: torch.device) -> dict:
    d, f, r = cfg.d_model, cfg.d_ff, cfg.lora_rank
    h, hd = cfg.n_heads, cfg.head_dim
    ones = lambda *s: torch.ones(s, device=device)      # noqa: E731
    zeros = lambda *s: torch.zeros(s, device=device)    # noqa: E731
    return {
        # pre-mix LayerNorms (official RWKV block layout)
        "ln1": ones(d), "ln1_b": zeros(d),
        "ln2": ones(d), "ln2_b": zeros(d),
        # time mixing
        "mix": 0.5 * ones(5, d),                  # r,k,v,w,g static lerp
        "w0": torch.linspace(-6.0, -1.0, d, device=device),  # log-log decay
        "w_lora_a": dense_init(gen, (d, r), d, device),
        "w_lora_b": dense_init(gen, (r, d), r, device) * 0.1,
        "u": zeros(h, hd),                        # current-token bonus
        "wr": dense_init(gen, (d, d), d, device),
        "wk": dense_init(gen, (d, d), d, device),
        "wv": dense_init(gen, (d, d), d, device),
        "wg": dense_init(gen, (d, d), d, device),
        "wo": dense_init(gen, (d, d), d, device),
        "ln_x": ones(d),                          # per-head group norm scale
        # channel mixing
        "cmix": 0.5 * ones(2, d),                 # k,r lerp
        "ck": dense_init(gen, (d, f), d, device),
        "cv": dense_init(gen, (f, d), f, device),
        "cr": dense_init(gen, (d, d), d, device),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """x_{t-1} stream: (B,T,D) -> (B,T,D). prev: (B,D) decode shift
    state."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1, :]
    return prev[:, None, :]


def _group_norm(x: torch.Tensor, scale: torch.Tensor, n_heads: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm over head_dim (RWKV's ln_x), in fp32."""
    b, t, d = x.shape
    xh = x.reshape(b, t, n_heads, d // n_heads).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    var = ((xh - mu) ** 2).mean(-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b, t, d) * scale.to(torch.float32)).to(x.dtype)


def _wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """Chunked WKV recurrence.

    r, k, v: (B,T,H,hd); logw: (B,T,H,hd) (log decay, < 0); u: (H,hd);
    state: (B,H,hd,hd) initial. Returns (y (B,T,H,hd) fp32, final state
    fp32)."""
    b, t, h, n = r.shape
    q = chunk
    if t % q:
        raise ValueError(f"WKV scan over {t} tokens: not a whole number of "
                         f"chunks of {q} (prompts must be)")
    nc = t // q
    f32 = torch.float32
    rs = r.reshape(b, nc, q, h, n).to(f32)
    ks = k.reshape(b, nc, q, h, n).to(f32)
    vs = v.reshape(b, nc, q, h, n).to(f32)
    lw = logw.reshape(b, nc, q, h, n).to(f32)

    # cumulative decay within the chunk: W[i] = exp(Σ_{j<=i} logw_j)
    cum = torch.cumsum(lw, dim=2)                       # (B,nc,q,H,N)
    # decay applied to the incoming state at position i: Π_{j<i} w_j (RWKV
    # decays S BEFORE adding the current token's kᵀv, which enters through
    # the u-bonus instead)
    ci = cum - lw                                       # Σ_{m<i}
    dec_in = torch.exp(ci)
    # key j's contribution surviving to the chunk end: Π_{j<m<=q-1} w_m
    dec_out = torch.exp(cum[:, :, -1:, :, :] - cum)

    # intra-chunk token to token: key j visible to query i > j with decay
    # Π_{j<m<i} w_m = exp(ci[i] - cum[j]); masked entries clamped before
    # the exp, so nothing overflows
    expo = ci[:, :, :, None, :, :] - cum[:, :, None, :, :, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device),
                      -1)[None, None, :, :, None, None]
    pair = torch.exp(torch.where(mask, expo, -1e30)) * mask  # strictly j < i

    # "bzihn,bzjhn,bzijhn->bzijh", then with v
    att = ((rs[:, :, :, None] * ks[:, :, None]) * pair).sum(-1)
    y_intra = torch.einsum("bzijh,bzjhm->bzihm", att, vs)
    # u-bonus (current token): "bzihn,hn,bzihn->bzih"
    bonus = (rs * u.to(f32) * ks).sum(-1)
    y_intra = y_intra + bonus[..., None] * vs

    # per-chunk state update pieces: "bzjhn,bzjhn,bzjhm->bzhnm"
    chunk_k = torch.einsum("bzjhn,bzjhm->bzhnm", ks * dec_out, vs)
    chunk_decay = torch.exp(cum[:, :, -1])              # (B,nc,H,N)

    # the inter-chunk scan, emitting the state BEFORE each chunk
    prev, final = chunk_scan(state.to(f32), chunk_decay[..., None],
                             chunk_k)                   # (B,nc,H,N,M)

    # "bzihn,bzihn,bzhnm->bzihm"
    y_state = torch.einsum("bzihn,bzhnm->bzihm", rs * dec_in, prev)
    y = (y_intra + y_state).reshape(b, t, h, n)
    return y, final


def rwkv6_axes(cfg: RWKV6Config) -> dict:
    return {
        "ln1": A(None), "ln1_b": A(None), "ln2": A(None), "ln2_b": A(None),
        "mix": A(None, None), "w0": A(None),
        "w_lora_a": A("embed", None), "w_lora_b": A(None, "embed"),
        "u": A("ssm_heads", None),
        "wr": A("embed", "ssm_inner"), "wk": A("embed", "ssm_inner"),
        "wv": A("embed", "ssm_inner"), "wg": A("embed", "ssm_inner"),
        "wo": A("ssm_inner", "embed"), "ln_x": A(None),
        "cmix": A(None, None),
        "ck": A("embed", "mlp"), "cv": A("mlp", "embed"),
        "cr": A("embed", "ssm_inner"),
    }


def _time_mix(xin: torch.Tensor, xprev: torch.Tensor, p: dict,
              heads: int, hd: int, wkv: torch.Tensor | None,
              decode: bool, chunk: int):
    """The time mix of ``heads`` heads from the LN'd stream ``xin`` and
    its shift ``xprev`` (B,T,D), up to the ``wo`` projection: ``p`` holds
    ``mix``, ``w_lora_a`` whole, and ``wr``/``wk``/``wv``/``wg``
    (D, heads·hd), ``w_lora_b`` (r, heads·hd), ``w0`` and ``ln_x``
    (heads·hd,), ``u`` (heads, hd) of these heads. ``wkv`` (B, heads,
    hd, hd) is the state the scan starts from (None: zeros). Returns
    (y = ln_x(wkv out) · g (B,T,heads·hd) in the model dtype, the new
    ``wkv``: a decode step's in ``wkv``'s dtype, a scan's in the model
    dtype)."""
    b, t, _ = xin.shape
    dt_ = xin.dtype
    f32 = torch.float32
    mix = p["mix"].to(dt_)
    xr, xk, xv, xw, xg = (xin + (xprev - xin) * mix[i] for i in range(5))

    r = torch.matmul(xr, p["wr"].to(dt_))
    k = torch.matmul(xk, p["wk"].to(dt_))
    v = torch.matmul(xv, p["wv"].to(dt_))
    g = silu_per_op(torch.matmul(xg, p["wg"].to(dt_)))
    # data-dependent decay (the Finch contribution), in fp32
    wlo = torch.tanh(torch.matmul(xw.to(f32), p["w_lora_a"].to(f32)))
    wlo = torch.matmul(wlo, p["w_lora_b"].to(f32))
    logw = -torch.exp(p["w0"].to(f32) + wlo)                 # < 0

    rh, kh, vh, lwh = (z.reshape(b, t, heads, hd) for z in (r, k, v, logw))

    if decode:
        s = wkv.to(f32)
        w_t = torch.exp(lwh[:, 0])                             # (B,H,hd)
        kv = kh[:, 0].to(f32)[..., :, None] * vh[:, 0].to(f32)[..., None, :]
        y = torch.einsum("bhn,bhnm->bhm", rh[:, 0].to(f32),
                         s + p["u"].to(f32)[None, :, :, None] * kv)
        s = s * w_t[..., None] + kv
        y = y[:, None]                                         # (B,1,H,hd)
        new = s.to(wkv.dtype)
    else:
        s0 = wkv if wkv is not None else torch.zeros(
            (b, heads, hd, hd), device=xin.device)
        y, sf = _wkv_chunked(rh, kh, vh, lwh, p["u"], s0, chunk)
        new = sf.to(dt_)

    y = y.reshape(b, t, heads * hd).to(dt_)
    return _group_norm(y, p["ln_x"], heads) * g, new


def _channel_mix(xcin: torch.Tensor, xprev: torch.Tensor, p: dict):
    """(kk = relu(xk·ck)², sigmoid(xr·cr)) of the channel mix from the
    LN'd stream and its shift, over the columns of ``p``'s ``ck`` and
    ``cr``."""
    dt_ = xcin.dtype
    cmix = p["cmix"].to(dt_)
    xk2 = xcin + (xprev - xcin) * cmix[0]
    xr2 = xcin + (xprev - xcin) * cmix[1]
    kk = torch.square(torch.relu(torch.matmul(xk2, p["ck"].to(dt_))))
    rr = sigmoid_per_op(torch.matmul(xr2, p["cr"].to(dt_)))
    return kk, rr


def rwkv6_apply(params: dict, x: torch.Tensor, cfg: RWKV6Config,
                ctx: ShardingCtx | None, state: dict | None = None
                ) -> tuple[torch.Tensor, dict | None]:
    """One RWKV6 block (time-mix + channel-mix). x: (B,T,D).

    state: {"shift_t", "shift_c": (B,D), "wkv": (B,H,hd,hd)} or None. A
    1-token call with a state is a decode step (the recurrent path);
    otherwise T must be a whole number of ``cfg.chunk``. Returns (out,
    the new state, or None without one); ``state`` is not written. On a
    mesh (``x`` a DTensor) the new state is this rank's blocks with
    their offsets (``rwkv6_mesh``)."""
    if is_dtensor(x):
        return rwkv6_mesh(params, x, cfg, ctx, state)
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    decode = state is not None and t == 1
    dt_ = x.dtype

    # ---- time mixing (on the LN'd stream, residual to raw x) ----
    xin = layer_norm(x, params["ln1"], params["ln1_b"])
    xprev = _token_shift(xin, state["shift_t"] if decode else None)
    y, wkv = _time_mix(xin, xprev, params, h, hd,
                       None if state is None else state["wkv"], decode,
                       cfg.chunk)
    out = torch.matmul(y, params["wo"].to(dt_))
    out = shard(out, ctx, "batch", "act_seq", "act_embed")
    x_mid = x + out

    # ---- channel mixing (on the LN'd stream) ----
    xcin = layer_norm(x_mid, params["ln2"], params["ln2_b"])
    xprev = _token_shift(xcin, state["shift_c"] if decode else None)
    kk, rr = _channel_mix(xcin, xprev, params)
    kk = shard(kk, ctx, "batch", "act_seq", "act_mlp")
    vv = torch.matmul(kk, params["cv"].to(dt_))
    x_out = x_mid + rr * vv

    if state is not None:
        return x_out, {"wkv": wkv, "shift_t": xin[:, -1, :],
                       "shift_c": xcin[:, -1, :]}
    return x_out, None


def rwkv6_mesh(params: dict, x, cfg: RWKV6Config, ctx: ShardingCtx,
               state: dict | None):
    """The block on a mesh: ``x`` (B,T,D) a DTensor, its rows split over
    the data axes, whole over ``model``. Each rank runs the time mix on
    its heads (``wr``/``wk``/``wv``/``wg`` column-parallel, the decay's
    LoRA output, ``u`` and the ``ln_x`` group norm sliced to them, the
    WKV scan or step local to them); the heads are gathered before
    ``wo``, which runs whole on every rank. In the channel mix ``ck`` is
    column- and ``cv`` row-parallel (their product summed over
    ``model``), ``cr`` column-parallel: ``sigmoid(rr)`` is gathered
    whole to meet ``vv``. Heads or hidden dims that do not split over
    ``model`` run whole on every rank.

    Returns (out DTensor, the new state as {name: (block, offset)}: this
    rank's rows and heads of ``wkv``, its rows of the shifts; or None)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = ctx.mesh
    names = tuple(mesh.mesh_dim_names)
    t = x.shape[1]
    h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    ns, j = split_over(ctx, "model", h, cfg.d_ff)
    hl = h // ns
    dl = hl * hd
    decode = state is not None and t == 1
    dt_ = x.dtype
    rows = row_placements(x)
    div = {a for a, p in zip(names, rows) if p.is_shard()}
    if ns > 1:
        div.add("model")

    def on(dim, base=(Replicate(),) * len(names), how=None):
        """``base`` with tensor dim ``dim`` split over ``model`` (or
        ``how`` there) where the heads split."""
        return tuple((how or Shard(dim)) if (a == "model" and ns > 1)
                     else r for a, r in zip(names, base))

    rep = (Replicate(),) * len(names)
    p = {k: spmd_local(params[k], mesh, rep, div)
         for k in ("ln1", "ln1_b", "ln2", "ln2_b", "mix", "cmix",
                   "w_lora_a")}
    for k in ("w0", "ln_x"):
        p[k] = spmd_local(params[k], mesh, rep, div)[j * dl:(j + 1) * dl]
    p["w_lora_b"] = spmd_local(params["w_lora_b"], mesh, rep,
                               div)[:, j * dl:(j + 1) * dl]
    p["u"] = spmd_local(params["u"], mesh, on(0), div)
    for k in ("wr", "wk", "wv", "wg", "ck", "cr"):
        p[k] = spmd_local(params[k], mesh, on(1), div)
    p["cv"] = spmd_local(params["cv"], mesh, on(0), div)
    st = None
    if state is not None:
        st = {k: redistribute(state[k], on(1, rows) if k == "wkv"
                              else rows).to_local() for k in state}

    # ---- time mixing on this rank's heads ----
    xl = spmd_local(x, mesh, rows, div)
    xin = layer_norm(xl, p["ln1"], p["ln1_b"])
    xprev = _token_shift(xin, st["shift_t"] if decode else None)
    y, wkv = _time_mix(xin, xprev, p, hl, hd,
                       None if st is None else st["wkv"], decode, cfg.chunk)
    y = redistribute(spmd_global(y, mesh, on(2, rows)), rows)
    x_mid = x + shard(matmul_rows(y, params["wo"]), ctx, "batch",
                      "act_seq", "act_embed")

    # ---- channel mixing: ck | cv over model, sigmoid(rr) gathered ----
    xcin = layer_norm(spmd_local(x_mid, mesh, rows, div), p["ln2"],
                      p["ln2_b"])
    xprev = _token_shift(xcin, st["shift_c"] if decode else None)
    kk, rr = _channel_mix(xcin, xprev, p)
    vv = spmd_global(torch.matmul(kk, p["cv"].to(dt_)), mesh,
                     on(2, rows, Partial()))
    vv = vv.redistribute(mesh, rows)
    rr = redistribute(spmd_global(rr, mesh, on(2, rows)), rows)
    x_out = x_mid + rr * vv
    if state is None:
        return x_out, None
    row0 = local_offset(x, rows)[0]
    return x_out, {"wkv": (wkv, (row0, j * hl, 0, 0)),
                   "shift_t": (xin[:, -1, :], (row0, 0)),
                   "shift_c": (xcin[:, -1, :], (row0, 0))}


def rwkv6_state_shape(cfg: RWKV6Config, batch: int) -> dict:
    h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    return {"wkv": (batch, h, hd, hd), "shift_t": (batch, d),
            "shift_c": (batch, d)}


def rwkv6_decode_step(params: dict, x_t: torch.Tensor, state: dict,
                      cfg: RWKV6Config, ctx: ShardingCtx | None
                      ) -> tuple[torch.Tensor, dict]:
    """x_t: (B,D) -> (y (B,D), new_state). Wraps apply with T=1."""
    y, new_state = rwkv6_apply(params, x_t[:, None, :], cfg, ctx, state)
    return y[:, 0, :], new_state
