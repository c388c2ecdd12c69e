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

The logical-axis annotations (``rwkv6_axes``) wait for the LM half of
ROADMAP §A.10.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.common import (chunk_scan, dense_init, layer_norm,
                                       sigmoid_per_op, silu_per_op)
from repro_torch.sharding.logical import ShardingCtx, shard

__all__ = ["RWKV6Config", "rwkv6_init", "rwkv6_apply", "rwkv6_decode_step",
           "rwkv6_state_shape"]


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


def rwkv6_apply(params: dict, x: torch.Tensor, cfg: RWKV6Config,
                ctx: ShardingCtx | None, state: dict | None = None
                ) -> tuple[torch.Tensor, dict | None]:
    """One RWKV6 block (time-mix + channel-mix). x: (B,T,D).

    state: {"shift_t", "shift_c": (B,D), "wkv": (B,H,hd,hd)} or None. A
    1-token call with a state is a decode step (the recurrent path);
    otherwise T must be a whole number of ``cfg.chunk``. Returns (out,
    the new state, or None without one); ``state`` is not written."""
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    decode = state is not None and t == 1
    dt_ = x.dtype
    f32 = torch.float32

    # ---- time mixing (on the LN'd stream, residual to raw x) ----
    xin = layer_norm(x, params["ln1"], params["ln1_b"])
    xprev = _token_shift(xin, state["shift_t"] if decode else None)
    mix = params["mix"].to(dt_)
    xr, xk, xv, xw, xg = (xin + (xprev - xin) * mix[i] for i in range(5))

    r = torch.matmul(xr, params["wr"].to(dt_))
    k = torch.matmul(xk, params["wk"].to(dt_))
    v = torch.matmul(xv, params["wv"].to(dt_))
    g = silu_per_op(torch.matmul(xg, params["wg"].to(dt_)))
    # data-dependent decay (the Finch contribution), in fp32
    wlo = torch.tanh(torch.matmul(xw.to(f32), params["w_lora_a"].to(f32)))
    wlo = torch.matmul(wlo, params["w_lora_b"].to(f32))
    logw = -torch.exp(params["w0"].to(f32) + wlo)             # < 0

    rh, kh, vh, lwh = (z.reshape(b, t, h, hd) for z in (r, k, v, logw))

    if decode:
        s = state["wkv"].to(f32)
        w_t = torch.exp(lwh[:, 0])                             # (B,H,hd)
        kv = kh[:, 0].to(f32)[..., :, None] * vh[:, 0].to(f32)[..., None, :]
        y = torch.einsum("bhn,bhnm->bhm", rh[:, 0].to(f32),
                         s + params["u"].to(f32)[None, :, :, None] * kv)
        s = s * w_t[..., None] + kv
        y = y[:, None]                                         # (B,1,H,hd)
        new_state = {"wkv": s.to(state["wkv"].dtype),
                     "shift_t": xin[:, -1, :]}
    else:
        s0 = state["wkv"] if state is not None else torch.zeros(
            (b, h, hd, hd), device=x.device)
        y, sf = _wkv_chunked(rh, kh, vh, lwh, params["u"], s0, cfg.chunk)
        new_state = {"wkv": sf.to(dt_), "shift_t": xin[:, -1, :]}

    y = y.reshape(b, t, d).to(dt_)
    y = _group_norm(y, params["ln_x"], h) * g
    out = torch.matmul(y, params["wo"].to(dt_))
    out = shard(out, ctx, "batch", "act_seq", "act_embed")
    x_mid = x + out

    # ---- channel mixing (on the LN'd stream) ----
    xcin = layer_norm(x_mid, params["ln2"], params["ln2_b"])
    xprev = _token_shift(xcin, state["shift_c"] if decode else None)
    cmix = params["cmix"].to(dt_)
    xk2 = xcin + (xprev - xcin) * cmix[0]
    xr2 = xcin + (xprev - xcin) * cmix[1]
    kk = torch.square(torch.relu(torch.matmul(xk2, params["ck"].to(dt_))))
    kk = shard(kk, ctx, "batch", "act_seq", "act_mlp")
    vv = torch.matmul(kk, params["cv"].to(dt_))
    rr = sigmoid_per_op(torch.matmul(xr2, params["cr"].to(dt_)))
    x_out = x_mid + rr * vv

    if state is not None:
        new_state["shift_c"] = xcin[:, -1, :]
        return x_out, new_state
    return x_out, None


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
