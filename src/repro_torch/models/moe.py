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
reference's einsums do. ``moe_axes`` is the layer's logical axes.

On a mesh whose ``model`` axis divides ``n_experts`` the layer is the
reference's expert-parallel ``_moe_apply_ep``, whose semantics differ
from the local path's wherever tokens drop (``_ep_local``): each data
shard is one dispatch group, its capacity counted over all of its
tokens; a model rank dispatches the assignments of its ``E/n`` experts
and sends the others to a drop row; the aux loss is each data shard's
estimate, averaged over the data axes; the shared expert's hidden dim is
split over ``model``, and its partial rides the one sum over ``model``
that combines the ranks' outputs, in ``x.dtype`` as the reference's
``psum`` sums them. ``moe_apply_ep_ref`` is the same arithmetic on one
device, looping over the shards. On any other mesh the local path runs
whole on every rank. ``routing_trace`` exposes the expert-parallel
layer's routing, and can make it replay another run's;
``local_routing_trace`` exposes the local path's.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.common import ACTIVATIONS, _const, dense_init
from repro_torch.sharding.logical import (A, ShardingCtx, gathered,
                                          mesh_sizes, on_mesh, shard,
                                          spmd_global, spmd_local)

__all__ = ["MoEConfig", "moe_init", "moe_axes", "moe_apply",
           "moe_apply_ep_ref", "routing_trace", "local_routing_trace"]


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


def moe_axes(cfg: MoEConfig) -> dict:
    ax = {
        "router": A("embed", None),
        "wi": A("expert", "embed", "mlp"),
        "wo": A("expert", "mlp", "embed"),
    }
    if cfg.gated:
        ax["wg"] = A("expert", "embed", "mlp")
    if cfg.n_shared:
        ax["shared_wi"] = A("embed", "mlp")
        ax["shared_wo"] = A("mlp", "embed")
        if cfg.gated:
            ax["shared_wg"] = A("embed", "mlp")
    return ax


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

    Dispatches as the reference does: to the expert-parallel path where
    the mesh has a ``model`` axis that divides ``n_experts``, else to the
    local path (on a mesh, whole on every rank)."""
    if on_mesh(ctx):
        n_model = mesh_sizes(ctx.mesh).get("model")
        if n_model is not None and cfg.n_experts % n_model == 0:
            return _moe_apply_ep(params, x, cfg, ctx, n_model)
        return _moe_apply_whole(params, x, cfg, ctx)
    return _moe_apply_local(params, x, cfg)


def _moe_apply_local(params: dict, x: torch.Tensor, cfg: MoEConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The local path (the reference's ``_moe_apply_local``) on plain
    tensors: group-wise dispatch, each batch row a group with its own
    capacity."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, cfg)
    act = ACTIVATIONS[cfg.act]
    dev = x.device

    _, top_w, top_e, aux = _route(params, x, cfg)

    # --- group-local dispatch: position within (row, expert) ---
    flat_e = top_e.reshape(b, s * k)
    pos_c, keep = _slots(flat_e, e, cap)
    local_log = _LOCAL_TRACE.get()
    if local_log is not None:
        local_log.append((flat_e, keep))
    src = torch.arange(s, device=dev).repeat_interleave(k)
    brow = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    buf = torch.zeros((b, e, cap + 1, d), dtype=x.dtype, device=dev)
    buf[brow, flat_e, pos_c] = x[:, src, :]

    # --- expert FFN (B, E, C, D) ---
    y = _ffn(buf[:, :, :cap, :], params["wi"],
             params.get("wg") if cfg.gated else None, params["wo"], act,
             "becd,edf->becf", "becf,efd->becd")

    # --- combine: row-local gather + routing weights ---
    y = F.pad(y, (0, 0, 0, 1))                          # the drop slot
    picked = y[brow, flat_e, pos_c]                     # (B, S·k, D)
    w = (top_w.reshape(b, s * k) * keep).to(x.dtype)
    out = _combine(picked, w, b, s, k)

    # --- shared experts (always on) ---
    if cfg.n_shared:
        out = out + _ffn(x, params["shared_wi"],
                         params.get("shared_wg") if cfg.gated else None,
                         params["shared_wo"], act, "bsd,df->bsf",
                         "bsf,fd->bsd")
    return out, aux


def _moe_apply_whole(params: dict, x, cfg: MoEConfig, ctx: ShardingCtx):
    """The local path on a mesh whose ``model`` axis does not divide the
    experts: ``x`` and the params gathered whole, the layer run on every
    rank alike (so each rank's gradients are the whole ones), the output
    laid out as the activations."""
    from torch.distributed.tensor import Replicate
    mesh = ctx.mesh
    rep = (Replicate(),) * mesh.ndim
    xl = spmd_local(x, mesh, rep)
    pl = {k: spmd_local(gathered(v, None), mesh, rep)
          for k, v in params.items()}
    out, aux = _moe_apply_local(pl, xl, cfg)
    return (shard(spmd_global(out, mesh, rep), ctx, "batch", "act_seq",
                  "act_embed"), spmd_global(aux, mesh, rep))


def _dp_axes(sizes: dict, batch: int) -> tuple[str, ...]:
    """The data axes the expert-parallel layer splits the batch over
    (the reference's search): ("pod", "data"), then ("data",), then
    ("pod",), each only where every axis exists and the product of
    their sizes exceeds 1 and divides ``batch``; else none."""
    for cand in (("pod", "data"), ("data",), ("pod",)):
        if all(a in sizes for a in cand):
            prod = math.prod(sizes[a] for a in cand)
            if prod > 1 and batch % prod == 0:
                return cand
    return ()


_TRACE: contextvars.ContextVar = contextvars.ContextVar("moe_routing_trace",
                                                       default=None)


@contextlib.contextmanager
def routing_trace(replay=None):
    """Expose the expert-parallel layer's routing: yields a list to which
    each dispatch (one data shard on one model rank) appends, in call
    order and on the CPU, {"j": model rank, "e_l": its expert count,
    "top_e" (T, k) the experts it dispatched to, "keep" (T·k,) bool: owned
    by this rank and within capacity, "probs" (T, E) fp32: its own router
    probabilities}. With ``replay`` (an iterable of (T, k) expert choices,
    one a dispatch in call order) each dispatch takes its experts from it
    in place of its own top-k, their weights renormed from its own
    probabilities (the aux loss stays its own): a one-device run then
    does another run's routing, so that only the arithmetic around the
    routing is compared."""
    state = {"log": [], "replay": None if replay is None else iter(replay)}
    token = _TRACE.set(state)
    try:
        yield state["log"]
    finally:
        _TRACE.reset(token)


_LOCAL_TRACE: contextvars.ContextVar = contextvars.ContextVar(
    "moe_local_routing_trace", default=None)


@contextlib.contextmanager
def local_routing_trace():
    """Expose the local path's routing (``_moe_apply_local``, on one
    device or run whole on every rank): yields a list to which each layer
    call appends (flat experts (B, S·k), keep (B, S·k) bool: within
    capacity), as the device tensors the layer computed, with no host
    sync."""
    log: list = []
    token = _LOCAL_TRACE.set(log)
    try:
        yield log
    finally:
        _LOCAL_TRACE.reset(token)


def _ep_local(xl: torch.Tensor, p: dict, cfg: MoEConfig, j: int,
              e_l: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One (data shard, model rank j)'s share of the expert-parallel
    layer, on local tensors: xl (B_l, S, D); ``p`` holds the router
    (D, E), this rank's experts ``wi``/``wg`` (E_l, D, F), ``wo`` (E_l,
    F, D) and its slice of the shared expert's hidden dim, all in
    ``xl.dtype`` but the router; ``cap`` the shard's capacity, counted
    over all of its tokens (``_capacity(B_l · S)``: one dispatch group).
    Returns (the rank's partial output (B_l, S, D) in ``xl.dtype``: its
    experts' routed sum plus its shared partial; the shard's aux loss ()
    fp32), and records its routing in a ``routing_trace``."""
    bl, s, d = xl.shape
    t = bl * s
    e, k = cfg.n_experts, cfg.top_k
    act = ACTIVATIONS[cfg.act]
    dev, dt = xl.device, xl.dtype
    probs, top_w, top_e, aux = _route(p, xl, cfg)
    trace = _TRACE.get()
    if trace is not None and trace["replay"] is not None:
        top_e = torch.as_tensor(next(trace["replay"]),
                                device=dev).reshape(bl, s, k)
        top_w = torch.gather(probs, -1, top_e)
        top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # --- this rank's experts: positions over the shard's (t·k) flattened
    # assignments, the others (and the overflow) to the drop row e_l ---
    flat_e = top_e.reshape(t * k)
    local_e = flat_e - j * e_l
    owned = (local_e >= 0) & (local_e < e_l)
    le = torch.where(owned, local_e, e_l)
    onehot = F.one_hot(le, e_l + 1)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = owned & (pos < cap)
    pos_c = torch.where(keep, pos, cap)
    le_c = torch.where(keep, le, e_l)
    if trace is not None:
        trace["log"].append({"j": j, "e_l": e_l,
                             "top_e": top_e.reshape(t, k).cpu(),
                             "keep": keep.cpu(),
                             "probs": probs.detach().reshape(t, e).cpu()})

    xt = xl.reshape(t, d)
    src = torch.arange(t, device=dev).repeat_interleave(k)
    buf = torch.zeros((e_l + 1, cap + 1, d), dtype=dt, device=dev)
    buf[le_c, pos_c] = xt[src]
    y = _ffn(buf[:e_l, :cap], p["wi"], p.get("wg") if cfg.gated else None,
             p["wo"], act, "ecd,edf->ecf", "ecf,efd->ecd")
    y = F.pad(y, (0, 0, 0, 1, 0, 1))                    # the drop row, col
    w = (top_w.reshape(t * k) * keep).to(dt)
    out = _combine(y[le_c, pos_c], w, t, 1, k).reshape(t, d)
    if cfg.n_shared:                                    # F split: partial
        out = out + _ffn(xt, p["shared_wi"],
                         p.get("shared_wg") if cfg.gated else None,
                         p["shared_wo"], act, "td,df->tf", "tf,fd->td")
    return out.reshape(bl, s, d), aux


def _ep_params(params: dict, cfg: MoEConfig, j: int, n_model: int,
               dtype: torch.dtype) -> dict:
    """Rank j's share of whole params (``moe_apply_ep_ref``): its
    ``E/n`` experts and its slice of the shared hidden dim, cast to
    ``dtype`` (the router stays as it is)."""
    e_l = cfg.n_experts // n_model
    out = {"router": params["router"]}
    for name in ("wi", "wg", "wo"):
        if name in params:
            out[name] = params[name][j * e_l:(j + 1) * e_l].to(dtype)
    if cfg.n_shared:
        f_l = params["shared_wi"].shape[1] // n_model
        for name, dim in (("shared_wi", 1), ("shared_wg", 1),
                          ("shared_wo", 0)):
            if name in params:
                out[name] = params[name].narrow(dim, j * f_l, f_l
                                                ).to(dtype)
    return out


def moe_apply_ep_ref(params: dict, x: torch.Tensor, cfg: MoEConfig,
                     n_data: int, n_model: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel layer on one device: ``x`` (B, S, D) and whole
    params, the mesh (n_data, n_model) walked shard by shard (data shard
    by data shard, model rank by model rank). Each data shard (the batch
    split ``n_data`` ways where that divides it and ``n_data`` > 1, else
    one shard) sums its model ranks' partial outputs in rank order in
    ``x.dtype``; the aux loss is the shards' mean. Returns (out, aux)."""
    b = x.shape[0]
    nd = n_data if (n_data > 1 and b % n_data == 0) else 1
    e_l = cfg.n_experts // n_model
    bl = b // nd
    cap = _capacity(bl * x.shape[1], cfg)
    outs, auxes = [], []
    for i in range(nd):
        xl = x[i * bl:(i + 1) * bl]
        acc = None
        for j in range(n_model):
            part, aux = _ep_local(
                xl, _ep_params(params, cfg, j, n_model, x.dtype), cfg, j,
                e_l, cap)
            acc = part if acc is None else acc + part
        outs.append(acc)
        auxes.append(aux)
    out = torch.cat(outs, dim=0)
    aux = torch.stack(auxes).sum() / _const(nd, x) if nd > 1 else auxes[0]
    return out, aux


def _dp_mean(aux: torch.Tensor, mesh, dp: tuple[str, ...]):
    """The shards' aux losses averaged over the data axes ``dp`` (the
    reference's ``pmean``), as a DTensor replicated everywhere: each
    shard's aux / n summed, so that its gradient is 1/n a shard."""
    from torch.distributed.tensor import Partial, Replicate
    n = math.prod(mesh_sizes(mesh)[a] for a in dp)
    names = mesh.mesh_dim_names
    part = spmd_global(aux / _const(n, aux) if n > 1 else aux, mesh,
                       [Partial() if a in dp else Replicate()
                        for a in names])
    return part.redistribute(mesh, [Replicate()] * mesh.ndim)


def _moe_apply_ep(params: dict, x, cfg: MoEConfig, ctx: ShardingCtx,
                  n_model: int, capacity: int | None = None,
                  aux_mean=None):
    """The reference's ``_moe_apply_ep`` over DTensors, each rank's share
    on its local tensors (``_ep_local``; ``spmd_local`` stands in for
    shard_map's in_specs). ``x`` comes in split over the data axes
    ``_dp_axes`` finds and whole over ``model`` (a sequence split over
    ``model`` is gathered here and laid out again after); the experts'
    weights are cast to ``x.dtype`` before their gather over the data
    axes, and each rank keeps its ``E/n`` experts. The ranks' partial
    outputs are summed over ``model`` (DTensor ``Partial`` to
    ``Replicate``: one all-reduce, and under autograd each rank's
    gradient is the whole one). Under autograd ``x`` and the router get
    partial gradients over ``model`` (each rank routes to its own
    experts) and the data axes; the aux loss, the same on every model
    rank, carries its gradient from model rank 0 alone. ``capacity``
    (default: over the shard's tokens) and ``aux_mean`` (default
    ``_dp_mean``) are what the mesh tests plant faults through."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = ctx.mesh
    names = tuple(mesh.mesh_dim_names)
    dp = _dp_axes(mesh_sizes(mesh), x.shape[0])
    j = mesh.get_local_rank("model")
    e_l = cfg.n_experts // n_model
    rows = tuple(Shard(0) if a in dp else Replicate() for a in names)
    div = set(dp) | {"model"}

    def place(dim):
        return tuple(Shard(dim) if (a == "model" and dim is not None)
                     else Replicate() for a in names)

    def weight(name, dim):
        w = params[name]
        w = w.to(x.dtype) if name != "router" else w
        return spmd_local(gathered(w), mesh, place(dim), div)

    p = {"router": weight("router", None)}
    for name in ("wi", "wg", "wo"):
        if name in params:
            p[name] = weight(name, 0)
    if cfg.n_shared:
        f = params["shared_wi"].shape[1]
        if f % n_model:
            raise ValueError(
                f"the shared expert's hidden dim {f} does not split over "
                f"model={n_model} (the expert-parallel layer splits it)")
        for name, dim in (("shared_wi", 1), ("shared_wg", 1),
                          ("shared_wo", 0)):
            if name in params:
                p[name] = weight(name, dim)
    xl = spmd_local(x, mesh, rows, div)
    if capacity is None:
        capacity = _capacity(xl.shape[0] * xl.shape[1], cfg)
    out, aux = _ep_local(xl, p, cfg, j, e_l, capacity)
    out = spmd_global(out, mesh, tuple(
        Partial() if a == "model" else r for a, r in zip(names, rows)))
    out = out.redistribute(mesh, rows)
    aux = (aux_mean or _dp_mean)(aux if j == 0 else aux.detach(), mesh, dp)
    return shard(out, ctx, "batch", "act_seq", "act_embed"), aux
