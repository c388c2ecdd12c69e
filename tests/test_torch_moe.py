"""The port's mixture-of-experts layer against the JAX package on the
CPU: ``moe_apply`` (the reference's local path, ``ctx=None``), its
routing and dispatch, and the transformer with MoE layers (the reduced
dbrx and llama4-scout configs).

Inputs come from a numpy seed; JAX params reach the port through
``params_from_numpy``. The tolerances are ``tests/test_torch_lm.py``'s:

* fp32 within ``TOL_FP32`` = 1e-5 of 1 + max|want|, the reference
  jitted;
* one bf16 call within 2 ulps and at most 1 % of elements off, the
  reference run op by op (``jax.disable_jit``) with its silu rounded as
  the port's (``_PORT_ROUNDING``; the activation itself is held in
  ``test_torch_lm.py``'s activations check);
* a whole bf16 model within ``TOL_BF16`` = 2⁻⁴ of 1 + max|want|;
* the aux loss within 1e-6, and the routing (each assignment's expert,
  and whether it is kept) equal. Each routing check prints the smallest
  margin between a token's k-th and (k+1)-th probability, so that a
  flipped expert cannot hide behind a tolerance.

Each rule the port has to keep has a planted fault that must fail its
check: ``torch.topk``'s tie order, positions counted k-major, and the
combine computed in fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import (_PORT_ROUNDING, TOL_BF16, TOL_FP32, _bf16_close,
                           _close, _tree_np)

from repro.configs.registry import get_arch as j_get_arch
from repro.launch.train import reduced_config as j_reduced_config
from repro.models import common as jc
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.launch.train import reduced_config
from repro_torch.models import moe as tmoe

TOL_AUX = 1e-6
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (n_shared, top_k) of the reference's two MoE configs and around them
SHAPES = [(0, 1), (0, 2), (0, 4), (1, 1), (1, 2)]
# 48 tokens a row over 6 experts: at capacity_factor 0.01 the capacity
# is its floor of 8, under the 8·k tokens an expert gets on average
B, S, D, F_, E = 2, 48, 16, 24, 6
MOE_ARCHS = ["dbrx-132b", "llama4-scout-17b-a16e"]


def _cfgs(n_shared=0, top_k=2, gated=True, cf=1.25, e=E):
    kw = dict(d_model=D, d_ff=F_, n_experts=e, top_k=top_k,
              capacity_factor=cf, n_shared=n_shared, gated=gated)
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _case(name, jcfg, seed=0, zero_router=False):
    """(JAX params, port params, JAX x, port x) in dtype ``name``."""
    jdt, tdt = DTYPES[name]
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    tp = params_from_numpy(_tree_np(jp), "cpu")
    x = np.random.RandomState(seed + 1).randn(B, S, D).astype(np.float32)
    return jp, tp, jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _reference_routing(jp, jx, jcfg):
    """The reference's routing and dispatch, step for step as
    ``repro/models/moe.py:232-250`` computes them with JAX's ops: (probs,
    top_e (B, S, k), keep (B, S·k))."""
    b, s, _ = jx.shape
    logits = jnp.einsum("bsd,de->bse", jx.astype(jnp.float32),
                        jp["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, jcfg.top_k)
    flat_e = top_e.reshape(b, s * jcfg.top_k)
    onehot = jax.nn.one_hot(flat_e, jcfg.n_experts, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=1) * onehot).sum(-1) - 1
    return probs, top_e, pos < jmoe._capacity(s, jcfg)


def _check_routing(tp, x, tcfg, jp, jx, jcfg, label=""):
    """The port's routing (``_route``, ``_slots``) equal to the
    reference's: every assignment's expert, and whether it is kept.
    Returns the number of dropped assignments."""
    b, s, _ = x.shape
    _, _, top_e, _ = tmoe._route(tp, x, tcfg)
    _, keep = tmoe._slots(top_e.reshape(b, s * tcfg.top_k),
                          tcfg.n_experts, tmoe._capacity(s, tcfg))
    probs, want_e, want_keep = _reference_routing(jp, jx, jcfg)
    srt = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    if tcfg.top_k < tcfg.n_experts:
        margin = srt[..., tcfg.top_k - 1] - srt[..., tcfg.top_k]
        print(f"routing {label}: smallest top-k margin {margin.min():.3g}")
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want_e),
                                  err_msg=f"{label}: experts")
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep),
                                  err_msg=f"{label}: kept assignments")
    return int((~keep).sum())


def _reference(name, jp, jx, jcfg, monkeypatch):
    """The reference's ``moe_apply`` as dtype ``name``'s check runs it:
    jitted in fp32; op by op in bf16, its silu rounded as the port's."""
    fn = lambda p, x: jmoe.moe_apply(p, x, jcfg, None)  # noqa: E731
    if name == "f32":
        return jax.jit(fn)(jp, jx)
    monkeypatch.setitem(jc.ACTIVATIONS, jcfg.act, _PORT_ROUNDING[jcfg.act])
    with jax.disable_jit():
        return fn(jp, jx)


def _check_out(name, got, want, label):
    if name == "f32":
        _close(got, want, TOL_FP32, label)
    else:
        _bf16_close(got, want, label)


# ------------------------------------------------------------- moe_apply

@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("n_shared,top_k", SHAPES)
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.01])
def test_moe_apply_matches_the_reference(name, n_shared, top_k, gated, cf,
                                         monkeypatch):
    """Output, routing and aux loss of one call; at capacity_factor 0.01
    assignments are dropped, and the same ones in both packages."""
    jcfg, tcfg = _cfgs(n_shared, top_k, gated, cf)
    jp, tp, jx, x = _case(name, jcfg)
    got, aux = tmoe.moe_apply(tp, x, tcfg, None)
    assert got.dtype == DTYPES[name][1] and aux.dtype == torch.float32
    label = f"{name} shared={n_shared} k={top_k} gated={gated} cf={cf}"
    dropped = _check_routing(tp, x, tcfg, jp, jx, jcfg, label)
    assert (dropped > 0) == (cf == 0.01) or cf == 1.25, (label, dropped)
    want, jaux = _reference(name, jp, jx, jcfg, monkeypatch)
    _check_out(name, got, want, label)
    assert abs(float(aux) - float(jaux)) <= TOL_AUX, (float(aux),
                                                      float(jaux))


def test_capacity_matches_the_reference():
    for tokens in (1, 7, 48, 64, 100, 4096):
        for top_k, cf, e in ((4, 1.25, 16), (1, 1.25, 16), (2, 0.01, 6),
                             (2, 8.0, 4)):
            jcfg, tcfg = _cfgs(top_k=top_k, cf=cf, e=e)
            assert tmoe._capacity(tokens, tcfg) == jmoe._capacity(tokens,
                                                                 jcfg)
    # dbrx at a 64-token prefill: 24 slots an expert against 16 on average
    assert tmoe._capacity(64, get_arch("dbrx-132b").model().cfg.moe) == 24


def test_ties_go_to_the_lowest_expert_first():
    """A zero router makes every expert tie (all probabilities 1/E): the
    reference takes experts 0..k-1; two equal router columns tie two
    experts for every token. The port orders both as jax.lax.top_k."""
    jcfg, tcfg = _cfgs(top_k=4, cf=8.0)
    jp, tp, jx, x = _case("f32", jcfg, zero_router=True)
    _check_routing(tp, x, tcfg, jp, jx, jcfg, "zero router")
    _, _, top_e, _ = tmoe._route(tp, x, tcfg)
    assert (top_e == torch.arange(4)).all()
    got, _ = tmoe.moe_apply(tp, x, tcfg, None)
    want, _ = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg, None))(jp, jx)
    _close(got, want, TOL_FP32, "zero router")
    # a planted tie: experts 1 and 4 have the same router column
    jp, tp, jx, x = _case("f32", jcfg, seed=3)
    jp["router"] = jp["router"].at[:, 4].set(jp["router"][:, 1])
    tp = params_from_numpy(_tree_np(jp), "cpu")
    _check_routing(tp, x, tcfg, jp, jx, jcfg, "planted tie")
    full = tmoe._top_k(torch.from_numpy(np.array(
        _reference_routing(jp, jx, jcfg)[0])), E)[1]
    assert ((full == 1).int().argmax(-1) < (full == 4).int().argmax(-1)).all()


def test_group_independence():
    """Each batch row is its own dispatch group: permuting the rows
    permutes the outputs (tests/test_moe.py::test_group_independence on
    the port), at a capacity that drops."""
    jcfg, tcfg = _cfgs(top_k=2, cf=1.0)
    _, tp, _, _ = _case("f32", jcfg)
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 16, D)
                         .astype(np.float32))
    out, _ = tmoe.moe_apply(tp, x, tcfg, None)
    perm = torch.tensor([2, 0, 3, 1])
    out_p, _ = tmoe.moe_apply(tp, x[perm], tcfg, None)
    _close(out_p, out[perm], TOL_FP32, "permuted rows")
    one, _ = tmoe.moe_apply(tp, x[2:3], tcfg, None)
    _close(one, out[2:3], TOL_FP32, "one row alone")


def test_local_routing_trace_is_the_reference_routing():
    """``local_routing_trace`` yields one entry a local-path call: the
    flat experts (B, S·k) and the keep mask the layer dispatched with,
    equal to the reference's routing and dispatch at a capacity that
    drops, and nothing outside the context."""
    jcfg, tcfg = _cfgs(top_k=2, cf=1.0)
    jp, tp, jx, x = _case("f32", jcfg)
    with tmoe.local_routing_trace() as log:
        tmoe.moe_apply(tp, x, tcfg, None)
        tmoe.moe_apply(tp, x[1:], tcfg, None)
    tmoe.moe_apply(tp, x, tcfg, None)
    assert len(log) == 2
    _, want_e, want_keep = _reference_routing(jp, jx, jcfg)
    want_e = np.asarray(want_e).reshape(B, S * tcfg.top_k)
    want_keep = np.asarray(want_keep)
    assert not want_keep.all()
    for (flat_e, keep), rows in zip(log, (slice(None), slice(1, None))):
        assert flat_e.shape == keep.shape and keep.dtype == torch.bool
        np.testing.assert_array_equal(flat_e.numpy(), want_e[rows])
        np.testing.assert_array_equal(keep.numpy(), want_keep[rows])


def test_a_mesh_raises_and_tf32_routing_is_refused():
    """TF32 routing is refused by the local path and by the expert-
    parallel one (on a mesh it raises as well: ``moe_apply_ep_ref`` runs
    a mesh's arithmetic on one device; tests/test_torch_moe_mesh.py holds
    it and the mesh against JAX)."""
    jcfg, tcfg = _cfgs()
    _, tp, _, x = _case("f32", jcfg)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            tmoe.moe_apply(tp, x, tcfg, None)
        with pytest.raises(RuntimeError, match="highest"):
            tmoe.moe_apply_ep_ref(tp, x, tcfg, 1, 2)
    finally:
        torch.set_float32_matmul_precision(saved)


def test_init_layout_and_the_shared_gate_copy():
    """The port's init draws the reference's tree: same keys, shapes and
    scale; ``shared_wg`` equals ``shared_wi``, as the reference's (it
    draws both from one key)."""
    jcfg, tcfg = _cfgs(n_shared=1)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg,
                       torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    np.testing.assert_array_equal(np.asarray(jp["shared_wg"]),
                                  np.asarray(jp["shared_wi"]))
    assert torch.equal(tp["shared_wg"], tp["shared_wi"])
    assert float(tp["wi"].abs().max()) <= 2 / D ** 0.5 + 1e-7


# --------------------------------------------------------- planted faults

def _topk_order(probs, k):
    return torch.topk(probs, k, dim=-1)


def _k_major_slots(flat_e, e, cap):
    """Positions counted over k first, then tokens."""
    b, sk = flat_e.shape
    k = sk // S
    by_k = flat_e.reshape(b, S, k).transpose(1, 2).reshape(b, sk)
    onehot = torch.nn.functional.one_hot(by_k, e)
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    pos = pos.reshape(b, k, S).transpose(1, 2).reshape(b, sk)
    keep = pos < cap
    return torch.where(keep, pos, cap), keep


def _combine_in_fp32(gathered, w, b, s, k):
    d = gathered.shape[-1]
    prod = gathered.float() * w.float()[..., None]
    return prod.reshape(b, s, k, d).sum(dim=2).to(gathered.dtype)


@pytest.mark.parametrize("plant", ["torch.topk order", "k-major positions",
                                   "combine in fp32"])
def test_planted_faults_fail(plant, monkeypatch):
    """The control for the checks above: each fault passes unplanted and
    fails planted. A zero router shows the tie order; a capacity that
    drops shows the position order; top-4 in bf16 shows the combine's
    roundings."""
    if plant == "torch.topk order":
        jcfg, tcfg = _cfgs(top_k=2, cf=8.0)
        jp, tp, jx, x = _case("f32", jcfg, zero_router=True)
        fault = ("_top_k", _topk_order)
    elif plant == "k-major positions":
        jcfg, tcfg = _cfgs(top_k=2, cf=0.01)
        jp, tp, jx, x = _case("f32", jcfg)
        fault = ("_slots", _k_major_slots)
    else:
        jcfg, tcfg = _cfgs(top_k=4, cf=8.0)
        jp, tp, jx, x = _case("bf16", jcfg)
        want, _ = _reference("bf16", jp, jx, jcfg, monkeypatch)
        _bf16_close(tmoe.moe_apply(tp, x, tcfg, None)[0], want, "unplanted")
        monkeypatch.setattr(tmoe, "_combine", _combine_in_fp32)
        with pytest.raises(AssertionError):
            _bf16_close(tmoe.moe_apply(tp, x, tcfg, None)[0], want,
                        f"planted: {plant}")
        return
    _check_routing(tp, x, tcfg, jp, jx, jcfg, "unplanted")
    monkeypatch.setattr(tmoe, *fault)
    with pytest.raises(AssertionError):
        _check_routing(tp, x, tcfg, jp, jx, jcfg, f"planted: {plant}")


# ---------------------------------------------------- the MoE transformer

def _moe_lm_pair(arch, name):
    """The reduced config of ``arch`` in both packages, in dtype
    ``name``, and the JAX params bridged to the port."""
    jdt, tdt = DTYPES[name]
    jm = j_reduced_config(j_get_arch(arch).model())
    tm = reduced_config(get_arch(arch).model())
    jm = type(jm)(dataclasses.replace(jm.cfg, dtype=jdt))
    tm = type(tm)(dataclasses.replace(tm.cfg, dtype=tdt))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, params_from_numpy(_tree_np(jp), "cpu")


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_prefill_and_decode_step(arch, name):
    """A batch of 2 prompts prefilled into a 20-position cache, then one
    decode step at per-row positions (11 and 6), against the reference's
    jitted prefill and decode step: fp32 within 1e-5, bf16 (a whole
    model) within 2⁻⁴."""
    jm, tm, jp, tp = _moe_lm_pair(arch, name)
    assert sorted(tp["layers"]) == sorted(jp["layers"])
    assert "moe" in tp["layers"] and "mlp" not in tp["layers"]
    rng = np.random.RandomState(10)
    toks = rng.randint(0, tm.cfg.vocab, size=(2, 11)).astype(np.int32)
    nxt = np.array([3, 7], np.int32)
    pos = np.array([11, 6], np.int32)
    cache = tm.init_cache(2, 20, device="cpu")
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               cache)
    k_prefill = cache["k"].clone()
    dlogits, cache = tm.decode_step(tp, torch.from_numpy(nxt),
                                    torch.from_numpy(pos), cache)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                       jm.init_cache(2, 20))
    jdlog, jcache2 = jax.jit(jm.decode_step)(
        jp, jnp.asarray(nxt), jnp.asarray(pos), jcache)
    tol = TOL_FP32 if name == "f32" else TOL_BF16
    _close(logits, jlog, tol, f"{arch} {name} prefill logits")
    _close(k_prefill, jcache["k"], tol, f"{arch} {name} prefill cache")
    _close(dlogits, jdlog, tol, f"{arch} {name} decode logits")
    _close(cache["v"], jcache2["v"], tol, f"{arch} {name} decode cache")


def test_moe_lm_init_and_param_counts():
    """The port's own init draws the reference's tree, and the reduced
    configs count the reference's total and active parameters."""
    for arch in MOE_ARCHS:
        jm, tm, jp, _ = _moe_lm_pair(arch, "f32")
        mine = tm.init(0, device="cpu")
        shape = lambda t: tuple(t.shape)  # noqa: E731
        assert jax.tree_util.tree_map(shape, mine) == \
            jax.tree_util.tree_map(shape, jp), arch
        n = sum(t.numel() for t in jax.tree_util.tree_leaves(mine))
        assert n == tm.param_count() == jm.cfg.param_count(), arch
        assert tm.cfg.active_param_count() == jm.cfg.active_param_count()
        assert tm.cfg.active_param_count() < tm.param_count()
