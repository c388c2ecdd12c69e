"""Expert parallelism: the port's ``moe_apply`` on a mesh against the
reference's own ``_moe_apply_ep`` (``repro/models/moe.py:104-218``).

The reference's expert-parallel layer is not the local layer sharded: a
data shard is one dispatch group whose capacity counts all of its
tokens, a model rank dispatches its own experts' assignments only, and
the aux loss is each shard's estimate averaged over the data axes. So it
is held here where tokens drop (capacity factors 0.5 and 1.25, not the
8.0 of ``tests/test_distributed.py``).

The JAX side runs in one child interpreter with four host devices
(``XLA_FLAGS``, as ``tests/test_distributed.py`` does) and returns, for
meshes (1, 2), (1, 4) and (2, 2) and the cases of ``CASES`` (gated or
not, 0 or 1 shared expert, top-1 or top-4, capacity factor 0.5 or
1.25; every pair of those factors' values in some case): the output and
aux of its ``moe_apply`` on the mesh, and each
(data shard, model rank)'s routing and keep mask, computed by the
reference's formulas. Against it:

* ``moe_apply_ep_ref`` (one device, the shards walked in rank order);
* the port's gloo worlds 1x2, 1x4 and 2x2 (``run_spmd``): every rank's
  ``moe_apply`` on DTensors laid out by ``moe_axes``;

output within ``TOL`` = 1e-5 · (1 + max|y|) in fp32, aux within 1e-6,
routing and keep masks equal. A mesh whose ``model`` axis does not
divide the experts (6 experts on 1x4) takes the local path, held
against JAX's on the same mesh. The reduced dbrx-132b and llama4-scout
(``act_seq`` over ``model``) serve on 1x2 (prefill and per-row decode
logits, and the ``Engine``'s tokens, against JAX's on the same mesh),
and dbrx trains one step there against JAX's sharded step at the
reference's bars (loss rtol 1e-5, params rtol 2e-4 / atol 2e-5; AdamW at
eps 1e-3, as ``tests/test_torch_train.py`` says why). Two planted
faults must fail: a rank that counts capacity over a row's tokens, and
an aux loss left unaveraged over ``data``.
"""
from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_spmd

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
D, FF, E, B, S = 16, 32, 8, 4, 8
TOL = 1e-5
AUX_TOL = 1e-6
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
# (gated, n_shared, top_k, capacity factor): each value of each factor
# in at least two cases, every pair of factors' values in at least one
CASES = {f"g{int(g)}s{sh}k{k}c{cf}": dict(
    d_model=D, d_ff=FF, n_experts=E, top_k=k, capacity_factor=cf,
    n_shared=sh, gated=g)
    for g, sh, k, cf in ((True, 0, 4, 0.5), (False, 1, 1, 0.5),
                         (True, 1, 1, 1.25), (False, 0, 4, 1.25),
                         (True, 1, 4, 1.25), (False, 1, 4, 0.5),
                         (True, 0, 1, 0.5), (False, 0, 1, 1.25))}
# 6 experts: model 4 does not divide them, so 1x4 takes the local path
LOCAL_CASE = dict(d_model=D, d_ff=FF, n_experts=6, top_k=2,
                  capacity_factor=0.5, n_shared=1, gated=True)
# the planted faults' case: a shard's capacity (24 on 1x2) is 8 a row
PLANT_CASE = "g1s1k4c1.25"
LM_ARCHS = ("dbrx-132b", "llama4-scout-17b-a16e")
LB, LS, LT = 4, 8, 12                  # the LMs' batch, prompt, cache
WORKLOAD = [(5, 6), (8, 4), (6, 6), (7, 5)]
ADAM = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-3)

_CHILD = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_default_matmul_precision", "float32")
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.models.moe import MoEConfig, moe_apply, moe_init
from repro.sharding.logical import A, ShardingCtx, DEFAULT_RULES, \\
    param_shardings
inp = pickle.load(open(sys.argv[1], "rb"))
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
x = jnp.asarray(inp["x"])

def mesh_of(shape):
    n = shape[0] * shape[1]
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("data", "model"))

def routing(p, xl, cfg, n_model, cap):
    # the reference's _moe_apply_ep routing and keep mask (:143-168)
    bl, s, d = xl.shape
    t, k, e = bl * s, cfg.top_k, cfg.n_experts
    e_l = e // n_model
    logits = jnp.einsum("bsd,de->bse", xl.astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat_e = top_e.reshape(t * k)
    out = []
    for j in range(n_model):
        local_e = flat_e - j * e_l
        owned = (local_e >= 0) & (local_e < e_l)
        le = jnp.where(owned, local_e, e_l)
        onehot = jax.nn.one_hot(le, e_l + 1, dtype=jnp.int32)
        pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
        out.append({"top_e": np.asarray(top_e.reshape(t, k)),
                    "keep": np.asarray(owned & (pos < cap))})
    return out

def capacity(tokens, cfg):
    import math
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)

res = {"params": {}, "mesh": {}}
for name, kw in inp["cases"].items():
    cfg = MoEConfig(**kw)
    p = moe_init(jax.random.PRNGKey(inp["seeds"][name]), cfg)
    res["params"][name] = np_tree(p)
    for mname, shape in inp["meshes"].items():
        if name == "local" and mname != "1x4":
            continue
        ctx = ShardingCtx(mesh_of(shape))
        y, aux = jax.jit(lambda pp, xx: moe_apply(pp, xx, cfg, ctx))(p, x)
        nd = shape[0] if x.shape[0] % shape[0] == 0 else 1
        bl = x.shape[0] // nd
        routes = []
        if name != "local":
            for i in range(nd):
                routes += routing(p, x[i * bl:(i + 1) * bl], cfg, shape[1],
                                  capacity(bl * x.shape[1], cfg))
        res["mesh"][(name, mname)] = (np.asarray(y), float(aux), routes)

# the reduced MoE LMs on mesh (1, 2): prefill / decode logits, Engine
# tokens, and (dbrx) one sharded train step
from repro.configs.registry import get_arch
from repro.launch.train import reduced_config
from repro.optim import adamw as j_adamw
from repro.serve import Engine, EngineConfig
from repro.train.steps import make_train_step
mesh = mesh_of((1, 2))
lm = inp["lm"]
res["lm"] = {}
for arch in lm["archs"]:
    spec = get_arch(arch)
    cfg = reduced_config(spec.model()).cfg
    import dataclasses
    jm = type(spec.model())(dataclasses.replace(cfg, dtype=jnp.float32))
    rules = DEFAULT_RULES
    if spec.rule_overrides:
        rules = rules.with_overrides(**spec.rule_overrides)
    ctx = ShardingCtx(mesh, rules)
    jp = jm.init(jax.random.PRNGKey(3))
    tok, nxt, pos = (jnp.asarray(lm[k]) for k in ("tok", "nxt", "pos"))
    lp, cache = jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c,
                                                   ctx))(
        jp, tok, jm.init_cache(tok.shape[0], lm["T"]))
    ld, _ = jax.jit(lambda p, t, q, c: jm.decode_step(p, t, q, c, ctx))(
        jp, nxt, pos, cache)
    eng = Engine(jm, jp, EngineConfig(capacity=4, max_seq=16), ctx)
    for pr, (_, budget) in zip(lm["prompts"], lm["workload"]):
        eng.add_request(pr, budget)
    tokens = {r.uid: list(r.generated) for r in eng.run()}
    out = {"params": np_tree(jp), "prefill": np.asarray(lp),
           "decode": np.asarray(ld), "engine": tokens}
    if arch == lm["archs"][0]:
        opt_cfg = j_adamw.AdamWConfig(**lm["adam"])
        shapes = jax.eval_shape(lambda: jp)
        psh = param_shardings(shapes, jm.axes(), mesh, rules)
        osh = param_shardings(jax.eval_shape(j_adamw.adamw_init, jp),
                              {"m": jm.axes(), "v": jm.axes(),
                               "step": A()}, mesh, rules)
        batch = {"tokens": tok, "labels": jnp.asarray(lm["labels"])}
        bsh = {k: NamedSharding(mesh, P("data", None)) for k in batch}
        step = jax.jit(make_train_step(jm, opt_cfg, ctx),
                       in_shardings=(psh, osh, bsh),
                       out_shardings=(psh, osh, None))
        new_p, _, metrics = step(jp, j_adamw.adamw_init(jp), batch)
        out["train"] = (float(metrics["loss"]), np_tree(new_p))
    res["lm"][arch] = out
pickle.dump(res, open(sys.argv[2], "wb"))
"""


def _x():
    return np.random.RandomState(5).randn(B, S, D).astype(np.float32)


def _lm_inputs():
    rng = np.random.RandomState(9)
    v = 2048
    return {"tok": rng.randint(0, v, size=(LB, LS)).astype(np.int32),
            "nxt": rng.randint(0, v, size=(LB,)).astype(np.int32),
            "pos": np.array([LS, LS - 1, LS, LS - 2], np.int32),
            "labels": rng.randint(0, v, size=(LB, LS)).astype(np.int32),
            "prompts": [rng.randint(0, v, size=p).astype(np.int32)
                        for p, _ in WORKLOAD],
            "workload": WORKLOAD, "T": LT, "adam": ADAM,
            "archs": LM_ARCHS}


def _all_cases():
    return {**CASES, "local": LOCAL_CASE}


@functools.cache
def _jax_side() -> dict:
    cases = _all_cases()
    inp = {"x": _x(), "cases": cases, "meshes": MESHES,
           "seeds": {n: i for i, n in enumerate(sorted(cases))},
           "lm": _lm_inputs()}
    with tempfile.TemporaryDirectory(prefix="moe_mesh_") as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(inp, f)
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO_SRC + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        res = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(_CHILD), src, dst],
            capture_output=True, text=True, timeout=600, env=env)
        assert res.returncode == 0, res.stdout + "\n" + res.stderr
        with open(dst, "rb") as f:
            return pickle.load(f)


# ------------------------------------------------------------ rank side

def _routes(log):
    """A ``routing_trace`` log as numpy: each dispatch's experts and keep
    mask."""
    return [{"top_e": r["top_e"].numpy(), "keep": r["keep"].numpy()}
            for r in log]


def _apply(mesh, np_params, kw, x, **plant):
    """(whole out, aux, this rank's routing) of ``moe_apply`` on DTensors
    laid out by ``moe_axes``; with ``plant`` (``capacity``, ``aux_mean``)
    of the expert-parallel layer it plants through them."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.moe import (MoEConfig, _moe_apply_ep, moe_apply,
                                        moe_axes, routing_trace)
    from repro_torch.sharding.logical import (ShardingCtx, distribute_tree,
                                              mesh_sizes, whole)
    cfg = MoEConfig(**kw)
    ctx = ShardingCtx(mesh)
    placed = distribute_tree(params_from_numpy(np_params, "cpu"),
                             moe_axes(cfg), ctx)
    with routing_trace() as log, torch.no_grad():
        if plant:
            y, aux = _moe_apply_ep(placed, torch.from_numpy(x), cfg, ctx,
                                   mesh_sizes(mesh)["model"], **plant)
        else:
            y, aux = moe_apply(placed, torch.from_numpy(x), cfg, ctx)
    return whole(y).numpy(), float(whole(aux)), _routes(log)


def _lm_rank(mesh, lm_params):
    """The reduced MoE LMs on ``mesh``: logits, Engine tokens, and the
    first arch's train step."""
    import dataclasses

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.sharding.logical import (ShardingCtx, distribute_tree,
                                              whole)
    from repro_torch.train.steps import make_train_step
    lm = _lm_inputs()
    out = {}
    for arch in LM_ARCHS:
        spec = get_arch(arch)
        cfg = reduced_config(spec.model()).cfg
        model = type(spec.model())(dataclasses.replace(
            cfg, dtype=torch.float32))
        ctx = ShardingCtx(mesh, spec.rules())
        full = params_from_numpy(lm_params[arch], "cpu")
        placed = distribute_tree(full, model.axes(), ctx)
        cache = distribute_tree(model.init_cache(LB, LT, device="cpu"),
                                model.cache_axes(), ctx)
        with torch.no_grad():
            lp, cache = model.prefill(
                placed, {"tokens": torch.from_numpy(lm["tok"])}, cache, ctx)
            ld, _ = model.decode_step(placed, torch.from_numpy(lm["nxt"]),
                                      torch.from_numpy(lm["pos"]), cache,
                                      ctx)
        eng = Engine(model, full, EngineConfig(capacity=4, max_seq=16,
                                               device="cpu"), ctx)
        for p, (_, budget) in zip(lm["prompts"], WORKLOAD):
            eng.add_request(p, budget)
        r = {"prefill": whole(lp).numpy(), "decode": whole(ld).numpy(),
             "engine": {q.uid: list(q.generated) for q in eng.run()},
             "graphs": eng.graph_mode}
        if arch == LM_ARCHS[0]:
            from repro_torch.core.tree import tree_map
            step = make_train_step(model, AdamWConfig(**ADAM), ctx)
            new_p, _, metrics = step(
                placed, adamw_init(placed),
                {"tokens": torch.from_numpy(lm["tok"]),
                 "labels": torch.from_numpy(lm["labels"])})
            r["train"] = (float(metrics["loss"]), tree_map(
                lambda t: whole(t).detach().numpy().copy(), new_p))
        out[arch] = r
    return out


def _moe_rank(rank, world, shape, params, lm_params):
    # the world's ranks share the host's cores: a pool of threads each
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    from torch.distributed.tensor import Replicate

    from repro_torch.models import moe
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import spmd_global
    mesh = mesh_groups(shape, ("data", "model"), "cpu")
    x = _x()
    out = {"cases": {name: _apply(mesh, params[name], kw, x)
                     for name, kw in CASES.items()}}
    if shape == (1, 4):
        out["local"] = _apply(mesh, params["local"], LOCAL_CASE, x)
    if shape == (1, 2):
        out["lm"] = _lm_rank(mesh, lm_params)
        cfg = moe.MoEConfig(**CASES[PLANT_CASE])
        out["planted_capacity"] = _apply(
            mesh, params[PLANT_CASE], CASES[PLANT_CASE], x,
            capacity=moe._capacity(S, cfg))
    if shape == (2, 2):
        out["planted_aux"] = _apply(
            mesh, params[PLANT_CASE], CASES[PLANT_CASE], x,
            aux_mean=lambda aux, mesh, dp: spmd_global(
                aux, mesh, [Replicate()] * mesh.ndim))
    return out


@functools.cache
def _worlds() -> dict:
    js = _jax_side()
    lm_params = {a: js["lm"][a]["params"] for a in LM_ARCHS}
    return {m: run_spmd(_moe_rank, shape[0] * shape[1], "gloo", "cpu",
                        shape, js["params"], lm_params, timeout=300)
            for m, shape in MESHES.items()}


# ------------------------------------------------------------ the checks

def _close(got, want, tol, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = tol * (1.0 + np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= bound, f"{label}: max |d| {err:.3g} > {bound:.3g}"


def _hold(got, want, label):
    y, aux, routes = got
    wy, waux, wroutes = want
    _close(y, wy, TOL, f"{label} out")
    assert abs(aux - waux) <= AUX_TOL, \
        f"{label} aux: {aux} vs {waux} (|d| {abs(aux - waux):.3g})"
    assert len(routes) == len(wroutes)
    for i, (r, w) in enumerate(zip(routes, wroutes)):
        np.testing.assert_array_equal(r["top_e"], w["top_e"],
                                      err_msg=f"{label} top_e {i}")
        np.testing.assert_array_equal(r["keep"], w["keep"],
                                      err_msg=f"{label} keep {i}")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ep_reference_matches_jax(mesh, case):
    """``moe_apply_ep_ref`` on one device against JAX's expert-parallel
    layer on the mesh, and its drops are real in the small-capacity
    cases."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.moe import (MoEConfig, moe_apply_ep_ref,
                                        routing_trace)
    js = _jax_side()
    nd, nm = MESHES[mesh]
    cfg = MoEConfig(**CASES[case])
    with routing_trace() as log:
        y, aux = moe_apply_ep_ref(
            params_from_numpy(js["params"][case], "cpu"),
            torch.from_numpy(_x()), cfg, nd, nm)
    routes = _routes(log)
    _hold((y.numpy(), float(aux), routes), js["mesh"][(case, mesh)],
          f"ref {mesh} {case}")
    if CASES[case]["capacity_factor"] == 0.5 and CASES[case]["top_k"] == 4:
        kept = sum(int(r["keep"].sum()) for r in routes)
        assert kept < B * S * 4, f"{case}: nothing dropped"


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_matches_jax(mesh):
    """Every rank's ``moe_apply`` over DTensors (the whole output, the
    aux loss, and the routing of each (data shard, model rank) it ran)
    against JAX's on the same mesh, for every case."""
    js = _jax_side()
    nm = MESHES[mesh][1]
    for rank, r in enumerate(_worlds()[mesh]):
        for case, (y, aux, routes) in r["cases"].items():
            wy, waux, wroutes = js["mesh"][(case, mesh)]
            i, j = divmod(rank, nm)
            nd = len(wroutes) // nm
            want = [wroutes[(i if nd > 1 else 0) * nm + j]]
            _hold((y, aux, routes), (wy, waux, want),
                  f"{mesh} rank {rank} {case}")


def test_a_model_axis_that_does_not_divide_the_experts_runs_locally():
    js = _jax_side()
    wy, waux, _ = js["mesh"][("local", "1x4")]
    for rank, r in enumerate(_worlds()["1x4"]):
        y, aux, routes = r["local"]
        assert routes == [], "the expert-parallel path ran"
        _close(y, wy, TOL, f"1x4 rank {rank} local out")
        assert abs(aux - waux) <= AUX_TOL


def test_planted_per_row_capacity_fails():
    js = _jax_side()
    want = js["mesh"][(PLANT_CASE, "1x2")]
    y, _, _ = _worlds()["1x2"][0]["planted_capacity"]
    with pytest.raises(AssertionError, match="out"):
        _close(y, want[0], TOL, "planted capacity out")


def test_planted_aux_not_averaged_over_data_fails():
    js = _jax_side()
    want = js["mesh"][(PLANT_CASE, "2x2")][1]
    auxes = [r["planted_aux"][1] for r in _worlds()["2x2"]]
    assert max(abs(a - want) for a in auxes) > AUX_TOL, \
        f"planted aux {auxes} within {AUX_TOL} of {want}"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_moe_lm_serves_on_1x2_as_jax(arch):
    want = _jax_side()["lm"][arch]
    for rank, r in enumerate(_worlds()["1x2"]):
        got = r["lm"][arch]
        _close(got["prefill"], want["prefill"], TOL, f"{arch} prefill")
        _close(got["decode"], want["decode"], TOL, f"{arch} decode")
        assert got["engine"] == want["engine"], (rank, got["engine"])
        assert got["graphs"] == "off (cpu)"


def test_reduced_dbrx_train_step_on_1x2_matches_jax():
    from repro_torch.core.tree import tree_items
    want_loss, want_p = _jax_side()["lm"][LM_ARCHS[0]]["train"]
    loss, params = _worlds()["1x2"][0]["lm"][LM_ARCHS[0]]["train"]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for path, p in tree_items(params):
        w = want_p
        for k in path:
            w = w[k]
        np.testing.assert_allclose(p, np.asarray(w), rtol=2e-4, atol=2e-5,
                                   err_msg="/".join(path))
