"""The multi-pod mesh: the LMs over ``("pod", "data", "model")``, against
the JAX package on the same mesh of host devices.

Two gloo worlds of four ranks on the CPU (``run_spmd`` over
``sharding/groups.py`` meshes, the host-staged groups the card's gloo
worlds run on): pod × data × model = 2 × 1 × 2 and 2 × 2 × 1. The batch
is split over pod and data together (the rules' ``("pod", "data")``),
the parameters are replicated over ``pod`` (only the gradient reduce
crosses it). The JAX side runs in one child interpreter with four host
devices (``XLA_FLAGS``, as ``tests/test_torch_moe_mesh.py`` does) on the
same two meshes. Held:

* the reduced dense LM (2 layers, d 64): prefill and per-row decode
  logits in fp32 within 1e-5 · (1 + max|logit|) of JAX's on the mesh,
  ``Engine`` tokens equal to JAX's ``Engine`` on the mesh; under int8
  the logits and the ``Engine``'s tokens bitwise to the port's unsharded
  int8 path (every MLP matmul a ``qmatmul`` on the rank's shard). The
  batch has B = 8 rows, two a rank where pod × data is 4: the CPU's BLAS
  rounds a one-row float product (the attention projections around the
  int8 MLP) otherwise than a product of several rows, in the unsharded
  port too, so one row a rank would hold the mesh to another rounding;
* one train step (AdamW at eps 1e-3, as ``tests/test_torch_train.py``
  says why) against JAX's sharded step on the mesh at the reference's
  bars (``tests/test_distributed.py``): loss rtol 1e-5, params rtol 2e-4
  / atol 2e-5;
* the same step with the cross-pod compression: each pod's gradients
  taken on its own rows over its own (data, model) mesh, then
  ``cross_pod_grad_reduce`` over the three-axis mesh (bf16, and int8
  with error feedback), then AdamW. bf16: held at the same bars against
  JAX's per-pod gradients summed in bf16 and JAX's ``adamw_update``.
  int8: each pod's gradients held to JAX's at the same bars, and the
  reduced gradient bitwise to the reference's ``error_feedback_compress``
  applied to the port's own pod gradients (a per-tensor int8 code turns
  a rounding-level difference of a gradient near a code boundary into a
  whole step of the code), the params within the bars of JAX's
  ``adamw_update`` on that sum;
* the reduced dbrx-132b's MoE layer through the expert-parallel path
  (``_moe_apply_ep``), each (pod, data) shard one dispatch group, at
  capacity factors 0.5 and 1.25: output within 1e-5 · (1 + max|y|), aux
  within 1e-6, and every (group, model rank)'s routing and keep mask
  equal to the reference's formulas on JAX's side;
* a planted fault must fail: the pod-local gradients applied with no
  reduce over ``pod`` (a gradient summed over ``data`` only).

The rank bodies import no JAX.
"""
from __future__ import annotations

import dataclasses
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
AXES = ("pod", "data", "model")
MESHES = {"2x1x2": (2, 1, 2), "2x2x1": (2, 2, 1)}
KW = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab=96, qkv_bias=True)
B, S, T = 8, 8, 12                      # batch, prompt, cache length
WORKLOAD = [(5, 6), (8, 4), (6, 6), (7, 5), (4, 5), (8, 3), (3, 6), (6, 4)]
ADAM = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-3)
TOL = 1e-5
AUX_TOL = 1e-6
MB, MS = 4, 32                          # the MoE layer's batch, sequence
CAPACITY_FACTORS = (0.5, 1.25)
MODES = ("bf16", "int8")

_CHILD = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_default_matmul_precision", "float32")
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.registry import get_arch
from repro.launch.train import reduced_config
from repro.models.moe import moe_apply, moe_init
from repro.models.transformer import LMConfig, TransformerLM
from repro.optim import adamw as j_adamw
from repro.serve import Engine, EngineConfig
from repro.sharding.logical import A, ShardingCtx, DEFAULT_RULES, \\
    param_shardings
from repro.train.steps import make_train_step
inp = pickle.load(open(sys.argv[1], "rb"))
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
AXES = ("pod", "data", "model")

def mesh_of(shape):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape), AXES)

def capacity(tokens, cfg):
    import math
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)

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

jm = TransformerLM(LMConfig(**inp["kw"], dtype=jnp.float32))
jp = jm.init(jax.random.PRNGKey(0))
moe_base = reduced_config(get_arch("dbrx-132b").model()).cfg.moe
res = {"params": np_tree(jp), "moe_params": {}, "mesh": {}}
tok, nxt, pos = (jnp.asarray(inp[k]) for k in ("tok", "nxt", "pos"))
x = jnp.asarray(inp["x"])
for name, shape in inp["meshes"].items():
    mesh = mesh_of(shape)
    ctx = ShardingCtx(mesh, DEFAULT_RULES)
    lp, cache = jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c,
                                                   ctx))(
        jp, tok, jm.init_cache(tok.shape[0], inp["T"]))
    ld, _ = jax.jit(lambda p, t, q, c: jm.decode_step(p, t, q, c, ctx))(
        jp, nxt, pos, cache)
    eng = Engine(jm, jp, EngineConfig(capacity=len(inp["workload"]),
                                      max_seq=16), ctx)
    for pr, (_, budget) in zip(inp["prompts"], inp["workload"]):
        eng.add_request(pr, budget)
    tokens = {r.uid: list(r.generated) for r in eng.run()}
    opt_cfg = j_adamw.AdamWConfig(**inp["adam"])
    psh = param_shardings(jax.eval_shape(lambda: jp), jm.axes(), mesh,
                          DEFAULT_RULES)
    osh = param_shardings(jax.eval_shape(j_adamw.adamw_init, jp),
                          {"m": jm.axes(), "v": jm.axes(), "step": A()},
                          mesh, DEFAULT_RULES)
    batch = {"tokens": tok, "labels": jnp.asarray(inp["labels"])}
    bsh = {k: NamedSharding(mesh, P(("pod", "data"), None)) for k in batch}
    step = jax.jit(make_train_step(jm, opt_cfg, ctx),
                   in_shardings=(psh, osh, bsh),
                   out_shardings=(psh, osh, None))
    new_p, _, metrics = step(jp, j_adamw.adamw_init(jp), batch)
    out = {"prefill": np.asarray(lp), "decode": np.asarray(ld),
           "engine": tokens,
           "train": (float(metrics["loss"]), np_tree(new_p)), "moe": {}}
    nd, nm = shape[0] * shape[1], shape[2]
    for i, cf in enumerate(inp["capacity_factors"]):
        cfg = dataclasses.replace(moe_base, capacity_factor=cf)
        p = moe_init(jax.random.PRNGKey(10 + i), cfg)
        res["moe_params"][cf] = np_tree(p)
        y, aux = jax.jit(lambda pp, xx: moe_apply(pp, xx, cfg, ctx))(p, x)
        bl = x.shape[0] // nd
        routes = []
        for g in range(nd):
            routes += routing(p, x[g * bl:(g + 1) * bl], cfg, nm,
                              capacity(bl * x.shape[1], cfg))
        out["moe"][cf] = (np.asarray(y), float(aux), routes)
    res["mesh"][name] = out
pickle.dump(res, open(sys.argv[2], "wb"))
"""


def _inputs() -> dict:
    rng = np.random.RandomState(11)
    v = KW["vocab"]
    return {"tok": rng.randint(0, v, size=(B, S)).astype(np.int32),
            "nxt": rng.randint(0, v, size=(B,)).astype(np.int32),
            "pos": np.array([S, S - 1, S, S - 2] * 2, np.int32),
            "labels": rng.randint(0, v, size=(B, S)).astype(np.int32),
            "prompts": [rng.randint(0, v, size=p).astype(np.int32)
                        for p, _ in WORKLOAD],
            "x": rng.randn(MB, MS, 64).astype(np.float32),
            "workload": WORKLOAD, "T": T, "adam": ADAM, "kw": KW,
            "meshes": MESHES, "capacity_factors": CAPACITY_FACTORS}


@functools.cache
def _jax_side() -> dict:
    with tempfile.TemporaryDirectory(prefix="pod_mesh_") as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(_inputs(), f)
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


def _jax_tree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.asarray, tree)


@functools.cache
def _jax_cross_pod() -> dict:
    """The reference's cross-pod step, here in one device: each pod's
    loss and gradients on its rows, each mode's compressed sum over the
    pods (bf16 summed in bf16, int8 through ``error_feedback_compress``
    from a zero residual) averaged, then JAX's AdamW. Also the planted
    fault's: pod 0's gradients alone. {mode: (mean loss, params)}."""
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import LMConfig, TransformerLM
    from repro.optim import adamw as j_adamw
    from repro.train import compression as jc
    jm = TransformerLM(LMConfig(**KW, dtype=jnp.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_side()["params"])
    inp = _inputs()
    half = B // 2
    losses, grads = [], []
    for p in range(2):
        rows = slice(p * half, (p + 1) * half)
        batch = {"tokens": jnp.asarray(inp["tok"][rows]),
                 "labels": jnp.asarray(inp["labels"][rows])}
        loss, g = jax.value_and_grad(
            lambda pp: jm.loss(pp, batch, None)[0])(jp)
        losses.append(float(loss))
        grads.append(g)
    opt_cfg = j_adamw.AdamWConfig(**ADAM)

    def update(g):
        new_p, _, _ = j_adamw.adamw_update(g, j_adamw.adamw_init(jp), jp,
                                           opt_cfg)
        return jax.tree_util.tree_map(np.asarray, new_p)

    def bf16(a, b):
        s = a.astype(jnp.bfloat16) + b.astype(jnp.bfloat16)
        return s.astype(jnp.float32) / 2.0

    def int8(a, b):
        sa, _ = jc.error_feedback_compress(a, jnp.zeros(a.shape), "int8")
        sb, _ = jc.error_feedback_compress(b, jnp.zeros(b.shape), "int8")
        return ((sa + sb) / 2.0).astype(a.dtype)

    tm = jax.tree_util.tree_map
    mean = sum(losses) / 2.0
    return {"bf16": (mean, update(tm(bf16, *grads))),
            "pod0": (losses[0], update(grads[0])),
            "grads": [tm(np.asarray, g) for g in grads],
            "int8_of": lambda g0, g1: tm(np.asarray, tm(
                int8, _jax_tree(g0), _jax_tree(g1))),
            "update": lambda g: update(_jax_tree(g))}


# ------------------------------------------------------------ rank side

def _t_model():
    from repro_torch.models.transformer import LMConfig, TransformerLM
    return TransformerLM(LMConfig(**KW, dtype=torch.float32))


def _whole_np(tree):
    from repro_torch.core.tree import tree_map
    from repro_torch.sharding.logical import whole
    return tree_map(lambda t: whole(t).detach().numpy().copy(), tree)


def _forward(model, params, ctx, quant):
    """(prefill logits, per-row decode logits), whole, as numpy."""
    from repro_torch.ops import ExecPolicy, use_policy
    from repro_torch.sharding.logical import distribute_tree, whole
    inp = _inputs()
    cache = model.init_cache(B, T, device="cpu")
    if ctx is not None:
        cache = distribute_tree(cache, model.cache_axes(), ctx)
    with use_policy(ExecPolicy(quant=quant)), torch.no_grad():
        lp, cache = model.prefill(params, {"tokens": torch.from_numpy(
            inp["tok"])}, cache, ctx)
        ld, _ = model.decode_step(params, torch.from_numpy(inp["nxt"]),
                                  torch.from_numpy(inp["pos"]), cache, ctx)
    return whole(lp).numpy(), whole(ld).numpy()


def _engine_tokens(model, params, ctx, quant):
    from repro_torch.ops import ExecPolicy
    from repro_torch.serve import Engine, EngineConfig
    eng = Engine(model, params, EngineConfig(
        capacity=len(WORKLOAD), max_seq=16, device="cpu",
        policy=ExecPolicy(quant=quant)), ctx)
    for p, (_, budget) in zip(_inputs()["prompts"], WORKLOAD):
        eng.add_request(p, budget)
    return {r.uid: list(r.generated) for r in eng.run()}


def _batch(rows=slice(None)):
    inp = _inputs()
    return {"tokens": torch.from_numpy(inp["tok"][rows]),
            "labels": torch.from_numpy(inp["labels"][rows])}


def _pod_meshes(shape):
    """Every pod's (data, model) mesh, built on every rank in pod order
    (each rank keeps its own pod's: the others are None)."""
    from repro_torch.sharding.groups import mesh_groups
    ranks = torch.arange(int(np.prod(shape))).reshape(shape)
    meshes = [mesh_groups(shape[1:], AXES[1:], "cpu", ranks=ranks[p])
              for p in range(shape[0])]
    return next(m for m in meshes if m is not None)


def _cross_pod_step(model, placed, mesh, sub, mode):
    """One train step with the cross-pod compression: this pod's loss
    and gradients on its rows over its own (data, model) mesh ``sub``,
    ``cross_pod_grad_reduce`` over ``mesh``'s ``pod`` axis (``mode``
    ``None``: no reduce, the planted fault), then AdamW. (The pods' mean
    loss (this pod's under the planted fault), the new params, this
    pod's gradients, the reduced gradients), whole."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.core.tree import tree_map
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.sharding.logical import ShardingCtx
    from repro_torch.train.compression import (cross_pod_grad_reduce,
                                               init_ef_state)
    from repro_torch.train.steps import loss_and_grads
    assert tuple(mesh.mesh_dim_names)[0] == "pod"
    n_pods = int(mesh.mesh.shape[0])
    pod = mesh.get_local_rank("pod")

    def on_sub(t):
        assert t.placements[0].is_replicate(), "a param split over pod"
        return DTensor.from_local(t.to_local(), sub, t.placements[1:],
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    def on_mesh(local, like):
        return DTensor.from_local(local, mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())
    half = B // n_pods
    loss, _, grads = loss_and_grads(
        model, tree_map(on_sub, placed),
        _batch(slice(pod * half, (pod + 1) * half)), ShardingCtx(sub))
    g = tree_map(lambda t, like: on_mesh(t.to_local(), like), grads, placed)
    pod_grads = _whole_np(g)
    if mode is not None:
        g, _ = cross_pod_grad_reduce(g, init_ef_state(g), mesh=mesh,
                                     mode=mode)
        total = loss.clone()
        dist.all_reduce(total, group=mesh.get_group("pod"))
        loss = total / n_pods
    cfg = AdamWConfig(**ADAM)
    new_p, _, _ = adamw_update(g, adamw_init(placed, cfg), placed, cfg)
    return float(loss), _whole_np(new_p), pod_grads, _whole_np(g)


def _moe_rank(mesh, moe_params):
    """The reduced dbrx MoE layer at each capacity factor: (whole out,
    aux, this rank's routing) of ``moe_apply`` on DTensors."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    from repro_torch.models.moe import moe_apply, moe_axes, routing_trace
    from repro_torch.sharding.logical import (ShardingCtx, distribute_tree,
                                              whole)
    base = reduced_config(get_arch("dbrx-132b").model()).cfg.moe
    ctx = ShardingCtx(mesh)
    x = torch.from_numpy(_inputs()["x"])
    out = {}
    for cf in CAPACITY_FACTORS:
        cfg = dataclasses.replace(base, capacity_factor=cf)
        placed = distribute_tree(params_from_numpy(moe_params[cf], "cpu"),
                                 moe_axes(cfg), ctx)
        with routing_trace() as log, torch.no_grad():
            y, aux = moe_apply(placed, x, cfg, ctx)
        out[cf] = (whole(y).numpy(), float(whole(aux)),
                   [{"top_e": r["top_e"].numpy(), "keep": r["keep"].numpy()}
                    for r in log])
    return out


def _pod_body(rank, world, shape, np_params, moe_params):
    # the world's ranks share the host's cores: a pool of threads each
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    from repro_torch.bridge import params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import ShardingCtx, distribute_tree
    from repro_torch.train.steps import make_train_step
    mesh = mesh_groups(shape, AXES, "cpu")
    sub = _pod_meshes(shape)
    ctx = ShardingCtx(mesh)
    model = _t_model()
    full = params_from_numpy(np_params, "cpu")
    placed = distribute_tree(full, model.axes(), ctx)
    out = {"batch_placements": str(distribute_tree(
        model.init_cache(B, T, device="cpu"), model.cache_axes(),
        ctx)["k"].placements)}
    out["fp32"] = _forward(model, placed, ctx, "none")
    out["int8"] = _forward(model, placed, ctx, "int8")
    out["int8_plain"] = _forward(model, full, None, "int8")
    out["engine_fp32"] = _engine_tokens(model, full, ctx, "none")
    out["engine_int8"] = _engine_tokens(model, full, ctx, "int8")
    out["engine_int8_plain"] = _engine_tokens(model, full, None, "int8")
    cfg = AdamWConfig(**ADAM)
    new_p, _, metrics = make_train_step(model, cfg, ctx)(
        placed, adamw_init(placed, cfg), _batch())
    out["train"] = (float(metrics["loss"]), _whole_np(new_p))
    out["cross_pod"] = {m: _cross_pod_step(model, placed, mesh, sub, m)
                        for m in MODES}
    out["planted"] = _cross_pod_step(model, placed, mesh, sub, None)
    out["moe"] = _moe_rank(mesh, moe_params)
    return out


@functools.cache
def _worlds() -> dict:
    js = _jax_side()
    return {name: run_spmd(_pod_body, 4, "gloo", "cpu", shape,
                           js["params"], js["moe_params"], timeout=400)
            for name, shape in MESHES.items()}


# ------------------------------------------------------------ the checks

def _close(got, want, tol, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = tol * (1.0 + np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= bound, f"{label}: max |d| {err:.3g} > {bound:.3g}"


def _hold_params(params, want, label):
    from repro_torch.core.tree import tree_items
    for path, p in tree_items(params):
        w = want
        for k in path:
            w = w[k]
        np.testing.assert_allclose(p, np.asarray(w), rtol=2e-4, atol=2e-5,
                                   err_msg=f"{label} " + "/".join(path))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_agrees(mesh):
    ranks = _worlds()[mesh]
    for r in ranks[1:]:
        for k in ("fp32", "int8"):
            for a, b in zip(r[k], ranks[0][k]):
                np.testing.assert_array_equal(a, b)
        assert r["engine_fp32"] == ranks[0]["engine_fp32"]
        assert r["train"][0] == ranks[0]["train"][0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_batch_is_split_over_pod_and_data(mesh):
    """The KV cache's batch dim (dim 1 of the stacked (L, B, T, kv, hd))
    takes pod and data together."""
    place = _worlds()[mesh][0]["batch_placements"]
    if mesh == "2x2x1":
        assert place == "(Shard(dim=1), Shard(dim=1), Replicate())"
    else:
        assert place.startswith("(Shard(dim=1), ")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_prefill_and_decode_logits_match_jax(mesh):
    want = _jax_side()["mesh"][mesh]
    lp, ld = _worlds()[mesh][0]["fp32"]
    _close(lp, want["prefill"], TOL, f"{mesh} prefill")
    _close(ld, want["decode"], TOL, f"{mesh} decode")
    assert (lp.argmax(-1) == want["prefill"].argmax(-1)).all()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_int8_is_bitwise_to_the_unsharded_port(mesh):
    r = _worlds()[mesh][0]
    for got, want, what in zip(r["int8"], r["int8_plain"],
                               ("prefill", "decode")):
        np.testing.assert_array_equal(got, want, err_msg=f"{mesh} {what}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_engine_tokens(mesh):
    want = _jax_side()["mesh"][mesh]["engine"]
    r = _worlds()[mesh][0]
    assert r["engine_fp32"] == want
    assert r["engine_int8"] == r["engine_int8_plain"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_train_step_matches_jax(mesh):
    want_loss, want_p = _jax_side()["mesh"][mesh]["train"]
    loss, params = _worlds()[mesh][0]["train"]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _hold_params(params, want_p, mesh)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cross_pod_train_step_matches_the_reference(mesh, mode):
    from repro_torch.core.tree import tree_items
    ref = _jax_cross_pod()
    ranks = _worlds()[mesh]
    want_loss = ref["bf16"][0]
    per_pod = len(ranks) // MESHES[mesh][0]
    pods = [ranks[0]["cross_pod"][mode][2],
            ranks[per_pod]["cross_pod"][mode][2]]
    for p, g in enumerate(pods):
        _hold_params(g, ref["grads"][p], f"{mesh} pod {p} gradients")
    if mode == "int8":
        reduced = ref["int8_of"](*pods)
        want_p = ref["update"](reduced)
    else:
        want_p = ref["bf16"][1]
    for rank, r in enumerate(ranks):
        loss, params, _, got = r["cross_pod"][mode]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        _hold_params(params, want_p, f"{mesh} rank {rank} {mode}")
        if mode == "int8":
            for path, a in tree_items(got):
                w = reduced
                for k in path:
                    w = w[k]
                np.testing.assert_array_equal(
                    a, w, err_msg=f"{mesh} rank {rank} " + "/".join(path))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_planted_gradient_summed_over_data_only_fails(mesh):
    """Pod 0's ranks apply their pod's gradients with no pod reduce: the
    step is pod 0's own (the fault reproduced on JAX's side), and it
    misses the whole batch's step past the bars."""
    _, want_p = _jax_side()["mesh"][mesh]["train"]
    loss, params, _, _ = _worlds()[mesh][0]["planted"]
    own_loss, own_p = _jax_cross_pod()["pod0"]
    np.testing.assert_allclose(loss, own_loss, rtol=1e-5)
    _hold_params(params, own_p, f"{mesh} pod 0 alone")
    with pytest.raises(AssertionError):
        _hold_params(params, want_p, f"{mesh} planted")


def _hold_moe(got, want, label):
    y, aux, routes = got
    wy, waux, wroutes = want
    _close(y, wy, TOL, f"{label} out")
    assert abs(aux - waux) <= AUX_TOL, f"{label} aux: {aux} vs {waux}"
    assert len(routes) == len(wroutes) == 1, label
    for r, w in zip(routes, wroutes):
        np.testing.assert_array_equal(r["top_e"], w["top_e"],
                                      err_msg=f"{label} top_e")
        np.testing.assert_array_equal(r["keep"], w["keep"],
                                      err_msg=f"{label} keep")


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_dispatch_groups_over_pod_and_data_match_jax(mesh, cf):
    """Every rank's expert-parallel MoE layer against JAX's on the mesh;
    rank (p, d, m) dispatches group p · data + d for model rank m."""
    shape = MESHES[mesh]
    wy, waux, wroutes = _jax_side()["mesh"][mesh]["moe"][cf]
    kept = 0
    for rank, r in enumerate(_worlds()[mesh]):
        p, d, m = np.unravel_index(rank, shape)
        g = p * shape[1] + d
        want = [wroutes[g * shape[2] + m]]
        _hold_moe(r["moe"][cf], (wy, waux, want),
                  f"{mesh} rank {rank} cf {cf}")
        kept += int(r["moe"][cf][2][0]["keep"].sum())
    if cf == 0.5:
        assert kept < MB * MS * 2, f"{mesh}: nothing dropped"
