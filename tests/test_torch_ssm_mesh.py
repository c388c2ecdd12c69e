"""The hybrid (Mamba2 + a shared attention block), the RWKV-6 LM and the
encoder-decoder served and trained over a ``("data", "model")`` mesh,
against the JAX package's unsharded run (the reference runs these
families pjit-style: its sharded run equals the unsharded one up to
fp32 order).

Two gloo worlds on the CPU (``run_spmd`` over ``sharding/groups.py``
meshes): 1x2 and 2x2. Each rank lays the same params out by the model's
logical axes (``distribute_tree``) and runs, on DTensors, in fp32:

* a prefill and a per-row decode step: the logits and every cache leaf
  after the step (the Mamba2 scan state and conv tail, the shared
  block's K/V; RWKV's ``wkv`` and shifts; the encoder-decoder's self and
  cross K/V), within ``TOL`` = 1e-5 · (1 + max|want|);
* the hybrid under int8 (its shared MLP's matmuls ``qmatmul`` on the
  rank's shards): logits bitwise to the port's unsharded int8 path;
* the ``Engine`` (hybrid, RWKV): tokens equal to JAX's ``Engine``;
* one train step each against JAX's at the reference's bars of
  ``tests/test_distributed.py`` (loss rtol 1e-5, params rtol 2e-4 /
  atol 2e-5; AdamW at eps 1e-3, as ``tests/test_torch_train.py`` says
  why).

The hybrid's d_inner (128, 2 heads of 64) splits over ``model`` = 2 by
heads, while the packed ``in_proj`` output (274) and conv channels (144)
split evenly through ``xb``. The 1x2 world also plants a fault through
``mamba2_mesh``'s ``norm``: a gated RMSNorm that each rank takes over its
own heads only, which must move the first Mamba2 block's output past
the bar of the unsharded block. Params are moved off their init by a seeded
0.1·N(0, 1), as ``tests/test_torch_ssm.py`` does (RWKV's bonus ``u`` is
zeros at init). The rank bodies import no JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_spmd

V = 64
HYB_KW = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
              vocab=V, d_state=8, shared_interval=2, mamba_chunk=8,
              remat="none")
RWKV_KW = dict(n_layers=2, d_model=32, d_ff=48, vocab=V, head_dim=8,
               chunk=8, remat="none")
ENC_KW = dict(n_enc_layers=2, n_dec_layers=2, d_model=32, n_heads=4,
              n_kv_heads=4, d_ff=48, vocab=V, remat="none")
ARCHS = {"hybrid": ("zamba2-7b", HYB_KW), "rwkv": ("rwkv6-1.6b", RWKV_KW),
         "encdec": ("seamless-m4t-medium", ENC_KW)}
B, S, T, T_ENC = 4, 8, 16, 12
POS = np.array([S, S - 1, S, S - 2], np.int32)
# (prompt length, budget): whole scan chunks of 8
WORKLOAD = [(8, 5), (16, 3), (8, 6), (16, 4)]
ADAM = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-3)
TOL = 1e-5
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


def _inputs():
    rng = np.random.RandomState(17)
    return {"tokens": rng.randint(0, V, size=(B, S)).astype(np.int32),
            "next": rng.randint(0, V, size=(B,)).astype(np.int32),
            "labels": rng.randint(0, V, size=(B, S)).astype(np.int32),
            "frames": rng.randn(B, T_ENC, 32).astype(np.float32),
            "prompts": [rng.randint(0, V, size=p).astype(np.int32)
                        for p, _ in WORKLOAD]}


def _batch(fam, inp, torch_side):
    conv = torch.from_numpy if torch_side else (lambda a: a)
    b = {"tokens": conv(inp["tokens"])}
    if fam == "encdec":
        b["frames"] = conv(inp["frames"])
    return b


# ------------------------------------------------------------ rank side

def _t_model(fam):
    from repro_torch.configs import get_arch
    arch, kw = ARCHS[fam]
    model = get_arch(arch).model()
    return type(model)(dataclasses.replace(model.cfg, dtype=torch.float32,
                                           **kw))


def _init_cache(model, fam, ctx):
    from repro_torch.sharding.logical import distribute_tree
    cache = model.init_cache(B, T, T_ENC, device="cpu") if fam == "encdec" \
        else model.init_cache(B, T, device="cpu")
    if ctx is not None:
        cache = distribute_tree(cache, model.cache_axes(), ctx)
    return cache


def _serve(model, fam, params, ctx, quant):
    """(prefill logits, per-row decode logits, every cache leaf after
    the decode step), whole, as numpy."""
    from repro_torch.core.tree import tree_map
    from repro_torch.ops import ExecPolicy, use_policy
    from repro_torch.sharding.logical import whole
    inp = _inputs()
    cache = _init_cache(model, fam, ctx)
    with use_policy(ExecPolicy(quant=quant)), torch.no_grad():
        lp, cache = model.prefill(params, _batch(fam, inp, True), cache, ctx)
        ld, cache = model.decode_step(params, torch.from_numpy(inp["next"]),
                                      torch.from_numpy(POS), cache, ctx)
    return (whole(lp).numpy(), whole(ld).numpy(),
            tree_map(lambda t: whole(t).numpy().copy(), cache))


def _engine(model, params, ctx):
    from repro_torch.serve import Engine, EngineConfig
    eng = Engine(model, params, EngineConfig(capacity=4, max_seq=32,
                                             device="cpu"), ctx)
    for p, (_, budget) in zip(_inputs()["prompts"], WORKLOAD):
        eng.add_request(p, budget)
    return {r.uid: list(r.generated) for r in eng.run()}


def _train(model, fam, params, ctx):
    from repro_torch.core.tree import tree_map
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.logical import whole
    from repro_torch.train.steps import make_train_step
    inp = _inputs()
    batch = _batch(fam, inp, True)
    batch["labels"] = torch.from_numpy(inp["labels"])
    step = make_train_step(model, AdamWConfig(**ADAM), ctx)
    new_p, _, metrics = step(params, adamw_init(params), batch)
    return float(metrics["loss"]), tree_map(
        lambda t: whole(t).detach().numpy().copy(), new_p)


def _local_norm(y, scale):
    """Planted: the gated RMSNorm over each rank's own heads only."""
    from torch.distributed.tensor import Shard

    from repro_torch.models.common import rms_norm
    from repro_torch.sharding.logical import (mesh_sizes, redistribute,
                                              row_placements, spmd_global,
                                              whole)
    mesh = y.device_mesh
    n = mesh_sizes(mesh)["model"]
    j = mesh.get_local_rank("model")
    rows = row_placements(y)
    yl, sl = y.to_local(), whole(scale)
    c = yl.shape[-1] // n
    part = rms_norm(yl[..., j * c:(j + 1) * c], sl[j * c:(j + 1) * c])
    split = tuple(Shard(2) if a == "model" else r
                  for a, r in zip(mesh.mesh_dim_names, rows))
    return redistribute(spmd_global(part, mesh, split), rows)


def _norm_block(model, placed, full, ctx):
    """The hybrid's first Mamba2 block on the mesh (``mamba2_mesh``) with
    its gated norm and with the planted rank-local one, and unsharded
    (``mamba2_apply``), on the same seeded input: whole, as numpy."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.common import layer_views
    from repro_torch.models.mamba2 import mamba2_apply, mamba2_mesh
    from repro_torch.sharding.logical import gathered, shard, whole
    cfg = model.cfg.mamba_cfg
    x = torch.from_numpy(np.random.RandomState(5).randn(
        B, S, model.cfg.d_model).astype(np.float32))
    xm = shard(x, ctx, "batch", "act_seq", "act_embed")
    pm = tree_map(gathered, layer_views(placed["mamba_layers"])[0]["mamba"])
    with torch.no_grad():
        got = [whole(mamba2_mesh(pm, xm, cfg, ctx, None, False, **kw)[0])
               .numpy() for kw in ({}, {"norm": _local_norm})]
        want = mamba2_apply(layer_views(full["mamba_layers"])[0]["mamba"],
                            x, cfg, None).numpy()
    return got[0], got[1], want


def _rank(rank, world, shape, np_params):
    # the world's ranks share the host's cores: a pool of threads each
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    from repro_torch.bridge import params_from_numpy
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import ShardingCtx, distribute_tree
    mesh = mesh_groups(shape, ("data", "model"), "cpu")
    ctx = ShardingCtx(mesh)
    out = {}
    for fam in ARCHS:
        model = _t_model(fam)
        full = params_from_numpy(np_params[fam], "cpu")
        placed = distribute_tree(full, model.axes(), ctx)
        r = {"fp32": _serve(model, fam, placed, ctx, "none"),
             "train": _train(model, fam, placed, ctx)}
        if fam == "hybrid":
            r["int8"] = _serve(model, fam, placed, ctx, "int8")[:2]
            r["int8_plain"] = _serve(model, fam, full, None, "int8")[:2]
            if shape == (1, 2):
                r["planted"] = _norm_block(model, placed, full, ctx)
        if fam != "encdec":
            r["engine"] = _engine(model, full, ctx)
        out[fam] = r
    return out


# ------------------------------------------------------------ JAX side

def _j_model(fam):
    import jax.numpy as jnp

    from repro.configs.registry import get_arch as j_get_arch
    arch, kw = ARCHS[fam]
    m = j_get_arch(arch).model()
    return type(m)(dataclasses.replace(m.cfg, dtype=jnp.float32, **kw))


@functools.cache
def _jax_side() -> dict:
    """{family: (np params, {prefill, decode, cache, engine, loss,
    params})} of the unsharded JAX models, jitted."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as j_adamw
    from repro.serve import Engine as JEngine
    from repro.serve import EngineConfig as JEngineConfig
    from repro.train.steps import make_train_step as j_make_train_step
    inp = _inputs()
    out = {}
    for i, fam in enumerate(ARCHS):
        jm = _j_model(fam)
        rng = np.random.RandomState(30 + i)
        np_p = jax.tree_util.tree_map(
            lambda a: (np.asarray(a) + 0.1 * rng.randn(*a.shape)).astype(
                np.float32), jm.init(jax.random.PRNGKey(i)))
        jp = jax.tree_util.tree_map(jnp.asarray, np_p)
        batch = {k: jnp.asarray(v) for k, v in _batch(fam, inp,
                                                      False).items()}
        cache = jm.init_cache(B, T, enc_seq=T_ENC) if fam == "encdec" \
            else jm.init_cache(B, T)
        lp, cache = jax.jit(jm.prefill)(jp, batch, cache)
        ld, cache = jax.jit(jm.decode_step)(jp, jnp.asarray(inp["next"]),
                                            jnp.asarray(POS), cache)
        r = {"prefill": np.asarray(lp), "decode": np.asarray(ld),
             "cache": jax.tree_util.tree_map(np.asarray, cache)}
        if fam != "encdec":
            eng = JEngine(jm, jp, JEngineConfig(capacity=4, max_seq=32))
            for p, (_, budget) in zip(inp["prompts"], WORKLOAD):
                eng.add_request(p, budget)
            r["engine"] = {q.uid: list(q.generated) for q in eng.run()}
        batch["labels"] = jnp.asarray(inp["labels"])
        step = jax.jit(j_make_train_step(jm, j_adamw.AdamWConfig(**ADAM)))
        new_p, _, metrics = step(jp, j_adamw.adamw_init(jp), batch)
        r["loss"] = float(metrics["loss"])
        r["params"] = jax.tree_util.tree_map(np.asarray, new_p)
        out[fam] = (np_p, r)
    return out


@functools.cache
def _worlds() -> dict:
    np_params = {fam: v[0] for fam, v in _jax_side().items()}
    return {m: run_spmd(_rank, shape[0] * shape[1], "gloo", "cpu", shape,
                        np_params, timeout=300)
            for m, shape in MESHES.items()}


# ------------------------------------------------------------ the checks

def _close(got, want, tol, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = tol * (1.0 + np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= bound, f"{label}: max |d| {err:.3g} > {bound:.3g}"


def _items(tree, prefix=()):
    if isinstance(tree, dict):
        return [i for k in sorted(tree) for i in _items(tree[k],
                                                        prefix + (k,))]
    return [(prefix, tree)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("fam", sorted(ARCHS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_prefill_decode_and_cache_match_jax(mesh, fam):
    want = _jax_side()[fam][1]
    for rank, r in enumerate(_worlds()[mesh]):
        lp, ld, cache = r[fam]["fp32"]
        label = f"{mesh} rank {rank} {fam}"
        _close(lp, want["prefill"], TOL, f"{label} prefill")
        _close(ld, want["decode"], TOL, f"{label} decode")
        leaves = _items(cache)
        assert [p for p, _ in leaves] == [p for p, _ in
                                          _items(want["cache"])]
        for path, leaf in leaves:
            _close(leaf, _get(want["cache"], path), TOL,
                   f"{label} cache {'/'.join(path)}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_hybrid_int8_is_bitwise_to_the_unsharded_port(mesh):
    for rank, r in enumerate(_worlds()[mesh]):
        h = r["hybrid"]
        for got, want, what in zip(h["int8"], h["int8_plain"],
                                   ("prefill", "decode")):
            np.testing.assert_array_equal(
                got, want, err_msg=f"{mesh} rank {rank} int8 {what}")


@pytest.mark.parametrize("fam", ["hybrid", "rwkv"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_engine_tokens_match_jax(mesh, fam):
    want = _jax_side()[fam][1]["engine"]
    for rank, r in enumerate(_worlds()[mesh]):
        assert r[fam]["engine"] == want, (mesh, rank, fam)


@pytest.mark.parametrize("fam", sorted(ARCHS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_train_step_matches_jax(mesh, fam):
    want = _jax_side()[fam][1]
    loss, params = _worlds()[mesh][0][fam]["train"]
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
    for path, p in _items(params):
        np.testing.assert_allclose(p, _get(want["params"], path),
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"{fam} {'/'.join(path)}")


def test_planted_local_gated_norm_fails():
    """The first Mamba2 block on 1x2: with the whole gated norm within
    the bar of the unsharded block, with a rank-local one past it."""
    for rank, r in enumerate(_worlds()["1x2"]):
        good, bad, want = r["hybrid"]["planted"]
        _close(good, want, TOL, f"rank {rank} block")
        with pytest.raises(AssertionError, match="planted"):
            _close(bad, want, TOL, f"rank {rank} planted block")
