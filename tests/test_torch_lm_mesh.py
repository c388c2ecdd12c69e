"""The dense LM served and trained over a ``("data", "model")`` mesh,
against the JAX package's unsharded run (whose own sharded run equals it
up to its bars).

Two gloo worlds on the CPU, spawned through
``repro_torch.launch.mesh.run_spmd`` over ``repro_torch.sharding.groups``
meshes (the host-staged groups the card's gloo worlds run on): 1x2 (2
ranks) and 2x2 (4 ranks). Each rank lays the same params out by the
model's logical axes (``distribute_tree``) and runs, on DTensors:

* prefill and a per-row decode step in fp32, held against JAX at
  1e-5 · (1 + max|want|);
* the same under int8, bitwise to the port's unsharded int8 path (every
  MLP matmul a ``qmatmul`` on the rank's shard, the row-parallel ``wo``
  an exact int32 sum across ranks);
* the ``Engine`` in fp32 (tokens equal to JAX's ``Engine``) and in int8
  (tokens equal to the unsharded port ``Engine``);
* one train step (AdamW at eps 1e-3, as ``tests/test_torch_train.py``
  says why) against JAX's at the reference's bars of
  ``tests/test_distributed.py``: loss rtol 1e-5, params rtol 2e-4 /
  atol 2e-5;
* ``shard_batch``; a checkpoint saved from 1x2 restored onto 2x2, and one
  saved from 2x2 restored onto 1x2 (the elastic restore), bitwise;
* the other dense archs, reduced (2 layers, d 64) in fp32 and each under
  its own rules (``ArchSpec.rules()``: qwen3-14b's and gemma2-2b's
  ``act_seq`` over ``model``): qwen3's qk-norm, gemma2's sliding window
  (cut to 4 so that it masks), softcaps and sandwich norms, command-r's
  layernorm biases, internvl2's vision prefix; prefill and decode logits
  in fp32 against JAX, and under int8 bitwise to the port's unsharded
  int8 path;
* the 1x2 world also runs ``cross_pod_grad_reduce`` over a (pod=2) mesh
  and a planted fault: a cache write whose rank takes its positions from
  0 (not from the offset it holds) moves the decode logits past the bar.

The rank bodies import no JAX (their helpers live in this module, whose
JAX imports sit in the test functions); the JAX side runs here.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_spmd

KW = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab=96, qkv_bias=True)
B, S, T = 4, 8, 12                      # batch, prompt, cache length
WORKLOAD = [(5, 6), (8, 4), (6, 6), (7, 5)]
ADAM = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-3)
TOL = 1e-5
# the other dense archs on the mesh: reduced, fp32, the window cut to
# WINDOW; internvl2 prefills PATCHES vision embeddings before the text;
# their cache holds T_VAR positions
VARIANTS = ("qwen3-14b", "gemma2-2b", "command-r-35b", "internvl2-26b")
WINDOW, PATCHES, T_VAR = 4, 4, 16


def _tokens():
    rng = np.random.RandomState(7)
    tok = rng.randint(0, KW["vocab"], size=(B, S)).astype(np.int32)
    nxt = rng.randint(0, KW["vocab"], size=(B,)).astype(np.int32)
    pos = np.array([S, S - 1, S, S - 2], np.int32)
    labels = rng.randint(0, KW["vocab"], size=(B, S)).astype(np.int32)
    prompts = [rng.randint(0, KW["vocab"], size=p).astype(np.int32)
               for p, _ in WORKLOAD]
    return tok, nxt, pos, labels, prompts


def _small(cfg):
    """The reduced config in fp32, its sliding window cut to WINDOW."""
    return dict(sliding_window=WINDOW if cfg.sliding_window else None)


def _vision(arch):
    """internvl2's (B, PATCHES, 64) vision embeddings, else None."""
    if arch != "internvl2-26b":
        return None
    return np.random.RandomState(8).randn(B, PATCHES, 64).astype(np.float32)


# ------------------------------------------------------------ rank side

def _t_model():
    from repro_torch.models.transformer import LMConfig, TransformerLM
    return TransformerLM(LMConfig(**KW, dtype=torch.float32))


def _whole_np(tree):
    from repro_torch.core.tree import tree_map
    from repro_torch.sharding.logical import whole
    return tree_map(lambda t: whole(t).detach().numpy().copy(), tree)


def _forward(model, params, cache, ctx, quant):
    """(prefill logits, per-row decode logits), whole, as numpy."""
    from repro_torch.ops import ExecPolicy, use_policy
    from repro_torch.sharding.logical import whole
    tok, nxt, pos, _, _ = _tokens()
    with use_policy(ExecPolicy(quant=quant)), torch.no_grad():
        lp, cache = model.prefill(params, {"tokens": torch.from_numpy(tok)},
                                  cache, ctx)
        ld, _ = model.decode_step(params, torch.from_numpy(nxt),
                                  torch.from_numpy(pos), cache, ctx)
    return whole(lp).numpy(), whole(ld).numpy()


def _variant_model(arch):
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    cfg = reduced_config(get_arch(arch).model()).cfg
    return type(get_arch(arch).model())(
        dataclasses.replace(cfg, dtype=torch.float32, **_small(cfg)))


def _variant_forward(model, params, ctx, quant, arch):
    """(prefill logits, per-row decode logits) of a reduced arch, whole,
    as numpy; internvl2 prefills its vision embeddings first."""
    from repro_torch.ops import ExecPolicy, use_policy
    from repro_torch.sharding.logical import distribute_tree, whole
    tok, nxt, pos, _, _ = _tokens()
    vis = _vision(arch)
    batch = {"tokens": torch.from_numpy(tok)}
    if vis is not None:
        batch["vision_embeds"] = torch.from_numpy(vis)
        pos = pos + PATCHES
    cache = model.init_cache(B, T_VAR, device="cpu")
    if ctx is not None:
        cache = distribute_tree(cache, model.cache_axes(), ctx)
    with use_policy(ExecPolicy(quant=quant)), torch.no_grad():
        lp, cache = model.prefill(params, batch, cache, ctx)
        ld, _ = model.decode_step(params, torch.from_numpy(nxt),
                                  torch.from_numpy(pos), cache, ctx)
    return whole(lp).numpy(), whole(ld).numpy()


def _variants(mesh, variants):
    """Each reduced arch on ``mesh`` under its own rules: fp32 and int8
    logits, and the unsharded int8 ones."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_arch
    from repro_torch.sharding.logical import ShardingCtx, distribute_tree
    out = {}
    for arch, np_params in variants.items():
        model = _variant_model(arch)
        ctx = ShardingCtx(mesh, get_arch(arch).rules())
        full = params_from_numpy(np_params, "cpu")
        placed = distribute_tree(full, model.axes(), ctx)
        out[arch] = {q: _variant_forward(model, placed, ctx, q, arch)
                     for q in ("none", "int8")}
        out[arch]["int8_plain"] = _variant_forward(model, full, None,
                                                   "int8", arch)
    return out


def _engine_tokens(model, params, ctx, quant):
    from repro_torch.ops import ExecPolicy
    from repro_torch.serve import Engine, EngineConfig
    eng = Engine(model, params, EngineConfig(
        capacity=4, max_seq=16, device="cpu",
        policy=ExecPolicy(quant=quant)), ctx)
    for p, (_, budget) in zip(_tokens()[4], WORKLOAD):
        eng.add_request(p, budget)
    return {r.uid: list(r.generated) for r in eng.run()}


def _train_step(model, params, ctx):
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step
    tok, _, _, labels, _ = _tokens()
    step = make_train_step(model, AdamWConfig(**ADAM), ctx)
    return step(params, adamw_init(params),
                {"tokens": torch.from_numpy(tok),
                 "labels": torch.from_numpy(labels)})


def _mesh_body(rank, world, shape, np_params, variants, ckpt_in,
               ckpt_out):
    """Everything a world checks; returns numpy results (rank 0's are
    the ones compared, every rank's must agree)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import tree_items
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import layers
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import (NamedSharding, ShardingCtx,
                                              distribute_tree, local_part,
                                              param_shardings)
    mesh = mesh_groups(shape, ("data", "model"), "cpu")
    ctx = ShardingCtx(mesh)
    model = _t_model()
    full = params_from_numpy(np_params, "cpu")
    placed = distribute_tree(full, model.axes(), ctx)
    out = {"specs": {"/".join(p): str(t.placements)
                     for p, t in tree_items(placed)}}

    def fresh_cache():
        return distribute_tree(model.init_cache(B, T, device="cpu"),
                               model.cache_axes(), ctx)

    out["fp32"] = _forward(model, placed, fresh_cache(), ctx, "none")
    out["int8"] = _forward(model, placed, fresh_cache(), ctx, "int8")
    out["int8_plain"] = _forward(model, full,
                                 model.init_cache(B, T, device="cpu"),
                                 None, "int8")
    out["engine_fp32"] = _engine_tokens(model, full, ctx, "none")
    out["engine_int8"] = _engine_tokens(model, full, ctx, "int8")
    out["engine_int8_plain"] = _engine_tokens(model, full, None, "int8")
    out["variants"] = _variants(mesh, variants)

    # shard_batch: this rank's rows of the global batch
    tok = _tokens()[0]
    sb = shard_batch({"tokens": torch.from_numpy(tok)}, mesh, device="cpu")
    loc, off = local_part(sb["tokens"])
    out["shard_batch"] = (off, loc.numpy().copy(),
                          str(sb["tokens"].placements))

    new_params, new_opt, metrics = _train_step(model, placed, ctx)
    out["train"] = (float(metrics["loss"]), _whole_np(new_params))
    mgr = CheckpointManager(ckpt_out)
    mgr.save(1, params=new_params, opt_state=new_opt)

    # the elastic restore of another mesh's checkpoint onto this one
    meta = model.init(torch.Generator(), device="meta")
    psh = param_shardings(meta, model.axes(), mesh)
    osh = {"m": psh, "v": psh, "step": NamedSharding(mesh, ())}
    _, rp, ro, _ = CheckpointManager(ckpt_in).restore(
        params_template=meta, opt_template=adamw_init(meta, AdamWConfig()),
        device="cpu", params_shardings=psh, opt_shardings=osh)
    out["restored"] = (_whole_np(rp), _whole_np({"m": ro["m"],
                                                 "v": ro["v"]}),
                       {"/".join(p): str(t.placements)
                        for p, t in tree_items(rp)})

    if shape == (1, 2):
        out["cross_pod"] = _cross_pod(rank)
        # planted: every rank writes the cache as if it held positions 0..
        real = layers._cache_part

        def planted(c):
            loc, off = real(c)
            return loc, (off[0], 0) + tuple(off[2:])

        layers._cache_part = planted
        try:
            out["planted"] = _forward(model, placed, fresh_cache(), ctx,
                                      "none")
        finally:
            layers._cache_part = real
    return out


def _cross_pod(rank):
    """``cross_pod_grad_reduce`` over a (pod=2, data=1, model=1) mesh:
    each rank a pod with its own gradients."""
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.train.compression import (cross_pod_grad_reduce,
                                               init_ef_state)
    mesh = mesh_groups((2, 1, 1), ("pod", "data", "model"), "cpu")
    grads = _pod_grads(rank)
    res = {}
    for mode in ("none", "bf16", "int8"):
        g, ef = cross_pod_grad_reduce(grads, init_ef_state(grads),
                                      mesh=mesh, mode=mode)
        res[mode] = (_whole_np(g), _whole_np(ef))
    return res


def _pod_grads(rank):
    g = torch.Generator().manual_seed(100 + rank)
    return {"a": torch.randn((5, 7), generator=g),
            "b": {"c": torch.randn((11,), generator=g) * 1e-3}}


# ------------------------------------------------------------ JAX side

@functools.cache
def _jax_side():
    """(np params, {fp32 prefill/decode logits, engine tokens, train
    (loss, params)}) of the unsharded JAX model."""
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import LMConfig as JLMConfig
    from repro.models.transformer import TransformerLM as JTransformerLM
    from repro.optim import adamw as j_adamw
    from repro.serve import Engine as JEngine
    from repro.serve import EngineConfig as JEngineConfig
    from repro.train.steps import make_train_step as j_make_train_step
    jm = JTransformerLM(JLMConfig(**KW, dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tok, nxt, pos, labels, prompts = _tokens()
    lp, cache = jm.prefill(jp, {"tokens": jnp.asarray(tok)},
                           jm.init_cache(B, T))
    ld, _ = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), cache)
    eng = JEngine(jm, jp, JEngineConfig(capacity=4, max_seq=16))
    for p, (_, budget) in zip(prompts, WORKLOAD):
        eng.add_request(p, budget)
    tokens = {r.uid: list(r.generated) for r in eng.run()}
    step = jax.jit(j_make_train_step(jm, j_adamw.AdamWConfig(**ADAM)))
    new_p, _, metrics = step(jp, j_adamw.adamw_init(jp),
                             {"tokens": jnp.asarray(tok),
                              "labels": jnp.asarray(labels)})
    return np_params, {
        "prefill": np.asarray(lp), "decode": np.asarray(ld),
        "engine": tokens, "loss": float(metrics["loss"]),
        "params": jax.tree_util.tree_map(np.asarray, new_p)}


@functools.cache
def _jax_variants():
    """{arch: (np params, fp32 prefill logits, decode logits)} of each
    reduced arch's unsharded JAX model."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_arch as j_get_arch
    from repro.launch.train import reduced_config as j_reduced_config
    tok, nxt, pos, _, _ = _tokens()
    out = {}
    for arch in VARIANTS:
        cfg = j_reduced_config(j_get_arch(arch).model()).cfg
        jm = type(j_get_arch(arch).model())(
            dataclasses.replace(cfg, dtype=jnp.float32, **_small(cfg)))
        jp = jm.init(jax.random.PRNGKey(1))
        batch = {"tokens": jnp.asarray(tok)}
        p = pos
        if _vision(arch) is not None:
            batch["vision_embeds"] = jnp.asarray(_vision(arch))
            p = pos + PATCHES
        lp, cache = jm.prefill(jp, batch, jm.init_cache(B, T_VAR))
        ld, _ = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(p), cache)
        out[arch] = (jax.tree_util.tree_map(np.asarray, jp),
                     np.asarray(lp), np.asarray(ld))
    return out


@functools.cache
def _worlds():
    """The 1x2 world, then the 2x2 world. Checkpoints: U, the unsharded
    port's train step (written here), restored by the 1x2 world; A, the
    1x2 world's step, restored by the 2x2 world; B, the 2x2 world's step,
    restored here without a mesh."""
    np_params, _ = _jax_side()
    tmp = tempfile.mkdtemp(prefix="lm_mesh_")
    u, a, b = (os.path.join(tmp, n) for n in ("u", "a", "b"))
    _save_unsharded(np_params, u)
    variants = {arch: v[0] for arch, v in _jax_variants().items()}
    w12 = run_spmd(_mesh_body, 2, "gloo", "cpu", (1, 2), np_params,
                   variants, u, a, timeout=240)
    w22 = run_spmd(_mesh_body, 4, "gloo", "cpu", (2, 2), np_params,
                   variants, a, b, timeout=240)
    return {"1x2": w12, "2x2": w22, "dirs": (u, a, b)}


def _save_unsharded(np_params, path):
    """The unsharded port's train step, saved: what the 1x2 world
    restores."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint.manager import CheckpointManager
    model = _t_model()
    p, o, _ = _train_step(model, params_from_numpy(np_params, "cpu"), None)
    CheckpointManager(path).save(1, params=p, opt_state=o)


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


MESHES = ["1x2", "2x2"]


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_agrees(mesh):
    ranks = _worlds()[mesh]
    for r in ranks[1:]:
        for k in ("fp32", "int8"):
            for a, b in zip(r[k], ranks[0][k]):
                np.testing.assert_array_equal(a, b)
        assert r["engine_fp32"] == ranks[0]["engine_fp32"]
        assert r["train"][0] == ranks[0]["train"][0]


@pytest.mark.parametrize("mesh", MESHES)
def test_params_are_laid_out_by_the_axes(mesh):
    specs = _worlds()[mesh][0]["specs"]
    if mesh == "1x2":
        assert specs["layers/mlp/wi"] == "(Replicate(), Shard(dim=2))"
        assert specs["layers/attn/wo"] == "(Replicate(), Shard(dim=1))"
        assert specs["embedding"] == "(Replicate(), Shard(dim=0))"
    else:
        assert specs["layers/mlp/wo"] == "(Shard(dim=2), Shard(dim=1))"
        assert specs["embedding"] == "(Shard(dim=1), Shard(dim=0))"
    assert specs["layers/ln1"] == "(Replicate(), Replicate())"


@pytest.mark.parametrize("mesh", MESHES)
def test_prefill_and_decode_logits_match_jax(mesh):
    _, want = _jax_side()
    lp, ld = _worlds()[mesh][0]["fp32"]
    _close(lp, want["prefill"], TOL, f"{mesh} prefill")
    _close(ld, want["decode"], TOL, f"{mesh} decode")
    assert (lp.argmax(-1) == want["prefill"].argmax(-1)).all()


@pytest.mark.parametrize("mesh", MESHES)
def test_int8_is_bitwise_to_the_unsharded_port(mesh):
    r = _worlds()[mesh][0]
    for got, want, what in zip(r["int8"], r["int8_plain"],
                               ("prefill", "decode")):
        np.testing.assert_array_equal(got, want, err_msg=f"{mesh} {what}")


@pytest.mark.parametrize("mesh", MESHES)
def test_engine_tokens(mesh):
    _, want = _jax_side()
    r = _worlds()[mesh][0]
    assert r["engine_fp32"] == want["engine"]
    assert r["engine_int8"] == r["engine_int8_plain"]


@pytest.mark.parametrize("arch", VARIANTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_dense_arch_logits_match_jax_under_its_rules(mesh, arch):
    _, want_p, want_d = _jax_variants()[arch]
    r = _worlds()[mesh][0]["variants"][arch]
    lp, ld = r["none"]
    _close(lp, want_p, TOL, f"{mesh} {arch} prefill")
    _close(ld, want_d, TOL, f"{mesh} {arch} decode")
    for got, want, what in zip(r["int8"], r["int8_plain"],
                               ("prefill", "decode")):
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{mesh} {arch} int8 {what}")


def test_planted_wrong_rank_cache_write_fails():
    _, want = _jax_side()
    good = _worlds()["1x2"][0]["fp32"]
    bad = _worlds()["1x2"][0]["planted"]
    _close(good[1], want["decode"], TOL, "decode")
    # the prefill attends over the cache it wrote, so both steps move
    for got, key in zip(bad, ("prefill", "decode")):
        with pytest.raises(AssertionError, match=key):
            _close(got, want[key], TOL, f"planted {key}")


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_matches_jax(mesh):
    _, want = _jax_side()
    loss, params = _worlds()[mesh][0]["train"]
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
    for path, p in _items(params):
        w = want["params"]
        for k in path:
            w = w[k]
        np.testing.assert_allclose(p, np.asarray(w), rtol=2e-4, atol=2e-5,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("mesh", MESHES)
def test_shard_batch_keeps_this_ranks_rows(mesh):
    tok = _tokens()[0]
    for rank, r in enumerate(_worlds()[mesh]):
        off, rows, place = r["shard_batch"]
        d = 2 if mesh == "2x2" else 1
        assert off[0] == (rank // 2) * (B // d)
        np.testing.assert_array_equal(rows, tok[off[0]:off[0] + B // d])
        # the data axis takes the rows even at size 1 (the reference's
        # P(("data",)) does too)
        assert place == "(Shard(dim=0), Replicate())"


@pytest.mark.parametrize("mesh", MESHES)
def test_elastic_restore_across_meshes(mesh):
    """1x2 restores the unsharded port's checkpoint, 2x2 the 1x2 world's:
    each leaf whole again, equal to what was saved, and laid out by the
    restoring mesh's shardings."""
    from repro_torch.checkpoint.manager import load_pytree
    u, a, _ = _worlds()["dirs"]
    src = u if mesh == "1x2" else a
    params, moments, specs = _worlds()[mesh][0]["restored"]
    template = _t_model().init(torch.Generator(), device="meta")
    saved = load_pytree(template, os.path.join(src, "step_000000001",
                                               "params.npz"), "cpu")
    for (path, got), (_, want) in zip(_items(params), _items(saved)):
        np.testing.assert_array_equal(got, want.numpy(),
                                      err_msg="/".join(path))
    assert specs == _worlds()[mesh][0]["specs"]
    assert set(moments) == {"m", "v"}


def test_checkpoint_of_2x2_restores_onto_one_device():
    """The 2x2 world's checkpoint, written by its rank 0 from DTensors
    joined whole, restores without a mesh to the 2x2 world's params."""
    from repro_torch.checkpoint.manager import CheckpointManager
    _, _, b = _worlds()["dirs"]
    meta = _t_model().init(torch.Generator(), device="meta")
    _, params, _, _ = CheckpointManager(b).restore(params_template=meta,
                                                   device="cpu")
    want = _worlds()["2x2"][0]["train"][1]
    for (path, got), (_, w) in zip(_items(params), _items(want)):
        np.testing.assert_array_equal(got.numpy(), w, err_msg="/".join(path))


def test_cross_pod_reduce_against_the_reference_functions():
    """Each pod's gradients compressed by the reference's own
    ``compress_decompress`` / ``error_feedback_compress``, summed as the
    reference's psum sums (bf16 in bf16), averaged: bitwise."""
    import jax.numpy as jnp

    from repro.train import compression as jc
    res = _worlds()["1x2"][0]["cross_pod"]
    g0, g1 = (_whole_np(_pod_grads(r)) for r in (0, 1))
    for path, a in _items(g0):
        b = g1
        for k in path:
            b = b[k]
        got = {m: res[m][0] for m in res}
        for k in path:
            got = {m: got[m][k] for m in got}
        np.testing.assert_array_equal(got["none"], a)     # the baseline
        bf = (jnp.asarray(a).astype(jnp.bfloat16)
              + jnp.asarray(b).astype(jnp.bfloat16)).astype(jnp.float32)
        np.testing.assert_array_equal(got["bf16"], np.asarray(bf / 2.0))
        s0, e0 = jc.error_feedback_compress(jnp.asarray(a),
                                            jnp.zeros(a.shape), "int8")
        s1, _ = jc.error_feedback_compress(jnp.asarray(b),
                                           jnp.zeros(b.shape), "int8")
        np.testing.assert_array_equal(got["int8"], np.asarray((s0 + s1)
                                                              / 2.0))
        ef = res["int8"][1]
        for k in path:
            ef = ef[k]
        np.testing.assert_array_equal(ef, np.asarray(e0))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
def test_compression_functions_bitwise(mode, scale):
    """``compress_decompress``, ``error_feedback_compress`` and
    ``init_ef_state`` against the reference's, in fp32, op by op."""
    import jax.numpy as jnp

    from repro.train import compression as jc
    from repro_torch.train import compression as tc
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((33, 17)) * scale).astype(np.float32)
    ef = (rng.standard_normal((33, 17)) * scale * 1e-2).astype(np.float32)
    np.testing.assert_array_equal(
        tc.compress_decompress(torch.from_numpy(x), mode).numpy(),
        np.asarray(jc.compress_decompress(jnp.asarray(x), mode)))
    ts, te = tc.error_feedback_compress(torch.from_numpy(x),
                                        torch.from_numpy(ef), mode)
    js, je = jc.error_feedback_compress(jnp.asarray(x), jnp.asarray(ef),
                                        mode)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    z = tc.init_ef_state({"w": torch.from_numpy(x)})
    assert z["w"].dtype == torch.float32 and not z["w"].any()


def test_cross_pod_reduce_without_a_pod_axis_is_the_identity():
    from repro_torch.train.compression import cross_pod_grad_reduce

    class _Mesh:
        mesh_dim_names = ("data", "model")

    g = {"w": torch.ones(3)}
    assert cross_pod_grad_reduce(g, g, mesh=_Mesh) == (g, g)
