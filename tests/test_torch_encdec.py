"""The port's encoder-decoder (seamless-m4t-medium's backbone) against the
JAX package on the CPU: its config and parameter count, the registry
and the launchers, ``encode``, ``prefill`` (logits and every cache
leaf), ``decode_step`` at a scalar and at per-row positions, and the
loss with every gradient.

Small sizes, as ``tests/test_models_smoke.py`` cuts it: 2 + 2 layers,
d_model 32, 4 heads, d_ff 48, vocab 64, 12 encoder frames. Inputs come
from a numpy seed; JAX params reach the port through
``params_from_numpy``. Tolerances are ``test_torch_lm.py``'s: fp32
within 1e-5 of 1 + max|want| against the jitted reference, a bf16 model
within 2⁻⁴.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import TOL_BF16, TOL_FP32, _close, _tree_np
from test_torch_ssm import _perturbed
from test_torch_train import _grads_close, _jax_loss_and_grads, _jpath

from repro.configs.registry import get_arch as j_get_arch
from repro.configs.seamless_m4t_medium import CONFIG as J_SEAMLESS
from repro.models.encdec import EncDecLM as JEncDecLM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.tree import tree_items
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.encdec import EncDecConfig, EncDecLM
from repro_torch.train.steps import loss_and_grads

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(n_enc_layers=2, n_dec_layers=2, d_model=32, n_heads=4,
             n_kv_heads=4, d_ff=48, vocab=64)
T_ENC, B = 12, 2


def _pair(name, remat="none"):
    jdt, tdt = DTYPES[name]
    jm = JEncDecLM(dataclasses.replace(J_SEAMLESS, **SMALL, dtype=jdt,
                                       remat="none"))
    tm = EncDecLM(dataclasses.replace(get_arch(
        "seamless-m4t-medium").model().cfg, **SMALL, dtype=tdt,
        remat=remat))
    jp = _perturbed(_tree_np(jm.init(jax.random.PRNGKey(0))), 21)
    return jm, tm, jp, params_from_numpy(jp, "cpu")


def _inputs(seed=22, s=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T_ENC, 32).astype(np.float32),
            rng.randint(0, 64, (B, s)).astype(np.int32),
            rng.randint(0, 64, (B, s)).astype(np.int32))


def _tol(name):
    return TOL_FP32 if name == "f32" else TOL_BF16


def test_config_param_count_and_registry():
    """The config field for field, the reference's parameter count (and
    the tensors of a small init: the formula counts every tensor), the
    arch in ``ARCH_IDS`` in the reference's order, its ArchSpec fields."""
    spec, jspec = get_arch("seamless-m4t-medium"), j_get_arch(
        "seamless-m4t-medium")
    mine = dataclasses.asdict(spec.model().cfg)
    ref = dataclasses.asdict(J_SEAMLESS)
    assert mine.pop("dtype") == torch.bfloat16
    assert ref.pop("dtype") == jnp.bfloat16
    assert mine == ref
    assert spec.model().param_count() == J_SEAMLESS.param_count() \
        == 614_739_968
    assert (spec.family, spec.frames, spec.dec_frac, spec.source,
            spec.cache_seq_divisor) == (jspec.family, jspec.frames,
                                        jspec.dec_frac, jspec.source,
                                        jspec.cache_seq_divisor)
    assert "seamless-m4t-medium" in ARCH_IDS
    _, tm, _, tp = _pair("f32")
    assert sum(t.numel() for _, t in tree_items(tp)) == tm.param_count()
    small = tm.init(0, device="cpu")
    assert sorted(p for p, _ in tree_items(small)) == \
        sorted(p for p, _ in tree_items(tp))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_encode_prefill_decode_and_cache_match_jax(name):
    """``encode``; a prefill of 8 tokens into a 12-position self cache
    (logits, then every leaf of the self and cross caches); two decode
    steps, at a scalar position and at per-row positions."""
    jm, tm, jp, tp = _pair(name)
    frames, toks, _ = _inputs()
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    tol = _tol(name)
    _close(tm.encode(tp, torch.from_numpy(frames)),
           jax.jit(jm.encode, static_argnums=2)(jp, jnp.asarray(frames),
                                                None), tol, "encode")
    jcache = jm.init_cache(B, 12, enc_seq=T_ENC)
    cache = tm.init_cache(B, 12, enc_seq=T_ENC, device="cpu")
    jl, jcache = jax.jit(jm.prefill)(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)},
        jcache)
    logits, cache = tm.prefill(tp, {"frames": torch.from_numpy(frames),
                                    "tokens": torch.from_numpy(toks)},
                               cache)
    _close(logits, jl, tol, f"prefill logits {name}")
    for path, leaf in tree_items(cache):
        assert leaf.dtype == DTYPES[name][1]
        _close(leaf, _jpath(jcache, path), tol, f"cache {'/'.join(path)}")
    for pos in (np.int32(8), np.array([8, 5], np.int32)):
        nxt = np.array([3, 9], np.int32)
        jl, jcache = jax.jit(jm.decode_step)(jp, jnp.asarray(nxt),
                                             jnp.asarray(pos), jcache)
        logits, cache = tm.decode_step(tp, torch.from_numpy(nxt),
                                       torch.from_numpy(np.asarray(pos)),
                                       cache)
        _close(logits, jl, tol, f"decode logits at {pos}")
        for path, leaf in tree_items(cache["self"]):
            _close(leaf, jcache["self"][path[0]], tol,
                   f"self cache {path[0]} after decode at {pos}")


def test_prefill_needs_frames_and_a_matching_cross_cache():
    _, tm, _, tp = _pair("f32")
    frames, toks, _ = _inputs()
    with pytest.raises(KeyError, match="frames"):
        tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                   tm.init_cache(B, 12, device="cpu"))
    with pytest.raises(ValueError, match="enc_seq=12"):
        tm.prefill(tp, {"frames": torch.from_numpy(frames),
                        "tokens": torch.from_numpy(toks)},
                   tm.init_cache(B, 16, device="cpu"))


@pytest.mark.parametrize("name,remat", [("f32", "none"), ("f32", "full"),
                                        ("bf16", "full")])
def test_loss_and_grads_match_jax(name, remat):
    """The loss (chunked CE over the tied embedding, with a loss mask)
    and every gradient, encoder and cross-attention included."""
    jm, tm, jp, tp = _pair(name, remat)
    frames, toks, labels = _inputs(23)
    mask = (np.random.RandomState(24).rand(B, 8) > 0.3).astype(np.float32)
    batch = {"frames": frames, "tokens": toks, "labels": labels,
             "loss_mask": mask}
    jloss, _, jg = _jax_loss_and_grads(
        jm, jax.tree_util.tree_map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met, g = loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(loss, jloss, _tol(name), "encdec loss")
    assert float(met["ce"]) == float(loss)
    _grads_close(g, jg, _tol(name), f"encdec {name} remat={remat}")
    assert all(float(t.abs().sum()) > 0 for _, t in
               tree_items(g["enc_layers"]))


def test_serve_launcher_refuses_encdec_for_want_of_frames():
    """The Engine feeds a prefill only tokens, and the reference's
    launcher fails on the missing frames too."""
    with pytest.raises(KeyError, match="frames"):
        serve_launcher.main(["--arch", "seamless-m4t-medium", "--device",
                             "cpu"])
