"""The port's training stack against the JAX package on the CPU: the
losses and their gradients, the vocab-chunked cross entropy,
``fake_quant_int8`` and ``quantize_tree``, AdamW with its clipping and
schedules, the train step (microbatches, ``cast_params_once``), the
synthetic data, checkpoints in both directions, and the launcher's
deterministic resume.

Inputs come from numpy seeds; JAX params reach the port through
``params_from_numpy``, moved off their init by a seeded 0.1·N(0, 1)
where a zero init would hide a fault (``_perturbed``). Models are small:
2 layers, d_model 32, vocab 300 (one padded CE chunk), the CNN at its
Tab.-I widths, the VGG at 48².

Tolerances, stated once (``test_torch_lm.py``'s):

* fp32 within ``TOL_FP32`` = 1e-5 of 1 + max|want|, the JAX side jitted:
  the same fp32 ops in another library differ by a few ulps, and a
  gradient sums them in another order;
* a bf16 model (its loss and each gradient) within ``TOL_BF16`` = 2⁻⁴ of
  1 + max|want|;
* AdamW's updated params, moments and lr within ``TOL_ADAM`` = 1e-6 of
  1 + max|want| (fp32 elementwise math; ``pow`` and ``sqrt`` a few ulps
  apart);
* exact things (data batches, checkpoints, int8 codes, the global norm
  summed in the reference's order, a resumed run's losses) bitwise.

Planted faults must fail their bars: a conv route that returns a
detached output (the CUDA wrapper's fault before ``ConvWindowFn``,
simulated on the CPU), Adam without its bias correction, and a global
norm summed in the tree's insertion order.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import TOL_BF16, TOL_FP32, _close, _tree_np
from test_torch_ssm import RWKV_KW, ZAMBA_KW, _perturbed

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.core.quantize import fake_quant_int8 as j_fake_quant_int8
from repro.core.quantize import quantize_tree as j_quantize_tree
from repro.data.pipeline import SyntheticMNIST as JSyntheticMNIST
from repro.data.pipeline import SyntheticTextConfig as JTextConfig
from repro.data.pipeline import SyntheticTextIterator as JTextIterator
from repro.models import common as jc
from repro.models.cnn import PaperCNN as JPaperCNN
from repro.models.cnn import PaperCNNConfig as JPaperCNNConfig
from repro.models.hybrid import HybridConfig as JHybridConfig
from repro.models.hybrid import HybridLM as JHybridLM
from repro.models.moe import MoEConfig as JMoEConfig
from repro.models.rwkv_lm import RWKVLM as JRWKVLM
from repro.models.rwkv_lm import RWKVLMConfig as JRWKVLMConfig
from repro.models.transformer import LMConfig as JLMConfig
from repro.models.transformer import TransformerLM as JTransformerLM
from repro.models.vgg import VGGStyleCNN as JVGG
from repro.models.vgg import VGGStyleCNNConfig as JVGGConfig
from repro.optim import adamw as j_adamw
from repro.optim import clip as j_clip
from repro.optim import schedule as j_schedule
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.quantize import QTensor, fake_quant_int8, quantize_tree
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.data.pipeline import (SyntheticMNIST, SyntheticTextConfig,
                                       SyntheticTextIterator, shard_batch)
from repro_torch.kernels.addtree import ops as at_ops
from repro_torch.kernels.conv_window import ops as cw_ops
from repro_torch.kernels.fused_cwp import ops as fc_ops
from repro_torch.kernels.qmatmul import ops as qm_ops
from repro_torch.launch import train as launcher
from repro_torch.models import common as tc
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
from repro_torch.models.hybrid import HybridConfig, HybridLM
from repro_torch.models.moe import MoEConfig
from repro_torch.models.rwkv_lm import RWKVLM, RWKVLMConfig
from repro_torch.models.transformer import LMConfig, TransformerLM
from repro_torch.models.vgg import VGGStyleCNN, VGGStyleCNNConfig
from repro_torch.ops import ExecPolicy, use_policy
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import clip as t_clip
from repro_torch.optim import schedule as t_schedule
from repro_torch.train.steps import loss_and_grads, make_train_step

TOL_ADAM = 1e-6
V = 300
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jpath(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _grads_close(got, want, tol, label):
    """Every leaf of the port's gradient tree within ``tol`` of the
    reference's leaf at the same path. A None leaf (the loss does not
    reach the parameter: command-r's ``ln2`` beside its parallel block)
    passes only where the reference's gradient is all zeros."""
    items = tree_items(got)
    assert sorted(p for p, _ in items) == sorted(
        tuple(k.key for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]), label
    for path, g in items:
        w = _jpath(want, path)
        if g is None:
            assert not np.asarray(w, np.float32).any(), \
                f"{label}: no gradient for {'/'.join(path)}"
            continue
        _close(g, w, tol, f"{label} d/d{'/'.join(path)}")


def _jax_loss_and_grads(jm, jp, jbatch):
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jp, jbatch)
    return loss, metrics, g


def _both(batch_np: dict):
    return ({k: jnp.asarray(v) for k, v in batch_np.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch_np.items()})


# ----------------------------------------------------------- the models

def _cnn_case(name):
    jm, tm = JPaperCNN(JPaperCNNConfig()), PaperCNN(PaperCNNConfig())
    jp = _perturbed(_tree_np(jm.init(jax.random.PRNGKey(0))), 1)
    b = JSyntheticMNIST(seed=0).batch(8, step=0)
    return jm, tm, jp, {k: np.asarray(v) for k, v in b.items()}


def _vgg_case(name):
    jm = JVGG(JVGGConfig(img_size=48))
    tm = VGGStyleCNN(VGGStyleCNNConfig(img_size=48))
    jp = _perturbed(_tree_np(jm.init(jax.random.PRNGKey(0))), 2)
    rng = np.random.RandomState(3)
    return jm, tm, jp, {
        "images": rng.randn(2, 3, 48, 48).astype(np.float32),
        "labels": rng.randint(0, 10, 2).astype(np.int32)}


def _tokens(rng, b=2, s=16, vocab=V):
    return {"tokens": rng.randint(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.randint(0, vocab, (b, s)).astype(np.int32)}


LM_KW = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=48, vocab=V, qkv_bias=True, rope_theta=1e6)
LM_VARIANTS = {
    "dense": {},
    "untied-softcap-sandwich": dict(tie_embeddings=False,
                                    final_softcap=30.0, attn_softcap=50.0,
                                    sandwich_norm=True, norm_plus_one=True,
                                    local_global=True, sliding_window=8),
    "full-ce-layernorm-parallel": dict(chunked_ce=False, norm="layernorm",
                                       parallel_block=True),
    "moe": dict(moe="moe"),
}


def _lm_case(name, variant="dense", remat="none"):
    jdt, tdt = DTYPES[name]
    kw = dict(LM_KW, **LM_VARIANTS[variant])
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("moe"):
        moe = dict(d_model=32, d_ff=24, n_experts=4, top_k=2, n_shared=1)
        jkw["moe"], tkw["moe"] = JMoEConfig(**moe), MoEConfig(**moe)
    jm = JTransformerLM(JLMConfig(**jkw, dtype=jdt, remat=remat))
    tm = TransformerLM(LMConfig(**tkw, dtype=tdt, remat=remat))
    jp = _perturbed(_tree_np(jm.init(jax.random.PRNGKey(0))), 4)
    batch = _tokens(np.random.RandomState(5))
    batch["loss_mask"] = (np.random.RandomState(6).rand(2, 16)
                          > 0.25).astype(np.float32)
    return jm, tm, jp, batch


def _hybrid_case(name):
    jdt, tdt = DTYPES[name]
    jm = JHybridLM(JHybridConfig(name="z", **ZAMBA_KW, dtype=jdt))
    tm = HybridLM(HybridConfig(name="z", **dict(ZAMBA_KW, remat="full"),
                               dtype=tdt))
    jp = _perturbed(_tree_np(jm.init(jax.random.PRNGKey(0))), 7)
    return jm, tm, jp, _tokens(np.random.RandomState(8), vocab=64)


def _rwkv_case(name):
    jdt, tdt = DTYPES[name]
    jm = JRWKVLM(JRWKVLMConfig(name="r", **RWKV_KW, dtype=jdt))
    tm = RWKVLM(RWKVLMConfig(name="r", **dict(RWKV_KW, remat="full"),
                             dtype=tdt))
    jp = _perturbed(_tree_np(jm.init(jax.random.PRNGKey(0))), 9)
    return jm, tm, jp, _tokens(np.random.RandomState(10), vocab=64)


CASES = {"cnn": _cnn_case, "vgg48": _vgg_case, "hybrid": _hybrid_case,
         "rwkv": _rwkv_case}
CASES.update({f"lm-{v}": (lambda name, v=v: _lm_case(name, v))
              for v in LM_VARIANTS})
CASES["lm-dense-remat"] = lambda name: _lm_case(name, "dense", "full")


@pytest.mark.parametrize("case,name", [
    *[(c, "f32") for c in CASES],
    ("lm-dense", "bf16"), ("lm-moe", "bf16"), ("rwkv", "bf16")])
def test_loss_and_grads_match_jax(case, name):
    """Each model's loss, metrics and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's loss. The LM cases carry a
    loss mask; the MoE case's loss includes the aux loss summed over
    its 2 layers; ``lm-dense-remat`` checkpoints every layer."""
    jm, tm, jp, batch = CASES[case](name)
    jb, tb = _both(batch)
    jloss, jmet, jg = _jax_loss_and_grads(jm, jax.tree_util.tree_map(
        jnp.asarray, jp), jb)
    loss, met, g = loss_and_grads(tm, params_from_numpy(jp, "cpu"), tb)
    tol = TOL_FP32 if name == "f32" else TOL_BF16
    _close(loss, jloss, tol, f"{case} {name} loss")
    assert sorted(met) == sorted(jmet)
    for k in met:
        _close(met[k], jmet[k], tol, f"{case} {name} {k}")
    if case == "lm-moe":
        assert float(met["aux"]) > 0
    _grads_close(g, jg, tol, f"{case} {name}")


def test_cnn_trains_through_the_conv_window_function():
    """The CNN's loss under the ``cuda`` backend (on the CPU:
    ``ConvWindowFn`` around the plain version) gives every parameter the
    reference's gradient; the conv gradients come from the Function's
    backward."""
    jm, tm, jp, batch = _cnn_case("f32")
    jb, tb = _both(batch)
    _, _, jg = _jax_loss_and_grads(jm, jax.tree_util.tree_map(jnp.asarray,
                                                              jp), jb)
    calls = []
    real = cw_ops.ConvWindowFn.backward

    def counted(ctx, g):
        calls.append(tuple(g.shape))
        return real(ctx, g)

    with use_policy(ExecPolicy(backend="cuda")), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(cw_ops.ConvWindowFn, "backward", staticmethod(counted))
        _, _, g = loss_and_grads(tm, params_from_numpy(jp, "cpu"), tb)
    assert sorted(calls) == [(8, 15, 26, 26), (8, 20, 8, 8)]
    _grads_close(g, jg, TOL_FP32, "cnn via ConvWindowFn")


def _detached_conv_window(x, w, b=None, *, stride=(1, 1), policy=None):
    """The fault: the kernel's output as a fresh tensor autograd cannot
    see (the CUDA wrapper before ``ConvWindowFn``)."""
    with torch.no_grad():
        return cw_ops._conv_window(x, w, b, stride=stride, policy=policy)


def test_planted_detached_conv_fails(monkeypatch):
    """With the conv route detached, conv1 and conv2 get no gradient and
    a train step's updated convs miss the reference's."""
    jm, tm, jp, batch = _cnn_case("f32")
    monkeypatch.setattr(cw_ops, "conv_window", _detached_conv_window)
    with use_policy(ExecPolicy(backend="cuda")):
        _, _, g = loss_and_grads(tm, params_from_numpy(jp, "cpu"),
                                 _both(batch)[1])
    assert g["conv1"]["w"] is None and g["conv2"]["b"] is None
    assert g["fc_w"] is not None
    with pytest.raises(AssertionError, match="no gradient"):
        _grads_close(g, _jax_loss_and_grads(
            jm, jax.tree_util.tree_map(jnp.asarray, jp),
            _both(batch)[0])[2], TOL_FP32, "planted")
    with use_policy(ExecPolicy(backend="cuda")), \
            pytest.raises(AssertionError, match="grad_norm|conv1/"):
        _train_step_vs_jax("cnn")


def test_kernels_without_a_backward_refuse_grad_on_the_cpu_too():
    """The grad guard runs before the device branch, so a call the card
    would refuse fails here too, naming the op; without grad it runs."""
    x = torch.randn(2, 15, 13, 13)
    w = torch.randn(20, 15, 6, 6, requires_grad=True)
    codes = torch.ones((3, 4), dtype=torch.int8)
    calls = {
        "fused_cwp": lambda: fc_ops.fused_cwp(x, w),
        "qmatmul": lambda: qm_ops.qmatmul(
            codes, codes.T.contiguous(), torch.ones(3, 1,
                                                    requires_grad=True), 1),
        "tree_reduce_sum": lambda: at_ops.tree_reduce_sum(
            torch.randn(5, 9, requires_grad=True))}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: an input requires"):
            call()
        with torch.no_grad():
            assert call() is not None


def test_the_training_modules_import_no_jax():
    """The new packages pull in nothing of JAX or the JAX package, in a
    fresh interpreter."""
    code = ("import sys\n"
            "import repro_torch.optim, repro_torch.train.mnist\n"
            "import repro_torch.data, repro_torch.checkpoint\n"
            "import repro_torch.launch.train, repro_torch.models.encdec\n"
            "import repro_torch.configs.seamless_m4t_medium\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parents[1] / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# --------------------------------------------------------- cross entropy

@pytest.mark.parametrize("v,chunk", [(37, 8), (64, 16), (50, 64)])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_chunked_cross_entropy(v, chunk, softcap, masked, transpose):
    """Padded last chunk (37 of 40, 50 of 64), softcap and mask: value
    and the gradients w.r.t. x and the weight against the full CE in the
    port and against the reference's chunked CE."""
    rng = np.random.RandomState(v + chunk)
    x = rng.randn(2, 5, 6).astype(np.float32)
    w = (rng.randn(6, v) if transpose else rng.randn(v, 6)).astype(
        np.float32)
    lab = rng.randint(0, v, (2, 5)).astype(np.int32)
    mask = (rng.rand(2, 5) > 0.4).astype(np.float32) if masked else None
    kw = dict(transpose_weight=transpose, final_softcap=softcap,
              chunk=chunk)

    def jfn(x, w):
        return jc.chunked_cross_entropy(
            x, w, jnp.asarray(lab),
            mask=None if mask is None else jnp.asarray(mask), **kw)

    jval, (jgx, jgw) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = tc.chunked_cross_entropy(tx, tw, torch.from_numpy(lab),
                                   mask=tmask, **kw)
    gx, gw = torch.autograd.grad(got, (tx, tw))
    _close(got.detach(), jval, TOL_FP32, "chunked CE vs JAX")
    _close(gx, jgx, TOL_FP32, "d/dx vs JAX")
    _close(gw, jgw, TOL_FP32, "d/dw vs JAX")
    logits = torch.einsum("bsd,dv->bsv" if transpose else "bsd,vd->bsv",
                          tx, tw)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    full = tc.cross_entropy_loss(logits, torch.from_numpy(lab), tmask)
    fx, fw = torch.autograd.grad(full, (tx, tw))
    _close(got.detach(), full.detach(), TOL_FP32, "chunked vs full CE")
    _close(gx, fx, TOL_FP32, "d/dx chunked vs full")
    _close(gw, fw, TOL_FP32, "d/dw chunked vs full")
    jfull = jc.cross_entropy_loss(jnp.asarray(logits.detach().numpy()),
                                  jnp.asarray(lab),
                                  None if mask is None
                                  else jnp.asarray(mask))
    _close(full.detach(), jfull, TOL_FP32, "full CE vs JAX")


def test_chunked_cross_entropy_keeps_no_chunk_logits():
    """The backward keeps the running reductions, not a chunk's logits:
    the graph saves no (tokens × chunk) tensor."""
    x = torch.randn(2, 8, 4, requires_grad=True)
    w = torch.randn(100, 4, requires_grad=True)
    lab = torch.randint(0, 100, (2, 8))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        loss = tc.chunked_cross_entropy(x, w, lab, chunk=32)
    assert saved and max(saved) < 16 * 32, saved
    loss.backward()
    assert x.grad is not None and w.grad.abs().sum() > 0


# ------------------------------------------------------ quantize helpers

@pytest.mark.parametrize("axis", [-1, 0, None])
def test_fake_quant_int8_forward_bitwise_straight_through(axis):
    rng = np.random.RandomState(11)
    x = rng.randn(6, 9).astype(np.float32) * 3
    w = rng.randn(6, 9).astype(np.float32)
    jy, jg = jax.value_and_grad(
        lambda v: jnp.sum(j_fake_quant_int8(v, axis) * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = fake_quant_int8(tx, axis)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(j_fake_quant_int8(jnp.asarray(x),
                                                         axis)))
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), tx)
    np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(np.asarray(jg), w)
    assert not np.array_equal(y.detach().numpy(), x)


def test_quantize_tree_codes_bitwise_small_leaves_kept():
    rng = np.random.RandomState(12)
    tree = {"w": rng.randn(8, 5).astype(np.float32),
            "tiny": rng.randn(3, 5).astype(np.float32),
            "b": rng.randn(40).astype(np.float32),
            "layers": {"wi": rng.randn(2, 4, 6).astype(np.float32)}}
    want = j_quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    got = quantize_tree(params_from_numpy(tree, "cpu"))
    for k in ("w",):
        assert isinstance(got[k], QTensor)
        np.testing.assert_array_equal(got[k].codes.numpy(),
                                      np.asarray(want[k].codes))
        np.testing.assert_array_equal(got[k].scale.numpy(),
                                      np.asarray(want[k].scale))
    q = got["layers"]["wi"]
    np.testing.assert_array_equal(q.codes.numpy(),
                                  np.asarray(want["layers"]["wi"].codes))
    for k in ("tiny", "b"):
        assert not isinstance(got[k], QTensor)
        np.testing.assert_array_equal(got[k].numpy(), tree[k])
        assert not isinstance(want[k], tuple)


# ------------------------------------------------------------- optimizer

def _opt_tree(rng):
    return {"embedding": rng.randn(7, 4).astype(np.float32),
            "layers": {"w": rng.randn(2, 4, 3).astype(np.float32),
                       "ln": rng.randn(2, 4).astype(np.float32)},
            "bias": rng.randn(5).astype(np.float32)}


def _adam_close(got, want, label):
    for path, g in tree_items(got):
        _close(g, _jpath(want, path), TOL_ADAM, f"{label} {'/'.join(path)}")


def _adam_run(cfg_kw, t_update=None, steps=4):
    """``steps`` AdamW updates in both packages from one seeded tree and
    seeded gradients; holds params, moments, step, lr and grad norm."""
    rng = np.random.RandomState(13)
    params = _opt_tree(rng)
    jcfg = j_adamw.AdamWConfig(**cfg_kw)
    tcfg = t_adamw.AdamWConfig(**{
        k: (torch.bfloat16 if v is jnp.bfloat16 else v)
        for k, v in cfg_kw.items()})
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = j_adamw.adamw_init(jp, jcfg)
    tp = params_from_numpy(params, "cpu")
    ts = t_adamw.adamw_init(tp, tcfg)
    update = t_update or t_adamw.adamw_update
    for i in range(steps):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.randn(*a.shape) * (3.0 if i % 2 else 0.3)
                       ).astype(np.float32), params)
        jp, js, jm = jax.jit(j_adamw.adamw_update, static_argnums=3)(
            jax.tree_util.tree_map(jnp.asarray, grads), js, jp, jcfg)
        tp, ts, tm = update(params_from_numpy(grads, "cpu"), ts, tp, tcfg)
        _adam_close(tp, jp, f"step {i + 1} params")
        _adam_close({"m": ts["m"], "v": ts["v"]},
                    {"m": js["m"], "v": js["v"]}, f"step {i + 1} moments")
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        _close(tm["lr"], jm["lr"], TOL_ADAM, "lr")
        _close(tm["grad_norm"], jm["grad_norm"], TOL_FP32, "grad_norm")


@pytest.mark.parametrize("cfg_kw", [
    dict(lr=1e-2, warmup_steps=2, total_steps=6),
    dict(lr=1e-2, warmup_steps=0, total_steps=3, clip_norm=None,
         weight_decay=0.0),
    dict(lr=3e-3, warmup_steps=1, total_steps=5, clip_norm=0.5,
         m_dtype=jnp.bfloat16)])
def test_adamw_update_matches_jax(cfg_kw):
    _adam_run(cfg_kw)


def _adamw_without_bias_correction(grads, opt_state, params, cfg):
    """The fault: Adam's moments used raw, as if bc1 = bc2 = 1."""
    step = opt_state["step"] + 1
    lr = t_schedule.cosine_schedule(step, cfg.lr, cfg.warmup_steps,
                                    cfg.total_steps, cfg.min_lr_ratio)
    grads, gnorm = t_clip.clip_by_global_norm(grads, cfg.clip_norm)
    m = tree_map(lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g,
                 opt_state["m"], grads)
    v = tree_map(lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * g * g,
                 opt_state["v"], grads)

    def upd(p, m_, v_):
        u = m_ / (torch.sqrt(v_) + cfg.eps)
        if p.ndim >= 2:
            u = u + cfg.weight_decay * p
        return p - lr * u
    return tree_map(upd, params, m, v), {"m": m, "v": v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}


def test_planted_adam_without_bias_correction_fails():
    with pytest.raises(AssertionError, match="params"):
        _adam_run(dict(lr=1e-2, warmup_steps=2, total_steps=6),
                  _adamw_without_bias_correction)


def test_schedules_and_clip_match_jax():
    for step in range(0, 14):
        js = jnp.asarray(step, jnp.int32)
        ts = torch.tensor(step, dtype=torch.int32)
        _close(t_schedule.cosine_schedule(ts, 1e-3, 3, 10, 0.1),
               j_schedule.cosine_schedule(js, 1e-3, 3, 10, 0.1), TOL_ADAM,
               f"cosine step {step}")
        _close(t_schedule.linear_warmup(ts, 2e-3, 5),
               j_schedule.linear_warmup(js, 2e-3, 5), TOL_ADAM,
               f"warmup step {step}")
    tree = _opt_tree(np.random.RandomState(14))
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = params_from_numpy(tree, "cpu")
    # a leaf's own sum runs in each library's reduction order, so the
    # norm agrees to an ulp or two here (the leaves' order: bitwise, below)
    _close(t_clip.global_norm(tt), j_clip.global_norm(jt), TOL_ADAM,
           "global_norm")
    for cap in (0.5, 1e3):
        got, n = t_clip.clip_by_global_norm(tt, cap)
        want, jn = j_clip.clip_by_global_norm(jt, cap)
        _close(n, jn, TOL_ADAM, f"norm before clip {cap}")
        _adam_close(got, want, f"clip {cap}")


def _order_sensitive_tree():
    """Squares that sum to 2²⁵ + 3 in sorted key order (a, b, c, z),
    rounded to 2²⁵ + 4 in fp32, but to 2²⁵ when z comes first."""
    one = np.ones(1, np.float32)
    return {"z": np.full(2, 2.0 ** 12, np.float32), "a": one, "b": one,
            "c": one}


def _insertion_order_global_norm(tree):
    """The fault: the leaves summed in the dicts' insertion order."""
    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] \
            if isinstance(t, dict) else [t]
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@pytest.mark.parametrize("planted", [False, True])
def test_global_norm_sums_in_the_reference_order(planted):
    tree = _order_sensitive_tree()
    want = float(j_clip.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                           tree)))
    fn = _insertion_order_global_norm if planted else t_clip.global_norm
    got = float(fn(params_from_numpy(tree, "cpu")))
    assert (got == want) != planted, (got, want)


# ------------------------------------------------------------ train step

def _train_step_vs_jax(case, microbatches=1, cast=False, name="f32"):
    """One train step in both packages from the same params and batch:
    loss, metrics and every updated param and moment. Adam's eps is
    1e-3 here: at the first step the update is m/(√v + eps) ≈ g/(|g| +
    eps), which at eps 1e-8 turns the rounding noise of a gradient that
    is zero in exact arithmetic (a key bias, under softmax's shift
    invariance) into a ±lr step whose sign no two libraries share."""
    jm, tm, jp, batch = CASES[case](name)
    jb, tb = _both(batch)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-3)
    jstep = jax.jit(j_make_train_step(jm, j_adamw.AdamWConfig(**kw),
                                      microbatches=microbatches,
                                      cast_params_once=cast))
    tstep = make_train_step(tm, t_adamw.AdamWConfig(**kw),
                            microbatches=microbatches,
                            cast_params_once=cast)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jout = jstep(jparams, j_adamw.adamw_init(jparams), jb)
    tparams = params_from_numpy(jp, "cpu")
    tout = tstep(tparams, t_adamw.adamw_init(tparams), tb)
    tol = TOL_FP32 if name == "f32" else TOL_BF16
    for k in jout[2]:
        _close(tout[2][k], jout[2][k], tol, f"{case} metric {k}")
    for path, p in tree_items(tout[0]):
        _close(p, _jpath(jout[0], path), tol, f"{case} {'/'.join(path)}")
    for path, p in tree_items({"m": tout[1]["m"], "v": tout[1]["v"]}):
        _close(p, _jpath(jout[1], path), tol, f"{case} {'/'.join(path)}")
    return tout


@pytest.mark.parametrize("case", ["cnn", "lm-dense", "lm-moe"])
def test_train_step_matches_jax(case):
    _train_step_vs_jax(case)


def test_microbatches_match_jax_and_one_batch():
    """Two microbatches against the reference's two, and against one
    batch of both: same loss (each half has as many unmasked tokens ±
    the mask, so the means differ; without a mask they agree)."""
    _train_step_vs_jax("lm-dense", microbatches=2)
    jm, tm, jp, batch = _lm_case("f32")
    del batch["loss_mask"]
    tb = _both(batch)[1]
    cfg = t_adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                              eps=1e-3)
    outs = []
    for mb in (1, 2):
        p = params_from_numpy(jp, "cpu")
        outs.append(make_train_step(tm, cfg, microbatches=mb)(
            p, t_adamw.adamw_init(p), tb))
    _close(outs[1][2]["loss"], outs[0][2]["loss"], TOL_FP32, "loss mb2/1")
    for path, p in tree_items(outs[1][0]):
        _close(p, _jpath(outs[0][0], path), TOL_FP32, "/".join(path))
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tm, cfg, microbatches=3)(
            params_from_numpy(jp, "cpu"),
            t_adamw.adamw_init(params_from_numpy(jp, "cpu")), tb)


def test_cast_params_once_matches_jax():
    """bf16 compute with the fp32 matrices cast once: against the
    reference's ``cast_params_once`` step (a bf16 model: 2⁻⁴)."""
    tout = _train_step_vs_jax("lm-dense", microbatches=2, cast=True,
                              name="bf16")
    assert all(p.dtype == torch.float32 for _, p in tree_items(tout[0]))


def test_stacked_layer_gradients_pass_gradcheck():
    """Layers are views into stacked leaves; their gradients accumulate
    into the stacks (float64 gradcheck through ``layer_views``)."""
    x = torch.randn(3, 4, dtype=torch.float64)

    def f(stack, bias):
        h = x
        for p in tc.layer_views({"w": stack, "nested": {"b": bias}}):
            h = torch.tanh(h @ p["w"] + p["nested"]["b"])
        return h.sum()

    stack = torch.randn(3, 4, 4, dtype=torch.float64, requires_grad=True)
    bias = torch.randn(3, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(f, (stack, bias))


# ------------------------------------------------------------------ data

def test_text_batches_bitwise_and_state_round_trip():
    jcfg = JTextConfig(vocab=97, seq_len=12, global_batch=3, seed=5)
    tcfg = SyntheticTextConfig(vocab=97, seq_len=12, global_batch=3, seed=5)
    jit_, tit = JTextIterator(jcfg), SyntheticTextIterator(tcfg)
    for _ in range(3):
        jb, tb = jit_.next_batch(), tit.next_batch()
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    state = json.loads(json.dumps(tit.state_dict()))
    assert state == jit_.state_dict() == {"seed": 5, "step": 3}
    resumed = SyntheticTextIterator.from_state(tcfg, state)
    np.testing.assert_array_equal(resumed.next_batch()["tokens"].numpy(),
                                  tit.next_batch()["tokens"].numpy())
    with pytest.raises(ValueError, match="seed"):
        SyntheticTextIterator.from_state(
            dataclasses.replace(tcfg, seed=6), state)


def test_mnist_batches_bitwise_and_shard_batch():
    jd, td = JSyntheticMNIST(seed=0), SyntheticMNIST(seed=0)
    np.testing.assert_array_equal(td.templates, jd.templates)
    for step in (0, 7):
        jb, tb = jd.batch(16, step=step), td.batch(16, step=step)
        for k in ("images", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    moved = shard_batch(tb, device="cpu")
    assert moved["images"].shape == (16, 1, 28, 28)
    with pytest.raises(NotImplementedError, match="A.10"):
        shard_batch(tb, mesh=object(), device="cpu")


# ----------------------------------------------------------- checkpoints

def _ckpt_trees():
    rng = np.random.RandomState(15)
    params = {"embedding": rng.randn(6, 4).astype(np.float32),
              "layers": {"wq": rng.randn(2, 4, 4).astype(np.float32)},
              "norm": rng.randn(4).astype(np.float32)}
    half = jnp.asarray(rng.randn(3, 4), jnp.bfloat16)
    return params, half


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    params, half = _ckpt_trees()
    jparams = dict(jax.tree_util.tree_map(jnp.asarray, params), half=half)
    jopt = j_adamw.adamw_init(jparams)
    jopt = dict(jopt, step=jnp.asarray(7, jnp.int32))
    JCheckpointManager(tmp_path, keep=2).save(
        3, params=jparams, opt_state=jopt, extra={"data": {"seed": 0,
                                                           "step": 3}})
    tmpl = params_from_numpy(_tree_np(jparams), "cpu")
    assert tmpl["half"].dtype == torch.bfloat16
    otmpl = t_adamw.adamw_init(tmpl)
    mgr = CheckpointManager(tmp_path)
    step, got, opt, extra = mgr.restore(params_template=tmpl,
                                        opt_template=otmpl, device="cpu")
    assert step == 3 and extra == {"data": {"seed": 0, "step": 3}}
    for path, t in tree_items(got):
        assert t.dtype == _jpath(tmpl, path).dtype
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(_jpath(jparams, path), np.float32))
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 7


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    params, half = _ckpt_trees()
    tparams = dict(params_from_numpy(params, "cpu"),
                   half=torch.from_numpy(np.asarray(half, np.float32)).to(
                       torch.bfloat16))
    topt = t_adamw.adamw_init(tparams)
    topt["m"] = tree_map(lambda v: v + 1, topt["m"])
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, params=tparams, opt_state=topt, extra={"k": s})
    assert mgr.steps() == [2, 3]
    jtmpl = jax.eval_shape(lambda: dict(
        jax.tree_util.tree_map(jnp.asarray, params), half=half))
    jot = jax.eval_shape(j_adamw.adamw_init, jtmpl)
    step, jp, jo, extra = JCheckpointManager(tmp_path).restore(
        params_template=jtmpl, opt_template=jot)
    assert step == 3 and extra == {"k": 3}
    assert jp["half"].dtype == jnp.bfloat16
    for path, t in tree_items(tparams):
        np.testing.assert_array_equal(np.asarray(_jpath(jp, path),
                                                 np.float32),
                                      t.float().numpy())
    np.testing.assert_array_equal(np.asarray(jo["m"]["embedding"]),
                                  topt["m"]["embedding"].numpy())
    keys = sorted(np.load(tmp_path / "step_000000003" / "params.npz"))
    assert keys == ["embedding", "half", "layers/wq", "norm"]


# ----------------------------------------------------- launcher (resume)

def _launch(tmp_path, ckpt, *extra):
    return launcher.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                          "cpu", "--steps", "6", "--global-batch", "4",
                          "--seq", "16", "--ckpt-every", "3", "--ckpt",
                          str(tmp_path / ckpt), *extra])


class _Killed(Exception):
    pass


def test_launcher_resumes_bit_exactly(tmp_path, monkeypatch, capsys):
    """Kill a run right after its step-3 checkpoint, invoke it again: it
    resumes from step 3 and its losses 4–6 equal the uninterrupted run's
    bitwise. ``--microbatches 2``'s first loss is the one-batch run's
    within 1e-5 relative. Each step prints its loss at full precision."""
    whole = _launch(tmp_path, "whole")
    printed = [float(ln.split("loss=")[1].split()[0])
               for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("step ")]
    assert printed == [whole["losses"][s] for s in range(1, 7)]
    assert whole["start"] == 0 and sorted(whole["losses"]) == list(
        range(1, 7))
    real_save = CheckpointManager.save

    def save_then_die(self, step, **kw):
        out = real_save(self, step, **kw)
        if step == 3:
            raise _Killed
        return out

    monkeypatch.setattr(CheckpointManager, "save", save_then_die)
    with pytest.raises(_Killed):
        _launch(tmp_path, "killed")
    monkeypatch.setattr(CheckpointManager, "save", real_save)
    resumed = _launch(tmp_path, "killed")
    assert resumed["start"] == 3
    assert "auto-resumed from step 3" in capsys.readouterr().out
    for s in (4, 5, 6):
        assert resumed["losses"][s] == whole["losses"][s], s
    mb = _launch(tmp_path, "mb2", "--microbatches", "2")
    assert abs(mb["losses"][1] - whole["losses"][1]) <= \
        1e-5 * abs(whole["losses"][1])
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "dbrx-132b"])
def test_meta_init_is_the_resume_template(arch):
    """``init(gen, device="meta")``, the launcher's resume template,
    draws nothing and has the real init's paths, shapes and dtypes."""
    from repro_torch.configs import get_arch
    model = launcher.reduced_config(get_arch(arch).model())
    meta = tree_items(model.init(torch.Generator(), device="meta"))
    real = tree_items(model.init(0, device="cpu"))
    assert all(t.device.type == "meta" for _, t in meta)
    assert [(p, t.shape, t.dtype) for p, t in meta] == \
        [(p, t.shape, t.dtype) for p, t in real]


def test_launcher_refuses_a_mesh_and_frames():
    with pytest.raises(NotImplementedError, match="A.10"):
        launcher.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                       "cpu", "--mesh", "2x2"])
    with pytest.raises(NotImplementedError, match="frames"):
        launcher.main(["--arch", "seamless-m4t-medium", "--device", "cpu"])
