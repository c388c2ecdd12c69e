"""The port's serving stack carrying the sub-quadratic LMs, against the
JAX package on the CPU: ``SlotKVCache`` over the zamba2 hybrid's and the
RWKV-6 LM's recurrent caches, the continuous-batching ``Engine`` (against
its naive one-request loop and against JAX's ``Engine``), and the
launcher.

Models are zamba2-7b cut to 5 layers (a shared block after every 2,
d_model 32, SSD chunk 8) and rwkv6-1.6b cut to 2 layers (d_model 32, WKV
chunk 8), vocab 64; prompts are 8 or 16 tokens, whole chunks. Engine
tokens are held exactly:

* fp32 models (bf16 and int8 KV caches are the bf16 models' below)
  against JAX's engine jitted, as it serves, with a float and an int8 KV
  cache, and zamba2 under ``ExecPolicy(quant="int8")``, its shared MLP
  through the plain ``qmatmul``;
* bf16 models, with a bf16 and an int8 KV cache, against JAX's engine
  run op by op (``jax.disable_jit``): under jit XLA rewrites bf16 chains
  (an RWKV prefill's logits move by an ulp between the reference's own
  jitted and op-by-op runs, enough to flip a near-tied token), while the
  port's blocks round as the op-by-op reference does. Two roundings are
  held to the port's there, as ``tests/test_torch_lm.py`` does: the
  shared MLP's gelu (``_PORT_ROUNDING``) and the int8 cache's scale
  (the compiled ``absmax × fp32(1/127)``).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _PORT_ROUNDING, _compiled_quantize_int8

import repro.configs.registry as j_registry
import repro.serve.cache as j_cache
from repro.configs.rwkv6_16b import CONFIG as J_RWKV
from repro.configs.zamba2_7b import CONFIG as J_ZAMBA
from repro.launch import serve as j_launcher
from repro.models import common as jc
from repro.models.hybrid import HybridLM as JHybridLM
from repro.models.rwkv_lm import RWKVLM as JRWKVLM
from repro.ops import ExecPolicy as JPolicy
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve.cache import _quantize_leaves as j_quantize_leaves
import repro_torch.configs as t_configs
import repro_torch.kernels.qmatmul.ref as qm_ref
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.launch import serve as launcher
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.rwkv_lm import RWKVLM
from repro_torch.ops import ExecPolicy
from repro_torch.serve import (Engine, EngineConfig, SlotKVCache,
                               make_decode_step, make_prefill_step)
from repro_torch.serve.cache import _quantize_leaves

V = 64
ZAMBA_KW = dict(n_layers=5, d_model=32, n_heads=4, n_kv_heads=4, d_ff=48,
                vocab=V, d_state=8, shared_interval=2, mamba_chunk=8,
                remat="none")
RWKV_KW = dict(n_layers=2, d_model=32, d_ff=48, vocab=V, head_dim=8,
               chunk=8, remat="none")
# (prompt length, token budget): every prompt a whole number of chunks
WORKLOAD = [(8, 5), (16, 3), (8, 6), (16, 4), (8, 5)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _models(model: str, name: str):
    jdt, tdt = DTYPES[name]
    if model == "zamba2":
        return (JHybridLM(dataclasses.replace(J_ZAMBA, dtype=jdt,
                                              **ZAMBA_KW)),
                HybridLM(dataclasses.replace(
                    get_arch("zamba2-7b").model().cfg, dtype=tdt,
                    **ZAMBA_KW)))
    return (JRWKVLM(dataclasses.replace(J_RWKV, dtype=jdt, **RWKV_KW)),
            RWKVLM(dataclasses.replace(get_arch("rwkv6-1.6b").model().cfg,
                                       dtype=tdt, **RWKV_KW)))


def _pair(model: str, name: str = "f32", seed: int = 0):
    """(JAX model, JAX params, port model, the same params), every leaf
    moved off its init by a seeded 0.1·N(0, 1) (RWKV's zero bonus
    ``u`` included)."""
    jm, tm = _models(model, name)
    rng = np.random.RandomState(seed)
    jp = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.randn(*a.shape)).astype(
            np.float32), jm.init(jax.random.PRNGKey(seed)))
    return (jm, jax.tree_util.tree_map(jnp.asarray, jp), tm,
            params_from_numpy(jp, "cpu"))


def _workload(seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, V, size=p).astype(np.int32), b)
            for p, b in WORKLOAD]


def _cfg(**kw):
    return EngineConfig(device="cpu", **kw)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _serve(engine, workload):
    for p, b in workload:
        engine.add_request(p, b)
    return {r.uid: r.generated for r in engine.run()}


MODELS = ["rwkv6", "zamba2"]


# ---------------------------------------------------------- slot cache

@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_a_prefill_overwrites_its_slots_whole_state(model, quant):
    """Every cache leaf has batch at axis 1, so ``SlotKVCache`` carries the
    recurrent states unchanged; a prefill's scatter overwrites the slot's
    whole recurrent state (a previous tenant's leaves nothing behind),
    and no other slot. Under int8 every leaf is quantized over its last
    axis."""
    jm, jp, tm, tp = _pair(model)
    kv = SlotKVCache(tm, 3, 24, quant=quant, device="cpu")
    leaves = _leaves(kv.data if quant == "none" else kv.codes)
    assert leaves and all(leaf.shape[1] == 3 for leaf in leaves)
    if quant == "int8":
        assert all(s.shape == c.shape[:-1] + (1,) for c, s in
                   zip(leaves, _leaves(kv.scales)))
    # a previous tenant's state in every slot
    for t in _leaves(kv.data if quant == "none" else kv.codes):
        t.fill_(7)
    toks = np.random.RandomState(4).randint(0, V, (1, 16)).astype(np.int32)
    cache = tm.init_cache(1, 16, device="cpu")
    tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache)
    kv.write_prefill(1, cache, 16)
    if quant == "int8":
        want, _ = _quantize_leaves(cache)
        got = kv.codes
    else:
        want, got = cache, kv.data
    for g, w in zip(_leaves(got), _leaves(want)):
        n = w.shape[2] if g.ndim > 2 else None
        np.testing.assert_array_equal(g[:, 1:2, :n].numpy(), w.numpy())
        assert bool((g[:, [0, 2]] == 7).all())


@pytest.mark.parametrize("model", MODELS)
def test_int8_cache_codes_match_the_reference(model):
    """The same float cache quantized by both packages: every leaf's
    codes and scales bitwise."""
    jm, jp, tm, tp = _pair(model)
    toks = np.random.RandomState(5).randint(0, V, (2, 8)).astype(np.int32)
    _, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                    jm.init_cache(2, 8))
    cache = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jcache)
    codes, scales = _quantize_leaves(cache)
    jcodes, jscales = j_quantize_leaves(jcache)
    for got, want in zip(_leaves(codes) + _leaves(scales),
                         jax.tree_util.tree_leaves(jcodes)
                         + jax.tree_util.tree_leaves(jscales)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- engine

def _naive(model, params, prompt, budget, max_seq):
    """One request at a time: the oracle the engine must match."""
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    cache = model.init_cache(1, max_seq, device="cpu")
    tok, cache = prefill(params, {"tokens": torch.from_numpy(prompt[None])},
                         cache)
    out, pos = [int(tok[0])], len(prompt)
    while len(out) < budget:
        tok, cache = decode(params, tok,
                            torch.tensor([pos], dtype=torch.int32), cache)
        out.append(int(tok[0]))
        pos += 1
    return out


@pytest.mark.parametrize("model", MODELS)
def test_engine_matches_sequential_greedy(model):
    """Interleaved continuous batching over 2 slots (each reused by later
    requests) gives exactly each request's tokens served alone."""
    _, _, tm, tp = _pair(model)
    workload = _workload()
    got = _serve(Engine(tm, tp, _cfg(capacity=2, max_seq=24)), workload)
    for uid, (prompt, budget) in enumerate(workload):
        assert got[uid] == _naive(tm, tp, prompt, budget, 24), uid


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_engine_matches_the_jax_engine(model, kv_quant):
    """fp32 models, a float and an int8 KV cache, JAX's engine jitted: the
    same tokens for every request, and the same stats and cache bytes."""
    jm, jp, tm, tp = _pair(model)
    workload = _workload(11)
    jeng = JEngine(jm, jp, JEngineConfig(capacity=2, max_seq=24,
                                         kv_quant=kv_quant))
    teng = Engine(tm, tp, _cfg(capacity=2, max_seq=24, kv_quant=kv_quant))
    assert _serve(teng, workload) == _serve(jeng, workload)
    for field in ("steps", "items", "lane_steps", "pad_lanes", "prefills",
                  "prefill_tokens"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field)
    assert teng.kv.nbytes() == jeng.kv.nbytes()


def test_zamba2_engine_under_int8_compute_matches_the_jax_engine(
        monkeypatch):
    """``ExecPolicy(quant="int8")``: the shared block's MLP through the
    plain ``qmatmul`` (3 calls at each of its 2 calls a pass) and the
    cache in int8, in both packages: the same tokens."""
    jm, jp, tm, tp = _pair("zamba2", seed=1)
    calls = []
    plain = qm_ref.qmatmul_ref

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return plain(*a, **kw)

    monkeypatch.setattr(qm_ref, "qmatmul_ref", counted)
    workload = _workload(12)
    jeng = JEngine(jm, jp, JEngineConfig(capacity=2, max_seq=24,
                                         policy=JPolicy(quant="int8")))
    teng = Engine(tm, tp, _cfg(capacity=2, max_seq=24,
                               policy=ExecPolicy(quant="int8")))
    assert teng.config.cache_quant == "int8" == jeng.config.cache_quant
    assert _serve(teng, workload) == _serve(jeng, workload)
    s = teng.stats
    steps = s.prefills + s.decode_lane_steps // 2
    assert len(calls) == 3 * tm.cfg.n_groups * steps


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_bf16_engine_matches_the_jax_engine_op_by_op(model, kv_quant,
                                                     monkeypatch):
    """bf16 models with a bf16 and an int8 KV cache: the same tokens as
    JAX's engine run op by op (see the module's docstring)."""
    jm, jp, tm, tp = _pair(model, "bf16", seed=2)
    monkeypatch.setitem(jc.ACTIVATIONS, "gelu", _PORT_ROUNDING["gelu"])
    monkeypatch.setattr(j_cache, "quantize_int8", _compiled_quantize_int8)
    workload = _workload(13)
    teng = Engine(tm, tp, _cfg(capacity=2, max_seq=24, kv_quant=kv_quant))
    got = _serve(teng, workload)
    with jax.disable_jit():
        want = _serve(JEngine(jm, jp, JEngineConfig(
            capacity=2, max_seq=24, kv_quant=kv_quant)), workload)
    assert got == want
    assert all(len(got[u]) == b for u, (_, b) in enumerate(WORKLOAD))


@pytest.mark.parametrize("model", MODELS)
def test_slot_reuse_does_not_leak(model):
    """A request prefilled into a slot another request used (its states
    still resident until the scatter) decodes as in a fresh engine."""
    _, _, tm, tp = _pair(model)
    rng = np.random.RandomState(9)
    a, b = (rng.randint(0, V, size=16).astype(np.int32) for _ in range(2))
    want = _serve(Engine(tm, tp, _cfg(capacity=1, max_seq=24)),
                  [(b, 6)])[0]
    got = _serve(Engine(tm, tp, _cfg(capacity=1, max_seq=24)),
                 [(a, 8), (b, 6)])
    assert got[1] == want


@pytest.mark.parametrize("model", MODELS)
def test_a_ragged_prompt_raises_through_the_engine(model):
    """A 9-token prompt (chunk 8) raises in both packages' engines."""
    jm, jp, tm, tp = _pair(model)
    ragged = np.arange(9, dtype=np.int32)
    teng = Engine(tm, tp, _cfg(capacity=1, max_seq=24))
    teng.add_request(ragged, 2)
    with pytest.raises(ValueError, match="chunks of 8"):
        teng.run()
    jeng = JEngine(jm, jp, JEngineConfig(capacity=1, max_seq=24))
    jeng.add_request(ragged, 2)
    with pytest.raises(AssertionError):
        jeng.run()


# ------------------------------------------------------------ launcher

@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_launcher_refuses_reduced_as_the_reference(arch, monkeypatch):
    """``reduced_config`` raises SystemExit for these configs in both
    packages, so neither arch has a ``--reduced``."""
    with pytest.raises(SystemExit):
        launcher.main(["--arch", arch, "--reduced", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--reduced"])
    with pytest.raises(SystemExit):
        j_launcher.main()


@pytest.mark.parametrize("model,arch", [("zamba2", "zamba2-7b"),
                                        ("rwkv6", "rwkv6-1.6b")])
def test_launcher_serves_the_small_models_as_the_reference(
        model, arch, monkeypatch, capsys):
    """The launcher's LM path on the small model of ``arch`` in both
    packages (``get_arch`` patched to it), prompts of 16 and 8 tokens:
    every request served and the reference's report lines, with its
    counts."""
    jm, tm = _models(model, "bf16")
    jspec = dataclasses.replace(j_registry.get_arch(arch),
                                arch_id=f"{arch}-small", build=lambda: jm)
    tspec = dataclasses.replace(get_arch(arch), build=lambda: tm)
    monkeypatch.setattr(j_registry, "get_arch", lambda a: jspec)
    monkeypatch.setattr(t_configs, "get_arch", lambda a: tspec)
    argv = ["--arch", arch, "--capacity", "2", "--requests", "4",
            "--prompt-len", "16", "--decode-steps", "6"]
    engine, results = launcher.main(argv + ["--device", "cpu"])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_launcher.main()
    ref = capsys.readouterr().out
    assert len(results) == 4 and all(len(r.generated) == 6
                                      for r in results.values())
    heads = lambda out: [ln.split(" ")[0] for ln in out.splitlines()]  # noqa
    assert heads(mine) == heads(ref)
    for a, b in zip(mine.splitlines(), ref.splitlines()):
        if a.startswith(("arch=", "engine steps", "tokens:")):
            assert a.split(" (")[0] == b.split(" (")[0], (a, b)
    assert engine.model is tm and engine.device.type == "cpu"
