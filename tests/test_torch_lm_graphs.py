"""The compiled LM and train steps (``serve/graphs.py``) on the CPU: the
static-buffer ``Engine`` and train step against the JAX package and
against the eager steps, the serving weights cast once, and three
planted faults.

On the CPU a ``StepGraph`` calls its step on the same static buffers a
CUDA graph replays on the card, so these tests hold the buffer logic:
the decode state written into the slot cache's own leaves, a prefill
from a zeroed batch-1 cache scattered into its slot, the prefill graphs'
LRU, the train step writing params and optimizer state in place.

Tolerances: tokens, the cast-once logits and the static-buffer train
step against the eager one are held exactly (the same ops on the same
values). Against JAX, as ``test_torch_lm_serve.py``,
``test_torch_ssm_serve.py`` and ``test_torch_train.py`` hold the eager
stack: engine tokens equal, the JAX engine jitted for the fp32 model,
run op by op for the bf16 ones (jit rewrites bf16 chains, which flips a
near-tied token of the reduced MoE under an int8 cache in the port's
eager engine before this one too); a train step within 1e-5 of 1 +
max|want| (fp32).

Planted faults, each of which must fail: the MoE router cast once (its
fp32 read rounds, and the logits move), a decode step that rebinds the
slot cache's leaves instead of copying into them (the static buffers go
stale), and an evicted prefill graph called again instead of captured
again.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _PORT_ROUNDING, _compiled_quantize_int8

import repro.serve.cache as j_cache
import repro_torch.serve.engine as engine_mod
from repro.configs.registry import get_arch as j_get_arch
from repro.configs.rwkv6_16b import CONFIG as J_RWKV
from repro.configs.zamba2_7b import CONFIG as J_ZAMBA
from repro.launch.train import reduced_config as j_reduced_config
from repro.models import common as jc
from repro.models.cnn import PaperCNN as JPaperCNN
from repro.models.cnn import PaperCNNConfig as JPaperCNNConfig
from repro.models.hybrid import HybridLM as JHybridLM
from repro.models.rwkv_lm import RWKVLM as JRWKVLM
from repro.models.transformer import LMConfig as JLMConfig
from repro.models.transformer import TransformerLM as JTransformerLM
from repro.ops import ExecPolicy as JPolicy
from repro.optim import adamw as j_adamw
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.data.pipeline import SyntheticMNIST
from repro_torch.launch.train import reduced_config
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.rwkv_lm import RWKVLM
from repro_torch.models.transformer import LMConfig, TransformerLM
from repro_torch.ops import ExecPolicy, use_policy
from repro_torch.optim import adamw as t_adamw
from repro_torch.serve import Engine, EngineConfig, SlotKVCache
from repro_torch.serve.graphs import (StepGraph, copy_tree, train_graph,
                                      tree_tensors)
from repro_torch.serve.weights import (SERVE_CAST, cast_serving_params,
                                       model_family)
from repro_torch.train import make_train_step

TOL_FP32 = 1e-5
SSM_KW = {"zamba2": dict(n_layers=5, d_model=32, n_heads=4, n_kv_heads=4,
                         d_ff=48, vocab=64, d_state=8, shared_interval=2,
                         mamba_chunk=8, remat="none"),
          "rwkv6": dict(n_layers=2, d_model=32, d_ff=48, vocab=64,
                        head_dim=8, chunk=8, remat="none")}
DENSE_KW = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=64, qkv_bias=True, remat="none")


def _bridge(jm, seed: int, jitter: bool = True):
    """JAX params from ``seed`` (each leaf moved off its init by a
    seeded 0.1·N(0, 1), so no zero init hides a fault) and the same
    values as the port's CPU tree."""
    rng = np.random.RandomState(seed)
    jp = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + (0.1 * rng.randn(*a.shape) if jitter
                                    else 0)).astype(np.float32),
        jm.init(jax.random.PRNGKey(seed)))
    return (jax.tree_util.tree_map(jnp.asarray, jp),
            params_from_numpy(jp, "cpu"))


def _pair(family: str, dtype: str = "f32"):
    """(JAX model, JAX params, port model, port params) of a small model
    of ``family``: the dense transformer (fp32: 2 layers, d_model 32;
    bf16: qwen1.5-0.5b reduced as the launchers reduce it), dbrx-132b
    reduced (bf16 MoE, top-2 of 4), zamba2 (5 layers) and rwkv6 (2
    layers) at d_model 32."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    if family == "dense" and dtype == "f32":
        jm = JTransformerLM(JLMConfig(**DENSE_KW, dtype=jdt))
        tm = TransformerLM(LMConfig(**DENSE_KW, dtype=tdt))
    elif family in ("dense", "moe"):
        arch = "qwen1.5-0.5b" if family == "dense" else "dbrx-132b"
        jm = j_reduced_config(j_get_arch(arch).model())
        tm = reduced_config(get_arch(arch).model())
    elif family == "zamba2":
        jm = JHybridLM(dataclasses.replace(J_ZAMBA, dtype=jdt,
                                           **SSM_KW[family]))
        tm = HybridLM(dataclasses.replace(
            get_arch("zamba2-7b").model().cfg, dtype=tdt, **SSM_KW[family]))
    else:
        jm = JRWKVLM(dataclasses.replace(J_RWKV, dtype=jdt,
                                         **SSM_KW[family]))
        tm = RWKVLM(dataclasses.replace(
            get_arch("rwkv6-1.6b").model().cfg, dtype=tdt,
            **SSM_KW[family]))
    jp, tp = _bridge(jm, 0, jitter=family in ("zamba2", "rwkv6"))
    return jm, jp, tm, tp


def _workload(vocab: int, lengths, seed: int = 3, budget: int = 5):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=p).astype(np.int32),
             budget - i % 3) for i, p in enumerate(lengths)]


def _serve(engine, workload):
    for p, b in workload:
        engine.add_request(p, b)
    return {r.uid: r.generated for r in engine.run()}


def _assert_compiled(engine):
    """Every prefill and decode step went through the engine's step
    graphs: a prefill graph's calls sum to the prefills, the decode
    graph's to the decode steps, each length built once more than it was
    evicted, and no more prefill graphs held than the cap."""
    graphs = engine.graphs()
    prefills = sum(g.calls for g in graphs
                   if g is not engine._decode_graph)
    steps = engine.stats.decode_lane_steps // engine.config.capacity
    assert prefills == engine.stats.prefills
    assert engine._decode_graph.calls == steps
    assert len(engine._prefill_graphs) <= engine_mod.MAX_PREFILL_GRAPHS
    built = sum(engine.captures.values())
    assert built == len(engine.evicted) + len(engine._prefill_graphs)
    assert all(g.released for g in engine.evicted)


# ------------------------------------------- engine tokens against JAX

@pytest.mark.parametrize("mode", ["bf16_kv", "int8_kv", "int8"])
def test_dense_engine_matches_the_jax_engine(mode, monkeypatch):
    """qwen1.5-0.5b reduced (bf16, 2 layers, d_model 64) through the
    static-buffer engine and JAX's run op by op, with a bf16 KV cache, an
    int8 one, and under int8 compute (the MLP through the plain qmatmul):
    the same tokens. Seven requests over capacity 2 (admissions mid-run),
    three prompt lengths over a cap of 2 prefill graphs (evictions)."""
    monkeypatch.setattr(engine_mod, "MAX_PREFILL_GRAPHS", 2)
    monkeypatch.setitem(jc.ACTIVATIONS, "silu", _PORT_ROUNDING["silu"])
    monkeypatch.setattr(j_cache, "quantize_int8", _compiled_quantize_int8)
    jm, jp, tm, tp = _pair("dense", "bf16")
    kv = "int8" if mode == "int8_kv" else None
    quant = "int8" if mode == "int8" else "none"
    workload = _workload(tm.cfg.vocab, (8, 12, 16, 8, 12, 16, 8))
    teng = Engine(tm, tp, EngineConfig(
        capacity=2, max_seq=24, kv_quant=kv, device="cpu",
        policy=ExecPolicy(quant=quant)))
    jeng = JEngine(jm, jp, JEngineConfig(capacity=2, max_seq=24,
                                         kv_quant=kv,
                                         policy=JPolicy(quant=quant)))
    got = _serve(teng, workload)
    with jax.disable_jit():
        want = _serve(jeng, workload)
    assert got == want and len(got) == 7
    assert teng.stats.steps == jeng.stats.steps
    _assert_compiled(teng)
    assert set(teng.captures) == {8, 12, 16} and teng.evicted


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_fp32_dense_engine_matches_the_jitted_jax_engine(kv_quant,
                                                         monkeypatch):
    """The fp32 dense model (2 layers, d_model 32) against JAX's engine
    jitted, as it serves: the same tokens, every step through a graph."""
    monkeypatch.setattr(engine_mod, "MAX_PREFILL_GRAPHS", 1)
    jm, jp, tm, tp = _pair("dense")
    workload = _workload(64, (4, 7, 4, 6, 7))
    teng = Engine(tm, tp, EngineConfig(capacity=2, max_seq=24,
                                       kv_quant=kv_quant, device="cpu"))
    jeng = JEngine(jm, jp, JEngineConfig(capacity=2, max_seq=24,
                                         kv_quant=kv_quant))
    assert _serve(teng, workload) == _serve(jeng, workload)
    _assert_compiled(teng)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_moe_engine_matches_the_jax_engine(kv_quant, monkeypatch):
    """dbrx-132b reduced (bf16, top-2 of 4 experts) against JAX's engine
    run op by op: the same tokens; the router stays fp32 in the
    engine."""
    monkeypatch.setitem(jc.ACTIVATIONS, "silu", _PORT_ROUNDING["silu"])
    monkeypatch.setattr(j_cache, "quantize_int8", _compiled_quantize_int8)
    jm, jp, tm, tp = _pair("moe", "bf16")
    workload = _workload(tm.cfg.vocab, (4, 7, 4, 6, 7))
    teng = Engine(tm, tp, EngineConfig(capacity=2, max_seq=24,
                                       kv_quant=kv_quant, device="cpu"))
    jeng = JEngine(jm, jp, JEngineConfig(capacity=2, max_seq=24,
                                         kv_quant=kv_quant))
    got = _serve(teng, workload)
    with jax.disable_jit():
        want = _serve(jeng, workload)
    assert got == want
    _assert_compiled(teng)
    layers = teng.params["layers"]
    assert layers["moe"]["router"].dtype == torch.float32
    assert layers["moe"]["wi"].dtype == torch.bfloat16


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("family", ["zamba2", "rwkv6"])
def test_ssm_engine_matches_the_jax_engine(family, kv_quant, monkeypatch):
    """zamba2 and rwkv6 in bf16, their recurrent state returned by the
    blocks and copied into the slot cache's leaves, against JAX's engine
    run op by op: the same tokens, over 2 prefill graphs at most."""
    monkeypatch.setattr(engine_mod, "MAX_PREFILL_GRAPHS", 1)
    monkeypatch.setitem(jc.ACTIVATIONS, "gelu", _PORT_ROUNDING["gelu"])
    monkeypatch.setattr(j_cache, "quantize_int8", _compiled_quantize_int8)
    jm, jp, tm, tp = _pair(family, "bf16")
    workload = _workload(64, (8, 16, 8, 16, 8))
    teng = Engine(tm, tp, EngineConfig(capacity=2, max_seq=24,
                                       kv_quant=kv_quant, device="cpu"))
    jeng = JEngine(jm, jp, JEngineConfig(capacity=2, max_seq=24,
                                         kv_quant=kv_quant))
    got = _serve(teng, workload)
    with jax.disable_jit():
        want = _serve(jeng, workload)
    assert got == want
    _assert_compiled(teng)


def test_engine_graphs_off_is_the_same_engine():
    """``graphs=False`` runs the same steps on the same buffers: on the
    CPU both settings are one path, and give the same tokens."""
    _, _, tm, tp = _pair("dense")
    workload = _workload(64, (4, 7, 5))
    out = [_serve(Engine(tm, tp, EngineConfig(capacity=2, max_seq=16,
                                              device="cpu", graphs=g)),
                  workload) for g in (True, False)]
    assert out[0] == out[1]


# ------------------------------------------------------- cast once

def _logits(model, params, policy=ExecPolicy()):
    """A 8-token prefill's logits and the next decode step's, batch 2."""
    rng = np.random.RandomState(4)
    toks = torch.from_numpy(rng.randint(0, model.cfg.vocab, (2, 8))
                            .astype(np.int32))
    cache = model.init_cache(2, 16, device="cpu")
    with use_policy(policy), torch.no_grad():
        pre, cache = model.prefill(params, {"tokens": toks}, cache)
        dec, _ = model.decode_step(params, pre.argmax(-1).to(torch.int32),
                                   torch.tensor([8, 8], dtype=torch.int32),
                                   cache)
    return pre, dec


CAST_CASES = {"dense": ("dense", "bf16", "none"),
              "dense-int8": ("dense", "bf16", "int8"),
              "moe": ("moe", "bf16", "none"),
              "hybrid": ("zamba2", "bf16", "none"),
              "rwkv": ("rwkv6", "bf16", "none")}


@pytest.mark.parametrize("case", sorted(CAST_CASES))
def test_weights_cast_once_are_bitwise(case):
    """Per family, a prefill's and a decode step's logits with the
    serving cast set cast once equal those of the fp32 weights cast at
    each read (bf16 models; ``dense-int8`` under int8 compute): the
    cast is exact. Every path of the family's set names a leaf of some
    arch of the family, and every cast leaf is the compute dtype."""
    family, dtype, quant = CAST_CASES[case]
    _, _, tm, tp = _pair(family, dtype)
    fam = model_family(tm)
    assert fam == case.split("-")[0]
    cast = cast_serving_params(tm, tp, "cpu")
    pol = ExecPolicy(quant=quant)
    for got, want in zip(_logits(tm, cast, pol), _logits(tm, tp, pol)):
        assert torch.equal(got, want)
    assert SERVE_CAST[fam] & {p for p, _ in tree_items(tp)}
    for path, leaf in tree_items(cast):
        want = tm.cfg.dtype if path in SERVE_CAST[fam] else torch.float32
        assert leaf.dtype == want, path


def test_every_cast_path_names_a_leaf_of_its_family():
    """No stale path: each entry of SERVE_CAST is a leaf of one of the
    family's archs (meta-device params: nothing drawn)."""
    archs = {"dense": ["qwen1.5-0.5b", "gemma2-2b", "command-r-35b",
                       "qwen3-14b", "internvl2-26b"],
             "moe": ["dbrx-132b", "llama4-scout-17b-a16e"],
             "hybrid": ["zamba2-7b"], "rwkv": ["rwkv6-1.6b"]}
    seen = {}
    for fam, ids in archs.items():
        seen[fam] = set()
        for arch in ids:
            m = get_arch(arch).model()
            assert model_family(m) == fam
            seen[fam] |= {p for p, _ in tree_items(
                m.init(torch.Generator(), device="meta"))}
    # attention is one module: the MoE archs have no QKV bias, qwen1.5 has
    seen["moe"] |= {p for p in seen["dense"] if p[:2] == ("layers", "attn")}
    for fam, paths in SERVE_CAST.items():
        assert paths <= seen[fam], paths - seen[fam]


def test_donated_params_are_emptied_and_cast():
    """``donate=True``: the engine takes the tree over, the caller's dict
    is emptied, and the engine's weights are the cast ones."""
    _, _, tm, tp = _pair("dense", "bf16")
    mine = dict(tp)
    eng = Engine(tm, mine, EngineConfig(capacity=1, max_seq=8,
                                        device="cpu"), donate=True)
    assert mine == {}
    assert eng.params["layers"]["mlp"]["wi"].dtype == torch.bfloat16
    assert eng.params["layers"]["ln1"].dtype == torch.float32


def test_planted_router_cast_once_moves_the_logits(monkeypatch):
    """Planted: the MoE router joins the cast set. Routing reads it in
    fp32, so the cast rounds it, and the logits move."""
    _, _, tm, tp = _pair("moe", "bf16")
    monkeypatch.setitem(SERVE_CAST, "moe",
                        SERVE_CAST["moe"] | {("layers", "moe", "router")})
    bad = cast_serving_params(tm, tp, "cpu")
    assert bad["layers"]["moe"]["router"].dtype == torch.bfloat16
    got, want = _logits(tm, bad), _logits(tm, tp)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------- state in place

def _rebinding_set_device_state(self, *state):
    """The fault: rebind the cache's leaves to a step's new ones."""
    if self.quant == "int8":
        self.codes, self.scales = state
    else:
        (self.data,) = state


@pytest.mark.parametrize("planted", [False, True])
def test_decode_state_is_copied_into_the_static_leaves(planted,
                                                       monkeypatch):
    """Under an int8 cache every decode step returns new codes and
    scales. Copied into the slot cache's leaves, the next step reads
    them: tokens equal JAX's. Planted: rebound instead, the decode
    graph's static leaves go stale (and the prefills scatter into leaves
    it never reads): the tokens differ."""
    if planted:
        monkeypatch.setattr(SlotKVCache, "set_device_state",
                            _rebinding_set_device_state)
    jm, jp, tm, tp = _pair("dense")
    workload = _workload(64, (4, 7, 4, 6, 7), budget=6)
    teng = Engine(tm, tp, EngineConfig(capacity=2, max_seq=24,
                                       kv_quant="int8", device="cpu"))
    jeng = JEngine(jm, jp, JEngineConfig(capacity=2, max_seq=24,
                                         kv_quant="int8"))
    static = tree_tensors(teng._decode_graph.inputs["state"])
    got, want = _serve(teng, workload), _serve(jeng, workload)
    still = tree_tensors(teng.kv.device_state())
    assert (got == want) != planted
    assert all(a is b for a, b in zip(static, still)) != planted


def _keep_evicted(self, length):
    """The fault: on eviction the least recently used prefill graph is
    released but stays under its length, so that length coming back
    calls it again instead of building a new one."""
    graph = self._prefill_graphs.get(length)
    if graph is None:
        live = [g for g in self._prefill_graphs.values() if not g.released]
        if len(live) >= engine_mod.MAX_PREFILL_GRAPHS:
            live[0].release()
        graph = self._prefill_graphs[length] = self._new_prefill(length)
    return graph


@pytest.mark.parametrize("planted", [False, True])
def test_an_evicted_prefill_length_is_built_again(planted, monkeypatch):
    """A third prompt length over a cap of 2 evicts the least recently
    used graph; its length coming back builds (on the card: captures) a
    new one. Planted: the evicted graph stays under its length and is
    called again: the engine raises rather than replay a released
    graph."""
    monkeypatch.setattr(engine_mod, "MAX_PREFILL_GRAPHS", 2)
    if planted:
        monkeypatch.setattr(Engine, "_prefill_graph", _keep_evicted)
    _, _, tm, tp = _pair("dense")
    eng = Engine(tm, tp, EngineConfig(capacity=1, max_seq=16,
                                      device="cpu"))
    workload = _workload(64, (4, 5, 6, 4))
    if planted:
        with pytest.raises(RuntimeError, match="release"):
            _serve(eng, workload)
        return
    solo = Engine(tm, tp, EngineConfig(capacity=1, max_seq=16,
                                       device="cpu"))
    assert _serve(eng, workload) == _serve(solo, workload[:3] +
                                           workload[3:])
    assert eng.captures == {4: 2, 5: 1, 6: 1}
    _assert_compiled(eng)


def test_step_graph_copies_inputs_and_refuses_unknown_ones():
    """A call copies its keyword arguments into the static buffers (the
    same tensor is left alone); an unknown name, a shape the buffer
    cannot take, or a call after release raises."""
    buf = torch.zeros(3)
    g = StepGraph(lambda x: x * 2, {"x": buf}, device="cpu")
    assert torch.equal(g(x=torch.tensor([1.0, 2.0, 3.0])),
                       torch.tensor([2.0, 4.0, 6.0]))
    assert torch.equal(buf, torch.tensor([1.0, 2.0, 3.0]))
    assert g(x=buf) is not None and g.calls == 2 and not g.captured
    with pytest.raises(TypeError, match="y"):
        g(y=buf)
    with pytest.raises(ValueError, match="shape"):
        g(x=torch.zeros(4))
    g.release()
    with pytest.raises(RuntimeError, match="release"):
        g()
    with pytest.raises(ValueError, match="keys"):
        copy_tree({"a": buf}, {"b": buf})


# ------------------------------------------------------- train step

def _jax_step(jm, jp, batches, kw):
    step = jax.jit(j_make_train_step(jm, j_adamw.AdamWConfig(**kw)))
    params, opt = jp, j_adamw.adamw_init(jp)
    losses = []
    for b in batches:
        params, opt, m = step(params, opt,
                              {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return params, losses


def _train_case(case):
    """(JAX model, port model, JAX params, port params, 3 batches)."""
    if case == "cnn":
        jm, tm = JPaperCNN(JPaperCNNConfig()), PaperCNN(PaperCNNConfig())
        data = SyntheticMNIST(seed=0)
        batches = [{k: v.numpy() for k, v in data.batch(8, step=i).items()}
                   for i in range(3)]
    else:
        jm = JTransformerLM(JLMConfig(**DENSE_KW, dtype=jnp.float32))
        tm = TransformerLM(LMConfig(**DENSE_KW, dtype=torch.float32))
        rng = np.random.RandomState(5)
        batches = [{k: rng.randint(0, 64, (2, 16)).astype(np.int32)
                    for k in ("tokens", "labels")} for _ in range(3)]
    jp, tp = _bridge(jm, 1)
    return jm, tm, jp, tp, batches


TRAIN_KW = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-3)


@pytest.mark.parametrize("case", ["cnn", "lm"])
def test_static_train_step_is_bitwise_to_eager_and_matches_jax(case):
    """Three steps through ``train_graph`` (params and optimizer state
    written in place) against the eager functional step: losses and
    every param, moment and the step counter bitwise; and against JAX's
    jitted step within TOL_FP32 (eps 1e-3, as ``test_torch_train.py``
    holds the eager step, for the reason it gives). The CNN's convs run
    ``ConvWindowFn``'s plain route on the CPU."""
    jm, tm, jp, tp, batches = _train_case(case)
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    step = make_train_step(tm, t_adamw.AdamWConfig(**TRAIN_KW))
    params = tree_map(torch.clone, tp)
    opt = t_adamw.adamw_init(params)
    eager_p = tree_map(torch.clone, tp)
    eager_o = t_adamw.adamw_init(eager_p)
    graph = train_graph(step, params, opt, tb[0], device="cpu")
    static = tree_tensors((params, opt))
    for b in tb:
        got = graph(batch=b)
        eager_p, eager_o, want = step(eager_p, eager_o, b)
        assert torch.equal(got["loss"], want["loss"])
    assert all(torch.equal(a, b) for a, b in zip(
        tree_tensors((params, opt)), tree_tensors((eager_p, eager_o))))
    assert all(a is b for a, b in zip(static, tree_tensors((params, opt))))
    jparams, _ = _jax_step(jm, jp, batches, TRAIN_KW)
    for path, p in tree_items(params):
        w = np.asarray(_jpath(jparams, path), np.float32)
        tol = TOL_FP32 * (1 + float(np.abs(w).max()))
        assert np.abs(p.numpy() - w).max() <= tol, path
    assert graph.calls == 3 and not graph.captured


def _jpath(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_resume_into_static_buffers_is_bitwise():
    """Three steps uninterrupted against one step, its params and
    optimizer state saved (cloned, as a checkpoint's restore gives new
    trees) and a new train graph built on the restored trees for the
    other two: the same losses and final params, bitwise."""
    _, tm, _, tp, batches = _train_case("lm")
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    step = make_train_step(tm, t_adamw.AdamWConfig(**TRAIN_KW))

    def fresh():
        p = tree_map(torch.clone, tp)
        return p, t_adamw.adamw_init(p)

    p, o = fresh()
    whole = train_graph(step, p, o, tb[0], device="cpu")
    want = [float(whole(batch=b)["loss"]) for b in tb]
    p2, o2 = fresh()
    first = train_graph(step, p2, o2, tb[0], device="cpu")
    got = [float(first(batch=tb[0])["loss"])]
    saved_p, saved_o = tree_map(torch.clone, p2), tree_map(torch.clone, o2)
    resumed = train_graph(step, saved_p, saved_o, tb[1], device="cpu")
    got += [float(resumed(batch=b)["loss"]) for b in tb[1:]]
    assert got == want
    assert all(torch.equal(a, b) for a, b in
               zip(tree_tensors((saved_p, saved_o)), tree_tensors((p, o))))
