"""The port's LM serving stack against the JAX package on the CPU: the
request queue, the slot scheduler, the slot KV cache, the
continuous-batching ``Engine`` (alone, against its naive one-request
loop, against the JAX ``Engine``, and behind ``Frontend`` via
``LMAdapter``), the launcher's LM branch, and the import boundary.

The cases mirror ``tests/test_serve_engine.py`` on the port. Models are
fp32, 2 layers, d_model 32, vocab 64 (as the reference's engine tests),
where greedy tokens are a safe parity target: the same requests on the
same params give the same tokens in both packages. The JAX engine runs
jitted, as it serves. Tokens are held exactly; the int8 KV cache's
codes are held bitwise on the same float inputs.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as j_launcher
from repro.models.transformer import LMConfig as JLMConfig
from repro.models.transformer import TransformerLM as JTransformerLM
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve.cache import _quantize_leaves as j_quantize_leaves
from repro.serve.cache import dequantize_leaves as j_dequantize_leaves
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models.transformer import LMConfig, TransformerLM
from repro_torch.ops import ExecPolicy
from repro_torch.serve import (Engine, EngineConfig, EngineStats, Frontend,
                               FrontendConfig, LMAdapter, QueueFullError,
                               Request, RequestQueue, RequestState,
                               Scheduler, SlotKVCache, VirtualClock,
                               make_decode_step, make_prefill_step)
from repro_torch.serve.cache import _quantize_leaves, dequantize_leaves

ROOT = Path(__file__).resolve().parents[1]
V = 64
KW = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
          d_ff=64, vocab=V)


def _model():
    return TransformerLM(LMConfig(**KW, dtype=torch.float32, remat="none"))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, the same params on the CPU)."""
    jm = JTransformerLM(JLMConfig(**KW, dtype=jnp.float32, remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, _model(), tp


def _req(uid=0, plen=4, budget=4):
    rng = np.random.RandomState(uid)
    return Request(uid=uid, prompt=rng.randint(0, V, size=plen),
                   max_new_tokens=budget)


def _cfg(**kw):
    return EngineConfig(device="cpu", **kw)


def _reference_generate(model, params, prompt, budget, max_seq):
    """The naive one-request-at-a-time greedy loop: the oracle the
    engine must match token for token."""
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    cache = model.init_cache(1, max_seq, device="cpu")
    tok, cache = prefill(params, {"tokens": torch.from_numpy(prompt[None])},
                         cache)
    out = [int(tok[0])]
    pos = len(prompt)
    while len(out) < budget:
        tok, cache = decode(params, tok, torch.tensor(pos, dtype=torch.int32),
                            cache)
        out.append(int(tok[0]))
        pos += 1
    return out


WORKLOAD = [(4, 5), (7, 3), (4, 6), (6, 4), (7, 5)]


def _workload(seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, V, size=p).astype(np.int32), b)
            for p, b in WORKLOAD]


# ----------------------------------------------------- queue, scheduler

def test_queue_is_fifo_and_validates():
    q = RequestQueue([_req(i) for i in range(3)])
    assert [q.pop().uid for _ in range(3)] == [0, 1, 2]
    r = _req()
    r.state = RequestState.RUNNING
    with pytest.raises(ValueError):
        RequestQueue().add(r)
    with pytest.raises(ValueError):
        Request(uid=0, prompt=np.zeros((0,), np.int32), max_new_tokens=1)
    with pytest.raises(ValueError):
        Request(uid=0, prompt=np.zeros((3,), np.int32), max_new_tokens=0)
    full = RequestQueue([_req(0)], maxlen=1)
    with pytest.raises(QueueFullError):
        full.add(_req(1))
    assert len(full) == 1 and full.peek().uid == 0


def test_scheduler_admits_evicts_and_reuses_slots_lifo():
    s = Scheduler(2)
    q = RequestQueue([_req(i) for i in range(5)])
    admitted = s.admit(q)
    assert len(admitted) == 2 and s.free_slots == 0 and len(q) == 3
    assert {r.slot for r in admitted} == {0, 1}
    assert all(r.state is RequestState.RUNNING for r in admitted)
    victim = s.request_in(1)
    evicted = s.evict(1)
    assert evicted is victim and evicted.slot is None
    assert evicted.state is RequestState.FINISHED and s.free_slots == 1
    (refill,) = s.admit(q)
    assert refill.slot == 1 and s.num_running == 2
    s3 = Scheduler(3)
    s3.admit(RequestQueue([_req(i) for i in range(3)]))
    s3.evict(0)
    s3.evict(2)
    (r,) = s3.admit(RequestQueue([_req(10)]))
    assert r.slot == 2                       # most recently freed first
    s3.tick()
    s3.tick()
    assert s3.stats.mean_occupancy() == 2.0


def test_overlong_prompt_rejected_not_lost():
    s = Scheduler(1)
    q = RequestQueue([_req(0, plen=100), _req(1, plen=4)])
    admitted = s.admit(q, max_prompt_len=16)
    assert [r.uid for r in admitted] == [1]
    assert s.stats.truncated == 1
    (rej,) = s.drain_rejected()
    assert rej.uid == 0 and rej.truncated
    assert rej.state is RequestState.FINISHED
    assert s.drain_rejected() == []


# ---------------------------------------------------------- slot cache

def test_int8_cache_leaves_match_the_reference(pair):
    """Quantize and dequantize a cache tree: codes and scales bitwise to
    the reference's on the same fp32 values, and the dequantized cache
    in bf16 bitwise too (the round trip's order is the reference's)."""
    rng = np.random.RandomState(1)
    k = rng.randn(2, 3, 5, 2, 8).astype(np.float32)
    tree = {"k": torch.from_numpy(k), "v": torch.from_numpy(-k)}
    codes, scales = _quantize_leaves(tree)
    jcodes, jscales = j_quantize_leaves({"k": jnp.asarray(k),
                                         "v": jnp.asarray(-k)})
    for name in ("k", "v"):
        np.testing.assert_array_equal(codes[name].numpy(),
                                      np.asarray(jcodes[name]))
        np.testing.assert_array_equal(scales[name].numpy(),
                                      np.asarray(jscales[name]))
    got = dequantize_leaves(codes, scales, torch.bfloat16)["k"]
    want = j_dequantize_leaves(jcodes, jscales, jnp.bfloat16)["k"]
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))
    marker = {"m": torch.ones(3, dtype=torch.int8)}
    c, s = _quantize_leaves(marker)
    assert s["m"].ndim == 0 and dequantize_leaves(c, s, torch.float32)[
        "m"] is c["m"]


def test_slot_cache_writes_a_prefill_into_its_slot():
    model = _model()
    kv = SlotKVCache(model, 3, 8, device="cpu")
    pre = {"k": torch.full((2, 1, 5, 2, 8), 2.0),
           "v": torch.full((2, 1, 5, 2, 8), 3.0)}
    kv.write_prefill(1, pre, 5)
    assert kv.positions().tolist() == [0, 5, 0] and kv.remaining(1) == 3
    assert float(kv.data["k"][:, 1, :5].min()) == 2.0
    assert float(kv.data["k"][:, 1, 5:].abs().max()) == 0.0
    assert float(kv.data["v"][:, [0, 2]].abs().max()) == 0.0
    kv.advance(1)
    kv.free(1)
    assert kv.positions().tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        kv.write_prefill(0, pre, 9)
    with pytest.raises(ValueError):
        SlotKVCache(model, 1, 4, quant="int4", device="cpu")


# -------------------------------------------------------------- engine

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_matches_sequential_greedy(kv_quant):
    """Interleaved continuous batching produces exactly the tokens of the
    naive sequential loop, per request."""
    model = _model()
    params = model.init(0, device="cpu")
    workload = _workload()
    engine = Engine(model, params, _cfg(capacity=2, max_seq=24,
                                        kv_quant=kv_quant))
    uids = [engine.add_request(p, b) for p, b in workload]
    got = {r.uid: r.generated for r in engine.run()}
    assert len(got) == len(workload)
    if kv_quant == "none":
        for uid, (prompt, budget) in zip(uids, workload):
            want = _reference_generate(model, params, prompt, budget, 24)
            assert got[uid] == want, f"request {uid} diverged"
    assert all(len(got[u]) == b for u, (_, b) in zip(uids, workload))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_matches_the_jax_engine(pair, kv_quant):
    """The same requests on the same params through both packages'
    engines: the same tokens for every request, and the same stats."""
    jm, jp, tm, tp = pair
    workload = _workload(11)
    jeng = JEngine(jm, jp, JEngineConfig(capacity=2, max_seq=24,
                                         kv_quant=kv_quant))
    teng = Engine(tm, tp, _cfg(capacity=2, max_seq=24, kv_quant=kv_quant))
    for p, b in workload:
        jeng.add_request(p, b)
        teng.add_request(p, b)
    want = {r.uid: r.generated for r in jeng.run()}
    got = {r.uid: r.generated for r in teng.run()}
    assert got == want
    for field in ("steps", "items", "lane_steps", "pad_lanes", "prefills",
                  "prefill_tokens"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field)
    assert teng.stats.decode_lane_steps == jeng.stats.decode_lane_steps
    assert teng.kv.nbytes() == jeng.kv.nbytes()


def test_engine_under_int8_compute_matches_the_jax_engine(pair):
    """``ExecPolicy(quant="int8")``: every MLP matmul through qmatmul and
    the KV cache in int8 (cache_quant follows the policy), in both
    packages."""
    from repro.ops import ExecPolicy as JPolicy
    jm, jp, tm, tp = pair
    workload = _workload(12)
    jeng = JEngine(jm, jp, JEngineConfig(capacity=2, max_seq=24,
                                         policy=JPolicy(quant="int8")))
    teng = Engine(tm, tp, _cfg(capacity=2, max_seq=24,
                               policy=ExecPolicy(quant="int8")))
    assert teng.config.cache_quant == "int8" == jeng.config.cache_quant
    for p, b in workload:
        jeng.add_request(p, b)
        teng.add_request(p, b)
    want = {r.uid: r.generated for r in jeng.run()}
    assert {r.uid: r.generated for r in teng.run()} == want


def _moe_pair(arch):
    """The reduced ``arch`` (bf16, 2 layers, 4 experts) in both packages,
    the JAX params bridged to the port."""
    from repro.configs.registry import get_arch as j_get_arch
    from repro.launch.train import reduced_config as j_reduced_config
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    jm = j_reduced_config(j_get_arch(arch).model())
    tm = reduced_config(get_arch(arch).model())
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_moe_engine_matches_the_jax_engine(arch, kv_quant):
    """A reduced MoE model in bf16 (dbrx: top-2 of 4 experts with renorm;
    llama4-scout: top-1 plus a shared expert) served by both packages'
    engines, with a bf16 and with an int8 KV cache: the same tokens for
    every request, and the same stats."""
    jm, jp, tm, tp = _moe_pair(arch)
    assert tm.cfg.moe is not None and tm.cfg.dtype == torch.bfloat16
    rng = np.random.RandomState(11)
    workload = [(rng.randint(0, tm.cfg.vocab, size=p).astype(np.int32), b)
                for p, b in WORKLOAD]
    jeng = JEngine(jm, jp, JEngineConfig(capacity=2, max_seq=24,
                                         kv_quant=kv_quant))
    teng = Engine(tm, tp, _cfg(capacity=2, max_seq=24, kv_quant=kv_quant))
    for p, b in workload:
        jeng.add_request(p, b)
        teng.add_request(p, b)
    want = {r.uid: r.generated for r in jeng.run()}
    got = {r.uid: r.generated for r in teng.run()}
    assert got == want and len(got) == len(WORKLOAD)
    for field in ("steps", "prefills", "prefill_tokens"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field)
    assert teng.kv.nbytes() == jeng.kv.nbytes()


def test_slot_reuse_does_not_leak():
    """A request decoded in a reused slot (the previous tenant's K/V
    still resident) matches a fresh single-request engine."""
    model = _model()
    params = model.init(0, device="cpu")
    rng = np.random.RandomState(9)
    a = rng.randint(0, V, size=5)
    b = rng.randint(0, V, size=5)
    solo = Engine(model, params, _cfg(capacity=1, max_seq=16))
    solo.add_request(b, 6)
    want = solo.run()[0].generated
    reused = Engine(model, params, _cfg(capacity=1, max_seq=16))
    reused.add_request(a, 8)
    reused.add_request(b, 6)
    assert {r.uid: r.generated for r in reused.run()}[1] == want


def test_continuous_refill_truncation_eos_and_rejection():
    model = _model()
    params = model.init(0, device="cpu")
    engine = Engine(model, params, _cfg(capacity=2, max_seq=16))
    for i in range(6):
        engine.add_request(np.full((3,), i % V, np.int32), 4)
    finished = engine.run()
    assert len(finished) == 6 and not engine.has_work()
    assert engine.scheduler.stats.admitted == 6
    assert engine.scheduler.stats.finished == 6
    assert all(r.num_generated == 4 for r in finished)
    assert engine.scheduler.stats.mean_occupancy() > 1.0
    # a budget the slot cannot hold finishes early, truncated
    engine = Engine(model, params, _cfg(capacity=1, max_seq=8))
    engine.add_request(np.arange(5, dtype=np.int32), 50)
    (r,) = engine.run()
    assert r.truncated and r.num_generated <= 8 - 5 + 1
    # EOS stops generation at its first occurrence
    probe = Engine(model, params, _cfg(capacity=1, max_seq=24))
    probe.add_request(np.arange(4, dtype=np.int32), 6)
    tokens = probe.run()[0].generated
    eos = tokens[-1]
    engine = Engine(model, params, _cfg(capacity=1, max_seq=24,
                                        eos_token=eos))
    engine.add_request(np.arange(4, dtype=np.int32), 6)
    assert engine.run()[0].generated == tokens[:tokens.index(eos) + 1]
    # a prompt longer than max_seq comes back truncated with no tokens
    engine = Engine(model, params, _cfg(capacity=1, max_seq=8))
    engine.add_request(np.zeros((20,), np.int32), 4)
    engine.add_request(np.zeros((4,), np.int32), 3)
    by_uid = {r.uid: r for r in engine.run()}
    assert set(by_uid) == {0, 1}
    assert by_uid[0].truncated and by_uid[0].num_generated == 0
    assert by_uid[1].num_generated == 3


def test_int8_cache_is_smaller_and_stats_add_up():
    model = _model()
    params = model.init(0, device="cpu")
    native = Engine(model, params, _cfg(capacity=2, max_seq=16))
    quant = Engine(model, params, _cfg(capacity=2, max_seq=16,
                                       kv_quant="int8"))
    assert quant.kv.nbytes() < native.kv.nbytes()
    for eng in (native, quant):
        for p, b in _workload(5)[:3]:
            eng.add_request(p, b)
        eng.run()
        s = eng.stats
        assert isinstance(s, EngineStats)
        assert s.prefills == 3 and s.prefill_tokens == 4 + 7 + 4
        assert s.decode_tokens == (5 - 1) + (3 - 1) + (6 - 1)
        assert s.items == s.prefill_tokens + s.decode_tokens
        assert s.decode_lane_steps == s.lane_steps + s.pad_lanes
        assert 0 < s.decode_utilization <= 1 and s.tokens_per_s > 0
    with pytest.raises(QueueFullError):
        bounded = Engine(model, params, _cfg(capacity=1, max_queue=1))
        bounded.add_request(np.zeros(3, np.int32), 2)
        bounded.add_request(np.zeros(3, np.int32), 2)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(_model(), {}, EngineConfig())


# ----------------------------------------------------------- front-end

def test_lm_adapter_behind_the_frontend():
    """Requests submitted to the front-end come back as the engine's own
    generations, in the front-end's rids, with latency accounted."""
    model = _model()
    params = model.init(0, device="cpu")
    workload = _workload(7)
    direct = Engine(model, params, _cfg(capacity=2, max_seq=24))
    for p, b in workload:
        direct.add_request(p, b)
    want = [r.generated for r in sorted(direct.run(), key=lambda r: r.uid)]
    clock = VirtualClock()
    eng = Engine(model, params, _cfg(capacity=2, max_seq=24), clock=clock)
    adapter = LMAdapter(eng)
    fe = Frontend(adapter, FrontendConfig(max_queue=8, step_cost_s=0.5),
                  clock)
    assert adapter.kind == "lm" and not adapter.forms_buckets
    assert adapter.preferred_batch == 2 and adapter.free_lanes() == 2
    rids = [fe.submit(p, max_new_tokens=b) for p, b in workload]
    results = fe.run_until_drained()
    assert sorted(results) == rids
    assert [results[r].generated for r in rids] == want
    assert fe.stats is eng.stats and eng.stats.completed == len(workload)
    assert all(lat > 0 for lat in eng.stats.latencies)
    assert not adapter.has_inflight()


# ------------------------------------------------------------ launcher

ARGV = ["--arch", "qwen1.5-0.5b", "--reduced", "--capacity", "2",
        "--requests", "4", "--prompt-len", "16", "--decode-steps", "8"]


def _line_heads(text: str) -> list[str]:
    """Each report line up to its first number: what must match."""
    out = []
    for ln in text.strip().splitlines():
        head = ""
        for ch in ln:
            if ch.isdigit():
                break
            head += ch
        out.append(head)
    return out


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_launcher_prints_the_references_report(monkeypatch, capsys,
                                               kv_quant):
    """``--reduced --device cpu`` serves every request and prints the
    reference launcher's report lines, with the same counts (requests,
    engine steps, occupancy, prefill and decode tokens, KV bytes)."""
    argv = ARGV + ["--kv-quant", kv_quant]
    engine, results = launcher.main(argv + ["--device", "cpu"])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_launcher.main()
    ref = capsys.readouterr().out
    assert len(results) == 4 and all(len(r.generated) == 8
                                      for r in results.values())
    assert _line_heads(mine) == _line_heads(ref)
    keep = ("arch=", "engine steps", "tokens:")
    for a, b in zip(mine.splitlines(), ref.splitlines()):
        if a.startswith(keep):
            a, b = a.split(" tok/s")[0], b.split(" tok/s")[0]
            assert a.split(" (")[0] == b.split(" (")[0], (a, b)
    assert "served 4 requests" in mine
    assert engine.model.cfg.d_model == 64 and engine.device.type == "cpu"


@pytest.mark.parametrize("arch", ["dbrx-132b", "gemma2-2b"])
def test_launcher_serves_the_other_archs_reduced(monkeypatch, capsys, arch):
    """``--arch dbrx-132b --reduced --device cpu`` (MoE) and gemma2-2b
    (local/global, softcaps) serve every request and print the
    reference launcher's report lines with its counts."""
    argv = ["--arch", arch] + ARGV[2:]
    engine, results = launcher.main(argv + ["--device", "cpu"])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_launcher.main()
    ref = capsys.readouterr().out
    assert len(results) == 4 and all(len(r.generated) == 8
                                      for r in results.values())
    assert _line_heads(mine) == _line_heads(ref)
    for a, b in zip(mine.splitlines(), ref.splitlines()):
        if a.startswith(("arch=", "engine steps", "tokens:")):
            assert a.split(" (")[0] == b.split(" (")[0], (a, b)
    assert f"arch={arch}" in mine and "served 4 requests" in mine


def test_launcher_lm_defaults_to_the_card_and_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="A.10"):
        launcher.main(ARGV + ["--device", "cpu", "--mesh", "1x2"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(ARGV)


# ------------------------------------------------------ import boundary

def test_the_lm_modules_import_no_jax():
    """``import repro_torch`` and the LM modules pull in nothing of JAX
    and nothing of the JAX package, in a fresh interpreter."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.launch.train, repro_torch.sharding\n"
        "import repro_torch.models.transformer, repro_torch.configs\n"
        "import repro_torch.models.moe\n"
        "from repro_torch.configs import ARCH_IDS, get_arch\n"
        "for arch in ARCH_IDS:\n"
        "    get_arch(arch).model()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
