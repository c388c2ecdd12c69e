"""The port's ``OpenLoopDriver`` against the reference's, on the CPU.

The same arrival schedules, made from numpy seeds (Poisson arrivals from
``RandomState(seed).exponential``), replay against both packages'
``Frontend`` under a ``VirtualClock`` with a virtual step cost, so every
latency is an exact function of the schedule:

* over the stub engines of ``tests/test_frontend_virtual.py`` (a lane
  engine and a bucket former, ported here as helpers), both top-up
  settings, with and without a deadline, under and over load: the shed
  lists, the dispatch order and the results equal, ``stats.latencies``
  bitwise, and steps, items, pad lanes, completed, deadline misses and
  goodput equal;
* the reference's own driver cases on the port: the same seed gives the
  same stats, every arrival is accounted for, a shed arrival is a counted
  rejection, the top-up trace, an idle clock jumping to the next
  arrival, a stall and ``max_steps`` raising, an unsorted schedule sorted
  stably;
* over the real engines, with the JAX package's weights carried across by
  ``repro_torch.bridge``: ``VisionEngine`` serving ``PaperCNN`` in all
  three formats against JAX's engine (Pallas in interpret mode) under the
  reference's driver, and the reduced qwen1.5-0.5b ``Engine`` against
  JAX's engine run op by op. Shed lists, batches and latencies are equal
  exactly; tokens are equal; logits are held as ``tests/test_torch_serve.py``
  holds the engines: fp32 within 1e-5, qformat within one Q8.8 step, and
  int8 within 1e-6 of JAX's compiled engine (jax 0.9.0 contracts its
  requant epilogue into an FMA) and bitwise to the reference's eager
  forward of each batch the driver formed. An int8 batch shares one
  activation scale, so a request's int8 logits depend on its batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_lm import _PORT_ROUNDING, _compiled_quantize_int8

import repro.serve as jserve
import repro.serve.cache as j_cache
import repro_torch.serve as tserve
from repro.configs.registry import get_arch as j_get_arch
from repro.launch.train import reduced_config as j_reduced_config
from repro.models import common as jc
from repro.models.cnn import PaperCNN as JaxCNN
from repro.models.cnn import PaperCNNConfig as JaxCNNConfig
from repro.ops import ExecPolicy as JPolicy
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.launch.train import reduced_config
from repro_torch.models.cnn import PaperCNN
from repro_torch.ops import ExecPolicy

PACKAGES = {"jax": jserve, "port": tserve}
STEP = 0.01                       # virtual seconds an engine step costs
TOL_FP32 = 1e-5
TOL_INT8_COMPILED = 1e-6
QSTEP = 2.0 ** -8


# ------------------------------------------------ stub engines (helpers)

class SimAdapter:
    """Lane engine: ``capacity`` lanes; a request holds one lane for
    ``options["steps"]`` engine steps. ``pkg`` is the serving package
    whose ``ServeStats`` and ``QueueFullError`` it uses."""

    kind = "sim"
    forms_buckets = False

    def __init__(self, pkg, capacity: int, refuse_first: int = 0):
        self.pkg = pkg
        self.capacity = capacity
        self.stats = pkg.ServeStats()
        self.lanes: dict[int, int] = {}          # rid -> steps remaining
        self.injected: list[int] = []            # rids, in inject order
        self._refuse = refuse_first
        self._done: list[tuple[int, object]] = []

    @property
    def preferred_batch(self) -> int:
        return self.capacity

    def free_lanes(self) -> int:
        return self.capacity - len(self.lanes)

    def inject(self, req) -> None:
        if self._refuse > 0:
            self._refuse -= 1
            raise self.pkg.QueueFullError(len(self.lanes), self.capacity)
        assert len(self.lanes) < self.capacity, "inject into a full engine"
        self.lanes[req.rid] = int(req.options.get("steps", 1))
        self.injected.append(req.rid)

    def step(self) -> None:
        active = len(self.lanes)
        self.stats.steps += 1
        self.stats.items += active
        self.stats.lane_steps += active
        self.stats.pad_lanes += self.capacity - active
        for rid in list(self.lanes):
            self.lanes[rid] -= 1
            if self.lanes[rid] <= 0:
                del self.lanes[rid]
                self._done.append((rid, f"result-{rid}"))

    def drain(self):
        out, self._done = self._done, []
        return out

    def has_inflight(self) -> bool:
        return bool(self.lanes)


class BucketSimAdapter:
    """Bucket former: each step serves one fresh batch of up to ``batch``
    injected requests and pays pad lanes for the rest of the bucket."""

    kind = "sim-bucket"
    forms_buckets = True

    def __init__(self, pkg, batch: int):
        self.batch = batch
        self.stats = pkg.ServeStats()
        self.injected: list[int] = []
        self.batches: list[list[int]] = []
        self._pending: list[int] = []
        self._done: list[tuple[int, object]] = []

    @property
    def preferred_batch(self) -> int:
        return self.batch

    def free_lanes(self) -> int:
        return self.batch

    def inject(self, req) -> None:
        self._pending.append(req.rid)
        self.injected.append(req.rid)

    def step(self) -> None:
        if not self._pending:
            return
        served, self._pending = (self._pending[:self.batch],
                                 self._pending[self.batch:])
        self.batches.append(served)
        self.stats.steps += 1
        self.stats.items += len(served)
        self.stats.lane_steps += len(served)
        self.stats.pad_lanes += self.batch - len(served)
        self._done.extend((rid, rid) for rid in served)

    def drain(self):
        out, self._done = self._done, []
        return out

    def has_inflight(self) -> bool:
        return bool(self._pending)


class Recorder:
    """Wraps a real engine's adapter and records the dispatch order (rids
    as injected) and, for a bucket former, the rids of each step."""

    def __init__(self, adapter):
        self.adapter = adapter
        self.kind = adapter.kind
        self.forms_buckets = adapter.forms_buckets
        self.injected: list[int] = []
        self.batches: list[list[int]] = []
        self._since: list[int] = []

    @property
    def stats(self):
        return self.adapter.stats

    @property
    def preferred_batch(self) -> int:
        return self.adapter.preferred_batch

    def free_lanes(self) -> int:
        return self.adapter.free_lanes()

    def inject(self, req) -> None:
        self.adapter.inject(req)
        self.injected.append(req.rid)
        self._since.append(req.rid)

    def step(self) -> None:
        self.adapter.step()
        self.batches.append(self._since)
        self._since = []

    def drain(self):
        return self.adapter.drain()

    def has_inflight(self) -> bool:
        return self.adapter.has_inflight()


def poisson(seed: int, n: int, mean_gap: float, payloads=None,
            options=None) -> list[tuple[float, object, dict]]:
    """``n`` arrivals at seeded Poisson times; payload i is ``payloads[i]``
    (default i), options ``options(rng, i)`` (default one to three lane
    steps)."""
    rng = np.random.RandomState(seed)
    times = np.cumsum(rng.exponential(mean_gap, size=n))
    out = []
    for i, t in enumerate(times):
        opts = (options(rng, i) if options is not None
                else {"steps": int(rng.randint(1, 4))})
        out.append((float(t), i if payloads is None else payloads[i], opts))
    return out


def drive(pkg, adapter, arrivals, *, max_steps=2000, **cfg):
    """One open-loop run of ``arrivals`` on ``pkg``'s front-end under a
    fresh VirtualClock: (front-end, driver, results)."""
    clock = pkg.VirtualClock()
    cfg.setdefault("step_cost_s", STEP)
    fe = pkg.Frontend(adapter, pkg.FrontendConfig(**cfg), clock)
    driver = pkg.OpenLoopDriver(fe, arrivals)
    return fe, driver, driver.run(max_steps=max_steps)


STAT_FIELDS = ("steps", "items", "lane_steps", "pad_lanes", "submitted",
               "rejected", "completed", "deadline_misses", "first_t",
               "last_t", "wall_s")


def assert_same_run(want, got) -> None:
    """Two packages' (front-end, driver) after the same schedule: shed
    lists, latencies (bitwise: ``==`` on floats), the stats fields and
    goodput, and every request's timestamps equal."""
    (jfe, jdrv), (tfe, tdrv) = want, got
    assert tdrv.shed == jdrv.shed
    assert tfe.stats.latencies == jfe.stats.latencies
    for f in STAT_FIELDS:
        assert getattr(tfe.stats, f) == getattr(jfe.stats, f), f
    assert tfe.stats.goodput_rps == jfe.stats.goodput_rps
    assert tfe.stats.p99_s == jfe.stats.p99_s
    assert sorted(tfe.requests) == sorted(jfe.requests)
    for rid, jr in jfe.requests.items():
        tr = tfe.requests[rid]
        assert (tr.arrival_t, tr.deadline_t, tr.dispatch_t, tr.finish_t) == \
            (jr.arrival_t, jr.deadline_t, jr.dispatch_t, jr.finish_t), rid
    assert [a[0] for a in tdrv.arrivals] == [a[0] for a in jdrv.arrivals]


# ----------------------------------------- port vs reference, stub engines

STUBS = {"lanes": lambda pkg: SimAdapter(pkg, 2),
         "bucket": lambda pkg: BucketSimAdapter(pkg, 4)}
LOADS = {"under": 0.02, "over": 0.002}   # mean gap; a step costs 0.01


@pytest.mark.parametrize("load", sorted(LOADS))
@pytest.mark.parametrize("slo_s", [None, 0.05])
@pytest.mark.parametrize("topup", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("stub", sorted(STUBS))
def test_stub_engine_schedule_matches_the_reference(stub, seed, topup, slo_s,
                                                    load):
    arrivals = poisson(seed, 24, LOADS[load])
    runs = {}
    for name, pkg in PACKAGES.items():
        adapter = STUBS[stub](pkg)
        fe, driver, res = drive(pkg, adapter, arrivals, max_queue=4,
                                slo_s=slo_s, topup=topup)
        runs[name] = (fe, driver, res, adapter)
    (jfe, jdrv, jres, jad), (tfe, tdrv, tres, tad) = runs["jax"], runs["port"]
    assert_same_run((jfe, jdrv), (tfe, tdrv))
    assert tres == jres
    assert tad.injected == jad.injected
    if stub == "bucket":
        assert tad.batches == jad.batches
    s = tfe.stats
    assert s.submitted + len(tdrv.shed) == len(arrivals)
    assert s.rejected == len(tdrv.shed) and s.completed == s.submitted
    if load == "over":
        assert tdrv.shed, "an overloaded run must shed"


# ------------------------------- the reference's driver cases, on the port

def _port(adapter, **cfg):
    clock = tserve.VirtualClock()
    cfg.setdefault("step_cost_s", STEP)
    return tserve.Frontend(adapter, tserve.FrontendConfig(**cfg), clock), clock


def _stats_once(seed: int):
    arrivals = poisson(seed, 12, 0.01)
    fe, _ = _port(SimAdapter(tserve, 2), slo_s=0.05)
    tserve.OpenLoopDriver(fe, arrivals).run(max_steps=500)
    return fe.stats


def test_same_seed_identical_stats():
    a, b = _stats_once(7), _stats_once(7)
    assert a.latencies == b.latencies
    assert (a.steps, a.items, a.pad_lanes, a.completed, a.deadline_misses) \
        == (b.steps, b.items, b.pad_lanes, b.completed, b.deadline_misses)
    assert a.goodput_rps == b.goodput_rps


def test_all_arrivals_accounted():
    s = _stats_once(3)
    assert (s.submitted, s.completed, s.rejected) == (12, 12, 0)


def test_shed_arrivals_are_counted_rejections():
    """A burst lands before any dispatch: one accepted, three refused at
    intake and shed, with no retry."""
    fe, _ = _port(SimAdapter(tserve, 1), max_queue=1)
    driver = tserve.OpenLoopDriver(fe, [(0.0, i, {"steps": 4})
                                        for i in range(4)])
    driver.run(max_steps=200)
    assert fe.stats.rejected == len(driver.shed) == 3
    assert driver.shed == [0.0, 0.0, 0.0]
    assert fe.stats.submitted == fe.stats.completed == 1


def _staggered(topup: bool):
    fe, _ = _port(BucketSimAdapter(tserve, 4), slo_s=1.0, topup=topup)
    arrivals = [(0.000, "a", {}), (0.005, "b", {}), (0.010, "c", {}),
                (0.015, "d", {})]
    tserve.OpenLoopDriver(fe, arrivals).run(max_steps=100)
    return fe.stats


def test_topup_trace():
    """Staggered arrivals into a batch-4 bucket former: top-up holds the
    partial bucket and serves one full batch; the greedy policy opens a
    bucket per wave and pays pad lanes."""
    held, greedy = _staggered(True), _staggered(False)
    assert held.steps == 1 and held.pad_lanes == 0
    assert held.latencies == [pytest.approx(0.025), pytest.approx(0.020),
                              pytest.approx(0.015), pytest.approx(0.010)]
    assert greedy.completed == held.completed == 4
    assert greedy.steps > held.steps and greedy.pad_lanes > held.pad_lanes
    assert held.lane_utilization > greedy.lane_utilization


def test_idle_clock_jumps_to_the_next_arrival():
    fe, clock = _port(SimAdapter(tserve, 2))
    driver = tserve.OpenLoopDriver(fe, [(1.0, "a", {}), (5.0, "b", {})])
    driver.run(max_steps=10)
    assert fe.stats.latencies == [pytest.approx(STEP)] * 2
    assert clock.now() == pytest.approx(5.0 + STEP)
    assert [r.arrival_t for r in fe.requests.values()] == \
        [pytest.approx(1.0), pytest.approx(5.0)]


def test_a_stall_raises():
    class Stalled(SimAdapter):
        def free_lanes(self):
            return 0

    fe, _ = _port(Stalled(tserve, 1))
    driver = tserve.OpenLoopDriver(fe, [(0.0, "stuck", {})])
    with pytest.raises(RuntimeError, match="stalled"):
        driver.run(max_steps=10)


def test_max_steps_raises():
    fe, _ = _port(SimAdapter(tserve, 1))
    driver = tserve.OpenLoopDriver(fe, [(0.0, "long", {"steps": 50})])
    with pytest.raises(RuntimeError, match="max_steps=5"):
        driver.run(max_steps=5)


def test_an_unsorted_schedule_is_sorted_stably():
    """Arrivals given out of order replay sorted by time, ties in the
    order given, and serve as the sorted schedule does."""
    arrivals = poisson(4, 10, 0.01)
    shuffled = [arrivals[i] for i in np.random.RandomState(0).permutation(10)]
    tie = [(0.5, "first", {}), (0.5, "second", {}), (0.1, "early", {})]
    fe, _ = _port(SimAdapter(tserve, 2))
    driver = tserve.OpenLoopDriver(fe, shuffled + tie)
    assert [a[0] for a in driver.arrivals] == sorted(
        a[0] for a in shuffled + tie)
    order = [a[1] for a in driver.arrivals if a[0] == 0.5]
    assert order == ["first", "second"]
    res = driver.run(max_steps=500)
    fe2, _ = _port(SimAdapter(tserve, 2))
    res2 = tserve.OpenLoopDriver(
        fe2, sorted(shuffled + tie, key=lambda a: a[0])).run(max_steps=500)
    assert res == res2 and fe.stats.latencies == fe2.stats.latencies


# ----------------------------------------------- real engines, both sides

@pytest.fixture(scope="module")
def cnn():
    """JAX ``PaperCNN`` weights (seeded nonzero biases) as numpy, and 16
    seeded images."""
    params = JaxCNN(JaxCNNConfig()).init(jax.random.PRNGKey(1))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(5)
    for name, m in (("conv1", 15), ("conv2", 20)):
        np_params[name]["b"] = (rng.randn(m) * 0.1).astype(np.float32)
    np_params["fc_b"] = (rng.randn(10) * 0.1).astype(np.float32)
    images = [rng.randn(1, 28, 28).astype(np.float32) for _ in range(16)]
    return np_params, images


@pytest.mark.parametrize("mode", ["none", "qformat", "int8"])
def test_vision_engine_open_loop_matches_the_reference(cnn, mode):
    """16 images at seeded Poisson times (8 a step), batch 4, queue 6,
    deadline 0.05 s: the port's VisionEngine behind its driver against
    JAX's behind the reference's, the same schedule on the same weights.
    """
    np_params, images = cnn
    jax_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    jpol = JPolicy(backend="pallas", quant=mode)
    arrivals = poisson(11, len(images), STEP / 8, payloads=images,
                       options=lambda rng, i: {})
    cfg = dict(max_queue=6, slo_s=0.05)
    jclock, tclock = jserve.VirtualClock(), tserve.VirtualClock()
    jeng = jserve.VisionEngine(
        JaxCNN(JaxCNNConfig()), jax_params,
        jserve.VisionEngineConfig(batch=4, policy=jpol), clock=jclock)
    teng = tserve.VisionEngine(
        PaperCNN(), params_from_numpy(np_params, "cpu"),
        tserve.VisionEngineConfig(batch=4, policy=ExecPolicy(quant=mode),
                                  device="cpu"), clock=tclock)
    runs = {}
    for name, pkg, eng, clock in (("jax", jserve, jeng, jclock),
                                  ("port", tserve, teng, tclock)):
        rec = Recorder(pkg.VisionAdapter(eng))
        fe = pkg.Frontend(rec, pkg.FrontendConfig(step_cost_s=STEP, **cfg),
                          clock)
        driver = pkg.OpenLoopDriver(fe, arrivals)
        runs[name] = (fe, driver, driver.run(max_steps=200), rec)
    (jfe, jdrv, want, jrec), (tfe, tdrv, got, trec) = runs["jax"], runs["port"]
    assert_same_run((jfe, jdrv), (tfe, tdrv))
    assert trec.injected == jrec.injected and trec.batches == jrec.batches
    assert tdrv.shed, "the schedule must shed"
    assert sorted(got) == sorted(want)
    assert tfe.stats.completed + len(tdrv.shed) == len(images)
    g = np.stack([got[r]["logits"] for r in sorted(got)])
    w = np.stack([want[r]["logits"] for r in sorted(want)])
    if mode == "none":
        np.testing.assert_allclose(g, w, rtol=TOL_FP32, atol=TOL_FP32)
    elif mode == "qformat":
        assert np.abs(g - w).max() <= QSTEP
    else:
        np.testing.assert_allclose(g, w, rtol=TOL_INT8_COMPILED,
                                   atol=TOL_INT8_COMPILED)
        model = JaxCNN(JaxCNNConfig(policy=jpol))
        for batch in trec.batches:
            if not batch:
                continue
            x = np.zeros((4, 1, 28, 28), np.float32)     # padded bucket
            x[:len(batch)] = [tfe.requests[r].payload for r in batch]
            eager = np.asarray(model.forward(jax_params, jnp.asarray(x)))
            np.testing.assert_array_equal(
                np.stack([got[r]["logits"] for r in batch]),
                eager[:len(batch)])


@pytest.fixture(scope="module")
def qwen():
    """qwen1.5-0.5b reduced as the launchers reduce it (bf16, 2 layers,
    d_model 64) in both packages, the JAX weights bridged to the port."""
    jm = j_reduced_config(j_get_arch("qwen1.5-0.5b").model())
    tm = reduced_config(get_arch("qwen1.5-0.5b").model())
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_lm_engine_open_loop_matches_the_reference(qwen, quant, monkeypatch):
    """Eight prompts of 8, 12 or 16 tokens asking 2–6 tokens each, at
    seeded Poisson times (two a step), capacity 2, queue 3: the port's
    Engine behind its driver against JAX's engine run op by op (as
    ``tests/test_torch_lm_graphs.py`` holds them) behind the reference's;
    under ``quant="int8"`` every MLP matmul goes through qmatmul's plain
    version and the KV cache is int8."""
    monkeypatch.setitem(jc.ACTIVATIONS, "silu", _PORT_ROUNDING["silu"])
    monkeypatch.setattr(j_cache, "quantize_int8", _compiled_quantize_int8)
    jm, jp, tm, tp = qwen
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, tm.cfg.vocab, size=int(p)).astype(np.int32)
               for p in rng.choice([8, 12, 16], size=8)]
    arrivals = poisson(13, len(prompts), STEP / 2, payloads=prompts,
                       options=lambda r, i: {
                           "max_new_tokens": int(r.randint(2, 7))})
    jclock, tclock = jserve.VirtualClock(), tserve.VirtualClock()
    jeng = jserve.Engine(jm, jp, jserve.EngineConfig(
        capacity=2, max_seq=24, policy=JPolicy(quant=quant)), clock=jclock)
    teng = tserve.Engine(tm, tp, tserve.EngineConfig(
        capacity=2, max_seq=24, policy=ExecPolicy(quant=quant),
        device="cpu"), clock=tclock)
    runs = {}
    for name, pkg, eng, clock in (("jax", jserve, jeng, jclock),
                                  ("port", tserve, teng, tclock)):
        rec = Recorder(pkg.LMAdapter(eng))
        fe = pkg.Frontend(rec, pkg.FrontendConfig(max_queue=3,
                                                  step_cost_s=STEP), clock)
        driver = pkg.OpenLoopDriver(fe, arrivals)
        if name == "jax":
            with jax.disable_jit():
                res = driver.run(max_steps=500)
        else:
            res = driver.run(max_steps=500)
        runs[name] = (fe, driver, res, rec)
    (jfe, jdrv, want, jrec), (tfe, tdrv, got, trec) = runs["jax"], runs["port"]
    assert_same_run((jfe, jdrv), (tfe, tdrv))
    assert trec.injected == jrec.injected
    assert tdrv.shed, "the schedule must shed"
    assert tfe.stats.completed + len(tdrv.shed) == len(prompts)
    assert {r: v.generated for r, v in got.items()} == \
        {r: v.generated for r, v in want.items()}
    for rid, res in got.items():
        assert len(res.generated) == \
            tfe.requests[rid].options["max_new_tokens"]
    assert teng.stats.prefills == jeng.stats.prefills == len(got)
