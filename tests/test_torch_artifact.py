"""The port's plan artifact store (``repro_torch.artifact``) against the
JAX package's (``repro.artifact``), on the CPU.

Ports ``tests/test_artifact.py``: the graph codec (whose documents equal
the reference's), fingerprint semantics (stable across recompiles and processes;
moves with weights, quant mode, baked tiles, policies, the streaming
budget and the kernel sources; the params digest equals the
reference's on the same weights), save/load roundtrips, the fallback
ladder (corrupt / unknown schema / stale params / another build → warn,
never crash), zero-derivation serving boots, and the warmup report.

Not ported here, by design: ``TestAOT`` — its counterpart, a CUDA graph
per bucket, exists only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s ``boot`` phase). ``TestShardedArtifacts``'s
counterparts, which need a process group, are in
``tests/test_torch_mesh.py``.

An engine booted from an artifact is held against the JAX engine by the
bars of ``tests/test_torch_serve.py``: fp32 1e-5, qformat one Q8.8 step,
int8 rtol = atol = 1e-6 against the reference's jitted engine (which
contracts its requant epilogues into FMAs) and bitwise against its eager
forward.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.artifact import graph_to_doc as j_graph_to_doc
from repro.artifact import params_digest as j_params_digest
from repro.artifact.warmup import PHASES as J_PHASES
from repro.models.cnn import PaperCNN as JaxCNN
from repro.models.cnn import PaperCNNConfig as JaxCNNConfig
from repro.ops import ExecPolicy as JPolicy
from repro.serve import VisionEngine as JaxVisionEngine
from repro.serve import VisionEngineConfig as JaxVisionEngineConfig
import repro_torch.artifact.fingerprint as fingerprint
from repro_torch.artifact import (ArtifactError, ArtifactStaleError,
                                  PlanStore, graph_from_doc, graph_to_doc,
                                  load_plan, params_digest, save_plan)
from repro_torch.artifact.fingerprint import SCHEMA_VERSION
from repro_torch.artifact.warmup import PHASES, collect_warmup, phase
from repro_torch.bridge import params_from_numpy
from repro_torch.graph import BoundPlan
from repro_torch.launch import serve as launcher
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
from repro_torch.ops import ExecPolicy
from repro_torch.serve import VisionEngine, VisionEngineConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
MODES = ("none", "qformat", "int8")
TOL_FP32 = 1e-5
QSTEP = 2.0 ** -8


@pytest.fixture(scope="module")
def model():
    return PaperCNN(PaperCNNConfig())


@pytest.fixture(scope="module")
def weights():
    """The JAX init with seeded nonzero biases, as numpy, plus six seeded
    images."""
    params = JaxCNN(JaxCNNConfig()).init(jax.random.PRNGKey(1))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(1)
    for name, m in (("conv1", 15), ("conv2", 20)):
        np_params[name]["b"] = (rng.randn(m) * 0.1).astype(np.float32)
    np_params["fc_b"] = (rng.randn(10) * 0.1).astype(np.float32)
    images = [rng.randn(1, 28, 28).astype(np.float32) for _ in range(6)]
    return np_params, images


@pytest.fixture(scope="module")
def params(weights):
    return params_from_numpy(weights[0], "cpu")


@pytest.fixture(scope="module")
def images(weights):
    return torch.from_numpy(np.stack(weights[1][:2]))


def _bound(model, params, quant="none", batch=2, **kw):
    plan = model.compile(policy=ExecPolicy(quant=quant), batch=batch, **kw)
    return plan.bind(params)


class TestGraphCodec:
    @pytest.mark.parametrize("quant", MODES)
    @pytest.mark.parametrize("budget", [None, 10_000])
    def test_roundtrip_matches_the_reference_doc(self, model, quant,
                                                 budget):
        g = model.compile(policy=ExecPolicy(quant=quant), batch=2,
                          stream_budget=budget).graph
        assert graph_from_doc(graph_to_doc(g)) == g
        jg = JaxCNN(JaxCNNConfig()).compile(
            JPolicy(quant=quant), batch=2, stream_budget=budget,
            verify=False).graph
        assert graph_to_doc(g) == j_graph_to_doc(jg)

    def test_doc_is_json_stable(self, model):
        g = model.compile(batch=2).graph
        assert json.dumps(graph_to_doc(g), sort_keys=True) == \
            json.dumps(graph_to_doc(g), sort_keys=True)

    def test_unknown_op_rejected(self, model):
        doc = graph_to_doc(model.compile(batch=2).graph)
        doc["nodes"][1]["op"] = "systolic_array"
        with pytest.raises(ValueError, match="systolic_array"):
            graph_from_doc(doc)


class TestFingerprint:
    def test_stable_across_recompiles(self, model, params):
        assert (_bound(model, params).fingerprint()
                == _bound(model, params).fingerprint())

    def test_stable_across_processes(self, model):
        """A replica in another process derives the same identity for the
        same (model, weights, policy)."""
        code = (
            "from repro_torch.models.cnn import PaperCNN\n"
            "from repro_torch.ops import ExecPolicy\n"
            "m = PaperCNN()\n"
            "p = m.init(0, device='cpu')\n"
            "b = m.compile(policy=ExecPolicy(quant='none'), batch=2)"
            ".bind(p)\n"
            "print(b.fingerprint())\n")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO / "src")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True,
                             timeout=300)
        assert out.stdout.strip() == \
            _bound(model, model.init(0, device="cpu")).fingerprint()

    def test_weights_change_it(self, model, params):
        other = model.init(7, device="cpu")
        assert (_bound(model, params).fingerprint()
                != _bound(model, other).fingerprint())

    def test_quant_mode_changes_it(self, model, params):
        assert len({_bound(model, params, quant=q).fingerprint()
                    for q in MODES}) == 3

    def test_baked_tiles_change_it(self, model, params):
        b = _bound(model, params)
        tweaked = BoundPlan(plan=b.plan, params=b.params, folded=b.folded,
                            policy=b.policy,
                            tuned={3: {"fused_conv_block.split": 2}})
        assert b.fingerprint() != tweaked.fingerprint()

    def test_policies_change_it(self, model, params):
        b = _bound(model, params)
        tuned = model.compile(policy=ExecPolicy(autotune=True),
                              batch=2).bind(params)
        bound_pol = model.compile(batch=2).bind(
            params, policy=ExecPolicy(tiling={"fused_conv_block.ipb": 2}))
        assert len({b.fingerprint(), tuned.fingerprint(),
                    bound_pol.fingerprint()}) == 3

    def test_stream_budget_changes_it(self, model, params):
        fps = {_bound(model, params, stream_budget=s).fingerprint()
               for s in (None, 10_000, 12_000)}
        assert len(fps) == 3

    def test_kernel_sources_change_it(self, model, params, monkeypatch):
        want = _bound(model, params).fingerprint()
        monkeypatch.setattr(fingerprint, "source_digest", lambda: "edited")
        assert _bound(model, params).fingerprint() != want

    def test_params_digest_is_the_references(self, weights, params):
        def rev(d):
            if isinstance(d, dict):
                return {k: rev(v) for k, v in reversed(list(d.items()))}
            return d
        assert params_digest(params) == params_digest(rev(params))
        assert params_digest(params) == j_params_digest(
            jax.tree_util.tree_map(jnp.asarray, weights[0]))


class TestRoundtrip:
    @pytest.mark.parametrize("quant", MODES)
    @pytest.mark.parametrize("budget", [None, 10_000])
    def test_bitwise_equal_outputs(self, tmp_path, model, params, images,
                                   quant, budget):
        bound = _bound(model, params, quant=quant, stream_budget=budget)
        want = bound(images)
        fp = bound.save(tmp_path / quant)
        restored = BoundPlan.load(tmp_path / quant, device="cpu")
        assert restored.fingerprint() == fp
        assert restored.plan == bound.plan
        assert torch.equal(restored(images), want)

    def test_no_derivation_work_on_load(self, tmp_path, model, params):
        _bound(model, params).save(tmp_path / "p")
        with collect_warmup() as rep:
            BoundPlan.load(tmp_path / "p", device="cpu")
        assert rep.zero_compile()
        assert rep.phase_calls("artifact") == 1
        for p in ("trace", "fuse", "place", "tune", "compile"):
            assert rep.phase_calls(p) == 0, p

    def test_execution_plan_save_is_bind_plus_save(self, tmp_path, model,
                                                   params, images):
        plan = model.compile(policy=ExecPolicy(quant="int8"), batch=2)
        fp = plan.save(params, tmp_path / "p")
        restored = BoundPlan.load(tmp_path / "p", params=params,
                                  device="cpu")
        assert restored.fingerprint() == fp
        assert torch.equal(restored(images), plan.bind(params)(images))

    def test_tuned_tiles_and_their_cache_rows_survive(self, tmp_path,
                                                      model, params):
        from repro_torch.ops.tiling import TUNING_CACHE
        b = _bound(model, params)
        tuned = {3: {"fused_conv_block.split": 2}}
        src = BoundPlan(plan=b.plan, params=b.params, folded=b.folded,
                        policy=b.policy, tuned=tuned)
        sig = (2, 1, 28, 28, 15, 3, 3, 1, 1)
        saved = TUNING_CACHE.snapshot()
        try:
            TUNING_CACHE.put("fused_conv_block", sig, torch.float32,
                             {"split": 2})
            src.save(tmp_path / "p")
            TUNING_CACHE.clear()
            assert BoundPlan.load(tmp_path / "p", device="cpu").tuned == \
                tuned
            assert TUNING_CACHE.get("fused_conv_block", sig,
                                    torch.float32) == {"split": 2}
        finally:
            TUNING_CACHE.restore(saved)

    def test_load_defaults_to_the_card(self, tmp_path, model, params):
        _bound(model, params).save(tmp_path / "p")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                load_plan(tmp_path / "p")


class TestFallbackLadder:
    """Bad artifacts warn and fall back — never crash a boot."""

    def _saved(self, tmp_path, model, params):
        store = PlanStore(tmp_path)
        store.save("bucket_2", _bound(model, params))
        return store

    def _falls_back(self, store, **kw):
        with pytest.warns(UserWarning, match="falling back"):
            assert store.load("bucket_2", device="cpu", **kw) is None

    def test_corrupt_manifest(self, tmp_path, model, params):
        store = self._saved(tmp_path, model, params)
        (store.path("bucket_2") / "manifest.json").write_text("{not json")
        self._falls_back(store)

    def test_corrupt_payload(self, tmp_path, model, params):
        store = self._saved(tmp_path, model, params)
        (store.path("bucket_2") / "payloads.npz").write_bytes(b"garbage")
        with pytest.raises(ArtifactError, match="malformed"):
            load_plan(store.path("bucket_2"), device="cpu")
        self._falls_back(store)

    def test_unknown_schema_version(self, tmp_path, model, params):
        store = self._saved(tmp_path, model, params)
        mf = store.path("bucket_2") / "manifest.json"
        doc = json.loads(mf.read_text())
        doc["schema_version"] = SCHEMA_VERSION + 99
        mf.write_text(json.dumps(doc))
        with pytest.raises(ArtifactError, match="schema"):
            load_plan(store.path("bucket_2"), device="cpu")
        self._falls_back(store)

    def test_tampered_manifest_fails_fingerprint(self, tmp_path, model,
                                                 params):
        store = self._saved(tmp_path, model, params)
        mf = store.path("bucket_2") / "manifest.json"
        doc = json.loads(mf.read_text())
        doc["quant"] = "int8"            # lie about the baked quant mode
        mf.write_text(json.dumps(doc))
        with pytest.raises(ArtifactError, match="fingerprint"):
            load_plan(store.path("bucket_2"), device="cpu")
        self._falls_back(store)

    def test_another_build_falls_back(self, tmp_path, model, params,
                                      monkeypatch):
        """An artifact written against other kernel sources (or another
        torch, CUDA or device) never serves."""
        store = self._saved(tmp_path, model, params)
        monkeypatch.setattr(fingerprint, "source_digest", lambda: "edited")
        self._falls_back(store)

    def test_stale_params_detected(self, tmp_path, model, params):
        store = self._saved(tmp_path, model, params)
        other = model.init(7, device="cpu")
        with pytest.raises(ArtifactStaleError):
            load_plan(store.path("bucket_2"), params=other, device="cpu")
        self._falls_back(store, params=other)

    def test_missing_artifact_warns_and_is_none(self, tmp_path):
        assert not PlanStore(tmp_path).has("bucket_8")
        assert PlanStore(tmp_path).names() == []
        with pytest.warns(UserWarning, match="falling back"):
            assert PlanStore(tmp_path).load("bucket_8", device="cpu") is None


def _engine(model, params, **kw):
    return VisionEngine(model, params, VisionEngineConfig(
        batch=2, buckets="auto", device="cpu", **kw))


class TestServingBoot:
    def test_artifact_boot_runs_zero_derivation(self, tmp_path, model,
                                                params):
        donor = _engine(model, params)
        assert set(donor.save_artifacts(tmp_path)) == {"bucket_1",
                                                       "bucket_2"}
        assert PlanStore(tmp_path).names() == ["bucket_1", "bucket_2"]
        with collect_warmup() as boot:
            engine = _engine(model, params, artifact_dir=str(tmp_path))
        assert boot.zero_compile()
        assert boot.phase_calls("artifact") == 2
        assert boot.phase_calls("first_dispatch") == 2
        assert set(engine.plan_source.values()) == {"artifact+aot"}

    def test_artifact_boot_serves_identically(self, tmp_path, model,
                                              params, weights):
        fresh = _engine(model, params)
        fresh.save_artifacts(tmp_path)
        booted = _engine(model, params, artifact_dir=str(tmp_path))
        for img in weights[1][:3]:
            fresh.submit(img)
            booted.submit(img)
        a, b = fresh.run(), booted.run()
        for uid in a:
            np.testing.assert_array_equal(a[uid]["logits"],
                                          b[uid]["logits"])

    @pytest.mark.parametrize("mode", MODES)
    def test_artifact_boot_matches_the_reference_engine(self, tmp_path,
                                                        weights, mode):
        np_params, imgs = weights
        model = PaperCNN()
        params = params_from_numpy(np_params, "cpu")
        cfg = dict(batch=4, policy=ExecPolicy(quant=mode), device="cpu")
        VisionEngine(model, params, VisionEngineConfig(**cfg)) \
            .save_artifacts(tmp_path)
        eng = VisionEngine(model, params, VisionEngineConfig(
            **cfg, artifact_dir=str(tmp_path)))
        assert eng.plan_source == {4: "artifact+aot"}
        jax_params = jax.tree_util.tree_map(jnp.asarray, np_params)
        jpol = JPolicy(backend="xla", quant=mode)
        jeng = JaxVisionEngine(JaxCNN(JaxCNNConfig()), jax_params,
                               JaxVisionEngineConfig(batch=4, policy=jpol))
        for img in imgs:
            eng.submit(img)
            jeng.submit(img)
        got, want = eng.run(), jeng.run()
        g = np.stack([got[i]["logits"] for i in sorted(got)])
        w = np.stack([want[i]["logits"] for i in sorted(want)])
        if mode == "int8":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
            eager = JaxCNN(JaxCNNConfig(policy=jpol)).forward(
                jax_params, jnp.asarray(np.stack(imgs[:4])))
            np.testing.assert_array_equal(g[:4], np.asarray(eager))
        elif mode == "qformat":
            assert np.abs(g - w).max() <= QSTEP
        else:
            np.testing.assert_allclose(g, w, rtol=TOL_FP32, atol=TOL_FP32)

    def test_stale_store_falls_back_to_fresh(self, tmp_path, model,
                                             params):
        _engine(model, params).save_artifacts(tmp_path)
        other = model.init(7, device="cpu")
        with pytest.warns(UserWarning, match="falling back"):
            engine = _engine(model, other, artifact_dir=str(tmp_path))
        assert set(engine.plan_source.values()) == {"fresh"}

    def test_save_artifacts_needs_a_directory(self, model, params):
        with pytest.raises(ValueError, match="artifact directory"):
            _engine(model, params).save_artifacts()

    def test_launcher_saves_then_boots_from_the_store(self, tmp_path,
                                                      capsys):
        argv = ["--arch", "mnist_cnn", "--capacity", "2", "--requests",
                "3", "--device", "cpu", "--warmup-report"]
        cache = str(tmp_path / "tuned.tuning.json")
        _, first = launcher.main(argv + ["--autotune", "--tuning-cache",
                                         cache, "--save-plan",
                                         str(tmp_path / "plans")])
        out = capsys.readouterr().out
        assert "0 autotuned stages" in out and "saved plan artifact" in out
        assert json.loads(pathlib.Path(cache).read_text())["entries"] == []
        _, again = launcher.main(argv + ["--plan-artifact",
                                         str(tmp_path / "plans")])
        out = capsys.readouterr().out
        assert "plan artifacts: 1:artifact+aot, 2:artifact+aot" in out
        assert "zero-derivation boot: OK" in out
        assert all(p in out for p in PHASES)
        for uid in first:
            np.testing.assert_array_equal(first[uid]["logits"],
                                          again[uid]["logits"])


class TestWarmupReport:
    def test_phases_are_the_references(self):
        assert PHASES == J_PHASES

    def test_phase_attribution(self):
        with collect_warmup() as rep:
            with phase("trace"):
                pass
            with phase("trace"):
                pass
            with phase("compile"):
                pass
        assert rep.phase_calls("trace") == 2
        assert rep.phase_calls("compile") == 1
        assert not rep.zero_compile()
        assert all(p in rep.pretty() for p in PHASES)

    def test_noop_outside_collector(self):
        with phase("compile"):
            pass

    def test_zero_compile_means_no_derivation(self):
        with collect_warmup() as rep:
            with phase("artifact"):
                pass
            with phase("first_dispatch"):
                pass
        assert rep.zero_compile()

    def test_compile_records_trace_fuse_place(self, model):
        with collect_warmup() as rep:
            model.compile(batch=2, stream_budget=10_000)
        assert [rep.phase_calls(p) for p in ("trace", "fuse", "place")] \
            == [1, 1, 1]


def test_save_plan_refuses_params_it_cannot_flatten(tmp_path, model,
                                                    params):
    b = _bound(model, params)
    bad = BoundPlan(plan=b.plan, params={**params, "x": [1, 2]},
                    folded=b.folded)
    with pytest.raises(ArtifactError, match="dict of tensors"):
        save_plan(bad, tmp_path / "p")
    assert not (tmp_path / "p").exists()
