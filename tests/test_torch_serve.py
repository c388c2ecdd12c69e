"""The port's serving stack against the JAX package, the launcher on the
CPU, and the port's import boundary.

``VisionEngine`` on ``device="cpu"`` serves the same seeded images with
the weights of the JAX ``PaperCNN.init`` (seeded nonzero biases) and is
held per request against the JAX ``VisionEngine`` running its Pallas
kernels in interpret mode, to the tolerances of
``tests/test_torch_model.py`` except under int8. There the reference
engine is not bitwise equal to its own op-by-op plan on jax 0.9.0: it
compiles each bucket into one program, in which the requant epilogues
``acc·s + b`` contract into FMAs despite the optimization barrier, and
the per-tensor and per-row int8 scales move by an ulp. So int8 engine
logits are held to rtol = atol = 1e-6 (about eight ulps at |y| ~ 1),
and the port's full batch bitwise to the reference's eager forward,
which keeps the two roundings.
"""
import ast
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.cnn import PaperCNN as JaxCNN
from repro.models.cnn import PaperCNNConfig as JaxCNNConfig
from repro.ops import ExecPolicy as JPolicy
from repro.serve import VisionEngine as JaxVisionEngine
from repro.serve import VisionEngineConfig as JaxVisionEngineConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models.cnn import PaperCNN
from repro_torch.ops import ExecPolicy
from repro_torch.serve import (Frontend, FrontendConfig, QueueFullError,
                               SchedulerCore, VirtualClock, VisionAdapter,
                               VisionEngine, VisionEngineConfig)

ROOT = Path(__file__).resolve().parents[1]
MODES = ("none", "qformat", "int8")
TOL_FP32 = 1e-5
QSTEP = 2.0 ** -8


@pytest.fixture(scope="module")
def weights():
    params = JaxCNN(JaxCNNConfig()).init(jax.random.PRNGKey(1))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(1)
    for name, m in (("conv1", 15), ("conv2", 20)):
        np_params[name]["b"] = (rng.randn(m) * 0.1).astype(np.float32)
    np_params["fc_b"] = (rng.randn(10) * 0.1).astype(np.float32)
    images = [rng.randn(1, 28, 28).astype(np.float32) for _ in range(6)]
    return np_params, images


def _serve(engine, images) -> dict:
    for img in images:
        engine.submit(img)
    return engine.run()


@pytest.mark.parametrize("mode", MODES)
def test_vision_engine_matches_reference(weights, mode):
    """Six requests at batch 4: one full batch and one short batch padded
    to the bucket, on both sides."""
    np_params, images = weights
    jax_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    jpol = JPolicy(backend="pallas", quant=mode)
    jeng = JaxVisionEngine(JaxCNN(JaxCNNConfig()), jax_params,
                           JaxVisionEngineConfig(batch=4, policy=jpol))
    eng = VisionEngine(PaperCNN(), params_from_numpy(np_params, "cpu"),
                       VisionEngineConfig(batch=4,
                                          policy=ExecPolicy(quant=mode),
                                          device="cpu"))
    want, got = _serve(jeng, images), _serve(eng, images)
    assert sorted(got) == sorted(want) == list(range(len(images)))
    g = np.stack([got[i]["logits"] for i in sorted(got)])
    w = np.stack([want[i]["logits"] for i in sorted(want)])
    if mode == "int8":
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        eager = JaxCNN(JaxCNNConfig(policy=jpol)).forward(
            jax_params, jnp.asarray(np.stack(images[:4])))
        np.testing.assert_array_equal(g[:4], np.asarray(eager))
    elif mode == "qformat":
        diff = np.abs(g - w)
        assert diff.max() <= QSTEP, (
            f"{int((diff > 0).sum())} logits differ, max {diff.max()}")
    else:
        np.testing.assert_allclose(g, w, rtol=TOL_FP32, atol=TOL_FP32)
    top2 = np.sort(w, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert [got[i]["label"] for i in range(6) if clear[i]] == \
        [want[i]["label"] for i in range(6) if clear[i]]
    for s in (eng.stats, jeng.stats):
        assert (s.steps, s.items, s.pad_lanes) == (2, 6, 2)


def test_bucket_ladder_and_prewarm():
    model = PaperCNN()
    eng = VisionEngine(model, model.init(0, device="cpu"),
                       VisionEngineConfig(batch=8, buckets="auto",
                                          device="cpu"))
    assert eng.buckets == (1, 2, 4, 8)
    assert sorted(eng._bounds) == [1, 2, 4, 8]        # prewarmed at boot
    rng = np.random.RandomState(0)
    _serve(eng, [rng.randn(1, 28, 28).astype(np.float32)
                 for _ in range(11)])                 # 8 + 3 -> bucket 4
    assert (eng.stats.steps, eng.stats.items, eng.stats.pad_lanes) == \
        (2, 11, 1)
    with pytest.raises(ValueError):
        VisionEngine(model, model.init(0, device="cpu"),
                     VisionEngineConfig(batch=8, buckets=(1, 4),
                                        device="cpu"))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((28, 28), np.float32))


@pytest.mark.parametrize("option", [{"mesh": object()}, {"autotune": True},
                                    {"artifact_dir": "plans"}])
def test_unported_engine_options_raise(option):
    """A mesh must be a ``DeviceMesh`` with a ``model`` axis (mesh
    serving is held in ``tests/test_torch_mesh.py``). ``autotune``
    serves (the CPU tunes nothing) and an ``artifact_dir`` without an
    artifact warns and compiles fresh, as the reference's engine does."""
    model = PaperCNN()
    params = model.init(0, device="cpu")
    if "mesh" in option:
        with pytest.raises(ValueError, match="no 'model' axis"):
            VisionEngine(model, params,
                         VisionEngineConfig(device="cpu", **option))
    elif "artifact_dir" in option:
        with pytest.warns(UserWarning, match="falling back"):
            eng = VisionEngine(model, params,
                               VisionEngineConfig(device="cpu", **option))
        assert set(eng.plan_source.values()) == {"fresh"}
    else:
        eng = VisionEngine(model, params,
                           VisionEngineConfig(device="cpu", **option))
        assert all(not b.tuned for b in eng._bounds.values())


def test_launcher_serves_on_cpu(capsys):
    engine, results = launcher.main(["--arch", "mnist_cnn", "--capacity",
                                     "4", "--requests", "10", "--device",
                                     "cpu"])
    out = capsys.readouterr().out
    assert "served 10 images" in out and "vision path on cpu" in out
    assert sorted(results) == list(range(10))
    assert engine.buckets == (1, 2, 4)
    logits = np.stack([results[i]["logits"] for i in range(10)])
    assert logits.shape == (10, 10) and np.isfinite(logits).all()
    # the same seeded weights and images through the engine directly
    model = PaperCNN()
    direct = VisionEngine(model, model.init(0, device="cpu"),
                          VisionEngineConfig(batch=4, buckets="auto",
                                             device="cpu"))
    rng = np.random.RandomState(1)
    want = _serve(direct, [rng.randn(1, 28, 28).astype(np.float32)
                           for _ in range(10)])
    np.testing.assert_array_equal(
        logits, np.stack([want[i]["logits"] for i in range(10)]))


def test_launcher_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(["--arch", "mnist_cnn", "--requests", "1"])


def test_launcher_refuses_unported_archs():
    """seamless-m4t-medium resolves now, but the Engine feeds a prefill
    no frames: the launcher refuses it there, as the reference's fails."""
    with pytest.raises(KeyError, match="frames"):
        launcher.main(["--arch", "seamless-m4t-medium", "--device", "cpu"])


# ------------------------------------------------------------ front-end

def test_scheduler_core_is_edf_then_fcfs():
    clock = VirtualClock()
    core = SchedulerCore(clock, max_queue=4)
    a = core.submit("a")
    b = core.submit("b", deadline_t=5.0)
    c = core.submit("c", deadline_t=5.0)
    d = core.submit("d", deadline_t=1.0)
    with pytest.raises(QueueFullError):
        core.submit("e")
    assert [r.payload for r in core.pick(3)] == ["d", "b", "c"]
    assert core.earliest_deadline_t() == math.inf
    core.requeue([b])
    assert [r.rid for r in core.pick(5)] == [b.rid, a.rid]
    assert (c.seq, d.seq) == (2, 3)


def test_frontend_holds_a_partial_bucket_while_slack_allows():
    model = PaperCNN()
    clock = VirtualClock()
    eng = VisionEngine(model, model.init(0, device="cpu"),
                       VisionEngineConfig(batch=4, device="cpu"),
                       clock=clock)
    fe = Frontend(VisionAdapter(eng), FrontendConfig(slo_s=10.0,
                                                     step_cost_s=1.0),
                  clock)
    img = np.zeros((1, 28, 28), np.float32)
    for _ in range(2):
        fe.submit(img)
    assert fe.step(flush=False) is False         # slack 10 s > 2 steps
    clock.advance(9.0)
    assert fe.step(flush=False) is True          # slack 1 s: dispatch
    assert fe.stats.completed == 2 and fe.stats.deadline_misses == 0
    fe.submit(img)
    fe.run_until_drained()
    assert fe.stats.completed == 3 and eng.stats.steps == 2


# --------------------------------------------------------- import boundary

def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    bad = {}
    for f in files:
        hits = [m for m in _imported_modules(f)
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        if hits:
            bad[str(f.relative_to(ROOT))] = hits
    assert not bad, bad
