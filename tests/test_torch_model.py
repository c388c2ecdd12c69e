"""The paper CNN in the port against the JAX package: eager forward,
compiled plans and their lowered graphs, in all three number formats.

Both packages run the weights of the JAX ``PaperCNN.init`` (biases
replaced by seeded nonzero ones, so every epilogue is exercised), handed
to the port through ``repro_torch.bridge``, on the same seeded images.
The JAX side runs its Pallas kernels in interpret mode
(``ExecPolicy(backend="pallas")``), as its own tests do. Tolerances:

* int8  — bitwise. The interpreted fused Pallas kernel contracts its
  requant epilogue into one FMA on jax 0.9.0 (see
  ``tests/test_torch_kernels.py``), which can move a requantized code of
  the next layer by one step, so fused int8 plans are held against the
  reference's two-rounding arithmetic: its eager forward and its ``xla``
  backend.
* qformat — within one Q8.8 lattice step per logit, with the count of
  differing elements in the message.
* none  — rtol = atol = 1e-5, and equal labels wherever the top-two logit
  gap exceeds 1e-4: fp32 sums run in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.cnn import PaperCNN as JaxCNN
from repro.models.cnn import PaperCNNConfig as JaxCNNConfig
from repro.ops import ExecPolicy as JPolicy
from repro_torch.bridge import params_from_numpy
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.graph.ir import QuantizeNode
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
from repro_torch.ops import ExecPolicy

MODES = ("none", "qformat", "int8")
TOL_FP32 = 1e-5
QSTEP = 2.0 ** -8
BATCH = 3


def _jax_model(mode: str, backend: str = "pallas") -> JaxCNN:
    return JaxCNN(JaxCNNConfig(policy=JPolicy(backend=backend, quant=mode)))


def _port_model(mode: str, backend: str | None = None) -> PaperCNN:
    return PaperCNN(PaperCNNConfig(policy=ExecPolicy(backend=backend,
                                                     quant=mode)))


class Reference:
    """Shared weights and images, and the JAX results, each computed once
    per module."""

    def __init__(self):
        params = JaxCNN(JaxCNNConfig()).init(jax.random.PRNGKey(0))
        self.np_params = jax.tree_util.tree_map(np.asarray, params)
        rng = np.random.RandomState(0)
        for name, m in (("conv1", 15), ("conv2", 20)):
            self.np_params[name]["b"] = (rng.randn(m) * 0.1).astype(
                np.float32)
        self.np_params["fc_b"] = (rng.randn(10) * 0.1).astype(np.float32)
        self.jax_params = jax.tree_util.tree_map(jnp.asarray,
                                                 self.np_params)
        self.params = params_from_numpy(self.np_params, "cpu")
        self.x = rng.randn(BATCH, 1, 28, 28).astype(np.float32)
        self._cache: dict = {}

    def jax_eager(self, mode: str) -> np.ndarray:
        key = ("eager", mode)
        if key not in self._cache:
            self._cache[key] = np.asarray(_jax_model(mode).forward(
                self.jax_params, jnp.asarray(self.x)))
        return self._cache[key]

    def jax_plan(self, mode: str, fuse: bool, backend: str = "pallas"):
        key = ("plan", mode, fuse, backend)
        if key not in self._cache:
            plan = _jax_model(mode, backend).compile(fuse=fuse, batch=BATCH)
            self._cache[key] = (plan, np.asarray(
                plan.bind(self.jax_params)(jnp.asarray(self.x))))
        return self._cache[key]


@pytest.fixture(scope="module")
def ref() -> Reference:
    return Reference()


def assert_logits_agree(mode: str, got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape == (BATCH, 10)
    assert got.dtype == want.dtype == np.float32
    if mode == "int8":
        np.testing.assert_array_equal(got, want)
    elif mode == "qformat":
        diff = np.abs(got - want)
        assert diff.max() <= QSTEP, (
            f"{int((diff > 0).sum())} logits differ, max {diff.max()}")
    else:
        np.testing.assert_allclose(got, want, rtol=TOL_FP32, atol=TOL_FP32)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])


@pytest.mark.parametrize("backend", [None, "cuda"])
@pytest.mark.parametrize("mode", MODES)
def test_eager_forward_matches_reference(ref, mode, backend):
    """Auto-selection on the CPU runs the ``torch`` backend; naming
    ``cuda`` runs the kernels' wrappers, which take their plain version
    on a CPU tensor."""
    with torch.inference_mode():
        got = _port_model(mode, backend).forward(
            ref.params, torch.from_numpy(ref.x)).numpy()
    assert_logits_agree(mode, got, ref.jax_eager(mode))


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_compiled_plan_matches_reference(ref, mode, fuse):
    model = _port_model(mode)
    with torch.inference_mode():
        got = model.compile(fuse=fuse, batch=BATCH).bind(ref.params)(
            torch.from_numpy(ref.x)).numpy()
        eager = model.forward(ref.params, torch.from_numpy(ref.x)).numpy()
    if mode == "int8" and fuse:
        assert_logits_agree(mode, got, ref.jax_eager(mode))
        assert_logits_agree(mode, got,
                            ref.jax_plan(mode, fuse, backend="xla")[1])
    else:
        assert_logits_agree(mode, got, ref.jax_plan(mode, fuse)[1])
    if mode != "none":     # the exact modes: plan == eager bitwise
        np.testing.assert_array_equal(got, eager)


def _node_summary(node) -> tuple:
    return (node.op, node.id, tuple(node.inputs), tuple(node.out.shape),
            getattr(node, "kind", None), getattr(node, "constant", None),
            str(getattr(node, "ref", None)), getattr(node, "odd", None))


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_lowered_graph_matches_reference(ref, mode, fuse):
    plan = _port_model(mode).compile(fuse=fuse, batch=BATCH)
    jplan = ref.jax_plan(mode, fuse)[0]
    assert [_node_summary(n) for n in plan.graph] == \
        [_node_summary(n) for n in jplan.graph]
    assert plan.graph.output_id == jplan.graph.output_id
    assert plan.num_fused() == (2 if fuse else 0)
    assert plan.quant == mode
    kinds = {n.kind for n in plan.graph if isinstance(n, QuantizeNode)}
    assert kinds == {"none": set(), "qformat": {"qformat"},
                     "int8": {"int8_act", "int8_conv_weight"}}[mode]


def test_plan_refuses_another_number_format(ref):
    bound = _port_model("int8").compile(batch=BATCH).bind(ref.params)
    with pytest.raises(ValueError):
        bound(torch.from_numpy(ref.x), policy=ExecPolicy(quant="qformat"))


@pytest.mark.parametrize("option", [{"mesh": object()}, {"autotune": True},
                                    {"verify": True}])
def test_unported_compile_options_raise(option):
    """A mesh must be a ``DeviceMesh`` with a ``model`` axis (placed plans
    are held in ``tests/test_torch_mesh.py``); ``autotune`` and ``verify``
    compile as the reference's do."""
    if "mesh" in option:
        with pytest.raises(ValueError, match="no 'model' axis"):
            PaperCNN().compile(**option)
    else:
        plan = PaperCNN().compile(**option)
        assert plan.autotune == option.get("autotune", False)


def test_config_counts_match_reference():
    jcfg, cfg = JaxCNNConfig(), PaperCNNConfig()
    assert cfg.param_count() == jcfg.param_count() == 14180
    assert cfg.flops_per_image() == jcfg.flops_per_image()
    assert cfg.feature_sizes() == jcfg.feature_sizes()


def test_bridge_keeps_the_jax_layout(ref):
    p = ref.params
    assert tuple(p["conv1"]["w"].shape) == (15, 1, 3, 3)
    assert tuple(p["conv2"]["w"].shape) == (20, 15, 6, 6)
    assert tuple(p["conv2"]["b"].shape) == (20,)
    assert tuple(p["fc_w"].shape) == (320, 10)
    assert tuple(p["fc_b"].shape) == (10,)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in (p["conv1"]["w"], p["fc_w"], p["fc_b"]))
    with pytest.raises(TypeError):
        params_from_numpy({"w": np.zeros(3, np.int32)}, "cpu")


def test_init_is_seeded_and_on_the_named_device():
    a = PaperCNN().init(7, device="cpu")
    b = PaperCNN().init(torch.Generator().manual_seed(7), device="cpu")
    assert torch.equal(a["conv2"]["w"], b["conv2"]["w"])
    assert torch.equal(a["fc_w"], b["fc_w"])
    assert not torch.equal(a["fc_w"], PaperCNN().init(8, device="cpu")
                           ["fc_w"])
    assert float(a["fc_w"].abs().max()) <= 2 / np.sqrt(320) + 1e-7


def test_default_device_is_the_card():
    """Entry points default to cuda; without a card the default raises
    instead of quietly running on the CPU."""
    assert DEFAULT_DEVICE == "cuda"
    if torch.cuda.is_available():
        assert PaperCNN().init()["fc_w"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        PaperCNN().init()
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({"w": np.zeros(3, np.float32)}, DEFAULT_DEVICE)
