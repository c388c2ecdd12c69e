"""The port's streaming spatial tiler (``repro_torch.stream``) and the
VGG-style ``highres_cnn`` against the JAX package, on the CPU.

Covers the halo math (the same band lists, streamed-row totals, tile
choices and ``check_tiling`` codes over a sweep), the ``SpatialTiling``
spec and its doc round trip, the placement pass (MNIST untiled at the
default budget; the 224² ``highres_cnn`` plans carry the reference's
tilings node for node and print alike — graphs only, no forward at
224²), the two stream executors against the port's untiled ops and the
JAX stream executors over the reference's (quant, k, s, h) sweep with
ragged last bands, ``VGGStyleCNN`` at 48² and 64² with small budgets
(eager, streamed plans fused and unfused) against the JAX model,
``VisionEngine`` on a streamed small ``highres_cnn``, and the launcher's
``--arch highres_cnn`` on the CPU.

Inputs are seeded numpy arrays; the JAX ``init`` crosses over through
``repro_torch.bridge``. The JAX side runs its ``xla`` backend: op by op
under int8, the reference's two-rounding arithmetic (its interpreted
fused Pallas kernel and its jitted programs contract the int8 requant
epilogue into an FMA on jax 0.9.0; see ``tests/test_torch_kernels.py``),
and under ``jax.jit`` in the other two modes, which compiles a reference
once instead of each op at each band's shape. Tolerances:

* int8 — bitwise: the convs sum integer-valued codes exactly, and the
  activation scale is taken once over the whole image. The one
  exception is the reference's jitted engine: rtol = atol = 1e-6 there,
  as in ``tests/test_torch_serve.py``, with the port's engine bitwise
  against the reference's eager forward.
* qformat — bitwise for a conv op (its sums of Q8.8 products are exact);
  within one Q8.8 step per logit for a model, whose fc sums are not.
* none — rtol = atol = 1e-5 (``TOL_FP32``), and equal labels where the
  top-two logit gap exceeds 1e-4: the port's streamed and untiled ops
  may sum in other orders than each other and than XLA.

The reference's ``TestFingerprint`` and ``TestStreamAutotune`` families
are ported beside the modules they test: ``tests/test_torch_artifact.py``
(the budget in the fingerprint, streamed roundtrips) and
``tests/test_torch_autotune.py`` (the ``th`` axis, its cache row and its
baking into a plan).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.vgg import VGGStyleCNN as JaxVGG
from repro.models.vgg import VGGStyleCNNConfig as JaxVGGConfig
from repro.ops import ExecPolicy as JPolicy
from repro.ops import fused_conv_block as j_fused
from repro.serve import VisionEngine as JaxVisionEngine
from repro.serve import VisionEngineConfig as JaxVisionEngineConfig
from repro.stream import tiling as jt
from repro.stream import stream_conv2d as j_stream_conv2d
from repro.stream import stream_fused_conv_block as j_stream_fused
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import serve as launcher
from repro_torch.models.cnn import PaperCNN
from repro_torch.models.vgg import VGGStyleCNN, VGGStyleCNNConfig
from repro_torch.ops import (ExecPolicy, conv2d, fused_conv_block,
                             use_policy)
from repro_torch.serve import VisionEngine, VisionEngineConfig
from repro_torch.stream import (STREAM_VMEM_BUDGET_BYTES, SpatialTiling,
                                band_input_rows, band_working_set,
                                choose_tile_rows, conv_bands, halo_rows,
                                image_working_set, place_spatial_tiling,
                                pooled_bands, resolve_tile_rows,
                                stream_conv2d, stream_fused_conv_block,
                                streamed_input_rows, tiling_from_doc,
                                tiling_to_doc)
from repro_torch.stream.tiling import check_tiling

MODES = ("none", "qformat", "int8")
TOL_FP32 = 1e-5
TOL_JIT_INT8 = 1e-6
QSTEP = 2.0 ** -8


def _tiled(plan) -> list:
    return [n for n in plan.graph if getattr(n, "tiling", None)]


def _docs(graph) -> list:
    return [tiling_to_doc(getattr(n, "tiling", None)) for n in graph]


def _jax(mode, fn, *args) -> np.ndarray:
    """``fn(*args)`` on the JAX side: op by op under int8, else jitted."""
    return np.asarray(fn(*args) if mode == "int8" else jax.jit(fn)(*args))


def _agree_op(mode, got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    if mode == "none":
        np.testing.assert_allclose(got, want, rtol=TOL_FP32, atol=TOL_FP32)
    else:
        np.testing.assert_array_equal(got, want)


def _agree_logits(mode, got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
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


# ------------------------------------------------------------ halo math

CONV_SWEEP = [(ho, tile, kh, sh) for ho in (1, 5, 8, 9, 13, 26, 220)
              for tile in (1, 2, 3, 7, 45, 300) for kh in (1, 2, 3, 5, 6)
              for sh in (1, 2)]
POOL_SWEEP = [(h, tile, kh, sh) for h in (13, 14, 15, 16, 28, 110, 224)
              for tile in (1, 2, 3, 4, 42, 45) for kh in (2, 3, 5, 6)
              for sh in (1, 2) if h >= kh]


@pytest.mark.parametrize("ho", [1, 5, 8, 9, 13, 26, 220])
def test_conv_bands_match_reference(ho):
    for _, tile, kh, sh in (c for c in CONV_SWEEP if c[0] == ho):
        bands = conv_bands(ho, tile, kh, sh)
        assert bands == jt.conv_bands(ho, tile, kh, sh)
        assert streamed_input_rows(ho, tile, kh, sh) == \
            jt.streamed_input_rows(ho, tile, kh, sh)
        # the band law: outputs partition [0, ho), each band reads
        # (rb-1)·sh + kh rows, adjacent bands overlap on the halo
        assert bands[0][0] == 0 and bands[-1][1] == ho
        for lo, hi, in_lo, in_hi in bands:
            assert in_hi - in_lo == band_input_rows(hi - lo, kh, sh)
        for (_, _, _, hi0), (_, _, lo1, _) in zip(bands, bands[1:]):
            assert hi0 - lo1 == halo_rows(kh, sh) or kh < sh
        nb = len(bands)
        assert streamed_input_rows(ho, tile, kh, sh) == \
            (ho - 1) * sh + kh + (nb - 1) * (kh - sh)


@pytest.mark.parametrize("h", [13, 14, 15, 16, 28, 110, 224])
def test_pooled_bands_match_reference(h):
    for _, tile, kh, sh in (c for c in POOL_SWEEP if c[0] == h):
        ho = (h - kh) // sh + 1
        for po in {max(ho // 2, 1), (ho + 1) // 2}:
            bands = pooled_bands(po, tile, kh, sh, h)
            assert bands == jt.pooled_bands(po, tile, kh, sh, h)
            assert bands[0][0] == 0 and bands[-1][1] == po
            for p0, _, in_lo, in_hi in bands:
                assert in_lo == 2 * p0 * sh and in_hi <= h


def test_band_helpers_refuse_empty_bands():
    for fn, args in ((band_input_rows, (0, 3)), (conv_bands, (9, 0, 3)),
                     (pooled_bands, (4, 0, 3, 1, 13))):
        with pytest.raises(ValueError):
            fn(*args)


@pytest.mark.parametrize("pooled", [True, False])
@pytest.mark.parametrize("budget", [1, 20_000, 50_000, 1 << 20, 1 << 40])
def test_choose_tile_rows_matches_reference(budget, pooled):
    for n, h, w, m, k, sh in ((3, 224, 224, 8, 5, 1), (8, 110, 110, 16, 3, 1),
                              (16, 54, 54, 32, 3, 1), (1, 28, 28, 15, 3, 1),
                              (15, 13, 13, 20, 6, 1), (3, 33, 41, 5, 3, 2)):
        got = choose_tile_rows(n, h, w, m, k, k, (sh, sh), 4,
                               pooled=pooled, budget=budget)
        assert got == jt.choose_tile_rows(n, h, w, m, k, k, (sh, sh), 4,
                                          pooled=pooled, budget=budget)
        wo = (w - k) // sh + 1
        assert got >= 1
        if got > 1:
            assert band_working_set(n, w, m, wo, got, k, sh, 4,
                                    pooled=pooled) <= budget
        ho = (h - k) // sh + 1
        assert image_working_set(n, h, w, m, ho, wo, 4) == \
            jt.image_working_set(n, h, w, m, ho, wo, 4)


# (tile_rows, halo, pooled, budget) against a stage: legal specs, a wrong
# halo, a pooled flag on the wrong family, a band over its budget
CHECK_SPECS = [(45, 4, True, 1 << 20), (45, 2, True, 1 << 20),
               (45, 4, False, 1 << 20), (100, 4, True, 1 << 20),
               (1, 4, True, 1), (3, 4, True, 10), (110, 4, True, 1 << 20),
               (106, 4, False, 1 << 20), (7, 2, False, 50_000)]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("spec", CHECK_SPECS)
def test_check_tiling_codes_match_reference(spec, fused):
    tr, halo, pooled, budget = spec
    mine = SpatialTiling(tr, halo, pooled, budget)
    ref = jt.SpatialTiling(tr, halo, pooled, budget)
    for in_shape, w_shape in (((8, 3, 224, 224), (8, 3, 5, 5)),
                              ((8, 8, 110, 110), (16, 8, 3, 3)),
                              ((2, 3, 13, 15), (4, 3, 5, 5))):
        kw = dict(fused=fused, in_shape=in_shape, w_shape=w_shape,
                  stride=(1, 1), itemsize=4)
        got = check_tiling(mine, **kw)
        assert [c for c, _ in got] == [c for c, _ in jt.check_tiling(ref,
                                                                     **kw)]
        if halo != w_shape[2] - 1:
            assert "stream-halo" in [c for c, _ in got]
        if pooled != fused:
            assert [c for c, _ in got][-1] == "stream-pool-straddle"


def test_spec_validation_and_doc_roundtrip():
    with pytest.raises(ValueError, match="tile_rows"):
        SpatialTiling(tile_rows=0, halo=2)
    with pytest.raises(ValueError, match="halo"):
        SpatialTiling(tile_rows=2, halo=-1)
    spec = SpatialTiling(tile_rows=7, halo=4, pooled=True,
                         budget_bytes=50_000)
    ref = jt.SpatialTiling(tile_rows=7, halo=4, pooled=True,
                           budget_bytes=50_000)
    assert tiling_from_doc(tiling_to_doc(spec)) == spec
    assert tiling_to_doc(spec) == jt.tiling_to_doc(ref)
    assert str(spec) == str(ref) == "7p halo=4"
    assert str(SpatialTiling(106, 4)) == str(jt.SpatialTiling(106, 4))
    assert tiling_to_doc(None) is None and tiling_from_doc(None) is None
    assert SpatialTiling(3, 2).budget_bytes == STREAM_VMEM_BUDGET_BYTES \
        == jt.STREAM_VMEM_BUDGET_BYTES == 1 << 20


# ------------------------------------------------------------ placement

def test_mnist_stays_untiled_at_default_budget():
    for mode in MODES:
        for fuse in (True, False):
            plan = PaperCNN().compile(ExecPolicy(quant=mode), fuse=fuse)
            assert not _tiled(plan)
            assert " tile=" not in plan.pretty()


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_highres_plan_carries_the_reference_tilings(mode, fuse):
    """The 224² plans, graphs only: the same tiling on every node, and
    the same printout."""
    plan = get_arch("highres_cnn").model().compile(
        ExecPolicy(quant=mode), fuse=fuse, batch=8)
    jplan = JaxVGG(JaxVGGConfig()).compile(
        JPolicy(quant=mode), fuse=fuse, batch=8, verify=False)
    assert _docs(plan.graph) == _docs(jplan.graph)
    assert plan.pretty() == jplan.pretty()
    tiled = _tiled(plan)
    assert [n.w.path[0] for n in tiled] == ["block0", "block1"]
    if fuse:
        assert [(n.tiling.tile_rows, n.tiling.halo) for n in tiled] == \
            [(45, 4), (42, 2)]
        assert all(n.tiling.pooled for n in tiled)
    else:
        assert not any(n.tiling.pooled for n in tiled)


def test_budget_knob():
    model = VGGStyleCNN(VGGStyleCNNConfig(img_size=64))
    assert not _tiled(model.compile(stream_budget=1 << 40))
    tiled = model.compile(stream_budget=50_000)
    assert _tiled(tiled)
    assert all(n.tiling.budget_bytes == 50_000 for n in _tiled(tiled))
    jtiled = JaxVGG(JaxVGGConfig(img_size=64)).compile(
        stream_budget=50_000, verify=False)
    assert _docs(tiled.graph) == _docs(jtiled.graph)
    # an MNIST plan under a budget its stages exceed streams as well
    assert len(_tiled(PaperCNN().compile(stream_budget=10_000))) == 2


def test_pass_is_idempotent_and_skips_fitting_stages():
    plan = VGGStyleCNN(VGGStyleCNNConfig(img_size=64)).compile(
        stream_budget=50_000)
    g2 = place_spatial_tiling(plan.graph, budget_bytes=50_000)
    assert _docs(g2) == _docs(plan.graph)
    assert _docs(place_spatial_tiling(plan.graph)) == _docs(plan.graph)
    # blocks 2 and 3 fit: left untiled
    assert [n.w.path[0] for n in _tiled(plan)] == ["block0", "block1"]


def test_config_matches_reference():
    for img in (48, 64, 224):
        cfg, jcfg = VGGStyleCNNConfig(img_size=img), JaxVGGConfig(
            img_size=img)
        assert cfg.feature_sizes() == jcfg.feature_sizes()
        assert cfg.fc_in() == jcfg.fc_in()
        assert cfg.flops_per_image() == jcfg.flops_per_image()
        assert cfg.param_count() == jcfg.param_count()
    assert VGGStyleCNNConfig().param_count() == 61_754
    assert VGGStyleCNNConfig().flops_per_image() == 120_582_912
    for img in (50, 40):                        # an odd pre-pool map
        with pytest.raises(ValueError, match="odd"):
            VGGStyleCNNConfig(img_size=img)
    with pytest.raises(ValueError, match="larger"):
        VGGStyleCNNConfig(img_size=4)


def test_arch_registry_and_init():
    spec = get_arch("highres_cnn")
    model = spec.model()
    assert isinstance(model, VGGStyleCNN) and spec.family == "cnn"
    assert model.input_shape(8) == (8, 3, 224, 224)
    # the reference's rule: both CNNs stay out of the LM arch list
    assert "highres_cnn" not in ARCH_IDS and "mnist_cnn" not in ARCH_IDS
    assert ARCH_IDS == [a for a in ARCH_IDS if get_arch(a).family != "cnn"]
    a = model.init(7, device="cpu")
    b = model.init(torch.Generator().manual_seed(7), device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda t: tuple(t.shape),
        jax.eval_shape(JaxVGG(JaxVGGConfig()).init, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), a) == jshapes
    assert all(torch.equal(a[k]["w"], b[k]["w"]) for k in ("block0",
                                                           "block3"))
    assert a["fc_w"].device.type == "cpu"
    assert not torch.equal(a["fc_w"], model.init(8, device="cpu")["fc_w"])


# ---------------------------------------------------- stream executors

def _operands(k, h, wd, seed=0):
    rng = np.random.RandomState(seed + 10 * k + h)
    x = rng.randn(2, 3, h, wd).astype(np.float32)
    w = (rng.randn(4, 3, k, k) * (3 * k * k) ** -0.5).astype(np.float32)
    b = (rng.randn(4) * 0.1).astype(np.float32)
    return x, w, b


# the reference's sweep; with tile_rows = 2 the K = 5 and stride-2 cases
# leave a ragged last band
CONV_CASES = [(3, 1, 13), (3, 2, 13), (5, 1, 13), (5, 2, 13), (3, 1, 14)]
_JAX_STREAM_CONV: dict = {}        # one reference result per case
FUSED_CASES = [(3, 1, 13), (3, 2, 13), (5, 1, 13), (5, 2, 15), (3, 1, 16)]


@pytest.mark.parametrize("backend", [None, "cuda"])
@pytest.mark.parametrize("k,s,h", CONV_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_stream_conv2d_matches_untiled_and_reference(mode, k, s, h,
                                                     backend):
    """``cuda`` names the kernel's backend, whose wrapper takes its plain
    version on a CPU tensor."""
    x, w, b = _operands(k, h, h + 2)
    tiling = SpatialTiling(tile_rows=2, halo=halo_rows(k, s))
    pol = ExecPolicy(backend=backend, quant=mode)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = stream_conv2d(tx, tw, tb, stride=(s, s), tiling=tiling,
                        policy=pol).numpy()
    untiled = conv2d(tx, tw, tb, stride=(s, s), policy=pol).numpy()
    key = (mode, k, s, h)
    if key not in _JAX_STREAM_CONV:
        _JAX_STREAM_CONV[key] = _jax(mode, functools.partial(
            j_stream_conv2d, stride=(s, s),
            tiling=jt.SpatialTiling(tile_rows=2, halo=halo_rows(k, s)),
            policy=JPolicy(backend="xla", quant=mode)), x, w, b)
    want = _JAX_STREAM_CONV[key]
    _agree_op(mode, got, untiled)
    _agree_op(mode, got, want)


@pytest.mark.parametrize("k,s,h", FUSED_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_stream_fused_matches_untiled_and_reference(mode, k, s, h):
    """Pooled bands, ragged last bands and odd='drop' trailing rows."""
    x, w, b = _operands(k, h, h)
    tiling = SpatialTiling(tile_rows=2, halo=halo_rows(k, s), pooled=True)
    pol = ExecPolicy(quant=mode)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = stream_fused_conv_block(tx, tw, tb, stride=(s, s), odd="drop",
                                  tiling=tiling, policy=pol).numpy()
    untiled = fused_conv_block(tx, tw, tb, stride=(s, s), odd="drop",
                               policy=pol).numpy()
    want = _jax(mode, functools.partial(
        j_stream_fused, stride=(s, s), odd="drop",
        tiling=jt.SpatialTiling(tile_rows=2, halo=halo_rows(k, s),
                                pooled=True),
        policy=JPolicy(backend="xla", quant=mode)), x, w, b)
    _agree_op(mode, got, untiled)
    _agree_op(mode, got, want)


@pytest.mark.parametrize("mode", MODES)
def test_stream_fused_through_the_kernel_backend(mode):
    """Every band's conv map even (16 → 14 rows, 2-row pooled bands), so
    the ``cuda`` backend takes each band."""
    x, w, b = _operands(3, 16, 16)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    pol = ExecPolicy(backend="cuda", quant=mode)
    got = stream_fused_conv_block(
        tx, tw, tb, tiling=SpatialTiling(2, 2, pooled=True),
        policy=pol).numpy()
    _agree_op(mode, got, fused_conv_block(tx, tw, tb, policy=pol).numpy())
    _agree_op(mode, got, _jax(mode, functools.partial(
        j_fused, policy=JPolicy(backend="xla", quant=mode)), x, w, b))


def test_single_band_passthrough_and_ambient_policy():
    x, w, b = (torch.from_numpy(a) for a in _operands(3, 9, 9))
    got = stream_fused_conv_block(x, w, b, odd="drop",
                                  tiling=SpatialTiling(64, 2, pooled=True))
    assert torch.equal(got, fused_conv_block(x, w, b, odd="drop"))
    with use_policy(ExecPolicy(quant="qformat")):
        got = stream_conv2d(x, w, None, tiling=SpatialTiling(4, 2))
        want = conv2d(x, w, None)
    assert torch.equal(got, want)


def test_tile_height_override_beats_the_spec():
    """``stream_*.th`` (the stream's band height) is resolved apart from
    the conv kernels' own ``*.band`` key, and the result is unchanged."""
    x, w, b = (torch.from_numpy(a) for a in _operands(3, 16,
                                                      16))
    spec = SpatialTiling(2, 2, pooled=True)
    base = ExecPolicy(quant="qformat")
    assert resolve_tile_rows("stream_fused_conv_block", x, w, (1, 1), spec,
                             base) == 2
    for tiling, th in (({"stream_fused_conv_block.th": 3}, 3),
                       ({"stream_conv2d.th": 5}, 2),
                       ({"fused_conv_block.band": 4}, 2),
                       ({"th": 0}, 1)):
        pol = base.with_options(tiling=tiling)
        assert resolve_tile_rows("stream_fused_conv_block", x, w, (1, 1),
                                 spec, pol) == th
        got = stream_fused_conv_block(x, w, b, tiling=spec, policy=pol)
        assert torch.equal(got, fused_conv_block(x, w, b, policy=base))


def test_int8_scale_is_taken_over_the_whole_image():
    """A band whose own absmax is smaller than the image's must still
    use the image's scale: streamed == untiled bitwise."""
    x, w, b = _operands(3, 16, 16)
    x[:, :, :4] *= 20.0                    # the first band holds the max
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    pol = ExecPolicy(quant="int8")
    got = stream_conv2d(tx, tw, tb, tiling=SpatialTiling(2, 2), policy=pol)
    assert torch.equal(got, conv2d(tx, tw, tb, policy=pol))


# ------------------------------------------------------------- the model

class Reference:
    """The JAX ``VGGStyleCNN.init`` weights (seeded nonzero biases) and
    images, per image size, with the JAX results computed once."""

    def __init__(self):
        self._cache: dict = {}

    def weights(self, img: int):
        key = ("w", img)
        if key not in self._cache:
            params = jax.jit(JaxVGG(JaxVGGConfig(img_size=img)).init)(
                jax.random.PRNGKey(img))
            np_params = jax.tree_util.tree_map(np.asarray, params)
            rng = np.random.RandomState(img)
            for i, (m, _) in enumerate(JaxVGGConfig().blocks):
                np_params[f"block{i}"]["b"] = (rng.randn(m) * 0.1).astype(
                    np.float32)
            np_params["fc_b"] = (rng.randn(10) * 0.1).astype(np.float32)
            x = rng.randn(2, 3, img, img).astype(np.float32)
            self._cache[key] = (np_params, x)
        return self._cache[key]

    def jax_logits(self, img, mode, kind, budget=None):
        key = (img, mode, kind, budget)
        if key not in self._cache:
            np_params, x = self.weights(img)
            model = JaxVGG(JaxVGGConfig(img_size=img, policy=JPolicy(
                backend="xla", quant=mode)))
            jp = jax.tree_util.tree_map(jnp.asarray, np_params)
            if kind == "eager":
                fn = functools.partial(model.forward, jp)
            else:
                plan = model.compile(batch=2, fuse=kind == "fused",
                                     stream_budget=budget, verify=False)
                assert _tiled(plan)
                bound = plan.bind(jp)

                def fn(v):      # jit hashes its function; a BoundPlan
                    return bound(v)     # holds a dict, so wrap it
            self._cache[key] = _jax(mode, fn, x)
        return self._cache[key]


@pytest.fixture(scope="module")
def ref() -> Reference:
    return Reference()


def _port_model(img, mode):
    return VGGStyleCNN(VGGStyleCNNConfig(img_size=img,
                                         policy=ExecPolicy(quant=mode)))


@pytest.mark.parametrize("mode", MODES)
def test_vgg_eager_matches_reference(ref, mode):
    """At 48²; at 64² the eager forward is held to the streamed plans,
    and they to the reference's, in the next test."""
    img = 48
    np_params, x = ref.weights(img)
    with torch.inference_mode():
        got = _port_model(img, mode).forward(
            params_from_numpy(np_params, "cpu"), torch.from_numpy(x))
    _agree_logits(mode, got.numpy(), ref.jax_logits(img, mode, "eager"))


# image size, budget, fusion: each leaves block 0 and block 1 in bands
# with a ragged last one (48² fused: pooled bands of 8, 8, 6 and 8, 2
# rows; unfused: conv bands of 19, 19, 6 and 19, 1 rows)
@pytest.mark.parametrize("img,budget,fuse", [(48, 40_000, True),
                                             (48, 40_000, False),
                                             (64, 50_000, True)])
@pytest.mark.parametrize("mode", MODES)
def test_vgg_streamed_plan_matches_untiled_and_reference(ref, mode, img,
                                                         budget, fuse):
    np_params, x = ref.weights(img)
    params = params_from_numpy(np_params, "cpu")
    model = _port_model(img, mode)
    streamed = model.compile(batch=2, fuse=fuse, stream_budget=budget)
    untiled = model.compile(batch=2, fuse=fuse, stream_budget=1 << 40)
    assert len(_tiled(streamed)) == 2 and not _tiled(untiled)
    with torch.inference_mode():
        got = streamed.bind(params)(torch.from_numpy(x)).numpy()
        flat = untiled.bind(params)(torch.from_numpy(x)).numpy()
        eager = model.forward(params, torch.from_numpy(x)).numpy()
    _agree_logits(mode, got, flat)
    if mode != "none":      # the exact formats: streamed == eager bitwise
        np.testing.assert_array_equal(got, eager)
    kind = "fused" if fuse else "unfused"
    _agree_logits(mode, got, ref.jax_logits(img, mode, kind, budget))


class _Streamed(VGGStyleCNN):
    """48² highres_cnn whose plans stream under a small budget."""

    def compile(self, *args, **kwargs):
        return super().compile(*args, stream_budget=40_000, **kwargs)


class _JaxStreamed(JaxVGG):
    def compile(self, *args, **kwargs):
        return super().compile(*args, stream_budget=40_000, **kwargs)


@pytest.mark.parametrize("mode", MODES)
def test_vision_engine_serves_streamed_plans(ref, mode):
    """One bucket of 4 on both sides: the int8 activation scale is taken
    over the whole served batch, so both must batch alike."""
    np_params, _ = ref.weights(48)
    rng = np.random.RandomState(5)
    images = [rng.randn(3, 48, 48).astype(np.float32) for _ in range(5)]
    cfg = VGGStyleCNNConfig(img_size=48)
    eng = VisionEngine(_Streamed(cfg), params_from_numpy(np_params, "cpu"),
                       VisionEngineConfig(batch=4,
                                          policy=ExecPolicy(quant=mode),
                                          device="cpu"))
    assert len(_tiled(eng.plan)) == 2 and eng.buckets == (4,)
    for img in images:
        eng.submit(img)
    res = eng.run()
    got = np.stack([res[i]["logits"] for i in range(5)])
    jeng = JaxVisionEngine(
        _JaxStreamed(JaxVGGConfig(img_size=48)),
        jax.tree_util.tree_map(jnp.asarray, np_params),
        JaxVisionEngineConfig(batch=4,
                              policy=JPolicy(backend="xla", quant=mode)))
    for img in images:
        jeng.submit(img)
    jres = jeng.run()
    want = np.stack([np.asarray(jres[i]["logits"]) for i in range(5)])
    if mode == "int8":
        np.testing.assert_allclose(got, want, rtol=TOL_JIT_INT8,
                                   atol=TOL_JIT_INT8)
        # the port's full batch bitwise against the reference's eager
        # forward, which keeps the two roundings
        jmodel = JaxVGG(JaxVGGConfig(img_size=48, policy=JPolicy(
            backend="xla", quant=mode)))
        eager = np.asarray(jmodel.forward(
            jax.tree_util.tree_map(jnp.asarray, np_params),
            jnp.asarray(np.stack(images[:4]))))
        np.testing.assert_array_equal(got[:4], eager)
    else:
        _agree_logits(mode, got, want)
    assert [res[i]["label"] for i in range(5)] == \
        [int(np.argmax(got[i])) for i in range(5)]


def test_launcher_serves_highres_on_cpu(capsys, monkeypatch):
    """``--arch highres_cnn --device cpu`` through ``serve_vision``
    unchanged; the arch's config is cut to 48² with a small budget so no
    224² forward runs here (the card runs the full size)."""
    import repro_torch.configs.highres_cnn as arch
    monkeypatch.setattr(arch, "CONFIG", VGGStyleCNNConfig(img_size=48))
    monkeypatch.setattr(
        "repro_torch.stream.passes.STREAM_VMEM_BUDGET_BYTES", 40_000)
    engine, results = launcher.main(["--arch", "highres_cnn", "--capacity",
                                     "2", "--requests", "3", "--device",
                                     "cpu"])
    out = capsys.readouterr().out
    assert "arch=highres_cnn" in out and "served 3 images" in out
    assert len(_tiled(engine.plan)) == 2
    assert engine.plan.num_fused() == 4 and engine.buckets == (1, 2)
    logits = np.stack([results[i]["logits"] for i in range(3)])
    assert logits.shape == (3, 10) and np.isfinite(logits).all()
    # the same seeded weights and images through the engine directly
    model = VGGStyleCNN(VGGStyleCNNConfig(img_size=48))
    direct = VisionEngine(model, model.init(0, device="cpu"),
                          VisionEngineConfig(batch=2, buckets="auto",
                                             device="cpu"))
    rng = np.random.RandomState(1)
    for _ in range(3):
        direct.submit(rng.randn(3, 48, 48).astype(np.float32))
    want = direct.run()
    np.testing.assert_array_equal(
        logits, np.stack([want[i]["logits"] for i in range(3)]))
