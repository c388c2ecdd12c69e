"""The conv kernels' int8 route on the CPU: its launch keys, its wrappers'
argument checks, its plain versions against JAX, and the int8 codes that
the op layer, the streamed bands, the placed stages and the autotuner hand
the ``fused_conv_block`` and ``conv2d`` backends.

Under ``int8`` every conv entry point splits its QTensor operands with
``split_int8``: the codes stay ``torch.int8``, so on the card the kernels
contract them on the s8 tensor cores with no cast. On the CPU the plain
backends cast them themselves (``f32_codes``), so every int8 result here
is bitwise to the JAX package's ``split_requant`` + reference conv, as
before. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_window.ops import conv2d_window as j_conv_window
from repro.models.cnn import PaperCNN as JaxCNN
from repro.models.cnn import PaperCNNConfig as JaxCNNConfig
from repro.models.vgg import VGGStyleCNN as JaxVGG
from repro.models.vgg import VGGStyleCNNConfig as JaxVGGConfig
from repro.ops import ExecPolicy as JPolicy
from repro.ops import quantize_conv_int8 as j_quantize_conv_int8
from repro.ops import split_requant as j_split_requant
from repro_torch.bridge import params_from_numpy
from repro_torch.core.quantize import QTensor, f32_codes
from repro_torch.kernels.conv_window import ops as cw_ops
from repro_torch.kernels.conv_window.ref import conv2d_window_ref
from repro_torch.kernels.fused_cwp import ops as fc_ops
from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
from repro_torch.launch.op_stats import OpCounter
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
from repro_torch.models.vgg import VGGStyleCNN, VGGStyleCNNConfig
from repro_torch.ops import (REGISTRY, ExecPolicy, conv2d, fused_conv_block,
                             quantize_conv_int8, register, split_int8,
                             split_requant, tiling)
from repro_torch.stream import stream_conv2d, stream_fused_conv_block
from repro_torch.stream.tiling import SpatialTiling

PALLAS = JPolicy(backend="pallas")
META = torch.device("meta")
# (N, H, W, M, K) of the paper CNN's convs and every launch shape of
# highres_cnn's 224² streamed plan: block 0's 94- and 44-row bands, block
# 1's 86- and 26-row bands, blocks 2 and 3, and the odd 95-row band
SHAPES = {"conv1": (1, 28, 28, 15, 3), "conv2": (15, 13, 13, 20, 6),
          "block0 94": (3, 94, 224, 8, 5), "block0 44": (3, 44, 224, 8, 5),
          "block1 86": (8, 86, 110, 16, 3), "block1 26": (8, 26, 110, 16, 3),
          "block2": (16, 54, 54, 32, 3), "block3": (32, 26, 26, 32, 3),
          "odd band": (3, 95, 224, 8, 5)}
S8_KEYS = {"cpb", "band", "items"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(shape, bsz=2, seed=0):
    """(QTensor x, QTensor w, b) of one conv shape, quantized as the op
    layer does."""
    n, h, w_, m, k = shape
    rng = np.random.RandomState(seed)
    x = _t(rng.randn(bsz, n, h, w_).astype(np.float32))
    w = _t((rng.randn(m, n, k, k) / np.sqrt(n * k * k)).astype(np.float32))
    b = _t((rng.randn(m) * 0.1).astype(np.float32))
    return (*quantize_conv_int8(x, w), b)


# ------------------------------------------------------ the launch keys

@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("bsz", [1, 8, 1024])
def test_chooser_keys_fit_and_fill_the_card(name, bsz):
    """At the paper's and the 224² shapes the int8 chooser gives every
    key, channels in 8s up to 32 and no more than M rounded up to 8, a
    slab under half the shared memory (so two blocks
    share an SM), and at least 66 blocks (half the SMs: fewer, fuller
    blocks won the sweep at B = 8) wherever one-row bands of 8 channels
    can give that many."""
    n, h, w, m, k = SHAPES[name]
    odd = "pad" if name == "odd band" else "raise"
    t = tiling.choose_conv_s8_blocks(bsz, n, h, w, m, k, k, 1, 1, odd=odd)
    assert set(t) == S8_KEYS
    assert t["cpb"] % 8 == 0 and 8 <= t["cpb"] <= min(32, -(-m // 8) * 8)
    smem = tiling.conv_s8_smem_bytes(n, h, w, k, k, 1, t["cpb"], t["band"],
                                     t["items"])
    assert smem <= tiling.SMEM_MAX // 2
    po = ((h - k + 1) + (odd == "pad")) // 2
    # counted an item a block: a block then takes more items only where
    # the depth is too shallow for the warps to share
    blocks = bsz * -(-po // t["band"]) * -(-m // t["cpb"])
    most = bsz * po * -(-m // 8)
    assert blocks >= min(tiling.H100_SMS // 2, most)


@pytest.mark.parametrize("bsz,name,want", [
    # rows: (cpb, band, items)
    (8, "conv1", (8, 2, 2)),        # 1 k-step: items, not depth
    (8, "conv2", (8, 1, 1)),        # 23 k-steps shared by warps
    (1024, "conv1", (16, 13, 2)),   # 2 whole images a block
    (1024, "conv2", (24, 4, 4)),    # 4 images a block
    (8, "block0 94", (8, 1, 1)),    # 14 units a one-row item
    (8, "block1 86", (16, 1, 1)),
    (8, "block2", (32, 2, 1)),      # a band of 2: 7 units
    (8, "block3", (16, 2, 1)),
])
def test_chooser_at_the_served_shapes(bsz, name, want):
    n, h, w, m, k = SHAPES[name]
    keys = ("cpb", "band", "items")
    assert tiling.choose_conv_s8_blocks(bsz, n, h, w, m, k, k, 1, 1) == \
        dict(zip(keys, want))


def test_smem_bytes_add_up():
    """conv2, cpb 24, a band of 4 tile rows, 3 items: the expanded weights
    (24 rows of η' = 15·6·8 → 736, + 16), the run table (8 bytes a run of
    η'), the raw weights (24·540 + 4 → 16s), the slab offsets (4 bytes a
    channel an item) and 3 × 15 channel bands of 13 rows × 13 + 19."""
    got = tiling.conv_s8_smem_bytes(15, 13, 13, 6, 6, 1, 24, 4, 3)
    assert got == (24 * 752 + 2 * 736 + 12976 + 192 + 45 * 192)
    # three more items add their slabs and offsets only
    assert (tiling.conv_s8_smem_bytes(15, 13, 13, 6, 6, 1, 24, 4, 6) - got
            == 45 * 192 + (368 - 192))


def test_overrides_and_the_cache_resolve_by_namespace():
    """``fused_conv_block.<key>`` steers the pooled launch and
    ``conv2d.<key>`` the unpooled one; a bare key both; an int8
    ``TUNING_CACHE`` entry sits under the overrides and beside a float32
    entry of the same signature, which it never reads."""
    sig = (8, 15, 13, 13, 20, 6, 6, 1, 1)
    t = tiling.conv_s8_tiles(*sig, {"fused_conv_block.items": 3,
                                    "conv2d.items": 5}, platform="cpu")
    assert t["items"] == 3
    assert tiling.conv_s8_tiles(*sig, {"conv2d.items": 5}, pool=False,
                                platform="cpu")["items"] == 5
    assert tiling.conv_s8_tiles(*sig, {"band": 2}, pool=False,
                                platform="cpu")["band"] == 2
    saved = tiling.TUNING_CACHE.snapshot()
    try:
        tiling.TUNING_CACHE.put("fused_conv_block", sig, torch.int8,
                                {"items": 3, "cpb": 16}, platform="cpu")
        tiling.TUNING_CACHE.put("fused_conv_block", sig, torch.float32,
                                {"split": 4}, platform="cpu")
        t = tiling.conv_s8_tiles(*sig, platform="cpu")
        assert (t["items"], t["cpb"]) == (3, 16)
        t = tiling.conv_s8_tiles(*sig, {"fused_conv_block.cpb": 8},
                                 platform="cpu")
        assert (t["items"], t["cpb"]) == (3, 8)
        assert tiling.fused_tiles(*sig, platform="cpu")["split"] == 4
    finally:
        tiling.TUNING_CACHE.restore(saved)
    assert t["smem"] == tiling.conv_s8_smem_bytes(
        15, 13, 13, 6, 6, 1, 8, t["band"], 3)


@pytest.mark.parametrize("bad", [{"cpb": 12}, {"cpb": 40}, {"cpb": 0},
                                 {"cpb": 4}, {"band": 0}, {"items": 0},
                                 {"items": 256}])
def test_keys_the_kernel_refuses_raise(bad):
    with pytest.raises(ValueError):
        tiling.conv_s8_tiles(8, 15, 13, 13, 20, 6, 6, 1, 1,
                             {f"fused_conv_block.{k}": v
                              for k, v in bad.items()}, platform="cpu")


def test_retired_keys_steer_nothing():
    """The int8 block is 8 warps and one commit group: ``threads`` and
    ``stages`` overrides leave its launch as it was, and a cached entry
    that carries either is a miss (measured under an older kernel)."""
    sig = (8, 15, 13, 13, 20, 6, 6, 1, 1)
    want = tiling.conv_s8_tiles(*sig, platform="cpu")
    assert tiling.conv_s8_tiles(*sig, {"fused_conv_block.threads": 64,
                                       "fused_conv_block.stages": 3,
                                       "threads": 32},
                                platform="cpu") == want
    saved = tiling.TUNING_CACHE.snapshot()
    try:
        tiling.TUNING_CACHE.put("fused_conv_block", sig, torch.int8,
                                {"threads": 64, "cpb": 16, "band": 2,
                                 "items": 1, "stages": 2}, platform="cpu")
        assert tiling.conv_s8_tiles(*sig, platform="cpu") == want
    finally:
        tiling.TUNING_CACHE.restore(saved)


def test_a_slab_past_shared_memory():
    """The heuristic's own point past SMEM_MAX (a one-row band of 512
    channels × 230 columns) raises, as an override past it does: the
    int8 route has no second path."""
    sig = (2, 512, 6, 230, 6, 3, 3, 1, 1)
    with pytest.raises(ValueError, match="int8 route"):
        tiling.conv_s8_tiles(*sig, platform="cpu")
    with pytest.raises(ValueError, match="int8 route"):
        tiling.conv_s8_tiles(8, 64, 6, 230, 6, 3, 3, 1, 1,
                             {"fused_conv_block.items": 8}, platform="cpu")


# ------------------------------------------------------- the wrappers

def test_wrappers_check_int8_operands():
    xq, wq, b = _codes(SHAPES["conv2"])
    x, w, s = split_int8(xq, wq)
    with pytest.raises(ValueError, match="requant scale"):
        fc_ops.fused_cwp(x, w, b)
    with pytest.raises(TypeError, match="mixed operands"):
        fc_ops.fused_cwp(x, w.to(torch.float32), b, scale=s)
    with pytest.raises(TypeError, match="mixed operands"):
        cw_ops.conv_window(x.to(torch.float32), w)
    with pytest.raises(TypeError, match="int8 codes"):
        cw_ops.conv_window(x.to(torch.int16), w.to(torch.int16))
    with pytest.raises(TypeError, match="mixed operands"):
        fc_ops.fused_cwp(x.to(torch.float32), w, b, scale=s)


def test_wrappers_take_int8_codes_on_the_cpu_without_launching():
    """On the CPU the wrappers run the plain version on int8 codes,
    bitwise to the same call on the codes as fp32, and count nothing."""
    xq, wq, b = _codes(SHAPES["conv2"], bsz=3)
    x, w, s = split_int8(xq, wq)
    xf, wf, sf = split_requant(xq, wq)
    assert x.dtype == w.dtype == torch.int8 and torch.equal(s, sf)
    before = (fc_ops.launches, fc_ops.launches_int8, cw_ops.launches,
              cw_ops.launches_int8)
    assert torch.equal(fc_ops.fused_cwp(x, w, b, scale=s),
                       fc_ops.fused_cwp(xf, wf, b, scale=s))
    assert torch.equal(cw_ops.conv_window(x, w), cw_ops.conv_window(xf, wf))
    assert torch.equal(cw_ops.conv_window(x, w, b),
                       cw_ops.conv_window(xf, wf, b))
    assert before == (fc_ops.launches, fc_ops.launches_int8,
                      cw_ops.launches, cw_ops.launches_int8)


@pytest.mark.parametrize("stage", ["conv1", "conv2"])
def test_plain_versions_on_int8_codes_match_pallas(stage):
    """The plain versions on int8 codes: bitwise to the same call on the
    JAX package's ``split_requant`` codes (f32) and to its Pallas kernels
    in interpret mode on them."""
    n, h, w_, m, k = SHAPES[stage]
    rng = np.random.RandomState(5)
    x = rng.randn(2, n, h, w_).astype(np.float32)
    w = (rng.randn(m, n, k, k) / np.sqrt(n * k * k)).astype(np.float32)
    b = (rng.randn(m) * 0.1).astype(np.float32)
    jx, jw, js = j_split_requant(*j_quantize_conv_int8(jnp.asarray(x),
                                                       jnp.asarray(w)))
    xc, wc, s = split_int8(*quantize_conv_int8(_t(x), _t(w)))
    np.testing.assert_array_equal(xc.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(wc.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    got = conv2d_window_ref(xc, wc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_conv_window(
        jx, jw, None, policy=PALLAS)))
    np.testing.assert_array_equal(
        got.numpy(), conv2d_window_ref(f32_codes(xc), f32_codes(wc)).numpy())
    # the fused plain version on int8 codes is its call on the reference's
    # f32 codes, which test_torch_kernels.py holds against the Pallas kernel
    got = fused_cwp_ref(xc, wc, _t(b), odd="drop", scale=s)
    want = fused_cwp_ref(_t(np.asarray(jx)), _t(np.asarray(jw)), _t(b),
                         odd="drop", scale=_t(np.asarray(js)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_split_int8_is_split_requant_without_the_cast():
    xq, wq, _ = _codes(SHAPES["conv1"])
    codes, f32 = split_int8(xq, wq), split_requant(xq, wq)
    assert codes[0].dtype == codes[1].dtype == torch.int8
    assert f32[0].dtype == f32[1].dtype == torch.float32
    for c, f in zip(codes[:2], f32[:2]):
        assert torch.equal(c.to(torch.float32), f)
    assert torch.equal(codes[2], f32[2])
    x = torch.ones(1, 1, 3, 3)
    assert split_int8(x, x) == (x, x, None)
    with pytest.raises(TypeError, match="BOTH operands"):
        split_int8(xq, x)


# --------------------------------------------- int8 codes reach backends

@pytest.fixture
def seen():
    """The dtypes of x and w every conv backend call receives, recorded by
    a test backend registered first on the CPU and removed after."""
    calls = []

    def spy(op, inner):
        def fn(x, w, *a, **kw):
            calls.append((op, x.dtype, w.dtype, x.device.type))
            return inner(x, w, *a, **kw)
        return fn

    saved = {op: dict(REGISTRY._ops[op])
             for op in ("conv2d", "fused_conv_block")}
    for op in saved:
        inner = REGISTRY.lookup(op, "torch").fn
        register(op, "spy", priority={"cpu": 99})(spy(op, inner))
    try:
        yield calls
    finally:
        for op, impls in saved.items():
            REGISTRY._ops[op] = impls


def test_int8_entry_points_hand_the_backends_int8_codes(seen):
    xq, wq, b = _codes(SHAPES["conv2"])
    pol = ExecPolicy(quant="int8")
    x = xq.codes.to(torch.float32) * xq.scale
    w = wq.codes.to(torch.float32) * wq.scale.reshape(-1, 1, 1, 1)
    conv2d(x, w, b, policy=pol)
    fused_conv_block(x, w, b, policy=pol)
    til = SpatialTiling(tile_rows=2, halo=5)
    stream_conv2d(xq, wq, b, tiling=til, policy=ExecPolicy())
    stream_fused_conv_block(xq, wq, b, odd="drop", tiling=til,
                            policy=ExecPolicy())
    assert seen and all(c[1:] == (torch.int8, torch.int8, "cpu")
                        for c in seen), seen
    assert {c[0] for c in seen} == {"conv2d", "fused_conv_block"}
    # the entry points once each; 8 conv rows and 4 pooled rows, in
    # bands of 2
    assert len(seen) == 2 + 4 + 2


# ------------------------------------------------------- int8 plans

def test_mnist_int8_plan_bitwise_to_jax_with_int8_codes(seen):
    """The int8 plans of mnist_cnn (fused and unfused) are bitwise to the
    JAX package's, every conv stage handed int8 codes."""
    import jax
    params = JaxCNN(JaxCNNConfig()).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    x = np.random.RandomState(1).randn(4, 1, 28, 28).astype(np.float32)
    for fuse in (True, False):
        # as tests/test_torch_model.py holds them: the fused plan against
        # the reference's xla backend (its interpreted fused kernel
        # contracts the epilogue into an FMA), the unfused one against
        # its Pallas kernels
        jplan = JaxCNN(JaxCNNConfig(policy=JPolicy(
            backend="xla" if fuse else "pallas", quant="int8"))).compile(
                fuse=fuse, batch=4)
        want = np.asarray(jplan.bind(params)(jnp.asarray(x)))
        plan = PaperCNN(PaperCNNConfig(policy=ExecPolicy(
            quant="int8"))).compile(fuse=fuse, batch=4)
        got = plan.bind(params_from_numpy(np_params, "cpu"))(_t(x))
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(seen) == 4 and all(c[1] == torch.int8 for c in seen)


def test_highres_int8_streamed_plan_bitwise_to_jax_with_int8_codes(seen):
    """highres_cnn at 48², streamed under a small budget, int8: bitwise
    to the JAX package's bound plan run op by op (not jitted, as
    tests/test_torch_stream.py runs it), every band handed int8 codes."""
    import jax
    cfg = JaxVGGConfig(img_size=48, policy=JPolicy(backend="xla",
                                                   quant="int8"))
    jparams = jax.jit(JaxVGG(cfg).init)(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    x = np.random.RandomState(2).randn(2, 3, 48, 48).astype(np.float32)
    jplan = JaxVGG(cfg).compile(batch=2, stream_budget=40_000, verify=False)
    want = np.asarray(jplan.bind(jparams)(jnp.asarray(x)))   # op by op
    plan = VGGStyleCNN(VGGStyleCNNConfig(img_size=48, policy=ExecPolicy(
        quant="int8"))).compile(batch=2, stream_budget=40_000)
    assert any(getattr(n, "tiling", None) for n in plan.graph)
    got = plan.bind(params_from_numpy(np_params, "cpu"))(_t(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(seen) > 4 and all(c[1:3] == (torch.int8, torch.int8)
                                 for c in seen)


# ------------------------------------------------------- meta charges

def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_meta_charges_the_int8_route():
    """On meta, int8 codes charge int8 operations and 1-byte inputs (the
    fp32 vectors and output at 4 bytes), fp32 operands as before."""
    bsz, n, h, w, m, kk = 3, 2, 9, 11, 5, 3
    ho, wo = h - kk + 1, w - kk + 1
    macs = bsz * m * ho * wo * n * kk * kk
    x, wt = _meta((bsz, n, h, w), torch.int8), _meta((m, n, kk, kk),
                                                     torch.int8)
    with OpCounter() as c:
        out = cw_ops.conv_window(x, wt)
    s = c.stats
    assert tuple(out.shape) == (bsz, m, ho, wo) and out.dtype == torch.float32
    assert (s.ops["conv_window"].flops, s.ops["conv_window"].bytes) == (
        2 * macs, x.numel() + wt.numel() + 4 * bsz * m * ho * wo)
    assert s.flops_by_dtype == {"int8": 2 * macs}
    with OpCounter() as c:
        out = fc_ops.fused_cwp(x, wt, _meta((m,)), scale=_meta((m,)),
                               odd="drop")
    s = c.stats
    po, qo = ho // 2, wo // 2
    assert tuple(out.shape) == (bsz, m, po, qo)
    assert s.ops["fused_cwp"].bytes == (x.numel() + wt.numel()
                                        + 4 * (2 * m + bsz * m * po * qo))
    assert s.flops_by_dtype == {"int8": 2 * macs}


def test_an_int8_plan_on_meta_charges_int8_convs():
    """The mnist_cnn int8 plan on meta: both conv stages and the fc charge
    int8 operations, no fp32 conv."""
    plan = PaperCNN(PaperCNNConfig(policy=ExecPolicy(quant="int8"))).compile(
        batch=8)
    params = PaperCNN().init(0, device=META)
    bound = plan.bind(params)
    with OpCounter() as c:
        bound(_meta((8, 1, 28, 28)))
    s = c.stats
    assert s.ops["fused_cwp"].count == 2
    conv_flops = s.ops["fused_cwp"].flops
    assert s.flops_by_dtype["int8"] >= conv_flops + s.ops["qmatmul"].flops


# ------------------------------------------------------- the autotuner

def test_autotuner_stage_calls_hand_int8_codes():
    """An int8 plan's tunable conv stages (fused and streamed) are handed
    to the tuner as the served path hands them: int8 activation and weight
    codes and the requant scale, so the tuner measures the int8 route and
    caches it under dtype int8."""
    import jax
    cfg = VGGStyleCNNConfig(img_size=48, policy=ExecPolicy(quant="int8"))
    plan = VGGStyleCNN(cfg).compile(batch=2, stream_budget=40_000)
    jparams = jax.jit(JaxVGG(JaxVGGConfig(img_size=48)).init)(
        jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    folded = plan._fold_constants(params)
    calls = list(plan._stage_calls(params, folded))
    convs = [c for c in calls if c[1] != "qmatmul"]
    assert {c[1] for c in convs} == {"fused_conv_block",
                                     "stream_fused_conv_block"}
    for node, op, (x, w, b), kw in convs:
        assert x.dtype == w.dtype == torch.int8, op
        assert kw["scale"].dtype == torch.float32
        assert kw["scale"].shape == (w.shape[0],)
        assert int(x.abs().max()) == 127      # a per-tensor absmax code
    dense = [c for c in calls if c[1] == "qmatmul"]
    assert len(dense) == 1 and dense[0][2][0].dtype == torch.int8


def test_autotune_heuristic_and_axes_follow_the_route():
    from repro_torch.ops import autotune
    xq, wq, _ = _codes(SHAPES["conv2"], bsz=8)
    x, w, s = split_int8(xq, wq)
    heur = autotune.heuristic_tiles("fused_conv_block", x, w, None,
                                    stride=(1, 1), scale=s)
    assert set(heur) == S8_KEYS
    assert heur == {k: v for k, v in tiling.choose_conv_s8_blocks(
        8, 15, 13, 13, 20, 6, 6, 1, 1).items()}
    axes = autotune._conv_axes(x, w, (1, 1), heur)
    assert list(axes) == ["items", "band", "cpb"]
    assert axes["cpb"] == [8, 16, 24]
    assert set(autotune.heuristic_tiles(
        "fused_conv_block", x.to(torch.float32), w.to(torch.float32), None,
        stride=(1, 1), scale=s)) == {"threads", "cpb", "band", "split",
                                     "ipb"}
    assert autotune._known_keys("conv2d", torch.int8) == tuple(
        sorted(S8_KEYS, key=["cpb", "band", "items"].index))


def test_ensure_tuned_on_the_cpu_measures_nothing_for_int8():
    from repro_torch.ops import autotune
    xq, wq, b = _codes(SHAPES["conv2"])
    x, w, s = split_int8(xq, wq)
    before = autotune.measurements
    assert autotune.ensure_tuned("fused_conv_block", x, w, b,
                                 stride=(1, 1), scale=s) is None
    assert autotune.measurements == before


def test_backends_accept_int8_codes_and_refuse_mixed():
    xq, wq, b = _codes(SHAPES["conv1"])
    x, w, s = split_int8(xq, wq)
    assert REGISTRY.supported_backends("fused_conv_block", x, w, b,
                                       scale=s)[0] == "torch"
    assert "cuda" in REGISTRY.supported_backends("fused_conv_block", x, w,
                                                 b, scale=s)
    assert "cuda" in REGISTRY.supported_backends("conv2d", x, w)
    assert "cuda" not in REGISTRY.supported_backends(
        "conv2d", x, w.to(torch.float32))
    assert "cuda" not in REGISTRY.supported_backends("fused_conv_block",
                                                     x, w, b)
    assert isinstance(xq, QTensor)
