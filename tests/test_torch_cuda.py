"""The CUDA kernels on the card: each against its plain version, and the
dispatch rules on CUDA tensors.

Every test here needs an NVIDIA GPU and skips without one. The file
imports nothing of JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: int8 and qformat operands make every conv sum exact, so the
kernels must agree bitwise with their plain versions; fp32 (``none``)
sums run in another order, rtol = atol = 1e-5. The addition tree sums in
its plain version's order, so it is bitwise in fp32.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantize import QFormat, quantize_int8
from repro_torch.kernels.addtree import ops as at_ops
from repro_torch.kernels.addtree.ref import tree_reduce_sum_ref
from repro_torch.kernels.conv_window import ops as cw_ops
from repro_torch.kernels.conv_window.ref import conv2d_window_ref
from repro_torch.kernels.fused_cwp import ops as fc_ops
from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
from repro_torch.kernels.qmatmul import ops as qm_ops
from repro_torch.kernels.qmatmul.ref import qmatmul_ref
from repro_torch.core.window import pool_output_size
from repro_torch.graph.ir import Conv2DNode, FusedConvBlockNode
from repro_torch.graph.passes import (place_channel_parallel,
                                      stage_input_spec)
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
from repro_torch.models.vgg import VGGStyleCNN, VGGStyleCNNConfig
from repro_torch.ops import (BackendUnavailableError, ExecPolicy, conv2d,
                             fused_conv_block, qdense, quantize_conv_int8,
                             split_requant, tree_reduce_sum)
from repro_torch.ops.tiling import TREE_MAX_ETA
from repro_torch.serve import VisionEngine, VisionEngineConfig
from repro_torch.stream import (SpatialTiling, conv_bands, pooled_bands,
                                stream_fused_conv_block)

pytestmark = pytest.mark.cuda

STAGES = {"conv1": (1, 28, 28, 15, 3), "conv2": (15, 13, 13, 20, 6)}
# chip_smoke.py's addtree shapes: (R, η), prime R = 509, η up to the cap
TREE_SHAPES = [(1, 1), (4, 9), (8, 1), (96, 7), (100, 37), (509, 144),
               (1024, 37), (16, 256), (64, 540), (64, 1350),
               (33, TREE_MAX_ETA)]
# the kernel's own paths: η on both sides of the short-row threshold (32),
# R off a multiple of the rows a block takes (256 short, 16 or 8 long), the
# paper CNN's product matrices at B = 8
TREE_PATH_SHAPES = [(257, 9), (300, 32), (13, 33), (9, 16), (13, 540),
                    (81_120, 9), (10_240, 540),
                    # over 16,896 rows: a whole warp a row
                    (20_000, 37), (20_000, 540)]
# non-paper fused shapes (N, H, W, M, K, stride, tiling): stride 2 with a
# band of 3 pooled rows over 8, and a slab too wide to stage
FUSED_SHAPES = {
    "stride2_ragged_band": ((3, 33, 41, 5, 3), (2, 2),
                            {"fused_conv_block.band": 3}),
    "unstaged": ((64, 6, 230, 6, 3), (1, 1), {}),
}
# conv_window beyond the paper's shapes, each with an odd output: a 5x5
# kernel on conv2's input (9x9), stride 2 (17x21) with a band of 3 tile
# rows over 9, and a slab too wide to stage (5x229)
CONV_SHAPES = {
    "odd_output": ((15, 13, 13, 20, 5), (1, 1), {}),
    "stride2_ragged_band": ((3, 35, 43, 5, 3), (2, 2), {"conv2d.band": 3}),
    "unstaged": ((64, 7, 231, 6, 3), (1, 1), {}),
}
MODES = ("none", "qformat", "int8")
TOL_FP32 = 1e-5
QSTEP = 2.0 ** -8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _operands(stage, mode, bsz, device):
    n, h, w_, m, k = STAGES[stage] if isinstance(stage, str) else stage
    g = torch.Generator().manual_seed(bsz)
    x = torch.randn((bsz, n, h, w_), generator=g)
    w = torch.randn((m, n, k, k), generator=g) * (n * k * k) ** -0.5
    b = torch.randn((m,), generator=g) * 0.1
    s = None
    if mode == "qformat":
        q = QFormat()
        x, w, b = q.quantize(x), q.quantize(w), q.quantize(b)
    elif mode == "int8":
        x, w, s = split_requant(*quantize_conv_int8(x, w))
    return tuple(None if t is None else t.to(device) for t in (x, w, b, s))


def _agree(mode, got, want):
    torch.cuda.synchronize()
    if mode == "none":
        torch.testing.assert_close(got, want, rtol=TOL_FP32, atol=TOL_FP32)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("mode", MODES)
def test_conv_kernels_match_plain(card, mode, stage, bsz):
    x, w, b, s = _operands(stage, mode, bsz, card)
    before = (fc_ops.launches, cw_ops.launches)
    fused = fc_ops.fused_cwp(x, w, b, scale=s)
    cb = None if mode == "int8" else b
    conv = cw_ops.conv_window(x, w, cb)
    assert (fc_ops.launches, cw_ops.launches) == (before[0] + 1,
                                                  before[1] + 1)
    _agree(mode, fused, fused_cwp_ref(x, w, b, scale=s))
    _agree(mode, conv, conv2d_window_ref(x, w, cb))


@pytest.mark.parametrize("bsz", [1, 8, 1000])
def test_qmatmul_matches_plain(card, bsz):
    g = torch.Generator().manual_seed(bsz)
    xq = quantize_int8(torch.randn((bsz, 320), generator=g), axis=-1)
    wq = quantize_int8(torch.randn((320, 10), generator=g) * 0.05, axis=0)
    args = [t.to(card) for t in (xq.codes, wq.codes, xq.scale, wq.scale)]
    _agree("int8", qm_ops.qmatmul(*args), qmatmul_ref(*args))


def _qmatmul_operands(m, k, n, device, seed=None):
    """int8 codes over the full range and positive f32 scales."""
    g = torch.Generator().manual_seed(m * 7 + k * 3 + n if seed is None
                                      else seed)
    xc = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    wc = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
    xs = torch.rand((m, 1), generator=g) * 0.05
    ws = torch.rand((1, n), generator=g) * 0.05
    return [t.to(device) for t in (xc, wc, xs, ws)]


@pytest.mark.parametrize("m,k,n", [
    (1, 37, 1), (8, 320, 10), (1000, 4099, 33), (4097, 320, 300),
    (8, 4099, 300), (4097, 37, 10), (1, 4099, 33), (1000, 37, 1)]
    # both sides of the body boundary (tensor-core tiles from M = 8 at
    # N >= 64), K in {37, 320, 4,099, 14,336}, N in {10, 16, 1,408, 3,584}
    + [(m, k, n) for m in (1, 7, 8, 15, 16, 17, 64, 512)
       for k, n in ((37, 3584), (320, 1408), (4099, 16), (14336, 10),
                    (14336, 3584))])
def test_qmatmul_shapes_match_plain_bitwise(card, m, k, n):
    """K off a multiple of 16 (37, 4099) takes byte loads; N past one
    column tile and narrow N; M off a block's rows; decode shapes split
    K across blocks."""
    args = _qmatmul_operands(m, k, n, card)
    before = qm_ops.launches
    with qm_ops.record_shapes() as seen:
        got = qm_ops.qmatmul(*args)
    assert qm_ops.launches == before + 1
    assert seen == {("epilogue", m, k, n)}
    _agree("int8", got, qmatmul_ref(*args))


@pytest.mark.parametrize("m,k,n", [(4, 1408, 1024), (64, 704, 1024),
                                   (37, 4099, 33), (1, 37, 1),
                                   (2, 2816, 1024), (32, 1408, 1024),
                                   (4, 7168, 3584), (512, 7168, 3584)])
def test_qmatmul_accumulator_matches_plain_bitwise(card, m, k, n):
    """The raw mode (no epilogue): the int32 accumulator a row-parallel
    shard hands to the exact sum across ranks, at the LM mesh shard
    shapes too (a split K adds into the zeroed output)."""
    from repro_torch.kernels.qmatmul.ref import qmatmul_acc_ref
    xc, wc, _, _ = _qmatmul_operands(m, k, n, card)
    with qm_ops.record_shapes() as seen:
        got = qm_ops.qmatmul_acc(xc, wc)
    assert seen == {("acc", m, k, n)}
    assert got.dtype == torch.int32
    assert torch.equal(got, qmatmul_acc_ref(xc, wc))


def test_qmatmul_unaligned_view_matches_plain_bitwise(card):
    """A view one byte into its storage: rows are not 4-byte aligned, so
    the kernel reads them with byte loads."""
    xc, wc, xs, ws = _qmatmul_operands(37, 320, 10, card)
    x = torch.empty(37 * 320 + 1, dtype=torch.int8, device=card)[1:]
    x = x.view(37, 320)
    x.copy_(xc)
    assert x.is_contiguous() and x.data_ptr() % 4
    _agree("int8", qm_ops.qmatmul(x, wc, xs, ws), qmatmul_ref(x, wc, xs, ws))


def test_qmatmul_scalar_scales_match_plain_bitwise(card):
    xc, wc, _, _ = _qmatmul_operands(8, 320, 10, card)
    got = qm_ops.qmatmul(xc, wc, 0.03125, torch.tensor(0.0078125))
    want = qmatmul_ref(xc, wc, torch.full((8, 1), 0.03125, device=card),
                       torch.full((1, 10), 0.0078125, device=card))
    _agree("int8", got, want)


@pytest.mark.parametrize("tiling", [
    {"qmatmul.body": 1},                            # tiles at N = 33
    {"qmatmul.body": 1, "qmatmul.tile_m": 128,
     "qmatmul.ksplit": 128},                        # K in 33 slices
    {"qmatmul.body": 0, "qmatmul.tile_m": 4,
     "qmatmul.ksplit": 100},                        # 17 x 41 blocks
    {"qmatmul.body": 0, "qmatmul.tile_m": 16, "qmatmul.tile_n": 128,
     "qmatmul.ksplit": 4100}])                      # K whole, 8 bytes a word
def test_qmatmul_overrides_match_plain_bitwise(card, tiling):
    args = _qmatmul_operands(67, 4099, 33, card)
    got = qm_ops.qmatmul(*args, policy=ExecPolicy(tiling=tiling))
    _agree("int8", got, qmatmul_ref(*args))


@pytest.mark.parametrize("m,k,n,raw", [(4, 1024, 2816, False),
                                       (64, 2816, 1024, False),
                                       (4, 1408, 1024, True),
                                       (512, 7168, 3584, True)])
def test_qmatmul_graph_replays_match_plain_bitwise(card, m, k, n, raw):
    """One launch captured in a CUDA graph, with a split K's zeroed
    buffer, replayed on new inputs copied in: bitwise each time, one
    counted launch (the capture's)."""
    args = _qmatmul_operands(m, k, n, card)
    call = ((lambda: qm_ops.qmatmul_acc(args[0], args[1])) if raw
            else (lambda: qm_ops.qmatmul(*args)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = qm_ops.launches
    with torch.cuda.graph(graph):
        got = call()
    assert qm_ops.launches == before + 1
    for rep in range(2):
        for dst, src in zip(args, _qmatmul_operands(m, k, n, card,
                                                    seed=rep)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = (qm_ops.qmatmul_acc(args[0], args[1]) if raw
                else qm_ops.qmatmul(*args))
        assert torch.equal(got, qmatmul_ref(*args) if not raw else
                           _acc_ref(args[0], args[1]))
        assert torch.equal(got, want)


def _acc_ref(xc, wc):
    from repro_torch.kernels.qmatmul.ref import qmatmul_acc_ref
    return qmatmul_acc_ref(xc, wc)


def test_auto_dispatch_reaches_the_kernels(card):
    x, w, b, _ = _operands("conv2", "none", 2, card)
    before = (fc_ops.launches, cw_ops.launches, qm_ops.launches)
    fused_conv_block(x, w, b)
    conv2d(x, w, b)
    g = torch.Generator().manual_seed(0)
    qdense(torch.randn((2, 320), generator=g).to(card),
           quantize_int8(torch.randn((320, 10), generator=g).to(card),
                         axis=0))
    assert (fc_ops.launches, cw_ops.launches, qm_ops.launches) == \
        tuple(c + 1 for c in before)


def test_refused_call_raises_instead_of_falling_back(card):
    # float64: the kernels take float32, and no plain version may run
    x = torch.zeros((1, 15, 13, 13), device=card, dtype=torch.float64)
    w = torch.zeros((20, 15, 5, 5), device=card, dtype=torch.float64)
    with pytest.raises(BackendUnavailableError):
        fused_conv_block(x, w, odd="drop")
    with pytest.raises(ValueError):
        cw_ops.conv_window(x.float(), w.float().cpu())


@pytest.mark.parametrize("shape", TREE_SHAPES)
def test_addtree_matches_plain_bitwise(card, shape):
    g = torch.Generator().manual_seed(shape[1])
    x = torch.randn(shape, generator=g).to(card)
    before = at_ops.launches
    got = at_ops.tree_reduce_sum(x)
    assert at_ops.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, tree_reduce_sum_ref(x))


@pytest.mark.parametrize("shape", TREE_PATH_SHAPES)
def test_addtree_paths_match_plain_bitwise(card, shape):
    g = torch.Generator().manual_seed(shape[0])
    x = torch.randn(shape, generator=g).to(card)
    assert torch.equal(at_ops.tree_reduce_sum(x), tree_reduce_sum_ref(x))


@pytest.mark.parametrize("eta", [16, 540])
def test_addtree_unaligned_rows_match_plain_bitwise(card, eta):
    """A view one float into its storage is not 16-byte aligned: the
    kernel takes 4-byte loads there."""
    g = torch.Generator().manual_seed(eta)
    x = torch.randn(37 * eta + 1, generator=g).to(card)[1:].view(37, eta)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert torch.equal(at_ops.tree_reduce_sum(x), tree_reduce_sum_ref(x))


@pytest.mark.parametrize("tiling", [{"tree_reduce_sum.rows": 5,
                                     "tree_reduce_sum.threads": 64},
                                    {"tree_reduce_sum.short_eta": 1},
                                    {"tree_reduce_sum.short_eta": 540,
                                     "tree_reduce_sum.rows": 40},
                                    {"tree_reduce_sum.row_lanes": 32},
                                    {"tree_reduce_sum.row_lanes": 16,
                                     "tree_reduce_sum.rows": 7}])
@pytest.mark.parametrize("eta", [9, 540])
def test_addtree_overrides_match_plain_bitwise(card, tiling, eta):
    g = torch.Generator().manual_seed(eta)
    x = torch.randn((301, eta), generator=g).to(card)
    got = at_ops.tree_reduce_sum(x, policy=ExecPolicy(tiling=tiling))
    assert torch.equal(got, tree_reduce_sum_ref(x))


@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("mode", MODES)
def test_fused_large_batch_matches_plain(card, mode, stage):
    x, w, b, s = _operands(stage, mode, 1024, card)
    _agree(mode, fc_ops.fused_cwp(x, w, b, scale=s),
           fused_cwp_ref(x, w, b, scale=s))


@pytest.mark.parametrize("case", sorted(FUSED_SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_fused_other_shapes_match_plain(card, mode, case):
    shape, stride, tiling = FUSED_SHAPES[case]
    x, w, b, s = _operands(shape, mode, 2, card)
    got = fc_ops.fused_cwp(x, w, b, stride=stride, scale=s,
                           policy=ExecPolicy(tiling=tiling))
    _agree(mode, got, fused_cwp_ref(x, w, b, stride, scale=s))


@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("mode", MODES)
def test_conv_window_large_batch_matches_plain(card, mode, stage):
    x, w, b, _ = _operands(stage, mode, 1024, card)
    cb = None if mode == "int8" else b
    _agree(mode, cw_ops.conv_window(x, w, cb), conv2d_window_ref(x, w, cb))


@pytest.mark.parametrize("case", sorted(CONV_SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_conv_window_other_shapes_match_plain(card, mode, case):
    shape, stride, tiling = CONV_SHAPES[case]
    x, w, b, _ = _operands(shape, mode, 2, card)
    cb = None if mode == "int8" else b
    got = cw_ops.conv_window(x, w, cb, stride=stride,
                             policy=ExecPolicy(tiling=tiling))
    _agree(mode, got, conv2d_window_ref(x, w, cb, stride=stride))


def _shard_shapes(model, size, override):
    """(kernel, (N, H, W, M, K)) of each placed stage's per-shard launch
    at a model axis of ``size``: OCP runs the stage's kernel on M/ocp
    output channels; ICP and BOTH run conv_window on the (N/icp, M/ocp)
    block before the ring."""
    graph = place_channel_parallel(model.compile(batch=8).graph, size,
                                   override=override)
    out = []
    for node in graph:
        spec = getattr(node, "sharding", None)
        if spec is None or spec.mode == "none":
            continue
        ki, ko = spec.split(size)
        _, n, h, w = stage_input_spec(graph, node).shape
        m, _, k, _ = node.w.shape
        fused = ki == 1 and isinstance(node, FusedConvBlockNode)
        out.append(("fused_cwp" if fused else "conv_window",
                    (n // ki, h, w, m // ko, k)))
    return out


@pytest.mark.parametrize("override", [None, "input", "output"])
@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("arch", ["mnist_cnn", "highres_cnn"])
@pytest.mark.parametrize("mode", MODES)
def test_conv_kernels_match_plain_at_per_shard_shapes(card, mode, arch,
                                                      size, override):
    """The conv kernels at the channel counts a mesh gives them (2 to 16
    per shard, N slices of 4 to 8 under BOTH), at B = 8 and at a data
    axis's B = 4."""
    model = (PaperCNN() if arch == "mnist_cnn" else VGGStyleCNN())
    try:
        shapes = _shard_shapes(model, size, override)
    except ValueError:          # no stage can take the forced schedule
        shapes = []
    if arch == "mnist_cnn" and override is None:
        assert shapes           # conv2 is OCP at 2 and 4
    for kern, shape in shapes:
        for bsz in (8, 4):
            x, w, b, s = _operands(shape, mode, bsz, card)
            if kern == "fused_cwp":
                _agree(mode, fc_ops.fused_cwp(x, w, b, scale=s),
                       fused_cwp_ref(x, w, b, scale=s))
            else:               # a partial: no bias, no scale
                _agree(mode, cw_ops.conv_window(x, w, None),
                       conv2d_window_ref(x, w, None))


@pytest.mark.parametrize("tiling", [{"conv2d.band": 2, "conv2d.split": 4},
                                    {"conv2d.ipb": 3, "conv2d.cpb": 8,
                                     "conv2d.threads": 256},
                                    {"conv2d.split": 1, "conv2d.band": 1}])
def test_conv_window_overrides_match_plain(card, tiling):
    """Odd 9x9 output, several images a block and every split width."""
    x, w, b, _ = _operands((15, 13, 13, 20, 5), "qformat", 5, card)
    got = cw_ops.conv_window(x, w, b, policy=ExecPolicy(tiling=tiling))
    _agree("qformat", got, conv2d_window_ref(x, w, b))


def test_tree_auto_dispatch_launches_the_kernel(card, monkeypatch):
    """On a CUDA tensor the op runs the kernel: one launch, and neither
    plain version may run in its place."""
    def refuse(*_, **__):
        raise AssertionError("a plain version ran on a CUDA tensor")

    x = torch.randn((10240, 540), generator=torch.Generator().manual_seed(0))
    want = tree_reduce_sum_ref(x)
    monkeypatch.setattr(at_ops, "tree_reduce_sum_ref", refuse)
    monkeypatch.setattr(torch, "sum", refuse)
    before = at_ops.launches
    got = tree_reduce_sum(x.to(card))
    assert at_ops.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape", [(2, 4, 9), (2, TREE_MAX_ETA + 1)])
def test_tree_refused_call_raises(card, shape):
    before = at_ops.launches
    with pytest.raises(BackendUnavailableError):
        tree_reduce_sum(torch.zeros(shape, device=card))
    assert at_ops.launches == before


@pytest.mark.parametrize("mode", MODES)
def test_vision_engine_on_card_matches_cpu(card, mode):
    model = PaperCNN()
    params = model.init(0, device="cpu")
    rng = np.random.RandomState(0)
    images = [rng.randn(1, 28, 28).astype(np.float32) for _ in range(11)]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = VisionEngine(model, params, VisionEngineConfig(
            batch=8, buckets="auto", policy=ExecPolicy(quant=mode),
            device=dev))
        for img in images:
            eng.submit(img)
        res = eng.run()
        out[dev] = np.stack([res[i]["logits"] for i in range(11)])
    if mode == "none":
        np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=TOL_FP32,
                                   atol=TOL_FP32)
    else:
        np.testing.assert_array_equal(out["cuda"], out["cpu"])


# ------------------------------------------------ highres_cnn, streamed

def _launch_shapes(plan) -> list[tuple[str, tuple]]:
    """(kernel, (N, H, W, M, K)) of every conv launch one batch of
    ``plan`` makes: one a band for a streamed stage, else one a stage."""
    out = []
    for node in plan.graph:
        if not isinstance(node, (Conv2DNode, FusedConvBlockNode)):
            continue
        _, n, h, w = stage_input_spec(plan.graph, node).shape
        m, _, k, _ = node.w.shape
        sh = node.stride[0]
        fused = isinstance(node, FusedConvBlockNode)
        rows = [h]
        if node.tiling is not None and fused:
            po = pool_output_size((h - k) // sh + 1, node.odd)
            rows = [hi - lo for *_, lo, hi in pooled_bands(
                po, node.tiling.tile_rows, k, sh, h)]
        elif node.tiling is not None:
            rows = [hi - lo for *_, lo, hi in conv_bands(
                (h - k) // sh + 1, node.tiling.tile_rows, k, sh)]
        out += [("fused_cwp" if fused else "conv_window", (n, r, w, m, k))
                for r in rows]
    return out


@pytest.mark.parametrize("mode", MODES)
def test_highres_streamed_matches_untiled_and_cpu(card, mode):
    """224², B = 2: the streamed plan (first two blocks in bands) against
    the untiled plan on the card and against itself on the CPU; the
    kernels launch once a band."""
    model = VGGStyleCNN(VGGStyleCNNConfig(policy=ExecPolicy(quant=mode)))
    cpu_params = model.init(0, device="cpu")
    params = model.init(0, device=card)
    x = torch.randn(model.input_shape(2),
                    generator=torch.Generator().manual_seed(2))
    streamed = model.compile(batch=2)
    untiled = model.compile(batch=2, stream_budget=1 << 40)
    shapes = _launch_shapes(streamed)
    assert [k for k, _ in shapes] == ["fused_cwp"] * 7
    assert len(_launch_shapes(untiled)) == 4
    out = {}
    for name, plan in (("streamed", streamed), ("untiled", untiled)):
        before = (fc_ops.launches, qm_ops.launches)
        with torch.inference_mode():
            out[name] = plan.bind(params)(x.to(card))
        torch.cuda.synchronize()
        assert fc_ops.launches - before[0] == len(_launch_shapes(plan))
        assert qm_ops.launches - before[1] == (mode == "int8")
    with torch.inference_mode():
        cpu = streamed.bind(cpu_params)(x)
    for got, want in ((out["streamed"], out["untiled"]),
                      (out["streamed"].cpu(), cpu)):
        assert got.shape == (2, 10) and bool(torch.isfinite(got).all())
        if mode == "int8":
            assert torch.equal(got, want)
        elif mode == "qformat":
            assert float((got - want).abs().max()) <= QSTEP
        else:
            torch.testing.assert_close(got, want, rtol=TOL_FP32,
                                       atol=TOL_FP32)


def _highres_shapes() -> dict[str, set]:
    """Every distinct conv launch shape of the 224² plans: streamed fused
    (served), streamed unfused, and the eager forward's convs."""
    model = VGGStyleCNN()
    shapes = {"fused_cwp": set(), "conv_window": set()}
    for plan in (model.compile(), model.compile(fuse=False),
                 model.compile(fuse=False, stream_budget=1 << 40)):
        for kern, shape in _launch_shapes(plan):
            shapes[kern].add(shape)
    return shapes


@pytest.mark.parametrize("bsz", [2, 8])
@pytest.mark.parametrize("mode", MODES)
def test_highres_kernel_shapes_match_plain(card, mode, bsz):
    shapes = _highres_shapes()
    assert (3, 94, 224, 8, 5) in shapes["fused_cwp"]
    assert (8, 86, 110, 16, 3) in shapes["fused_cwp"]
    for shape in sorted(shapes["fused_cwp"]):
        x, w, b, s = _operands(shape, mode, bsz, card)
        _agree(mode, fc_ops.fused_cwp(x, w, b, scale=s),
               fused_cwp_ref(x, w, b, scale=s))
    for shape in sorted(shapes["conv_window"]):
        x, w, b, _ = _operands(shape, mode, bsz, card)
        cb = None if mode == "int8" else b
        _agree(mode, cw_ops.conv_window(x, w, cb),
               conv2d_window_ref(x, w, cb))


@pytest.mark.parametrize("bsz", [2, 8])
def test_highres_fc_qmatmul_matches_plain(card, bsz):
    """The int8 fc of the 224² model: K = 4,608, N = 10."""
    fc_in = VGGStyleCNNConfig().fc_in()
    assert fc_in == 4608
    args = _qmatmul_operands(bsz, fc_in, 10, card)
    _agree("int8", qm_ops.qmatmul(*args), qmatmul_ref(*args))


def test_odd_streamed_fused_band_raises(card, monkeypatch):
    """13 rows, k = 3, odd='pad': 11 conv rows, pooled bands of 2, 2, 2
    rows whose last reads input rows 8-13, a conv map of 3 rows. (Under
    odd='drop' the last band stops at row 12 and is even.) Since the
    kernel pools odd maps this no longer raises: in every mode all three
    bands launch the fused kernel, none reaches the plain version, and
    the streamed result equals the plain version of the whole stage."""
    def refuse(*_, **__):
        raise AssertionError("a plain version ran on a CUDA tensor")

    g = torch.Generator().manual_seed(13)
    x = torch.randn((2, 3, 13, 14), generator=g).to(card)
    w = torch.randn((4, 3, 3, 3), generator=g).to(card)
    b = (torch.randn((4,), generator=g) * 0.1).to(card)
    plain = fc_ops.fused_cwp_ref
    for mode in MODES:
        pol = ExecPolicy(quant=mode)
        monkeypatch.setattr(fc_ops, "fused_cwp_ref", plain)
        want = fused_conv_block(x, w, b, odd="pad",
                                policy=pol.with_options(backend="torch"))
        monkeypatch.setattr(fc_ops, "fused_cwp_ref", refuse)
        before = fc_ops.launches
        got = stream_fused_conv_block(
            x, w, b, odd="pad", policy=pol,
            tiling=SpatialTiling(2, 2, pooled=True))
        assert fc_ops.launches == before + 3
        assert got.shape == (2, 4, 6, 6)
        _agree(mode, got, want)


# ------------------------------------------------- odd pooled maps

# (N, H, W, M, K) whose conv map is odd: 9x9 (a 5x5 kernel on conv2's
# input), a 224-wide band with an odd row count, odd in both dims
ODD_POOL_SHAPES = [(15, 13, 13, 20, 5), (3, 95, 224, 8, 5),
                   (3, 44, 223, 8, 5), (8, 27, 27, 16, 3)]


@pytest.mark.parametrize("odd", ["drop", "pad"])
@pytest.mark.parametrize("bsz", [1, 8])
@pytest.mark.parametrize("shape", ODD_POOL_SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_fused_odd_pools_match_plain(card, mode, shape, bsz, odd):
    x, w, b, s = _operands(shape, mode, bsz, card)
    before = fc_ops.launches
    got = fc_ops.fused_cwp(x, w, b, scale=s, odd=odd)
    assert fc_ops.launches == before + 1
    _agree(mode, got, fused_cwp_ref(x, w, b, scale=s, odd=odd))


def test_fused_odd_raise_raises_before_launching(card):
    x, w, b, _ = _operands((15, 13, 13, 20, 5), "none", 2, card)
    before = fc_ops.launches
    with pytest.raises(ValueError, match="odd"):
        fused_conv_block(x, w, b)
    assert fc_ops.launches == before


# ------------------------------------------- boot: graphs, tuning, artifacts

def _images(n, shape=(1, 28, 28), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bsz", [1, 8])
def test_graph_replay_matches_direct_call(card, mode, bsz):
    """A bucket's CUDA graph replays bitwise what a direct call of its
    bound plan computes; its kernels were counted once, at capture."""
    from repro_torch.artifact.aot import capture_graph
    model = PaperCNN(PaperCNNConfig(policy=ExecPolicy(quant=mode)))
    bound = model.compile(batch=bsz).bind(model.init(0, device=card))
    graph = capture_graph(bound, model.input_shape(bsz))
    want = {"fused_cwp": 2, "conv_window": 0, "addtree": 0,
            "qmatmul": int(mode == "int8"),
            # the int8 route's launches, among the kernel's own
            "fused_cwp_int8": 2 * int(mode == "int8"),
            "conv_window_int8": 0}
    assert graph.kernels == want
    x = torch.from_numpy(np.stack(_images(bsz, seed=bsz)))
    before = fc_ops.launches
    got = graph.run(x).clone()
    assert fc_ops.launches == before
    assert torch.equal(got, bound(x.to(card)))


@pytest.mark.parametrize("mode", ["int8", "none"])
def test_short_batch_after_a_full_one_sees_zero_pad_lanes(card, mode):
    """The static input keeps the last batch's images: a short batch must
    zero its pad lanes (an int8 activation scale is the whole padded
    batch's absmax), so its logits equal those of a fresh engine."""
    from repro_torch.artifact import clear_graph_cache
    model = PaperCNN()
    params = model.init(0, device="cpu")
    cfg = VisionEngineConfig(batch=8, policy=ExecPolicy(quant=mode),
                             device="cuda")
    clear_graph_cache()
    big = [img * 50 for img in _images(8, seed=1)]
    short = _images(3, seed=2)
    eng = VisionEngine(model, params, cfg)
    for img in big + short:
        eng.submit(img)
    got = eng.run()
    clear_graph_cache()                 # the fresh engine captures its own
    fresh = VisionEngine(model, params, cfg)
    for img in short:
        fresh.submit(img)
    want = fresh.run()
    for i in range(3):
        np.testing.assert_array_equal(got[8 + i]["logits"],
                                      want[i]["logits"])
    assert eng.replays == {8: 3} and eng.graph_launches()["fused_cwp"] == 6


@pytest.mark.parametrize("mode", MODES)
def test_tuned_plan_matches_heuristic(card, mode, monkeypatch):
    """Bind-time autotuning on the card: every stage measured (and
    counted), a second bind measures nothing, and the tuned plan equals
    the heuristic one bitwise in int8 and qformat, within 1e-5 in fp32
    (``split`` lanes change the fp32 sum order)."""
    import repro_torch.ops.autotune as autotune
    from repro_torch.ops.tiling import TUNING_CACHE
    monkeypatch.setattr(autotune, "TUNE_ITERS", 2)
    saved = TUNING_CACHE.snapshot()
    TUNING_CACHE.clear()
    try:
        model = PaperCNN(PaperCNNConfig(policy=ExecPolicy(quant=mode)))
        params = model.init(0, device=card)
        x = torch.from_numpy(np.stack(_images(8))).to(card)
        heur = model.compile(batch=8).bind(params)(x)
        before = autotune.measurements
        tuned = model.compile(batch=8, autotune=True).bind(params)
        assert len(TUNING_CACHE) == (3 if mode == "int8" else 2)
        measured = autotune.measurements - before
        assert measured >= len(TUNING_CACHE)
        model.compile(batch=8, autotune=True).bind(params)
        assert autotune.measurements == before + measured
        _agree(mode, tuned(x), heur)
    finally:
        TUNING_CACHE.restore(saved)


def test_artifact_boot_on_card_is_bitwise(card, tmp_path):
    from repro_torch.artifact import clear_graph_cache, collect_warmup
    model = PaperCNN(PaperCNNConfig(policy=ExecPolicy(quant="int8")))
    params = model.init(0, device="cpu")
    cfg = dict(batch=4, buckets="auto", device="cuda")
    fresh = VisionEngine(model, params, VisionEngineConfig(**cfg))
    fresh.save_artifacts(tmp_path)
    clear_graph_cache()
    with collect_warmup() as boot:
        booted = VisionEngine(model, params, VisionEngineConfig(
            **cfg, artifact_dir=str(tmp_path)))
    assert boot.zero_compile()
    assert set(booted.plan_source.values()) == {"artifact+aot"}
    for img in _images(5):
        fresh.submit(img)
        booted.submit(img)
    a, b = fresh.run(), booted.run()
    for uid in a:
        np.testing.assert_array_equal(a[uid]["logits"], b[uid]["logits"])


# ------------------------------------------------------------- the LM

# qmatmul at the LM's shapes (qwen1.5-0.5b's MLP): M = a prefill's prompt
# length or the decode batch, (K, N) = wi/wg (1,024, 2,816), wo (2,816,
# 1,024)
LM_QMATMUL = [(m, k, n) for m in (1, 4, 32, 64, 256)
              for k, n in ((1024, 2816), (2816, 1024))]


def _lm_model(layers=2, d_model=1024, vocab=151_936, dtype=torch.bfloat16):
    from repro_torch.models.transformer import LMConfig, TransformerLM
    return TransformerLM(LMConfig(
        name="lm", n_layers=layers, d_model=d_model, n_heads=16,
        n_kv_heads=16, head_dim=d_model // 16, d_ff=2816 * d_model // 1024,
        vocab=vocab, qkv_bias=True, rope_theta=1e6, dtype=dtype,
        remat="none"))


@pytest.mark.parametrize("m,k,n", LM_QMATMUL)
def test_qmatmul_lm_shapes_bitwise_with_a_bf16_out_dtype(card, m, k, n):
    """The kernel writes f32 and the wrapper casts after it, as the plain
    version does: bitwise in f32 and in bf16."""
    args = _qmatmul_operands(m, k, n, card)
    before = qm_ops.launches
    got = qm_ops.qmatmul(*args, out_dtype=torch.bfloat16)
    assert qm_ops.launches == before + 1 and got.dtype == torch.bfloat16
    assert torch.equal(got, qmatmul_ref(*args, torch.bfloat16))
    _agree("int8", qm_ops.qmatmul(*args), qmatmul_ref(*args))


def test_lm_engine_int8_tokens_equal_between_cuda_and_torch(card):
    """A 2-layer model at full width under ExecPolicy(quant="int8"): the
    engine through the qmatmul kernel and through its plain version on
    the same card gives the same tokens (integer sums are exact and the
    epilogue rounds twice in both)."""
    from repro_torch.serve import Engine, EngineConfig
    model = _lm_model()
    params = model.init(0, device=card)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 151_936, size=p) for p in (32, 64, 32, 64)]
    out = {}
    for backend in ("cuda", "torch"):
        eng = Engine(model, params, EngineConfig(
            capacity=2, max_seq=80,
            policy=ExecPolicy(quant="int8", backend=backend),
            device="cuda"))
        for p in prompts:
            eng.add_request(p, 6)
        out[backend] = {r.uid: r.generated for r in eng.run()}
    assert out["cuda"] == out["torch"] and len(out["cuda"]) == 4


def test_lm_launch_counts(card):
    """Under int8 each layer's MLP launches qmatmul three times (wi, wg,
    wo) in a prefill and in a decode step; nothing else launches it."""
    from repro_torch.ops import use_policy
    model = _lm_model(layers=3, d_model=256, vocab=1000)
    params = model.init(0, device=card)
    cache = model.init_cache(2, 24, device=card)
    toks = torch.randint(0, 1000, (2, 16), device=card)
    with use_policy(ExecPolicy(quant="int8")):
        before = qm_ops.launches
        _, cache = model.prefill(params, {"tokens": toks}, cache)
        assert qm_ops.launches - before == 3 * 3
        before = qm_ops.launches
        model.decode_step(params, toks[:, 0], torch.tensor([16, 16]), cache)
        assert qm_ops.launches - before == 3 * 3
    before = qm_ops.launches
    model.decode_step(params, toks[:, 0], torch.tensor([17, 17]), cache)
    assert qm_ops.launches == before               # no int8 policy


# the MLP shapes of the dense configs served under int8 since the MoE
# slice: a decode step's M = 4 and a prefill's M = 64 at command-r's
# largest K (22,528) and N (22,528), and qwen3-14b's wo
LARGE_K_QMATMUL = [(4, 22_528, 8192), (64, 22_528, 8192),
                   (64, 8192, 22_528), (64, 17_408, 5120)]


@pytest.mark.parametrize("m,k,n", LARGE_K_QMATMUL)
def test_qmatmul_large_k_shapes_bitwise(card, m, k, n):
    """One launch at K and N up to 22,528 (127² · 22,528 < 2³¹: the int32
    accumulator cannot overflow), bitwise to the plain version, whose
    K chunks keep its temporary under 256 MiB."""
    args = _qmatmul_operands(m, k, n, card)
    before = qm_ops.launches
    got = qm_ops.qmatmul(*args, out_dtype=torch.bfloat16)
    assert qm_ops.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, qmatmul_ref(*args, torch.bfloat16))


@pytest.mark.parametrize("n_shared,top_k", [(0, 4), (1, 1)])
def test_moe_apply_card_matches_cpu(card, n_shared, top_k):
    """moe_apply at a small width (d_model 256, 8 experts of d_ff 512) in
    fp32, card against CPU: the same expert and the same keep wherever
    the k-th and (k+1)-th probabilities are more than 1e-5 apart, the
    output within 1e-4 of 1 + max|want| on the batch rows (dispatch
    groups) that hold no near-tie,
    the aux loss within 1e-6, and no kernel launched."""
    from repro_torch.models import moe
    cfg = moe.MoEConfig(d_model=256, d_ff=512, n_experts=8, top_k=top_k,
                        n_shared=n_shared, capacity_factor=1.0)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg,
                          torch.device("cpu"))
    x = torch.randn((3, 64, 256), generator=torch.Generator().manual_seed(1))
    want, want_aux = moe.moe_apply(params, x, cfg, None)
    before = {m: m.launches for m in (fc_ops, cw_ops, qm_ops, at_ops)}
    dev = {k: v.to(card) for k, v in params.items()}
    got, aux = moe.moe_apply(dev, x.to(card), cfg, None)
    assert all(m.launches == n for m, n in before.items())
    probs, _, top_e, _ = moe._route(params, x, cfg)
    _, _, top_e_card, _ = moe._route(dev, x.to(card), cfg)
    srt = torch.sort(probs, dim=-1, descending=True).values
    clear = (srt[..., top_k - 1] - srt[..., top_k]) > 1e-5
    assert torch.equal(top_e_card.cpu()[clear], top_e[clear])
    cap = moe._capacity(64, cfg)
    _, keep = moe._slots(top_e.reshape(3, -1), 8, cap)
    _, keep_card = moe._slots(top_e_card.reshape(3, -1), 8, cap)
    whole = clear.all(dim=-1)                  # (B,): groups of no near-tie
    assert torch.equal(keep_card.cpu()[whole], keep[whole])
    err = float((got.cpu() - want).abs()[whole].max())
    assert err <= 1e-4 * (1 + float(want.abs().max())), err
    assert abs(float(aux) - float(want_aux)) <= 1e-6


# ---------------------------------------------------- kernels under autograd

@pytest.mark.parametrize("stage", sorted(STAGES))
def test_conv_window_function_gradients_match_plain(card, stage):
    """``ConvWindowFn`` (the kernel forward, cuDNN's conv gradients with
    TF32 off) against autograd through the plain conv on the card: the
    output and the three gradients within 1e-5 of 1 + max|want|."""
    x, w, b, _ = _operands(stage, "none", 3, card)
    g = torch.randn(conv2d_window_ref(x, w, b).shape,
                    generator=torch.Generator().manual_seed(5)).to(card)
    got, want = [], []
    for fn, out in ((cw_ops.conv_window, got), (conv2d_window_ref, want)):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = fn(*leaves)
        out.append(y.detach())
        out.extend(torch.autograd.grad((y * g).sum(), leaves))
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        tol = TOL_FP32 * (1 + float(e.abs().max()))
        assert float((a - e).abs().max()) <= tol


def test_conv_window_function_passes_gradcheck_against_its_backward(card):
    """``torch.autograd.gradcheck`` of the Function at a tiny shape: its
    analytic gradients against finite differences of its forward, in
    float32 (the kernel's only type), at float32's step and tolerance;
    cuDNN's weight gradient may sum in another order each call, hence
    ``nondet_tol``."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((1, 2, 6, 5), generator=gen).to(card)
    w = (torch.randn((3, 2, 3, 2), generator=gen) * 0.3).to(card)
    b = torch.randn((3,), generator=gen).to(card)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    assert torch.autograd.gradcheck(
        lambda *a: cw_ops.conv_window(*a, stride=(2, 1)), leaves,
        eps=1e-2, atol=1e-2, rtol=1e-2, nondet_tol=1e-5)


def test_the_other_kernels_refuse_inputs_that_require_grad(card):
    """``fused_cwp``, ``qmatmul`` and ``tree_reduce_sum`` have no
    backward: under grad mode an input that requires grad raises, naming
    the op, before any launch; under ``torch.no_grad`` they launch."""
    x, w, b, _ = _operands("conv2", "none", 2, card)
    xq = torch.randint(-127, 128, (4, 32), dtype=torch.int8).to(card)
    wq = torch.randint(-127, 128, (32, 8), dtype=torch.int8).to(card)
    xs = torch.rand((4, 1), device=card, requires_grad=True)
    calls = {
        "fused_cwp": lambda: fc_ops.fused_cwp(
            x, w.clone().requires_grad_(True), b),
        "qmatmul": lambda: qm_ops.qmatmul(xq, wq, xs, 0.5),
        "tree_reduce_sum": lambda: at_ops.tree_reduce_sum(
            torch.rand((8, 9), device=card, requires_grad=True)),
    }
    for name, call in calls.items():
        before = (fc_ops.launches, qm_ops.launches, at_ops.launches)
        with pytest.raises(RuntimeError, match=name):
            call()
        assert (fc_ops.launches, qm_ops.launches, at_ops.launches) == before
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


# ------------------------------------------------------------ step graphs
# The compiled LM and train steps (serve/graphs.py): every graph replay
# is held bitwise against the same step run eagerly on the same buffers.

GRAPH_MODES = ("bf16", "int8_kv", "int8")


def _engine_config(mode, **kw):
    """bf16 weights and cache; bf16 with an int8 KV cache; int8 compute
    (the MLP through qmatmul, the cache in int8)."""
    from repro_torch.serve import EngineConfig
    return EngineConfig(
        policy=ExecPolicy(quant="int8") if mode == "int8" else ExecPolicy(),
        kv_quant="int8" if mode == "int8_kv" else None, device="cuda", **kw)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_tree(v) for v in tree)
    return tree.clone()


def _step_logits(model, eng, prompt, compiled):
    """A prefill's logits and a decode step's over the engine's filled
    slots, through StepGraphs (captured, or run eagerly on the same
    buffers), the decode from its own copy of the slot state."""
    from repro_torch.ops import use_policy
    from repro_torch.serve.engine import engine_decode_step
    from repro_torch.serve.graphs import StepGraph, tree_tensors
    dev, pol = eng.device, eng.config.policy
    decode = engine_decode_step(model, eng.config, sample=False)

    def prefill(params, tokens, cache):
        for leaf in tree_tensors(cache):
            leaf.zero_()
        with use_policy(pol), torch.no_grad():
            return model.prefill(params, {"tokens": tokens}, cache)[0]

    def step(params, tokens, pos, state):
        return decode(params, tokens, pos, *state)[0]

    state = _clone_tree(eng.kv.device_state())
    pre = StepGraph(prefill, {
        "params": eng.params,
        "tokens": torch.as_tensor(prompt[None], device=dev),
        "cache": model.init_cache(1, len(prompt), device=dev)},
        device=dev, compiled=compiled)
    dec = StepGraph(step, {
        "params": eng.params,
        "tokens": torch.as_tensor(eng._last_token, device=dev),
        "pos": torch.as_tensor(eng.kv.positions(), device=dev),
        "state": state}, state=state, device=dev, compiled=compiled)
    out = pre().clone(), dec().clone()
    assert pre.captured == dec.captured == compiled
    return out


@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_engine_graphs_are_bitwise_to_eager_steps(card, mode):
    """The engine through its graphs and with ``graphs=False`` (the same
    steps eagerly on the same buffers): the same tokens; under int8 the
    replays launched qmatmul 3 x layers a prefill and a decode step; a
    prefill's and a 2-slot decode step's logits bitwise graph vs eager."""
    from repro_torch.serve import Engine
    model = _lm_model(layers=2, d_model=256, vocab=1000)
    params = model.init(0, device=card)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 1000, size=p) for p in (16, 32, 16, 32)]
    out = {}
    for graphs in (True, False):
        eng = Engine(model, params, _engine_config(
            mode, capacity=2, max_seq=48, graphs=graphs))
        for p in prompts:
            eng.add_request(p, 8)
        out[graphs] = {r.uid: r.generated for r in eng.run()}
        if graphs:
            steps = eng.stats.decode_lane_steps // 2
            assert all(g.captured for g in eng.graphs())
            launched = eng.graph_launches().get("qmatmul", 0)
            want = 6 * (eng.stats.prefills + steps) if mode == "int8" else 0
            assert launched == want, (launched, want)
    assert out[True] == out[False] and len(out[True]) == 4
    eng = Engine(model, params, _engine_config(mode, capacity=2,
                                               max_seq=48))
    for p in prompts[:2]:
        eng.add_request(p, 8)
    eng._admit()
    got = _step_logits(model, eng, prompts[1], compiled=True)
    want = _step_logits(model, eng, prompts[1], compiled=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_prefill_graphs_evict_and_capture_again_in_one_pool(card,
                                                            monkeypatch):
    """Two prefill graphs at most: a third length evicts the least
    recently used, which is captured again when its length comes back;
    the tokens are those of the eager engine, so no replay overwrote a
    prefill's output before the engine read it."""
    import repro_torch.serve.engine as engine_mod
    from repro_torch.serve import Engine
    monkeypatch.setattr(engine_mod, "MAX_PREFILL_GRAPHS", 2)
    model = _lm_model(layers=2, d_model=256, vocab=1000)
    params = model.init(0, device=card)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 1000, size=p) for p in (8, 16, 24, 8, 16)]
    out = {}
    for graphs in (True, False):
        eng = Engine(model, params, _engine_config(
            "bf16", capacity=1, max_seq=40, graphs=graphs))
        for p in prompts:
            eng.add_request(p, 4)
        out[graphs] = {r.uid: r.generated for r in eng.run()}
        if graphs:
            assert eng.captures == {8: 2, 16: 2, 24: 1}
            assert len(eng.evicted) == 3
            prefill_calls = sum(g.calls for g in eng.graphs()) - \
                eng._decode_graph.calls
            assert prefill_calls == eng.stats.prefills == 5
    assert out[True] == out[False]


def test_step_graphs_refuse_an_autotuning_policy(card):
    """The tuner measures launches, which a capture cannot hold: an
    engine under an autotuning policy is refused on the card."""
    from repro_torch.serve import Engine, EngineConfig
    model = _lm_model(layers=1, d_model=256, vocab=1000)
    params = model.init(0, device=card)
    with pytest.raises(ValueError, match="autotun"):
        Engine(model, params, EngineConfig(
            policy=ExecPolicy(quant="int8", autotune=True), device="cuda"))


def _train_runs(card, monkeypatch, model, batches, opt_cfg):
    """Three steps of ``model`` through the train graph and eagerly on
    the same buffers (deterministic algorithms on, as the launcher runs):
    {compiled: (losses, params, graph)}."""
    from repro_torch.optim import adamw_init
    from repro_torch.serve.graphs import train_graph
    from repro_torch.train import make_train_step
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    out = {}
    try:
        for compiled in (True, False):
            params = model.init(0, device=card)
            opt = adamw_init(params)
            g = train_graph(make_train_step(model, opt_cfg), params, opt,
                            {k: v.to(card) for k, v in batches[0].items()},
                            device=card, compiled=compiled)
            losses = [g(batch=b)["loss"].clone() for b in batches]
            out[compiled] = (losses, params, g)
    finally:
        torch.use_deterministic_algorithms(was)
    return out


def test_lm_train_graph_is_bitwise_to_eager(card, monkeypatch):
    """A 2-layer LM at d_model 256: three train steps through the graph
    and eagerly, losses and new params bitwise."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim import AdamWConfig
    model = _lm_model(layers=2, d_model=256, vocab=1000)
    g = torch.Generator().manual_seed(0)
    batches = [{k: torch.randint(0, 1000, (4, 32), generator=g,
                                 dtype=torch.int32)
                for k in ("tokens", "labels")} for _ in range(3)]
    out = _train_runs(card, monkeypatch, model, batches,
                      AdamWConfig(total_steps=3, warmup_steps=1))
    (gl, gp, graph), (el, ep, _) = out[True], out[False]
    assert graph.captured and graph.calls == 3
    assert all(torch.equal(a, b) for a, b in zip(gl, el))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gp),
                                                 tree_leaves(ep)))


def test_mnist_train_graph_replays_conv_window(card, monkeypatch):
    """``PaperCNN`` through ``ConvWindowFn``: the train graph holds 2
    ``conv_window`` launches a replay (the forward convs; cuDNN's
    backward), and three steps are bitwise to the eager ones."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import SyntheticMNIST
    from repro_torch.optim import AdamWConfig
    data = SyntheticMNIST(seed=0)
    batches = [data.batch(32, step=i) for i in range(3)]
    out = _train_runs(card, monkeypatch, PaperCNN(PaperCNNConfig()),
                      batches, AdamWConfig(lr=2e-3, warmup_steps=2,
                                           total_steps=3))
    (gl, gp, graph), (el, ep, _) = out[True], out[False]
    assert graph.kernels["conv_window"] == 2 and graph.calls == 3
    assert all(torch.equal(a, b) for a, b in zip(gl, el))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gp),
                                                 tree_leaves(ep)))


# ------------------------------------------- the conv kernels' int8 route

# (N, H, W, M, K), stride, launch keys: depth off a multiple of 32 (5 x 7
# x 7 = 245) and M = 13; stride 2 on an odd map with 2 items a block; a
# 2 x 2 kernel with 40 channels at 32 a block; the paper's conv2
S8_CASES = {
    "eta245 M13": ((5, 17, 19, 13, 7), (1, 1), {"cpb": 24}),
    "stride2 items": ((3, 35, 43, 5, 3), (2, 2), {"band": 3, "items": 2}),
    "k2 M40": ((9, 12, 14, 40, 2), (1, 1), {"cpb": 32}),
    "conv2": ((15, 13, 13, 20, 6), (1, 1), {}),
}


def _s8_operands(card, shape, bsz, seed=0):
    """int8 codes of x and w as the op layer splits them (split_int8 is
    split_requant without the cast), the requant scale and a bias."""
    n, h, w_, m, k = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((bsz, n, h, w_), generator=g)
    w = torch.randn((m, n, k, k), generator=g) * (n * k * k) ** -0.5
    b = torch.randn((m,), generator=g) * 0.1
    xq, wq = quantize_conv_int8(x, w)
    scale = (xq.scale * wq.scale).reshape(-1)
    return tuple(t.to(card) for t in (xq.codes, wq.codes, scale, b))


@pytest.mark.parametrize("bsz", [1, 8, 1024])
@pytest.mark.parametrize("case", sorted(S8_CASES))
def test_int8_route_matches_plain_bitwise(card, case, bsz):
    """int8 codes take the int8 route (counted in ``launches_int8``) and
    are bitwise to the plain version and to the fp32 route on the same
    codes as fp32, pooled under odd='pad' and unpooled."""
    shape, stride, keys = S8_CASES[case]
    x, w, s, b = _s8_operands(card, shape, bsz)
    for mod, ns in ((fc_ops, "fused_conv_block"), (cw_ops, "conv2d")):
        pol = ExecPolicy(tiling={f"{ns}.{k}": v for k, v in keys.items()})
        before = (mod.launches, mod.launches_int8)
        if mod is fc_ops:
            def run(x, w):
                return fc_ops.fused_cwp(x, w, b, stride=stride, scale=s,
                                        odd="pad", policy=pol)
            want = fused_cwp_ref(x, w, b, stride, odd="pad", scale=s)
        else:
            def run(x, w):
                return cw_ops.conv_window(x, w, b, stride=stride,
                                          policy=pol)
            want = conv2d_window_ref(x, w, b, stride=stride)
        got = run(x, w)
        torch.cuda.synchronize()
        assert (mod.launches, mod.launches_int8) == (before[0] + 1,
                                                     before[1] + 1)
        assert torch.equal(got, want)
        assert torch.equal(run(x.float(), w.float()), got)


def test_int8_route_unaligned_views_match_plain_bitwise(card):
    """Codes one byte into their storage, weights three: no word of
    either is 4-byte aligned."""
    x, w, s, b = _s8_operands(card, STAGES["conv2"], 8)
    xu = torch.empty(x.numel() + 1, dtype=torch.int8, device=card)[1:]
    wu = torch.empty(w.numel() + 3, dtype=torch.int8, device=card)[3:]
    xu, wu = xu.view(x.shape), wu.view(w.shape)
    xu.copy_(x)
    wu.copy_(w)
    assert torch.equal(fc_ops.fused_cwp(xu, wu, b, scale=s),
                       fused_cwp_ref(x, w, b, scale=s))
    assert torch.equal(cw_ops.conv_window(xu, wu), conv2d_window_ref(x, w))


def test_int8_route_graph_replays_match_plain_bitwise(card):
    """Captured once in a CUDA graph, replayed on new codes copied into
    the static input: bitwise each time, one launch counted at capture."""
    x, w, s, b = _s8_operands(card, STAGES["conv2"], 8)
    static = x.clone()
    fc_ops.fused_cwp(static, w, b, scale=s)
    torch.cuda.synchronize()
    before = fc_ops.launches_int8
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fc_ops.fused_cwp(static, w, b, scale=s)
    assert fc_ops.launches_int8 == before + 1
    for seed in (1, 2, 3):
        xn, _, _, _ = _s8_operands(card, STAGES["conv2"], 8, seed)
        static.copy_(xn)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fused_cwp_ref(xn, w, b, scale=s))
    assert fc_ops.launches_int8 == before + 1


@pytest.mark.parametrize("arch", ["mnist_cnn", "highres_cnn"])
def test_int8_plans_take_the_int8_route(card, arch):
    """Every conv launch of an int8 plan on the card takes the int8 route
    (no conv call casts its codes), and the logits equal the CPU's."""
    model = (PaperCNN(PaperCNNConfig(policy=ExecPolicy(quant="int8")))
             if arch == "mnist_cnn" else
             VGGStyleCNN(VGGStyleCNNConfig(policy=ExecPolicy(quant="int8"))))
    params = model.init(0, device="cpu")
    x = torch.randn(model.input_shape(2), generator=torch.Generator(
        ).manual_seed(4))
    plan = model.compile(batch=2)
    before = {m: (m.launches, m.launches_int8) for m in (fc_ops, cw_ops)}
    with torch.inference_mode():
        got = plan.bind({k: (v.to(card) if isinstance(v, torch.Tensor) else
                             {kk: vv.to(card) for kk, vv in v.items()})
                         for k, v in params.items()})(x.to(card))
        want = plan.bind(params)(x)
    for m, (n0, n8) in before.items():
        assert m.launches - n0 == m.launches_int8 - n8
    assert fc_ops.launches > before[fc_ops][0]
    assert torch.equal(got.cpu(), want)
