"""The odd-even addition tree slice of the port against the JAX package:
the ``addtree`` kernel's plain version and wrapper, the
``tree_reduce_sum`` op family, the paper-dataflow conv through it, the
tree and window-buffer models (C2/C3) and the quantize leftovers.

Inputs come from numpy with a fixed seed and go through both packages.
The tree's summation order is the contract, so every tree comparison is
bitwise, except ``torch`` against ``xla``: both are library sums in
orders of their own, held to |Δ| ≤ 1e-6·Σ|x| per row (measured here the
gap is 1.5e-5 at η = 540, where Σ|x| ≈ 430: about 30× inside it).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import addtree as j_addtree
from repro.core import quantize as j_quant
from repro.core import window as j_window
from repro.kernels.addtree.ops import tree_reduce_sum as j_tree_kernel
from repro.ops import ExecPolicy as JPolicy
from repro.ops import conv2d as j_conv2d
from repro.ops import quantize_conv_int8 as j_quantize_conv_int8
from repro.ops import split_requant as j_split_requant
from repro.ops import tree_reduce_sum as j_tree_reduce_sum
from repro_torch.core import addtree as t_addtree
from repro_torch.core import quantize as t_quant
from repro_torch.core import window as t_window
from repro_torch.kernels import build
from repro_torch.kernels.addtree import ops as at_ops
from repro_torch.kernels.addtree.ref import (tree_reduce_sum_levels,
                                            tree_reduce_sum_ref)
from repro_torch.ops import (REGISTRY, BackendUnavailableError, ExecPolicy,
                             list_backends, list_ops, tiling,
                             tree_reduce_sum)

# tests/test_kernels.py's addtree shapes, then a prime R, a ragged R, and
# the paper CNN's conv2 η = 540 and a wider 1350
SHAPES = [(4, 9), (256, 144), (96, 7), (8, 1), (100, 37), (16, 256),
          (509, 144), (1024, 37), (64, 540), (64, 1350)]
# the paper CNN's conv stages: (N, H, W, M, K)
STAGES = {"conv1": (1, 28, 28, 15, 3), "conv2": (15, 13, 13, 20, 6)}
# fp32 conv sums: the JAX ref backend's compiler may contract a product
# into the tree's first add (one rounding fewer); |y| is O(10) here
TOL_FP32 = 1e-5
CAP = tiling.TREE_MAX_ETA


def _x(shape, seed=None) -> np.ndarray:
    seed = shape[1] if seed is None else seed
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _same(a, b) -> None:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ----------------------------------------- plain version vs the Pallas kernel

@pytest.mark.parametrize("shape", SHAPES)
def test_plain_and_wrapper_match_pallas_bitwise(shape):
    x = _x(shape)
    want = j_tree_kernel(jnp.asarray(x), interpret=True)
    before = at_ops.launches
    _same(tree_reduce_sum_ref(_t(x)), want)
    _same(at_ops.tree_reduce_sum(_t(x)), want)
    assert at_ops.launches == before          # the CPU runs no kernel


# the kernel's order: aligned 2**k chunks as perfect trees, then the tree
# over level k (k = 1..3 as stated, 4 and 6 where the kernel's lanes stop)
LEVEL_ETAS = list(range(1, 65)) + [65, 96, 127, 128, 129, 143, 144, 255,
                                   256, 257, 540, 1023, 1024, 1025, 1350,
                                   2047, 4096, CAP - 1, CAP]


@functools.cache
def _jax_tree(eta: int) -> np.ndarray:
    return np.asarray(j_addtree.pairwise_sum(jnp.asarray(_x((3, eta))),
                                             axis=-1))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("eta", LEVEL_ETAS)
def test_level_k_restatement_is_the_tree(eta, k):
    x = _t(_x((3, eta)))
    got = tree_reduce_sum_levels(x, k)
    _same(got, t_addtree.pairwise_sum(x))
    _same(got, _jax_tree(eta))


# ------------------------------------- op family vs the JAX family, per backend

@pytest.mark.parametrize("shape", [(4, 9), (509, 144), (64, 540), (64, 1350)])
@pytest.mark.parametrize("mine,theirs", [("ref", "ref"), ("cuda", "pallas"),
                                         ("torch", "xla")])
def test_backend_matches_jax_backend(shape, mine, theirs):
    x = _x(shape, seed=7)
    got = tree_reduce_sum(_t(x), policy=ExecPolicy(backend=mine)).numpy()
    want = np.asarray(j_tree_reduce_sum(jnp.asarray(x),
                                        policy=JPolicy(backend=theirs)))
    if mine != "torch":
        _same(got, want)
        return
    assert got.shape == want.shape
    gap = np.abs(got.astype(np.float64) - want)
    assert (gap <= 1e-6 * np.abs(x).astype(np.float64).sum(-1)).all()


# ---------------------------------------------------- registry and wrapper

def test_family_registered_with_backends_by_device():
    assert "tree_reduce_sum" in list_ops()
    assert list_backends("tree_reduce_sum", "cpu") == ["torch", "cuda", "ref"]
    assert list_backends("tree_reduce_sum", "cuda") == ["cuda"]


def test_named_cuda_refuses_3d_and_auto_gives_torch_sum():
    x3 = _t(_x((2, 4, 9)))
    with pytest.raises(BackendUnavailableError):
        tree_reduce_sum(x3, policy=ExecPolicy(backend="cuda"))
    assert torch.equal(tree_reduce_sum(x3), torch.sum(x3, dim=-1))
    x = _t(_x((5, 9)))
    assert torch.equal(tree_reduce_sum(x), torch.sum(x, dim=-1))


@pytest.mark.parametrize("case", ["over_cap", "float64", "empty_rows"])
def test_predicate_refuses(case):
    x = {"over_cap": torch.zeros(2, CAP + 1),
         "float64": torch.zeros(2, 9, dtype=torch.float64),
         "empty_rows": torch.zeros(2, 0)}[case]
    with pytest.raises(BackendUnavailableError):
        tree_reduce_sum(x, policy=ExecPolicy(backend="cuda"))


def test_the_cap_itself_is_accepted():
    x = _t(_x((3, CAP)))
    _same(tree_reduce_sum(x, policy=ExecPolicy(backend="cuda")),
          t_addtree.pairwise_sum(x))


class _CudaLike:
    """Shape-only stand-in for a CUDA tensor: dispatch reads its device
    and the predicate its shape and dtype, and nothing may run on it."""

    def __init__(self, shape, dtype=torch.float32):
        self.shape = shape
        self.ndim = len(shape)
        self.dtype = dtype
        self.device = torch.device("cuda")

    def contiguous(self):
        raise AssertionError("a backend ran on a refused CUDA call")


@pytest.mark.parametrize("shape,dtype", [((2, 4, 9), torch.float32),
                                         ((2, CAP + 1), torch.float32),
                                         ((2, 9), torch.float16)])
def test_cuda_call_the_kernel_refuses_raises(shape, dtype):
    """On a CUDA tensor only the kernel is a candidate: what its predicate
    refuses raises instead of falling back to ``torch.sum``."""
    with pytest.raises(BackendUnavailableError):
        REGISTRY.dispatch("tree_reduce_sum", _CudaLike(shape, dtype))


@pytest.mark.parametrize("case", ["dtype", "rank", "contiguity", "zero_eta",
                                  "over_cap", "not_a_tensor"])
def test_wrapper_rejects_bad_arguments(case):
    x = {"dtype": torch.zeros(4, 9, dtype=torch.float64),
         "rank": torch.zeros(2, 4, 9),
         "contiguity": torch.zeros(9, 4).t(),
         "zero_eta": torch.zeros(4, 0),
         "over_cap": torch.zeros(2, CAP + 1),
         "not_a_tensor": np.zeros((4, 9), np.float32)}[case]
    with pytest.raises((TypeError, ValueError)):
        at_ops.tree_reduce_sum(x)


def test_wrapper_empty_rows_on_cpu():
    out = at_ops.tree_reduce_sum(torch.zeros(0, 9))
    assert out.shape == (0,) and out.dtype == torch.float32


@pytest.mark.parametrize("r,eta,threads,rows,lanes", [
    (4, 1, 128, 128, 32), (81_120, 9, 128, 128, 32),
    (10_383_360, 32, 128, 128, 32), (13, 33, 256, 16, 16),
    (10_240, 540, 256, 16, 16), (16_896, 144, 256, 16, 16),
    (16_897, 144, 256, 8, 32), (1_310_720, 540, 256, 8, 32),
    (33, CAP, 256, 16, 16)])
def test_choose_tree_blocks(r, eta, threads, rows, lanes):
    """A thread a row up to η = 32 (128 a block); above, 256 threads, a
    half-warp a row while 132 SMs × 128 half-warps cover R, a warp a row
    on more."""
    assert tiling.choose_tree_blocks(r, eta) == {
        "threads": threads, "rows": rows, "short_eta": 32,
        "row_lanes": lanes}


def test_tree_tiling_overrides():
    d = tiling.choose_tree_blocks(10_240, 540)
    assert tiling.block_threads("tree_reduce_sum", d,
                                {"tree_reduce_sum.threads": 64}) == 64
    assert tiling.block_threads("tree_reduce_sum", d, {"threads": 128}) == 128
    assert tiling.block_threads("tree_reduce_sum", d,
                                {"conv2d.threads": 64}) == 256
    with pytest.raises(ValueError):
        tiling.block_threads("tree_reduce_sum", d,
                             {"tree_reduce_sum.threads": 40})


@pytest.mark.parametrize("r,eta,overrides,want", [
    (100, 9, {}, {"threads": 128, "rows": 128, "short_eta": 32,
                  "row_lanes": 32, "smem": 128 * 9 * 4}),
    (100, 16, {}, {"threads": 128, "rows": 128, "short_eta": 32,
                   "row_lanes": 32, "smem": 128 * 17 * 4}),  # odd stride
    (10_240, 540, {}, {"rows": 16, "short_eta": 32, "row_lanes": 16,
                       "smem": 16 * 34 * 4}),             # ⌈540/16⌉ a row
    (10**6, 540, {}, {"rows": 8, "short_eta": 32, "row_lanes": 32,
                      "smem": 8 * 34 * 4}),
    (100, 9, {"tree_reduce_sum.rows": 100, "tree_reduce_sum.short_eta": 4},
     {"threads": 128, "rows": 100, "short_eta": 4, "row_lanes": 32,
      "smem": 4 * 1 * 4}),
    (100, 540, {"rows": 3, "threads": 64, "conv2d.rows": 1},
     {"rows": 3, "short_eta": 32, "row_lanes": 16, "smem": 4 * 34 * 4}),
    (100, 540, {"tree_reduce_sum.row_lanes": 32},
     {"rows": 16, "short_eta": 32, "row_lanes": 32, "smem": 8 * 34 * 4}),
    (100, 540, {"tree_reduce_sum.short_eta": 540},
     {"rows": 16, "short_eta": 540, "row_lanes": 16, "smem": 16 * 541 * 4}),
])
def test_tree_tiles_resolve_overrides(r, eta, overrides, want):
    threads = 64 if "threads" in overrides else 256
    assert tiling.tree_tiles(r, eta, overrides) == {"threads": threads,
                                                    **want}


@pytest.mark.parametrize("overrides", [{"tree_reduce_sum.rows": 0},
                                       {"tree_reduce_sum.threads": 48},
                                       {"tree_reduce_sum.row_lanes": 8},
                                       {"tree_reduce_sum.rows": 100_000}])
def test_tree_tiles_refuse_what_cannot_launch(overrides):
    with pytest.raises(ValueError):
        tiling.tree_tiles(100, 9, overrides)


def test_addtree_source_is_built_and_content_keyed():
    assert "addtree" in build.SOURCES
    assert (build.CSRC / "addtree.cu").is_file()
    p = build.library_path("addtree")
    assert p.parent == build.BUILD_DIR and p.name.startswith("libaddtree-")
    assert p != build.library_path("qmatmul")


# ------------------------------------------- the paper-dataflow conv on the tree

def _conv_operands(stage, mode, bsz=2, seed=0):
    n, h, w_, m, k = STAGES[stage]
    rng = np.random.RandomState(seed)
    x = rng.randn(bsz, n, h, w_).astype(np.float32)
    w = (rng.randn(m, n, k, k) / np.sqrt(n * k * k)).astype(np.float32)
    b = (rng.randn(m) * 0.1).astype(np.float32)
    if mode == "int8":     # integer-valued f32 codes, as the op layer has them
        xc, wc, _ = j_split_requant(*j_quantize_conv_int8(jnp.asarray(x),
                                                          jnp.asarray(w)))
        x, w = np.asarray(xc), np.asarray(wc)
    return x, w, b


@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_products_through_the_tree_are_conv2d_ref(stage, mode):
    x, w, b = _conv_operands(stage, mode)
    prod = t_window.window_products(_t(x), _t(w))          # (B,Ho,Wo,M,η)
    sums = tree_reduce_sum(prod.reshape(-1, prod.shape[-1]),
                           policy=ExecPolicy(backend="cuda"))
    got = (sums.reshape(prod.shape[:-1]) + _t(b)).permute(0, 3, 1, 2)
    _same(got, t_window.conv2d_ref(_t(x), _t(w), _t(b)))
    want = np.asarray(j_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               policy=JPolicy(backend="ref")))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_FP32,
                               atol=TOL_FP32)


# ------------------------------------------------------ C2 and C3 models

def test_tree_models_match_jax():
    for eta in range(1, 301):
        assert t_addtree.level_widths(eta) == j_addtree.level_widths(eta)
        for fn in ("tree_resources", "classic_tree_resources"):
            mine = getattr(t_addtree, fn)(eta)
            theirs = getattr(j_addtree, fn)(eta)
            assert (mine.eta, mine.adders, mine.registers, mine.cycles,
                    mine.padded_inputs, mine.padding_waste) == \
                (theirs.eta, theirs.adders, theirs.registers, theirs.cycles,
                 theirs.padded_inputs, theirs.padding_waste)
    for fn in (t_addtree.level_widths, t_addtree.tree_resources,
               t_addtree.classic_tree_resources):
        with pytest.raises(ValueError):
            fn(0)


@pytest.mark.parametrize("eta,ours,classic", [(9, (8, 20, 4), (15, 31, 4)),
                                              (144, (143, 290, 8),
                                               (255, 511, 8)),
                                              (256, (255, 511, 8),
                                               (255, 511, 8))])
def test_paper_worked_numbers(eta, ours, classic):
    """§III.B.1: η = 9 costs ours 8/20/4 against the classic 15/31/4;
    144 and 256 inputs both cost the classic tree 255/511/8."""
    o, c = t_addtree.tree_resources(eta), t_addtree.classic_tree_resources(eta)
    assert (o.adders, o.registers, o.cycles) == ours
    assert (c.adders, c.registers, c.cycles) == classic


@pytest.mark.parametrize("shape", [(4, 9), (3, 144), (2, 256)])
def test_classic_padded_sum_bitwise(shape):
    x = _x(shape, seed=11)
    _same(t_addtree.classic_padded_sum(_t(x)),
          j_addtree.classic_padded_sum(jnp.asarray(x)))


def test_classic_padded_sum_axis_and_keepdim():
    x = _x((3, 9, 4), seed=12)
    _same(t_addtree.classic_padded_sum(_t(x), axis=1, keepdim=True),
          j_addtree.classic_padded_sum(jnp.asarray(x), axis=1,
                                       keepdims=True))


@pytest.mark.parametrize("k,w,kw", [(3, 8, None), (6, 13, None), (1, 5, None),
                                    (2, 9, 5), (3, 7, 2)])
def test_fill_latency_and_reuse_ratio(k, w, kw):
    assert t_window.fill_latency(k, w, kw) == j_window.fill_latency(k, w, kw)
    assert t_window.reuse_ratio(k) == j_window.reuse_ratio(k)


@pytest.mark.parametrize("k", [3, (2, 3)])
@pytest.mark.parametrize("stride", [(1, 1), (2, 1)])
def test_line_buffer_stream_matches_jax(k, stride):
    image = np.random.RandomState(13).randn(7, 9)
    mine = list(t_window.LineBufferSim(k, 9).run(image, stride))
    theirs = list(j_window.LineBufferSim(k, 9).run(image, stride))
    assert len(mine) == len(theirs) > 0
    for (c1, r1, q1, w1), (c2, r2, q2, w2) in zip(mine, theirs):
        assert (c1, r1, q1) == (c2, r2, q2)
        np.testing.assert_array_equal(w1, w2)
    kh, kw = (k, k) if isinstance(k, int) else k
    cyc, r, c, win = mine[0]
    assert cyc == t_window.fill_latency(kh, 9, kw) + 1
    np.testing.assert_array_equal(win, image[r:r + kh, c:c + kw])


def test_line_buffer_rejects_bad_shapes():
    with pytest.raises(ValueError):
        t_window.LineBufferSim((2, 10), 9)
    with pytest.raises(ValueError):
        list(t_window.LineBufferSim(3, 9).run(np.zeros((7, 8))))


# --------------------------------------------------------- quantize leftovers

@pytest.mark.parametrize("bits", [(8, 8), (4, 4), (6, 10)])
def test_qformat_int_codes_bitwise(bits):
    q_j, q_t = j_quant.QFormat(*bits), t_quant.QFormat(*bits)
    x = (np.random.RandomState(14).randn(300) * 2 ** (bits[0] - 1))
    halves = (np.arange(-8, 9) + 0.5) * q_t.step
    x = np.concatenate([x, halves, [1e6, -1e6]]).astype(np.float32)
    codes = q_t.quantize_int(_t(x))
    _same(codes, q_j.quantize_int(jnp.asarray(x)))
    _same(q_t.dequantize_int(codes), q_j.dequantize_int(jnp.asarray(codes)))
    _same(q_t.dequantize_int(codes), q_t.quantize(_t(x)))


@pytest.mark.parametrize("shape,axis", [((6, 320), -1), ((320, 10), 0),
                                        ((3, 2, 5, 5), None)])
def test_dequantize_int8_bitwise(shape, axis):
    x = (np.random.RandomState(15).randn(*shape) * 3).astype(np.float32)
    j = j_quant.quantize_int8(jnp.asarray(x), axis)
    t = t_quant.quantize_int8(_t(x), axis)
    _same(t_quant.dequantize_int8(t), j_quant.dequantize_int8(j))
