"""The port's kernels against the JAX Pallas kernels, and their wrappers.

Each kernel's plain PyTorch version (``kernels/*/ref.py``) is held
against the Pallas kernel it replaces, run in interpret mode on the CPU
as the JAX package's own tests run it, in every number format the kernel
sees on the paper CNN. Tolerances, per mode:

* int8  — bitwise: the convs contract integer-valued f32 codes
  (η·127² < 2²⁴, so every summation order is exact) and ``qmatmul``
  accumulates in int32. The one exception is the interpreted fused
  kernel's epilogue (see ``test_fused_cwp_plain_matches_pallas``).
* qformat — within one Q8.8 lattice step after the output snap: sums of
  Q8.8 products are exact only while they fit 24 bits.
* none  — rtol = atol = 1e-5: the fp32 sums run in another order than
  the TPU kernel's contraction.

The wrappers run their plain version on a CPU tensor and are checked
here for argument validation and launch counting; the CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_window.ops import conv2d_window as j_conv_window
from repro.kernels.fused_cwp.ops import fused_conv_window as j_fused
from repro.kernels.qmatmul.ops import qmatmul as j_qmatmul
from repro.ops import ExecPolicy as JPolicy
from repro.ops import quantize_conv_int8 as j_quantize_conv_int8
from repro.ops import split_requant as j_split_requant
from repro.ops.registry import REGISTRY as J_REGISTRY
from repro_torch.core.quantize import QFormat, quantize_int8
from repro_torch.kernels import build
from repro_torch.kernels.conv_window import ops as cw_ops
from repro_torch.kernels.conv_window.ref import conv2d_window_ref
from repro_torch.kernels.fused_cwp import ops as fc_ops
from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
from repro_torch.kernels.qmatmul import ops as qm_ops
from repro_torch.kernels.qmatmul.ref import qmatmul_ref
from repro_torch.ops import (BackendUnavailableError, ExecPolicy, REGISTRY,
                             fused_conv_block, list_backends,
                             quantize_conv_int8, split_requant)
from repro_torch.ops import tiling

PALLAS = JPolicy(backend="pallas")
TOL_FP32 = 1e-5
QSTEP = 2.0 ** -8
# the paper CNN's conv stages: (N, H, W, M, K); the fc is (320, 10)
STAGES = {"conv1": (1, 28, 28, 15, 3), "conv2": (15, 13, 13, 20, 6)}
FC = (320, 10)
MODES = ("none", "qformat", "int8")


def _t(a):
    return torch.from_numpy(np.array(a))


def _conv_operands(stage: str, mode: str, bsz: int = 2, seed: int = 0):
    """Numpy (x, w, b, scale) for one stage in one mode, as the op layer
    hands them to the kernel: lattice values under qformat, integer-valued
    f32 codes plus the per-channel requant scale under int8 (quantized by
    the JAX package, so both sides see the same codes)."""
    n, h, w_, m, k = STAGES[stage]
    rng = np.random.RandomState(seed)
    x = rng.randn(bsz, n, h, w_).astype(np.float32)
    w = (rng.randn(m, n, k, k) / np.sqrt(n * k * k)).astype(np.float32)
    b = (rng.randn(m) * 0.1).astype(np.float32)
    scale = None
    if mode == "qformat":
        q = QFormat()
        x, w, b = (q.quantize(_t(a)).numpy() for a in (x, w, b))
    elif mode == "int8":
        xc, wc, s = j_split_requant(*j_quantize_conv_int8(jnp.asarray(x),
                                                          jnp.asarray(w)))
        x, w, scale = np.asarray(xc), np.asarray(wc), np.asarray(s)
    return x, w, b, scale


def _agree(mode: str, got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    if mode == "int8":
        np.testing.assert_array_equal(got, want)
    elif mode == "qformat":
        q = QFormat()
        g, w = q.quantize(_t(got)).numpy(), q.quantize(_t(want)).numpy()
        diff = np.abs(g - w)
        assert diff.max() <= QSTEP, (
            f"{int((diff > 0).sum())} elements differ, max {diff.max()}")
    else:
        np.testing.assert_allclose(got, want, rtol=TOL_FP32, atol=TOL_FP32)


# ------------------------------------------- plain versions vs Pallas

@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("mode", MODES)
def test_fused_cwp_plain_matches_pallas(stage, mode):
    """Under int8 the Pallas kernel, interpreted on the CPU, contracts its
    requant epilogue ``acc·s + b`` into one fused multiply-add despite the
    optimization barrier that pins two roundings (jax 0.9.0), so it sits
    up to one rounding of the product acc·s (ε·|acc·s| ≤ ε·(|y| + |b|))
    from the two-rounding result. The port keeps the two roundings, which
    the reference's own ``xla`` backend of the same op family computes:
    against that backend int8 is bitwise."""
    x, w, b, s = (None if a is None else jnp.asarray(a)
                  for a in _conv_operands(stage, mode))
    want = np.asarray(j_fused(x, w, b, scale=s, policy=PALLAS))
    got = fused_cwp_ref(*(None if a is None else _t(np.asarray(a))
                          for a in (x, w, b)),
                        scale=None if s is None else _t(np.asarray(s)))
    got = got.numpy()
    if mode != "int8":
        _agree(mode, got, want)
        return
    eps = float(np.finfo(np.float32).eps)
    bound = eps * (np.abs(want).max() + np.abs(np.asarray(b)).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    xla = J_REGISTRY.lookup("fused_conv_block", "xla").fn
    _agree(mode, got, np.asarray(xla(x, w, b, scale=s)))


@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("mode", MODES)
def test_conv_window_plain_matches_pallas(stage, mode):
    """Under int8 the conv sees codes and no bias; the requant epilogue
    runs outside it (``ops.conv2d``)."""
    x, w, b, _ = _conv_operands(stage, mode)
    b = None if mode == "int8" else b
    want = np.asarray(j_conv_window(jnp.asarray(x), jnp.asarray(w),
                                    None if b is None else jnp.asarray(b),
                                    policy=PALLAS))
    got = conv2d_window_ref(_t(x), _t(w),
                            None if b is None else _t(b)).numpy()
    _agree(mode, got, want)


@pytest.mark.parametrize("bsz", [1, 5])
def test_qmatmul_plain_matches_pallas(bsz):
    rng = np.random.RandomState(bsz)
    xq = quantize_int8(_t(rng.randn(bsz, FC[0]).astype(np.float32)), axis=-1)
    wq = quantize_int8(_t((rng.randn(*FC) * 0.05).astype(np.float32)),
                       axis=0)
    want = np.asarray(j_qmatmul(*(jnp.asarray(t.numpy()) for t in
                                  (xq.codes, wq.codes, xq.scale, wq.scale)),
                                policy=PALLAS))
    got = qmatmul_ref(xq.codes, wq.codes, xq.scale, wq.scale).numpy()
    _agree("int8", got, want)


def test_int8_operands_match_reference():
    """``quantize_conv_int8`` + ``split_requant`` give the kernels the
    same codes and requant scale as the JAX op layer."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 15, 13, 13).astype(np.float32)
    w = (rng.randn(20, 15, 6, 6) * 0.05).astype(np.float32)
    want = j_split_requant(*j_quantize_conv_int8(jnp.asarray(x),
                                                 jnp.asarray(w)))
    got = split_requant(*quantize_conv_int8(_t(x), _t(w)))
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


# ------------------------------------------------ wrappers on the CPU

def test_wrappers_run_plain_version_on_cpu_without_launching():
    x, w, b, s = (None if a is None else _t(a)
                  for a in _conv_operands("conv2", "int8"))
    before = (fc_ops.launches, cw_ops.launches, qm_ops.launches)
    assert torch.equal(fc_ops.fused_cwp(x, w, b, scale=s),
                       fused_cwp_ref(x, w, b, scale=s))
    assert torch.equal(cw_ops.conv_window(x, w, b),
                       conv2d_window_ref(x, w, b))
    xq = quantize_int8(torch.randn(3, 320, generator=torch.Generator()
                                   .manual_seed(0)), axis=-1)
    wq = quantize_int8(torch.randn(320, 10, generator=torch.Generator()
                                   .manual_seed(1)), axis=0)
    assert torch.equal(qm_ops.qmatmul(xq.codes, wq.codes, xq.scale,
                                      wq.scale),
                       qmatmul_ref(xq.codes, wq.codes, xq.scale, wq.scale))
    assert (fc_ops.launches, cw_ops.launches, qm_ops.launches) == before


def test_qmatmul_wrapper_broadcasts_scalar_scales():
    g = torch.Generator().manual_seed(2)
    xc = torch.randint(-127, 128, (4, 320), generator=g, dtype=torch.int8)
    wc = torch.randint(-127, 128, (320, 10), generator=g, dtype=torch.int8)
    out = qm_ops.qmatmul(xc, wc, 0.5, torch.tensor(0.25))
    assert torch.equal(out, qmatmul_ref(xc, wc, torch.full((4, 1), 0.5),
                                        torch.full((1, 10), 0.25)))
    with pytest.raises(ValueError):
        qm_ops.qmatmul(xc, wc, torch.ones(3), 1.0)


@pytest.mark.parametrize("case", ["dtype", "rank", "contiguity",
                                  "channels", "bias", "odd_output"])
def test_fused_wrapper_rejects_bad_arguments(case):
    x = torch.zeros(2, 15, 13, 13)
    w = torch.zeros(20, 15, 6, 6)
    b = torch.zeros(20)
    if case == "dtype":
        x = x.double()
    elif case == "rank":
        x = x[0]
    elif case == "contiguity":
        x = x.transpose(2, 3)
    elif case == "channels":
        w = torch.zeros(20, 14, 6, 6)
    elif case == "bias":
        b = torch.zeros(19)
    else:
        w = torch.zeros(20, 15, 5, 5)          # 13 - 5 + 1 = 9, odd
    with pytest.raises((TypeError, ValueError)):
        fc_ops.fused_cwp(x, w, b)


def test_conv_and_qmatmul_wrappers_reject_bad_arguments():
    with pytest.raises(TypeError):
        cw_ops.conv_window(torch.zeros(1, 1, 8, 8, dtype=torch.float16),
                           torch.zeros(2, 1, 3, 3))
    with pytest.raises(ValueError):
        cw_ops.conv_window(torch.zeros(1, 1, 2, 8), torch.zeros(2, 1, 3, 3))
    with pytest.raises(TypeError):
        qm_ops.qmatmul(torch.zeros(2, 8), torch.zeros(8, 3, dtype=torch.int8),
                       1.0, 1.0)
    with pytest.raises(ValueError):
        qm_ops.qmatmul(torch.zeros(2, 8, dtype=torch.int8),
                       torch.zeros(7, 3, dtype=torch.int8), 1.0, 1.0)


# ------------------------------------------------------------ registry

def test_backend_priorities_by_device():
    for op in ("conv2d", "fused_conv_block", "qmatmul"):
        assert list_backends(op, "cpu") == ["torch", "cuda", "ref"]
        assert list_backends(op, "cuda") == ["cuda"]


class _CudaLike:
    """Shape-only stand-in for a CUDA tensor: dispatch reads its device
    and the predicates its shape and dtype, and nothing may run on it."""

    def __init__(self, shape, dtype=torch.float32):
        self.shape = shape
        self.ndim = len(shape)
        self.dtype = dtype
        self.device = torch.device("cuda")

    def contiguous(self):
        raise AssertionError("a backend ran on a refused CUDA call")


def test_cuda_call_the_kernel_refuses_raises():
    """On a CUDA tensor only the kernel is a candidate: a call it refuses
    (a float64 input; the kernels take float32) raises instead of falling
    back to a plain backend."""
    x = _CudaLike((2, 15, 13, 13), torch.float64)
    w = _CudaLike((20, 15, 5, 5), torch.float64)
    with pytest.raises(BackendUnavailableError):
        REGISTRY.dispatch("fused_conv_block", x, w, None, stride=(1, 1),
                          odd="drop", scale=None)


def test_named_backend_refusal_raises():
    # float64: a call the cuda backend refuses (its kernel takes float32)
    x = torch.zeros(1, 15, 13, 13, dtype=torch.float64)
    w = torch.zeros(20, 15, 5, 5, dtype=torch.float64)
    with pytest.raises(BackendUnavailableError):
        fused_conv_block(x, w, odd="drop", policy=ExecPolicy(backend="cuda"))
    out = fused_conv_block(x, w, odd="drop", policy=ExecPolicy(
        backend="torch"))
    assert tuple(out.shape) == (1, 20, 4, 4)


@pytest.mark.parametrize("backend", ["ref", "torch", "cuda"])
@pytest.mark.parametrize("mode", MODES)
def test_every_cpu_backend_agrees(backend, mode):
    rng = np.random.RandomState(4)
    x = _t(rng.randn(2, 15, 13, 13).astype(np.float32))
    w = _t((rng.randn(20, 15, 6, 6) * 0.05).astype(np.float32))
    b = _t((rng.randn(20) * 0.1).astype(np.float32))
    pol = ExecPolicy(quant=mode)
    got = fused_conv_block(x, w, b, policy=pol.with_options(backend=backend))
    want = fused_conv_block(x, w, b, policy=pol)
    _agree(mode, got.numpy(), want.numpy())


# -------------------------------------------------------- launch shape

def test_tiling_overrides_and_validation():
    """conv_window's tiles take ``conv2d.<key>`` overrides and fused_cwp's
    ``fused_conv_block.<key>``: one template, two namespaces."""
    conv2 = (15, 13, 13, 20, 6, 6, 1, 1)
    defaults = tiling.choose_fused_blocks(8, *conv2, pool=False)
    tiles = {k: tiling.fused_tiles(8, *conv2, ov, pool=False)
             for k, ov in (("bare", {"threads": 64}),
                           ("named", {"threads": 64, "conv2d.threads": 96}),
                           ("other", {"fused_conv_block.threads": 64,
                                      "fused_conv_block.split": 4,
                                      "qmatmul.threads": 64}))}
    assert tiles["bare"]["threads"] == 64
    assert tiles["named"]["threads"] == 96
    assert {k: tiles["other"][k] for k in defaults} == defaults
    fused = tiling.fused_tiles(8, *conv2, {"conv2d.split": 4,
                                           "fused_conv_block.threads": 64})
    assert fused["threads"] == 64 and fused["split"] == \
        tiling.choose_fused_blocks(8, *conv2)["split"]
    for bad in ({"threads": 48}, {"conv2d.cpb": 6}, {"conv2d.band": 0},
                {"conv2d.split": 3}):
        with pytest.raises(ValueError, match="conv2d"):
            tiling.fused_tiles(8, *conv2, bad, pool=False)


def test_build_paths_are_content_keyed():
    paths = {n: build.library_path(n) for n in build.SOURCES}
    assert set(paths) == {"addtree", "conv_window", "fused_cwp", "qmatmul"}
    for name, p in paths.items():
        assert p.parent == build.BUILD_DIR and p.name.startswith(f"lib{name}-")
        assert build.library_path(name) == p
    with pytest.raises(KeyError):
        build.library_path("no_such_kernel")



# the paper CNN's stages as choose_fused_blocks takes them:
# (N, H, W, M, Kh, Kw, sh, sw)
FUSED_ARGS = {"conv1": (1, 28, 28, 15, 3, 3, 1, 1),
              "conv2": (15, 13, 13, 20, 6, 6, 1, 1)}


@pytest.mark.parametrize("stage,bsz,want", [
    # served batches: lanes split the contraction, small blocks spread out
    ("conv1", 1, {"threads": 32, "cpb": 4, "band": 1, "split": 2,
                  "ipb": 1}),
    ("conv1", 8, {"threads": 64, "cpb": 8, "band": 1, "split": 2,
                  "ipb": 1}),
    ("conv2", 1, {"threads": 128, "cpb": 4, "band": 1, "split": 32,
                  "ipb": 1}),
    ("conv2", 8, {"threads": 128, "cpb": 4, "band": 1, "split": 32,
                  "ipb": 1}),
    # large batches: no split; whole images, every channel group, several
    # images a block (conv2's 43 KB of weights stage once for four)
    ("conv1", 1024, {"threads": 320, "cpb": 16, "band": 4, "split": 1,
                     "ipb": 3}),
    ("conv2", 1024, {"threads": 320, "cpb": 20, "band": 4, "split": 1,
                     "ipb": 4}),
])
def test_choose_fused_blocks(stage, bsz, want):
    assert tiling.choose_fused_blocks(bsz, *FUSED_ARGS[stage]) == want


# conv_window at odd outputs: a 5x5 kernel on conv2's 13x13 input (9x9
# out), and stride 2 on 35x43 (17x21 out)
ODD_ARGS = {"odd_output": (15, 13, 13, 20, 5, 5, 1, 1),
            "stride2": (3, 35, 43, 5, 3, 3, 2, 2)}


@pytest.mark.parametrize("bsz", [1, 8, 1024])
@pytest.mark.parametrize("stage", sorted(FUSED_ARGS))
def test_unpooled_conv_blocks_at_the_paper_shapes(stage, bsz):
    """Ho and Wo are even at both paper stages, so conv_window's tile grid
    is fused_cwp's and the heuristic picks the same launch."""
    args = FUSED_ARGS[stage]
    assert tiling.choose_fused_blocks(bsz, *args, pool=False) == \
        tiling.choose_fused_blocks(bsz, *args)


@pytest.mark.parametrize("case,bsz,want", [
    ("odd_output", 1, {"threads": 160, "cpb": 4, "band": 1, "split": 32,
                       "ipb": 1}),
    ("odd_output", 8, {"threads": 160, "cpb": 4, "band": 1, "split": 32,
                       "ipb": 1}),
    # 5x5 tiles of 2x2 points over the 9x9 output: the whole image and
    # every channel a block, four images (a fifth's band would take the
    # slab, with its weight rows 4 floats past cpb, over the target)
    ("odd_output", 1024, {"threads": 320, "cpb": 20, "band": 5, "split": 1,
                          "ipb": 4}),
    ("stride2", 8, {"threads": 96, "cpb": 4, "band": 1, "split": 8,
                    "ipb": 1}),
    ("stride2", 1024, {"threads": 320, "cpb": 8, "band": 9, "split": 1,
                       "ipb": 3}),
])
def test_unpooled_conv_blocks_at_odd_outputs(case, bsz, want):
    assert tiling.choose_fused_blocks(bsz, *ODD_ARGS[case],
                                      pool=False) == want


def _tile_rows_read(h, kh, sh, ho, band, po):
    """Per band, the input rows (from the band's first) that the kernel's
    tiles read: rows 2·ph·sh .. +Kh−1, and the tile's second conv row
    unless it is past Ho, where the kernel reads the first row again."""
    reads = []
    for ph0 in range(0, po, band):
        top = 0
        for ph in range(ph0, min(ph0 + band, po)):
            second = 2 * ph + 1 if 2 * ph + 1 < ho else 2 * ph
            top = max(top, (second - 2 * ph0) * sh + kh)
        reads.append((2 * ph0 * sh, top))
    return reads


@pytest.mark.parametrize("case,bsz,tiles", [
    ("odd_output", 1024, {}), ("stride2", 2, {"conv2d.band": 3}),
    ("stride2", 2, {"conv2d.band": 2}), ("stride2", 1024, {})])
def test_unpooled_smem_covers_the_ragged_rows(case, bsz, tiles):
    """The staged band holds every row its tiles read and none past H:
    ``fused_smem_bytes`` counts min((2·band − 1)·sh + Kh, H) rows, which
    the kernel clamps to H − row0 at the last band."""
    n, h, w, m, kh, kw, sh, sw = ODD_ARGS[case]
    t = tiling.fused_tiles(bsz, *ODD_ARGS[case], tiles, pool=False)
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    assert ho % 2 and wo % 2
    po = -(-ho // 2)
    staged = min((2 * t["band"] - 1) * sh + kh, h)
    for row0, top in _tile_rows_read(h, kh, sh, ho, t["band"], po):
        assert top <= min(staged, h - row0)
    ld = tiling.fused_ld(h, w, kh, kw, sh, sw, pool=False)
    assert t["ld"] == ld >= w
    assert t["smem"] == 4 * (n * kh * kw * (t["cpb"] + 4)
                             + t["ipb"] * n * staged * ld)


@pytest.mark.parametrize("mkn,want", [
    # the paper's fc at a served batch and at 1024: N = 10 takes the
    # streaming body, 16 columns a block (8 rows a block, so 8 columns a
    # thread word, two words), the whole K in one slice: no split
    ((8, 320, 10), {"body": 0, "tile_m": 8, "tile_n": 16, "ksplit": 320}),
    ((1024, 320, 10), {"body": 0, "tile_m": 16, "tile_n": 16,
                       "ksplit": 320}),
    # K off a word multiple: the slice rounds up to 40, zero past K
    ((3, 37, 5), {"body": 0, "tile_m": 4, "tile_n": 16, "ksplit": 40}),
    # tensor-core tiles: 3 tiles of 64 x 128 split K 16 ways (4 steps of
    # 64 bytes a block) toward 2 x 132 blocks; a tile is 128 columns
    # through 4 stages, so the body has no tile_n or stages key
    ((64, 4096, 300), {"body": 1, "tile_m": 64, "ksplit": 256}),
])
def test_choose_qmatmul_blocks(mkn, want):
    assert tiling.choose_qmatmul_blocks(*mkn) == want
    t = tiling.qmatmul_tiles(*mkn)
    assert {k: t[k] for k in want} == want
    assert t["splits"] == -(-mkn[1] // want["ksplit"])
    cols = want.get("tile_n", tiling.QMATMUL_TC_BN)
    assert t["grid"][0] == -(-mkn[2] // cols)
    assert t["smem"] == tiling.qmatmul_smem_bytes(
        want["body"], want["tile_m"], cols, want["ksplit"]) <= \
        tiling.SMEM_MAX


def test_qmatmul_tiles_slices_long_k_and_refuses_bad_overrides():
    # a 1 MB weight splits K; the x slice stays within its cap
    t = tiling.qmatmul_tiles(8, 100_000, 10)
    assert t["body"] == 0 and t["splits"] > 1
    assert t["ksplit"] * t["tile_m"] <= tiling.QMATMUL_XSLICE
    assert t["grid"][0] * t["grid"][1] * t["splits"] >= 2 * tiling.H100_SMS
    # a slice longer than K is K; namespaced keys win over bare ones, and
    # an overridden body takes that body's heuristic for the other keys
    t = tiling.qmatmul_tiles(8, 37, 10, {"ksplit": 96, "tile_m": 4,
                                         "qmatmul.tile_m": 16,
                                         "conv2d.tile_m": 8})
    assert (t["ksplit"], t["tile_m"], t["splits"]) == (40, 16, 1)
    t = tiling.qmatmul_tiles(8, 320, 300, {"qmatmul.body": 1})
    assert (t["body"], t["tile_m"], t["ksplit"]) == (1, 64, 320)
    # a key the body does not take is ignored, as any key the op does not
    # know: tiles stay 128 columns, and the stages key is gone
    for extra in ({"qmatmul.tile_n": 64}, {"qmatmul.stages": 3}):
        assert tiling.qmatmul_tiles(8, 320, 300, {"qmatmul.body": 1,
                                                  **extra}) == t
    for bad in ({"body": 2}, {"tile_m": 32}, {"body": 0, "tile_n": 48},
                {"body": 0, "tile_n": 8}, {"ksplit": 0}, {"ksplit": 6},
                {"body": 1, "tile_m": 16}, {"body": 1, "ksplit": 96},
                {"body": 1, "tile_m": 256}, {"body": 0, "tile_m": 64}):
        with pytest.raises(ValueError, match="qmatmul"):
            tiling.qmatmul_tiles(8, 320, 300, bad)
    # the x slice past the shared memory a block may take
    with pytest.raises(ValueError, match="shared memory"):
        tiling.qmatmul_tiles(16, 20_000, 10, {"ksplit": 16_000})


@pytest.mark.parametrize("m,body", [(1, 0), (4, 0), (7, 0), (8, 1),
                                    (15, 1), (16, 1), (17, 1), (64, 1),
                                    (512, 1)])
def test_qmatmul_body_boundary(m, body):
    """Tensor-core tiles from M = 8 (at N >= 64; the card's measurement
    put the crossover between 8 and 12 rows), streaming below, and
    streaming at a narrow N whatever M is."""
    assert tiling.QMATMUL_TC_MIN_M == 8
    assert tiling.qmatmul_tiles(m, 1024, 1408)["body"] == body
    assert tiling.qmatmul_tiles(m, 1024, 16)["body"] == 0
    assert tiling.qmatmul_tiles(m, 320, 10)["body"] == 0


# every LM decode launch of qmatmul (M = capacity 4 or a pod rank's 2):
# qwen1.5-0.5b's MLP and its model-2 and -4 shards, the four dense
# configs, zamba2-7b's shared MLP and its model-2 shard
LM_DECODE = [(1024, 2816), (2816, 1024), (1024, 1408), (1408, 1024),
             (1024, 704), (704, 1024), (5120, 17408), (17408, 5120),
             (2304, 9216), (9216, 2304), (8192, 22528), (22528, 8192),
             (6144, 16384), (16384, 6144), (3584, 14336), (14336, 3584),
             (3584, 7168), (7168, 3584)]


@pytest.mark.parametrize("k,n", LM_DECODE)
@pytest.mark.parametrize("m", [2, 4])
def test_qmatmul_decode_fills_the_card_twice(m, k, n):
    """The weight is streamed once over at least 2 x 132 blocks: K is cut
    into whole 4-row groups, the last slice holds the rest, and the split
    takes the zeroed buffer of one 64-bit slot an output entry."""
    t = tiling.qmatmul_tiles(m, k, n)
    gx, gy, gz = t["grid"]
    assert t["body"] == 0 and t["tile_m"] == 4 and t["tile_n"] == 128
    assert gx * gy * gz >= 2 * tiling.H100_SMS
    assert t["ksplit"] % 4 == 0 and (gz - 1) * t["ksplit"] < k <= \
        gz * t["ksplit"]
    assert t["scratch"] == 8 * m * n
    assert t["smem"] == 4 * t["ksplit"] + 4 * 4 * 128


@pytest.mark.parametrize("m,k,n,splits", [
    (64, 1024, 2816, 4), (64, 2816, 1024, 11), (512, 14336, 3584, 3),
    (512, 3584, 14336, 1), (64, 8192, 22528, 1), (8, 320, 10, 1),
    (8, 4608, 10, 288), (1, 37, 1, 1)])
def test_qmatmul_scratch_sizing(m, k, n, splits):
    """An unsplit call takes no buffer. A split one of the tensor-core
    body takes M x N int32 sums and an arrival counter an output tile;
    of the streaming body, a 64-bit slot an output entry: its blocks'
    count in the top 16 bits (so at most 65,535 blocks share a K, CUDA's
    grid z), their exact sum in the low 48."""
    t = tiling.qmatmul_tiles(m, k, n)
    gx, gy, _ = t["grid"]
    assert t["splits"] == splits <= 65535
    if splits == 1:
        assert t["scratch"] == 0
    elif t["body"] == 1:
        assert t["scratch"] == 4 * (m * n + gx * gy)
    else:
        assert t["scratch"] == 8 * m * n


def test_qmatmul_staged_k_major_layout_is_the_transpose():
    """The tensor-core body's staging of a step of w, restated in plain
    PyTorch: the [n][k] tile holds w's transpose, and every lane of a
    warp's loads and stores of the transposition pass hits its own bank."""
    from repro_torch.kernels.qmatmul.ref import TC_BK, tc_stage_w
    w = np.random.RandomState(5).randint(-128, 128, (64, 128)).astype(
        np.int8)
    kmajor, reads, writes = tc_stage_w(torch.from_numpy(w))
    np.testing.assert_array_equal(kmajor[:, :TC_BK].numpy(),
                                  w.view(np.uint8).T)
    for addrs in (reads, writes):
        banks = (addrs // 4) % 32
        assert all(len(set(b.tolist())) == 32
                   for b in banks.reshape(-1, 32))
    # every byte of the tile written once: 128 rows x 16 words
    words = writes.reshape(-1) // 4
    assert len(set(words.tolist())) == 128 * 16


@pytest.mark.parametrize("splits", [2, 7, 300, 65535])
def test_qmatmul_split_slot_counts_and_sums_exactly(splits):
    """Blocks add their int32 sums of one entry into its 64-bit slot in
    any order: after each add the slot counts the adds so far, and its
    low 32 bits are the int32 (wrapped) sum the plain version gives,
    with every sum at int32's extremes too."""
    from repro_torch.kernels.qmatmul.ref import add_split
    rng = np.random.RandomState(splits)
    for parts in (rng.randint(-2 ** 31, 2 ** 31, splits, dtype=np.int64),
                  np.full(splits, 2 ** 31 - 1, np.int64),
                  np.full(splits, -2 ** 31, np.int64)):
        slot, total = 0, 0
        for i, v in enumerate(parts[rng.permutation(splits)]):
            slot, count, low = add_split(slot, int(v))
            total += int(v)
            assert count == i + 1
        want = int(torch.tensor(parts).to(torch.int32).sum(
            dtype=torch.int32))
        assert low == want == (total + 2 ** 31) % 2 ** 32 - 2 ** 31


def test_qmatmul_transpose4_is_a_byte_transpose():
    from repro_torch.kernels.qmatmul.ref import transpose4
    blocks = np.random.RandomState(6).randint(0, 256, (50, 4, 4)).astype(
        np.uint8)
    r = torch.from_numpy(blocks.view("<u4").astype(np.int64)).squeeze(-1)
    o = torch.stack(transpose4(*r.unbind(1)), dim=1)
    got = o.numpy().astype("<u4").view(np.uint8).reshape(50, 4, 4)
    np.testing.assert_array_equal(got, blocks.transpose(0, 2, 1))


@pytest.mark.parametrize("args,ld", [
    (FUSED_ARGS["conv2"], 20),      # Qo = 4: 2·ld ≡ 8 (mod 32)
    (FUSED_ARGS["conv1"], 29),      # Qo = 13: 2·ld ≡ 26 (mod 32)
    ((3, 33, 41, 5, 3, 3, 2, 2), 41),   # Qo = 10, sw = 2: 40 words a row
    ((1, 40, 40, 4, 3, 3, 1, 1), 40),   # Qo = 19: a row spans 38 words
    ((1, 21, 13, 4, 3, 3, 2, 1), 13),   # 4·ld ≡ 10 (mod 32) has no ld
])
def test_fused_ld_pads_rows_apart_in_the_banks(args, ld):
    n, h, w, m, kh, kw, sh, sw = args
    assert tiling.fused_ld(h, w, kh, kw, sh, sw) == ld


def test_fused_tiles_overrides_staging_and_checks():
    conv2 = FUSED_ARGS["conv2"]
    t = tiling.fused_tiles(1024, *conv2)
    # 540 weight rows of 20 + 4 floats + 4 images × 15 channels × 13 rows
    # × 20 floats
    assert t["smem"] == 4 * (24 * 540 + 4 * 15 * 13 * 20) and t["ld"] == 20
    t = tiling.fused_tiles(8, *conv2, {"fused_conv_block.split": 8,
                                       "band": 2, "cpb": 8, "ipb": 2,
                                       "conv2d.threads": 32})
    assert {k: t[k] for k in ("threads", "cpb", "band", "split", "ipb")} == \
        {"threads": 128, "cpb": 8, "band": 2, "split": 8, "ipb": 2}
    assert t["smem"] == 4 * (12 * 540 + 2 * 15 * 9 * 20)  # 2 pooled rows
    # a slab over SMEM_MAX is read from device memory, not refused
    wide = tiling.fused_tiles(1, 256, 6, 512, 4, 3, 3, 1, 1)
    assert wide["smem"] == 0
    for bad in ({"cpb": 6}, {"cpb": 0}, {"band": 0}, {"ipb": 0},
                {"split": 3}, {"split": 64},
                {"fused_conv_block.threads": 40}):
        with pytest.raises(ValueError):
            tiling.fused_tiles(8, *conv2, bad)


@pytest.mark.parametrize("name", ["addtree", "conv_window", "fused_cwp",
                                  "qmatmul"])
def test_launch_args_match_the_c_signature(name):
    """ctypes passes what ``argtypes`` says, so a count that drifts from
    the launcher's C signature fails only on the card: count both here."""
    import re
    src = (build.CSRC / f"{name}.cu").read_text()
    sig = re.search(r'extern "C" int \w+\((.*?)\)\s*\{', src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    want = (sum("void*" in p for p in params) - 1,       # the stream
            sum(p.startswith("int ") for p in params))
    ops = (build.CSRC.parent / "kernels" / name / "ops.py").read_text()
    got = re.search(r"launch_args\((\d+), (\d+)\)", ops).groups()
    assert tuple(map(int, got)) == want


# ------------------------------------------------------ odd pooled maps

# (N, H, W, M, K) whose conv map is odd: a 5x5 kernel on conv2's 13x13
# input (9x9), and a band of a 224-wide image with an odd row count
# (7x220)
ODD_POOL_SHAPES = {"9x9": (15, 13, 13, 20, 5), "band": (3, 11, 224, 8, 5)}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("odd", ["drop", "pad"])
@pytest.mark.parametrize("shape", sorted(ODD_POOL_SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_odd_pooled_maps_match_reference_xla(backend, odd, shape, mode):
    """``fused_conv_block`` at an odd conv map, ``odd='drop'`` and
    ``'pad'``, through the plain backend and the kernel's wrapper (its
    plain version on the CPU), against the reference's ``xla`` backend op
    by op: int8 bitwise, qformat one step, fp32 1e-5."""
    from repro.ops import fused_conv_block as j_fused_op
    n, h, w_, m, k = ODD_POOL_SHAPES[shape]
    rng = np.random.RandomState(11)
    x = rng.randn(2, n, h, w_).astype(np.float32)
    w = (rng.randn(m, n, k, k) / np.sqrt(n * k * k)).astype(np.float32)
    b = (rng.randn(m) * 0.1).astype(np.float32)
    want = np.asarray(j_fused_op(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), odd=odd,
        policy=JPolicy(backend="xla", quant=mode)))
    got = fused_conv_block(_t(x), _t(w), _t(b), odd=odd,
                           policy=ExecPolicy(backend=backend, quant=mode))
    ho, wo = h - k + 1, w_ - k + 1
    assert ho % 2 and want.shape == (2, m, (ho + (odd == "pad")) // 2,
                                     (wo + (wo % 2 and odd == "pad")) // 2)
    _agree(mode, got.numpy(), want)


def test_odd_raise_refuses_an_odd_map_before_any_launch():
    x, w = torch.zeros(1, 15, 13, 13), torch.zeros(20, 15, 5, 5)
    before = fc_ops.launches
    with pytest.raises(ValueError, match="odd"):
        fc_ops.fused_cwp(x, w)
    with pytest.raises(ValueError, match="odd"):
        fused_conv_block(x, w, policy=ExecPolicy(backend="cuda"))
    assert fc_ops.launches == before
    # the kernel's predicate takes every odd mode: the wrapper decides
    assert REGISTRY.lookup("fused_conv_block", "cuda").accepts(
        x, w, None, stride=(1, 1), odd="pad", scale=None)


@pytest.mark.parametrize("shape", sorted(ODD_POOL_SHAPES))
@pytest.mark.parametrize("bsz", [1, 8])
def test_pad_tiles_cover_the_ragged_rows(shape, bsz):
    """Under ``odd='pad'`` the pooled tile grid is ceil(Ho/2) x
    ceil(Wo/2), as conv_window's, and the staged band holds every row
    its tiles read and none past H; under ``'drop'`` it is the floor."""
    n, h, w, m, k = ODD_POOL_SHAPES[shape]
    args = (n, h, w, m, k, k, 1, 1)
    ho = h - k + 1
    for odd, po in (("pad", -(-ho // 2)), ("drop", ho // 2)):
        t = tiling.fused_tiles(bsz, *args, odd=odd)
        staged = min((2 * t["band"] - 1) + k, h)
        if odd == "pad":
            for row0, top in _tile_rows_read(h, k, 1, ho, t["band"], po):
                assert top <= min(staged, h - row0)
        assert t["smem"] == 4 * (n * k * k * (t["cpb"] + 4)
                                 + t["ipb"] * n * staged * t["ld"])
    # a padded pool tiles the conv map exactly as the unpooled conv does
    assert tiling.fused_tiles(bsz, *args, odd="pad") == \
        tiling.fused_tiles(bsz, *args, pool=False)
