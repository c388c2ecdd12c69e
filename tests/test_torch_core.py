"""repro_torch.core against repro.core: quantize, addtree, window.

Inputs come from numpy with a fixed seed and go through both packages.
Every comparison is bitwise unless its tolerance says why not: these
functions are elementwise, gathers, or fixed-order sums, so both
frameworks round at the same places. The one exception is
``conv2d_im2col``, whose fp32 matmul sums in a library-chosen order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import addtree as j_addtree
from repro.core import quantize as j_quant
from repro.core import window as j_window
from repro_torch.core import addtree as t_addtree
from repro_torch.core import quantize as t_quant
from repro_torch.core import window as t_window

# fp32 matmul in another summation order; |y| is O(10) on these inputs
TOL_FP32 = 1e-5


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b) -> None:
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- quantize

@pytest.mark.parametrize("bits", [(8, 8), (4, 4), (6, 10)])
def test_qformat_quantize_bitwise(bits):
    q_j, q_t = j_quant.QFormat(*bits), t_quant.QFormat(*bits)
    rng = np.random.RandomState(0)
    x = (rng.randn(257) * 2 ** (bits[0] - 1)).astype(np.float32)
    # exact half-steps (round half to even) and both saturation ends
    halves = (np.arange(-8, 9) + 0.5) * q_t.step
    x = np.concatenate([x, halves, [1e6, -1e6, q_t.max_val, q_t.min_val]])
    x = x.astype(np.float32)
    _same(q_j.quantize(jnp.asarray(x)), q_t.quantize(_t(x)))
    assert (q_t.step, q_t.max_val, q_t.min_val, q_t.total_bits) == \
        (q_j.step, q_j.max_val, q_j.min_val, q_j.total_bits)


@pytest.mark.parametrize("shape,axis", [((6, 320), -1), ((6, 320), 0),
                                        ((3, 2, 5, 5), None),
                                        ((320, 10), 0), ((4, 7), 1)])
def test_quantize_int8_bitwise(shape, axis):
    x = (np.random.RandomState(1).randn(*shape) * 3).astype(np.float32)
    j, t = j_quant.quantize_int8(jnp.asarray(x), axis), \
        t_quant.quantize_int8(_t(x), axis)
    _same(j.codes, t.codes)
    _same(j.scale, t.scale)


def test_quantize_int8_all_zero_uses_floor_scale():
    x = np.zeros((3, 4), np.float32)
    j, t = j_quant.quantize_int8(jnp.asarray(x)), \
        t_quant.quantize_int8(_t(x))
    _same(j.scale, t.scale)
    assert int(t.codes.abs().max()) == 0


@pytest.mark.parametrize("with_scale,with_bias", [(True, True),
                                                  (True, False),
                                                  (False, True),
                                                  (False, False)])
def test_conv_epilogue_bitwise(with_scale, with_bias):
    rng = np.random.RandomState(2)
    acc = rng.randint(-20000, 20000, size=(2, 5, 3, 4)).astype(np.float32)
    s = (rng.rand(5) * 1e-3).astype(np.float32) if with_scale else None
    b = rng.randn(5).astype(np.float32) if with_bias else None
    j = j_quant.conv_epilogue(jnp.asarray(acc),
                              None if s is None else jnp.asarray(s),
                              None if b is None else jnp.asarray(b))
    t = t_quant.conv_epilogue(_t(acc), None if s is None else _t(s),
                              None if b is None else _t(b))
    _same(j, t)


def test_requant_epilogue_rounds_twice():
    """acc·s then +b, two roundings: a fused multiply-add would keep the
    product exact and land elsewhere on this input."""
    acc = np.array([3.0], np.float32)
    s = np.array([np.float32(1) / np.float32(3)], np.float32)
    b = np.array([-1.0], np.float32)
    t = t_quant.requant_epilogue(_t(acc), _t(s), _t(b))
    _same(j_quant.requant_epilogue(jnp.asarray(acc), jnp.asarray(s),
                                   jnp.asarray(b)), t)
    fma = np.float32(np.float64(acc[0]) * np.float64(s[0]) + b[0])
    assert t.item() == 0.0 and fma != 0.0


# ----------------------------------------------------------------- addtree

@pytest.mark.parametrize("eta", [1, 2, 3, 7, 9, 16, 540])
def test_pairwise_sum_bitwise(eta):
    x = np.random.RandomState(eta).randn(5, eta).astype(np.float32)
    _same(j_addtree.pairwise_sum(jnp.asarray(x)),
          t_addtree.pairwise_sum(_t(x)))


def test_pairwise_sum_axis_and_keepdim():
    x = np.random.RandomState(3).randn(4, 9, 3).astype(np.float32)
    _same(j_addtree.pairwise_sum(jnp.asarray(x), axis=1, keepdims=True),
          t_addtree.pairwise_sum(_t(x), axis=1, keepdim=True))


# ------------------------------------------------------------------ window

@pytest.mark.parametrize("size,k,stride", [(28, 3, 1), (13, 6, 1),
                                           (13, 5, 2), (7, 7, 3)])
def test_conv_output_size(size, k, stride):
    assert t_window.conv_output_size(size, k, stride) == \
        j_window.conv_output_size(size, k, stride)


def test_conv_output_size_rejects_small_input():
    with pytest.raises(ValueError):
        t_window.conv_output_size(2, 3, 1)


@pytest.mark.parametrize("size", [8, 9, 26, 13])
@pytest.mark.parametrize("odd", ["drop", "pad", "raise"])
def test_pool_output_size(size, odd):
    if size % 2 and odd == "raise":
        for mod in (j_window, t_window):
            with pytest.raises(ValueError):
                mod.pool_output_size(size, odd)
        return
    assert t_window.pool_output_size(size, odd) == \
        j_window.pool_output_size(size, odd)


@pytest.mark.parametrize("hw", [(8, 8), (9, 8), (8, 9), (13, 13)])
@pytest.mark.parametrize("odd", ["drop", "pad", "raise"])
def test_maxpool2_odd_modes(hw, odd):
    x = np.random.RandomState(4).randn(2, 3, *hw).astype(np.float32)
    if (hw[0] % 2 or hw[1] % 2) and odd == "raise":
        with pytest.raises(ValueError):
            t_window.maxpool2(_t(x), odd=odd)
        return
    _same(j_window.maxpool2(jnp.asarray(x), odd=odd),
          t_window.maxpool2(_t(x), odd=odd))


def test_maxpool2_rejects_unknown_mode():
    with pytest.raises(ValueError):
        t_window.maxpool2(torch.zeros(1, 1, 4, 4), odd="ceil")


CONV_CASES = [((2, 1, 28, 28), (15, 1, 3, 3), (1, 1)),
              ((2, 15, 13, 13), (20, 15, 6, 6), (1, 1)),
              ((1, 3, 11, 9), (4, 3, 3, 2), (2, 1))]


@pytest.mark.parametrize("xs,ws,stride", CONV_CASES)
def test_extract_windows_bitwise(xs, ws, stride):
    x = np.random.RandomState(5).randn(*xs).astype(np.float32)
    k = ws[2:]
    _same(j_window.extract_windows(jnp.asarray(x), k, stride),
          t_window.extract_windows(_t(x), k, stride))


def _conv_inputs(xs, ws, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*xs).astype(np.float32)
    w = (rng.randn(*ws) / np.sqrt(np.prod(ws[1:]))).astype(np.float32)
    b = (rng.randn(ws[0]) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("xs,ws,stride", CONV_CASES)
@pytest.mark.parametrize("data", ["fp32", "lattice"])
def test_conv2d_ref(xs, ws, stride, data):
    """Same products, same odd-even tree, same bias add. On Q8.8 lattice
    data every product and partial sum is exact, so the two agree
    bitwise. On fp32 data the reference's compiler may contract a product
    into the first tree level's add (one rounding fewer), so the
    comparison takes the fp32 tolerance."""
    x, w, b = _conv_inputs(xs, ws, 6)
    if data == "lattice":
        q = t_quant.QFormat()
        x, w, b = (q.quantize(_t(a)).numpy() for a in (x, w, b))
    j = _np(j_window.conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), stride))
    t = _np(t_window.conv2d_ref(_t(x), _t(w), _t(b), stride))
    if data == "lattice":
        _same(j, t)
    else:
        np.testing.assert_allclose(t, j, rtol=TOL_FP32, atol=TOL_FP32)


@pytest.mark.parametrize("xs,ws,stride", CONV_CASES)
def test_conv2d_im2col_close(xs, ws, stride):
    x, w, b = _conv_inputs(xs, ws, 7)
    j = _np(j_window.conv2d_im2col(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), stride))
    t = _np(t_window.conv2d_im2col(_t(x), _t(w), _t(b), stride))
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, rtol=TOL_FP32, atol=TOL_FP32)
