"""The port's dense transformer LM against the JAX package, module by
module, on the CPU.

Inputs come from a numpy seed; JAX params reach the port through
``params_from_numpy``. Every model here is small (2 layers, d_model 32
to 64, vocab 64 to 512). The single ops and the int8 matmuls run op by
op on the JAX side; attention, the MLP and the model are jitted there,
since compiling each op of them anew per shape takes most of the time
otherwise. Under int8 both its default backend (``xla``) and its Pallas
``qmatmul`` kernel in interpret mode are held.

Tolerances, stated once and used throughout:

* ``TOL_FP32`` = 1e-5 relative to 1 + max|want|: the same fp32 ops in
  another library (sigmoid, rsqrt, softmax, matmul orders) differ by a
  few ulps.
* ``TOL_BF16`` = 2⁻⁴ relative to 1 + max|want|, for a whole model
  only: bf16 has 8 significand bits, and a value that the two libraries
  compute an ulp apart in fp32 can round to neighbouring bf16 values,
  which later layers carry on and the logits' head sums over.
* One call in bf16 (a norm, rope, softcap, attention, the MLP) is held
  against the reference run op by op (``jax.disable_jit``) at
  ``BF16_ULPS`` = 2 ulps of each element and at most ``BF16_SHARE`` =
  1 % of the elements differing at all (``_bf16_close``). Op by op,
  because under jit XLA rewrites a bf16 chain: a division by a constant
  becomes an fp32 multiply by its reciprocal, and fused intermediates
  stay in fp32, so the jitted reference rounds where its source does
  not say. The bound is tight enough to fail a planted fault, such as
  the two attention scalings swapped, a softmax or a norm without its
  fp32 upcast, or the bias added before the cast
  (``test_bf16_bound_catches_planted_faults``).
* Exact operations (masks, positions, int8 codes, ``qmatmul`` and
  ``dense`` under int8 on the same inputs) are held bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen15_05b import CONFIG as J_QWEN
from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_arch as j_get_arch
from repro.launch.train import reduced_config as j_reduced_config
from repro.models import common as jc
from repro.models import layers as jl
from repro.models.transformer import LMConfig as JLMConfig
from repro.models.transformer import TransformerLM as JTransformerLM
from repro.ops import ExecPolicy as JPolicy
from repro.ops import dense as j_dense
from repro.ops import qdense as j_qdense
from repro.ops import qmatmul as j_qmatmul
from repro.ops import use_policy as j_use_policy
from repro.core import quantize as j_quantize
from repro.core.quantize import quantize_int8 as j_quantize_int8
from repro.ops import impls as j_impls
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.quantize import quantize_int8
from repro_torch.launch.train import reduced_config
from repro_torch.models import common as tc
from repro_torch.models import layers as tl
from repro_torch.models.transformer import LMConfig, TransformerLM
from repro_torch.ops import ExecPolicy, dense, qdense, qmatmul, use_policy
from repro_torch.sharding.logical import A, ShardingCtx, shard

TOL_FP32 = 1e-5
TOL_BF16 = 2.0 ** -4
BF16_ULPS = 2.0
BF16_SHARE = 0.01
# the transformer archs this slice adds to the port's registry
NEW_ARCHS = ["dbrx-132b", "llama4-scout-17b-a16e", "command-r-35b",
             "qwen3-14b", "gemma2-2b", "internvl2-26b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
J_INT8 = {"xla": JPolicy(quant="int8"),
          "pallas": JPolicy(quant="int8", backend="pallas")}


def _np(a) -> np.ndarray:
    """A JAX or torch array as float64 numpy (bf16 widened exactly)."""
    if torch.is_tensor(a):
        return a.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _close(got, want, tol: float, label: str = "") -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (label, g.shape, w.shape)
    assert np.isfinite(g).all() and np.isfinite(w).all(), label
    err = float(np.abs(g - w).max()) if g.size else 0.0
    scale = 1.0 + float(np.abs(w).max())
    print(f"{label}: max_abs {err:.3g} = {err / scale:.3g} of "
          f"1 + max|want| (bound {tol:g})")
    assert err <= tol * scale, f"{label}: max_abs {err} > {tol * scale}"


def _equal(got, want, label: str = "") -> None:
    """Bitwise: same shape, same values (bf16 compared exactly through
    float64, integers and booleans as they are)."""
    if got.dtype in (torch.bfloat16, torch.float32, torch.float64):
        g, w = _np(got), _np(want)
    else:
        g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape, (label, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=label)


def _tol(name: str) -> float:
    return TOL_FP32 if name == "f32" else TOL_BF16


def _bf16_ulps(got, want) -> tuple[float, float]:
    """(the largest error in bf16 ulps of its element, the share of
    elements not bitwise equal). An element's ulp is 2^(e - 7) for its
    binary exponent e, taken at no less than max|want| / 16, so that a
    value cancelled near zero is not measured in its own tiny ulps."""
    g, w = _np(got), _np(want)
    err = np.abs(g - w)
    mag = np.maximum(np.abs(w), np.abs(w).max() / 16)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return float((err / ulp).max()), float((err > 0).mean())


def _bf16_close(got, want, label: str = "", *,
                share: float = BF16_SHARE) -> None:
    """One bf16 call against the reference run op by op: within
    ``BF16_ULPS`` of each element, and at most ``share`` of the elements
    off at all. Prints the reading (``pytest -s``)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (label, g.shape, w.shape)
    assert np.isfinite(g).all() and np.isfinite(w).all(), label
    ulps, diff = _bf16_ulps(got, want)
    rel = float(np.abs(g - w).max()) / (1.0 + float(np.abs(w).max()))
    print(f"bf16 {label}: {ulps:g} ulps max, {diff:.4f} of elements "
          f"differ, max_abs {rel:.3g} of 1 + max|want|")
    assert ulps <= BF16_ULPS and diff <= share, (
        f"{label}: {ulps:g} ulps (bound {BF16_ULPS:g}), {diff:.4f} of "
        f"elements differ (bound {share:g})")


def _ref(name: str, fn):
    """The reference function as the check of dtype ``name`` runs it:
    jitted in fp32, op by op in bf16 (see the module's docstring)."""
    if name == "f32":
        return jax.jit(fn)

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


def _check(name: str, got, want, label: str = "") -> None:
    """One call: ``TOL_FP32`` in fp32, ``_bf16_close`` in bf16."""
    if name == "f32":
        _close(got, want, TOL_FP32, label)
    else:
        _bf16_close(got, want, label)


def _randn(rng, shape, jdt, tdt, scale=1.0):
    a = (rng.randn(*shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------- the two repairs

def test_bridge_keeps_bf16_leaves_and_carries_the_lm_tree():
    """A bf16 leaf (np.asarray of a JAX bf16 array) becomes torch.bfloat16
    with the same values; fp32 leaves stay fp32; the nested, layer-stacked
    LM tree comes through leaf for leaf. The parent refused bf16."""
    cfg = JLMConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                    n_kv_heads=2, d_ff=64, vocab=64, qkv_bias=True,
                    remat="none")
    params = JTransformerLM(cfg).init(jax.random.PRNGKey(3))
    bf = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    got = params_from_numpy(_tree_np(bf), "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(bf)[0]
    assert set(got) == {"embedding", "layers", "final_norm"}
    assert set(got["layers"]) == {"attn", "mlp", "ln1", "ln2"}
    for path, leaf in flat_j:
        t = got
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(_np(t), _np(leaf))
    f32 = params_from_numpy(_tree_np(params), "cpu")
    assert f32["layers"]["attn"]["wq"].dtype == torch.float32
    np.testing.assert_array_equal(f32["embedding"].numpy(),
                                  np.asarray(params["embedding"]))
    with pytest.raises(TypeError):
        params_from_numpy({"w": np.zeros(3, np.int32)}, "cpu")


# ------------------------------------------------------- bounded memory

def _stacked_init_as_a_list(init_fn, gen, n):
    """The earlier ``stacked_init``: every layer drawn into a list, then
    stacked (twice the layers' memory at its peak)."""
    layers = [init_fn(gen) for _ in range(n)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return stack(layers)


@pytest.mark.parametrize("moe", [False, True])
def test_stacked_init_draws_the_same_values_into_one_stack(moe):
    """Layer by layer into preallocated stacks: the generator's draws
    keep their order, so every leaf is bitwise what the list-then-stack
    version drew, for a dense and an MoE layer tree."""
    from repro_torch.models.moe import MoEConfig
    cfg = LMConfig(name="t", n_layers=3, d_model=16, n_heads=2,
                   n_kv_heads=2, d_ff=24, vocab=32, qkv_bias=True,
                   moe=MoEConfig(d_model=16, d_ff=24, n_experts=4, top_k=2,
                                 n_shared=1) if moe else None)
    tm = TransformerLM(cfg)
    dev = torch.device("cpu")
    init = lambda g: tm._layer_init(g, dev)  # noqa: E731
    got = tc.stacked_init(init, torch.Generator().manual_seed(5), 3)
    want = _stacked_init_as_a_list(init, torch.Generator().manual_seed(5), 3)
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.shape[0] == 3 and torch.equal(g, w), path
    assert not torch.equal(got["attn"]["wq"][0], got["attn"]["wq"][1])


@pytest.mark.parametrize("m,k,n", [(3, 37, 5), (64, 1000, 48), (2, 1, 7),
                                   (1, 4099, 1)])
def test_qmatmul_ref_sums_k_in_bounded_chunks(m, k, n, monkeypatch):
    """The plain qmatmul sums K in chunks whose (M, k, N) int32 product
    stays under its budget, and equals the one-product sum bitwise: at a
    K that spans many chunks (the budget cut to a few rows of K), at a
    chunk of one row, and at K = 1."""
    from repro_torch.kernels.qmatmul import ref as qref
    rng = np.random.RandomState(k)
    xc = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    wc = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8))
    xs = torch.from_numpy(rng.rand(m, 1).astype(np.float32))
    ws = torch.from_numpy(rng.rand(1, n).astype(np.float32))
    acc = (xc.to(torch.int32)[:, :, None] * wc.to(torch.int32)[None]
           ).sum(dim=1, dtype=torch.int32)
    want = acc.to(torch.float32) * xs * ws
    for budget in (qref.TEMP_BYTES, 4 * m * n * 7, 1):
        monkeypatch.setattr(qref, "TEMP_BYTES", budget)
        step = qref.k_chunk(m, n)
        assert 4 * m * step * n <= max(budget, 4 * m * n)
        assert torch.equal(qref.qmatmul_ref(xc, wc, xs, ws), want), budget
    monkeypatch.undo()
    # a full-size chunk at command-r's prefill, 64 x 22,528 int32 a row
    # of K: the temporary stays under the 256 MiB budget
    assert 4 * 64 * qref.k_chunk(64, 22_528) * 22_528 <= 256 << 20


@pytest.mark.parametrize("jpol", sorted(J_INT8))
def test_qdense_and_qmatmul_take_the_references_out_dtype(jpol):
    """``qdense`` returns ``x.dtype`` by default and ``qmatmul`` f32 unless
    told otherwise; the cast follows the fp32 two-scale epilogue, so a
    bf16 result equals the reference's bitwise. The parent always gave
    f32."""
    rng = np.random.RandomState(4)
    jx, x = _randn(rng, (3, 5, 64), jnp.bfloat16, torch.bfloat16)
    w = (rng.randn(64, 48) * 0.2).astype(np.float32)
    jwq = j_quantize_int8(jnp.asarray(w).astype(jnp.bfloat16), axis=0)
    wq = quantize_int8(torch.from_numpy(w).to(torch.bfloat16), axis=0)
    _equal(wq.codes, jwq.codes, "weight codes")
    with j_use_policy(J_INT8[jpol]):
        want = j_qdense(jx, jwq)
        want_f32 = j_qdense(jx, jwq, out_dtype=jnp.float32)
    got = qdense(x, wq)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _equal(got, want, "qdense bf16")
    _equal(qdense(x, wq, out_dtype=torch.float32), want_f32, "qdense f32")
    xq = quantize_int8(x.reshape(-1, 64), axis=-1)
    plain = qmatmul(xq.codes, wq.codes, xq.scale, wq.scale)
    cast = qmatmul(xq.codes, wq.codes, xq.scale, wq.scale,
                   out_dtype=torch.bfloat16)
    assert plain.dtype == torch.float32 and cast.dtype == torch.bfloat16
    assert torch.equal(cast, plain.to(torch.bfloat16))
    jxq = j_quantize_int8(jx.reshape(-1, 64), axis=-1)
    with j_use_policy(J_INT8[jpol]):
        jcast = j_qmatmul(jxq.codes, jwq.codes, jxq.scale, jwq.scale,
                          out_dtype=jnp.bfloat16)
    _equal(cast, jcast, "qmatmul bf16")


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("jpol", sorted(J_INT8))
def test_dense_under_int8_is_bitwise_with_its_bias_in_the_model_dtype(
        name, jpol):
    jdt, tdt = DTYPES[name]
    rng = np.random.RandomState(5)
    jx, x = _randn(rng, (2, 7, 32), jdt, tdt)
    jw, w = _randn(rng, (32, 40), jdt, tdt, 0.2)
    jb, b = _randn(rng, (40,), jdt, tdt, 0.1)
    with j_use_policy(J_INT8[jpol]):
        want = j_dense(jx, jw, jb)
    with use_policy(ExecPolicy(quant="int8")):
        got = dense(x, w, b)
    assert got.dtype == tdt
    _equal(got, want, f"dense int8 {name}")


# --------------------------------------------------------------- common

@pytest.mark.parametrize("name", sorted(DTYPES))
def test_norms_rope_softcap_and_activations(name):
    """The reference's functions here run op by op already. In bf16 the
    activations are held at ``BF16_ULPS`` with any share of elements
    off: the port's silu and gelu round the fp32 sigmoid and the tanh
    gelu once, while XLA on the CPU rounds after each op of its own
    expansion (exp, add, divide; gelu with its constants in bf16)."""
    jdt, tdt = DTYPES[name]
    rng = np.random.RandomState(6)
    jx, x = _randn(rng, (2, 5, 3, 16), jdt, tdt, 2.0)
    jw, w = _randn(rng, (16,), jnp.float32, torch.float32, 0.5)
    jb, b = _randn(rng, (16,), jnp.float32, torch.float32, 0.5)
    for plus_one in (False, True):
        got = tc.rms_norm(x, w, plus_one=plus_one)
        assert got.dtype == tdt
        _check(name, got, jc.rms_norm(jx, jw, plus_one=plus_one),
               f"rms_norm plus_one={plus_one}")
    _check(name, tc.layer_norm(x, w, b), jc.layer_norm(jx, jw, jb), "ln")
    _check(name, tc.layer_norm(x, w), jc.layer_norm(jx, jw), "ln no bias")
    pos = rng.randint(0, 4096, size=(2, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        cos, sin = tc.rope_freqs(torch.from_numpy(pos), 16, theta)
        jcos, jsin = jc.rope_freqs(jnp.asarray(pos), 16, theta)
        assert cos.dtype == torch.float32 and tuple(cos.shape) == (2, 5, 8)
        _close(cos, jcos, TOL_FP32, "cos")
        _close(sin, jsin, TOL_FP32, "sin")
        _check(name, tc.apply_rope(x, cos, sin),
               jc.apply_rope(jx, jcos, jsin), f"apply_rope theta={theta:g}")
    for cap in (None, 3.0):
        _check(name, tc.softcap(x, cap), jc.softcap(jx, cap), f"cap {cap}")
    assert set(tc.ACTIVATIONS) == set(jc.ACTIVATIONS)
    for act in tc.ACTIVATIONS:
        got, want = tc.ACTIVATIONS[act](x), jc.ACTIVATIONS[act](jx)
        if name == "f32":
            _close(got, want, TOL_FP32, act)
        else:
            _bf16_close(got, want, act, share=1.0)
    logits = torch.from_numpy(rng.randn(2, 3, 7).astype(np.float32))
    _equal(tc.take_last_logits(logits),
           jc.take_last_logits(jnp.asarray(logits.numpy())))


def test_decode_positions_and_masks():
    _equal(tc.decode_q_pos(5, 3), jc.decode_q_pos(jnp.int32(5), 3))
    vec = np.array([0, 4, 9], np.int32)
    _equal(tc.decode_q_pos(torch.from_numpy(vec), 3),
           jc.decode_q_pos(jnp.asarray(vec), 3))
    rng = np.random.RandomState(7)
    q_pos = rng.randint(0, 12, size=(3, 4)).astype(np.int32)
    for kv_pos in (np.arange(12, dtype=np.int32),
                   rng.randint(0, 12, size=(3, 12)).astype(np.int32)):
        for causal in (True, False):
            for window in (None, 3):
                for kv_len in (None, np.array([2, 12, 7], np.int32)):
                    got = tl.make_attn_mask(
                        torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                        causal=causal, window=window,
                        kv_len=None if kv_len is None
                        else torch.from_numpy(kv_len))
                    want = jl.make_attn_mask(
                        jnp.asarray(q_pos), jnp.asarray(kv_pos),
                        causal=causal, window=window,
                        kv_len=None if kv_len is None
                        else jnp.asarray(kv_len))
                    _equal(got, want, f"{causal} {window} {kv_len}")
    for s in (1, 7, 512, 513, 576, 1030, 2048):
        assert tl._pick_q_block(s) == jl._pick_q_block(s)


def test_shard_is_the_identity_on_one_device_and_raises_for_a_mesh():
    """The identity without a mesh; on a mesh ``shard`` lays a tensor out
    over its process groups, so a mesh that has none (a ``MeshShape``,
    which resolves specs only) raises. The mesh path itself is held in
    tests/test_torch_lm_mesh.py."""
    from repro_torch.sharding.logical import MeshShape
    x = torch.ones(2, 3)
    assert shard(x, None, "batch", None) is x
    assert shard(x, ShardingCtx(), "batch", None) is x
    with pytest.raises(TypeError, match="DeviceMesh"):
        shard(x, ShardingCtx(mesh=MeshShape(("data", "model"), (2, 2))),
              "batch", None)
    assert A("embed", "mlp") == A("embed", "mlp") != A("mlp")


# ------------------------------------------------------------ attention

def _attn_setup(name, *, hd=8, qkv_bias=True, **extra):
    jdt, tdt = DTYPES[name]
    cfg = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=hd,
               qkv_bias=qkv_bias, rope_theta=1e6, **extra)
    jp = jl.attn_init(jax.random.PRNGKey(1), jl.AttnConfig(**cfg))
    rng = np.random.RandomState(8)
    if qkv_bias:        # zeros at init: give the biases values
        for k in ("bq", "bk", "bv"):
            jp[k] = jnp.asarray(rng.randn(*jp[k].shape).astype(np.float32)
                                * 0.1)
    tp = params_from_numpy(_tree_np(jp), "cpu")
    return (jl.AttnConfig(**cfg), tl.AttnConfig(**cfg), jp, tp, jdt, tdt,
            rng)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("hd", [8, 12])
def test_attention_short_and_blockwise(name, hd):
    """S = 12 takes the short path (scores / sqrt(hd) in the model
    dtype); S = 576 the blockwise one (two 288-query blocks, scores in
    fp32 times 1/sqrt(hd)). hd = 12 makes sqrt(hd) inexact, where the two
    scalings round differently in bf16. GQA: 4 query heads on 2 KV
    heads."""
    jcfg, tcfg, jp, tp, jdt, tdt, rng = _attn_setup(name, hd=hd)
    for s in (12, 576):
        jx, x = _randn(rng, (2, s, 32), jdt, tdt)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
        want, _ = _ref(name, lambda p, x, q: jl.attention(
            p, x, jcfg, None, q_pos=q))(jp, jx, jnp.asarray(pos))
        got, cache = tl.attention(tp, x, tcfg, None,
                                  q_pos=torch.from_numpy(pos.copy()))
        assert cache is None and got.dtype == tdt
        _check(name, got, want, f"attention S={s}")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_attention_qk_norm_softcap_and_window(name):
    jcfg, tcfg, jp, tp, jdt, tdt, rng = _attn_setup(
        name, qkv_bias=False, qk_norm=True, attn_softcap=5.0)
    jx, x = _randn(rng, (2, 10, 32), jdt, tdt)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10)).copy()
    for active in (True, False):
        want, _ = _ref(name, lambda p, x, q, a: jl.attention(
            p, x, jcfg, None, q_pos=q, window=4, window_active=a))(
            jp, jx, jnp.asarray(pos), jnp.asarray(active))
        got, _ = tl.attention(tp, x, tcfg, None,
                              q_pos=torch.from_numpy(pos), window=4,
                              window_active=active)
        _check(name, got, want, f"window active={active}")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_cross_attention_and_precomputed_kv(name):
    """The encoder-decoder entry modes: keys and values from ``kv_x``
    (no rope, bidirectional), and precomputed K/V masked by
    ``kv_valid_len``."""
    jcfg, tcfg, jp, tp, jdt, tdt, rng = _attn_setup(name)
    jx, x = _randn(rng, (2, 6, 32), jdt, tdt)
    jenc, enc = _randn(rng, (2, 9, 32), jdt, tdt)
    jk, k = _randn(rng, (2, 9, 2, 8), jdt, tdt)
    jv, v = _randn(rng, (2, 9, 2, 8), jdt, tdt)
    lens = np.array([9, 4], np.int32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    want, _ = _ref(name, lambda p, x, q, e: jl.attention(
        p, x, jcfg, None, q_pos=q, causal=False, kv_x=e))(
        jp, jx, jnp.asarray(pos), jenc)
    got, _ = tl.attention(tp, x, tcfg, None, q_pos=torch.from_numpy(pos),
                          causal=False, kv_x=enc)
    _check(name, got, want, "cross-attention")
    want, _ = _ref(name, lambda p, x, q, kv, n: jl.attention(
        p, x, jcfg, None, q_pos=q, causal=False, precomputed_kv=kv,
        kv_valid_len=n))(jp, jx, jnp.asarray(pos), (jk, jv),
                         jnp.asarray(lens))
    got, _ = tl.attention(tp, x, tcfg, None, q_pos=torch.from_numpy(pos),
                          causal=False, precomputed_kv=(k, v),
                          kv_valid_len=torch.from_numpy(lens))
    _check(name, got, want, "precomputed kv")


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("index", [0, 3])
def test_attention_scalar_cache_write(name, index):
    """A scalar ``cache_index`` writes all rows at one offset (prefill at
    0, a chunked prefill at 3), and attention runs over the whole cache
    masked by kv_len."""
    jcfg, tcfg, jp, tp, jdt, tdt, rng = _attn_setup(name)
    s, t = 5, 16
    jx, x = _randn(rng, (2, s, 32), jdt, tdt)
    jck, ck = _randn(rng, (2, t, 2, 8), jdt, tdt)
    jcv, cv = _randn(rng, (2, t, 2, 8), jdt, tdt)
    pos = np.broadcast_to(np.arange(index, index + s, dtype=np.int32),
                          (2, s)).copy()
    want, (wk, wv) = _ref(name, lambda p, x, q, c, i: jl.attention(
        p, x, jcfg, None, q_pos=q, cache_kv=c, cache_index=i))(
        jp, jx, jnp.asarray(pos), (jck, jcv), jnp.asarray(index, jnp.int32))
    got, (gk, gv) = tl.attention(
        tp, x, tcfg, None, q_pos=torch.from_numpy(pos), cache_kv=(ck, cv),
        cache_index=index)
    assert gk is ck and gv is cv                 # written in place
    _check(name, got, want, "out")
    _check(name, gk, wk, "k cache")
    _check(name, gv, wv, "v cache")
    # untouched positions are bitwise the old contents
    keep = [i for i in range(t) if not index <= i < index + s]
    _equal(gk[:, keep], np.asarray(jck)[:, keep].astype(np.float32)
           if name == "f32" else jck[:, keep], "k outside the write")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_attention_per_row_cache_write(name):
    """A (B,) ``cache_index``: each slot writes its one decode token at its
    own position (the reference's vmap of dynamic_update_slice; here one
    advanced-index assignment), and each row attends to its own prefix."""
    jcfg, tcfg, jp, tp, jdt, tdt, rng = _attn_setup(name)
    b, t = 3, 12
    jx, x = _randn(rng, (b, 1, 32), jdt, tdt)
    jck, ck = _randn(rng, (b, t, 2, 8), jdt, tdt)
    jcv, cv = _randn(rng, (b, t, 2, 8), jdt, tdt)
    idx = np.array([2, 7, 0], np.int32)
    want, (wk, wv) = _ref(name, lambda p, x, c, i: jl.attention(
        p, x, jcfg, None, q_pos=jc.decode_q_pos(i, b), cache_kv=c,
        cache_index=i))(jp, jx, (jck, jcv), jnp.asarray(idx))
    got, (gk, gv) = tl.attention(
        tp, x, tcfg, None,
        q_pos=tc.decode_q_pos(torch.from_numpy(idx), b),
        cache_kv=(ck, cv), cache_index=torch.from_numpy(idx))
    _check(name, got, want, "out")
    _check(name, gk, wk, "k cache")
    _check(name, gv, wv, "v cache")
    for row, i in enumerate(idx):
        others = [p for p in range(t) if p != i]
        _equal(gk[row, others], wk[row, others], f"row {row} untouched")


# ------------------------------------------------------------------- MLP

# The port's activations in bf16 as JAX functions: the fp32 sigmoid and
# the fp32 tanh gelu, each rounded once (see the activations' check)
_PORT_ROUNDING = {
    "silu": lambda x: x * jax.nn.sigmoid(
        x.astype(jnp.float32)).astype(x.dtype),
    "gelu": lambda x: jax.nn.gelu(x.astype(jnp.float32)).astype(x.dtype)}


def _compiled_quantize_int8(x, axis=-1):
    """The reference's ``quantize_int8`` as XLA compiles it: the division
    of the absmax by the constant 127 folded into an fp32 multiply by its
    reciprocal, as the port's ``quantize_int8`` spells it. Run op by op,
    the reference divides, and some scales land one ulp apart."""
    amax = j_quantize._absmax(x.astype(jnp.float32), axis)
    scale = jnp.maximum(amax, 1e-8) * np.float32(1 / 127)
    codes = jnp.clip(jnp.round(x.astype(jnp.float32) / scale), -127, 127)
    return j_quantize.QTensor(codes.astype(jnp.int8), scale)


def _mlp_ref_as_compiled(monkeypatch, act):
    """Run the bf16 MLP reference op by op with the two roundings that
    differ from its compiled form held to the port's: the activation and
    the int8 quantizer (checked here against the jitted one)."""
    monkeypatch.setitem(jc.ACTIVATIONS, act, _PORT_ROUNDING[act])
    monkeypatch.setattr(j_impls, "quantize_int8", _compiled_quantize_int8)


def _mlp_case(name, quant, gated, act):
    jdt, tdt = DTYPES[name]
    cfg = dict(d_model=32, d_ff=48, act=act, gated=gated, use_bias=True)
    jp = jl.mlp_init(jax.random.PRNGKey(2), jl.MLPConfig(**cfg))
    rng = np.random.RandomState(9)
    for k in ("bi", "bo"):
        jp[k] = jnp.asarray(rng.randn(*jp[k].shape).astype(np.float32) * .1)
    tp = params_from_numpy(_tree_np(jp), "cpu")
    jx, x = _randn(rng, (2, 6, 32), jdt, tdt)
    jpols = [JPolicy(quant="none")] if quant == "none" \
        else list(J_INT8.values())
    return cfg, jp, tp, jx, x, jpols


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_mlp_apply(name, quant, gated, act, monkeypatch):
    """Under int8 each of the MLP's matmuls is ``qdense`` → ``qmatmul``;
    held against the reference's default backend and its interpreted
    Pallas kernel. In bf16 the reference runs op by op with its
    activation rounded as the port's is (``_PORT_ROUNDING``; the
    activation itself is held in the activations' check) and its int8
    quantizer as compiled (``_compiled_quantize_int8``, held here against
    the jitted one), so what is held at ``BF16_ULPS`` is the rest: the
    matmuls, the bias adds in the model dtype, and the gate product."""
    cfg, jp, tp, jx, x, jpols = _mlp_case(name, quant, gated, act)
    with use_policy(ExecPolicy(quant=quant)):
        got = tl.mlp_apply(tp, x, tl.MLPConfig(**cfg), None)
    assert got.dtype == DTYPES[name][1]
    if name == "bf16":
        jq = jax.jit(j_quantize_int8)(jx)
        cq = _compiled_quantize_int8(jx)
        for part in ("scale", "codes"):
            np.testing.assert_array_equal(np.asarray(getattr(cq, part)),
                                          np.asarray(getattr(jq, part)))
        _mlp_ref_as_compiled(monkeypatch, act)
    for jpol in jpols:
        with j_use_policy(jpol):
            want = _ref(name, lambda p, x: jl.mlp_apply(
                p, x, jl.MLPConfig(**cfg), None))(jp, jx)
        _check(name, got, want, f"mlp {act} {quant} {jpol.backend}")


def _rms_norm_in_bf16(x, scale, *, eps=1e-6, plus_one=False):
    """A planted fault: rms_norm without its fp32 upcast."""
    w = (1.0 + scale) if plus_one else scale
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                           + eps) * w.to(x.dtype)


def _softmax_in_bf16(softmax):
    """A planted fault: the softmax's scores rounded to bf16 first."""
    return lambda a, dim: softmax(a.to(torch.bfloat16), dim=dim).to(a.dtype)


def _dense_bias_in_fp32(x, w, b=None):
    """A planted fault, the parent's int8 ``dense``: ``qdense`` in fp32,
    the bias added before the cast to the model dtype."""
    out = qdense(x, quantize_int8(w, axis=0), out_dtype=torch.float32)
    return (out if b is None else out + b).to(x.dtype)


def _planted_attention(monkeypatch, plant):
    s = 576 if plant in ("blockwise scaled as short", "softmax in bf16") \
        else 12
    jcfg, tcfg, jp, tp, jdt, tdt, rng = _attn_setup(
        "bf16", hd=12, qk_norm=plant == "qk norm in bf16")
    jx, x = _randn(rng, (2, s, 32), jdt, tdt)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want, _ = _ref("bf16", lambda p, x, q: jl.attention(
        p, x, jcfg, None, q_pos=q))(jp, jx, jnp.asarray(pos))
    got, _ = tl.attention(tp, x, tcfg, None, q_pos=torch.from_numpy(pos))
    _bf16_close(got, want, f"unplanted S={s}")
    if plant == "short scaled as blockwise":
        monkeypatch.setattr(tl, "_Q_BLOCK", 4)
    elif plant == "blockwise scaled as short":
        monkeypatch.setattr(tl, "_Q_BLOCK", 1024)
    elif plant == "softmax in bf16":
        monkeypatch.setattr(torch, "softmax", _softmax_in_bf16(torch.softmax))
    else:
        monkeypatch.setattr(tl, "rms_norm", _rms_norm_in_bf16)
    got, _ = tl.attention(tp, x, tcfg, None, q_pos=torch.from_numpy(pos))
    return got, want


@pytest.mark.parametrize("plant", [
    "short scaled as blockwise", "blockwise scaled as short",
    "softmax in bf16", "qk norm in bf16", "int8 bias in fp32"])
def test_bf16_bound_catches_planted_faults(plant, monkeypatch):
    """The control for ``_bf16_close``: each fault moves a single call
    by about one bf16 ulp in many elements, which 2⁻⁴ of max|want|
    never sees. The unplanted call passes, the planted one fails.
    Attention at hd = 12, where sqrt(hd) is inexact; S = 12 takes the
    short path, S = 576 the blockwise one."""
    if plant != "int8 bias in fp32":
        got, want = _planted_attention(monkeypatch, plant)
    else:
        cfg, jp, tp, jx, x, jpols = _mlp_case("bf16", "int8", True, "silu")
        _mlp_ref_as_compiled(monkeypatch, "silu")
        with j_use_policy(jpols[0]):
            want = _ref("bf16", lambda p, x: jl.mlp_apply(
                p, x, jl.MLPConfig(**cfg), None))(jp, jx)
        monkeypatch.setattr(tl, "dense_op", _dense_bias_in_fp32)
        with use_policy(ExecPolicy(quant="int8")):
            got = tl.mlp_apply(tp, x, tl.MLPConfig(**cfg), None)
    with pytest.raises(AssertionError):
        _bf16_close(got, want, f"planted: {plant}")


# ------------------------------------------------------------ the model

def _lm_pair(name, **extra):
    jdt, tdt = DTYPES[name]
    kw = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=512, qkv_bias=True, rope_theta=1e6, **extra)
    jm = JTransformerLM(JLMConfig(**kw, dtype=jdt, remat="none"))
    tm = TransformerLM(LMConfig(**kw, dtype=tdt, remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(10)
    for k in ("bq", "bk", "bv"):
        jp["layers"]["attn"][k] = jnp.asarray(
            rng.randn(*jp["layers"]["attn"][k].shape).astype(np.float32)
            * 0.1)
    return jm, tm, jp, params_from_numpy(_tree_np(jp), "cpu"), rng


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_prefill_and_decode_step(name, quant):
    """A batch of 2 prompts prefilled into a 20-position cache (logits and
    the cache written), then one decode step at per-row positions (11
    and 6: the second row's prompt was cut to 6 tokens by masking its
    kv_len) — held against the reference's functions, under both of its
    int8 backends."""
    jm, tm, jp, tp, rng = _lm_pair(name)
    toks = rng.randint(0, 512, size=(2, 11)).astype(np.int32)
    nxt = np.array([3, 7], np.int32)
    pos = np.array([11, 6], np.int32)
    pol = ExecPolicy(quant=quant)
    with use_policy(pol):
        cache = tm.init_cache(2, 20, device="cpu")
        logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                   cache)
        k_prefill = cache["k"].clone()
        dlogits, cache = tm.decode_step(tp, torch.from_numpy(nxt),
                                        torch.from_numpy(pos), cache)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 512)
    jpols = [JPolicy()] if quant == "none" else list(J_INT8.values())
    for jpol in jpols:
        with j_use_policy(jpol):
            jlog, jcache = jax.jit(jm.prefill)(
                jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 20))
            jdlog, jcache2 = jax.jit(jm.decode_step)(
                jp, jnp.asarray(nxt), jnp.asarray(pos), jcache)
        label = f"{name} {quant} {jpol.backend}"
        _close(logits, jlog, _tol(name), f"prefill logits {label}")
        _close(k_prefill, jcache["k"], _tol(name), f"prefill cache {label}")
        _close(dlogits, jdlog, _tol(name), f"decode logits {label}")
        _close(cache["v"], jcache2["v"], _tol(name), f"decode cache {label}")


def test_scalar_decode_and_layer_flags():
    """A scalar decode position (the lock-step loop), and the local/global
    flags of a sliding-window config."""
    jm, tm, jp, tp, rng = _lm_pair("f32", sliding_window=4,
                                   local_global=True)
    _equal(tm._layer_flags(), jm._layer_flags())
    toks = rng.randint(0, 512, size=(2, 9)).astype(np.int32)
    cache = tm.init_cache(2, 12, device="cpu")
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache)
    got, _ = tm.decode_step(tp, torch.tensor([1, 2]), 9, cache)
    _, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                    jm.init_cache(2, 12))
    want, _ = jax.jit(jm.decode_step)(jp, jnp.asarray([1, 2], jnp.int32),
                                      jnp.asarray(9, jnp.int32), jcache)
    _close(got, want, TOL_FP32, "scalar-position decode")
    assert TransformerLM(LMConfig(name="t", n_layers=3, d_model=8,
                                  n_heads=2, n_kv_heads=2, d_ff=8,
                                  vocab=8))._layer_flags() is None


@pytest.mark.parametrize("variant", [
    dict(norm="layernorm", parallel_block=True, tie_embeddings=False),
    dict(norm_plus_one=True, sandwich_norm=True, embed_scale=True,
         final_softcap=30.0, attn_softcap=50.0, qk_norm=True, act="gelu")])
def test_other_dense_variants(variant):
    """command-r's parallel LayerNorm block with an untied head, and
    gemma2's (1 + w) norms, sandwich norms, embed scaling and softcaps."""
    jm, tm, jp, tp, rng = _lm_pair("f32", **variant)
    assert sorted(_tree_np(jp)) == sorted(tm.init(0, device="cpu"))
    toks = rng.randint(0, 512, size=(1, 7)).astype(np.int32)
    got, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(1, 7, device="cpu"))
    want, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                  jm.init_cache(1, 7))
    _close(got, want, TOL_FP32, str(variant))


def test_init_shapes_seeding_and_param_count():
    jm, tm, jp, _, _ = _lm_pair("bf16")
    a = tm.init(7, device="cpu")
    b = tm.init(torch.Generator().manual_seed(7), device="cpu")
    jshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), jp)

    def walk(t, j):
        if isinstance(t, dict):
            assert sorted(t) == sorted(j)
            for k in t:
                walk(t[k], j[k])
        else:
            assert tuple(t.shape) == j and t.dtype == torch.float32

    walk(a, jshapes)
    assert torch.equal(a["embedding"], b["embedding"])
    assert torch.equal(a["layers"]["mlp"]["wo"], b["layers"]["mlp"]["wo"])
    assert not torch.equal(a["embedding"],
                           tm.init(8, device="cpu")["embedding"])
    assert float(a["embedding"].abs().max()) <= 2 / 8 + 1e-7
    n = sum(t.numel() for t in _leaves(a)) - sum(
        a["layers"]["attn"][k].numel() for k in ("bq", "bk", "bv"))
    assert n == tm.param_count() == jm.cfg.param_count()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# --------------------------------------------------------------- config

def test_qwen_config_matches_the_reference_without_allocating():
    spec = get_arch("qwen1.5-0.5b")
    model = spec.model()
    assert not any(torch.is_tensor(v) for v in vars(model).values())
    assert ARCH_IDS == J_ARCH_IDS == [
        "dbrx-132b", "llama4-scout-17b-a16e", "qwen1.5-0.5b",
        "command-r-35b", "qwen3-14b", "gemma2-2b", "internvl2-26b",
        "seamless-m4t-medium", "zamba2-7b", "rwkv6-1.6b"]
    assert spec.family == "dense"
    mine = dataclasses.asdict(model.cfg)
    ref = dataclasses.asdict(J_QWEN)
    assert mine.pop("dtype") == torch.bfloat16
    assert ref.pop("dtype") == jnp.bfloat16
    assert mine == ref
    assert model.param_count() == J_QWEN.param_count() == 463_913_984
    assert (model.cfg.n_layers, model.cfg.d_model, model.cfg.vocab,
            model.cfg.hd) == (24, 1024, 151_936, 64)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_the_reference_without_allocating(arch):
    """Each transformer arch this slice adds: its ``CONFIG`` field for
    field (an MoE config's too), its family, and its total and active
    parameter counts, all without drawing a weight."""
    spec, jspec = get_arch(arch), j_get_arch(arch)
    model, jmodel = spec.model(), jspec.model()
    assert not any(torch.is_tensor(v) for v in vars(model).values())
    assert spec.family == jspec.family and spec.source == jspec.source
    mine, ref = dataclasses.asdict(model.cfg), dataclasses.asdict(jmodel.cfg)
    assert mine.pop("dtype") == torch.bfloat16
    assert ref.pop("dtype") == jnp.bfloat16
    assert mine == ref
    assert model.param_count() == jmodel.cfg.param_count()
    assert model.cfg.active_param_count() == jmodel.cfg.active_param_count()
    assert (model.cfg.active_param_count() < model.param_count()) == \
        (spec.family == "moe")


def test_config_param_counts():
    counts = {a: (get_arch(a).model().param_count(),
                  get_arch(a).model().cfg.active_param_count())
              for a in ARCH_IDS}
    assert counts["dbrx-132b"] == (131_596_523_520, 36_469_708_800)
    assert counts["llama4-scout-17b-a16e"] == (107_769_861_120,
                                               17_172_894_720)
    assert counts["qwen3-14b"][0] == 14_768_296_960


def test_the_other_reference_archs_raise_with_their_roadmap_item():
    """Every reference arch is ported now (the encoder-decoder last):
    no arch is left to raise with a ROADMAP item, and an unknown id
    still raises."""
    assert set(J_ARCH_IDS) - set(ARCH_IDS) == set()
    for arch in J_ARCH_IDS:
        assert get_arch(arch).arch_id == arch
    with pytest.raises(KeyError, match="unknown"):
        get_arch("no-such-arch")


def test_reduced_config_matches_the_reference():
    mine = reduced_config(get_arch("qwen1.5-0.5b").model()).cfg
    ref = j_reduced_config(JTransformerLM(J_QWEN)).cfg
    a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
    assert a.pop("dtype") == torch.bfloat16 and b.pop("dtype")
    assert a == b and mine.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_reduced_config_of_each_arch_matches_the_reference(arch):
    """``--reduced`` of every new arch, the MoE branch included (4
    experts of d_ff 128, top-k at most 2)."""
    mine = reduced_config(get_arch(arch).model()).cfg
    ref = j_reduced_config(j_get_arch(arch).model()).cfg
    a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
    assert a.pop("dtype") == torch.bfloat16 and b.pop("dtype")
    assert a == b and mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()
    if mine.moe is not None:
        assert (mine.moe.n_experts, mine.moe.d_ff) == (4, 128)
        assert mine.moe.top_k == min(get_arch(arch).model().cfg.moe.top_k, 2)


def test_internvl2_vision_prefix_prefill():
    """internvl2's backbone at small size: a prefill whose
    ``vision_embeds`` (B, P, D) are prepended to the text tokens, in
    fp32 against the reference's, logits and the cache it wrote."""
    from repro_torch.configs.internvl2_26b import VISION_PATCHES
    assert VISION_PATCHES == 1024
    jm = j_reduced_config(j_get_arch("internvl2-26b").model())
    jm = type(jm)(dataclasses.replace(jm.cfg, dtype=jnp.float32))
    tm = reduced_config(get_arch("internvl2-26b").model())
    tm = type(tm)(dataclasses.replace(tm.cfg, dtype=torch.float32))
    assert tm.cfg.vision_prefix and not tm.cfg.tie_embeddings
    jp = jm.init(jax.random.PRNGKey(4))
    tp = params_from_numpy(_tree_np(jp), "cpu")
    rng = np.random.RandomState(6)
    toks = rng.randint(0, tm.cfg.vocab, size=(2, 5)).astype(np.int32)
    vis = rng.randn(2, 4, tm.cfg.d_model).astype(np.float32)
    logits, cache = tm.prefill(
        tp, {"tokens": torch.from_numpy(toks),
             "vision_embeds": torch.from_numpy(vis)},
        tm.init_cache(2, 9, device="cpu"))
    jlog, jcache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(vis)},
        jm.init_cache(2, 9))
    _close(logits, jlog, TOL_FP32, "internvl2 prefill logits")
    _close(cache["k"], jcache["k"], TOL_FP32, "internvl2 prefill cache")
    # the prefix moves the text's logits: it is attended to, not dropped
    plain, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                          tm.init_cache(2, 5, device="cpu"))
    assert float((plain - logits).abs().max()) > 1e-3
