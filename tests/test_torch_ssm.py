"""The port's sub-quadratic LMs against the JAX package on the CPU: the
``causal_conv1d`` op family and its decode step, the two chunked scans
(Mamba2's SSD, RWKV-6's WKV) against the JAX functions and against the
sequential recurrences of ``tests/test_mamba_rwkv.py`` ported to torch,
the Mamba2 and RWKV-6 blocks (prefill, then decode steps), and the
zamba2-7b hybrid and the rwkv6-1.6b LM at small sizes (d_model 32, SSD
and WKV chunks of 4 to 8, zamba2 cut to 5 layers with a shared block
after every 2, as ``tests/test_models_smoke.py`` cuts it).

Inputs come from a numpy seed; JAX params reach the port through
``params_from_numpy``, each leaf moved off its init value by a seeded
0.1·N(0, 1) (``_perturbed``), so that every parameter is exercised: the
init's RWKV bonus ``u`` is all zeros, and a dropped bonus would pass
against it.

Tolerances (``test_torch_lm.py``'s, stated there):

* fp32 within ``TOL_FP32`` = 1e-5 of 1 + max|want|, the JAX side jitted;
* a bf16 block within 2 ulps and at most 1 % of elements off the JAX
  side run op by op (``_bf16_close``): the blocks round their sigmoid
  and silu after each op as XLA does, so they match bitwise here;
* a whole bf16 model within ``TOL_BF16`` = 2⁻⁴ of 1 + max|logit|
  against the jitted reference;
* a chunked scan against its sequential recurrence within
  ``TOL_SCAN`` = 1e-4 (rtol and atol), the reference's own bar for that
  comparison (``test_mamba_rwkv.py``): the two sum in different orders.

Planted faults must fail these bars, each with its reading in the
message: the chunk scan emitting the state after each chunk, the shared
block fed without the embedding output ``x0``, and the RWKV bonus ``u``
dropped.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import (TOL_BF16, TOL_FP32, _bf16_close, _close, _equal,
                           _tree_np)

from repro.configs.rwkv6_16b import CONFIG as J_RWKV
from repro.configs.registry import get_arch as j_get_arch
from repro.configs.zamba2_7b import CONFIG as J_ZAMBA
from repro.core import conv as j_conv
from repro.models import mamba2 as jm2
from repro.models import rwkv6 as jr6
from repro.models.hybrid import HybridLM as JHybridLM
from repro.models.rwkv_lm import RWKVLM as JRWKVLM
from repro.ops import ExecPolicy as JPolicy
from repro.ops import causal_conv1d as j_causal_conv1d
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core import conv as t_conv
from repro_torch.models import common as tc
from repro_torch.models import hybrid as thy
from repro_torch.models import mamba2 as tm2
from repro_torch.models import rwkv6 as tr6
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.rwkv_lm import RWKVLM
from repro_torch.ops import (REGISTRY, ExecPolicy, causal_conv1d,
                             list_backends, list_ops)

TOL_SCAN = 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
V = 64
# zamba2 cut as tests/test_models_smoke.py cuts it; rwkv6 likewise
ZAMBA_KW = dict(n_layers=5, d_model=32, n_heads=4, n_kv_heads=4, d_ff=48,
                vocab=V, d_state=8, shared_interval=2, mamba_chunk=8,
                remat="none")
RWKV_KW = dict(n_layers=2, d_model=32, d_ff=48, vocab=V, head_dim=8,
               chunk=8, remat="none")


def _perturbed(tree, seed: int = 0):
    """Every leaf moved by 0.1·N(0, 1) from a numpy seed (numpy leaves,
    fp32)."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten(_tree_np(tree))
    flat = [(np.asarray(a, np.float32)
             + 0.1 * rng.randn(*np.shape(a))).astype(np.float32)
            for a in flat]
    return jax.tree_util.tree_unflatten(treedef, flat)


def _pair(name: str, jtree, seed: int = 0):
    """(JAX params in dtype ``name``'s leaves as JAX builds them: fp32,
    the port's copy)."""
    p = _perturbed(jtree, seed)
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, "cpu")


def _randn(rng, shape, jdt, tdt, scale=1.0):
    a = (rng.randn(*shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _eager(fn, *args, **kw):
    with jax.disable_jit():
        return fn(*args, **kw)


def _check(name, got, want, label):
    if name == "f32":
        _close(got, want, TOL_FP32, label)
    else:
        _bf16_close(got, want, label)


# ---------------------------------------------------------- causal_conv1d

@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("backend,jbackend", [("ref", "ref"),
                                              ("torch", "xla")])
@pytest.mark.parametrize("k,bias", [(4, True), (2, False), (1, True)])
def test_causal_conv1d_matches_the_reference(name, backend, jbackend, k,
                                             bias):
    """Both backends against the reference's same-named one: the
    stacked-window einsum (``ref``) and the K shifted adds (the port's
    ``torch``, the reference's ``xla``), run op by op in bf16."""
    jdt, tdt = DTYPES[name]
    rng = np.random.RandomState(k)
    jx, x = _randn(rng, (2, 9, 12), jdt, tdt)
    jw, w = _randn(rng, (k, 12), jdt, tdt, 0.5)
    jb, b = _randn(rng, (12,), jdt, tdt, 0.1)
    got = causal_conv1d(x, w, b if bias else None,
                        policy=ExecPolicy(backend=backend))
    want = _eager(j_causal_conv1d, jx, jw, jb if bias else None,
                  policy=JPolicy(backend=jbackend))
    assert got.dtype == tdt
    _check(name, got, want, f"causal_conv1d {backend} k={k}")
    # the compat re-export is the same op
    _equal(t_conv.causal_conv1d(x, w, b if bias else None,
                                policy=ExecPolicy(backend=backend)), got)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_causal_conv1d_step_rolls_the_ring_as_the_reference(name):
    """The decode step against the reference's, and T steps from a zero
    ring against the whole-sequence conv: the (K-1)-deep ring is the
    window the conv sees."""
    jdt, tdt = DTYPES[name]
    rng = np.random.RandomState(3)
    jx, x = _randn(rng, (2, 6, 10), jdt, tdt)
    jw, w = _randn(rng, (4, 10), jdt, tdt, 0.5)
    jb, b = _randn(rng, (10,), jdt, tdt, 0.1)
    jst, st = _randn(rng, (2, 3, 10), jdt, tdt)
    y, new = t_conv.causal_conv1d_step(x[:, 0], st, w, b)
    jy, jnew = _eager(j_conv.causal_conv1d_step, jx[:, 0], jst, jw, jb)
    _check(name, y, jy, "step y")
    _equal(new, jnew, "step ring")
    _equal(new[:, -1], x[:, 0], "newest sample last")
    ring = torch.zeros((2, 3, 10), dtype=tdt)
    outs = []
    for t in range(6):
        yt, ring = t_conv.causal_conv1d_step(x[:, t], ring, w, b)
        outs.append(yt)
    full = causal_conv1d(x, w, b, policy=ExecPolicy(backend="ref"))
    _check(name, torch.stack(outs, 1), full, "steps vs whole sequence")


def test_causal_conv1d_family_runs_its_plain_backend_on_the_card():
    """The reference has no Pallas kernel for this family, so its
    shifted adds carry a "cuda" priority: the one family that does. Every
    other family keeps its rule (only the kernel on the card)."""
    assert "causal_conv1d" in list_ops()
    assert list_backends("causal_conv1d", "cuda") == ["torch"]
    assert list_backends("causal_conv1d", "cpu") == ["torch", "ref"]
    impl = REGISTRY.lookup("causal_conv1d", "torch")
    assert impl.priority == {"cpu": 10, "cuda": 10}
    assert "cuda" not in REGISTRY.lookup("causal_conv1d", "ref").priority
    for op in ("conv2d", "fused_conv_block", "tree_reduce_sum", "qmatmul"):
        assert list_backends(op, "cuda") == ["cuda"], op
    with pytest.raises(AssertionError):
        causal_conv1d(torch.zeros(1, 4, 3), torch.zeros(2, 5))


# ------------------------------------------------------- the chunked scans

def _ssd_sequential(x, dt, a, b, c):
    """Token-by-token SSD recurrence (the definitional oracle)."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    state = torch.zeros((bsz, h, p, n))
    ys = []
    for i in range(t):
        decay = torch.exp(dt[:, i] * a[None, :])
        state = state * decay[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, i], b[:, i], x[:, i])
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, i], state))
    return torch.stack(ys, 1), state


def _wkv_sequential(r, k, v, logw, u, state):
    """RWKV-6 recurrence oracle: y_t = r·(S + u kᵀv); S = diag(w) S + kᵀv."""
    s = state
    ys = []
    for i in range(r.shape[1]):
        kv = torch.einsum("bhn,bhm->bhnm", k[:, i], v[:, i])
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, i],
                               s + u[None, :, :, None] * kv))
        s = s * torch.exp(logw[:, i])[..., None] + kv
    return torch.stack(ys, 1), s


def _scan_close(got, want, label):
    """The reference's bar for a chunked scan against its recurrence."""
    g, w = got.numpy(), want.numpy()
    err = float(np.abs(g - w).max())
    print(f"{label}: max_abs {err:.3g}")
    np.testing.assert_allclose(g, w, rtol=TOL_SCAN, atol=TOL_SCAN,
                               err_msg=f"{label}: max_abs {err}")


def _ssd_inputs(t, seed=0, h=3, p=4, n=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, t, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(2, t, h))).astype(np.float32)
    a = -np.exp(rng.randn(h)).astype(np.float32)
    b = rng.randn(2, t, n).astype(np.float32)
    c = rng.randn(2, t, n).astype(np.float32)
    return x, dt, a, b, c


def _wkv_inputs(t, seed=0, h=3, n=4):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(2, t, h, n).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.randn(2, t, h, n)).astype(np.float32)
    u = rng.randn(h, n).astype(np.float32)
    s0 = (rng.randn(2, h, n, n) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


def _ssd(t, chunk, seed=0):
    arrs = _ssd_inputs(t, seed)
    jcfg = jm2.Mamba2Config(d_model=8, d_state=5, head_dim=4, chunk=chunk)
    tcfg = tm2.Mamba2Config(d_model=8, d_state=5, head_dim=4, chunk=chunk)
    got = tm2._ssd_chunked(*map(torch.from_numpy, arrs), tcfg)
    want = jax.jit(lambda *a: jm2._ssd_chunked(*a, jcfg))(
        *map(jnp.asarray, arrs))
    return got, want, _ssd_sequential(*map(torch.from_numpy, arrs))


def _wkv(t, chunk, seed=0):
    arrs = _wkv_inputs(t, seed)
    got = tr6._wkv_chunked(*map(torch.from_numpy, arrs), chunk)
    want = jax.jit(lambda *a: jr6._wkv_chunked(*a, chunk))(
        *map(jnp.asarray, arrs))
    return got, want, _wkv_sequential(*map(torch.from_numpy, arrs))


@pytest.mark.parametrize("t,chunk", [(16, 4), (24, 8), (8, 8)])
def test_ssd_chunked_matches_the_reference_and_the_recurrence(t, chunk):
    (y, s), (jy, js), (qy, qs) = _ssd(t, chunk)
    _close(y, jy, TOL_FP32, f"ssd y t={t} chunk={chunk}")
    _close(s, js, TOL_FP32, f"ssd final state t={t} chunk={chunk}")
    _scan_close(y, qy, "ssd y vs recurrence")
    _scan_close(s, qs, "ssd state vs recurrence")


@pytest.mark.parametrize("t,chunk", [(16, 4), (24, 8), (8, 8)])
def test_wkv_chunked_matches_the_reference_and_the_recurrence(t, chunk):
    (y, s), (jy, js), (qy, qs) = _wkv(t, chunk)
    _close(y, jy, TOL_FP32, f"wkv y t={t} chunk={chunk}")
    _close(s, js, TOL_FP32, f"wkv final state t={t} chunk={chunk}")
    _scan_close(y, qy, "wkv y vs recurrence")
    _scan_close(s, qs, "wkv state vs recurrence")


def test_segsum_softplus_and_the_per_op_activations():
    """``_segsum``'s -inf above the diagonal gives an exact 0 after exp;
    ``softplus`` is JAX's at every x (``F.softplus`` returns x above 20);
    the per-op sigmoid and silu are JAX's bitwise in bf16 and within
    1e-5 in fp32."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 6).astype(np.float32)
    got = torch.exp(tm2._segsum(torch.from_numpy(x)))
    want = jnp.exp(jm2._segsum(jnp.asarray(x)))
    _close(got, want, TOL_FP32, "exp(segsum)")
    assert bool((torch.triu(got, 1) == 0).all())
    z = np.array([-40.0, -20.5, -3.0, 0.0, 0.7, 19.0, 20.5, 40.0],
                 np.float32)
    _close(tm2.softplus(torch.from_numpy(z)), jax.nn.softplus(z), TOL_FP32,
           "softplus")
    assert float(tm2.softplus(torch.tensor([-40.0]))) > 0
    jx, x = _randn(rng, (4096,), jnp.bfloat16, torch.bfloat16, 4.0)
    _equal(tc.sigmoid_per_op(x), jax.nn.sigmoid(jx), "bf16 sigmoid")
    _equal(tc.silu_per_op(x), jax.nn.silu(jx), "bf16 silu")
    jx, x = _randn(rng, (4096,), jnp.float32, torch.float32, 4.0)
    _close(tc.silu_per_op(x), jax.nn.silu(jx), TOL_FP32, "fp32 silu")


def test_scans_refuse_ragged_lengths_as_the_reference():
    """T must be a whole number of chunks: both packages raise, and the
    port never pads."""
    x, dt, a, b, c = _ssd_inputs(10)
    cfg = tm2.Mamba2Config(d_model=8, d_state=5, head_dim=4, chunk=4)
    with pytest.raises(ValueError, match="chunks of 4"):
        tm2._ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), cfg)
    with pytest.raises(AssertionError):
        jm2._ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)),
                         jm2.Mamba2Config(d_model=8, d_state=5, head_dim=4,
                                          chunk=4))
    arrs = _wkv_inputs(10)
    with pytest.raises(ValueError, match="chunks of 4"):
        tr6._wkv_chunked(*map(torch.from_numpy, arrs), 4)
    with pytest.raises(AssertionError):
        jr6._wkv_chunked(*map(jnp.asarray, arrs), 4)


# ------------------------------------------------------------------ blocks

def _m2_cfgs(chunk=4):
    kw = dict(d_model=16, d_state=8, head_dim=8, chunk=chunk)
    return jm2.Mamba2Config(**kw), tm2.Mamba2Config(**kw)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_mamba2_block_prefill_then_decode(name):
    """``mamba2_apply(return_state=True)`` over 8 tokens, then 4 decode
    steps from its state, against the reference; in fp32 also against
    the apply over all 12 tokens (the reference's own continuation bar,
    1e-3)."""
    jdt, tdt = DTYPES[name]
    jcfg, tcfg = _m2_cfgs()
    jp, tp = _pair(name, jm2.mamba2_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(4)
    jx, x = _randn(rng, (2, 12, 16), jdt, tdt)
    ref = (lambda f: jax.jit(f)) if name == "f32" else (
        lambda f: lambda *a: _eager(f, *a))
    out, st = tm2.mamba2_apply(tp, x[:, :8], tcfg, None, return_state=True)
    jout, jst = ref(lambda p, x: jm2.mamba2_apply(
        p, x, jcfg, None, return_state=True))(jp, jx[:, :8])
    _check(name, out, jout, f"mamba2 {name} prefill")
    _check(name, st["ssm"], jst["ssm"], f"mamba2 {name} ssm state")
    _equal(st["conv"], jst["conv"], f"mamba2 {name} conv ring")
    assert st["ssm"].dtype == tdt
    steps, jsteps = [], []
    jstep = ref(lambda p, x, s: jm2.mamba2_decode_step(p, x, s, jcfg, None))
    for i in range(8, 12):
        y, st = tm2.mamba2_decode_step(tp, x[:, i], st, tcfg, None)
        jy, jst = jstep(jp, jx[:, i], jst)
        steps.append(y)
        jsteps.append(jy)
    _check(name, torch.stack(steps, 1), jnp.stack(jsteps, 1),
           f"mamba2 {name} decode")
    _check(name, st["ssm"], jst["ssm"], f"mamba2 {name} decode state")
    if name == "f32":
        full = tm2.mamba2_apply(tp, x, tcfg, None)
        np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                                   full[:, 8:].numpy(), rtol=1e-3,
                                   atol=1e-3)


def test_mamba2_short_prefill_pads_the_ring_as_the_reference():
    """A prefill shorter than the ring (T = 2 < K - 1 = 3, chunk 2)
    left-pads the conv state with zeros."""
    jcfg, tcfg = _m2_cfgs(chunk=2)
    jp, tp = _pair("f32", jm2.mamba2_init(jax.random.PRNGKey(1), jcfg))
    x = np.random.RandomState(5).randn(2, 2, 16).astype(np.float32)
    _, st = tm2.mamba2_apply(tp, torch.from_numpy(x), tcfg, None,
                             return_state=True)
    _, jst = jm2.mamba2_apply(jp, jnp.asarray(x), jcfg, None,
                              return_state=True)
    _equal(st["conv"], jst["conv"], "short prefill ring")
    assert bool((st["conv"][:, 0] == 0).all())


def _r6_cfgs():
    kw = dict(d_model=16, d_ff=32, head_dim=8, chunk=4)
    return jr6.RWKV6Config(**kw), tr6.RWKV6Config(**kw)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_rwkv6_block_prefill_then_decode(name):
    """A prefill of 8 tokens from a nonzero state (the scan starts from
    it, the token shift from zeros), then 4 decode steps, against the
    reference. The prefill stores ``wkv`` in the activation dtype, a
    decode step in the state's (here fp32 under a bf16 block)."""
    jdt, tdt = DTYPES[name]
    jcfg, tcfg = _r6_cfgs()
    jp, tp = _pair(name, jr6.rwkv6_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(6)
    jx, x = _randn(rng, (2, 12, 16), jdt, tdt)
    shp = tr6.rwkv6_state_shape(tcfg, 2)
    st0 = {k: (rng.randn(*v) * 0.1).astype(np.float32)
           for k, v in shp.items()}
    ref = (lambda f: jax.jit(f)) if name == "f32" else (
        lambda f: lambda *a: _eager(f, *a))
    japply = ref(lambda p, x, s: jr6.rwkv6_apply(p, x, jcfg, None, s))
    out, st = tr6.rwkv6_apply(
        tp, x[:, :8], tcfg, None,
        {k: torch.from_numpy(v) for k, v in st0.items()})
    jout, jst = japply(jp, jx[:, :8],
                       {k: jnp.asarray(v) for k, v in st0.items()})
    _check(name, out, jout, f"rwkv6 {name} prefill")
    assert st["wkv"].dtype == tdt
    for k in st:
        _check(name, st[k], jst[k], f"rwkv6 {name} prefill {k}")
    st = {k: v.to(torch.float32) if k == "wkv" else v for k, v in st.items()}
    jst = dict(jst, wkv=jst["wkv"].astype(jnp.float32))
    jstep = ref(lambda p, x, s: jr6.rwkv6_decode_step(p, x, s, jcfg, None))
    steps, jsteps = [], []
    for i in range(8, 12):
        y, st = tr6.rwkv6_decode_step(tp, x[:, i], st, tcfg, None)
        jy, jst = jstep(jp, jx[:, i], jst)
        steps.append(y)
        jsteps.append(jy)
    assert st["wkv"].dtype == torch.float32
    _check(name, torch.stack(steps, 1), jnp.stack(jsteps, 1),
           f"rwkv6 {name} decode")
    # the fp32 state sums in another order than XLA's: fp32's bar
    _close(st["wkv"], jst["wkv"], TOL_FP32, f"rwkv6 {name} decode wkv")


def test_rwkv6_block_without_state_returns_none():
    jcfg, tcfg = _r6_cfgs()
    jp, tp = _pair("f32", jr6.rwkv6_init(jax.random.PRNGKey(2), jcfg))
    x = np.random.RandomState(7).randn(1, 8, 16).astype(np.float32)
    out, st = tr6.rwkv6_apply(tp, torch.from_numpy(x), tcfg, None)
    jout, _ = jr6.rwkv6_apply(jp, jnp.asarray(x), jcfg, None)
    assert st is None
    _close(out, jout, TOL_FP32, "rwkv6 without state")


# ------------------------------------------------------------------ models

def _zamba(name):
    jdt, tdt = DTYPES[name]
    jm = JHybridLM(dataclasses.replace(J_ZAMBA, dtype=jdt, **ZAMBA_KW))
    tm = HybridLM(dataclasses.replace(get_arch("zamba2-7b").model().cfg,
                                      dtype=tdt, **ZAMBA_KW))
    return jm, tm


def _rwkv(name):
    jdt, tdt = DTYPES[name]
    jm = JRWKVLM(dataclasses.replace(J_RWKV, dtype=jdt, **RWKV_KW))
    tm = RWKVLM(dataclasses.replace(get_arch("rwkv6-1.6b").model().cfg,
                                    dtype=tdt, **RWKV_KW))
    return jm, tm


MODELS = {"zamba2": _zamba, "rwkv6": _rwkv}


def _prefill_decode(tm, tp, jm, jp, toks, nxt, pos, max_seq=24):
    """Both packages: a prefill into a ``max_seq`` cache, then one decode
    step at per-row positions; the JAX side jitted. Returns (port
    (prefill logits, cache after it, decode logits, cache), JAX's)."""
    cache = tm.init_cache(toks.shape[0], max_seq, device="cpu")
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache)
    pre_cache = jax.tree_util.tree_map(torch.clone, cache)
    dlogits, cache = tm.decode_step(tp, torch.from_numpy(nxt),
                                    torch.from_numpy(pos), cache)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                       jm.init_cache(toks.shape[0], max_seq))
    jdlog, jcache2 = jax.jit(jm.decode_step)(
        jp, jnp.asarray(nxt), jnp.asarray(pos), jcache)
    return (logits, pre_cache, dlogits, cache), (jlog, jcache, jdlog,
                                                 jcache2)


def _leaf_pairs(a, b, prefix=""):
    if isinstance(a, dict):
        for k in a:
            yield from _leaf_pairs(a[k], b[k], f"{prefix}/{k}")
    else:
        yield prefix, a, b


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_lm_prefill_and_decode_match_the_reference(model, name):
    """A batch of 2 prompts of 16 tokens (two chunks) prefilled, then one
    decode step at per-row positions (16 and 9): the logits and every
    cache leaf after each, fp32 within 1e-5, a whole bf16 model within
    2⁻⁴ of 1 + max|logit|."""
    jm, tm = MODELS[model](name)
    jp, tp = _pair(name, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(10)
    toks = rng.randint(0, V, size=(2, 16)).astype(np.int32)
    nxt = np.array([3, 7], np.int32)
    pos = np.array([16, 9], np.int32)
    (lo, c1, dlo, c2), (jlo, jc1, jdlo, jc2) = _prefill_decode(
        tm, tp, jm, jp, toks, nxt, pos)
    tol = TOL_FP32 if name == "f32" else TOL_BF16
    assert lo.dtype == dlo.dtype == torch.float32
    _close(lo, jlo, tol, f"{model} {name} prefill logits")
    _close(dlo, jdlo, tol, f"{model} {name} decode logits")
    for path, got, want in _leaf_pairs(c1, jc1):
        assert got.dtype == tm.cfg.dtype, path
        _close(got, want, tol, f"{model} {name} prefill cache {path}")
    for path, got, want in _leaf_pairs(c2, jc2):
        _close(got, want, tol, f"{model} {name} decode cache {path}")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_lm_init_draws_the_reference_tree(model):
    """The port's own init draws the reference's tree, leaf for leaf in
    shape, the Mamba and RWKV layers stacked on a leading layer dim, and
    the caches have the reference's leaves with batch at axis 1."""
    jm, tm = MODELS[model]("f32")
    shape = lambda t: tuple(t.shape)  # noqa: E731
    mine = tm.init(0, device="cpu")
    assert jax.tree_util.tree_map(shape, mine) == \
        jax.tree_util.tree_map(shape, jm.init(jax.random.PRNGKey(0)))
    cache = tm.init_cache(3, 20, device="cpu")
    jcache = jm.init_cache(3, 20)
    assert jax.tree_util.tree_map(shape, cache) == \
        jax.tree_util.tree_map(shape, jcache)
    assert all(leaf.shape[1] == 3 and leaf.dtype == tm.cfg.dtype
               for leaf in jax.tree_util.tree_leaves(cache))


def test_zamba2_groups_tail_and_state_order():
    """81 layers make 13 groups of 6 and a tail of 3; at the small cut
    (5 layers, interval 2) 2 groups and a tail of 1. The attention cache
    is stacked a group, the Mamba states in layer order (groups', then
    the tail's)."""
    full = get_arch("zamba2-7b").model().cfg
    assert (full.n_groups, full.n_tail) == (13, 3)
    jm, tm = _zamba("f32")
    assert (tm.cfg.n_groups, tm.cfg.n_tail) == (2, 1)
    jp, tp = _pair("f32", jm.init(jax.random.PRNGKey(3)))
    toks = np.random.RandomState(11).randint(0, V, (1, 8)).astype(np.int32)
    cache = tm.init_cache(1, 8, device="cpu")
    tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache)
    assert tuple(cache["attn"]["k"].shape) == (2, 1, 8, 4, 8)
    # d_inner 64 in one head of 64 (the config's head_dim), d_state 8
    assert tuple(cache["mamba"]["ssm"].shape) == (5, 1, 1, 64, 8)
    assert tuple(cache["mamba"]["conv"].shape) == (5, 1, 3, 80)
    _, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                    jm.init_cache(1, 8))
    for i in range(5):
        for k in ("ssm", "conv"):
            _close(cache["mamba"][k][i], jcache["mamba"][k][i], TOL_FP32,
                   f"layer {i} {k} state")
    for g in range(2):
        _close(cache["attn"]["v"][g], jcache["attn"]["v"][g], TOL_FP32,
               f"group {g} shared-block V")


def test_full_size_configs_match_the_reference_without_allocating():
    """zamba2-7b and rwkv6-1.6b field for field, their families, sources,
    the sub-quadratic flag, and the reference's parameter counts (rwkv6's
    formula copied as it is, an approximation that counts 5 of its 6
    d × d matrices)."""
    for arch, n in (("zamba2-7b", 6_661_258_832),
                    ("rwkv6-1.6b", 1_483_325_440)):
        spec, jspec = get_arch(arch), j_get_arch(arch)
        model, jmodel = spec.model(), jspec.model()
        assert not any(torch.is_tensor(v) for v in vars(model).values())
        assert (spec.family, spec.source, spec.subquadratic) == \
            (jspec.family, jspec.source, jspec.subquadratic)
        mine, ref = (dataclasses.asdict(model.cfg),
                     dataclasses.asdict(jmodel.cfg))
        assert mine.pop("dtype") == torch.bfloat16
        assert ref.pop("dtype") == jnp.bfloat16
        assert mine == ref
        assert model.param_count() == jmodel.cfg.param_count() == n
        assert model.cfg.active_param_count() == n
    cfg = get_arch("zamba2-7b").model().cfg
    assert (cfg.mamba_cfg.d_inner, cfg.mamba_cfg.n_heads,
            cfg.mamba_cfg.conv_dim) == (7168, 112, 7296)
    assert cfg.attn_cfg.head_dim == 112 and cfg.mlp_cfg.act == "gelu"
    assert cfg.mlp_cfg.gated
    assert get_arch("rwkv6-1.6b").model().cfg.block_cfg.n_heads == 32


@pytest.mark.parametrize("model", sorted(MODELS))
def test_ragged_prompts_raise_in_both_packages(model):
    """A prompt that is not a whole number of chunks (9 tokens, chunk 8)
    raises in both packages, before the port writes its cache."""
    jm, tm = MODELS[model]("f32")
    jp, tp = _pair("f32", jm.init(jax.random.PRNGKey(0)))
    toks = np.zeros((1, 9), np.int32)
    cache = tm.init_cache(1, 9, device="cpu")
    with pytest.raises(ValueError, match="chunks of 8"):
        tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache)
    assert not any(bool(leaf.any()) for leaf in
                   jax.tree_util.tree_leaves(cache))
    with pytest.raises(AssertionError):
        jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(1, 9))


def test_rwkv_one_token_prompt_takes_the_recurrent_path():
    """``decode = state is not None and t == 1``: a 1-token prompt is no
    whole chunk, yet serves, through the recurrent step, as the
    reference's does."""
    jm, tm = _rwkv("f32")
    jp, tp = _pair("f32", jm.init(jax.random.PRNGKey(0)))
    toks = np.array([[5]], np.int32)
    lo, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                           tm.init_cache(1, 1, device="cpu"))
    jlo, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                             jm.init_cache(1, 1))
    _close(lo, jlo, TOL_FP32, "1-token prompt")
    _close(cache["wkv"], jcache["wkv"], TOL_FP32, "1-token wkv")


@pytest.mark.parametrize("model,top", [
    ("zamba2", {"embedding", "mamba_layers", "shared", "final_norm"}),
    ("rwkv6", {"embedding", "ln0", "ln0_b", "layers", "final_norm",
               "final_norm_b", "lm_head"})])
def test_bridge_carries_both_trees_key_for_key(model, top):
    jm, _ = MODELS[model]("bf16")
    jp = _tree_np(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, "cpu")
    assert set(tp) == top
    assert jax.tree_util.tree_structure(tp) == \
        jax.tree_util.tree_structure(jp)
    for path, got, want in _leaf_pairs(tp, jp):
        _equal(got, want, path)


# ------------------------------------------------------------ planted faults

def _scan_after(init, decay, inputs):
    """The fault: each chunk reads the state AFTER itself."""
    carry, prev = init, []
    for z in range(inputs.shape[1]):
        carry = carry * decay[:, z] + inputs[:, z]
        prev.append(carry)
    return torch.stack(prev, dim=1), carry


def _shared_block_without_x0(self, p, x, x0, ctx, **kw):
    return _SHARED_BLOCK(self, p, x, torch.zeros_like(x0), ctx, **kw)


_SHARED_BLOCK = thy.HybridLM._shared_block
_WKV = tr6._wkv_chunked


def _wkv_without_bonus(r, k, v, logw, u, state, chunk):
    return _WKV(r, k, v, logw, torch.zeros_like(u), state, chunk)


@pytest.mark.parametrize("plant", ["scan emits the state after the chunk",
                                   "shared block without x0",
                                   "RWKV bonus u dropped"])
def test_planted_faults_fail(plant, monkeypatch):
    """The control for the bars above: each check passes unplanted and
    fails planted, its reading in the failure's message."""
    if plant.startswith("scan"):
        def run(label):
            (y, _), (jy, _), (qy, _) = _ssd(16, 4)
            _close(y, jy, TOL_FP32, f"ssd {label}")
            _scan_close(y, qy, f"ssd vs recurrence {label}")
        run("unplanted")
        monkeypatch.setattr(tm2, "chunk_scan", _scan_after)
    else:
        name, model = ("f32", "zamba2") if "x0" in plant else ("f32",
                                                                "rwkv6")
        jm, tm = MODELS[model](name)
        jp, tp = _pair(name, jm.init(jax.random.PRNGKey(0)))
        toks = np.random.RandomState(12).randint(0, V, (2, 16)).astype(
            np.int32)

        def run(label):
            (lo, _, dlo, _), (jlo, _, jdlo, _) = _prefill_decode(
                tm, tp, jm, jp, toks, np.array([1, 2], np.int32),
                np.array([16, 16], np.int32))
            _close(lo, jlo, TOL_FP32, f"{model} prefill {label}")
            _close(dlo, jdlo, TOL_FP32, f"{model} decode {label}")
        run("unplanted")
        if "x0" in plant:
            monkeypatch.setattr(thy.HybridLM, "_shared_block",
                                _shared_block_without_x0)
        else:
            monkeypatch.setattr(tr6, "_wkv_chunked", _wkv_without_bonus)
    with pytest.raises(AssertionError, match="max_abs"):
        run(f"planted: {plant}")
