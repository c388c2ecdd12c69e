"""The port's launch tooling against the JAX package, on the CPU: the
shape grid and its specs (``configs/base.py``), the op counter
(``launch/op_stats.py``) against the reference's HLO walk
(``repro.launch.hlo_stats.analyze_hlo``), the H100 roofline
(``launch/roofline.py``), the one-device dry run (``launch/dryrun.py``),
the kernels' meta branches, and the two repairs the dry run needed (the
registry on meta; no host read of a 0-d decode position).

``repro.launch.dryrun`` is never imported here: it sets a 512-device
``XLA_FLAGS`` at import. Its ``model_flops_for`` is taken from its
source (``_reference_model_flops_for``). Every full-size step here runs
on the meta device: no storage, no arithmetic.

Exact counts are held exactly: FLOPs, bytes and shapes are integers.
"""
import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.registry import get_arch as j_get_arch
from repro.launch.hlo_stats import analyze_hlo
from repro.launch.train import reduced_config as j_reduced_config
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.serve.steps import make_decode_step as j_make_decode_step
from repro.serve.steps import make_prefill_step as j_make_prefill_step
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import SHAPES
from repro_torch.kernels.addtree.ops import tree_reduce_sum
from repro_torch.kernels.conv_window.ops import conv_window
from repro_torch.kernels.fused_cwp.ops import fused_cwp
from repro_torch.kernels.qmatmul.ops import qmatmul as qmatmul_kernel
from repro_torch.launch import dryrun
from repro_torch.launch.op_stats import ALLOC_BLOCK, OpCounter, count
from repro_torch.launch.roofline import HW, RooflineReport, roofline_terms
from repro_torch.launch.train import reduced_config
from repro_torch.models import layers
from repro_torch.ops import ExecPolicy, causal_conv1d, list_backends, list_ops
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.steps import make_train_step

META = torch.device("meta")
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
SERVE_CELLS = [(a, s) for a, s in CELLS
               if SHAPES[s][0] != "train"
               and get_arch(a).skip_reason(s) is None]
# small same-family configs of the sub-quadratic archs (as
# tests/test_torch_ssm.py's), and the transformer archs' reduced_config
ZAMBA_KW = dict(n_layers=5, d_model=32, n_heads=4, n_kv_heads=4, d_ff=48,
                vocab=512, d_state=8, shared_interval=2, mamba_chunk=8,
                remat="none")
RWKV_KW = dict(n_layers=2, d_model=32, d_ff=48, vocab=512, head_dim=8,
               chunk=8, remat="none")
B, S = 2, 64          # the dot-FLOP comparisons' batch and sequence


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _dt(dtype) -> str:
    """A dtype's name in either package."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _flat(tree, prefix=()) -> dict:
    """{key path: (shape, dtype name)} of a nest of dicts of tensors or
    ShapeDtypeStructs."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), _dt(tree.dtype))}


def _nbytes(tree) -> int:
    return sum(int(np.prod(s)) * (2 if d == "bfloat16" else
                                  np.dtype(d).itemsize)
               for s, d in _flat(tree).values())


def _reference_model_flops_for():
    """``repro.launch.dryrun.model_flops_for``, compiled from its source
    alone: importing the module would set its 512-device XLA_FLAGS."""
    src = (Path(repro.launch.__file__).parent / "dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "model_flops_for")
    ns: dict = {}
    exec(compile(ast.Module([fn], type_ignores=[]), "dryrun.py", "exec"),
         ns)
    return ns["model_flops_for"]


# ------------------------------------------------------------ the grid

def test_shapes_equal_the_reference():
    assert SHAPES == J_SHAPES


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_skip_reason(arch, shape):
    spec, jspec = get_arch(arch), j_get_arch(arch)
    assert spec.skip_reason(shape) == jspec.skip_reason(shape)
    kind, specs, axes, seq, batch = spec.input_specs(shape)
    jkind, jspecs, jaxes, jseq, jbatch = jspec.input_specs(shape)
    assert (kind, seq, batch) == (jkind, jseq, jbatch)
    assert sorted(specs) == sorted(jspecs) == sorted(axes) == sorted(jaxes)
    for k in specs:
        assert specs[k].device == META, k
        assert tuple(specs[k].shape) == tuple(jspecs[k].shape), k
        assert _dt(specs[k].dtype) == _dt(jspecs[k].dtype), k
        assert axes[k].names == jaxes[k].names, k


@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_cache_specs_match_eval_shape(arch, shape):
    """Every prefill and decode cell's cache at full size, leaf for leaf,
    against ``jax.eval_shape`` of the reference's ``init_cache``."""
    cache, axes = get_arch(arch).cache_specs(shape)
    jcache, _ = j_get_arch(arch).cache_specs(shape)
    assert axes == get_arch(arch).model().cache_axes()
    assert _flat(cache) == _flat(jcache)
    assert all(t.device == META for t in jax.tree_util.tree_leaves(cache))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_adamw_bytes_match_eval_shape(arch):
    """Full-size params and AdamW state (bf16 moments above 1e11
    parameters, as both dry runs choose) byte for byte."""
    model, jmodel = get_arch(arch).model(), j_get_arch(arch).model()
    params = model.init(torch.Generator(), device=META)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    assert _flat(params) == _flat(jparams)
    big = jmodel.cfg.param_count() > 100e9
    jcfg = JAdamWConfig(m_dtype=jnp.bfloat16, v_dtype=jnp.bfloat16) \
        if big else JAdamWConfig()
    jopt = jax.eval_shape(lambda p: j_adamw_init(p, jcfg), jparams)
    opt = adamw_init(params, dryrun.train_opt_config(model))
    assert _flat(opt) == _flat(jopt)
    assert _nbytes(opt) == _nbytes(jopt) > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_for_equals_the_reference(arch, shape):
    kind, seq, batch = SHAPES[shape]
    want = _reference_model_flops_for()(j_get_arch(arch), kind, seq, batch)
    assert dryrun.model_flops_for(get_arch(arch), kind, seq,
                                  batch) == want > 0


# ------------------------------------------- the counter vs the HLO walk

def _small_pair(arch):
    """(JAX model, port model) of one small same-family config."""
    jm, tm = j_get_arch(arch).model(), get_arch(arch).model()
    if arch == "zamba2-7b":
        return (type(jm)(dataclasses.replace(jm.cfg, **ZAMBA_KW)),
                type(tm)(dataclasses.replace(tm.cfg, **ZAMBA_KW)))
    if arch == "rwkv6-1.6b":
        return (type(jm)(dataclasses.replace(jm.cfg, **RWKV_KW)),
                type(tm)(dataclasses.replace(tm.cfg, **RWKV_KW)))
    return j_reduced_config(jm), reduced_config(tm)


def _wkv_pair_dot_flops(cfg) -> int:
    """The dot FLOPs of the reference's two three-operand WKV einsums
    (``repro/models/rwkv6.py`` ``att`` "bzihn,bzjhn,bzijhn->bzijh" and
    ``bonus`` "bzihn,hn,bzihn->bzih"), which XLA lowers to dots over the
    head dim; the port computes both as a product and a sum over that
    dim (``repro_torch/models/rwkv6.py``), elementwise work that charges
    no FLOPs."""
    q, n = cfg.chunk, cfg.head_dim
    h, nc = cfg.d_model // n, S // q
    return cfg.n_layers * (2 * B * nc * q * q * h * n + 2 * B * nc * q * h * n)


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a != "seamless-m4t-medium"])
def test_dot_flops_equal_the_reference_hlo(arch, step):
    """The counter's dot FLOPs of a prefill (B = 2, S = 64) and of a
    decode step over that cache equal ``analyze_hlo(...).dot_flops`` of
    the reference's jitted step at the same config: the reduced
    transformer configs (25,690,112 and 917,504 at qwen1.5) and small
    zamba2 and rwkv6 ones. One exception, whole: rwkv6's prefill, whose
    two three-operand WKV einsums XLA runs as dots and the port as
    elementwise products and sums (``_wkv_pair_dot_flops``)."""
    jm, tm = _small_pair(arch)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jcache = jax.eval_shape(lambda: jm.init_cache(B, S))
    tp = tm.init(torch.Generator(), device=META)
    tcache = tm.init_cache(B, S, device=META)
    if step == "prefill":
        lowered = jax.jit(j_make_prefill_step(jm)).lower(
            jp, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}, jcache)
        _, stats = count(make_prefill_step(tm), tp,
                         {"tokens": _meta((B, S), torch.int32)}, tcache)
    else:
        lowered = jax.jit(j_make_decode_step(jm)).lower(
            jp, jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32), jcache)
        _, stats = count(make_decode_step(tm), tp, _meta((B,), torch.int32),
                         _meta((), torch.int32), tcache)
    want = analyze_hlo(lowered.compile().as_text()).dot_flops
    if arch == "rwkv6-1.6b" and step == "prefill":
        want -= _wkv_pair_dot_flops(tm.cfg)
    assert stats.dot_flops == want > 0
    if arch == "qwen1.5-0.5b":
        assert want == {"prefill": 25_690_112, "decode": 917_504}[step]


def _reduced_qwen_train_dots(vocab_cols: int) -> int:
    """Dot FLOPs of one reduced qwen1.5 train step (2 layers, d 64, 4
    heads of 16, d_ff 128, B = 2, S = 64: T = 128 tokens), the head's
    matmuls over ``vocab_cols`` columns."""
    t, d, f, hd, h, layers_ = B * S, 64, 128, 16, 4, 2
    fwd_layer = (4 * 2 * t * d * d            # wq, wk, wv, wo
                 + 2 * 2 * B * h * S * S * hd  # scores, probs · v
                 + 3 * 2 * t * d * f)          # wi, wg, wo (gated)
    head = 2 * t * d * vocab_cols
    # forward + backward = 3 × the layers; the chunked CE's head 4 ×:
    # forward, its recompute in the backward (each chunk is under an
    # activation checkpoint), and the two gradient matmuls
    return 3 * layers_ * fwd_layer + 4 * head


def test_train_count_is_the_analytic_sum():
    """The port's reduced qwen1.5 train step counts 3 × its layers'
    matmuls + 4 × the head's over the 2,048-column vocab: 209,715,200.

    The reference's HLO counts 612,368,384 at the same config, and the
    whole gap is its chunked CE's padding (``repro/models/common.py``
    ``chunked_cross_entropy``): it pads the (V, D) weight with zero rows
    to a whole number of 8,192-column chunks and multiplies by all of
    them, so its four head matmuls run over 8,192 columns (f32[128,8192]
    dots inside the chunk ``while``), 4× the vocab here. The port slices
    the weight's real columns and pads only the logits with -inf. The
    reference's number is held here to the same sum at 8,192 columns."""
    jm = j_reduced_config(j_get_arch("qwen1.5-0.5b").model())
    tm = reduced_config(get_arch("qwen1.5-0.5b").model())
    tp = tm.init(torch.Generator(), device=META)
    batch = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32)}
    step = make_train_step(tm, AdamWConfig())
    stats = dryrun.count_train_step(step, tp, adamw_init(tp), batch)
    assert stats.dot_flops == _reduced_qwen_train_dots(2048) == 209_715_200

    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jbatch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
              for k in ("tokens", "labels")}
    jstep = j_make_train_step(jm, JAdamWConfig())
    lowered = jax.jit(jstep).lower(jp, j_adamw_init(jp, JAdamWConfig()),
                                   jbatch)
    want = analyze_hlo(lowered.compile().as_text()).dot_flops
    assert want == _reduced_qwen_train_dots(8192) == 612_368_384


def test_loop_aware_count_equals_counting_every_microbatch():
    """One microbatch × 4 + the rest equals the whole step counted op by
    op: every FLOP and byte, op by op; the peak is at most the whole
    step's (the parts never hold more than it does)."""
    tm = reduced_config(get_arch("qwen1.5-0.5b").model())
    tp = tm.init(torch.Generator(), device=META)
    opt = adamw_init(tp)
    batch = {"tokens": _meta((8, 16), torch.int32),
             "labels": _meta((8, 16), torch.int32)}
    step = make_train_step(tm, AdamWConfig(), microbatches=4)
    loop = dryrun.count_train_step(step, tp, opt, batch)
    _, whole = count(step, tp, opt, batch)
    assert loop.flops == whole.flops > 0
    assert loop.dot_flops == whole.dot_flops
    assert loop.bytes_accessed == whole.bytes_accessed > 0
    assert loop.flops_by_dtype == whole.flops_by_dtype
    assert {k: dataclasses.astuple(v) for k, v in loop.ops.items()} == \
        {k: dataclasses.astuple(v) for k, v in whole.ops.items()}
    assert 0 < loop.peak_bytes <= whole.peak_bytes


# ------------------------------------------------------- bytes and peak

def _views(x):
    return x.view(4, 8).t().expand(2, 8, 4)[1, 2:5].transpose(0, 1) \
        .permute(1, 0).detach()


def _views_are_free(counter_cls) -> None:
    with counter_cls() as c:
        _views(_meta((32,)))
    assert c.stats.bytes_accessed == 0, c.stats.ops


class _ViewsCharged(OpCounter):
    """Planted fault: views charged operands + outputs."""

    @staticmethod
    def _op_bytes(func, args, kwargs, out):
        ts = [t for t in (*args, out) if isinstance(t, torch.Tensor)]
        return sum(t.numel() * t.element_size() for t in ts)


def test_views_charge_nothing_and_the_planted_fault_fails():
    _views_are_free(OpCounter)
    with pytest.raises(AssertionError):
        _views_are_free(_ViewsCharged)


def test_bytes_are_operands_plus_outputs():
    a, b = _meta((64, 32)), _meta((32, 16))
    with OpCounter() as c:
        y = a @ b                       # 2·64·32·16 FLOPs in fp32
        y = y + 1.0                     # read y, write y
        z = torch.zeros((4, 16), device=META)   # written once
        z.copy_(y[:4])                  # dst written, src read
    s = c.stats
    assert s.flops == s.dot_flops == 2 * 64 * 32 * 16
    assert s.flops_by_dtype == {"float32": 2 * 64 * 32 * 16}
    assert s.ops["aten.mm"].bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert s.ops["aten.add"].bytes == 4 * 2 * 64 * 16
    assert s.ops["aten.copy_"].bytes == 4 * 2 * 4 * 16
    assert z.device == META


def test_peak_counts_live_storages_and_frees_dead_ones():
    x = _meta((1000,))                                 # 4,000 B → 4,096
    block = lambda n: -(-n // ALLOC_BLOCK) * ALLOC_BLOCK  # noqa: E731

    def fn(x):
        a = x * 2                                      # + 4,096
        b = a * 3                                      # + 4,096
        del a                                          # - 4,096
        return b + 1                                   # + 4,096

    _, stats = count(fn, x)
    assert stats.peak_bytes == 3 * block(4000)
    _, stats = count(fn, x, live=(_meta((256,)),))     # + 1,024 held
    assert stats.peak_bytes == 3 * block(4000) + 1024


# ------------------------------------------------------------- roofline

def test_roofline_terms_by_hand():
    """compute: each dtype at its own peak; memory at 3.35 TB/s; the
    reference's fields and properties."""
    by_dtype = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
    r = RooflineReport(arch="a", shape="s", mesh="h100x1", chips=1,
                       flops_per_device=989e12 + 67e12 + 1979e12,
                       bytes_per_device=6.7e12,
                       collective_bytes_per_device=0.0,
                       model_flops=494.5e12, peak_memory_per_device=1.0,
                       flops_by_dtype=by_dtype)
    assert r.compute_s == pytest.approx(3.0, rel=1e-12)
    assert r.memory_s == pytest.approx(2.0, rel=1e-12)
    assert r.collective_s == 0.0
    assert r.bottleneck == "compute"
    assert r.step_time_s == pytest.approx(3.0, rel=1e-12)
    assert r.mfu == pytest.approx(494.5e12 / (3.0 * 989e12), rel=1e-12)
    assert r.useful_flops_ratio == pytest.approx(494.5e12 / 3035e12)
    m = r.measured(6.0)
    assert m["mfu"] == pytest.approx(494.5e12 / (6.0 * 989e12), rel=1e-12)
    assert m["bound_share"] == pytest.approx(0.5, rel=1e-12)
    d = r.to_dict()
    for k in ("compute_s", "memory_s", "collective_s", "bottleneck",
              "useful_flops_ratio", "step_time_s", "mfu", "flops_by_dtype"):
        assert k in d
    assert (HW.PEAK_FLOPS_BF16, HW.PEAK_FLOPS_INT8, HW.PEAK_FLOPS_FP32,
            HW.HBM_BW, HW.NVLINK_BW) == (989e12, 1979e12, 67e12, 3.35e12,
                                          450e9)
    assert roofline_terms({}, 0.0, 900e9)["collective_s"] == 2.0
    with pytest.raises(KeyError, match="float64"):
        roofline_terms({"float64": 1.0}, 0.0)


# ------------------------------------------------ the kernels on meta

def _one_kernel(fn, *args, **kw):
    with OpCounter() as c:
        out = fn(*args, **kw)
    return out, c.stats


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_qmatmul_meta_branch(out_dtype):
    m, k, n = 4, 1024, 2816
    out, s = _one_kernel(qmatmul_kernel, _meta((m, k), torch.int8),
                         _meta((k, n), torch.int8), _meta((m, 1)),
                         _meta((1, n)), out_dtype=out_dtype)
    assert out.device == META and tuple(out.shape) == (m, n)
    assert out.dtype == out_dtype
    q = s.ops["qmatmul"]
    assert (q.count, q.flops) == (1, 2 * m * k * n)
    assert q.bytes == m * k + k * n + 4 * (m + n) + 4 * m * n
    assert s.flops_by_dtype == {"int8": 2 * m * k * n}
    assert s.dot_flops == 2 * m * k * n
    # the plain version's int32 chunks are not the kernel's work
    assert not {"aten.sum", "aten.mul"} & set(s.ops)


def test_conv_kernels_meta_branches():
    bsz, n, h, w, m, kk = 3, 2, 9, 11, 5, 3
    ho, wo = h - kk + 1, w - kk + 1
    macs = bsz * m * ho * wo * n * kk * kk
    x, wt, b = _meta((bsz, n, h, w)), _meta((m, n, kk, kk)), _meta((m,))
    out, s = _one_kernel(conv_window, x, wt, b)
    assert tuple(out.shape) == (bsz, m, ho, wo) and out.device == META
    c = s.ops["conv_window"]
    assert (c.count, c.flops) == (1, 2 * macs)
    assert c.bytes == 4 * (x.numel() + wt.numel() + m + bsz * m * ho * wo)
    out, s = _one_kernel(fused_cwp, x, wt, b, scale=_meta((m,)), odd="drop")
    po, qo = ho // 2, wo // 2
    assert tuple(out.shape) == (bsz, m, po, qo) and out.dtype == torch.float32
    c = s.ops["fused_cwp"]
    assert (c.count, c.flops) == (1, 2 * macs)
    assert c.bytes == 4 * (x.numel() + wt.numel() + 2 * m + bsz * m * po * qo)
    assert s.flops_by_dtype == {"float32": 2 * macs}


def test_addtree_meta_branch():
    r, eta = 1000, 37
    out, s = _one_kernel(tree_reduce_sum, _meta((r, eta)))
    assert tuple(out.shape) == (r,) and out.device == META
    c = s.ops["addtree"]
    assert (c.count, c.flops, c.bytes) == (1, r * (eta - 1),
                                           4 * r * (eta + 1))
    assert s.dot_flops == 0 and s.flops == r * (eta - 1)


# ------------------------------------------------------------ repairs

def test_registry_on_meta_selects_as_on_the_card():
    """Repair: the registry had no meta platform (zamba2-7b's prefill and
    loss raised BackendUnavailableError on meta). A meta tensor now
    selects by the cuda priorities: each kernel family its kernel
    wrapper, causal_conv1d its plain shifted adds."""
    for op in list_ops():
        assert list_backends(op, "meta") == list_backends(op, "cuda"), op
    assert list_backends("qmatmul", "meta") == ["cuda"]
    assert list_backends("causal_conv1d", "meta") == ["torch"]
    x, w = _meta((2, 16, 8)), _meta((4, 8))
    assert causal_conv1d(x, w).shape == (2, 16, 8)
    jm, tm = _small_pair("zamba2-7b")
    tp = tm.init(torch.Generator(), device=META)
    toks = _meta((2, 16), torch.int32)
    logits, _ = tm.prefill(tp, {"tokens": toks},
                           tm.init_cache(2, 16, device=META))
    assert logits.device == META
    loss, _ = tm.loss(tp, {"tokens": toks, "labels": toks})
    assert loss.shape == ()


def _meta_decode(model) -> torch.Tensor:
    tp = model.init(torch.Generator(), device=META)
    out, _ = make_decode_step(model)(tp, _meta((2,), torch.int32),
                                     _meta((), torch.int32),
                                     model.init_cache(2, 32, device=META))
    return out


def _host_read_write_cache(c, new, index):
    """Planted fault: the parent's scalar path, which reads a 0-d index
    on the host."""
    t, s = c.shape[1], new.shape[1]
    i = min(max(int(index), 0), t - s)
    c[:, i:i + s] = new.to(c.dtype)


def test_decode_reads_no_position_on_the_host(monkeypatch):
    """Repair: ``_write_cache`` read a 0-d position with ``int(index)``
    (a sync on the card, impossible on meta). A 0-d tensor now takes the
    per-row path: the decode step runs on meta, and on the CPU its
    writes and valid lengths are those of the Python int, bitwise."""
    model = reduced_config(get_arch("qwen1.5-0.5b").model())
    assert tuple(_meta_decode(model).shape) == (2,)
    rng = np.random.RandomState(0)
    base = torch.from_numpy(rng.randn(3, 10, 2, 4).astype(np.float32))
    new = torch.from_numpy(rng.randn(3, 2, 2, 4).astype(np.float32))
    for pos in (0, 4, 9):                # 9 clamps to 8, as the reference
        want, got = base.clone(), base.clone()
        layers._write_cache(want, new, pos)
        layers._write_cache(got, new, torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(got, want), pos
        assert torch.equal(
            layers._kv_len(torch.tensor(pos, dtype=torch.int32), 2, 3,
                           torch.device("cpu")),
            layers._kv_len(pos, 2, 3, torch.device("cpu")))
    monkeypatch.setattr(layers, "_write_cache", _host_read_write_cache)
    with pytest.raises((RuntimeError, NotImplementedError)):
        _meta_decode(model)


# ---------------------------------------- int8 decode: 72 qmatmul calls

def _qmatmul_priced_as_the_kernel(stats, calls: list) -> None:
    """``stats`` holds exactly ``calls`` (M, K, N) qmatmul launches, each
    priced by its own shape, and none of the plain version's int32
    work."""
    q = stats.ops.get("qmatmul")
    assert q is not None and q.count == len(calls)
    assert q.flops == sum(2 * m * k * n for m, k, n in calls)
    assert q.bytes == sum(m * k + k * n + 4 * (m + n) + 4 * m * n
                          for m, k, n in calls)
    assert stats.flops_by_dtype.get("int32", 0) == 0


@pytest.mark.parametrize("backend", [None, "torch"])
def test_int8_decode_prices_72_qmatmul_calls(backend):
    """Full-size qwen1.5-0.5b, one decode step at capacity 4 under int8
    on meta: 24 layers × (wi, wg, wo) = 72 qmatmul calls at M = 4, each
    priced by its shape. Planted fault: qmatmul priced by its plain
    version (a policy naming the plain backend) fails the check."""
    model = get_arch("qwen1.5-0.5b").model()
    tp = model.init(torch.Generator(), device=META)
    step = make_decode_step(model, policy=ExecPolicy(quant="int8",
                                                     backend=backend))
    _, stats = count(step, tp, _meta((4,), torch.int32),
                     _meta((4,), torch.int32),
                     model.init_cache(4, 80, device=META))
    d, f = model.cfg.d_model, model.cfg.d_ff
    calls = [(4, d, f), (4, d, f), (4, f, d)] * model.cfg.n_layers
    assert len(calls) == 72
    if backend is None:
        _qmatmul_priced_as_the_kernel(stats, calls)
    else:
        with pytest.raises(AssertionError):
            _qmatmul_priced_as_the_kernel(stats, calls)


# ------------------------------------------------------------- dry run

def test_run_cell_full_size_writes_the_reference_keys(tmp_path):
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    path = tmp_path / "h100x1__qwen1.5-0.5b__decode_32k.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    for k in ("arch", "shape", "mesh", "chips", "status", "microbatches",
              "count_s", "memory", "op_stats", "collectives", "roofline"):
        assert k in rec, k
    mem = rec["memory"]
    model = get_arch("qwen1.5-0.5b").model()
    jmodel = j_get_arch("qwen1.5-0.5b").model()
    assert mem["params"] == _nbytes(jax.eval_shape(jmodel.init,
                                                   jax.random.PRNGKey(0)))
    cache = 2 * 24 * 128 * 32_768 * model.cfg.n_kv_heads * model.cfg.hd * 2
    assert mem["cache"] == cache and mem["optimizer"] == 0
    assert mem["inputs"] == 4 * 128 + 4
    assert mem["argument_bytes"] == sum(mem[k] for k in
                                        ("params", "optimizer", "inputs",
                                         "cache"))
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    r = rec["roofline"]
    assert r["model_flops"] == 2.0 * model.cfg.param_count() * 128
    assert r["bottleneck"] == "memory" and r["collective_s"] == 0.0
    assert r["peak_memory_per_device"] == mem["peak_bytes"]
    skip = dryrun.run_cell("qwen1.5-0.5b", "long_500k", out_dir=tmp_path)
    assert skip["status"] == "skipped"
    assert skip["reason"] == j_get_arch("qwen1.5-0.5b").skip_reason(
        "long_500k")


def test_multi_pod_raises(tmp_path):
    """The multi-pod dry run is ported: ``--multi-pod both`` writes one
    cell's record on each production mesh, its collectives counted (the
    mesh dry run, ``tests/test_torch_dryrun_mesh.py``). What still
    raises is a fake world inside a process group already joined, so
    the dry run never counts on a real group or leaves one behind."""
    dryrun.main(["--multi-pod", "both", "--arch", "qwen1.5-0.5b",
                 "--shape", "decode_32k", "--out", str(tmp_path)])
    for mesh, chips in (("pod16x16", 256), ("pod2x16x16", 512)):
        rec = json.loads((tmp_path / f"{mesh}__qwen1.5-0.5b__decode_32k"
                                     f".json").read_text())
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["chips"] == chips and rec["mesh"] == mesh
        assert rec["collectives"]["count_by_op"]["all_gather"] > 0
        assert rec["roofline"]["collective_s"] > 0
    assert not torch.distributed.is_initialized()
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="joined one already"):
            with dryrun.fake_world(4):
                pass
    assert not torch.distributed.is_initialized()
