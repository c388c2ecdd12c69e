"""Backend registrations + the public op entry points (DESIGN.md §7).

Port of ``repro.ops.impls`` for its five op families:

  op               ref (oracle)          torch (plain)        cuda (kernel)
  ---------------  --------------------  -------------------  ----------------
  conv2d           paper-dataflow        im2col einsum        csrc/conv_window
                   (windows → odd-even
                   tree)
  fused_conv_block unfused ref chain     im2col+relu+pool     csrc/fused_cwp
  tree_reduce_sum  pairwise_sum          torch.sum            csrc/addtree
  qmatmul          int32-exact sum       int32-exact sum      csrc/qmatmul
  causal_conv1d    stacked-window        shifted adds         —
                   einsum

Device priorities: on a CUDA tensor only ``cuda`` is auto-selected; on a
CPU tensor the order is ``torch`` > ``cuda`` (whose wrapper then runs its
plain version) > ``ref``, the JAX CPU order. ``causal_conv1d`` is the one
exception: the reference has no Pallas kernel for it, so its shifted
adds are its design on every device and carry a ``cuda`` priority.

Quantization (paper C4) is applied here, once, per ``ExecPolicy.quant``,
exactly as in the reference: ``qformat`` snaps operands and results to
the Qm.n lattice; ``int8`` contracts the codes and applies the
per-output-channel requant scale after the reduction; dense layers take
the int8 datapath through ``qdense`` → ``qmatmul``. The conv backends
take the int8 codes as they are (``split_int8``): the ``cuda`` kernels
contract them on the int8 tensor cores, the ``ref`` and ``torch``
backends cast them to the integer-valued f32 the reference contracts
(``f32_codes``), bitwise to ``split_requant``'s.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.addtree import pairwise_sum
from repro_torch.core.quantize import (QTensor, conv_epilogue, f32_codes,
                                       quantize_int8)
from repro_torch.core.window import conv2d_im2col, conv2d_ref, maxpool2
from repro_torch.ops.policy import ExecPolicy, current_policy
from repro_torch.ops.registry import dispatch, register
from repro_torch.ops.tiling import TREE_MAX_ETA
from repro_torch.sharding.logical import (is_dtensor, matmul_rows,
                                          redistribute)

__all__ = ["conv2d", "fused_conv_block", "tree_reduce_sum", "qmatmul",
           "qdense", "dense", "causal_conv1d", "quantize_conv_int8",
           "split_requant", "split_int8"]

# the reference pins fp32 matmul precision; the fp32 fc product that stays
# on torch.matmul must not run in TF32 on the card, nor may the conv
# gradients (cuDNN, ``ConvWindowFn.backward``). Its bf16 contractions
# accumulate in fp32, so cuBLAS may not reduce bf16 partials in bf16
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

_PLAIN_CPU = {"cpu": 10}
_REF_CPU = {"cpu": 1}
_KERNEL = {"cuda": 30, "cpu": 5}


# ---------------------------------------------------------------- conv2d

@register("conv2d", "ref", priority=_REF_CPU)
def _conv2d_ref(x, w, b=None, *, stride=(1, 1), policy=None):
    return conv2d_ref(f32_codes(x), f32_codes(w), b, tuple(stride))


@register("conv2d", "torch", priority=_PLAIN_CPU)
def _conv2d_torch(x, w, b=None, *, stride=(1, 1), policy=None):
    return conv2d_im2col(f32_codes(x), f32_codes(w), b, tuple(stride))


def _f32(*ts) -> bool:
    return all(t is None or t.dtype == torch.float32 for t in ts)


def _kernel_operands(x, w) -> bool:
    """Both f32 (the kernels' fp32 route) or both int8 codes (their int8
    route)."""
    return x.dtype == w.dtype and x.dtype in (torch.float32, torch.int8)


def _conv2d_cuda_ok(x, w, b=None, *, stride=(1, 1), **_) -> bool:
    return (x.ndim == 4 and w.ndim == 4 and x.shape[1] == w.shape[1]
            and x.shape[2] >= w.shape[2] and x.shape[3] >= w.shape[3]
            and _kernel_operands(x, w) and _f32(b))


@register("conv2d", "cuda", priority=_KERNEL, supports=_conv2d_cuda_ok)
def _conv2d_cuda(x, w, b=None, *, stride=(1, 1), policy=None):
    from repro_torch.kernels.conv_window.ops import conv_window
    return conv_window(x.contiguous(), w.contiguous(),
                       None if b is None else b.contiguous(),
                       stride=tuple(stride), policy=policy)


def _conv_quant_operands(pol: ExecPolicy, x, w, b):
    """Quantize conv operands per the policy (paper C4), shared by the
    ``conv2d`` and ``fused_conv_block`` entry points."""
    if pol.quant == "qformat":
        q = pol.qformat
        return q.quantize(x), q.quantize(w), \
            (None if b is None else q.quantize(b))
    if pol.quant == "int8":
        return quantize_conv_int8(x, w) + (b,)
    return x, w, b


def quantize_conv_int8(x, w) -> tuple[QTensor, QTensor]:
    """Per-tensor activation QTensor + per-output-channel weight QTensor
    (codes in the conv's (M, N, Kh, Kw) layout, scale flattened to (M,))."""
    m = w.shape[0]
    wq = quantize_int8(w.reshape(m, -1), axis=-1)
    xq = quantize_int8(x, axis=None)
    return xq, QTensor(wq.codes.reshape(w.shape), wq.scale.reshape(-1))


def split_requant(x, w):
    """Split int8 QTensor conv operands into (x_codes, w_codes, scale):
    codes as integer-valued f32 (the η·127² < 2²⁴ contraction is exact in
    fp32) and the per-output-channel requant factor sx·sw, shape (M,).
    Non-QTensor operands pass through with scale None."""
    if not (isinstance(x, QTensor) or isinstance(w, QTensor)):
        return x, w, None
    if not (isinstance(x, QTensor) and isinstance(w, QTensor)):
        raise TypeError(
            "int8 conv needs BOTH operands quantized: got "
            f"x={type(x).__name__}, w={type(w).__name__}")
    scale = (x.scale * w.scale).reshape(-1).to(torch.float32)
    return (x.codes.to(torch.float32), w.codes.to(torch.float32), scale)


def split_int8(x, w):
    """``split_requant`` without the cast: (x_codes, w_codes, scale) with
    the codes as int8, as the conv backends take them (the kernels' int8
    route on the card; the plain backends cast them themselves). Every
    conv entry point splits its operands here, so no conv call under
    ``int8`` casts codes to f32 on the card. Non-QTensor operands pass
    through with scale None; one QTensor alone raises TypeError."""
    if not (isinstance(x, QTensor) or isinstance(w, QTensor)):
        return x, w, None
    if not (isinstance(x, QTensor) and isinstance(w, QTensor)):
        raise TypeError(
            "int8 conv needs BOTH operands quantized: got "
            f"x={type(x).__name__}, w={type(w).__name__}")
    scale = (x.scale * w.scale).reshape(-1).to(torch.float32)
    return x.codes, w.codes, scale


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, stride: tuple[int, int] = (1, 1),
           policy: ExecPolicy | None = None) -> torch.Tensor:
    """x: (B, N, H, W) · w: (M, N, Kh, Kw) -> (B, M, Ho, Wo), VALID.

    Under ``int8`` (or with QTensor operands, as compiled plans pass) the
    backend contracts codes and the requant scale + bias apply outside it
    as ``conv_epilogue``."""
    pol = policy if policy is not None else current_policy()
    x, w, b = _conv_quant_operands(pol, x, w, b)
    x, w, scale = split_int8(x, w)
    out = dispatch("conv2d", x, w, None if scale is not None else b,
                   stride=stride, policy=pol)
    if scale is not None:
        out = conv_epilogue(out, scale, b)
    if pol.quant == "qformat":
        out = pol.qformat.quantize(out)
    return out


# ------------------------------------------------------ fused_conv_block

@register("fused_conv_block", "ref", priority=_REF_CPU)
def _fused_ref(x, w, b=None, *, stride=(1, 1), odd="raise", scale=None,
               policy=None):
    x, w = f32_codes(x), f32_codes(w)
    if scale is None:
        out = conv2d_ref(x, w, b, tuple(stride))
    else:
        out = conv_epilogue(conv2d_ref(x, w, None, tuple(stride)), scale, b)
    return maxpool2(torch.relu(out), odd=odd)


@register("fused_conv_block", "torch", priority=_PLAIN_CPU)
def _fused_torch(x, w, b=None, *, stride=(1, 1), odd="raise", scale=None,
                 policy=None):
    out = conv2d_im2col(f32_codes(x), f32_codes(w),
                        None if scale is not None else b, tuple(stride))
    if scale is not None:
        out = conv_epilogue(out, scale, b)
    return maxpool2(torch.relu(out), odd=odd)


def _fused_cuda_ok(x, w, b=None, *, stride=(1, 1), scale=None, **_) -> bool:
    # every VALID conv map: the kernel drops or pads an odd last row or
    # column as core.window.maxpool2 does, and its wrapper raises
    # ValueError before any launch where pool_output_size does
    # (odd='raise' on an odd map, an unknown mode)
    return (_conv2d_cuda_ok(x, w, b, stride=stride) and _f32(scale)
            and (scale is not None or x.dtype != torch.int8))


@register("fused_conv_block", "cuda", priority=_KERNEL,
          supports=_fused_cuda_ok)
def _fused_cuda(x, w, b=None, *, stride=(1, 1), odd="raise", scale=None,
                policy=None):
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    return fused_cwp(x.contiguous(), w.contiguous(),
                     None if b is None else b.contiguous(),
                     stride=tuple(stride),
                     scale=None if scale is None else scale.contiguous(),
                     odd=odd, policy=policy)


def fused_conv_block(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, *,
                     stride: tuple[int, int] = (1, 1), odd: str = "raise",
                     policy: ExecPolicy | None = None) -> torch.Tensor:
    """conv + bias + relu + 2×2/2 maxpool as ONE op: (B, N, H, W) ·
    (M, N, Kh, Kw) -> (B, M, Po, Qo), an odd conv map pooled per ``odd``
    (``core.window.pool_output_size``). Quantization matches ``conv2d``;
    under ``int8`` the requant scale rides into the backend, since it
    must apply before the in-kernel bias/relu/pool."""
    pol = policy if policy is not None else current_policy()
    x, w, b = _conv_quant_operands(pol, x, w, b)
    x, w, scale = split_int8(x, w)
    out = dispatch("fused_conv_block", x, w, b, stride=stride, odd=odd,
                   scale=scale, policy=pol)
    if pol.quant == "qformat":
        out = pol.qformat.quantize(out)
    return out


# ------------------------------------------------------- tree_reduce_sum

@register("tree_reduce_sum", "ref", priority=_REF_CPU)
def _tree_ref(x, *, policy=None):
    return pairwise_sum(x, axis=-1)


@register("tree_reduce_sum", "torch", priority=_PLAIN_CPU)
def _tree_torch(x, *, policy=None):
    return torch.sum(x, dim=-1)


def _tree_cuda_ok(x, **_) -> bool:
    return (x.ndim == 2 and x.dtype == torch.float32
            and 1 <= x.shape[1] <= TREE_MAX_ETA)


@register("tree_reduce_sum", "cuda", priority=_KERNEL, supports=_tree_cuda_ok)
def _tree_cuda(x, *, policy=None):
    from repro_torch.kernels.addtree.ops import tree_reduce_sum as tree_kernel
    return tree_kernel(x.contiguous(), policy=policy)


def tree_reduce_sum(x: torch.Tensor, *,
                    policy: ExecPolicy | None = None) -> torch.Tensor:
    """(R, η) -> (R,): odd-even pairwise tree sum along the last axis."""
    return dispatch("tree_reduce_sum", x, policy=policy)


# --------------------------------------------------------------- qmatmul

def _qmatmul_plain(x_codes, w_codes, x_scale, w_scale, *,
                   out_dtype=torch.float32, policy=None):
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    return qmatmul_ref(x_codes, w_codes, x_scale, w_scale, out_dtype)


register("qmatmul", "ref", priority=_REF_CPU)(_qmatmul_plain)
register("qmatmul", "torch", priority=_PLAIN_CPU)(_qmatmul_plain)


def _qmatmul_cuda_ok(xc, wc, xs, ws, **_) -> bool:
    return (xc.ndim == 2 and wc.ndim == 2 and xc.dtype == torch.int8
            and wc.dtype == torch.int8)


@register("qmatmul", "cuda", priority=_KERNEL, supports=_qmatmul_cuda_ok)
def _qmatmul_cuda(x_codes, w_codes, x_scale, w_scale, *,
                  out_dtype=torch.float32, policy=None):
    from repro_torch.kernels.qmatmul.ops import qmatmul as qmatmul_kernel
    return qmatmul_kernel(x_codes.contiguous(), w_codes.contiguous(),
                          x_scale, w_scale, out_dtype=out_dtype,
                          policy=policy)


def qmatmul(x_codes: torch.Tensor, w_codes: torch.Tensor,
            x_scale: torch.Tensor, w_scale: torch.Tensor, *,
            out_dtype: torch.dtype = torch.float32,
            policy: ExecPolicy | None = None) -> torch.Tensor:
    """(M,K) int8 · (K,N) int8 -> (M,N) ``out_dtype``: the fp32 epilogue
    ``(acc · x_scale) · w_scale``, then a cast. Scales: x (M,1)|scalar,
    w (1,N)|scalar."""
    return dispatch("qmatmul", x_codes, w_codes, x_scale, w_scale,
                    out_dtype=out_dtype, policy=policy)


@register("qmatmul_acc", "ref", priority=_REF_CPU)
@register("qmatmul_acc", "torch", priority=_PLAIN_CPU)
def _qmatmul_acc_plain(x_codes, w_codes, *, policy=None):
    from repro_torch.kernels.qmatmul.ref import qmatmul_acc_ref
    return qmatmul_acc_ref(x_codes, w_codes)


def _qmatmul_acc_cuda_ok(xc, wc, **_) -> bool:
    return _qmatmul_cuda_ok(xc, wc, None, None)


@register("qmatmul_acc", "cuda", priority=_KERNEL,
          supports=_qmatmul_acc_cuda_ok)
def _qmatmul_acc_cuda(x_codes, w_codes, *, policy=None):
    from repro_torch.kernels.qmatmul.ops import qmatmul_acc as acc_kernel
    return acc_kernel(x_codes.contiguous(), w_codes.contiguous(),
                      policy=policy)


def qmatmul_acc(x_codes: torch.Tensor, w_codes: torch.Tensor, *,
                policy: ExecPolicy | None = None) -> torch.Tensor:
    """(M,K) int8 · (K,N) int8 -> the (M,N) int32 accumulator of
    ``qmatmul``, before its epilogue."""
    return dispatch("qmatmul_acc", x_codes, w_codes, policy=policy)


def qdense(x: torch.Tensor, wq: QTensor, out_dtype: torch.dtype | None = None,
           *, policy: ExecPolicy | None = None) -> torch.Tensor:
    """fp (…, K) · int8 (K, N) -> (…, N) in ``out_dtype`` (default
    ``x.dtype``): per-token activation quant, per-output-channel weight
    scales, int32 accumulation."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq = quantize_int8(x2, axis=-1)             # per-row (per-token) scale
    out = qmatmul(xq.codes, wq.codes, xq.scale, wq.scale,
                  out_dtype=out_dtype, policy=policy)
    return out.reshape(*lead, -1)


# ----------------------------------------------------------------- dense

def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
          policy: ExecPolicy | None = None) -> torch.Tensor:
    """Policy-aware dense: fp (…, K) · (K, N) -> (…, N). ``int8`` runs the
    int8 datapath (``qdense``); ``qformat`` keeps the whole affine op on
    the Qm.n lattice; ``none`` is a plain fp32 matmul, as the reference's
    einsum sits outside any kernel."""
    pol = policy if policy is not None else current_policy()
    if pol.quant == "int8":
        if w.ndim != 2:
            raise ValueError(
                f"dense under quant='int8' needs a 2-D weight, got "
                f"{tuple(w.shape)}; reshape or drop to quant='none'")
        if is_dtensor(x):
            out = _qdense_sharded(x, w, pol)
            return out if b is None else out + b
        # the weight is quantized on every call, as in the reference
        out = qdense(x, quantize_int8(w, axis=0), out_dtype=x.dtype,
                     policy=pol)
        return out if b is None else out + b
    if pol.quant == "qformat":
        q = pol.qformat
        out = q.quantize(torch.matmul(q.quantize(x), q.quantize(w)))
        return out if b is None else q.quantize(out + q.quantize(b))
    if is_dtensor(x) and any(p.is_shard() and 0 < p.dim < x.ndim - 1
                             for p in x.placements):
        # rows split along the sequence: a product on local tensors
        out = matmul_rows(x, w)
    else:
        out = torch.matmul(x, w)
    return out if b is None else out + b


def _qdense_sharded(x, w, pol: ExecPolicy):
    """``dense`` under int8 on DTensors: each rank quantizes and runs
    ``qmatmul`` on its own shards, bitwise to the unsharded int8 path.

    ``w`` is laid out to ``x``: its K sharded where ``x``'s last dim is
    (the mesh dims ``kx``), its N kept where it is sharded, else whole.
    Every absmax over K is a max all-reduce over ``kx`` first (the
    per-row scale of ``x``, the per-column scale of ``w``), so the codes
    are the unsharded ones. Without ``kx`` (column-parallel) the local
    ``qmatmul`` is the output shard; with it (row-parallel) each rank's
    int32 accumulator (``qmatmul_acc``) is summed over ``kx``, exactly,
    and the epilogue ``(acc · xs) · ws`` runs once after the sum, as the
    kernel's does. The output keeps ``x``'s row shards and ``w``'s
    column shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core.parallelism import all_reduce
    mesh = x.device_mesh
    kd = x.ndim - 1
    kx = {i for i, p in enumerate(x.placements) if p.is_shard(kd)}
    rows = {i: p for i, p in enumerate(x.placements)
            if p.is_shard() and p.dim < kd}
    w = redistribute(w, tuple(
        Shard(0) if i in kx else
        (p if (p.is_shard(1) and i not in rows) else Replicate())
        for i, p in enumerate(w.placements)))
    xl, wl = x.to_local(), w.to_local()
    x2 = xl.reshape(-1, xl.shape[-1])
    amax_x = all_reduce(x2.to(torch.float32).abs().amax(-1, keepdim=True),
                        mesh, dist.ReduceOp.MAX, kx)
    amax_w = all_reduce(wl.to(torch.float32).abs().amax(0, keepdim=True),
                        mesh, dist.ReduceOp.MAX, kx)
    xq = quantize_int8(x2, axis=-1, amax=amax_x)
    wq = quantize_int8(wl, axis=0, amax=amax_w)
    if kx:
        acc = all_reduce(qmatmul_acc(xq.codes, wq.codes, policy=pol),
                         mesh, dist.ReduceOp.SUM, kx)
        out = (acc.to(torch.float32) * xq.scale * wq.scale).to(x.dtype)
    else:
        out = qmatmul(xq.codes, wq.codes, xq.scale, wq.scale,
                      out_dtype=x.dtype, policy=pol)
    out = out.reshape(*xl.shape[:-1], -1)
    place = [rows.get(i, Shard(kd) if w.placements[i].is_shard(1)
                      else Replicate()) for i in range(mesh.ndim)]
    return DTensor.from_local(out, mesh, place, run_check=False)


# --------------------------------------------------------- causal_conv1d

@register("causal_conv1d", "ref", priority=_REF_CPU)
def _causal_conv1d_ref(x, w, b=None, *, policy=None):
    """Oracle: materialize every K-deep window, one einsum (B, T, K, C)."""
    k = w.shape[0]
    t = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    win = torch.stack([pad[:, i:i + t, :] for i in range(k)], dim=2)
    y = torch.einsum("btkc,kc->btc", win, w)
    return y if b is None else y + b


# The reference has no Pallas kernel for this family (its roster's "—"),
# so there is no kernel to port: the K shifted adds are the family's
# design on the card too, not a fallback from one. Hence this family,
# and only this one, gives its plain backend a "cuda" priority.
@register("causal_conv1d", "torch", priority={"cpu": 10, "cuda": 10})
def _causal_conv1d_torch(x, w, b=None, *, policy=None):
    """K shifted adds (the unrolled window walk)."""
    k = w.shape[0]
    t = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):          # K is tiny (2-4): unrolled
        out = out + pad[:, i:i + t, :] * w[i]
    return out if b is None else out + b


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *,
                  policy: ExecPolicy | None = None) -> torch.Tensor:
    """Depthwise causal 1-D conv, the 1-D window pipeline (DESIGN.md §5).

    x: (B, T, C), w: (K, C) -> (B, T, C); y[t] = Σ_k w[k]·x[t-K+1+k] + b.
    Left-padded so every output sees exactly K (zero-extended) samples,
    matching Mamba's conv1d."""
    assert x.shape[-1] == w.shape[-1], (x.shape, w.shape)
    return dispatch("causal_conv1d", x, w, b, policy=policy)
