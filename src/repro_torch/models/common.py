"""Shared model building blocks (port of ``repro.models.common``): init
helpers, the norms, rotary embeddings, soft-capping, the activations and
the decode-position helper, the two cross entropies the models' losses
use, and ``remat``, the per-layer activation checkpoint of training.

The norms and rope upcast to fp32 and cast back, as the reference does,
so a bf16 model keeps fp32 statistics.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["dense_init", "stacked_init", "layer_views", "chunk_scan",
           "rms_norm",
           "layer_norm", "rope_freqs", "apply_rope", "softcap", "ACTIVATIONS",
           "sigmoid_per_op", "silu_per_op", "take_last_logits",
           "decode_q_pos", "cross_entropy_loss", "chunked_cross_entropy",
           "classifier_loss", "remat"]


def decode_q_pos(pos, batch: int) -> torch.Tensor:
    """Query positions (B, 1) for a single-token decode step.

    ``pos`` is a scalar (the whole batch at one position) or a (B,)
    vector of per-sequence positions (slot-based continuous batching,
    DESIGN.md §6: every slot advances independently)."""
    pos = torch.as_tensor(pos, dtype=torch.int32)
    if pos.ndim == 0:
        return pos.reshape(1, 1).expand(batch, 1)
    return pos[:, None]


def dense_init(gen: torch.Generator, shape: tuple[int, ...], fan_in: int,
               device: torch.device) -> torch.Tensor:
    """Truncated-normal fan-in init (std = 1/sqrt(fan_in), cut at ±2σ),
    drawn from ``gen`` on the generator's own device, then moved to
    ``device``. On the meta device nothing is drawn: ``init(gen,
    device="meta")`` gives a tree of shapes and dtypes (the reference's
    ``eval_shape``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device=device)
    w = torch.empty(shape, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * fan_in ** -0.5).to(device)


def stacked_init(init_fn: Callable[[torch.Generator], dict],
                 gen: torch.Generator, n: int) -> dict:
    """Run ``init_fn`` ``n`` times -> params stacked on a leading layer
    dim (the reference vmaps its init over ``n`` keys). Layer 0 sets each
    stacked leaf's shape; each later layer is drawn in turn and copied
    into its row, so the peak holds the stack and one layer, never the
    list of layers beside their stack."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        out[0] = t
        return out

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    stacked = alloc(init_fn(gen))
    for i in range(1, n):
        put(stacked, init_fn(gen), i)
    return stacked


def layer_views(tree: dict) -> list[dict]:
    """Each layer's params of a layer-stacked tree (the reference's
    ``lax.scan`` slices): views into the stacked tensors, from one
    ``torch.unbind`` of each. Under autograd the layers' gradients reach
    a stack through unbind's one backward (a ``stack``), where a view a
    layer (``select``) would zero-fill and add a whole stack for each
    layer: L² traffic."""
    unbound = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda u: u[i], unbound)
            for i in range(len(tree_leaves(unbound)[0]))]


def chunk_scan(init: torch.Tensor, decay: torch.Tensor,
               inputs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked scans' inter-chunk recurrence (the reference's
    ``lax.scan`` over chunks): carry ← carry · decay[:, z] + inputs[:, z]
    for each chunk z, ``decay`` already broadcastable against a carry.
    Returns (the state BEFORE each chunk, stacked on dim 1; the final
    state)."""
    carry, prev = init, []
    for z in range(inputs.shape[1]):
        prev.append(carry)
        carry = carry * decay[:, z] + inputs[:, z]
    return torch.stack(prev, dim=1), carry


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32. ``plus_one``: gemma-style (1 + w) scaling, so a
    zero init is the identity."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    w = scale.to(torch.float32)
    return (x * ((1.0 + w) if plus_one else w)).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None = None, *, eps: float = 1e-5
               ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x * scale.to(torch.float32)
    if bias is not None:
        x = x + bias.to(torch.float32)
    return x.to(dt)


def _const(value: float, like: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A 0-d ``dtype`` tensor on ``like``'s device, made by a fill: no
    host-to-device copy (which would make the host wait for the stream),
    and, as a divisor, a true division (CUDA turns a division by a host
    scalar into a multiplication by its reciprocal)."""
    return torch.full((), value, dtype=dtype, device=like.device)


def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (…,) -> (cos, sin) each (…, head_dim/2), fp32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / _const(half, positions)
    inv = torch.pow(_const(theta, positions), exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B?, S, D/2) broadcastable. Split-half
    rotation in fp32."""
    dt = x.dtype
    x = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :] if cos.ndim == x.ndim - 1 else cos
    s = sin[..., None, :] if sin.ndim == x.ndim - 1 else sin
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap), in fp32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / _const(cap, x))
            ).to(x.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    # the reference's jax.nn.silu: x · sigmoid(x), rounded after each op
    return x * torch.sigmoid(x)


def sigmoid_per_op(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it on the CPU, jitted or not:
    1 / (1 + exp(-x)), each op rounded to ``x``'s dtype. In bf16 about a
    third of its values lie an ulp from the fp32 sigmoid rounded once
    (``ACTIVATIONS["silu"]``'s, which the transformer keeps); the Mamba2
    and RWKV-6 blocks use this one, and so match the reference's bf16
    bitwise."""
    return 1 / (1 + torch.exp(-x))


def silu_per_op(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` rounded as the reference's: x · ``sigmoid_per_op``."""
    return x * sigmoid_per_op(x)


# jax.nn.gelu defaults to the tanh approximation, so "gelu" is it too
ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": _silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "relu_sq": lambda x: torch.square(torch.relu(x)),
}


def remat(policy: str, fn: Callable, *args):
    """``fn(*args)``, under an activation checkpoint when ``policy`` is not
    ``"none"`` and grad mode is on: the reference's per-layer
    ``jax.checkpoint`` (``"full"``: nothing saved; its ``"dots"`` policy,
    which keeps the matmul outputs, is taken as ``"full"`` here). The
    forward is recomputed in the backward, op for op, so the gradients
    are those of the plain call."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _mean(nll: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """The token mean of ``nll``, over ``mask``'s tokens when given, as a
    true division on every device."""
    if mask is not None:
        m = mask.reshape(nll.shape).to(torch.float32)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.sum() / _const(nll.numel(), nll)


def _ce_chunk(xt, wc, run_max, run_sum, lab_logit, lab, lo: int,
              chunk: int, transpose_weight: bool, final_softcap):
    """One vocab chunk of ``chunked_cross_entropy``: the chunk's logits,
    padded to ``chunk`` columns with -inf, folded into the running max,
    the running sum of exponentials and the label's logit."""
    wc = wc.to(torch.float32)
    logits = xt @ (wc if transpose_weight else wc.T)
    if final_softcap is not None:
        cap = _const(final_softcap, logits)
        logits = cap * torch.tanh(logits / cap)
    if logits.shape[1] < chunk:
        logits = F.pad(logits, (0, chunk - logits.shape[1]),
                       value=float("-inf"))
    new_max = torch.maximum(run_max, logits.amax(-1))
    run_sum = run_sum * torch.exp(run_max - new_max) + \
        torch.exp(logits - new_max[:, None]).sum(-1)
    local = lab - lo
    in_chunk = (local >= 0) & (local < chunk)
    picked = torch.gather(logits, 1, local.clamp(0, chunk - 1)[:, None])
    lab_logit = lab_logit + torch.where(in_chunk, picked[:, 0], 0.0)
    return new_max, run_sum, lab_logit


def chunked_cross_entropy(x: torch.Tensor, weight: torch.Tensor,
                          labels: torch.Tensor, *,
                          transpose_weight: bool = False,
                          final_softcap: float | None = None,
                          mask: torch.Tensor | None = None,
                          chunk: int = 8_192) -> torch.Tensor:
    """Cross entropy without materializing the (B,S,V) logits: an online
    logsumexp over vocab chunks of ``chunk`` columns, each chunk under an
    activation checkpoint so that the backward keeps only the running
    reductions (3 × B·S floats a chunk) and recomputes the chunk's
    logits. The last chunk's missing columns are -inf (the reference pads
    the weight with zero rows and masks them; the weight is not copied
    here). ``final_softcap`` caps each logit; ``mask`` (B,S) averages over
    its tokens. Functionally the softmax CE on full logits.

    x: (B,S,D) final hidden; weight: (V,D) tied embedding or (D,V)
    lm_head (transpose_weight=True); labels: (B,S) int."""
    b, s, d = x.shape
    v = weight.shape[1] if transpose_weight else weight.shape[0]
    xt = x.reshape(b * s, d).to(torch.float32)
    lab = labels.reshape(b * s).to(device=x.device, dtype=torch.long)
    run_max = torch.full((b * s,), float("-inf"), device=x.device)
    run_sum = torch.zeros((b * s,), device=x.device)
    lab_logit = torch.zeros((b * s,), device=x.device)
    for lo in range(0, v, chunk):
        wc = weight[:, lo:lo + chunk] if transpose_weight \
            else weight[lo:lo + chunk]
        run_max, run_sum, lab_logit = remat(
            "full", lambda *a, lo=lo: _ce_chunk(
                *a, lo, chunk, transpose_weight, final_softcap),
            xt, wc, run_max, run_sum, lab_logit, lab)
    nll = (run_max + torch.log(run_sum)) - lab_logit
    return _mean(nll, mask)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32. logits (B,S,V), labels (B,S)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return _mean(lse - ll, mask)


def classifier_loss(logits: torch.Tensor, labels: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
    """The CNNs' loss: mean NLL of log-softmax in fp32 over (B, classes)
    logits, with ``{"ce", "accuracy"}``."""
    labels = labels.to(device=logits.device, dtype=torch.long)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -_mean(torch.gather(logp, -1, labels[:, None])[:, 0], None)
    acc = _mean((logits.argmax(-1) == labels).to(torch.float32), None)
    return nll, {"ce": nll, "accuracy": acc}


def take_last_logits(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1, :]
