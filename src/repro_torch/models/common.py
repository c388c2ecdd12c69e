"""Shared model building blocks (port of ``repro.models.common``): init
helpers, the norms, rotary embeddings, soft-capping, the activations and
the decode-position helper. The losses wait for ROADMAP §A.12.

The norms and rope upcast to fp32 and cast back, as the reference does,
so a bf16 model keeps fp32 statistics.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "stacked_init", "layer_view", "chunk_scan",
           "rms_norm",
           "layer_norm", "rope_freqs", "apply_rope", "softcap", "ACTIVATIONS",
           "sigmoid_per_op", "silu_per_op", "take_last_logits",
           "decode_q_pos"]


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
    ``device``."""
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


def layer_view(tree: dict, i: int) -> dict:
    """Layer ``i``'s params of a layer-stacked tree: views into the
    stacked tensors (the reference's ``lax.scan`` slices)."""
    return {k: layer_view(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


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


def take_last_logits(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1, :]
