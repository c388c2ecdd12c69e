"""The accelerator's conv layer on the op registry (DESIGN.md §7).

Port of ``repro.core.conv``'s 2-D half: ``Conv2DConfig`` carries an
``ExecPolicy`` (or None, deferring to the ambient ``use_policy``), and
``conv2d_apply`` is one registry call — or, when its input is a
``TracedArray`` (repro_torch.graph.trace), records a Conv2D node.

``causal_conv1d``: the 1-D window pipeline of Mamba2 (DESIGN.md §5),
re-exported from the op registry; its decode-time ``causal_conv1d_step``
keeps a (K-1)-deep ring state, the paper's WINDOW_BUFFER holding the
last K-1 samples.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.window import conv_output_size
from repro_torch.ops.policy import ExecPolicy

__all__ = ["Conv2DConfig", "conv2d_init", "conv2d_apply",
           "causal_conv1d", "causal_conv1d_step"]


@dataclass(frozen=True)
class Conv2DConfig:
    in_channels: int
    out_channels: int
    kernel: tuple[int, int] = (3, 3)
    stride: tuple[int, int] = (1, 1)
    use_bias: bool = True
    policy: ExecPolicy | None = None

    def out_size(self, h: int, w: int) -> tuple[int, int]:
        return (conv_output_size(h, self.kernel[0], self.stride[0]),
                conv_output_size(w, self.kernel[1], self.stride[1]))


def conv2d_init(gen: torch.Generator, cfg: Conv2DConfig,
                device: torch.device) -> dict:
    """w ~ N(0, 1/fan_in) of shape (M, N, Kh, Kw), zero bias (M,). Drawn
    on the CPU from ``gen``, so a seed gives the same weights on any
    device."""
    kh, kw = cfg.kernel
    fan_in = cfg.in_channels * kh * kw
    w = torch.randn((cfg.out_channels, cfg.in_channels, kh, kw),
                    generator=gen) * fan_in ** -0.5
    params = {"w": w.to(device)}
    if cfg.use_bias:
        params["b"] = torch.zeros((cfg.out_channels,), device=device)
    return params


def conv2d_apply(params: dict, x, cfg: Conv2DConfig):
    """x: (B, N, H, W) -> (B, M, Ho, Wo) under the configured policy, or
    a Conv2D node when ``x`` is a ``TracedArray``."""
    hook = getattr(x, "graph_conv2d", None)
    if hook is not None:
        return hook(params, cfg)
    from repro_torch.ops import conv2d
    return conv2d(x, params["w"], params.get("b"), stride=cfg.stride,
                  policy=cfg.policy)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *,
                  policy: ExecPolicy | None = None) -> torch.Tensor:
    """Compat re-export of ``repro_torch.ops.causal_conv1d`` (the 1-D
    window pipeline, DESIGN.md §5)."""
    from repro_torch.ops import causal_conv1d as op
    return op(x, w, b, policy=policy)


def causal_conv1d_step(x_t: torch.Tensor, state: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode step with the (K-1)-deep window state.

    x_t: (B, C); state: (B, K-1, C) holding the previous K-1 inputs
    (oldest first). Returns (y_t, new_state): the ring shifted by one,
    the paper's WINDOW_BUFFER shift (step 2 of §III.B.2) in one
    dimension. The window sum is one contraction over K, as the
    reference's einsum, so a bf16 window accumulates in fp32."""
    k = w.shape[0]
    window = torch.cat([state, x_t[:, None, :]], dim=1)     # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w)
    if b is not None:
        y = y + b
    new_state = window[:, 1:, :] if k > 1 else state
    return y, new_state
