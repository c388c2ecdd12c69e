"""The accelerator's conv layer on the op registry (DESIGN.md §7).

Port of ``repro.core.conv``'s 2-D half: ``Conv2DConfig`` carries an
``ExecPolicy`` (or None, deferring to the ambient ``use_policy``), and
``conv2d_apply`` is one registry call — or, when its input is a
``TracedArray`` (repro_torch.graph.trace), records a Conv2D node.
``causal_conv1d`` waits for the sequence-model slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.window import conv_output_size
from repro_torch.ops.policy import ExecPolicy

__all__ = ["Conv2DConfig", "conv2d_init", "conv2d_apply"]


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
