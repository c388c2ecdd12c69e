"""Multi-block VGG-style CNN — the high-resolution streaming workload.

Port of ``repro.models.vgg``. The paper's PaperCNN tops out at 28×28;
this model stacks conv blocks (conv → relu → 2×2 pool, each fused by the
graph compiler into one ``fused_conv_block`` stage) deep enough that a
≥224×224 input's early stages exceed the streaming budget and run as
halo-overlapped row bands (``repro_torch.stream``, DESIGN.md §13). VALID
padding throughout, like the paper's accelerator, so block kernel sizes
are chosen to keep every pre-pool feature map even (the ``maxpool2``
odd='raise' sizing discipline) — which is also what the ``fused_cwp``
kernel takes on the card.

Implements the same model protocol as ``PaperCNN`` (``input_shape`` /
``init`` / ``forward`` through the hooked functional layer /
``compile``), so ``VisionEngine`` and the launcher serve it unchanged.
Parameters are a plain dict in the JAX layout (``block<i>`` → ``w``
(M, N, K, K), ``b`` (M,); ``fc_w`` (K, N); ``fc_b`` (N,)), so
``repro_torch.bridge`` carries the reference's ``init`` across. ``loss``
is the reference's: mean NLL and accuracy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import torch

from repro_torch.core.conv import Conv2DConfig, conv2d_apply, conv2d_init
from repro_torch.core.window import maxpool2
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.graph.trace import dense, flatten, relu
from repro_torch.models.common import classifier_loss, dense_init
from repro_torch.ops.policy import ExecPolicy

if TYPE_CHECKING:
    from repro_torch.graph.plan import ExecutionPlan

__all__ = ["VGGStyleCNNConfig", "VGGStyleCNN"]


@dataclass(frozen=True)
class VGGStyleCNNConfig:
    """``blocks`` is a tuple of (out_channels, kernel) per conv block.

    The default chain at 224×224 (VALID conv, 2×2/2 pool):
    224 →(k5) 220→110 →(k3) 108→54 →(k3) 52→26 →(k3) 24→12 — every
    pre-pool map even, which the constructor validates for whatever
    ``img_size``/``blocks`` the caller picks (img_size ≡ 0 mod 4 works
    for the default blocks)."""

    name: str = "highres_cnn"
    in_channels: int = 3
    img_size: int = 224
    blocks: tuple[tuple[int, int], ...] = ((8, 5), (16, 3), (32, 3), (32, 3))
    n_classes: int = 10
    # None defers to the ambient use_policy(...) block
    policy: ExecPolicy | None = None

    def __post_init__(self):
        self.feature_sizes()            # validate the size chain now

    def block_cfg(self, i: int) -> Conv2DConfig:
        n = self.in_channels if i == 0 else self.blocks[i - 1][0]
        m, k = self.blocks[i]
        return Conv2DConfig(n, m, (k, k), (1, 1), policy=self.policy)

    def exec_policy(self) -> ExecPolicy | None:
        return self.policy

    def feature_sizes(self) -> tuple[int, ...]:
        """Post-pool spatial size after each block; raises when any
        pre-pool map is odd (the paper's pool would drop a row — sizing
        bug, same rule as PaperCNN)."""
        s = self.img_size
        sizes = []
        for i, (_, k) in enumerate(self.blocks):
            conv = s - k + 1
            if conv < 1:
                raise ValueError(f"block {i}: kernel {k} larger than "
                                 f"feature map {s}")
            if conv % 2:
                raise ValueError(
                    f"block {i}: pre-pool map {conv} is odd (img_size="
                    f"{self.img_size}); pick sizes that keep every "
                    f"conv output even (img_size % 4 == 0 works for the "
                    f"default blocks)")
            s = conv // 2
            sizes.append(s)
        return tuple(sizes)

    def fc_in(self) -> int:
        return self.feature_sizes()[-1] ** 2 * self.blocks[-1][0]

    def flops_per_image(self) -> int:
        """Analytic MACs×2 (conv blocks + fc) for GOPS accounting."""
        s = self.img_size
        n = self.in_channels
        total = 0
        for m, k in self.blocks:
            conv = s - k + 1
            total += 2 * m * n * k * k * conv * conv
            s, n = conv // 2, m
        return total + 2 * self.fc_in() * self.n_classes

    def param_count(self) -> int:
        n = self.in_channels
        total = 0
        for m, k in self.blocks:
            total += n * k * k * m + m
            n = m
        return total + self.fc_in() * self.n_classes + self.n_classes


class VGGStyleCNN:
    def __init__(self, cfg: VGGStyleCNNConfig = VGGStyleCNNConfig()):
        self.cfg = cfg

    def input_shape(self, batch: int = 1) -> tuple[int, int, int, int]:
        cfg = self.cfg
        return (batch, cfg.in_channels, cfg.img_size, cfg.img_size)

    def init(self, seed: int | torch.Generator = 0, *,
             device: str | torch.device = DEFAULT_DEVICE) -> dict:
        """Random weights from ``seed`` (an int or a CPU Generator), on
        ``device`` — the card unless the caller asks for the CPU."""
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
        cfg = self.cfg
        params = {f"block{i}": conv2d_init(gen, cfg.block_cfg(i), dev)
                  for i in range(len(cfg.blocks))}
        fc_in = cfg.fc_in()
        params["fc_w"] = dense_init(gen, (fc_in, cfg.n_classes), fc_in, dev)
        params["fc_b"] = torch.zeros((cfg.n_classes,), device=dev)
        return params

    def forward(self, params: dict, images):
        """(B, C, H, W) -> logits (B, n_classes); every op trace-aware,
        so ``compile`` fuses each block into one ``fused_conv_block``
        stage and the streaming pass tiles the over-budget ones. Eager,
        each conv is one ``conv2d`` call (``conv_window`` on the card)
        over the whole image."""
        cfg = self.cfg
        x = images
        for i in range(len(cfg.blocks)):
            x = conv2d_apply(params[f"block{i}"], x, cfg.block_cfg(i))
            x = maxpool2(relu(x))
        x = flatten(x)
        return dense(x, params["fc_w"], params["fc_b"],
                     policy=cfg.exec_policy())

    def loss(self, params: dict, batch: dict, ctx=None
             ) -> tuple[torch.Tensor, dict]:
        """batch: images (B, C, H, W), labels (B,) int -> (mean NLL,
        {"ce", "accuracy"}). On the card each conv is a ``conv_window``
        launch, and its gradient comes from ``ConvWindowFn``."""
        return classifier_loss(self.forward(params, batch["images"]),
                               batch["labels"])

    def compile(self, policy: ExecPolicy | None = None, *,
                fuse: bool = True, batch: int = 1, mesh=None,
                autotune: bool = False, stream_budget: int | None = None,
                verify: bool = True) -> "ExecutionPlan":
        """Same contract as ``PaperCNN.compile``: trace → block fusion →
        quant lowering → spatial-tiling placement. At the default 224×224
        the first two blocks exceed the streaming budget and execute as
        halo-overlapped row bands. ``autotune`` bakes measured launch
        shapes in at bind; ``verify`` (default on) runs the plan verifier;
        ``mesh`` places the conv stages channel-parallel (a sharded stage
        is never banded)."""
        from repro_torch.graph.plan import compile_model
        return compile_model(self, self.input_shape(batch), policy=policy,
                             fuse=fuse, mesh=mesh, autotune=autotune,
                             stream_budget=stream_budget, verify=verify)
