"""The paper's CNN (Tab. I) — the accelerator's workload, on PyTorch.

Port of ``repro.models.cnn``. Structure (MNIST 28×28×1, VALID padding):
  conv1: 3×3 × 15, stride 1   -> (15, 26, 26)
  relu + maxpool 2×2 stride 2 -> (15, 13, 13)
  conv2: 6×6 × 20, stride 1   -> (20, 8, 8)
  relu + maxpool 2×2 stride 2 -> (20, 4, 4)
  fc:    320 -> 10
14,180 parameters, the paper's Tab. I counts.

Parameters are a plain dict in the JAX layout — conv weights (M, N, Kh,
Kw), conv biases (M,), ``fc_w`` (K, N), ``fc_b`` (N,) — so a compiled
plan's ``ParamRef`` paths and ``repro_torch.bridge`` address the same
leaves. ``forward`` routes through the trace-aware functional layer, so
the same body is the eager model and the program ``compile()`` lifts into
an ``ExecutionPlan`` (DESIGN.md §8).
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

__all__ = ["PaperCNNConfig", "PaperCNN"]


@dataclass(frozen=True)
class PaperCNNConfig:
    name: str = "mnist_cnn"
    in_channels: int = 1
    img_size: int = 28
    conv1_k: int = 3
    conv1_c: int = 15
    conv2_k: int = 6
    conv2_c: int = 20
    n_classes: int = 10
    # None defers to the ambient use_policy(...) block
    policy: ExecPolicy | None = None

    @property
    def conv1_cfg(self) -> Conv2DConfig:
        return Conv2DConfig(self.in_channels, self.conv1_c,
                            (self.conv1_k, self.conv1_k), (1, 1),
                            policy=self.policy)

    @property
    def conv2_cfg(self) -> Conv2DConfig:
        return Conv2DConfig(self.conv1_c, self.conv2_c,
                            (self.conv2_k, self.conv2_k), (1, 1),
                            policy=self.policy)

    def exec_policy(self) -> ExecPolicy | None:
        return self.policy

    def feature_sizes(self) -> tuple[int, int, int]:
        """(post-pool1, post-pool2, flattened fc input)."""
        s1 = (self.img_size - self.conv1_k + 1) // 2
        s2 = (s1 - self.conv2_k + 1) // 2
        return s1, s2, s2 * s2 * self.conv2_c

    def flops_per_image(self) -> int:
        """Analytic MACs×2 for Tab. III-style accounting."""
        o1 = self.img_size - self.conv1_k + 1
        f1 = 2 * self.conv1_c * self.in_channels * self.conv1_k ** 2 * o1 * o1
        o2 = o1 // 2 - self.conv2_k + 1
        f2 = 2 * self.conv2_c * self.conv1_c * self.conv2_k ** 2 * o2 * o2
        return f1 + f2 + 2 * self.feature_sizes()[2] * self.n_classes

    def param_count(self) -> int:
        c1 = self.in_channels * self.conv1_k ** 2 * self.conv1_c + self.conv1_c
        c2 = self.conv1_c * self.conv2_k ** 2 * self.conv2_c + self.conv2_c
        fc = self.feature_sizes()[2] * self.n_classes + self.n_classes
        return c1 + c2 + fc


class PaperCNN:
    def __init__(self, cfg: PaperCNNConfig = PaperCNNConfig()):
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
        fc_in = cfg.feature_sizes()[2]
        return {
            "conv1": conv2d_init(gen, cfg.conv1_cfg, dev),
            "conv2": conv2d_init(gen, cfg.conv2_cfg, dev),
            "fc_w": dense_init(gen, (fc_in, cfg.n_classes), fc_in, dev),
            "fc_b": torch.zeros((cfg.n_classes,), device=dev),
        }

    def forward(self, params: dict, images):
        """images: (B, C, H, W) -> logits (B, n_classes). With a
        ``TracedArray`` the same body records the graph IR."""
        cfg = self.cfg
        x = conv2d_apply(params["conv1"], images, cfg.conv1_cfg)
        x = maxpool2(relu(x))
        x = conv2d_apply(params["conv2"], x, cfg.conv2_cfg)
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
        """trace → conv+relu+pool fusion → quant lowering → DQE →
        spatial-tiling placement, as an ``ExecutionPlan`` (DESIGN.md §8,
        §13). At the default ``stream_budget`` every stage
        fits and the plan is untiled; a smaller budget streams the conv
        stages as row bands. ``autotune`` bakes measured launch shapes in
        at bind (DESIGN.md §10); ``verify`` (default on) runs the plan
        verifier (§14); ``mesh`` places the conv stages channel-parallel
        over a ``DeviceMesh`` (§9/§15)."""
        from repro_torch.graph.plan import compile_model
        return compile_model(self, self.input_shape(batch), policy=policy,
                             fuse=fuse, mesh=mesh, autotune=autotune,
                             stream_budget=stream_budget, verify=verify)
