"""High-resolution streaming workload: multi-block VGG-style CNN at
224×224 (DESIGN.md §13). The first two blocks exceed the streaming
budget and execute as halo-overlapped row bands through
``repro_torch.stream`` — on the card, one ``fused_cwp`` launch a band.

Port of ``repro.configs.highres_cnn``; served by
``python -m repro_torch.launch.serve --arch highres_cnn``.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.vgg import VGGStyleCNN, VGGStyleCNNConfig

CONFIG = VGGStyleCNNConfig()

ARCH = ArchSpec(
    arch_id="highres_cnn", family="cnn",
    build=lambda: VGGStyleCNN(CONFIG),
    source="VGG-style stack (survey arXiv:1806.01683 §streaming dataflow)",
    notes="224x224x3; conv5x5x8 + 3 conv3x3 blocks (each fused conv+relu+"
          "pool) -> fc10; early stages spatially tiled via "
          "repro_torch.stream.",
)
