"""Per-architecture configs (port of ``repro.configs``): the paper CNN,
the 224×224 streaming CNN and the dense LM qwen1.5-0.5b."""
from repro_torch.configs.registry import ARCH_IDS, get_arch

__all__ = ["ARCH_IDS", "get_arch"]
