"""Per-architecture configs (port of ``repro.configs``): the paper CNN."""
from repro_torch.configs.registry import ARCH_IDS, get_arch

__all__ = ["ARCH_IDS", "get_arch"]
