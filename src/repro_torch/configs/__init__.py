"""Per-architecture configs (port of ``repro.configs``): the paper CNN
and the 224×224 streaming CNN."""
from repro_torch.configs.registry import ARCH_IDS, get_arch

__all__ = ["ARCH_IDS", "get_arch"]
