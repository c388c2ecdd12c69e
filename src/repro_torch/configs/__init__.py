"""Per-architecture configs (port of ``repro.configs``): the paper CNN,
the 224×224 streaming CNN and the reference's seven transformer LMs
(dense and MoE)."""
from repro_torch.configs.registry import ARCH_IDS, get_arch

__all__ = ["ARCH_IDS", "get_arch"]
