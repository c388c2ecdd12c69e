"""Per-architecture configs (port of ``repro.configs``): the paper CNN,
the 224×224 streaming CNN, the reference's seven transformer LMs (dense
and MoE) and its two sub-quadratic LMs (zamba2-7b, rwkv6-1.6b)."""
from repro_torch.configs.registry import ARCH_IDS, get_arch

__all__ = ["ARCH_IDS", "get_arch"]
