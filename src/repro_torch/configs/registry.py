"""Arch registry: ``--arch <id>`` resolution (port of
``repro.configs.registry``). Every arch of the reference resolves: the
paper's ``mnist_cnn`` (Tab. I), ``highres_cnn`` (224×224, streamed
through ``repro_torch.stream``), every transformer arch, dense and MoE,
the two sub-quadratic LMs (the Mamba2 hybrid zamba2-7b and rwkv6-1.6b)
and the encoder-decoder seamless-m4t-medium. As in the reference, both
CNNs are servable via ``--arch`` and stay out of ``ARCH_IDS``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec

__all__ = ["get_arch", "ARCH_IDS"]

_MODULES = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_16b",
    "mnist_cnn": "repro_torch.configs.mnist_cnn",
    "highres_cnn": "repro_torch.configs.highres_cnn",
}
# the vision workloads are servable via --arch but are not LM archs
ARCH_IDS = [a for a in _MODULES if a not in ("mnist_cnn", "highres_cnn")]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
