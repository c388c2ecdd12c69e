"""Arch registry: ``--arch <id>`` resolution (port of
``repro.configs.registry``). Ported so far: the paper's ``mnist_cnn``
(Tab. I), ``highres_cnn`` (224×224, streamed through
``repro_torch.stream``) and the dense LM ``qwen1.5-0.5b``; the other LM
archs wait for ROADMAP §A.11. As in the reference, both CNNs are
servable via ``--arch`` and stay out of ``ARCH_IDS``, the LM archs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec

__all__ = ["get_arch", "ARCH_IDS"]

_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "mnist_cnn": "repro_torch.configs.mnist_cnn",
    "highres_cnn": "repro_torch.configs.highres_cnn",
}
# the vision workloads are servable via --arch but are not LM archs
ARCH_IDS = [a for a in _MODULES if a not in ("mnist_cnn", "highres_cnn")]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported so far: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
