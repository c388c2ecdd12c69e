"""Arch registry: ``--arch <id>`` resolution (port of
``repro.configs.registry``; only ``mnist_cnn`` is ported so far — the
other archs wait for their slices, ROADMAP §A.6 and §A.11)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec

__all__ = ["get_arch", "ARCH_IDS"]

_MODULES = {
    "mnist_cnn": "repro_torch.configs.mnist_cnn",
}
ARCH_IDS = list(_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported so far: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
