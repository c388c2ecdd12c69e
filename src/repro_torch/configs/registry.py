"""Arch registry: ``--arch <id>`` resolution (port of
``repro.configs.registry``). Ported so far: the paper's ``mnist_cnn``
(Tab. I) and ``highres_cnn`` (224×224, streamed through
``repro_torch.stream``); the LM archs wait for ROADMAP §A.11.
``highres_cnn`` is servable via ``--arch`` but stays out of
``ARCH_IDS``, as in the reference."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec

__all__ = ["get_arch", "ARCH_IDS"]

_MODULES = {
    "mnist_cnn": "repro_torch.configs.mnist_cnn",
    "highres_cnn": "repro_torch.configs.highres_cnn",
}
ARCH_IDS = [a for a in _MODULES if a != "highres_cnn"]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported so far: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
