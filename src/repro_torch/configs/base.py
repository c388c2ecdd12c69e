"""``ArchSpec``: what ``--arch <id>`` resolves to (port of
``repro.configs.base``, the fields the vision and LM serving paths
read)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["ArchSpec"]


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # cnn|dense|moe|vlm|hybrid|ssm
    build: Callable[[], Any]          # -> model instance
    source: str                       # provenance note
    notes: str = ""
    subquadratic: bool = False        # O(1)-state decode (zamba2, rwkv6)

    def model(self):
        return self.build()
