"""``ArchSpec``: what ``--arch <id>`` resolves to (port of
``repro.configs.base``, the fields the serving and training paths read;
the shape grid and its input specs belong to the dry-run tooling,
ROADMAP §A.12)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["ArchSpec"]


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # cnn|dense|moe|vlm|audio|hybrid|ssm
    build: Callable[[], Any]          # -> model instance
    source: str                       # provenance note
    notes: str = ""
    frames: bool = False              # enc-dec: the encoder takes frames
    dec_frac: int = 4                 # enc-dec: decoder tokens = seq / this
    subquadratic: bool = False        # O(1)-state decode (zamba2, rwkv6)
    cache_seq_divisor: int = 1        # enc-dec: self cache = seq // this

    def model(self):
        return self.build()
