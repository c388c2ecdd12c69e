"""Logical axis names on tensors (port of ``repro.sharding.logical``,
the part the models call).

The models annotate activations with *logical* axis names ("batch",
"heads", "mlp", …) through ``shard(x, ctx, *names)``. On one device that
is the identity, which is all the port serves today: ``shard`` returns
``x`` when ``ctx`` is None or has no mesh, and raises for a mesh, since
resolving names to a device layout is the work of ROADMAP §A.10's LM
half (the logical-axis rules).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["A", "ShardingCtx", "shard"]


class A:
    """Logical-axes annotation for one param: a plain tuple of names
    kept apart from the params tree's own containers."""

    __slots__ = ("names",)

    def __init__(self, *names: str | None):
        self.names = names

    def __repr__(self) -> str:
        return f"A{self.names!r}"

    def __eq__(self, other) -> bool:
        return isinstance(other, A) and self.names == other.names

    def __hash__(self) -> int:
        return hash(self.names)


@dataclass(frozen=True)
class ShardingCtx:
    """Threaded through model code; ``shard`` is a no-op when ``mesh`` is
    None, so models run unmodified on one device."""

    mesh: Any = None
    rules: Any = None


def shard(x: torch.Tensor, ctx: ShardingCtx | None, *names: str | None
          ) -> torch.Tensor:
    """``x`` itself on one device; a mesh raises (ROADMAP §A.10, the LM
    half)."""
    if ctx is None or ctx.mesh is None:
        return x
    raise NotImplementedError(
        f"shard over a mesh (logical axes {names}) is not ported yet "
        f"(ROADMAP §A.10, the LM half: logical-axis rules)")
