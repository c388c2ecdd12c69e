"""ExecPolicy — the execution-policy layer of the op registry (DESIGN.md §7).

Port of ``repro.ops.policy``. One immutable value carries

  * ``backend`` — preferred registered backend (``"ref" | "torch" |
    "cuda"``, the analogues of the JAX roster's ``ref | xla | pallas``)
    or ``None`` for auto-selection by the registry's device priorities;
  * ``quant``   — numeric format (``"none" | "qformat" | "int8"``, paper
    C4) with its ``QFormat`` lattice;
  * ``tiling``  — per-op launch-shape overrides (e.g. ``{"threads": 128}``
    or namespaced ``{"conv2d.threads": 128}``), consulted before the
    tuning cache and the heuristics in ``repro_torch.ops.tiling``;
  * ``channel_parallel`` — the channel-parallel schedule override of a
    mesh-compiled plan (``repro_torch.graph`` placement pass): ``None``
    lets the placement pick per layer, ``"input"``/``"icp"`` and
    ``"output"``/``"ocp"`` force the paper's Eq. 7 / Eq. 6 schedule on
    every conv stage, ``"none"`` pins the plan to data parallelism;
  * ``autotune`` — measure launch shapes on a tuning-cache miss
    (``repro_torch.ops.autotune``): a kernel wrapper's concrete call on
    the card, or every stage of a plan at bind time.

The CUDA kernels have no interpret mode, so the JAX ``interpret`` field
has no counterpart. Policies nest via ``use_policy`` (a contextvar).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field, replace
from typing import Literal, Mapping

from repro_torch.core.quantize import QFormat

__all__ = ["ExecPolicy", "use_policy", "current_policy", "BACKENDS",
           "QUANT_MODES", "CHANNEL_PARALLEL_MODES"]

BACKENDS = ("ref", "torch", "cuda")
QUANT_MODES = ("none", "qformat", "int8")
# canonical spellings of the paper's two channel-parallel schedules
# (§III.A): "output"/"ocp" = Eq. 6 shard-M, "input"/"icp" = Eq. 7 shard-N
CHANNEL_PARALLEL_MODES = ("none", "input", "output")
_CHANNEL_PARALLEL_ALIASES = {"icp": "input", "ocp": "output"}


@dataclass(frozen=True)
class ExecPolicy:
    """How ops execute: backend preference, quantization, launch shape."""

    backend: str | None = None
    quant: Literal["none", "qformat", "int8"] = "none"
    qformat: QFormat = field(default_factory=QFormat)
    tiling: tuple[tuple[str, int], ...] = ()
    channel_parallel: str | None = None
    autotune: bool = False

    def __post_init__(self):
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS} or None")
        if self.quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {self.quant!r}; "
                             f"expected one of {QUANT_MODES}")
        if self.channel_parallel is not None:
            cp = _CHANNEL_PARALLEL_ALIASES.get(self.channel_parallel,
                                               self.channel_parallel)
            if cp not in CHANNEL_PARALLEL_MODES:
                raise ValueError(
                    f"unknown channel_parallel mode "
                    f"{self.channel_parallel!r}; expected one of "
                    f"{CHANNEL_PARALLEL_MODES} (or icp/ocp) or None")
            object.__setattr__(self, "channel_parallel", cp)
        if isinstance(self.tiling, Mapping):
            object.__setattr__(self, "tiling",
                               tuple(sorted(self.tiling.items())))
        else:
            object.__setattr__(self, "tiling", tuple(self.tiling))

    @property
    def tile_overrides(self) -> dict[str, int]:
        return dict(self.tiling)

    def with_options(self, **overrides) -> "ExecPolicy":
        return replace(self, **overrides)


_ACTIVE: contextvars.ContextVar[ExecPolicy] = contextvars.ContextVar(
    "repro_torch_exec_policy", default=ExecPolicy())


def current_policy() -> ExecPolicy:
    """The innermost active policy (``ExecPolicy()`` outside any block)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_policy(policy: ExecPolicy | None = None, /, **overrides):
    """Activate ``policy`` (or the current one with field ``overrides``)
    for the dynamic extent of the block. Nests."""
    base = policy if policy is not None else current_policy()
    resolved = replace(base, **overrides) if overrides else base
    token = _ACTIVE.set(resolved)
    try:
        yield resolved
    finally:
        _ACTIVE.reset(token)
