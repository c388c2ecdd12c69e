"""The op registry: named backends per op family, capability-aware dispatch.

Port of ``repro.ops.registry``. Each backend registers a **device
priority map** keyed on the device type of the call's first tensor
(``"cuda"`` or ``"cpu"``). A backend with no entry for a device is never
auto-selected there: on a CUDA tensor only the ``cuda`` backend (the
hand-written kernel) is a candidate, so the main path cannot drift onto a
plain PyTorch version. On a CPU tensor the order follows the JAX CPU
order, ``torch`` > ``cuda`` > ``ref``. The one family the reference gives
no Pallas kernel, ``causal_conv1d``, registers its plain backend for
``cuda`` as well (``ops/impls.py``).

A ``meta`` tensor (the dry run's shapes, ``launch/dryrun.py``) selects
by the ``cuda`` priorities: the step is priced as the card runs it. So
``causal_conv1d`` takes its plain shifted adds there, and each kernel
family its ``cuda`` wrapper, whose meta branch returns an empty output
and charges the kernel's own work to the op counter
(``launch/op_stats.py``); a call the card would refuse raises on meta
too.

An explicit ``policy.backend`` keeps the reference's rules:

  * family registers it and its predicate accepts → it runs (this is how
    a plain backend runs on the card: only when a policy names it);
  * family registers it but the predicate refuses → ``BackendUnavailable
    Error`` (no silent fallback);
  * family never registered it → device-priority auto-selection.

Auto-selection that finds no capable backend raises too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping

from repro_torch.ops.policy import ExecPolicy, current_policy

__all__ = ["OpImpl", "OpRegistry", "BackendUnavailableError", "REGISTRY",
           "register", "dispatch", "list_ops", "list_backends",
           "call_platform"]


class BackendUnavailableError(ValueError):
    """Requested backend is not registered, or rejects the call's args."""


def call_platform(args) -> str:
    """Device type of the first tensor argument (``"cpu"`` without one)."""
    for a in args:
        dev = getattr(a, "device", None)
        if dev is not None:
            return dev.type
    return "cpu"


# the dry run's shapes-only tensors select as the card's do
_SELECTS_AS = {"meta": "cuda"}


@dataclass(frozen=True)
class OpImpl:
    op: str
    backend: str
    fn: Callable
    priority: Mapping[str, int] = field(default_factory=dict)
    supports: Callable[..., bool] | None = None

    def rank(self, platform: str) -> int | None:
        """Auto-selection rank on ``platform``; None = never auto-picked."""
        return self.priority.get(_SELECTS_AS.get(platform, platform))

    def accepts(self, *args, **kwargs) -> bool:
        if self.supports is None:
            return True
        return bool(self.supports(*args, **kwargs))


class OpRegistry:
    def __init__(self):
        self._ops: dict[str, dict[str, OpImpl]] = {}

    def register(self, op: str, backend: str, *,
                 priority: Mapping[str, int],
                 supports: Callable[..., bool] | None = None) -> Callable:
        """Decorator: register ``fn`` as ``backend`` for ``op`` with a
        device-type → priority map."""
        def deco(fn: Callable) -> Callable:
            impls = self._ops.setdefault(op, {})
            if backend in impls:
                raise ValueError(f"{op}/{backend} registered twice")
            impls[backend] = OpImpl(op=op, backend=backend, fn=fn,
                                    priority=dict(priority),
                                    supports=supports)
            return fn
        return deco

    def ops(self) -> list[str]:
        return sorted(self._ops)

    def backends(self, op: str, platform: str = "cpu") -> list[str]:
        """Backends auto-selectable on ``platform``, best first."""
        impls = self._impls(op)
        ranked = [b for b in impls if impls[b].rank(platform) is not None]
        return sorted(ranked, key=lambda b: (-impls[b].rank(platform), b))

    def lookup(self, op: str, backend: str) -> OpImpl:
        """The registered ``backend`` of ``op``; ``BackendUnavailableError``
        if there is none."""
        impls = self._impls(op)
        if backend not in impls:
            raise BackendUnavailableError(
                f"op {op!r} has no {backend!r} backend; registered: "
                f"{sorted(impls)}")
        return impls[backend]

    def supported_backends(self, op: str, *args, **kwargs) -> list[str]:
        """Backends auto-selectable on the call's device that accept it,
        best first: ``[0]`` is what auto-dispatch would run."""
        impls = self._impls(op)
        return [b for b in self.backends(op, call_platform(args))
                if impls[b].accepts(*args, **kwargs)]

    def _impls(self, op: str) -> dict[str, OpImpl]:
        if op not in self._ops:
            raise KeyError(f"unknown op {op!r}; registered: {self.ops()}")
        return self._ops[op]

    def dispatch(self, op: str, *args, policy: ExecPolicy | None = None,
                 **kwargs):
        pol = policy if policy is not None else current_policy()
        impls = self._impls(op)
        if pol.backend is not None and pol.backend in impls:
            impl = impls[pol.backend]
            if not impl.accepts(*args, **kwargs):
                raise BackendUnavailableError(
                    f"backend {pol.backend!r} does not support this {op} "
                    f"call (shapes "
                    f"{[tuple(getattr(a, 'shape', ())) for a in args]})")
            return impl.fn(*args, policy=pol, **kwargs)
        platform = call_platform(args)
        for backend in self.backends(op, platform):
            impl = impls[backend]
            if impl.accepts(*args, **kwargs):
                return impl.fn(*args, policy=pol, **kwargs)
        raise BackendUnavailableError(
            f"no capable backend for op {op!r} on {platform} (auto-"
            f"selectable there: {self.backends(op, platform)}; shapes "
            f"{[tuple(getattr(a, 'shape', ())) for a in args]})")


REGISTRY = OpRegistry()
register = REGISTRY.register
dispatch = REGISTRY.dispatch
list_ops = REGISTRY.ops
list_backends = REGISTRY.backends
