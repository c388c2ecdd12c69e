"""The program's hand-written CUDA kernels, by the names the profiler
gives their device launches (demangled C++ names of ``csrc/``).

``fused_cwp`` and ``conv_window`` are one template (``conv_tile.cuh``):
its kernels ``kernel<STAGED, POOL, KW>`` (fp32 route) and
``s8_kernel<POOL, NT>`` (int8 route) are ``fused_cwp``'s where ``POOL`` is
true and ``conv_window``'s where it is false.
"""
from __future__ import annotations

import re

__all__ = ["PATTERNS", "matcher", "is_port_kernel"]

PATTERNS = {
    "fused_cwp": r"conv_tile::(s8_kernel<true|kernel<(true|false), true)",
    "conv_window": r"conv_tile::(s8_kernel<false|kernel<(true|false), false)",
    "qmatmul": r"\b(tc_kernel|stream_kernel)\b",
    "addtree": r"\baddtree_(short|long)\b",
}
_COMPILED = {k: re.compile(v) for k, v in PATTERNS.items()}


def matcher(kernel: str):
    """A predicate on device-op names: true for ``kernel``'s launches."""
    pat = _COMPILED[kernel]
    return lambda name: pat.search(name) is not None


def is_port_kernel(name: str) -> bool:
    return any(p.search(name) for p in _COMPILED.values())
