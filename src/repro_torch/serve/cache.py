"""Slot-based batched KV-cache manager (DESIGN.md §6); port of
``repro.serve.cache``.

The cache is a fixed-capacity ring of sequence *slots*: one
``model.init_cache(capacity, max_seq)`` tree whose leaves carry the
batch dim at axis 1 (the transformer's (L, B, S, KV, hd) K/V), plus
host-side per-slot position tracking. A slot's stale contents are hidden
by the per-slot ``kv_len`` mask, so slot reuse never needs a memset.

Two storage modes:

* ``quant="none"``  — leaves stay in the model dtype.
* ``quant="int8"``  — float leaves are held as int8 codes + per-vector
  fp32 scales (``core.quantize`` symmetric int8 over the trailing axis:
  one scale per (layer, slot, position, head) vector). The engine
  dequantizes the WHOLE cache to the model dtype before each decode step
  and re-quantizes the whole cache after it, as the reference does. In
  bf16 that round trip is lossy, so the order of the casts is the
  reference's exactly: codes → fp32 · scale → model dtype, and model
  dtype → fp32 → codes.

With a ``ShardingCtx`` on a mesh the leaves are DTensors laid out by the
model's ``cache_axes()`` (under the default rules the KV sequence dim
over ``model``, the slots over ``data``), and a prefill's batch-1 cache
is joined whole and written into the part of the slot each rank holds.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.quantize import quantize_int8
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.serve.graphs import copy_tree
from repro_torch.sharding.logical import (distribute_tree, is_dtensor,
                                          local_part, on_mesh, whole)

__all__ = ["SlotKVCache", "dequantize_leaves"]


def _tree_map(fn: Callable, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _is_quantizable(leaf: torch.Tensor) -> bool:
    return leaf.is_floating_point() and leaf.ndim >= 2


def _scatter_slot(big: Any, small: Any, slot: int) -> None:
    """Write a batch-1 cache tree into batch slot ``slot`` of ``big``, in
    place: every leaf pair is (…, C, extra…) vs (…, 1, extra…) with batch
    at axis 1; sequence-bearing leaves may be shorter than max_seq in
    ``small`` and land at sequence offset 0."""

    def write(b, s):
        if b.ndim < 2:          # marker/scalar leaf: nothing slot-indexed
            return
        if is_dtensor(b):
            _write_box(b, whole(s), slot)
            return
        index = (slice(None), slice(slot, slot + 1)) + tuple(
            slice(0, n) for n in s.shape[2:])
        b[index] = s.to(b.dtype)

    _tree_map(write, big, small)


def _write_box(big, small: torch.Tensor, slot: int) -> None:
    """``_scatter_slot``'s write into a DTensor leaf: the box (all, slot,
    [0, n) for each later dim) cut to the part this rank holds."""
    loc, off = local_part(big)
    box = [(0, small.shape[0]), (slot, slot + 1)] + [
        (0, n) for n in small.shape[2:]]
    dst, src = [], []
    for (lo, hi), o, n in zip(box, off, loc.shape):
        a, b = max(lo, o), min(hi, o + n)
        if a >= b:
            return
        dst.append(slice(a - o, b - o))
        src.append(slice(a - lo, b - lo))
    loc[tuple(dst)] = small[tuple(src)].to(loc.dtype)


def _quantize_leaves(cache: Any) -> tuple[Any, Any]:
    """Split a float cache tree into (int8 codes, fp32 scales) trees.
    Non-float or low-rank leaves pass through unquantized, with a 0-d
    ones marker as their scale: its rank never equals a real leaf's,
    which is how ``dequantize_leaves`` tells passthrough from quantized."""

    def q(leaf):
        if _is_quantizable(leaf):
            t = quantize_int8(leaf, axis=-1)
            return t.codes, t.scale
        return leaf, torch.ones((), dtype=torch.float32, device=leaf.device)

    pairs = _tree_map(q, cache)
    return _tree_map(lambda p: p[0], pairs), _tree_map(lambda p: p[1], pairs)


def dequantize_leaves(codes: Any, scales: Any, dtype: torch.dtype) -> Any:
    """Inverse of ``_quantize_leaves``: codes · scale in fp32, cast to
    ``dtype``. A leaf whose scale is the 0-d marker (a model's own int8
    leaf, not quantized here) passes through untouched."""

    def dq(c, s):
        if c.dtype == torch.int8 and s.ndim == c.ndim:
            return (c.to(torch.float32) * s).to(dtype)
        return c

    return _tree_map(dq, codes, scales)


class SlotKVCache:
    """Fixed ring of ``capacity`` sequence slots over a model cache tree.

    Host-side metadata: ``pos[slot]`` is the next write position (== the
    number of valid cache entries); device-side data is either
    ``self.data`` (native mode) or ``self.codes``/``self.scales`` (int8
    mode), on ``device``.
    """

    def __init__(self, model, capacity: int, max_seq: int, *,
                 quant: str = "none",
                 device: str | torch.device = DEFAULT_DEVICE, ctx=None):
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {quant!r}")
        self.capacity = capacity
        self.max_seq = max_seq
        self.quant = quant
        self.dtype = model.cfg.dtype
        self.device = resolve_device(device)
        self.pos = np.zeros((capacity,), np.int32)
        init = model.init_cache(capacity, max_seq, device=self.device)
        if on_mesh(ctx):
            init = distribute_tree(init, model.cache_axes(), ctx)
        if quant == "int8":
            self.codes, self.scales = _quantize_leaves(init)
            self.data = None
        else:
            self.data = init
            self.codes = self.scales = None

    # ---------- device views ----------
    def device_state(self) -> tuple:
        """The trees handed to the engine's decode step (mode-dependent)."""
        if self.quant == "int8":
            return (self.codes, self.scales)
        return (self.data,)

    def set_device_state(self, *state) -> None:
        """Write a step's new cache trees into the device leaves in place
        (a leaf that already is one is skipped). The leaves are never
        rebound: the decode graph reads them at fixed addresses."""
        copy_tree(self.device_state(), state)

    # ---------- slot operations ----------
    def write_prefill(self, slot: int, prefill_cache: Any, length: int
                      ) -> None:
        """Scatter a batch-1 prefill cache into ``slot``; positions beyond
        ``length`` keep whatever the previous tenant left (masked out)."""
        if length > self.max_seq:
            raise ValueError(f"prompt length {length} > max_seq "
                             f"{self.max_seq}")
        if self.quant == "int8":
            pc, ps = _quantize_leaves(prefill_cache)
            _scatter_slot(self.codes, pc, slot)
            _scatter_slot(self.scales, ps, slot)
        else:
            _scatter_slot(self.data, prefill_cache, slot)
        self.pos[slot] = length

    def free(self, slot: int) -> None:
        """Release a slot. Metadata only: stale K/V stays resident and is
        hidden by the kv_len mask until the next tenant overwrites it."""
        self.pos[slot] = 0

    def advance(self, slot: int) -> None:
        self.pos[slot] += 1

    def remaining(self, slot: int) -> int:
        return self.max_seq - int(self.pos[slot])

    def positions(self) -> np.ndarray:
        return self.pos.copy()

    # ---------- accounting ----------
    def nbytes(self) -> int:
        """Resident cache bytes (the int8 win made measurable)."""
        trees = (self.codes, self.scales) if self.quant == "int8" \
            else (self.data,)
        return int(sum(leaf.numel() * leaf.element_size()
                       for t in trees for leaf in _leaves(t)))
