"""Per-op cost of a step, counted on the meta device: the port's
counterpart of ``repro.launch.hlo_stats``.

The reference compiles a step and walks its optimized HLO text: FLOPs of
every ``dot`` and ``convolution``, operand + output bytes of every
top-level op, each ``while`` body multiplied by its trip count. PyTorch
has no compiled program to read, so the port runs the step itself on
tensors of the ``meta`` device (shapes and dtypes, no storage, no
arithmetic) under ``OpCounter``, a ``TorchDispatchMode`` that sees every
aten op the step dispatches, the backward's included:

* FLOPs: ``torch.utils.flop_counter``'s registered formulas (``mm``,
  ``bmm``, ``addmm``, the convolutions, attention), each kept apart by
  the dtype of its first operand, since the card's peak depends on it
  (``launch/roofline.py``). Every registered formula is a contraction,
  so they are also ``dot_flops``. Elementwise ops charge no FLOPs (the
  reference's HLO walk charges one an element; on the card they are
  bounded by their bytes).
* Ops whose tensors all lie on the CPU are the host's (a constant
  computed in Python), not the step's, and charge nothing.
* Bytes: each op's tensor operands plus its tensor outputs, the
  eager-mode HBM traffic of a kernel a op. Views and metadata ops charge
  nothing (the reference's ``_SKIP_BYTES`` for layout ops), nor does
  ``empty``; an op that overwrites its destination without reading it
  (``copy_``, ``fill_``, ``zero_``, and ``index_put_``, which writes its
  values' elements only) charges that destination once; a gather
  (``index``, ``index_select``, ``gather``, ``embedding``) charges its
  indices and the elements it returns, read and written, not its whole
  source (an embedding lookup reads its rows, not the table).
* The four CUDA kernels: their wrappers' meta branch returns an empty
  output and calls ``OpCounter.charge_kernel`` with the kernel's own work
  (``kernels/common.py`` ``charge_meta``), under the kernel's name; the
  plain version never runs on meta.
* Loops: ``count(fn, ..., repeat=n)`` counts one pass and multiplies it
  by n, as ``_trip_count`` multiplies a ``while`` body; the dry run
  counts one training microbatch so.
* Peak live bytes: the mode's own storage accounting. Every storage the
  step creates is live from the op that made it until its last
  reference dies (a weakref callback on the storage, which PyTorch keeps
  alive while autograd or a view holds it), each rounded up to the CUDA
  caching allocator's 512-byte blocks; the arguments' storages are live
  throughout. ``peak_bytes`` is the most live at once.
* Collectives: none on one device (``collective_bytes`` 0); the LMs'
  meshes are the LM half of ROADMAP §A.10.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCost", "OpStats", "OpCounter", "count", "ALLOC_BLOCK"]

ALLOC_BLOCK = 512     # the CUDA caching allocator's rounding, in bytes

_aten = torch.ops.aten
# ops that move no data although their schema does not say they alias
_NO_BYTES = {_aten._unsafe_view, _aten.alias, _aten.lift_fresh,
             _aten._reshape_alias, _aten.empty, _aten.empty_like,
             _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided}
# in-place ops that write their first operand without reading it
_OVERWRITE = {_aten.copy_, _aten.fill_, _aten.zero_}
# gathers (source first): they read the elements they return, not their
# whole source
_GATHER = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}


@dataclass
class OpCost:
    count: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0


@dataclass
class OpStats:
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0                 # one device: none
    flops_by_dtype: dict = field(default_factory=dict)   # "bfloat16" -> F
    ops: dict = field(default_factory=dict)       # name -> OpCost
    peak_bytes: int = 0

    def add(self, other: "OpStats", mult: float = 1.0) -> "OpStats":
        """``other`` × ``mult`` added in place; the peak is the larger
        one (parts counted apart run one after another)."""
        self.flops += other.flops * mult
        self.dot_flops += other.dot_flops * mult
        self.bytes_accessed += other.bytes_accessed * mult
        self.collective_bytes += other.collective_bytes * mult
        for k, v in other.flops_by_dtype.items():
            self.flops_by_dtype[k] = self.flops_by_dtype.get(k, 0.0) + v * mult
        for k, c in other.ops.items():
            mine = self.ops.setdefault(k, OpCost())
            mine.count += c.count * mult
            mine.flops += c.flops * mult
            mine.bytes += c.bytes * mult
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)
        return self

    def top(self, n: int) -> list[tuple[str, OpCost]]:
        """The ``n`` ops that moved the most bytes."""
        return sorted(self.ops.items(), key=lambda kv: -kv[1].bytes)[:n]

    def to_dict(self) -> dict:
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "bytes_accessed": self.bytes_accessed,
                "collective_bytes": self.collective_bytes,
                "flops_by_dtype": dict(self.flops_by_dtype),
                "peak_bytes": self.peak_bytes,
                "top_ops_by_bytes": [
                    {"op": k, "count": c.count, "flops": c.flops,
                     "bytes": c.bytes} for k, c in self.top(10)]}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched inside it into ``stats`` (see the
    module docstring). ``track`` marks trees as live for the peak."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self._live = 0
        self._storages: dict[int, weakref.ref] = {}

    # ---------------------------------------------------------- liveness
    def track(self, *trees) -> None:
        """Count every tensor storage of ``trees`` as live from now on,
        until it dies."""
        for t in _tensors(trees):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        size = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK

        def dead(_, key=key, size=size):
            self._live -= size
            self._storages.pop(key, None)

        self._storages[key] = weakref.ref(st, dead)
        self._live += size
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)

    # ------------------------------------------------------------ costs
    def _charge(self, name: str, flops: float, dtype: str | None,
                nbytes: float, dot: bool) -> None:
        s = self.stats
        c = s.ops.setdefault(name, OpCost())
        c.count += 1
        c.bytes += nbytes
        s.bytes_accessed += nbytes
        if flops:
            c.flops += flops
            s.flops += flops
            if dot:
                s.dot_flops += flops
            s.flops_by_dtype[dtype] = s.flops_by_dtype.get(dtype, 0.0) + flops

    def charge_kernel(self, name: str, *, ops: float, dtype: torch.dtype,
                      nbytes: float, dot: bool = True) -> None:
        """A CUDA kernel's own work (its wrapper's meta branch): ``ops``
        operations in ``dtype`` and ``nbytes`` moved, under ``name``."""
        self._charge(name, float(ops), str(dtype).replace("torch.", ""),
                     float(nbytes), dot)

    @staticmethod
    def _op_bytes(func, args, kwargs, out) -> int:
        outs = _tensors(out)
        if not outs or func.is_view or func._overloadpacket in _NO_BYTES:
            return 0
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        if packet in _OVERWRITE:
            return sum(_nbytes(t) for t in ins)     # dst written, src read
        if packet is _aten.index_put_:
            # indices and values read, the values' elements written
            return sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[-1])
        if packet in _GATHER:
            # the indices and the gathered elements read, the output written
            return sum(_nbytes(t) for t in ins[1:]) \
                + 2 * sum(_nbytes(t) for t in outs)
        return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if all(t.device.type == "cpu" for t in _tensors((args, kwargs, out))):
            return out      # the host's arithmetic (a constant), not the step's
        packet = func._overloadpacket
        flops, dtype = 0, None
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            first = _tensors((args, kwargs))[0]
            dtype = str(first.dtype).replace("torch.", "")
        self._charge(str(packet), float(flops), dtype,
                     float(self._op_bytes(func, args, kwargs, out)),
                     dot=True)
        for t in _tensors(out):
            self._track(t)
        return out


def count(fn: Callable, *args, repeat: int = 1, live=(), **kwargs
          ) -> tuple[Any, OpStats]:
    """(``fn(*args, **kwargs)``, its OpStats × ``repeat``). ``args``,
    ``kwargs`` and the trees in ``live`` (what the caller holds meanwhile:
    a step's params while one microbatch runs) count as live for the
    peak, once."""
    with OpCounter() as c:
        c.track(args, kwargs, live)
        out = fn(*args, **kwargs)
    return out, OpStats().add(c.stats, repeat)
