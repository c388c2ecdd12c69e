"""Logical axis names -> mesh layouts, with divisibility guards (port of
``repro.sharding.logical``).

Every tensor is annotated with *logical* axis names ("batch", "heads",
"mlp", …); rules map each name to an ordered list of candidate mesh axes.
``spec_for`` resolves a concrete spec for a given shape on a given mesh,
taking the first candidate whose size divides the dimension (and which no
earlier dim has consumed), so every (arch × shape × mesh) combination
resolves even when e.g. kv_heads=8 cannot split over model=16.

A spec is a tuple with one entry per tensor dim (trailing ``None``s
trimmed, as the reference's ``PartitionSpec``): ``None``, a mesh axis
name, or a tuple of names used together (sizes multiply, the first one
major). On a ``DeviceMesh`` it becomes DTensor placements
(``placements``), one per mesh dim: ``Shard(d)`` where tensor dim ``d``
takes that mesh axis, ``Replicate()`` elsewhere; a tuple entry shards
one tensor dim over several mesh dims, in mesh order.

Parallelism realized through the rules (DESIGN.md §4):
  DP    batch          -> ('pod', 'data')
  FSDP  embed (params) -> 'data'    (ZeRO-3: stacked-layer params split)
  TP    heads/mlp/vocab/conv_out -> 'model'   (paper C1 output-channel)
  TP-in conv_in/mlp_in -> 'model'   (paper C1 input-channel, psum variant)
  EP    expert         -> 'model'
  SP    kv_seq         -> 'data' in SP_DECODE_RULES (long-context decode)

``shard(x, ctx, *names)`` redistributes a DTensor to the resolved layout
(the reference's ``with_sharding_constraint``); a plain tensor on a mesh
is taken as the same global value on every rank, and without a mesh
``shard`` is the identity, so models run unmodified on one device.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Sequence

import torch

__all__ = ["A", "ShardingRules", "ShardingCtx", "MeshShape",
           "NamedSharding", "DEFAULT_RULES", "SP_DECODE_RULES",
           "INPUT_PARALLEL_RULES", "FSDP_AXES", "spec_for", "placements",
           "shard", "on_mesh", "staged_mesh", "is_dtensor", "redistribute",
           "gathered", "whole", "local_part", "param_specs",
           "param_shardings", "distribute_tree", "mesh_sizes",
           "row_placements", "split_over", "spmd_local", "spmd_global",
           "matmul_rows", "local_offset", "write_part"]

# the mesh axes a parameter's FSDP (ZeRO-3) shards lie on: gathered
# before the parameter is used (``gathered``)
FSDP_AXES = ("pod", "data")


class A:
    """Logical-axes annotation for one param: a plain tuple of names
    kept apart from the params tree's own containers, so an axes tree
    mirrors the params tree with ``A`` leaves."""

    __slots__ = ("names",)

    def __init__(self, *names: str | None):
        self.names = names

    def __repr__(self) -> str:
        return f"A{self.names!r}"

    def __eq__(self, other) -> bool:
        return isinstance(other, A) and self.names == other.names

    def __hash__(self) -> int:
        return hash(self.names)


# logical axis -> ordered candidates; each candidate is a mesh-axis name or
# a tuple of mesh-axis names (used together, sizes multiply).
Rules = Mapping[str, Sequence[Any]]

_BASE: dict[str, Sequence[Any]] = {
    # activations
    "batch":      [("pod", "data"), "data"],
    # attention-internal batch dim: defaults to the DP axes; archs whose
    # head count does not divide the TP degree override it
    "attn_batch": [("pod", "data"), "data"],
    "act_seq":    [],                 # unsharded by default
    "act_embed":  [],
    "act_heads":  ["model"],
    "act_kv":     ["model"],
    "act_mlp":    ["model"],
    "act_vocab":  ["model"],
    "act_expert": ["model"],
    # KV-cache sequence dim over 'model': with GQA (kv_heads < model
    # size) the head dim cannot take the model axis, and an unsharded 32k
    # cache is tens of GB a device (distributed flash-decode)
    "kv_seq":     ["model"],
    # params — weight matrices: TP axis first, then FSDP over 'data'
    "embed":      ["data"],           # FSDP/ZeRO-3 on the d_model dim
    "vocab":      ["model"],
    "heads":      ["model"],
    "kv_heads":   ["model"],
    "head":       [],
    "mlp":        ["model"],
    "expert":     ["model"],
    "conv_out":   ["model"],          # paper C1 output-channel parallel
    "conv_in":    [],                 # 'model' in input-parallel mode
    "conv_spatial": [],
    "layers":     [],                 # stacked layer dim: never sharded
    "ssm_state":  [],
    "ssm_heads":  ["model"],
    "ssm_inner":  ["model"],
}


@dataclass(frozen=True)
class ShardingRules:
    table: Rules = field(default_factory=lambda: dict(_BASE))

    def with_overrides(self, **kw: Sequence[Any]) -> "ShardingRules":
        t = dict(self.table)
        t.update(kw)
        return ShardingRules(t)


DEFAULT_RULES = ShardingRules()
# long-context decode: the KV-cache sequence dim over BOTH axes (context /
# sequence parallelism); batch=1 cells don't use 'data' for batch
SP_DECODE_RULES = DEFAULT_RULES.with_overrides(
    kv_seq=[("data", "model"), "data"], batch=[("pod",)])
# paper Eq. (7) input-channel-parallel mode for conv / row-parallel matmul
INPUT_PARALLEL_RULES = DEFAULT_RULES.with_overrides(
    conv_in=["model"], conv_out=[])


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without any process group: enough to
    resolve specs (the reference's ``AbstractMesh``)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def _cand_axes(cand: Any) -> tuple[str, ...]:
    return cand if isinstance(cand, tuple) else (cand,)


def spec_for(mesh, shape: Sequence[int], names: Sequence[str | None],
             rules: ShardingRules = DEFAULT_RULES) -> tuple:
    """Resolve the spec of ``shape`` with logical ``names``.

    Guards: a mesh axis is used at most once; a candidate is taken only
    if its total size divides the dim; a size-1 candidate is skipped;
    None / unknown names replicate the dim; trailing Nones are trimmed."""
    assert len(shape) == len(names), (shape, names)
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    out: list[Any] = []
    for dim, name in zip(shape, names):
        entry = None
        if name is not None:
            for cand in rules.table.get(name, []):
                axes = _cand_axes(cand)
                if any(a not in sizes for a in axes):
                    continue
                if any(a in used for a in axes):
                    continue
                size = 1
                for a in axes:
                    size *= sizes[a]
                if size == 1:       # trivial axis: keep the spec clean
                    continue
                if dim % size != 0 or dim == 0:
                    continue
                # a one-axis tuple is that axis (as PartitionSpec has it)
                entry = axes[0] if len(axes) == 1 else cand
                used.update(axes)
                break
        out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names that axis,
    else ``Replicate()``. A tuple entry must list its axes in mesh order
    (it does in every rule table here), which is how DTensor nests
    several mesh dims on one tensor dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _cand_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for a in axes:
            where[a] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


@dataclass(frozen=True)
class ShardingCtx:
    """Threaded through model code; ``shard`` is the identity when
    ``mesh`` is None (one device), so models run unmodified there."""

    mesh: Any = None
    rules: ShardingRules = DEFAULT_RULES

    def with_rules(self, rules: ShardingRules) -> "ShardingCtx":
        return replace(self, rules=rules)


def on_mesh(ctx: ShardingCtx | None) -> bool:
    return ctx is not None and ctx.mesh is not None


def staged_mesh(ctx: ShardingCtx | None) -> bool:
    """Whether ``ctx``'s mesh spans ranks of a gloo world, whose
    collectives are staged through host memory (``sharding/groups.py``)
    and synchronise the card: steps on such a mesh run eagerly, never
    as a captured CUDA graph. NCCL's collectives stay on the stream."""
    if not on_mesh(ctx) or ctx.mesh.mesh.numel() == 1:
        return False
    import torch.distributed as dist
    return dist.get_backend() == "gloo"


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _replicated(x: torch.Tensor, mesh):
    """A plain tensor every rank holds whole, as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def redistribute(x, target):
    """``x`` (a DTensor) with ``target`` placements. A mesh dim that
    moves its shard to another tensor dim goes through ``Replicate``
    first (an all-gather, then a local slice), never through DTensor's
    all-to-all, which gloo groups (``sharding/groups.py``) do not run
    on card tensors."""
    from torch.distributed.tensor import Replicate
    target = tuple(target)
    cur = tuple(x.placements)
    if cur == target:
        return x
    mid = tuple(Replicate() if (c.is_shard() and t.is_shard() and c != t)
                else c for c, t in zip(cur, target))
    if mid != cur:
        x = x.redistribute(x.device_mesh, mid)
    return x if mid == target else x.redistribute(x.device_mesh, target)


def shard(x: torch.Tensor, ctx: ShardingCtx | None, *names: str | None
          ) -> torch.Tensor:
    """``x`` laid out over ``ctx.mesh`` as its logical ``names`` resolve:
    a DTensor is redistributed (the collectives that takes, autograd
    included); a plain tensor is taken as one global value every rank
    holds, and sliced to its shard. Without a mesh, ``x`` itself."""
    if not on_mesh(ctx):
        return x
    mesh = ctx.mesh
    if isinstance(mesh, MeshShape):
        raise TypeError("shard lays tensors out over a DeviceMesh; a "
                        "MeshShape only resolves specs (spec_for)")
    target = placements(mesh, spec_for(mesh, x.shape, names, ctx.rules))
    if not is_dtensor(x):
        x = _replicated(x, mesh)
    return redistribute(x, target)


def gathered(x, axes: tuple[str, ...] | None = FSDP_AXES):
    """``x`` with its shards over the mesh axes ``axes`` gathered (every
    axis when None): the FSDP gather of a parameter before its use, and
    its reduce-scatter under autograd. A plain tensor is returned
    as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = tuple(x.device_mesh.mesh_dim_names)
    target = tuple(Replicate() if (axes is None or n in axes) else p
                   for n, p in zip(names, x.placements))
    return redistribute(x, target)


def whole(x):
    """The global value of a DTensor as a plain tensor on every rank (an
    all-gather where it is sharded, an all-reduce where it is partial); a
    plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local_part(x) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(this rank's local tensor, its offset in the global tensor) of a
    DTensor; a plain tensor is its own part at offset 0. The local
    tensor is the DTensor's storage: writing it writes the DTensor."""
    if not is_dtensor(x):
        return x, (0,) * x.ndim
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return x._local_tensor, tuple(int(o) for o in offset)


# ------------------------------------------------- explicit SPMD regions
#
# Where the reference runs a block as explicit per-device code (the MoE's
# shard_map) or where the port runs one on each rank's shards (the
# Mamba2 and RWKV-6 heads), a region takes its inputs as local tensors
# (``spmd_local``, the shard_map's in_specs) and hands its outputs back
# as DTensors (``spmd_global``, its out_specs). Under autograd an input
# that the region's ranks use differently (each its own heads, experts
# or rows) gets a partial gradient over the mesh dims where they differ:
# ``divergent`` names them, and the gradient is reduced where the input
# came from.

def row_placements(x) -> tuple:
    """A DTensor's placements with only its batch (dim 0) shards kept,
    every other mesh dim Replicate: the rows a rank holds, whole in the
    other dims."""
    from torch.distributed.tensor import Replicate
    return tuple(p if p.is_shard(0) else Replicate() for p in x.placements)


def split_over(ctx: ShardingCtx, axis: str, *dims: int) -> tuple[int, int]:
    """(n, i): the size of mesh axis ``axis`` where it divides every one
    of ``dims`` (heads, channels) and exceeds 1, else 1; and this rank's
    coordinate on it (0 when n is 1, every rank then computing whole)."""
    n = mesh_sizes(ctx.mesh).get(axis, 1)
    if n <= 1 or any(d % n for d in dims):
        return 1, 0
    return n, ctx.mesh.get_local_rank(axis)


def spmd_local(x, mesh, target, divergent=()) -> torch.Tensor:
    """This rank's local tensor of ``x`` laid out by the placements
    ``target`` (a plain tensor is taken as the same global value on
    every rank). Its gradient is declared partial over the mesh dims
    named in ``divergent`` that ``target`` replicates."""
    from torch.distributed.tensor import Partial
    if not is_dtensor(x):
        x = _replicated(x, mesh)
    x = redistribute(x, tuple(target))
    names = tuple(mesh.mesh_dim_names)
    grad = tuple(Partial() if (names[i] in divergent and p.is_replicate())
                 else p for i, p in enumerate(target))
    return x.to_local(grad_placements=grad)


def spmd_global(t: torch.Tensor, mesh, placements):
    """The DTensor whose local tensor on this rank is ``t`` (a region's
    output): Shard where the ranks hold parts, Partial where their values
    are summed, Replicate where every rank holds the same."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False)


def matmul_rows(x, w):
    """``x @ w`` on local tensors: ``x`` (…, K) a DTensor, each rank
    multiplying the rows it holds (whole in K) by its part of ``w`` (K,
    N): the whole weight, or its columns where ``w`` is split over
    ``model`` in N (the product's columns are then split there too; a
    split elsewhere is gathered).
    DTensor's own matmul of a 3-D shard runs as a batch of one-row
    products, which a CPU's BLAS rounds otherwise than the unsharded
    product. Under autograd ``w``'s gradient is partial over the row
    shards, and ``x``'s over the column splits."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    rows = row_placements(x)
    wpl = tuple(p if (a == "model" and p.is_shard(1)) else Replicate()
                for a, p in zip(names, w.placements if is_dtensor(w)
                                else (Replicate(),) * mesh.ndim))
    cols = {a for a, p in zip(names, wpl) if p.is_shard()}
    xl = spmd_local(x, mesh, rows, cols)
    wl = spmd_local(w, mesh, wpl,
                    {a for a, p in zip(names, rows) if p.is_shard()})
    out = torch.matmul(xl, wl.to(xl.dtype))
    return spmd_global(out, mesh, tuple(
        p if p.is_shard() else (Shard(out.ndim - 1) if q.is_shard() else q)
        for p, q in zip(rows, wpl)))


def local_offset(x, placements) -> tuple[int, ...]:
    """The global offset of this rank's part of ``x`` (a DTensor or its
    global shape's holder) laid out by ``placements``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    _, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, tuple(placements))
    return tuple(int(o) for o in off)


def write_part(dst, src: torch.Tensor, offset: Sequence[int]) -> None:
    """Write ``src``, the block of global offset ``offset``, into the
    part of ``dst`` (a DTensor or a plain tensor, in place) that this
    rank holds: only where the two overlap."""
    loc, off = local_part(dst)
    d_sl, s_sl = [], []
    for o, n, so, sn in zip(off, loc.shape, offset, src.shape):
        lo, hi = max(o, so), min(o + n, so + sn)
        if lo >= hi:
            return
        d_sl.append(slice(lo - o, hi - o))
        s_sl.append(slice(lo - so, hi - so))
    loc[tuple(d_sl)] = src[tuple(s_sl)].to(loc.dtype)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def param_specs(shapes: Any, axes: Any, mesh,
                rules: ShardingRules = DEFAULT_RULES) -> Any:
    """Map a tree of tensors (or anything with ``.shape``) and a matching
    tree of ``A`` annotations to a tree of specs."""
    return _tree_map(lambda s, a: spec_for(mesh, tuple(s.shape), a.names,
                                           rules), shapes, axes)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): ``place``
    lays a global tensor that every rank holds out as a DTensor, each
    rank keeping its shard (a local slice, no collective)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def place(self, t: torch.Tensor):
        if is_dtensor(t):
            return redistribute(t, self.placements)
        return redistribute(_replicated(t, self.mesh), self.placements)


def param_shardings(shapes: Any, axes: Any, mesh,
                    rules: ShardingRules = DEFAULT_RULES) -> Any:
    """The tree of ``NamedSharding``s of ``param_specs`` on ``mesh``."""
    specs = param_specs(shapes, axes, mesh, rules)
    return _tree_map(lambda sp: NamedSharding(mesh, sp), specs)


def distribute_tree(tree: Any, axes: Any, ctx: ShardingCtx | None) -> Any:
    """A tree of global tensors (the same values on every rank) laid out
    on ``ctx.mesh`` by its ``A`` axes tree; without a mesh, ``tree``."""
    if not on_mesh(ctx):
        return tree
    sh = param_shardings(tree, axes, ctx.mesh, ctx.rules)
    return _tree_map(lambda t, s: s.place(t), tree, sh)
