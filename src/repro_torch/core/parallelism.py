"""Channel-parallel convolution schedules — paper §III.A (C1), Eq. (6)/(7).

Port of ``repro.core.parallelism`` over ``torch.distributed``. The
paper's "compute units" are the ranks of a ``DeviceMesh``'s ``model``
axis, and its two ways to split the conv reduction are two sharding and
collective patterns over that axis:

* OUTPUT-channel parallel (Eq. 6, OCP): each rank owns M/S output
  channels of the weights and sees the full input; no collective.
* INPUT-channel parallel (Eq. 7, ICP, Fig. 3): each rank owns N/S input
  channels and computes the partial sums of its slice; one ring reduce
  combines the partials, and the bias (and the int8 requant scale) joins
  once, after the reduce.
* BOTH (DESIGN.md §15): the ``model`` axis factors into an icp × ocp
  sub-grid (``stage_mesh``), each rank owning an (M/ocp, N/icp) weight
  block; the reduce runs over the icp groups only.

All modes compose with batch sharding over ``data``.

The reference runs these as ``shard_map`` bodies over global arrays.
Here every rank runs the program itself: it finds its place in the
stage's (data, ocp, icp) grid (``StageGrid``), slices its own shard of
x, w, bias and scale, and runs the local body through the op registry
(``dispatch("conv2d" | "fused_conv_block")``), so on the card the
``conv_window`` and ``fused_cwp`` kernels run at the shard's shapes.
``conv2d_channel_parallel`` and ``fused_conv_block_channel_parallel``
take the global operands and return the global result on every rank,
as the reference's global arrays are; the plan executor
(``repro_torch.graph.plan``) calls the per-shard bodies
(``conv2d_shard``, ``fused_conv_block_shard``) on operands that ``bind``
already sliced.

``ring_all_reduce`` is the Eq. 7 reduction as a point-to-point ring, the
reference's double-buffered ``ppermute`` ring: ``size - 1`` hops
(``sharding.groups.exchange``), each sending the buffer last received to
``r + 1`` and receiving from ``r - 1``, while the accumulator adds in the
reference's order (own shard, then ``r - 1``, ``r - 2``, …). On lattice
and int8 data every order gives the same bits; on fp32 data the ranks of
one ring hold copies that differ by rounding, as the reference's do.

The meshes come from ``sharding.groups.mesh_groups``: over gloo their
groups stage card tensors through host memory and count every
collective in ``COMM_STATS``; over NCCL the collectives stay on the
stream.
"""
from __future__ import annotations

import enum
import functools
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.core.quantize import conv_epilogue
from repro_torch.core.window import maxpool2

__all__ = ["ChannelParallelism", "CommStats", "COMM_STATS", "StageGrid",
           "axis_size", "check_mesh", "stage_mesh", "stage_grid",
           "ring_all_reduce", "gather_channels", "gather_batch",
           "all_reduce", "all_reduce_max", "batch_shard", "conv2d_shard",
           "fused_conv_block_shard", "conv2d_channel_parallel",
           "fused_conv_block_channel_parallel"]


class ChannelParallelism(enum.Enum):
    NONE = "none"
    OUTPUT = "output"   # paper Eq. (6): shard M, no collective
    INPUT = "input"     # paper Eq. (7): shard N, one ring reduce
    BOTH = "both"       # §III.A composed: icp × ocp sub-grid


@dataclass
class CommStats:
    """Per collective kind of a ``StagedGroup`` (``all_reduce``,
    ``all_gather``, ``reduce_scatter``, ``exchange``): calls, how many
    were staged through host memory (card tensors), bytes this rank
    sent, and host seconds spent (a staged call synchronises the card
    before and after, so its seconds cover the transfer)."""

    calls: dict = field(default_factory=dict)
    staged: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)

    def reset(self) -> None:
        for d in (self.calls, self.staged, self.bytes, self.seconds):
            d.clear()

    def add(self, kind: str, staged: bool, nbytes: int, seconds: float):
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.staged[kind] = self.staged.get(kind, 0) + int(staged)
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds


COMM_STATS = CommStats()


def axis_size(mesh, axis: str) -> int:
    """Extent of ``axis`` in ``mesh`` (1 when the mesh has no such
    axis)."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.mesh.shape[names.index(axis)]) if axis in names else 1


def check_mesh(mesh) -> tuple[str, ...]:
    """The axis names of a mesh that can host a channel-parallel plan: a
    ``DeviceMesh`` (or its shape) with a ``model`` axis; else a
    ValueError."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        raise ValueError(
            f"mesh {mesh!r} has no 'model' axis; channel parallelism "
            f"(paper §III.A) shards over 'model' and batches over 'data' "
            f"(build one with repro_torch.launch.mesh)")
    return names


def _row(mesh, axis: str) -> list[int]:
    """Global ranks along ``axis`` through this rank's coordinate."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    pos = names.index(axis)
    idx = tuple(slice(None) if k == pos else c for k, c in enumerate(coord))
    return [int(r) for r in mesh.mesh[idx].tolist()]


@functools.lru_cache(maxsize=None)
def stage_mesh(mesh, icp: int, ocp: int, model_axis: str = "model"):
    """Factor ``mesh``'s model axis into an (ocp, icp) sub-grid over the
    same ranks, with icp varying fastest, so the icp ring runs between
    model-axis neighbours. Other axes (``data``) keep their place before
    the two. Creating it creates its process groups: every rank calls it,
    in the same order (the plan does so at compile time). Cached per
    (mesh, split)."""
    from repro_torch.sharding.groups import mesh_groups
    names = list(mesh.mesh_dim_names)
    pos = names.index(model_axis)
    ranks = mesh.mesh.movedim(pos, -1)
    ranks = ranks.reshape(*ranks.shape[:-1], ocp, icp)
    new_names = [n for n in names if n != model_axis] + ["ocp", "icp"]
    return mesh_groups(ranks.shape, new_names, mesh.device_type,
                       ranks=ranks)


@dataclass(frozen=True)
class StageGrid:
    """One rank's place in a stage's (ocp, icp) split of the model axis:
    its icp and ocp coordinates ``i`` and ``o`` (model coordinate
    ``o·ki + i``), and the global ranks of its icp ring in ring order
    with the ring's process group."""

    mode: ChannelParallelism
    ki: int
    ko: int
    i: int
    o: int
    ring: tuple[int, ...]
    group: object = None

    def x_local(self, x):
        """This rank's input channels: the i-th of ki blocks of N."""
        if self.ki == 1:
            return x
        n = x.shape[1] // self.ki
        return x[:, self.i * n:(self.i + 1) * n]

    def w_block(self, w):
        """This rank's (M/ko, N/ki) weight block."""
        if w is None:
            return None
        m, n = w.shape[0] // self.ko, w.shape[1] // self.ki
        return w[self.o * m:(self.o + 1) * m,
                 self.i * n:(self.i + 1) * n].contiguous()

    def v_block(self, v):
        """This rank's slice of a per-output-channel vector (bias,
        requant scale): its M/ko channels."""
        if v is None or self.ko == 1:
            return v
        m = v.shape[0] // self.ko
        return v[self.o * m:(self.o + 1) * m].contiguous()

    @property
    def out_layout(self) -> tuple[int, int] | None:
        """How the stage's output lies over the model axis: ``(ko, ki)``
        when each rank holds output block ``r // ki`` of ``ko``, None
        when every rank holds all M channels (ICP)."""
        return (self.ko, self.ki) if self.ko > 1 else None


def _factors(mode: ChannelParallelism, msize: int, icp: int, ocp: int
             ) -> tuple[int, int]:
    if mode == ChannelParallelism.OUTPUT:
        return 1, msize
    if mode == ChannelParallelism.INPUT:
        return msize, 1
    if mode == ChannelParallelism.BOTH:
        return max(icp, 1), max(ocp, 1)
    return 1, 1


def stage_grid(mesh, mode: ChannelParallelism, ki: int, ko: int,
               model_axis: str = "model") -> StageGrid:
    """This rank's ``StageGrid`` for an (icp=ki, ocp=ko) split; builds the
    stage mesh (collectively) when the split is 2-D."""
    row = _row(mesh, model_axis)
    r = row.index(dist.get_rank())
    i, o = r % ki, r // ki
    group = None
    if ki > 1:
        group = (stage_mesh(mesh, ki, ko, model_axis).get_group("icp")
                 if ko > 1 else mesh.get_group(model_axis))
    return StageGrid(mode=mode, ki=ki, ko=ko, i=i, o=o,
                     ring=tuple(row[o * ki:(o + 1) * ki]), group=group)


def ring_all_reduce(part: torch.Tensor, ring: tuple[int, ...],
                    group=None) -> torch.Tensor:
    """Eq. 7 all-reduce as a point-to-point ring over the global ranks
    ``ring`` (in ring order; this rank among them).

    ``size - 1`` hops: each sends the buffer it last received to the next
    rank and receives the previous rank's, while the accumulator adds the
    received shard. The buffer chain and the accumulate chain are
    separate, as the reference's double-buffered ``ppermute`` ring keeps
    them, and the sum runs in its order: own shard, then ``r - 1``,
    ``r - 2``, … ``size <= 1`` returns ``part`` untouched."""
    from repro_torch.sharding.groups import exchange
    size = len(ring)
    if size <= 1:
        return part
    me = ring.index(dist.get_rank())
    nxt, prv = ring[(me + 1) % size], ring[(me - 1) % size]
    buf = part.contiguous()
    acc = part
    for _ in range(size - 1):
        dst = torch.empty_like(buf)
        exchange(buf, dst, nxt, prv, group)
        buf = dst
        acc = acc + buf
    return acc


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return parts


def gather_channels(t: torch.Tensor, mesh, layout: tuple[int, int] | None,
                    model_axis: str = "model") -> torch.Tensor:
    """All-gather a channel-sharded activation over the model axis only:
    ``layout = (ko, ki)`` means model coordinate r holds output block
    ``r // ki`` of ``ko`` (its icp copies are alike but for rounding; the
    copy at icp coordinate 0 is the value, as in the reference).
    ``layout=None`` is already whole."""
    if layout is None:
        return t
    ko, ki = layout
    parts = _all_gather(t, mesh.get_group(model_axis))
    return torch.cat([parts[o * ki] for o in range(ko)], dim=1)


def gather_batch(t: torch.Tensor, mesh, data_axis: str = "data"
                 ) -> torch.Tensor:
    """All-gather the data-axis batch slices into the whole batch."""
    if axis_size(mesh, data_axis) == 1:
        return t
    return torch.cat(_all_gather(t, mesh.get_group(data_axis)), dim=0)


def all_reduce(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM,
               dims=None) -> torch.Tensor:
    """``t`` reduced by ``op`` in place over the mesh dims ``dims`` (every
    dim when None), one axis group after another; size-1 dims are
    skipped. Returns ``t``."""
    for i in sorted(range(mesh.ndim) if dims is None else dims):
        if mesh.mesh.shape[i] > 1:
            dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


def all_reduce_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """Max of ``t`` over every rank of ``mesh`` (a per-tensor int8 scale
    over an activation whose shards or batch slices lie on several
    ranks). Max is exact, so the result equals the unsharded one."""
    return all_reduce(t.clone(), mesh, dist.ReduceOp.MAX)


def batch_shard(mesh, batch: int, data_axis: str = "data"
                ) -> tuple[int, int] | None:
    """The (start, stop) rows of this rank's data-axis slice of a
    ``batch``-row input, or None when the mesh has no data axis of more
    than one rank or the batch does not divide it (the batch then stays
    replicated, as in the reference)."""
    if mesh is None:
        return None
    d = axis_size(mesh, data_axis)
    if d == 1 or batch % d:
        return None
    k = batch // d
    c = mesh.get_local_rank(data_axis)
    return c * k, (c + 1) * k


def _validate(x_shape, w_shape, mesh, mode: ChannelParallelism,
              model_axis: str, data_axis: str | None,
              icp: int = 0, ocp: int = 0) -> str | None:
    """Static shape and mesh checks with the reference's messages.
    Returns the resolved batch axis (``data_axis`` or None)."""
    if len(x_shape) != 4 or len(w_shape) != 4 or x_shape[1] != w_shape[1]:
        raise ValueError(
            f"channel-parallel conv needs x (B,N,H,W) and w (M,N,Kh,Kw) "
            f"with matching N; got x {tuple(x_shape)}, w {tuple(w_shape)}")
    names = tuple(mesh.mesh_dim_names)
    shape = {n: axis_size(mesh, n) for n in names}
    if model_axis not in names:
        raise ValueError(f"mesh {shape} has no {model_axis!r} axis")
    msize = shape[model_axis]
    m, n = w_shape[0], w_shape[1]
    if mode == ChannelParallelism.OUTPUT and m % msize:
        raise ValueError(
            f"OUTPUT-channel parallelism (paper Eq. 6) shards the M={m} "
            f"output channels over {model_axis}={msize} devices, but "
            f"{m} % {msize} != 0; pick a divisible channel count, a "
            f"smaller mesh, or INPUT mode")
    if mode == ChannelParallelism.INPUT and n % msize:
        raise ValueError(
            f"INPUT-channel parallelism (paper Eq. 7) shards the N={n} "
            f"input channels over {model_axis}={msize} devices, but "
            f"{n} % {msize} != 0; pick a divisible channel count, a "
            f"smaller mesh, or OUTPUT mode")
    if mode == ChannelParallelism.BOTH:
        ki, ko = max(icp, 1), max(ocp, 1)
        if ki * ko != msize:
            raise ValueError(
                f"BOTH-channel parallelism factors the {model_axis!r} "
                f"axis ({msize} devices) into icp×ocp, but "
                f"{ki}×{ko} = {ki * ko} != {msize}")
        if n % ki:
            raise ValueError(
                f"BOTH-channel parallelism (paper Eq. 7 side) shards the "
                f"N={n} input channels over icp={ki} groups, but "
                f"{n} % {ki} != 0; pick divisible factors")
        if m % ko:
            raise ValueError(
                f"BOTH-channel parallelism (paper Eq. 6 side) shards the "
                f"M={m} output channels over ocp={ko} groups, but "
                f"{m} % {ko} != 0; pick divisible factors")
    batch_axis = data_axis if data_axis in names else None
    if batch_axis is not None:
        dsize = shape[batch_axis]
        if x_shape[0] % dsize:
            raise ValueError(
                f"batch {x_shape[0]} does not divide the {batch_axis!r} "
                f"axis ({dsize} devices); pad the batch or pass "
                f"data_axis=None to replicate it")
    return batch_axis


def _conv(x, w, b, stride, policy):
    """Per-shard conv through the op registry (imported here: the ops
    package imports core)."""
    from repro_torch.ops.registry import dispatch
    return dispatch("conv2d", x, w, b, stride=stride, policy=policy)


def conv2d_shard(xl, wl, bl, sl, *, grid: StageGrid,
                 stride=(1, 1), policy=None) -> torch.Tensor:
    """One rank's conv2d of a placed stage on its shard operands. OCP:
    the whole stage per M-shard, epilogue included. ICP/BOTH: the
    partial conv, the icp ring, then scale and bias once."""
    stride = tuple(stride)
    if grid.ki == 1:
        if sl is not None:
            return conv_epilogue(_conv(xl, wl, None, stride, policy),
                                 sl, bl)
        return _conv(xl, wl, bl, stride, policy)
    part = _conv(xl, wl, None, stride, policy)
    return conv_epilogue(ring_all_reduce(part, grid.ring, grid.group),
                         sl, bl)


def fused_conv_block_shard(xl, wl, bl, sl, *, grid: StageGrid,
                           stride=(1, 1), odd: str = "raise",
                           policy=None) -> torch.Tensor:
    """One rank's fused conv+requant+bias+relu+pool stage. OCP runs the
    whole fused stage per M-shard (the ``fused_cwp`` kernel on the card).
    ICP/BOTH cannot: relu and pool do not commute with the sum over
    input channels, so the conv produces partials, the ring completes
    the accumulation, and the epilogue (scale → bias → relu → 2×2/2
    pool) runs on the reduced result."""
    from repro_torch.ops.registry import dispatch
    stride = tuple(stride)
    if grid.ki == 1:
        return dispatch("fused_conv_block", xl, wl, bl, stride=stride,
                        odd=odd, scale=sl, policy=policy)
    part = _conv(xl, wl, None, stride, policy)
    full = ring_all_reduce(part, grid.ring, grid.group)
    return maxpool2(torch.relu(conv_epilogue(full, sl, bl)), odd=odd)


def _run_global(body, x, w, b, scale, *, mesh, mode, model_axis,
                data_axis, icp, ocp, **kw):
    """Slice the global operands to this rank's shard, run ``body`` and
    gather the global result (channels over model, batch over data)."""
    batch_axis = _validate(x.shape, w.shape, mesh, mode, model_axis,
                           data_axis, icp, ocp)
    ki, ko = _factors(mode, axis_size(mesh, model_axis), icp, ocp)
    grid = stage_grid(mesh, mode, ki, ko, model_axis)
    rows = (None if batch_axis is None else
            batch_shard(mesh, x.shape[0], batch_axis))
    if rows is not None:
        x = x[rows[0]:rows[1]]
    out = body(grid.x_local(x), grid.w_block(w), grid.v_block(b),
               grid.v_block(scale), grid=grid, **kw)
    out = gather_channels(out, mesh, grid.out_layout, model_axis)
    return out if rows is None else gather_batch(out, mesh, batch_axis)


def conv2d_channel_parallel(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    *,
    mesh,
    mode: ChannelParallelism,
    stride: tuple[int, int] = (1, 1),
    scale: torch.Tensor | None = None,
    model_axis: str = "model",
    data_axis: str | None = "data",
    icp: int = 0,
    ocp: int = 0,
    policy=None,
) -> torch.Tensor:
    """Distributed conv2d under the selected channel-parallel schedule.

    x: (B, N, H, W), w: (M, N, Kh, Kw), b: (M,)|None, the global
    operands on every rank -> the global (B, M, Ho, Wo) on every rank.
    The batch is sharded over ``data_axis`` when the mesh has it;
    channels per ``mode``. ``scale`` (M,) is the int8 requant factor
    (codes in, dequantized out); under INPUT/BOTH it applies after the
    ring, with the bias, once. ``icp``/``ocp`` factor the model axis for
    BOTH (ignored otherwise)."""
    stride = tuple(stride)
    if mode == ChannelParallelism.NONE:
        if scale is not None:
            return conv_epilogue(_conv(x, w, None, stride, policy),
                                 scale, b)
        return _conv(x, w, b, stride, policy)
    return _run_global(conv2d_shard, x, w, b, scale, mesh=mesh, mode=mode,
                       model_axis=model_axis, data_axis=data_axis,
                       icp=icp, ocp=ocp, stride=stride, policy=policy)


def fused_conv_block_channel_parallel(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    *,
    mesh,
    mode: ChannelParallelism,
    stride: tuple[int, int] = (1, 1),
    odd: str = "raise",
    scale: torch.Tensor | None = None,
    model_axis: str = "model",
    data_axis: str | None = "data",
    icp: int = 0,
    ocp: int = 0,
    policy=None,
) -> torch.Tensor:
    """The fused conv+requant+bias+relu+pool stage, channel-parallel:
    x: (B, N, H, W), w: (M, N, Kh, Kw) -> (B, M, Ho/2, Wo/2), global
    operands in and the global result out on every rank (see
    ``fused_conv_block_shard`` for what runs per shard)."""
    from repro_torch.ops.registry import dispatch
    stride = tuple(stride)
    if mode == ChannelParallelism.NONE:
        return dispatch("fused_conv_block", x, w, b, stride=stride, odd=odd,
                        scale=scale, policy=policy)
    return _run_global(fused_conv_block_shard, x, w, b, scale, mesh=mesh,
                       mode=mode, model_axis=model_axis,
                       data_axis=data_axis, icp=icp, ocp=ocp,
                       stride=stride, odd=odd, policy=policy)
