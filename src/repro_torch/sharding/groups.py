"""Process groups for device meshes, host-staged where the backend is
gloo.

Every mesh of the port is built here (``mesh_groups``; ``launch/mesh.py``
builds through it): the LMs' DTensor meshes and the CNN's
channel-parallel meshes alike. DTensor runs its collectives through the
mesh's process groups (``all_gather_into_tensor``, ``all_reduce``,
``reduce_scatter_tensor``), ``core/parallelism.py`` through
``dist.all_gather``, ``dist.all_reduce`` and the ring's ``exchange``.
gloo takes CPU tensors: several ranks sharing one card run gloo, and a
gloo collective handed card tensors crashes the rank (a SIGSEGV with
torch 2.11 on an H100). ``StagedGroup`` is a ``ProcessGroup`` whose
collectives copy card tensors to host memory, run gloo there and copy
the result back; CPU tensors go straight through. Every call is counted
in ``core.parallelism.COMM_STATS`` under its kind (``all_reduce``,
``all_gather``, ``reduce_scatter``, ``exchange``): calls, how many were
staged, bytes this rank sent, and host seconds (a staged call
synchronises the card before and after, so its seconds cover the copies
and the transfer).

``mesh_groups(shape, axes, device, backend, ranks)`` builds a
``DeviceMesh`` over ``ranks`` (the first prod(shape) ranks of the
running world by default): over gloo its groups are ``StagedGroup``s,
over NCCL the plain ``DeviceMesh`` groups (NCCL takes card tensors and
keeps its collectives on the stream), and over torch's ``fake`` backend
(a world of hundreds of ranks in one process, whose collectives move
nothing) the plain groups too: the mesh dry run's meshes
(``launch/dryrun.py``), whose collectives are counted by
``launch/op_stats.py`` as ``StagedGroup`` counts them here.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.parallelism import COMM_STATS

__all__ = ["StagedGroup", "mesh_groups", "exchange"]

_BACKEND = "staged_gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if t.is_cuda else t


def _back(dst: torch.Tensor, src: torch.Tensor) -> None:
    if dst.data_ptr() != src.data_ptr():
        dst.copy_(src)


def _make_work_class():
    from torch._C._distributed_c10d import Work

    class Done(Work):
        """A finished collective: the staged call has already waited."""

        def __init__(self, result):
            super().__init__()
            self._fut = torch.futures.Future()
            self._fut.set_result(result)

        def wait(self, timeout=None) -> bool:
            return True

        def is_completed(self) -> bool:
            return True

        def get_future(self):
            return self._fut

    return Done


class StagedGroup(dist.ProcessGroup):
    """A gloo group whose collectives take card tensors through host
    memory (see the module docstring). Created by ``dist.new_group(...,
    backend="staged_gloo")``; the inner gloo backend is also the group's
    registered CPU backend, which names the group."""

    _done = None

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        from torch._C._distributed_c10d import PrefixStore, ProcessGroupGloo
        self.inner = ProcessGroupGloo(PrefixStore("staged", store), rank,
                                      size, timeout)
        self._register_backend(torch.device("cpu"),
                               dist.ProcessGroup.BackendType.CUSTOM,
                               self.inner)
        if StagedGroup._done is None:
            StagedGroup._done = _make_work_class()

    def getBackendName(self) -> str:
        return _BACKEND

    # ---- bookkeeping ----
    def _run(self, kind: str, tensors, body):
        staged = any(t.is_cuda for t in tensors)
        if staged:
            torch.cuda.synchronize(tensors[0].device)
        t0 = time.perf_counter()
        body()
        if staged:
            torch.cuda.synchronize(tensors[0].device)
        COMM_STATS.add(kind, staged,
                       sum(t.numel() * t.element_size() for t in tensors),
                       time.perf_counter() - t0)

    # ---- the collectives DTensor runs, under each name the C++ side
    # looks them up by ----
    def allreduce(self, tensors, opts=None):
        from torch._C._distributed_c10d import AllreduceOptions
        opts = opts if opts is not None else AllreduceOptions()

        def body():
            for t in tensors:
                h = _host(t)
                self.inner.allreduce([h], opts).wait()
                _back(t, h)

        self._run("all_reduce", tensors, body)
        return self._done(tensors)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        def body():
            for out, inp in zip(outputs, inputs):
                h = torch.empty((self.size(),) + tuple(inp.shape),
                                dtype=inp.dtype)
                self.inner.allgather([list(h.unbind(0))],
                                     [_host(inp)]).wait()
                out.copy_(h.reshape(out.shape))

        self._run("all_gather", inputs, body)
        return self._done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        """The sum over the group of each input, this rank's dim-0 block
        kept: an all-reduce, then the block (exact for integers; for
        floats the sum order is gloo's all-reduce order)."""
        from torch._C._distributed_c10d import AllreduceOptions
        o = AllreduceOptions()
        if opts is not None:
            o.reduceOp = opts.reduceOp

        def body():
            for out, inp in zip(outputs, inputs):
                h = inp.cpu() if inp.is_cuda else inp.clone()
                self.inner.allreduce([h], o).wait()
                k = h.shape[0] // self.size()
                r = self.rank()
                out.copy_(h[r * k:(r + 1) * k].reshape(out.shape))

        self._run("reduce_scatter", inputs, body)
        return self._done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def allgather(self, output_tensors, input_tensors, opts=None):
        """``dist.all_gather``'s list form: every rank's input into the
        output list, in group rank order."""
        def body():
            for outs, inp in zip(output_tensors, input_tensors):
                h_outs = outs if not inp.is_cuda else [
                    torch.empty(o.shape, dtype=o.dtype) for o in outs]
                self.inner.allgather([h_outs], [_host(inp)]).wait()
                for o, h in zip(outs, h_outs):
                    _back(o, h)

        self._run("all_gather", input_tensors, body)
        return self._done(output_tensors)

    def exchange(self, src: torch.Tensor, dst: torch.Tensor, nxt: int,
                 prv: int) -> None:
        """One ring hop: ``src`` sent to group rank ``nxt`` while ``dst``
        is received from group rank ``prv``."""
        def body():
            h_dst = _host(dst) if not dst.is_cuda else torch.empty(
                dst.shape, dtype=dst.dtype)
            works = [self.inner.send([_host(src).contiguous()], nxt, 0),
                     self.inner.recv([h_dst], prv, 0)]
            for w in works:
                w.wait()
            _back(dst, h_dst)

        self._run("exchange", [src], body)

    def barrier(self, opts=None):
        self.inner.barrier().wait()
        return self._done([])


def _register() -> None:
    if _BACKEND.upper() in dist.Backend._plugins:
        return
    dist.Backend.register_backend(
        _BACKEND, lambda store, rank, size, timeout:
        StagedGroup(store, rank, size, timeout), devices=["cpu", "cuda"])


def mesh_groups(shape, axes, device, backend: str | None = None,
                ranks=None):
    """A ``DeviceMesh`` of ``shape`` (axes ``axes``) over ``ranks`` (global
    ranks laid out as ``shape``; the first prod(shape) ranks of the world
    by default). Over gloo (the world's backend, or ``backend``) every
    axis group is a ``StagedGroup``; over NCCL the plain ``DeviceMesh``.
    Every rank of the world calls it, in the same order: it creates every
    axis group of the mesh. A rank outside the mesh gets None. Over the
    ``fake`` backend the one process is rank 0 of a world it only
    pretends to: the plain ``DeviceMesh``, nothing staged."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    dev_type = torch.device(device).type
    if ranks is None:
        ranks = torch.arange(int(np.prod(shape)), dtype=torch.int)
    ranks = torch.as_tensor(ranks, dtype=torch.int).reshape(shape)
    backend = backend or dist.get_backend()
    if backend != "gloo":       # NCCL, or the dry run's fake: no staging
        return DeviceMesh(dev_type, ranks, mesh_dim_names=axes)
    _register()
    me = dist.get_rank()
    groups = []
    for dim in range(len(shape)):
        rows = ranks.movedim(dim, -1).reshape(-1, shape[dim]).tolist()
        mine = None
        for row in rows:
            g = dist.new_group(row, backend=_BACKEND)
            if me in row:
                mine = g
        groups.append(mine)
    if me not in ranks.flatten().tolist():
        return None
    return DeviceMesh.from_group(groups, dev_type, mesh=ranks,
                                 mesh_dim_names=axes)


def exchange(src: torch.Tensor, dst: torch.Tensor, nxt: int, prv: int,
             group=None) -> None:
    """One hop of a point-to-point ring in ``group`` (the world when
    None): send ``src`` to global rank ``nxt`` while receiving ``dst``
    from global rank ``prv``. A ``StagedGroup`` stages card tensors
    through host memory; other groups (NCCL's, or gloo's on the CPU) run
    one ``batch_isend_irecv``, whose pair NCCL needs to avoid a send
    blocking on its peer's."""
    if isinstance(group, StagedGroup):
        group.exchange(src, dst, dist.get_group_rank(group, nxt),
                       dist.get_group_rank(group, prv))
        return
    ops = [dist.P2POp(dist.isend, src, nxt, group),
           dist.P2POp(dist.irecv, dst, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
