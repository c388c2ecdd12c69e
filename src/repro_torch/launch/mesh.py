"""Device meshes over ``torch.distributed`` and the SPMD spawn helper.

Port of ``repro.launch.mesh`` and of ``build_mesh``
(``repro.launch.train``). A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose axes are named as the
reference's: ``("data", "model")``, or ``("model",)`` alone. Every rank
runs the same program (SPMD) and builds the same mesh; creating one
creates its process groups, which every rank must do together, in the
same order.

The backend is explicit. NCCL needs a card of its own for every rank
(it refuses two ranks on one GPU), so ``backend=None`` resolves to NCCL
only when each rank has its own card, and raises otherwise: a world of
several ranks sharing one card, or a CPU world, runs only when the
caller names ``backend="gloo"``. Nothing chooses gloo quietly.

Defined as functions (never module-level meshes): importing this module
touches no process group.

``run_spmd(fn, world, backend, device, *args)`` spawns ``world`` ranks
with ``torch.multiprocessing``, joins them over a ``file://`` rendezvous
in a temporary directory (no TCP port, so concurrent test workers never
collide), runs ``fn(rank, world, *args)`` on each and returns every
rank's result to the caller, in rank order. ``fn`` must be importable by
name (a module-level function), since the ranks start from a fresh
interpreter.
"""
from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["MESH_AXES", "make_mesh_shape", "make_production_mesh",
           "make_test_mesh", "build_mesh", "resolve_backend",
           "init_process_group", "run_spmd"]

MESH_AXES = ("data", "model")


def make_mesh_shape(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else MESH_AXES
    return shape, axes


def _device_type(device) -> str:
    return "cpu" if device is None else torch.device(device).type


def _mesh(shape, axes, device=None):
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(shape))
    ranks = torch.arange(n, dtype=torch.int).reshape(shape)
    return DeviceMesh(_device_type(device), ranks,
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: (data=16, model=16) over the
    first 256 ranks. Multi-pod is the LM half of ROADMAP §A.10."""
    if multi_pod:
        raise NotImplementedError(
            "the multi-pod mesh is not ported yet (ROADMAP §A.10, the "
            "LM half)")
    shape, axes = make_mesh_shape()
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} — launch "
            f"{n} ranks (torchrun) before building the production mesh")
    return _mesh(shape, axes, device)


def make_test_mesh(shape=(2, 2), axes=MESH_AXES, device=None):
    """A small mesh over the first prod(shape) ranks of the running
    world."""
    return _mesh(tuple(shape), tuple(axes), device)


def resolve_backend(backend: str | None, world: int, device) -> str:
    """The process-group backend for ``world`` ranks on ``device``:
    ``backend`` when named (NCCL checked against the card count), NCCL
    when every rank has a card of its own, else a ValueError."""
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if backend is None:
        if dev.type == "cuda" and cards >= world:
            return "nccl"
        raise ValueError(
            f"{world} rank(s) on {dev.type} with {cards} card(s): NCCL "
            f"needs a card per rank; name backend='gloo' to run the "
            f"ranks over gloo (several ranks may then share one card)")
    if backend == "nccl" and (dev.type != "cuda" or cards < world):
        raise ValueError(
            f"backend 'nccl' needs a card per rank: {world} rank(s), "
            f"{cards} card(s) on {dev.type}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; expected nccl or "
                         f"gloo")
    return backend


def init_process_group(backend: str | None, device) -> None:
    """Join the default process group: from the launcher's environment
    (``torchrun`` sets ``WORLD_SIZE``/``RANK``/``MASTER_ADDR``), else as
    a world of one over a file store. No-op when already joined."""
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    backend = resolve_backend(backend, world, device)
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        fd, path = tempfile.mkstemp(prefix="repro_torch_pg_")
        os.close(fd)
        os.unlink(path)
        dist.init_process_group(backend, init_method=f"file://{path}",
                                rank=0, world_size=1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(_local_card(backend))


def _local_card(backend: str) -> int:
    """NCCL ranks take a card each; gloo ranks share the first."""
    if backend != "nccl":
        return 0
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def build_mesh(spec: str, backend: str | None = None, device="cuda"):
    """``spec``: ``"auto"`` (1 × world), ``"1"`` (one rank, a ``model``
    axis of 1) or ``"DxM"`` (data × model). Joins the process group
    first (``init_process_group``). A three-axis spec is the multi-pod
    mesh, ROADMAP §A.10's LM half, and raises."""
    init_process_group(backend, device)
    world = dist.get_world_size()
    if spec == "auto":
        return _mesh((1, world), MESH_AXES, device)
    shape = tuple(int(x) for x in spec.split("x"))
    if len(shape) > 2:
        raise NotImplementedError(
            f"mesh {spec!r}: the multi-pod mesh is not ported yet "
            f"(ROADMAP §A.10, the LM half)")
    axes = MESH_AXES[-len(shape):]
    if int(np.prod(shape)) > world:
        raise ValueError(f"mesh {spec!r} needs {int(np.prod(shape))} "
                         f"ranks; the world has {world}")
    return _mesh(shape, axes, device)


def _spmd_entry(rank: int, fn, world: int, backend: str, device: str,
                rendezvous: str, out_dir: str, args: tuple) -> None:
    """One spawned rank: join the group, pin the card, run, save."""
    dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank if backend == "nccl" else 0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    except BaseException:
        dist.destroy_process_group()
        raise
    # Leave without tearing the groups down: gloo's teardown of a world
    # with subgroups and point-to-point traffic aborts now and then
    # ("terminate called without an active exception") after every rank
    # has finished; the result is written and every rank is past the
    # barrier, so nothing is lost.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_spmd(fn, world: int, backend: str | None, device: str = "cpu",
             *args, timeout: float = 300.0) -> list:
    """Spawn ``world`` ranks, each running ``fn(rank, world, *args)``,
    and return their results in rank order. Results must pickle (numpy
    arrays, not device tensors). A rank that fails fails the call; a
    group that outlives ``timeout`` seconds is killed and raises."""
    import torch.multiprocessing as mp
    backend = resolve_backend(backend, world, device)
    with tempfile.TemporaryDirectory(prefix="repro_spmd_") as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _spmd_entry, args=(fn, world, backend, str(device), rendezvous,
                               tmp, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_spmd: {world} ranks still "
                                       f"running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
