"""Vision serving: bucketed micro-batch image inference over compiled plans.

Port of ``repro.serve.vision`` (DESIGN.md §8, §11). Requests are
micro-batched into a small static set of batch shapes and pushed through
the fused ``ExecutionPlan``; on the card its conv stages run the
``fused_cwp`` kernel and, under int8, its fc stage the ``qmatmul`` kernel.

``VisionEngineConfig.buckets`` keeps one bound plan per padded batch
bucket (e.g. 1/2/4/8 for ``batch=8``), and each micro-batch runs through
the smallest bucket that fits. The ladder **pre-warms at boot**
(``prewarm``, default on): every bucket's program exists before any
request arrives. Plans are ``bind``-ed at construction: weight
quantization is folded once.

On the card each bucket is served through a **CUDA graph**
(``repro_torch.artifact.aot``), the counterpart of the reference's AOT
executable: at boot the kernels are built, the bound plan runs once and
one call is captured on a static input; a micro-batch is copied into the
bucket's static input (pad lanes zeroed), the graph replays, and the
logits are copied out of the static output before the next batch. A
capture or replay that fails raises; nothing falls back to eager
dispatch. The graphs launch kernels without their wrappers, so the
engine counts replays (``replays``) and ``graph_launches`` gives the
kernel launches they made. A CPU engine calls the bound plan directly.

``VisionEngineConfig.autotune`` compiles with ``autotune=True``: each
bucket's bind measures launch shapes (or takes them from the tuning
cache) and bakes the winners in, so traffic never re-tunes.

``VisionEngineConfig.artifact_dir`` points the ladder at a plan artifact
store (``repro_torch.artifact``): each bucket first tries
``<dir>/bucket_<b>`` — a hit restores the bound plan (weights, folded
quantization, baked tiles) with no trace/fuse/place/tune work; a stale
or corrupt artifact warns and falls back to the fresh pipeline.
``save_artifacts()`` writes the ladder out (``--save-plan``).
``plan_source`` records each bucket's rung: ``"artifact+aot"`` — the
artifact loaded and its recorded kernel build is the one already built
here, so no nvcc runs (the CPU builds nothing); ``"artifact"`` — the
artifact loaded, the kernels are built first; ``"fresh"`` — compiled.

The engine runs on ``config.device`` — the card unless the caller asks
for the CPU — and moves the params there.

``VisionEngineConfig.mesh`` (a ``DeviceMesh``, ``repro_torch.launch.mesh``)
compiles every bucket channel-parallel (DESIGN.md §9/§15) and binds its
weights shard-resident. Every rank runs the engine on the same requests
(SPMD); each bound plan takes the rank's data-axis slice of the bucket
(``ExecutionPlan._scatter``) and returns the whole bucket's logits on
every rank. ``batch`` must divide the data axis, and buckets that do not
are dropped from the ladder, as in the reference. A mesh whose
collectives run (more than one rank) serves eagerly, and ``graphs``
(also in ``pretty()`` and the stats) says ``off (<backend>)``: gloo's
collectives run on the host and cannot be captured in a CUDA graph;
NCCL's could be, but a captured ring across cards has never run (the
card runs have one H100), so a multi-card NCCL mesh stays eager, its
collectives queued on the stream without a host sync, until that is
measured (ROADMAP §A.10). A mesh of one rank captures its graphs as
without a mesh.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.artifact.warmup import phase
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.ops.policy import ExecPolicy
from repro_torch.serve.clock import Clock, MonotonicClock
from repro_torch.serve.stats import ServeStats

__all__ = ["VisionEngineConfig", "VisionStats", "VisionEngine"]


@dataclass(frozen=True)
class VisionEngineConfig:
    batch: int = 8                    # the largest served batch shape
    # None follows compile() precedence (model-config policy, then the
    # ambient use_policy); set to pin a serving policy explicitly
    policy: ExecPolicy | None = None
    fuse: bool = True                 # compile with conv-block fusion
    # None serves every micro-batch at ``batch``; "auto" keeps power-of-two
    # buckets up to ``batch``; a tuple pins the ladder (must include batch)
    buckets: tuple[int, ...] | str | None = None
    # run EVERY ladder bucket once at construction, so no request pays
    # the kernel build or a first launch
    prewarm: bool = True
    device: str = DEFAULT_DEVICE
    # measured launch shapes at bind time (DESIGN.md §10)
    autotune: bool = False
    # plan artifact store directory (DESIGN.md §12): bucket plans load from
    # ``<dir>/bucket_<b>`` when present; ``save_artifacts()`` writes them
    artifact_dir: str | None = None
    # device mesh for a channel-parallel plan (DESIGN.md §9): compile with
    # ICP/OCP placement and bind weights shard-resident; None serves on
    # one device
    mesh: object | None = None


@dataclass
class VisionStats(ServeStats):
    """Vision view of ``ServeStats``: ``items`` counts real images served
    (``lane_steps == items``); ``pad_lanes`` counts batch-padding lanes.
    ``graphs`` says how buckets run: ``on`` (a CUDA graph a bucket),
    ``off (<backend>)`` on a mesh whose collectives run, ``off (cpu)``."""

    graphs: str = ""

    @property
    def images(self) -> int:
        return self.items

    @property
    def images_per_s(self) -> float:
        return self.items_per_s


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class VisionEngine:
    """Micro-batching classifier over ``model.compile()``.

    The model exposes ``compile(policy=..., fuse=..., batch=...)`` and
    ``input_shape(batch)`` (PaperCNN does). Short batches pad to the
    smallest bucket that fits; the pad lanes are dropped on the host.
    """

    def __init__(self, model, params,
                 config: VisionEngineConfig = VisionEngineConfig(),
                 clock: Clock | None = None):
        self.model = model
        self.config = config
        self.clock = clock if clock is not None else MonotonicClock()
        self.device = resolve_device(config.device)
        self._params = _to_device(params, self.device)
        mesh = config.mesh
        self._data_div = 1
        self.graphs = "on" if self.device.type == "cuda" else "off (cpu)"
        if mesh is not None:
            import torch.distributed as dist

            from repro_torch.core.parallelism import axis_size, check_mesh
            check_mesh(mesh)
            self._data_div = axis_size(mesh, "data")
            if config.batch % self._data_div:
                raise ValueError(
                    f"batch {config.batch} does not divide the mesh's data "
                    f"axis ({self._data_div} devices); the compiled batch "
                    f"shape is sharded over it — pick a divisible batch")
            if mesh.mesh.numel() > 1 and self.device.type == "cuda":
                self.graphs = f"off ({dist.get_backend()})"
        self.buckets = self._resolve_buckets(config, self._data_div)
        self._bounds: dict[int, object] = {}    # bucket -> BoundPlan
        self._graphs: dict[int, object] = {}    # bucket -> BucketGraph
        self.replays: dict[int, int] = {}       # bucket -> graph replays
        # bucket -> "artifact+aot" | "artifact" | "fresh" (boot telemetry)
        self.plan_source: dict[int, str] = {}
        self._store = None
        if config.artifact_dir is not None:
            from repro_torch.artifact.store import PlanStore
            self._store = PlanStore(config.artifact_dir)
        self.plan = self._compile_bucket(config.batch)
        if config.prewarm:
            self.warm()
        self.stats = VisionStats(graphs=self.graphs)
        self._queue: deque[tuple[int, np.ndarray]] = deque()
        self.results: dict[int, dict] = {}
        self._uid = 0

    @staticmethod
    def _resolve_buckets(config: VisionEngineConfig,
                         data_div: int = 1) -> tuple[int, ...]:
        """The bucket ladder; on a mesh with a ``data`` axis, only the
        buckets that divide it."""
        if config.buckets is None:
            return (config.batch,)
        if config.buckets == "auto":
            ladder = []
            b = 1
            while b < config.batch:
                ladder.append(b)
                b *= 2
            ladder.append(config.batch)
        else:
            ladder = sorted(set(int(b) for b in config.buckets))
            if not ladder or ladder[-1] != config.batch:
                raise ValueError(
                    f"buckets {config.buckets} must include the full "
                    f"batch {config.batch} (it serves saturated traffic)")
        return tuple(b for b in ladder
                     if b % data_div == 0) or (config.batch,)

    @staticmethod
    def bucket_name(bucket: int) -> str:
        """Artifact name of one bucket plan inside the store."""
        return f"bucket_{bucket}"

    def _compile_bucket(self, bucket: int):
        """Produce the ready program for one padded batch shape: restore
        the bound plan from the artifact store (any problem warns and
        falls through) or compile + bind it; on the card capture its CUDA
        graph (or take the process's graph of the same plan and bucket);
        then run it once on zeros, outside any timed serving step."""
        from repro_torch.kernels.build import is_built
        shape = (bucket, *self.model.input_shape()[1:])
        bound = None
        source = "fresh"
        if self._store is not None:
            art = self._store.load(self.bucket_name(bucket),
                                   params=self._params, device=self.device,
                                   mesh=self.config.mesh)
            if art is not None:
                bound = art.bound
                source = ("artifact+aot"
                          if self.device.type != "cuda" or is_built()
                          else "artifact")
        if bound is None:
            plan = self.model.compile(policy=self.config.policy,
                                      fuse=self.config.fuse, batch=bucket,
                                      mesh=self.config.mesh,
                                      autotune=self.config.autotune)
            bound = plan.bind(self._params)
        self._bounds[bucket] = bound
        self.plan_source[bucket] = source
        zeros = torch.zeros(shape, device=self.device)
        if self.graphs == "on":
            from repro_torch.artifact.aot import (cache_graph, cached_graph,
                                                  capture_graph,
                                                  executable_key)
            key = executable_key(bound.fingerprint(), shape, self.device)
            graph = cached_graph(key)
            if graph is None:
                graph = capture_graph(bound, shape)
                cache_graph(key, graph)
            self._graphs[bucket] = graph
            with phase("first_dispatch"), torch.inference_mode():
                graph.run(zeros).cpu()
            self.replays[bucket] = 1
        else:
            with phase("first_dispatch"), torch.inference_mode():
                bound(zeros)
        return bound.plan

    def save_artifacts(self, directory=None) -> dict[str, str]:
        """Persist every compiled bucket plan into the store at
        ``directory`` (default: the configured ``artifact_dir``) — what
        ``launch/serve.py --save-plan`` calls. Returns {artifact name:
        fingerprint}."""
        from repro_torch.artifact.store import PlanStore
        if directory is not None:
            store = PlanStore(directory)
        elif self._store is not None:
            store = self._store
        else:
            raise ValueError("no artifact directory: pass one or set "
                             "VisionEngineConfig.artifact_dir")
        return {self.bucket_name(b): store.save(self.bucket_name(b), bound)
                for b, bound in sorted(self._bounds.items())}

    def graph_launches(self) -> dict[str, int]:
        """Kernel launches the engine's graph replays made: per bucket,
        the launches its graph captured × its replays (the first, at
        boot, included)."""
        out: dict[str, int] = {}
        for b, n in self.replays.items():
            for k, v in self._graphs[b].kernels.items():
                out[k] = out.get(k, 0) + v * n
        return out

    def pretty(self) -> str:
        """One line: device, mesh, buckets and how they run."""
        mesh = ""
        if self.config.mesh is not None:
            from repro_torch.artifact.fingerprint import mesh_shape_doc
            mesh = (f", mesh={dict(mesh_shape_doc(self.config.mesh))}, "
                    f"{self.plan.num_sharded()} sharded stages")
        return (f"VisionEngine(device={self.device}{mesh}, buckets="
                f"{list(self.buckets)}, graphs: {self.graphs})")

    def warm(self) -> None:
        """Make every ladder bucket's bound plan exist now."""
        for b in self.buckets:
            if b not in self._bounds:
                self._compile_bucket(b)

    def _bucket_for(self, k: int) -> int:
        for b in self.buckets:
            if b >= k:
                return b
        return self.buckets[-1]

    # ---------- request intake ----------
    def submit(self, image) -> int:
        """Queue one (C, H, W) image; returns its request id."""
        img = np.asarray(image, np.float32)
        want = self.model.input_shape()[1:]
        if img.shape != tuple(want):
            raise ValueError(f"image shape {img.shape} != model input "
                             f"{tuple(want)}")
        uid = self._uid
        self._uid += 1
        self._queue.append((uid, img))
        return uid

    # ---------- driving ----------
    def step(self) -> int:
        """Serve one bucket-shaped batch from the queue; returns how many
        real images it carried."""
        if not self._queue:
            return 0
        uids, imgs = [], []
        while self._queue and len(uids) < self.config.batch:
            uid, img = self._queue.popleft()
            uids.append(uid)
            imgs.append(img)
        bucket = self._bucket_for(len(uids))
        if bucket not in self._bounds:  # one-time, outside the timed step
            self._compile_bucket(bucket)
        t0 = self.clock.now()
        batch = np.stack(imgs)
        graph = self._graphs.get(bucket)
        if graph is not None:
            # copy in (pad lanes zeroed), replay, copy the real lanes out
            # before the next replay overwrites the static output
            with torch.inference_mode():
                logits = graph.run(torch.from_numpy(batch))[
                    :len(uids)].cpu().numpy()
            self.replays[bucket] += 1
        else:
            if len(uids) < bucket:              # pad to the bucket shape
                pad = np.zeros((bucket - len(uids), *batch.shape[1:]),
                               np.float32)
                batch = np.concatenate([batch, pad])
            with torch.inference_mode():
                logits = self._bounds[bucket](
                    torch.from_numpy(batch).to(self.device)).cpu().numpy()
        for i, uid in enumerate(uids):
            self.results[uid] = {"label": int(logits[i].argmax()),
                                 "logits": logits[i]}
        self.stats.steps += 1
        self.stats.items += len(uids)               # real images served
        self.stats.lane_steps += len(uids)          # real work only
        self.stats.pad_lanes += bucket - len(uids)  # issued, not served
        self.stats.wall_s += self.clock.now() - t0
        return len(uids)

    def run(self) -> dict[int, dict]:
        """Drain the queue; returns {uid: {"label", "logits"}}."""
        while self._queue:
            self.step()
        return self.results

    def has_work(self) -> bool:
        return bool(self._queue)
