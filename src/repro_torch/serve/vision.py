"""Vision serving: bucketed micro-batch image inference over compiled plans.

Port of ``repro.serve.vision`` (DESIGN.md §8, §11). Requests are
micro-batched into a small static set of batch shapes and pushed through
the fused ``ExecutionPlan``; on the card its conv stages run the
``fused_cwp`` kernel and, under int8, its fc stage the ``qmatmul`` kernel.

``VisionEngineConfig.buckets`` keeps one bound plan per padded batch
bucket (e.g. 1/2/4/8 for ``batch=8``), and each micro-batch runs through
the smallest bucket that fits. The ladder **pre-warms at boot**
(``prewarm``, default on): every bucket runs once on zeros before any
request arrives, which builds the CUDA kernels and makes their first
launch, so no request pays either. Plans are ``bind``-ed at construction:
weight quantization is folded once.

The engine runs on ``config.device`` — the card unless the caller asks
for the CPU — and moves the params there. The reference's mesh
placement, bind-time autotuning and plan artifact store are later slices
and raise ``NotImplementedError``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

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
    # not ported yet: each raises NotImplementedError when set
    mesh: object | None = None
    autotune: bool = False
    artifact_dir: str | None = None


@dataclass
class VisionStats(ServeStats):
    """Vision view of ``ServeStats``: ``items`` counts real images served
    (``lane_steps == items``); ``pad_lanes`` counts batch-padding lanes."""

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
        if config.mesh is not None:
            raise NotImplementedError(
                "mesh-placed vision serving is not ported yet (ROADMAP "
                "§A.10, channel parallelism)")
        if config.autotune:
            raise NotImplementedError(
                "bind-time autotuning is not ported yet (ROADMAP §A.7)")
        if config.artifact_dir is not None:
            raise NotImplementedError(
                "the plan artifact store is not ported yet (ROADMAP §A.8)")
        self.model = model
        self.config = config
        self.clock = clock if clock is not None else MonotonicClock()
        self.device = resolve_device(config.device)
        self._params = _to_device(params, self.device)
        self.buckets = self._resolve_buckets(config)
        self._bounds: dict[int, object] = {}    # bucket -> BoundPlan
        self.plan = self._compile_bucket(config.batch)
        if config.prewarm:
            self.warm()
        self.stats = VisionStats()
        self._queue: deque[tuple[int, np.ndarray]] = deque()
        self.results: dict[int, dict] = {}
        self._uid = 0

    @staticmethod
    def _resolve_buckets(config: VisionEngineConfig) -> tuple[int, ...]:
        if config.buckets is None:
            return (config.batch,)
        if config.buckets == "auto":
            ladder = []
            b = 1
            while b < config.batch:
                ladder.append(b)
                b *= 2
            ladder.append(config.batch)
            return tuple(ladder)
        ladder = sorted(set(int(b) for b in config.buckets))
        if not ladder or ladder[-1] != config.batch:
            raise ValueError(
                f"buckets {config.buckets} must include the full batch "
                f"{config.batch} (it serves saturated traffic)")
        return tuple(ladder)

    def _compile_bucket(self, bucket: int):
        """Compile + bind one padded batch shape and run it once on zeros
        (builds the kernels, makes their first launch)."""
        plan = self.model.compile(policy=self.config.policy,
                                  fuse=self.config.fuse, batch=bucket)
        bound = plan.bind(self._params)
        self._bounds[bucket] = bound
        shape = (bucket, *self.model.input_shape()[1:])
        with torch.inference_mode():
            bound(torch.zeros(shape, device=self.device)).cpu()
        return plan

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
        if len(uids) < bucket:                  # pad to the bucket shape
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
