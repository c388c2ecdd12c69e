"""Deterministic, checkpointable synthetic data pipelines (port of
``repro.data.pipeline``).

The data is generated, not downloaded, with the properties a production
loader must have: deterministic given (seed, step), so a restore mid-run
replays the exact stream; O(1) state ({seed, step}). Everything is drawn
with numpy's seeded generators exactly as the reference draws it, so a
batch is the reference's bitwise; batches are CPU tensors, and
``shard_batch`` puts one on the device.

``SyntheticTextIterator`` is a learnable stream (a fixed random Markov
chain over the vocab), so a falling train loss means something.
``SyntheticMNIST`` draws MNIST-like 28×28 digits (a procedural stroke per
class, jitter and noise) for the paper's CNN (Tab. I / Fig. 9).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["SyntheticTextConfig", "SyntheticTextIterator", "SyntheticMNIST",
           "shard_batch"]


@dataclass(frozen=True)
class SyntheticTextConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4      # out-degree of the Markov chain


class SyntheticTextIterator:
    """Markov-chain token stream. State = (seed, step)."""

    def __init__(self, cfg: SyntheticTextConfig, step: int = 0):
        self.cfg = cfg
        self.step = step
        rng = np.random.default_rng(cfg.seed)
        # fixed transition table: vocab × branching successors
        self._table = rng.integers(0, cfg.vocab,
                                   size=(cfg.vocab, cfg.branching),
                                   dtype=np.int32)

    def state_dict(self) -> dict:
        return {"seed": self.cfg.seed, "step": self.step}

    @classmethod
    def from_state(cls, cfg: SyntheticTextConfig, state: dict
                   ) -> "SyntheticTextIterator":
        if state["seed"] != cfg.seed:
            raise ValueError(f"seed mismatch on restore: the state has "
                             f"{state['seed']}, the config {cfg.seed}")
        return cls(cfg, step=int(state["step"]))

    def next_batch(self) -> dict:
        """{"tokens", "labels"}: (global_batch, seq_len) int32 CPU tensors,
        labels the tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.step))
        self.step += 1
        starts = rng.integers(0, cfg.vocab, size=cfg.global_batch,
                              dtype=np.int32)
        choices = rng.integers(0, cfg.branching,
                               size=(cfg.global_batch, cfg.seq_len),
                               dtype=np.int32)
        toks = np.empty((cfg.global_batch, cfg.seq_len + 1), np.int32)
        toks[:, 0] = starts
        for t in range(cfg.seq_len):
            toks[:, t + 1] = self._table[toks[:, t], choices[:, t]]
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy())}


class SyntheticMNIST:
    """Procedural MNIST-like digits: each class a fixed stroke template
    (from a seeded generator) + per-sample jitter and noise. Separable
    enough to train the paper CNN past 95% in a few hundred steps, hard
    enough that an untrained net is at chance."""

    def __init__(self, seed: int = 0, n_classes: int = 10, size: int = 28):
        self.n_classes, self.size = n_classes, size
        rng = np.random.default_rng(seed)
        self.templates = np.zeros((n_classes, size, size), np.float32)
        for c in range(n_classes):
            # random walk stroke per class
            pts = [(rng.integers(4, size - 4), rng.integers(4, size - 4))]
            for _ in range(60):
                dy, dx = rng.integers(-2, 3, size=2)
                y = int(np.clip(pts[-1][0] + dy, 1, size - 2))
                x = int(np.clip(pts[-1][1] + dx, 1, size - 2))
                pts.append((y, x))
            for y, x in pts:
                self.templates[c, y - 1:y + 2, x - 1:x + 2] += 0.5
            self.templates[c] = np.clip(self.templates[c], 0, 1)

    def batch(self, batch_size: int, step: int, seed: int = 1234) -> dict:
        """{"images": (B, 1, size, size) f32, "labels": (B,) int32}, CPU
        tensors."""
        rng = np.random.default_rng((seed, step))
        labels = rng.integers(0, self.n_classes, size=batch_size)
        imgs = self.templates[labels].copy()
        # jitter: random shift ±2 px
        for i in range(batch_size):
            dy, dx = rng.integers(-2, 3, size=2)
            imgs[i] = np.roll(np.roll(imgs[i], dy, axis=0), dx, axis=1)
        imgs += rng.normal(0, 0.15, imgs.shape).astype(np.float32)
        return {"images": torch.from_numpy(imgs[:, None, :, :].copy()),
                "labels": torch.from_numpy(labels.astype(np.int32))}


def shard_batch(batch: dict, mesh=None, batch_axes=("pod", "data"), *,
                device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Put a host batch on ``device`` (the card unless the caller names
    the CPU); with a ``mesh``, as DTensors whose batch dim is split over
    the DP axes of ``batch_axes`` present in the mesh (replicated over the
    others, and whole where the mesh has none of them). Every rank passes
    the same global batch and keeps its rows: no collective."""
    dev = resolve_device(device)
    batch = {k: v.to(dev) for k, v in batch.items()}
    if mesh is None:
        return batch
    from repro_torch.sharding.logical import NamedSharding
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in batch_axes if a in names)
    entry = axes if len(axes) > 1 else (axes[0] if axes else None)
    return {k: NamedSharding(mesh, (entry,) if entry else ()).place(v)
            for k, v in batch.items()}
