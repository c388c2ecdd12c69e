"""Fault-tolerant checkpointing: atomic, keep-k, restore onto a named
device (port of ``repro.checkpoint.manager``).

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other bitwise: one ``.npz`` per tree, keyed by
the '/'-joined key paths in the reference's (sorted) order, a bfloat16
leaf stored as its exact fp32 upcast (``.npz`` has no bf16) and narrowed
again from the template's dtype on load; a step directory
``step_<9 digits>`` holds ``params.npz``, ``opt_state.npz`` and
``meta.json`` ({"step", "extra"}: the data iterator's state). Writes go
to a temporary file or directory that ``os.replace`` moves into place
last, so a run killed mid-write never corrupts the latest checkpoint.

On a mesh every rank calls ``save`` (DTensor leaves are joined whole,
a collective) and rank 0 writes; the others wait for it at a barrier.
The elastic restore is the reference's: ``load_pytree(..., shardings)``
and ``restore(params_shardings=, opt_shardings=)`` lay each loaded leaf
out by a ``NamedSharding`` (``repro_torch.sharding``), whatever mesh the
tree was saved from; ``device`` names the device a tree lands on.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.core.tree import tree_from_items, tree_items, tree_map
from repro_torch.sharding.logical import whole

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]

_SEP = "/"


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a running world, or a
    process outside any."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _wait_for_writer() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for path, leaf in tree_items(tree):
        t = whole(leaf.detach()).cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        flat[_key(path)] = t.numpy()
    return flat


def save_pytree(tree, path: Path) -> None:
    """Atomic save of a nested dict of tensors to ``path`` (.npz). On a
    mesh every rank calls it; rank 0 writes."""
    path = Path(path)
    flat = _flatten(tree)
    if not _writer():
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(template, path: Path,
                device: str | torch.device | None = None, shardings=None):
    """The arrays of ``path`` in the structure of ``template`` (a nested
    dict whose leaves have ``shape`` and ``dtype``: tensors, meta tensors
    and DTensors included), each cast to its template leaf's dtype, on
    ``device`` (default: the template leaf's device), then laid out by
    ``shardings`` (a tree of ``NamedSharding``s) when given: the elastic
    restore onto any mesh. A missing key or a shape that differs
    raises."""
    out = []
    with np.load(path, allow_pickle=False) as data:
        for p, leaf in tree_items(template):
            key = _key(p)
            if key not in data:
                raise KeyError(f"{path}: no array {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{path}: {key!r} has shape "
                                 f"{tuple(arr.shape)}, the template "
                                 f"{tuple(leaf.shape)}")
            dev = device if device is not None else leaf.device
            out.append((p, torch.from_numpy(arr).to(dtype=leaf.dtype,
                                                    device=dev)))
    tree = tree_from_items(out)
    if shardings is not None:
        tree = tree_map(lambda t, sh: sh.place(t), tree, shardings)
    return tree


class CheckpointManager:
    """Step-indexed checkpoints with keep-k GC and latest-step discovery."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:09d}"

    def save(self, step: int, *, params, opt_state=None,
             extra: dict | None = None) -> Path:
        """Atomic: assembled in a temporary directory, renamed into place
        last; then all but the newest ``keep`` are deleted. On a mesh
        every rank calls it (a DTensor leaf is joined whole) and rank 0
        writes."""
        final = self._step_dir(step)
        if not _writer():
            _flatten(params)
            if opt_state is not None:
                _flatten(opt_state)
            _wait_for_writer()
            return final
        tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
        try:
            save_pytree(params, tmp / "params.npz")
            if opt_state is not None:
                save_pytree(opt_state, tmp / "opt_state.npz")
            meta = {"step": step, "extra": extra or {}}
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)
        self._gc()
        _wait_for_writer()
        return final

    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                      if p.is_dir() and p.name.startswith("step_"))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, *, params_template, opt_template=None,
                step: int | None = None,
                device: str | torch.device | None = None,
                params_shardings=None, opt_shardings=None):
        """Returns (step, params, opt_state or None, extra); the latest
        step unless ``step`` is given. Elastic: the shardings may lay the
        trees out on another mesh than the one they were saved from."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        meta = json.loads((d / "meta.json").read_text())
        params = load_pytree(params_template, d / "params.npz", device,
                             params_shardings)
        opt = None
        if opt_template is not None and (d / "opt_state.npz").exists():
            opt = load_pytree(opt_template, d / "opt_state.npz", device,
                              opt_shardings)
        return step, params, opt, meta.get("extra", {})

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
