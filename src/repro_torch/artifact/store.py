"""The plan artifact store: persist compiled, bound plans (DESIGN.md §12).

Port of ``repro.artifact.store``. The expensive design work — structure,
number format, streaming placement, tile sizing — happens once, and a
replica boots by **reading**, not deriving.

On-disk artifact (a directory, written atomically via tmp + rename):

    manifest.json   schema version, content fingerprint, graph IR doc,
                    quant/QFormat, ExecPolicy docs, mesh shape, baked
                    tuned tiles,
                    tuning-cache rows for the plan's stages, params
                    digest, the build it was made by (torch and CUDA
                    versions, device, kernel-source digest)
    payloads.npz    params leaves + the bind-folded weight quantization
                    (QTensor codes/scales, qformat arrays), as numpy

``load_plan`` reconstructs a ``BoundPlan`` on the caller's device without
re-tracing, re-running passes or re-tuning, and runs ``verify_plan`` over
it. A mesh plan's payloads hold the whole weights (the fold is redone
from the params at save, since a rank keeps only its blocks); each rank
that loads it keeps its own blocks again (``_place_weights``), on the
caller's mesh or on one rebuilt from the recorded shape. On a mesh only
global rank 0 writes, and every rank waits for it. The reference also ships AOT-compiled executables; a CUDA graph
cannot be serialized, so the port captures one per bucket in-process at
boot instead (``repro_torch.artifact.aot``), from the restored plan.

Fallback ladder (every rung warns, no rung crashes the boot):

  1. hit           — plan + folded weights + baked tiles restored;
  2. artifact miss — schema version mismatch, corrupt manifest/payload,
                     fingerprint mismatch (another build, device or
                     edited payload), stale params, a failed
                     verification: ``PlanStore`` returns None and the
                     caller runs the fresh trace → fuse → place → tune
                     pipeline.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.artifact import warmup
from repro_torch.artifact.fingerprint import (SCHEMA_VERSION, device_doc,
                                              flatten_params, mesh_shape_doc,
                                              params_digest,
                                              plan_fingerprint,
                                              policy_from_doc, policy_to_doc)
from repro_torch.artifact.ir_codec import graph_from_doc, graph_to_doc
from repro_torch.core.quantize import QFormat, QTensor
from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["ArtifactError", "ArtifactStaleError", "PlanArtifact",
           "save_plan", "load_plan", "PlanStore", "MANIFEST", "PAYLOADS"]

MANIFEST = "manifest.json"
PAYLOADS = "payloads.npz"


class ArtifactError(RuntimeError):
    """Artifact unusable (corrupt, unknown schema, another build or
    device) — callers warn and fall back to the fresh compile pipeline."""


class ArtifactStaleError(ArtifactError):
    """Artifact is internally consistent but does not match the serving
    state (different weights) — reuse would silently serve stale math."""


# ---------------------------------------------------------------------------
# payload (de)flattening

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def _payload_arrays(params, folded) -> tuple[dict, dict]:
    """-> ({npz key: array}, folded-kind index {node id: kind})."""
    try:
        flat = flatten_params(params)
    except TypeError as e:
        raise ArtifactError(f"plan artifacts need a dict of tensors: "
                            f"{e}") from e
    arrays = {f"params/{k}": _np(v) for k, v in flat.items()}
    kinds: dict[str, str] = {}
    for nid, val in folded.items():
        if isinstance(val, QTensor):
            kinds[str(int(nid))] = "qtensor"
            arrays[f"folded/{int(nid)}.codes"] = _np(val.codes)
            arrays[f"folded/{int(nid)}.scale"] = _np(val.scale)
        else:
            kinds[str(int(nid))] = "array"
            arrays[f"folded/{int(nid)}.array"] = _np(val)
    return arrays, kinds


def _load_payloads(path: pathlib.Path, kinds: dict,
                   device: torch.device) -> tuple[dict, dict]:
    with np.load(path, allow_pickle=False) as data:
        raw = {k: torch.from_numpy(data[k]).to(device) for k in data.files}
    params: dict = {}
    for key, t in raw.items():
        if not key.startswith("params/"):
            continue
        node = params
        parts = key[len("params/"):].split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = t
    folded: dict = {}
    for nid_s, kind in kinds.items():
        nid = int(nid_s)
        if kind == "qtensor":
            folded[nid] = QTensor(raw[f"folded/{nid}.codes"],
                                  raw[f"folded/{nid}.scale"])
        elif kind == "array":
            folded[nid] = raw[f"folded/{nid}.array"]
        else:
            raise ArtifactError(f"unknown folded payload kind {kind!r}")
    return params, folded


# ---------------------------------------------------------------------------
# tuning-cache interop (DESIGN.md §10 ↔ §12)

def _export_stage_rows(bound) -> list[dict]:
    """The TUNING_CACHE entries covering this plan's stages, so a replica
    whose plan shares shapes with other calls resolves the measured tiles
    instead of re-tuning or falling to the heuristics."""
    from repro_torch.ops.autotune import signature_of
    from repro_torch.ops.tiling import TUNING_CACHE, platform_key
    rows, seen = [], set()
    for _, op, args, kw in bound.plan._stage_calls(bound.params,
                                                   bound.folded):
        plat = platform_key(args[0].device)
        sig = signature_of(op, args, kw)
        key = TUNING_CACHE.key(op, sig, args[0].dtype, plat)
        hit = TUNING_CACHE.get(op, sig, args[0].dtype, plat)
        if hit and key not in seen:
            seen.add(key)
            rows.append({"op": op, "shape": list(key[1]), "dtype": key[2],
                         "platform": key[3], "params": hit})
    return rows


# ---------------------------------------------------------------------------
# save

def save_plan(bound, path) -> str:
    """Persist a ``BoundPlan`` as a versioned artifact directory; returns
    the content fingerprint."""
    from repro_torch.kernels.build import source_digest
    plan = bound.plan
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # a mesh rank holds only its blocks of the placed stages: persist the
    # whole fold
    folded = (bound.folded if plan.mesh is None
              else plan._fold_constants(bound.params))
    arrays, folded_kinds = _payload_arrays(bound.params, folded)
    fp = plan_fingerprint(plan, params=bound.params, tuned=bound.tuned,
                          bind_policy=bound.policy)
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "fingerprint": fp,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": device_doc(bound.device),
        "kernels": source_digest(),
        "quant": plan.quant,
        "qformat": [plan.qformat.int_bits, plan.qformat.frac_bits],
        "compile_policy": policy_to_doc(plan.compile_policy),
        "bind_policy": policy_to_doc(bound.policy),
        "mesh": mesh_shape_doc(plan.mesh),
        "graph": graph_to_doc(plan.graph),
        "tuned": {str(int(k)): {kk: int(vv) for kk, vv in v.items()}
                  for k, v in bound.tuned.items()},
        "tuning_cache": _export_stage_rows(bound),
        "params_digest": params_digest(bound.params),
        "folded": folded_kinds,
    }
    if plan.mesh is None:
        _write(path, arrays, manifest)
        return fp
    import torch.distributed as dist
    try:
        if dist.get_rank() == 0:            # one writer; every rank waits
            _write(path, arrays, manifest)
    finally:
        dist.barrier()
    return fp


def _write(path: pathlib.Path, arrays: dict, manifest: dict) -> None:
    """Write the artifact directory atomically (tmp + rename)."""
    tmp = pathlib.Path(tempfile.mkdtemp(dir=path.parent, prefix=".tmp_"))
    try:
        with open(tmp / PAYLOADS, "wb") as f:
            np.savez(f, **arrays)
        (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1,
                                               sort_keys=True) + "\n")
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def _mesh_for(doc, mesh, device):
    """The mesh a loaded plan runs on: None for a one-device plan; else
    the caller's mesh, which must have the recorded shape, or one built
    over the running world's first ranks."""
    if doc is None:
        if mesh is not None:
            raise ArtifactError("artifact holds a one-device plan but a "
                                "mesh was given")
        return None
    if mesh is not None:
        if mesh_shape_doc(mesh) != doc:
            raise ArtifactError(f"artifact was compiled for mesh "
                                f"{dict(doc)}, the caller's mesh is "
                                f"{dict(mesh_shape_doc(mesh))}")
        return mesh
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    need = int(np.prod([size for _, size in doc]))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise ArtifactError(f"plan was compiled for mesh {dict(doc)} "
                            f"({need} ranks) but this process group has "
                            f"{have}")
    return make_test_mesh(tuple(size for _, size in doc),
                          tuple(name for name, _ in doc), device)


# ---------------------------------------------------------------------------
# load

@dataclass
class PlanArtifact:
    """A loaded artifact: the reconstructed ``BoundPlan`` and its
    manifest."""

    bound: object
    fingerprint: str
    manifest: dict
    path: pathlib.Path


def load_plan(path, *, params=None,
              device: str | torch.device = DEFAULT_DEVICE,
              mesh=None) -> PlanArtifact:
    """Reconstruct a ``BoundPlan`` on ``device`` from an artifact
    directory — no tracing, no passes, no tuning — and verify it.

    ``params``: when given (a serving replica holding its own weights),
    their digest must match the artifact's; a mismatch raises
    ``ArtifactStaleError``. The bound plan uses the artifact's own
    (identical) payload weights. ``mesh``: the ``DeviceMesh`` a mesh
    plan runs on (every rank loads together); None rebuilds one of the
    recorded shape.

    Raises ``ArtifactError`` on any corruption, schema, build or device
    mismatch, or failed verification; ``PlanStore.load`` wraps this with
    the warn-and-fall-back behaviour serving wants.
    """
    from repro_torch.analysis.verifier import (PlanVerificationError,
                                               verify_plan)
    from repro_torch.graph.plan import BoundPlan, ExecutionPlan
    from repro_torch.ops.tiling import TUNING_CACHE

    path = pathlib.Path(path)
    dev = resolve_device(device)
    with warmup.phase("artifact"):
        try:
            manifest = json.loads((path / MANIFEST).read_text())
        except FileNotFoundError as e:
            raise ArtifactError(f"no plan artifact at {path}: {e}") from e
        except json.JSONDecodeError as e:
            raise ArtifactError(
                f"plan artifact {path}: corrupt manifest ({e})") from e
        if not isinstance(manifest, dict):
            raise ArtifactError(f"plan artifact {path}: manifest is not "
                                f"an object")
        version = manifest.get("schema_version")
        if version != SCHEMA_VERSION:
            raise ArtifactError(
                f"plan artifact {path}: schema version {version!r} "
                f"(this build reads {SCHEMA_VERSION})")
        try:
            plan = ExecutionPlan(
                graph=graph_from_doc(manifest["graph"]),
                quant=manifest["quant"],
                qformat=QFormat(*manifest["qformat"]),
                compile_policy=policy_from_doc(manifest["compile_policy"]),
                mesh=_mesh_for(manifest.get("mesh"), mesh, dev))
            bind_policy = policy_from_doc(manifest["bind_policy"])
            tuned = {int(k): {kk: int(vv) for kk, vv in v.items()}
                     for k, v in manifest.get("tuned", {}).items()}
            loaded_params, folded = _load_payloads(
                path / PAYLOADS, manifest.get("folded", {}), dev)
        except ArtifactError:
            raise
        except Exception as e:
            raise ArtifactError(
                f"plan artifact {path}: malformed content "
                f"({type(e).__name__}: {e})") from e

        # integrity: the recomputed identity (this build, this device)
        # must match what was stamped
        fp = plan_fingerprint(plan, params=loaded_params, tuned=tuned,
                              bind_policy=bind_policy)
        if fp != manifest.get("fingerprint"):
            raise ArtifactError(
                f"plan artifact {path}: content fingerprint mismatch "
                f"(payloads edited, or written by another build or for "
                f"another device: it records torch "
                f"{manifest.get('torch_version')}, CUDA "
                f"{manifest.get('cuda_version')}, device "
                f"{manifest.get('device')}; here torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}, device {device_doc(dev)})")
        if params is not None and \
                params_digest(params) != manifest.get("params_digest"):
            raise ArtifactStaleError(
                f"plan artifact {path}: weights differ from the serving "
                f"params — refusing to serve a stale plan")

        # measured tiles for calls sharing these shapes: merge, never
        # overwrite fresher local measurements
        TUNING_CACHE.merge_rows(manifest.get("tuning_cache", ()),
                                keep_existing=True,
                                source=f"plan artifact {path}")
        placed = plan._place_weights(loaded_params, folded)
        bound = BoundPlan(plan=plan, params=loaded_params, folded=folded,
                          policy=bind_policy, placed=placed, tuned=tuned)
        # a manifest can pass the fingerprint check and still describe an
        # illegal plan (its producer recomputed the fingerprint): re-derive
        # every invariant before serving it
        try:
            verify_plan(bound)
        except PlanVerificationError as e:
            raise ArtifactError(
                f"plan artifact {path}: failed static verification — "
                + "; ".join(v.render() for v in e.violations)) from e
    return PlanArtifact(bound=bound, fingerprint=fp, manifest=manifest,
                        path=path)


# ---------------------------------------------------------------------------
# the store: named artifacts for serving

class PlanStore:
    """A directory of named plan artifacts (``<root>/<name>/``) with the
    warn-and-fall-back load serving wants: ``load`` returns ``None`` on
    any artifact problem (after warning), so the caller runs the fresh
    pipeline — a bad artifact can cost boot time, never availability or
    correctness."""

    def __init__(self, root):
        self.root = pathlib.Path(root)

    def path(self, name: str) -> pathlib.Path:
        return self.root / name

    def has(self, name: str) -> bool:
        return (self.path(name) / MANIFEST).exists()

    def names(self) -> list[str]:
        if not self.root.exists():
            return []
        return sorted(p.parent.name
                      for p in self.root.glob(f"*/{MANIFEST}"))

    def save(self, name: str, bound) -> str:
        return save_plan(bound, self.path(name))

    def load(self, name: str, *, params=None,
             device: str | torch.device = DEFAULT_DEVICE, mesh=None
             ) -> PlanArtifact | None:
        try:
            return load_plan(self.path(name), params=params, device=device,
                             mesh=mesh)
        except ArtifactError as e:
            warnings.warn(
                f"plan store: artifact {name!r} unusable, falling back "
                f"to fresh compile ({e})", stacklevel=2)
            return None
