"""Content fingerprints for compiled plans (DESIGN.md §12).

Port of ``repro.artifact.fingerprint``. A plan artifact is only safe to
reuse if everything that shaped the program is part of its identity. The
fingerprint is a sha256 over a canonical JSON document covering

  * the compiled graph IR (fusion, quantization lowering and each
    stage's ``SpatialTiling``, its budget included —
    ``ir_codec.graph_to_doc``),
  * the baked quantization mode + ``QFormat`` lattice,
  * the ExecPolicy essentials (compile and bind policy: backend, quant,
    tiling overrides, channel_parallel, autotune),
  * the mesh shape (``mesh_shape_doc``: axis names and sizes, no ranks),
  * the bind-time tuned tiles (``BoundPlan.tuned``),
  * the weight content (a digest over every params leaf: path, dtype,
    shape, raw bytes),
  * the build: the plan semantics version, the torch and CUDA versions,
    the compute capability of the device the params live on (``"cpu"``
    there), and the digest of the kernel sources in ``csrc/``
    (``kernels.build.source_digest``).

Changing any of these — retrained weights, another quant mode, new tuned
tiles, another card, an edited kernel — yields a distinct fingerprint, so
a replica never silently serves a stale artifact. The document is
deterministic (sorted keys, integer ids from the tracer's creation
order, no floats), so the same model + policy fingerprints identically
across processes.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from repro_torch.artifact.ir_codec import graph_to_doc
from repro_torch.core.quantize import QFormat
from repro_torch.kernels.build import source_digest
from repro_torch.ops.policy import ExecPolicy

__all__ = ["SCHEMA_VERSION", "REPRO_PLAN_VERSION", "flatten_params",
           "params_digest", "params_device", "device_doc", "policy_to_doc",
           "policy_from_doc", "mesh_shape_doc", "fingerprint_doc",
           "plan_fingerprint"]

# version of the on-disk artifact schema (manifest layout + payload
# naming); loaders refuse other versions and the caller compiles fresh
SCHEMA_VERSION = 1

# version of the semantics a plan encodes (executor calling conventions,
# pass meanings): part of the fingerprint
REPRO_PLAN_VERSION = 1


def flatten_params(params, prefix: str = "") -> dict[str, torch.Tensor]:
    """{"conv1/w": tensor, ...} of a nested dict of tensors; raises
    ``TypeError`` on a key that is not a string or a leaf that is not a
    tensor (the store keys payloads by these paths)."""
    if isinstance(params, torch.Tensor):
        return {prefix: params}
    if not isinstance(params, dict):
        raise TypeError(f"params leaf {prefix or '<root>'!r} is "
                        f"{type(params).__name__}; plan artifacts need a "
                        f"dict of tensors")
    flat = {}
    for k, v in params.items():
        if not isinstance(k, str) or "/" in k:
            raise TypeError(f"params key {k!r} under {prefix or '<root>'!r}"
                            f" is not a '/'-free string")
        flat.update(flatten_params(v, f"{prefix}/{k}" if prefix else k))
    return flat


def params_digest(params) -> str:
    """sha256 over every leaf of a params dict: key path, dtype, shape,
    raw bytes — sorted by path so dict ordering never leaks in."""
    h = hashlib.sha256()
    for key, leaf in sorted(flatten_params(params).items()):
        arr = leaf.detach().cpu().contiguous().numpy()
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def params_device(params) -> torch.device | None:
    """The device of the first params leaf (None without one)."""
    for leaf in flatten_params(params).values():
        return leaf.device
    return None


def device_doc(device: torch.device | None):
    """``"cpu"``, or the compute capability of a CUDA device: tuned tiles
    and built kernels belong to one card generation."""
    if device is None or device.type == "cpu":
        return None if device is None else "cpu"
    major, minor = torch.cuda.get_device_capability(device)
    return f"sm_{major}{minor}"


def policy_to_doc(policy: ExecPolicy | None) -> dict | None:
    if policy is None:
        return None
    return {
        "backend": policy.backend,
        "quant": policy.quant,
        "qformat": [policy.qformat.int_bits, policy.qformat.frac_bits],
        "tiling": [[k, int(v)] for k, v in policy.tiling],
        "channel_parallel": policy.channel_parallel,
        "autotune": bool(policy.autotune),
    }


def policy_from_doc(doc: dict | None) -> ExecPolicy | None:
    if doc is None:
        return None
    return ExecPolicy(
        backend=doc["backend"], quant=doc["quant"],
        qformat=QFormat(*doc["qformat"]),
        tiling=tuple((k, int(v)) for k, v in doc["tiling"]),
        channel_parallel=doc.get("channel_parallel"),
        autotune=bool(doc["autotune"]))


def mesh_shape_doc(mesh) -> list | None:
    """Mesh identity = (axis name, size) pairs in axis order. Ranks are
    deliberately not part of it: an artifact restores onto any group of
    processes of that shape."""
    if mesh is None:
        return None
    return [[name, int(size)] for name, size in
            zip(mesh.mesh_dim_names, mesh.mesh.shape)]


def fingerprint_doc(plan, *, params=None, tuned=None,
                    bind_policy=None) -> dict:
    """The canonical identity document for one (optionally bound) plan."""
    return {
        "repro_plan_version": REPRO_PLAN_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "kernels": source_digest(),
        "device": None if params is None
        else device_doc(params_device(params)),
        "graph": graph_to_doc(plan.graph),
        "quant": plan.quant,
        "qformat": [plan.qformat.int_bits, plan.qformat.frac_bits],
        "compile_policy": policy_to_doc(plan.compile_policy),
        "bind_policy": policy_to_doc(bind_policy),
        "mesh": mesh_shape_doc(plan.mesh),
        "tuned": {str(int(k)): {kk: int(vv) for kk, vv in sorted(v.items())}
                  for k, v in sorted((tuned or {}).items())},
        "params_digest": None if params is None else params_digest(params),
    }


def plan_fingerprint(plan, *, params=None, tuned=None,
                     bind_policy=None) -> str:
    """sha256 hex of the canonical identity document. Works on an
    ``ExecutionPlan`` (pass ``params``/``tuned`` explicitly) or via
    ``BoundPlan.fingerprint()``, which supplies its own."""
    doc = fingerprint_doc(plan, params=params, tuned=tuned,
                          bind_policy=bind_policy)
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()
