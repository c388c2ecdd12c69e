"""Plan artifact store: compiled, bound plans as versioned, persistable
artifacts, and a CUDA graph per served bucket (DESIGN.md §12).

Port of ``repro.artifact``:
  warmup      — time-to-ready phase attribution (trace/fuse/place/tune/
                compile/artifact/first_dispatch), stdlib-only
  ir_codec    — graph IR ↔ canonical JSON
  fingerprint — content fingerprint (graph + quant + tiling + tiles +
                policy + weights + the build and device)
  aot         — one CUDA graph per bucket, captured in-process, cached
                per (fingerprint, shape): the reference's AOT executables
  store       — save_plan/load_plan, the PlanArtifact handle, and the
                named PlanStore serving reads from

Exports resolve lazily (PEP 562): ``repro_torch.graph.plan`` imports
``repro_torch.artifact.warmup`` for its phase hooks while ``store``
imports ``repro_torch.graph.plan`` back.
"""
from __future__ import annotations

_EXPORTS = {
    "collect_warmup": "warmup", "phase": "warmup", "WarmupReport": "warmup",
    "current_report": "warmup", "PHASES": "warmup",
    "graph_to_doc": "ir_codec", "graph_from_doc": "ir_codec",
    "plan_fingerprint": "fingerprint", "params_digest": "fingerprint",
    "SCHEMA_VERSION": "fingerprint",
    "BucketGraph": "aot", "capture_graph": "aot",
    "executable_key": "aot", "clear_graph_cache": "aot",
    "ArtifactError": "store", "ArtifactStaleError": "store",
    "PlanArtifact": "store", "PlanStore": "store",
    "save_plan": "store", "load_plan": "store",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.artifact' has no "
                             f"attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"repro_torch.artifact.{mod}"),
                   name)


def __dir__():
    return __all__
