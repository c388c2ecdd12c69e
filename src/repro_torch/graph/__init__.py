"""The fusion graph compiler (DESIGN.md §8), ported from ``repro.graph``:
typed IR, tracer, passes and the single-device ExecutionPlan."""
from repro_torch.graph.plan import BoundPlan, ExecutionPlan, compile_model

__all__ = ["ExecutionPlan", "BoundPlan", "compile_model"]
