"""Static analysis of compiled plans (DESIGN.md §14), ported from
``repro.analysis``: the plan verifier. The reference's AST lint engine
scans JAX source and is not ported (ROADMAP §A)."""
from repro_torch.analysis.verifier import (PlanVerificationError, Violation,
                                           verify_plan)

__all__ = ["Violation", "PlanVerificationError", "verify_plan"]
