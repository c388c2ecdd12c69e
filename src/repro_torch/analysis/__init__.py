"""Static analysis (DESIGN.md §14), ported from ``repro.analysis``: the
AST lint engine over the port's own source and the compile-time plan
verifier.

  * ``repro_torch.analysis.rules`` / ``engine`` — named AST rules over
    ``src/repro_torch`` and ``chip_smoke.py``: the reference's rules that
    read any Python, counterparts of its dispatch rules, and the port's
    standing rules (no JAX import, no ``torch.topk`` routing, no
    division by a host scalar, sorted tree walks, no TF32, no module
    seams). Findings carry path:line, rule id, severity, message and a
    suggested fix; per-line ``# lint: disable=<rule>`` suppresses;
    ``--json`` emits machine-readable output.

  * ``repro_torch.analysis.verifier`` — ``verify_plan(plan_or_bound)``
    statically re-derives and checks every stage of a compiled plan
    before any dispatch, rejecting a malformed one with named violations.

``python -m repro_torch.analysis`` runs both over the tree.
"""
from repro_torch.analysis.engine import (DEFAULT_SCAN_DIRS, LintEngine,
                                         findings_to_json, format_findings,
                                         lint_tree)
from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.rules import Rule, all_rules, rule_by_id
from repro_torch.analysis.verifier import (PlanVerificationError, Violation,
                                           verify_plan)

__all__ = ["Finding", "Severity", "Rule", "all_rules", "rule_by_id",
           "LintEngine", "lint_tree", "format_findings", "findings_to_json",
           "DEFAULT_SCAN_DIRS", "Violation", "PlanVerificationError",
           "verify_plan"]
