"""``python -m repro_torch.analysis`` — the port's static gate
(DESIGN.md §14), ported from ``python -m repro.analysis``.

Runs both halves of the analysis package and exits non-zero on any
error-severity finding or plan violation:

  1. **Lint**: the AST rule catalog over the port's source
     (``src/repro_torch``, ``chip_smoke.py``). Output is the stable
     sorted one-line-per-finding summary (diffable across CI runs), or
     JSON with ``--json``.
  2. **Verify**: compiles the port's plans (PaperCNN across every quant
     mode, the 224x224 VGG-style ``highres_cnn`` with streamed stages)
     with ``verify=False`` and then runs ``verify_plan`` explicitly — so
     the gate exercises the verifier itself, not just the compile
     wiring. Compiling a plan launches nothing and needs no card.

Run it from the repository root as ``PYTHONPATH=src python -m
repro_torch.analysis`` (``--root`` names another root).
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.analysis.engine import (DEFAULT_SCAN_DIRS, LintEngine,
                                         findings_to_json, format_findings)
from repro_torch.analysis.findings import Severity
from repro_torch.analysis.verifier import verify_plan


def _run_lint(root: pathlib.Path, as_json: bool) -> int:
    engine = LintEngine(root)
    findings = engine.lint_dirs(DEFAULT_SCAN_DIRS)
    if as_json:
        print(findings_to_json(findings))
    else:
        print(format_findings(findings, scanned=engine.scanned))
    return 1 if any(f.severity is Severity.ERROR for f in findings) else 0


def _run_verify() -> int:
    """Compile the port's plans unverified, then verify explicitly."""
    from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
    from repro_torch.models.vgg import VGGStyleCNN, VGGStyleCNNConfig
    from repro_torch.ops import ExecPolicy

    rc = 0
    cases = [(f"mnist_cnn[{q}]",
              lambda q=q: PaperCNN(PaperCNNConfig()).compile(
                  ExecPolicy(quant=q), verify=False))
             for q in ("none", "qformat", "int8")]
    cases.append(("highres_cnn[streamed]",
                  lambda: VGGStyleCNN(VGGStyleCNNConfig()).compile(
                      verify=False)))
    for name, build in cases:
        violations = verify_plan(build(), raise_on_violation=False)
        if violations:
            rc = 1
            for v in violations:
                print(f"verify {name}: {v.render()}")
        else:
            print(f"verify {name}: ok")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST lint + compile-time plan verification gate")
    ap.add_argument("--root", default=".",
                    help="repo root the scan dirs hang off (default: cwd)")
    ap.add_argument("--json", action="store_true",
                    help="emit lint findings as JSON")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--lint-only", action="store_true",
                      help="skip the plan-verifier step")
    mode.add_argument("--verify-only", action="store_true",
                      help="skip the lint step")
    args = ap.parse_args(argv)

    rc = 0
    if not args.verify_only:
        rc |= _run_lint(pathlib.Path(args.root).resolve(), args.json)
    if not args.lint_only:
        rc |= _run_verify()
    return rc


if __name__ == "__main__":
    sys.exit(main())
