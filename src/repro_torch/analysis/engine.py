"""The lint engine: parse once, run every rule, honor suppressions
(DESIGN.md §14), ported from ``repro.analysis.engine``.

The engine walks the port's Python (default: ``src/repro_torch`` and
``chip_smoke.py``; a scan entry may be a directory or a single file;
tests stay exempt, and ``benchmarks/``, ``examples/`` and ``scripts/``
belong to the JAX package), parses each file once, and hands the AST to
every applicable rule. Findings are filtered through per-line
suppression comments::

    something_banned()        # lint: disable=raw-clock
    other_banned()            # lint: disable=raw-clock,global-random

and rendered either as stable one-line records (sorted by path, line,
rule — diffable across CI runs) or as JSON (``--json``).
"""
from __future__ import annotations

import ast
import json
import pathlib
import re

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.rules import all_rules

__all__ = ["DEFAULT_SCAN_DIRS", "LintEngine", "lint_tree",
           "format_findings", "findings_to_json", "parse_suppressions"]

# the port's own source; tests are exempt by construction
DEFAULT_SCAN_DIRS = ("src/repro_torch", "chip_smoke.py")

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_,\- ]+)")


def parse_suppressions(lines: list[str]) -> dict[int, set[str]]:
    """{1-based line: {rule ids}} from ``# lint: disable=a,b`` comments."""
    out: dict[int, set[str]] = {}
    for lineno, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[lineno] = {r.strip() for r in m.group(1).split(",")
                           if r.strip()}
    return out


class LintEngine:
    """Run the rule catalog over files under ``root``.

    ``root`` anchors the repo-relative paths rules scope on — pointing it
    at a fixture tree that mirrors the repo layout exercises the same
    scoping the real gate applies.
    """

    def __init__(self, root, rules=None):
        self.root = pathlib.Path(root)
        self.rules = tuple(rules) if rules is not None else all_rules()

    # ---------- single file ----------
    def lint_file(self, path) -> list[Finding]:
        path = pathlib.Path(path)
        rel = path.relative_to(self.root).as_posix()
        text = path.read_text()
        lines = text.splitlines()
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError as e:
            return [Finding(path=rel, line=e.lineno or 1,
                            rule="parse-error", severity=Severity.ERROR,
                            message=f"file does not parse: {e.msg}")]
        suppressed = parse_suppressions(lines)
        findings: list[Finding] = []
        for rule in self.rules:
            if not rule.applies(rel):
                continue
            for f in rule.visit(tree, rel, lines):
                if f.rule in suppressed.get(f.line, ()):
                    continue
                findings.append(f)
        return sorted(findings)

    # ---------- trees ----------
    def lint_dirs(self, dirs=DEFAULT_SCAN_DIRS) -> list[Finding]:
        findings: list[Finding] = []
        self.scanned = 0
        for d in dirs:
            base = self.root / d
            if base.is_file():
                paths = [base]
            elif base.is_dir():
                paths = sorted(base.rglob("*.py"))
            else:
                continue
            for path in paths:
                self.scanned += 1
                findings.extend(self.lint_file(path))
        return sorted(findings)


def lint_tree(root, dirs=DEFAULT_SCAN_DIRS) -> list[Finding]:
    """Convenience wrapper: one-shot lint of ``dirs`` under ``root``."""
    return LintEngine(root).lint_dirs(dirs)


# ---------------------------------------------------------------------------
# rendering

def format_findings(findings: list[Finding], *, scanned: int | None = None
                    ) -> str:
    """The stable, diffable CI summary: one line per finding (sorted),
    then a count line."""
    out = [f.render() for f in sorted(findings)]
    errors = sum(f.severity is Severity.ERROR for f in findings)
    warnings = len(findings) - errors
    scan = f" across {scanned} files" if scanned is not None else ""
    out.append(f"repro_torch.analysis: {len(findings)} finding(s) "
               f"({errors} error(s), {warnings} warning(s)){scan}")
    return "\n".join(out)


def findings_to_json(findings: list[Finding]) -> str:
    errors = sum(f.severity is Severity.ERROR for f in findings)
    doc = {"findings": [f.to_doc() for f in sorted(findings)],
           "errors": errors, "warnings": len(findings) - errors}
    return json.dumps(doc, indent=1, sort_keys=True)
