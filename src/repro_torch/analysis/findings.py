"""Structured lint findings (DESIGN.md §14), ported from
``repro.analysis.findings``.

A ``Finding`` is one rule hit at one source location. It is deliberately
plain data: the engine sorts, filters (suppressions) and renders them;
CI consumes the JSON form; tests assert on (path, line, rule) triples.
"""
from __future__ import annotations

import enum
from dataclasses import asdict, dataclass


class Severity(str, enum.Enum):
    """``error`` fails the gate; ``warning`` is advisory only."""

    ERROR = "error"
    WARNING = "warning"

    def __str__(self) -> str:  # noqa: D105 - str enum renders its value
        return self.value


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation: where, what, and how to fix it."""

    path: str                 # repo-relative posix path
    line: int                 # 1-based
    rule: str                 # rule id, e.g. "raw-clock"
    severity: Severity
    message: str
    fix: str = ""             # suggested fix (one line)
    snippet: str = ""         # the offending source line, stripped

    def render(self) -> str:
        """The stable, diffable one-line form CI logs show."""
        out = (f"{self.path}:{self.line}: [{self.rule}/{self.severity}] "
               f"{self.message}")
        if self.fix:
            out += f" (fix: {self.fix})"
        return out

    def to_doc(self) -> dict:
        doc = asdict(self)
        doc["severity"] = str(self.severity)
        return doc
