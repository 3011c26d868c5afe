"""Diagnostics: the Violation / Report data model (the port's copy of the
JAX package's ``analysis/report.py``, so a report reads the same from
either package).

Every pass returns plain data — a list of Violations — and never raises
on the code it analyzes. That is what makes the analyzer usable from
callers with different failure policies: the CLI (exit codes) and the
tests (assert on codes).

Severity model:
  error   — the code cannot run correctly (a lock-order inversion, a
            lock that bypasses the registry).
  warning — it runs but stalls or silently degrades (a lock held across
            a blocking call, a host read inside a CUDA-graph capture).
  info    — notes that cross no threshold. Never fail any mode.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass
class Violation:
    code: str            # stable kebab-case rule id, e.g. "axis-unknown"
    pass_name: str       # "legality" | "perf" | "schema" | the ffsan
    #                      source passes "concurrency" | "tracestability"
    severity: str        # "error" | "warning" | "info"
    message: str
    op_name: Optional[str] = None   # the offending op, or for the ffsan
    #                                 passes the function / method qualname
    # perf ranking key: estimated bytes moved by the flagged collective
    est_bytes: Optional[float] = None
    est_seconds: Optional[float] = None
    # source location (ffsan passes — None for strategy/graph passes,
    # which have no file:line to point at)
    file: Optional[str] = None
    line: Optional[int] = None

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity

    def __str__(self) -> str:
        where = f" op {self.op_name!r}" if self.op_name else ""
        if self.file:
            where += f" {self.file}:{self.line}"
        return (f"{self.severity}[{self.pass_name}/{self.code}]{where}: "
                f"{self.message}")


class Report:
    """Ordered collection of violations from one analyze() run."""

    def __init__(self, violations: Optional[List[Violation]] = None):
        self.violations: List[Violation] = list(violations or [])

    def add(self, v: Violation) -> None:
        self.violations.append(v)

    def extend(self, vs) -> None:
        self.violations.extend(vs)

    def errors(self) -> List[Violation]:
        return [v for v in self.violations if v.severity == "error"]

    def warnings(self) -> List[Violation]:
        return [v for v in self.violations if v.severity == "warning"]

    def notes(self) -> List[Violation]:
        return [v for v in self.violations if v.severity == "info"]

    @property
    def ok(self) -> bool:
        """No errors and no warnings (info notes don't count)."""
        return not self.errors() and not self.warnings()

    def codes(self) -> List[str]:
        return [v.code for v in self.violations]

    def by_code(self, code: str) -> List[Violation]:
        return [v for v in self.violations if v.code == code]

    def summary(self) -> str:
        e, w, n = len(self.errors()), len(self.warnings()), len(self.notes())
        return f"fflint: {e} error(s), {w} warning(s), {n} note(s)"

    def format_text(self, include_notes: bool = True) -> str:
        order = {"error": 0, "warning": 1, "info": 2}
        lines = [str(v) for v in sorted(
            self.violations, key=lambda v: (order[v.severity],
                                            -(v.est_bytes or 0.0)))
            if include_notes or v.severity != "info"]
        lines.append(self.summary())
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "violations": [dataclasses.asdict(v) for v in self.violations],
            "num_errors": len(self.errors()),
            "num_warnings": len(self.warnings()),
            "num_notes": len(self.notes()),
        }, indent=2)

    def log(self, logger) -> None:
        """Emit through a stdlib-style logger (compile's warn mode)."""
        for v in self.violations:
            if v.severity == "error":
                logger.error("%s", v)
            elif v.severity == "warning":
                logger.warning("%s", v)
