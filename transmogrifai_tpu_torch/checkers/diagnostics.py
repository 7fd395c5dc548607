"""Typed diagnostics (counterpart of ``transmogrifai_tpu/checkers/diagnostics.py``).

The reference's validators report findings as :class:`Diagnostic` objects
with stable codes, so tooling matches on codes instead of message text.  The
port has the serving server's codes so far:

- ``TM501`` — an estimator in the scoring path has no fitted model;
- ``TM505`` / ``TM506`` — the server's fault-tolerance configuration
  (``serve/validator.py::check_resilience_config``);
- ``TM507`` / ``TM508`` — blue/green swap admission
  (``serve/validator.py::check_swap_compatibility``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


class Severity(enum.IntEnum):
    """Ordered so gates can threshold (``sev >= Severity.WARNING``)."""

    INFO = 10
    WARNING = 20
    ERROR = 30

    def __str__(self) -> str:  # "error", not "Severity.ERROR", in messages
        return self.name.lower()


#: code -> (default severity, short title, default fix hint)
DIAGNOSTIC_CODES: Dict[str, Tuple[Severity, str, str]] = {
    "TM501": (Severity.ERROR, "unfitted estimator in scoring path",
              "train the workflow (or warm-start the missing stage) before "
              "building a scoring plan; an estimator without a fitted model "
              "cannot transform at request time"),
    "TM505": (Severity.ERROR, "invalid fault-tolerance configuration",
              "fix the serving resilience parameters: retry counts must be "
              ">= 0, backoff seconds > 0, breaker failure_threshold and "
              "recovery_batches >= 1, and the dead-letter hook (if set) "
              "must be callable"),
    "TM506": (Severity.WARNING, "deadline tighter than the batch flush wait",
              "the default request deadline is not longer than the "
              "batcher's max_wait_ms, so every request that waits for a "
              "full flush window expires in the queue and is evicted "
              "unscored; raise the deadline or lower max_wait_ms"),
    "TM507": (Severity.ERROR, "candidate model incompatible with serving schema",
              "the staged candidate does not serve the same result feature "
              "names as the active model; a swap would silently change the "
              "response schema under live clients — refit the same workflow "
              "(same result features) or deploy as a new server instead"),
    "TM508": (Severity.INFO, "blue/green swap compiles a fresh prefix",
              "the candidate's prefix fingerprint differs from the active "
              "plan's, so the swap cannot share the active plan's prefix "
              "(a warm refit that froze the prep stages would); the swap is "
              "still atomic, but the candidate sets up its own buckets"),
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code + severity + location + actionable fix hint."""

    code: str
    severity: Severity
    message: str
    stage_uid: Optional[str] = None
    location: Optional[str] = None
    fix_hint: str = ""

    def pretty(self) -> str:
        where = self.stage_uid or self.location or "<workflow>"
        lines = [f"{self.code} [{self.severity}] {where}: {self.message}"]
        if self.fix_hint:
            lines.append(f"       fix: {self.fix_hint}")
        return "\n".join(lines)


def make_diagnostic(code: str, message: str, stage_uid: Optional[str] = None,
                    location: Optional[str] = None,
                    severity: Optional[Severity] = None,
                    fix_hint: Optional[str] = None) -> Diagnostic:
    """Build a Diagnostic, filling severity/fix hint from the code table."""
    default_sev, _title, default_hint = DIAGNOSTIC_CODES.get(
        code, (Severity.WARNING, code, ""))
    return Diagnostic(code=code,
                      severity=default_sev if severity is None else severity,
                      message=message, stage_uid=stage_uid, location=location,
                      fix_hint=default_hint if fix_hint is None else fix_hint)


@dataclass
class DiagnosticReport:
    """Ordered collection of diagnostics with severity filters and rendering."""

    diagnostics: List[Diagnostic] = field(default_factory=list)

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity >= Severity.ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.WARNING]

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]


class OpCheckError(ValueError):
    """Raised by a gate on error-severity findings; carries the report."""

    def __init__(self, report: DiagnosticReport):
        self.report = report
        errs = report.errors()
        super().__init__(
            f"workflow validation failed with {len(errs)} error(s):\n"
            + "\n".join(d.pretty() for d in errs))
