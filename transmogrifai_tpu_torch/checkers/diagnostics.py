"""Typed diagnostics (counterpart of ``transmogrifai_tpu/checkers/diagnostics.py``).

The reference's validators report findings as :class:`Diagnostic` objects
with stable codes, so tooling matches on codes instead of message text.  The
port has the serving server's codes so far:

- ``TM501`` — an estimator in the scoring path has no fitted model;
- ``TM505`` / ``TM506`` — the server's fault-tolerance configuration
  (``serve/validator.py::check_resilience_config``);
- ``TM507`` / ``TM508`` — blue/green swap admission
  (``serve/validator.py::check_swap_compatibility``);
- ``TM801``-``TM809`` — continual training: drift, the warm refit, the
  promotion gate, swap and rollback (``workflow/continual.py``);
- ``TM820``-``TM823`` — training resilience: retries, degradation, fail
  fast (``workflow/resilience.py``).
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
    # -- continual training (drift-gated warm refit, workflow/continual.py) --
    "TM801": (Severity.WARNING, "covariate drift: PSI beyond threshold",
              "the streamed distribution of this feature diverged from its "
              "train-time snapshot (population stability index over the "
              "snapshot's quantile bins); the serving model was fitted on a "
              "population that no longer matches live traffic — let the "
              "refit controller retrain, or raise psi_threshold if this "
              "feature is expected to wander"),
    "TM802": (Severity.WARNING, "feature mean shift beyond z threshold",
              "the streamed mean of this feature sits more than z_threshold "
              "standard errors from its train-time mean (two-sample z over "
              "the snapshot moments); investigate an upstream pipeline "
              "change, or let the refit controller retrain"),
    "TM803": (Severity.WARNING, "missing-rate shift beyond threshold",
              "the fraction of missing values in this feature moved beyond "
              "missing_shift from its train-time rate — often an upstream "
              "extraction outage rather than real drift; check the producer "
              "before trusting a refit on the degraded window"),
    "TM804": (Severity.INFO, "insufficient streamed rows for drift evaluation",
              "fewer than min_records rows observed since the last refit "
              "anchor; drift statistics at this sample size would fire on "
              "noise, so the evaluation is deferred — stream more data or "
              "lower min_records"),
    "TM805": (Severity.ERROR, "warm refit failed; serving model unchanged",
              "every bounded retry of the drift-triggered refit failed; the "
              "server keeps the last-known-good model and the stream keeps "
              "scoring — inspect the attached cause, then retrigger by "
              "streaming more drifted data or refitting manually"),
    "TM806": (Severity.WARNING, "shadow gate failed; candidate not promoted",
              "the candidate model's mirrored-traffic scores violated the "
              "promotion gate (shadow failures, non-finite or oversized "
              "prediction deltas, or a metric regression); the candidate "
              "was discarded and the active model keeps serving — loosen "
              "max_prediction_delta only if the delta is the expected "
              "consequence of real drift"),
    "TM807": (Severity.INFO, "model swap committed",
              "informational: the candidate passed the shadow gate and an "
              "atomic blue/green swap made it the active serving model; "
              "the previous model is retained for rollback through the "
              "probation window"),
    "TM808": (Severity.WARNING, "post-swap rollback to last-known-good",
              "the promoted model tripped its circuit breaker inside the "
              "probation window and the server rolled back to the retained "
              "last-known-good model; treat the candidate as bad — inspect "
              "its refit window before promoting again"),
    "TM809": (Severity.WARNING, "warm refit recompiled the transform prefix",
              "the refit was expected to reuse the built kernel libraries "
              "and the frozen prefix (frozen prep stages) but kernel builds "
              "or library loads were observed "
              "(perf/kernels/dispatch.py::build_counts); check that the prep "
              "stages are really frozen"),
    # -- training resilience (workflow/resilience.py) -----------------------
    "TM820": (Severity.INFO, "retryable training fault; retrying",
              "a transient training-path failure (chunk read, prefetch, "
              "stage fit, sweep dispatch, device sync) was retried with "
              "bounded exponential backoff + jitter; informational unless "
              "it recurs — persistent retries escalate to a degradation "
              "ladder (TM821/TM822) or exhaust into the original error"),
    "TM821": (Severity.WARNING, "training degraded to a shrunk device mesh",
              "a device fault persisted through every in-place retry under "
              "a mesh, so the sweep re-dispatched with the data axis halved; "
              "the run completes at reduced parallelism — investigate the "
              "failing devices before the next full-mesh run (the port has "
              "no mesh yet, so it never emits this code)"),
    "TM822": (Severity.WARNING, "sweep degraded to a smaller row bucket",
              "repeated resource exhaustion (OOM) made the dispatched row "
              "bucket infeasible, so the sweep retried on the next-smaller "
              "power-of-two row cap; CV metrics for the degraded block are "
              "computed on the capped rows — lower hbm pressure (smaller "
              "chunk/bucket, fewer grids per dispatch) to avoid the cap"),
    "TM823": (Severity.ERROR, "training failed fast on a non-retryable "
              "error",
              "a non-retryable error (bad input, poison payload, programming "
              "error) surfaced inside a resilient training run; it was NOT "
              "retried — the sweep journal keeps every completed "
              "(family, fold-block) so a fixed re-run resumes past them "
              "(train(resume=...) / cli train --resume)"),
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
