"""The scoring server's TM5xx gates (counterpart of part of
``transmogrifai_tpu/serve/validator.py``):

- **TM505** (error) / **TM506** (warning): fault-tolerance configuration
  checks (:func:`check_resilience_config`) — invalid retry/breaker numbers,
  and a default deadline the flush wait makes unmeetable.  Run by
  :class:`~.server.ScoringServer` before any request is accepted.
- **TM507** (error) / **TM508** (info): blue/green swap admission
  (:func:`check_swap_compatibility`) — a staged candidate must serve the
  same result feature names and the same precision class as the active
  model, and a fingerprint-changing swap is called out.

TM501 (an unfitted estimator) is checked by the plan itself
(``serve/plan.py``).
"""

from __future__ import annotations

from typing import Any, Optional

from ..checkers.diagnostics import DiagnosticReport, make_diagnostic


def check_resilience_config(*, max_retries: int = 0,
                            backoff_base_s: float = 0.05,
                            backoff_cap_s: float = 1.0,
                            failure_threshold: int = 3,
                            recovery_batches: int = 8,
                            dead_letter: Any = None,
                            default_deadline_ms: Optional[float] = None,
                            max_wait_ms: Optional[float] = None
                            ) -> DiagnosticReport:
    """Static validation of the serving fault-tolerance parameters.

    TM505 (error): numerically impossible retry/backoff/breaker settings, or
    a non-callable dead-letter hook.  TM506 (warning): a default deadline no
    longer than the batcher's flush wait, so every request that waits out a
    full flush window is evicted unscored.
    """
    report = DiagnosticReport()

    def bad(msg: str) -> None:
        report.extend([make_diagnostic("TM505", msg)])

    if max_retries < 0:
        bad(f"max_retries must be >= 0, got {max_retries}")
    if backoff_base_s <= 0 or backoff_cap_s <= 0:
        bad(f"backoff seconds must be > 0, got base={backoff_base_s}, "
            f"cap={backoff_cap_s}")
    if backoff_cap_s < backoff_base_s:
        bad(f"backoff_cap_s ({backoff_cap_s}) < backoff_base_s "
            f"({backoff_base_s}): the cap would truncate the first retry")
    if failure_threshold < 1:
        bad(f"failure_threshold must be >= 1, got {failure_threshold}")
    if recovery_batches < 1:
        bad(f"recovery_batches must be >= 1, got {recovery_batches}")
    if dead_letter is not None and not callable(dead_letter):
        bad(f"dead_letter must be callable, got {type(dead_letter).__name__}")
    if default_deadline_ms is not None and default_deadline_ms <= 0:
        bad(f"default_deadline_ms must be > 0, got {default_deadline_ms}")
    if default_deadline_ms is not None and max_wait_ms is not None \
            and 0 < default_deadline_ms <= max_wait_ms:
        report.extend([make_diagnostic(
            "TM506",
            f"default deadline ({default_deadline_ms} ms) is not longer "
            f"than the batcher flush wait ({max_wait_ms} ms); queued "
            "requests will expire before they can flush")])
    return report


def check_swap_compatibility(active_plan, candidate_plan) -> DiagnosticReport:
    """Blue/green swap admission (TM507/TM508).

    TM507 (error): the candidate does not serve the same result feature
    names, or not at the same precision class, as the active plan.  TM508
    (info): the candidate's prefix fingerprint differs from the active
    plan's; still admitted, the difference is called out.
    """
    report = DiagnosticReport()
    active_names = sorted(f.name for f in active_plan.result_features)
    cand_names = sorted(f.name for f in candidate_plan.result_features)
    if active_names != cand_names:
        report.extend([make_diagnostic(
            "TM507",
            f"candidate serves result features {cand_names} but the active "
            f"model serves {active_names}; refusing a schema-changing swap")])
        return report
    active_prec = getattr(active_plan, "precision", "f32")
    cand_prec = getattr(candidate_plan, "precision", "f32")
    if active_prec != cand_prec:
        report.extend([make_diagnostic(
            "TM507",
            f"candidate precision class {cand_prec!r} differs from the "
            f"active plan's {active_prec!r}; refusing a numerics-changing "
            "swap")])
        return report
    if candidate_plan.fingerprint != active_plan.fingerprint:
        report.extend([make_diagnostic(
            "TM508",
            "candidate prefix fingerprint "
            f"{candidate_plan.fingerprint[:12]} differs from the active "
            f"plan's {active_plan.fingerprint[:12]}; the swap serves a "
            "different prefix")])
    return report
