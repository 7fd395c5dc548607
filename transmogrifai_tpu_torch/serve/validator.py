"""Servability validator — the TM5xx/TM601 gates of the compiled scoring
path (counterpart of ``transmogrifai_tpu/serve/validator.py``):

- **TM501** (error): an estimator in the scoring path has no fitted model.
- **TM502** (warning): a stage without ``device_transform`` consumes a
  device-capable stage's output and feeds a device-capable consumer — the
  device prefix stops there and the batch round-trips through the host.
- **TM503** (warning): a raw OPVector feature (its width known only from
  the data) feeds a device-capable stage, which stays on the host.
- **TM504** (info): the planner's split into device prefix and host
  remainder.
- **TM505** (error) / **TM506** (warning): the fault-tolerance configuration
  (:func:`check_resilience_config`), run before a server accepts requests.
- **TM507** (error) / **TM508** (info): blue/green swap admission
  (:func:`check_swap_compatibility`): same result features and precision
  class, and a fingerprint change called out.
- **TM509** (error): fleet device-memory admission
  (:func:`check_fleet_admission`): the candidate's static peak estimate
  plus every resident warm fingerprint's exceeds the fleet's budget even
  after the registry's LRU eviction.
- **TM511** (error): reduced-precision calibration parity
  (:func:`check_precision_parity`): a bf16/int8 plan's max prediction
  delta vs the f32 plan over the calibration batch exceeds the class bound
  (``serve.plan.TM511_BOUNDS``).
- **TM601** (error): plan admission (:func:`check_plan_admission`): the
  plan's static peak device-memory estimate over its bucket ladder
  (``checkers/plancheck.py``) exceeds the budget.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

from ..checkers.diagnostics import DiagnosticReport, make_diagnostic
from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..types import ColumnKind


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


def check_plan_admission(plan, hbm_budget: float) -> DiagnosticReport:
    """Device-memory admission of a scoring plan (TM601): the plan's static
    peak estimate over its bucket ladder (``checkers/plancheck.py``, shape
    arithmetic only, nothing allocated) against ``hbm_budget`` bytes.  The
    plan runs it at construction when given a budget, so a plan that cannot
    fit the device refuses to build.  The report carries the estimate as
    ``plan_cost``."""
    from ..checkers.plancheck import analyze_scoring_plan, cost_diagnostics

    report = DiagnosticReport()
    if not plan.device_stage_uids:
        return report  # all-host plan: nothing on the device to admit
    cost = analyze_scoring_plan(plan)
    report.plan_cost = cost
    report.extend(d for d in cost_diagnostics(cost, hbm_budget=hbm_budget)
                  if d.code == "TM601")
    return report


def check_fleet_admission(tenant: str, need_bytes: float,
                          resident_bytes: float, hbm_budget: float,
                          evicted: Sequence[str] = ()) -> DiagnosticReport:
    """Fleet device-memory admission (TM509) for the multi-tenant registry.

    ``need_bytes`` is the candidate plan's static peak estimate (TM601's
    number); ``resident_bytes`` sums the estimates of every distinct warm
    fingerprint still resident after the registry's LRU eviction pass (a
    candidate sharing a resident fingerprint costs nothing more).  Reports
    TM509 when the fleet still does not fit."""
    report = DiagnosticReport()
    if need_bytes + resident_bytes > hbm_budget:
        evicted_note = (
            f" (after evicting {len(evicted)} cold tenant(s): "
            f"{sorted(evicted)})" if evicted else "")
        report.extend([make_diagnostic(
            "TM509",
            f"cannot admit tenant {tenant!r}: candidate peak-HBM estimate "
            f"{need_bytes:.0f} B + resident warm executables "
            f"{resident_bytes:.0f} B exceed the fleet hbm_budget "
            f"{hbm_budget:.0f} B{evicted_note}")])
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


def _calibration_entries(plan, n_rows: int):
    """Deterministic synthetic calibration batch of ``plan``'s prefix entry
    operands, from ``entry_specs`` alone and in their order (one
    ``default_rng(511)`` stream, as the reference draws it): float lifts a
    seeded standard normal times 3 with a NaN last row, integer encodings
    small non-negative codes."""
    import numpy as np

    rng = np.random.default_rng(511)
    ops = []
    for trailing, dtype in plan.entry_specs:
        dt = np.dtype(dtype)
        shape = (n_rows,) + tuple(trailing)
        if np.issubdtype(dt, np.floating):
            arr = rng.standard_normal(shape).astype(dt) * 3.0
            if n_rows > 1 and arr.ndim == 1:
                arr[-1] = np.nan
        else:
            arr = rng.integers(0, 8, size=shape).astype(dt)
        ops.append(arr)
    return ops


def check_precision_parity(f32_plan, candidate_plan, *,
                           records: Optional[Sequence[Mapping[str, Any]]] = None,
                           n_rows: int = 64) -> DiagnosticReport:
    """Calibration parity gate of reduced-precision plans (TM511).

    With ``records``, both plans score them end to end and the delta is the
    largest absolute difference over the prediction outputs (a prediction
    map's continuous entries: the argmax class is a step function a
    boundary record may flip).  Without records, a deterministic synthetic
    batch (:func:`_calibration_entries`) runs through the device prefix
    only, and each float output's delta is divided by its largest f32
    magnitude (at least 1).  TM511 when the delta exceeds the class bound
    (``serve.plan.TM511_BOUNDS``), or when the class has no bound
    (fail-closed).  The delta lands on the report as
    ``max_precision_delta``."""
    import numpy as np

    from .plan import TM511_BOUNDS, Precision

    report = DiagnosticReport()
    report.max_precision_delta = None
    precision = getattr(candidate_plan, "precision", Precision.F32)
    if precision == Precision.F32:
        return report
    bound = TM511_BOUNDS.get(precision)
    if bound is None:
        report.extend([make_diagnostic(
            "TM511",
            f"precision class {precision!r} has no documented parity bound "
            "(serve.plan.TM511_BOUNDS); refusing fail-closed")])
        return report
    if not candidate_plan.device_stage_uids:
        return report  # all-host plan: the lowering never runs

    if records is not None:
        from ..types import Prediction

        ref_rows = f32_plan.score(list(records))
        got_rows = candidate_plan.score(list(records))
        delta = 0.0
        for ref, got in zip(ref_rows, got_rows):
            for name, rv in ref.items():
                gv = got.get(name)
                if isinstance(rv, Mapping):
                    delta = max(delta, *(abs(float(rv[k]) - float(gv[k]))
                                         for k in rv
                                         if k != Prediction.PredictionName),
                                0.0)
                elif isinstance(rv, (int, float)) and not isinstance(rv, bool):
                    delta = max(delta, abs(float(rv) - float(gv)))
                elif isinstance(rv, (list, tuple, np.ndarray)):
                    delta = max(delta, float(np.max(np.abs(
                        np.asarray(rv, dtype=np.float64)
                        - np.asarray(gv, dtype=np.float64)), initial=0.0)))
    else:
        ops = _calibration_entries(candidate_plan, n_rows)
        ref_outs = f32_plan._fused(*ops)
        got_outs = candidate_plan._fused(*ops)
        delta = 0.0
        for ref, got in zip(ref_outs, got_outs):
            r = np.asarray(ref)
            if not np.issubdtype(r.dtype, np.floating):
                continue
            d = np.abs(r.astype(np.float64) - np.asarray(got).astype(np.float64))
            norm = max(1.0, float(np.max(np.nan_to_num(np.abs(r)), initial=0.0)))
            delta = max(delta, float(np.max(np.nan_to_num(d), initial=0.0)) / norm)

    report.max_precision_delta = delta
    if delta > bound:
        report.extend([make_diagnostic(
            "TM511",
            f"{precision} plan's max prediction delta {delta:.3e} vs the "
            f"f32 plan over the calibration batch exceeds the class bound "
            f"{bound:.0e}; refusing the reduced-precision plan")])
    return report


def check_servability(result_features: Sequence[Feature],
                      fitted: Optional[Mapping[str, Any]] = None
                      ) -> DiagnosticReport:
    """The TM501-TM504 analyzers over the DAG reached from
    ``result_features``; ``fitted`` (uid -> fitted transformer) resolves
    estimators to their models, a missing one being TM501."""
    from ..stages.base import Estimator
    from ..workflow.dag import all_stages
    from ..workflow.plan import device_slots, partition_device_prefix, serving_entry_ok

    report = DiagnosticReport()
    resolved: List[Any] = []
    for st in all_stages(result_features):
        runner = fitted.get(st.uid) if fitted is not None else None
        if runner is None:
            if fitted is not None and isinstance(st, Estimator):
                report.extend([make_diagnostic(
                    "TM501",
                    f"estimator {type(st).__name__} ({st.uid}) has no fitted "
                    "model in the scoring path",
                    stage_uid=st.uid)])
            runner = st
        resolved.append(runner)

    prefix, remainder, device_uids = partition_device_prefix(resolved, serving_entry_ok)

    if resolved:
        host_names = ", ".join(sorted({type(r).__name__ for r in remainder})) \
            or "none"
        report.extend([make_diagnostic(
            "TM504",
            f"transform planner fuses {len(prefix)} of {len(resolved)} "
            f"stage(s) into the jitted device prefix; host remainder: "
            f"{len(remainder)} stage(s) ({host_names})")])

    consumers: Dict[str, List[Any]] = {}
    for r in resolved:
        for f in r.inputs:
            consumers.setdefault(f.uid, []).append(r)
    for r in remainder:
        if not any(f.uid in device_uids for f in r.inputs):
            continue
        out_uid = r.get_output().uid
        if any(callable(getattr(c, "device_transform", None))
               for c in consumers.get(out_uid, ())):
            report.extend([make_diagnostic(
                "TM502",
                f"{type(r).__name__} ({r.uid}) has no device_transform but "
                "sits between device-capable stages; the fused scoring "
                "prefix breaks here and pays a device->host->device "
                "round-trip per batch",
                stage_uid=r.uid)])

    seen_raw: set = set()
    for r in resolved:
        if not callable(getattr(r, "device_transform", None)):
            continue
        for slot in device_slots(r):
            if slot >= len(r.inputs):
                continue
            f = r.inputs[slot]
            if not isinstance(f.origin_stage, FeatureGeneratorStage):
                continue
            if f.ftype.kind is ColumnKind.VECTOR and f.uid not in seen_raw:
                seen_raw.add(f.uid)
                report.extend([make_diagnostic(
                    "TM503",
                    f"raw feature {f.name!r} is an OPVector whose width is "
                    f"only known from the data; {type(r).__name__} ({r.uid}) "
                    "cannot join the bucketed fused prefix and stays on host",
                    stage_uid=r.uid)])
    return report
