"""Continuous warm refit — the drift-gated streaming retrain control plane
(counterpart of ``transmogrifai_tpu/workflow/continual.py``).

The loop drives the serving engine's swap machinery (``serve/server.py``:
``stage_candidate``, ``shadow_report``, ``promote``, ``rollback``) from a
stream:

1. **Drift detection** (:class:`TrainingSnapshot` + :class:`DriftDetector`)
   — per-feature train-time statistics (moments, missing rate, decile-bin
   proportions); streamed batches accumulate incrementally (Welford merges,
   bin counts against the frozen train-time edges) and evaluate as PSI /
   two-sample mean-shift z-tests / missing-rate shifts with typed TM801-TM804
   diagnostics.  Float64 numpy on the host, copied from the reference, so the
   statistics and codes equal its.
2. **Warm refit** (:class:`RefitController`) — when drift fires, the model
   estimators retrain on the streamed window ON THE CARD with every prep
   stage FROZEN to its last-known-good fitted state, so the whole-table
   plan's prefix keeps its content fingerprint
   (``workflow/plan.py::DevicePrefix.prefix_fingerprint``, the serving
   plan's too) and the refit builds and loads no kernel
   (``perf/timers.py::measure_compiles``: kernel builds, library loads and
   serving-bucket allocations, the port's counterpart of the reference's
   backend compiles; TM809 reports a violation, and with a flight recorder
   installed each one is also a TM901 finding).
   Retries are bounded with exponential backoff; a refit that still fails
   raises :class:`RefitError` (TM805) and the serving model is untouched.
   Each successful refit checkpoints atomically (versioned save + fsync'd
   CURRENT pointer rename).
3. **Shadow scoring + promotion** — the candidate stages into the server
   (:meth:`~..serve.server.ScoringServer.stage_candidate`); live traffic
   mirrors through a second plan on the card, and :class:`PromotionGate`
   admits the swap only when mirrored records are plentiful, shadow failures
   are absent, prediction deltas are finite and bounded, and the
   candidate's validation metric has not regressed (TM806 on refusal, TM807
   on commit).
4. **Atomic swap + rollback** — promotion is the server's blue/green swap;
   a breaker trip inside the probation window rolls back to the retained
   last-known-good model (TM808).

Every phase fires a named fault point (``drift`` / ``refit`` /
``checkpoint`` / ``swap`` / ``rollback`` / ``shadow``) through the
:class:`~..serve.faults.FaultHarness`.  With telemetry on, the loop emits
``continual.drift`` / ``refit`` / ``gate`` / ``swap`` spans (``obs/trace.py``)
and a ``drift`` flight event per firing evaluation (``obs/flight.py``).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from ..checkers.diagnostics import (Diagnostic, DiagnosticReport,
                                    make_diagnostic)
from ..data.dataset import Dataset
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry, canonical_help
from ..serve.faults import fault_point
from ..types import ColumnKind

log = logging.getLogger(__name__)

#: raw-feature kinds the drift detector tracks (canonical numeric lifts)
_DRIFT_KINDS = frozenset({ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL})


class RefitError(RuntimeError):
    """Every bounded retry of a drift-triggered warm refit failed.  The
    serving model is untouched (TM805); ``diagnostics`` carries the typed
    findings and ``cause`` the last underlying failure."""

    def __init__(self, message: str, cause: Optional[BaseException] = None,
                 diagnostics: Optional[List[Diagnostic]] = None):
        super().__init__(message)
        self.cause = cause
        self.diagnostics = list(diagnostics or [])


# ---------------------------------------------------------------------------
# Train-time statistics snapshot
# ---------------------------------------------------------------------------

@dataclass
class FeatureSnapshot:
    """Per-feature train-time statistics: the drift baseline."""

    name: str
    count: int
    mean: float
    variance: float
    missing_rate: float
    #: interior quantile edges (len B-1); bin b = (edges[b-1], edges[b]]
    bin_edges: List[float]
    #: train-time proportion of valid rows per bin (len B)
    bin_probs: List[float]

    def to_dict(self) -> dict:
        return {"name": self.name, "count": self.count, "mean": self.mean,
                "variance": self.variance, "missingRate": self.missing_rate,
                "binEdges": self.bin_edges, "binProbs": self.bin_probs}

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureSnapshot":
        return cls(name=d["name"], count=int(d["count"]),
                   mean=float(d["mean"]), variance=float(d["variance"]),
                   missing_rate=float(d["missingRate"]),
                   bin_edges=[float(x) for x in d["binEdges"]],
                   bin_probs=[float(x) for x in d["binProbs"]])


@dataclass
class TrainingSnapshot:
    """SanityChecker-style statistics of the training data, per raw numeric
    predictor — the baseline streamed batches are compared against."""

    features: Dict[str, FeatureSnapshot] = field(default_factory=dict)
    n_rows: int = 0

    @classmethod
    def from_dataset(cls, dataset: Dataset,
                     features: Optional[Sequence[Any]] = None,
                     bins: int = 10) -> "TrainingSnapshot":
        """Snapshot every numeric predictor column (or the named raw
        ``features``, response features excluded) with decile bin edges."""
        names: List[str] = []
        if features is not None:
            for f in features:
                if getattr(f, "is_response", False):
                    continue
                kind = getattr(getattr(f, "ftype", None), "kind", None)
                if kind in _DRIFT_KINDS and f.name in dataset:
                    names.append(f.name)
        else:
            names = [n for n in dataset.names
                     if dataset[n].kind in _DRIFT_KINDS]
        snap = cls(n_rows=dataset.n_rows)
        for name in names:
            vals = dataset[name].values_f64()
            valid = vals[~np.isnan(vals)]
            n = len(vals)
            if n == 0 or len(valid) == 0:
                continue
            qs = np.quantile(valid, np.linspace(0.0, 1.0, bins + 1))
            edges = np.unique(qs[1:-1])  # degenerate columns collapse bins
            ids = np.searchsorted(edges, valid, side="right")
            probs = np.bincount(ids, minlength=len(edges) + 1) / len(valid)
            snap.features[name] = FeatureSnapshot(
                name=name, count=int(len(valid)),
                mean=float(valid.mean()),
                variance=float(valid.var()),
                missing_rate=float(1.0 - len(valid) / n),
                bin_edges=[float(e) for e in edges],
                bin_probs=[float(p) for p in probs])
        return snap

    # -- persistence (baseline rides beside the saved model) -----------------
    def to_dict(self) -> dict:
        return {"nRows": self.n_rows,
                "features": [fs.to_dict() for fs in self.features.values()]}

    @classmethod
    def from_dict(cls, d: dict) -> "TrainingSnapshot":
        snap = cls(n_rows=int(d.get("nRows", 0)))
        for fd in d.get("features", []):
            fs = FeatureSnapshot.from_dict(fd)
            snap.features[fs.name] = fs
        return snap

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)

    @classmethod
    def load(cls, path: str) -> "TrainingSnapshot":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


class _RunningStats:
    """Welford accumulator + bin counts for one streamed feature."""

    __slots__ = ("count", "mean", "m2", "missing", "bins")

    def __init__(self, n_bins: int):
        self.count = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.missing = 0
        self.bins = np.zeros(n_bins, dtype=np.int64)

    def update(self, vals: np.ndarray, edges: np.ndarray) -> None:
        nan = np.isnan(vals)
        self.missing += int(nan.sum())
        valid = vals[~nan]
        if len(valid) == 0:
            return
        # batch Welford merge (Chan et al.): exact for any batch split
        b_n, b_mean = len(valid), float(valid.mean())
        b_m2 = float(((valid - b_mean) ** 2).sum())
        delta = b_mean - self.mean
        tot = self.count + b_n
        self.mean += delta * b_n / tot
        self.m2 += b_m2 + delta * delta * self.count * b_n / tot
        self.count = tot
        ids = np.searchsorted(edges, valid, side="right")
        self.bins += np.bincount(ids, minlength=len(self.bins))

    @property
    def variance(self) -> float:
        return self.m2 / self.count if self.count else 0.0


def population_stability_index(p: np.ndarray, q: np.ndarray,
                               eps: float = 1e-4) -> float:
    """PSI between the train-time bin proportions ``p`` and the streamed
    proportions ``q`` (both renormalized after epsilon smoothing, so empty
    bins contribute a finite penalty instead of infinity)."""
    p = np.asarray(p, dtype=np.float64) + eps
    q = np.asarray(q, dtype=np.float64) + eps
    p /= p.sum()
    q /= q.sum()
    return float(((q - p) * np.log(q / p)).sum())


class DriftDetector:
    """Incremental comparison of streamed batches against the train-time
    snapshot: PSI over the frozen quantile bins, a two-sample z-test on the
    mean, and the missing-rate shift — evaluated on demand with typed
    TM801-TM804 diagnostics.

    ``observe(dataset)`` is cheap (one pass over the batch's numeric
    columns); ``evaluate()`` fires the ``drift`` fault point and reports.
    """

    def __init__(self, snapshot: TrainingSnapshot, *,
                 psi_threshold: float = 0.25, z_threshold: float = 8.0,
                 missing_shift: float = 0.25, min_records: int = 200):
        if psi_threshold <= 0 or z_threshold <= 0 or missing_shift <= 0:
            raise ValueError("drift thresholds must be > 0")
        self.psi_threshold = float(psi_threshold)
        self.z_threshold = float(z_threshold)
        self.missing_shift = float(missing_shift)
        self.min_records = int(min_records)
        self.evaluations = 0
        self.rebase(snapshot)

    # -- lifecycle -----------------------------------------------------------
    def rebase(self, snapshot: TrainingSnapshot) -> None:
        """Swap the baseline (post-promotion: the refit window becomes the
        new anchor) and reset the stream accumulators."""
        self.snapshot = snapshot
        self.reset()

    def reset(self) -> None:
        self._acc = {name: _RunningStats(len(fs.bin_probs))
                     for name, fs in self.snapshot.features.items()}
        self._edges = {name: np.asarray(fs.bin_edges, dtype=np.float64)
                       for name, fs in self.snapshot.features.items()}
        self.records = 0

    # -- accumulation --------------------------------------------------------
    def observe(self, dataset: Dataset) -> None:
        for name, acc in self._acc.items():
            if name in dataset:
                acc.update(dataset[name].values_f64(), self._edges[name])
        self.records += dataset.n_rows

    # -- evaluation ----------------------------------------------------------
    def feature_stats(self) -> Dict[str, Dict[str, float]]:
        """Current per-feature drift statistics (PSI / z / missing shift)."""
        out: Dict[str, Dict[str, float]] = {}
        for name, fs in self.snapshot.features.items():
            acc = self._acc[name]
            seen = acc.count + acc.missing
            if seen == 0:
                continue
            # missing-rate shift is well-defined from seen rows alone — a
            # TOTAL upstream outage (every value missing, count == 0) is
            # exactly when TM803 must still fire
            st = {
                "psi": 0.0, "z": 0.0,
                "mean": float("nan"), "train_mean": fs.mean,
                "missing_rate": acc.missing / seen,
                "missing_shift": abs(acc.missing / seen - fs.missing_rate),
                "records": acc.count,
            }
            if acc.count > 0:  # PSI / z need at least one valid value
                st["psi"] = population_stability_index(
                    np.asarray(fs.bin_probs), acc.bins / acc.count)
                se = math.sqrt(fs.variance / max(fs.count, 1)
                               + acc.variance / acc.count)
                diff = abs(acc.mean - fs.mean)
                if se > 0:
                    st["z"] = diff / se
                else:
                    # constant-to-constant shift: zero variance on both
                    # sides makes the standard error 0, but a MOVED mean is
                    # then infinitely significant, not insignificant (and
                    # the collapsed single-bin PSI cannot see it either)
                    st["z"] = 0.0 if math.isclose(
                        acc.mean, fs.mean, rel_tol=1e-9, abs_tol=1e-12) \
                        else float("inf")
                st["mean"] = acc.mean
            out[name] = st
        return out

    def evaluate(self) -> DiagnosticReport:
        """TM801 (PSI) / TM802 (mean shift) / TM803 (missing rate) findings,
        or TM804 when the stream sample is still too small to trust."""
        fault_point("drift", records=self.records)
        self.evaluations += 1
        report = DiagnosticReport()
        if self.records < self.min_records:
            report.extend([make_diagnostic(
                "TM804",
                f"{self.records} streamed row(s) since the last anchor < "
                f"min_records {self.min_records}; drift evaluation deferred")])
            return report
        for name, st in self.feature_stats().items():
            loc = f"feature:{name}"
            if st["psi"] > self.psi_threshold:
                report.extend([make_diagnostic(
                    "TM801",
                    f"feature {name!r} PSI {st['psi']:.4f} > threshold "
                    f"{self.psi_threshold} over {st['records']} streamed "
                    "rows", location=loc)])
            if st["z"] > self.z_threshold:
                report.extend([make_diagnostic(
                    "TM802",
                    f"feature {name!r} mean {st['mean']:.4g} sits "
                    f"{st['z']:.1f} standard errors from the train mean "
                    f"{st['train_mean']:.4g} (z threshold "
                    f"{self.z_threshold})", location=loc)])
            if st["missing_shift"] > self.missing_shift:
                report.extend([make_diagnostic(
                    "TM803",
                    f"feature {name!r} missing rate moved to "
                    f"{st['missing_rate']:.3f} "
                    f"(shift {st['missing_shift']:.3f} > "
                    f"{self.missing_shift})", location=loc)])
        return report

    @staticmethod
    def drifted(report: DiagnosticReport) -> bool:
        return any(d.code in ("TM801", "TM802", "TM803") for d in report)


# ---------------------------------------------------------------------------
# Warm refit
# ---------------------------------------------------------------------------

@dataclass
class RefitResult:
    """Outcome of one successful warm refit."""

    model: Any
    #: kernel builds + library loads + bucket allocations during the refit
    #: (``measure_compiles``: the port's counterpart of the reference's
    #: backend compiles; 0 when warm)
    backend_compiles: int
    prefix_reused: bool
    attempts: int
    seconds: float
    checkpoint_path: Optional[str] = None
    diagnostics: List[Diagnostic] = field(default_factory=list)


class RefitController:
    """Drift-triggered warm refit with the prep stages frozen, on ``device``
    (the CUDA card unless it names another).

    By default only the model-selector estimator refits on the streamed
    window; every other fitted stage (the transform prefix: fills, scalers,
    vectorizers, sanity checker) warm-starts from the last-known-good model,
    so the prefix keeps its content fingerprint and the refit builds and
    loads no kernel — ``prime()`` (run once, e.g. on the first window) runs
    the whole frozen prefix once, loading whatever kernel library the base
    train had not.  Failures retry with bounded exponential backoff; a
    refit that still fails raises :class:`RefitError` and the caller's
    serving model is untouched.

    ``checkpoint_dir`` enables atomic model checkpoints in two steps: each
    refit saves its candidate to a fresh versioned directory
    (:meth:`save_version`), and only a PROMOTED candidate flips the fsync'd
    ``CURRENT`` pointer (:meth:`mark_current` — the ContinualTrainer calls
    it after the swap commits).  A crash anywhere in between, a
    gate-rejected candidate, or a rolled-back promotion all leave
    ``CURRENT`` on the model that was actually serving.
    """

    def __init__(self, base_model, *, refit_uids: Optional[Sequence[str]] = None,
                 max_retries: int = 2, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0,
                 checkpoint_dir: Optional[str] = None,
                 expect_zero_prefix_compiles: bool = True,
                 sleep: Callable[[float], None] = time.sleep, device=None):
        from ..perf.kernels.dispatch import resolve_device

        self.device = resolve_device(device)
        if max_retries < 0 or backoff_base_s <= 0 or backoff_cap_s <= 0:
            raise ValueError("max_retries must be >= 0 and backoff > 0")
        self._base = base_model
        self._features = list(base_model.result_features)
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.checkpoint_dir = checkpoint_dir
        self.expect_zero_prefix_compiles = bool(expect_zero_prefix_compiles)
        self._sleep = sleep
        self._ckpt_seq = 0
        self.refit_uids = set(refit_uids) if refit_uids is not None \
            else self._default_refit_uids(base_model)
        if not self.refit_uids:
            raise ValueError("nothing to refit: the base model has no "
                             "estimator stages (pass refit_uids explicitly)")
        self._rehydrate_selector_shells()
        self.prime_compiles: Optional[int] = None
        #: the last refit's ``Workflow.last_train_profile`` (fits, flushes)
        self.last_train_profile: List[dict] = []

    def rebase(self, model) -> None:
        """Point the controller at a newly promoted base model, keeping its
        configuration (retry/backoff, checkpoint dir, expectations).  The
        frozen prep carries over from the promoted model's fitted stages, so
        the prefix fingerprint — and the zero-compile guarantee — survive
        the generation change."""
        self._base = model
        self._features = list(model.result_features)
        # same DAG, same stage uids: the configured refit set carries over
        self._rehydrate_selector_shells()

    @staticmethod
    def _default_refit_uids(model) -> set:
        """The model selector's uid when present (prep stays frozen), else
        every estimator stage in the DAG."""
        from ..models.selector import SelectedModel
        from ..stages.base import Estimator
        from .dag import all_stages

        selected = {uid for uid, m in model.fitted.items()
                    if isinstance(m, SelectedModel)}
        if selected:
            return selected
        return {s.uid for s in all_stages(model.result_features)
                if isinstance(s, Estimator)}

    def _rehydrate_selector_shells(self) -> None:
        """Make a serde-loaded model refittable.

        Saved estimator stages round-trip as shells (declared params only —
        a loaded model is a scoring artifact), so a loaded ModelSelector has
        no ``models``/``validator`` config.  Rebuild enough to retrain the
        RECORDED WINNER on fresh data: the fitted SelectedModel's summary
        names the winning family, grid, metric, and validation type — which
        is also the right production semantics for a drift refit (retrain
        the winner, don't re-run the full model search on every window)."""
        from ..evaluators import metrics as M
        from ..evaluators.base import (BinaryClassificationEvaluator,
                                       MultiClassificationEvaluator,
                                       RegressionEvaluator)
        from ..models.selector import ModelSelector
        from ..models.tuning import CrossValidator, TrainValidationSplit
        from ..stages.base import STAGE_REGISTRY, EstimatorStub
        from .dag import all_stages

        for stage in all_stages(self._features):
            if stage.uid not in self.refit_uids:
                continue
            if isinstance(stage, EstimatorStub):
                cls = STAGE_REGISTRY.get(stage.estimator_class)
                if cls is None or not issubclass(cls, ModelSelector):
                    continue
                # the port loads an estimator as a stub of its wiring: give
                # it back its class, a shell as the reference's loader makes
                stage.__class__ = cls
                del stage.estimator_class
                stage.last_fit_profile = {}
            elif not isinstance(stage, ModelSelector) \
                    or getattr(stage, "validator", None) is not None:
                continue
            selected = self._base.fitted.get(stage.uid)
            summary = getattr(selected, "summary", None)
            if summary is None or not summary.best_model_name:
                raise ValueError(
                    f"cannot refit loaded selector {stage.uid}: no recorded "
                    "winner in the fitted summary")
            est_cls = STAGE_REGISTRY.get(summary.best_model_name)
            if est_cls is None:
                raise ValueError(
                    f"cannot refit loaded selector {stage.uid}: winning "
                    f"family {summary.best_model_name!r} is not registered")
            metric = summary.metric_name
            if metric in M.METRICS_BINARY:
                ev = BinaryClassificationEvaluator(metric)
            elif metric in M.METRICS_REGRESSION:
                ev = RegressionEvaluator(metric)
            else:
                ev = MultiClassificationEvaluator(metric)
            if summary.validation_type == "TrainValidationSplit":
                validator = TrainValidationSplit(ev)
            else:
                validator = CrossValidator(ev)
            stage.models = [(est_cls(), [dict(summary.best_grid)])]
            stage.validator = validator
            stage.splitter = None  # rebalancing config does not round-trip
            stage.train_evaluators = []
            log.info("rehydrated selector shell %s to refit winner %s %s",
                     stage.uid, summary.best_model_name, summary.best_grid)

    # -- plan-cache priming --------------------------------------------------
    def prime(self, dataset: Dataset) -> int:
        """Run the whole frozen-prefix plan over ``dataset`` once on the
        device, so every kernel library the refit and the shadow plan reach
        is built and loaded before the first refit.  Returns the kernel
        builds and loads paid here (``perf/timers.py::measure_compiles``)."""
        from ..perf import measure_compiles
        from .fit import transform_dag

        with obs_flight.compile_context("continual.prime"), \
                measure_compiles() as probe:
            transform_dag(dataset, self._features, self._base.fitted, self.device)
        self.prime_compiles = probe.backend_compiles
        return self.prime_compiles

    # -- the refit -----------------------------------------------------------
    def refit(self, window: Dataset) -> RefitResult:
        """Warm refit on the streamed ``window`` under bounded retry.

        The window must carry the label column (continuous training streams
        labeled records).  On success returns the candidate model, the
        compile count of the whole train (``perf/timers.py::measure_compiles``:
        kernel builds, library loads and serving-bucket allocations — zero
        when the frozen prefix and the built kernels serve it), and the
        atomic checkpoint path when enabled.  Raises :class:`RefitError` after the
        bounded retries are exhausted — the caller's serving model (and its
        durable checkpoint) are untouched.
        """
        from ..perf import measure_compiles
        from .workflow import Workflow

        t0 = time.monotonic()
        attempt = 0
        last_exc: Optional[BaseException] = None
        while attempt <= self.max_retries:
            try:
                fault_point("refit", rows=window.n_rows, attempt=attempt)
                warm = {uid: m for uid, m in self._base.fitted.items()
                        if uid not in self.refit_uids}
                wf = Workflow().set_result_features(*self._features)
                if getattr(self._base, "workflow_cv", False):
                    wf.with_workflow_cv()
                wf._warm_models = dict(warm)
                # warm-path compile tagging: with a flight recorder
                # installed, any compile in here records as an UNEXPECTED
                # recompile (TM901 — the dynamic twin of TM809)
                with obs_trace.span("continual.refit", cat="continual",
                                    rows=window.n_rows, attempt=attempt), \
                        obs_flight.compile_context(
                            "continual.refit",
                            warm=self.expect_zero_prefix_compiles), \
                        measure_compiles() as probe:
                    model = wf.set_input_dataset(window).train(device=self.device)
                compiles = probe.backend_compiles
                self.last_train_profile = wf.last_train_profile
                ckpt = self.save_version(model) if self.checkpoint_dir \
                    else None
                break
            except Exception as e:  # noqa: BLE001 — bounded retry, then typed
                last_exc = e
                attempt += 1
                if attempt > self.max_retries:
                    diag = make_diagnostic(
                        "TM805",
                        f"warm refit failed after {attempt} attempt(s) "
                        f"({type(e).__name__}: {e}); serving model unchanged")
                    raise RefitError(diag.message, cause=e,
                                     diagnostics=[diag]) from e
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s * (2 ** (attempt - 1)))
                log.warning("refit attempt %d failed (%s: %s); retrying in "
                            "%.3fs", attempt, type(e).__name__, e, delay)
                self._sleep(delay)
        diags: List[Diagnostic] = []
        prefix_reused = self._prefix_reused(window, model)
        if self.expect_zero_prefix_compiles and compiles > 0:
            diags.append(make_diagnostic(
                "TM809",
                f"warm refit performed {compiles} compile(s) (kernel builds, "
                "library loads or bucket allocations); the frozen prefix and "
                "the built kernels were expected to serve this refit at zero"
                + ("" if prefix_reused else
                   " (the prefix fingerprint CHANGED — prep is not frozen)")))
            for d in diags:
                log.warning("%s", d.pretty())
        return RefitResult(model=model, backend_compiles=compiles,
                           prefix_reused=prefix_reused, attempts=attempt + 1,
                           seconds=time.monotonic() - t0,
                           checkpoint_path=ckpt, diagnostics=diags)

    def _prefix_reused(self, window: Dataset, model) -> bool:
        """True when the candidate's whole-table plan has the SAME prefix
        content fingerprint as the base model's — the frozen-prep contract
        that makes the refit (and the later scoring-plan swap) build
        nothing.  Planning only: nothing launches."""
        from .plan import plan_for_features

        try:
            old = plan_for_features(window, self._features, self._base.fitted,
                                    self.device)
            new = plan_for_features(window, model.result_features,
                                    model.fitted, self.device)
        except Exception:  # noqa: BLE001 — advisory only
            return False
        return (old is not None and new is not None
                and old.prefix_fingerprint() == new.prefix_fingerprint())

    # -- atomic checkpoint ---------------------------------------------------
    def save_version(self, model) -> str:
        """Durable versioned save of a candidate (``model-NNNN``) WITHOUT
        touching the ``CURRENT`` pointer — a refit artifact is not
        last-known-good until it actually serves.  Call
        :meth:`mark_current` after the candidate is promoted."""
        fault_point("checkpoint", seq=self._ckpt_seq + 1)
        d = self.checkpoint_dir
        os.makedirs(d, exist_ok=True)
        self._ckpt_seq += 1
        name = f"model-{self._ckpt_seq:04d}"
        model.save(os.path.join(d, name))
        return os.path.join(d, name)

    def mark_current(self, checkpoint_path: str) -> None:
        """Fsync'd CURRENT pointer rename over a completed version save:
        readers following ``CURRENT`` always see a complete, PROMOTED model,
        and a crash anywhere before the rename leaves the previous pointer
        (the serving last-known-good) intact."""
        d = self.checkpoint_dir
        name = os.path.basename(checkpoint_path.rstrip(os.sep))
        tmp = os.path.join(d, "CURRENT.tmp")
        with open(tmp, "w") as fh:
            fh.write(name)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(d, "CURRENT"))

    def clear_current(self) -> None:
        """Remove the CURRENT pointer: no promoted checkpoint is currently
        valid (e.g. the only promotion was rolled back and the pre-swap
        serving model was never checkpointed — the operator's original
        model artifact remains authoritative)."""
        try:
            os.remove(os.path.join(self.checkpoint_dir, "CURRENT"))
        except OSError:
            pass

    @staticmethod
    def load_checkpoint(checkpoint_dir: str):
        """The model the CURRENT pointer names — the last PROMOTED model
        (gate-rejected or rolled-back candidates keep their ``model-NNNN``
        dirs for postmortem but never become CURRENT).

        A zero-byte or whitespace-only CURRENT (a crash between creating the
        pointer file and writing its content — mark_current fsyncs before
        the rename, but hostile filesystems exist) means "no promoted
        checkpoint" and returns None instead of attempting to load the
        checkpoint dir itself as a model."""
        from .workflow import WorkflowModel

        with open(os.path.join(checkpoint_dir, "CURRENT")) as fh:
            name = fh.read().strip()
        if not name:
            log.warning("CURRENT pointer in %s is empty; treating as no "
                        "promoted checkpoint", checkpoint_dir)
            return None
        return WorkflowModel.load(os.path.join(checkpoint_dir, name))


# ---------------------------------------------------------------------------
# Promotion gate
# ---------------------------------------------------------------------------

@dataclass
class PromotionGate:
    """Admission rule for swapping a shadow-scored candidate live.

    ``max_prediction_delta`` bounds the MEAN absolute prediction delta
    between candidate and active over mirrored traffic (None skips the
    bound — under real drift the candidate SHOULD predict differently;
    non-finite deltas always refuse).  ``max_metric_drop`` bounds how far
    the candidate's validation metric may sit below the active model's
    (both from their own training summaries — different windows, so this is
    a sanity bound, not a like-for-like comparison)."""

    min_shadow_records: int = 64
    max_prediction_delta: Optional[float] = None
    max_metric_drop: Optional[float] = None
    require_no_shadow_failures: bool = True

    def check(self, shadow: Mapping[str, Any],
              active_metric: Optional[Tuple[str, float, bool]],
              candidate_metric: Optional[Tuple[str, float, bool]]
              ) -> List[Diagnostic]:
        """Empty list = promote; otherwise TM806 findings explaining why not."""
        reasons: List[str] = []
        if shadow["mirrored_records"] < self.min_shadow_records:
            reasons.append(
                f"only {shadow['mirrored_records']} mirrored record(s) < "
                f"min_shadow_records {self.min_shadow_records}")
        if self.require_no_shadow_failures and shadow["shadow_failures"] > 0:
            reasons.append(
                f"{shadow['shadow_failures']} shadow scoring failure(s)")
        mean_delta = shadow.get("mean_abs_delta")
        max_delta = shadow.get("max_abs_delta")
        if max_delta is not None and not math.isfinite(max_delta):
            reasons.append("non-finite prediction delta on mirrored traffic")
        elif self.max_prediction_delta is not None and mean_delta is not None \
                and mean_delta > self.max_prediction_delta:
            reasons.append(
                f"mean abs prediction delta {mean_delta:.4g} > "
                f"max_prediction_delta {self.max_prediction_delta}")
        if self.max_metric_drop is not None and active_metric is not None \
                and candidate_metric is not None:
            name, active_v, larger = active_metric
            _, cand_v, _ = candidate_metric
            drop = (active_v - cand_v) if larger else (cand_v - active_v)
            if drop > self.max_metric_drop:
                reasons.append(
                    f"candidate {name} regressed by {drop:.4g} > "
                    f"max_metric_drop {self.max_metric_drop}")
        return [make_diagnostic("TM806", "candidate not promoted: " + r)
                for r in reasons]


def best_validation_metric(model) -> Optional[Tuple[str, float, bool]]:
    """(metric name, best mean value, larger_is_better) from the model's
    selector summary, or None when unavailable."""
    try:
        summary = model.summary()
        if summary is None or not summary.validation_results:
            return None
        vals = [ev.mean_metric for ev in summary.validation_results
                if ev.model_uid == summary.best_model_uid
                or summary.best_model_uid == ""]
        vals = [v for v in vals if v is not None and math.isfinite(v)]
        if not vals:
            return None
        best = max(vals) if summary.larger_is_better else min(vals)
        return (summary.metric_name, float(best), summary.larger_is_better)
    except Exception:  # noqa: BLE001 — the gate degrades to delta checks
        return None


# ---------------------------------------------------------------------------
# The control loop
# ---------------------------------------------------------------------------

class ContinualTrainer:
    """Stream -> score -> drift -> warm refit -> shadow -> swap -> rollback.

    Drives a :class:`~..readers.streaming.MicroBatchStreamingReader` through
    a :class:`~..serve.server.ScoringServer`: every batch scores through the
    micro-batcher (mirrored to the shadow plan once a candidate is staged),
    feeds the drift accumulators, and commits its offset after the output
    sink ran.  When drift fires, the :class:`RefitController` retrains on the
    labeled window, the candidate stages for shadow scoring, and the
    :class:`PromotionGate` decides the atomic swap; the server auto-rolls
    back on a post-swap breaker trip.  Exceptions from any phase (including
    injected FaultHarness faults) are counted and the loop keeps serving the
    last-known-good model.

    ``snapshot=None`` bootstraps the drift baseline from the first
    ``bootstrap_records`` streamed rows; pass a train-time
    :class:`TrainingSnapshot` for a true training baseline.  The refit runs
    on the server's plan's device.  ``slo_monitor`` (an
    :class:`~..obs.slo.SloMonitor`, or anything with ``poll``,
    ``diagnostics`` and ``status``) is polled after every streamed batch;
    its new TM902/TM903 findings join the trainer's diagnostics and its
    status is ``metrics()["slo"]``.
    """

    def __init__(self, server, model, reader, *,
                 snapshot: Optional[TrainingSnapshot] = None,
                 detector: Optional[DriftDetector] = None,
                 refit: Optional[RefitController] = None,
                 gate: Optional[PromotionGate] = None,
                 window_records: int = 512,
                 bootstrap_records: int = 256,
                 probation_batches: int = 8,
                 swap_retries: int = 2,
                 drift_params: Optional[Mapping[str, Any]] = None,
                 on_batch: Optional[Callable] = None,
                 refit_enabled: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 slo_monitor=None):
        self._server = server
        #: polled after every streamed batch (``_poll_slo``)
        self._slo_monitor = slo_monitor
        self._slo_diags_seen = 0
        self.refit_enabled = bool(refit_enabled)
        self._model = model
        self._reader = reader
        self._refit = refit
        self._gate = gate or PromotionGate()
        self.window_records = int(window_records)
        self.bootstrap_records = int(bootstrap_records)
        self.probation_batches = int(probation_batches)
        self.swap_retries = int(swap_retries)
        self._drift_params = dict(drift_params or {})
        self._on_batch = on_batch
        self._detector = detector
        if self._detector is None and snapshot is not None:
            self._detector = DriftDetector(snapshot, **self._drift_params)
        self._bootstrap: List[Mapping[str, Any]] = []

        from ..workflow.workflow import dedup_raw_features

        self._raws = dedup_raw_features(model.result_features)
        self._label_name = next(
            (f.name for f in self._raws if f.is_response), None)
        self._window: List[Mapping[str, Any]] = []
        self._last_window_ds: Optional[Dataset] = None
        self._primed = False
        self._swap_attempts = 0
        self._active_metric = best_validation_metric(model)
        #: rollback observation: the server rolls back autonomously (breaker
        #: trip in probation), so the trainer re-syncs its generation state
        #: — and the durable CURRENT pointer — when the counter moves
        swap_m = getattr(server, "swap_metrics", None)
        self._last_rollbacks = int(swap_m().get("rollbacks", 0)) \
            if callable(swap_m) else 0
        self._pre_swap: Optional[Dict[str, Any]] = None
        self._marked_ckpt: Optional[str] = None
        #: bounded control-plane findings log (oldest dropped; totals live
        #: in the counters) — a tail-forever follow process must not leak
        self.diagnostics: List[Diagnostic] = []
        self.max_diagnostics = 512
        self.last_refit: Optional[RefitResult] = None
        # canonical control-plane counters (obs/metrics.py): by default they
        # join the SERVER's registry, so one Prometheus scrape / snapshot
        # line covers serving and continual training together
        if registry is None:
            registry = getattr(server, "registry", None)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._c: Dict[str, Any] = {
            key: self.registry.counter(
                f"tmog_continual_{key}_total",
                canonical_help(f"tmog_continual_{key}_total"))
            for key in ("batches", "records", "record_errors",
                        "drift_evaluations", "drift_events",
                        "refits", "refit_failures",
                        "candidates_staged", "gate_rejections",
                        "promotions", "swap_failures")}
        # per-trainer baseline: registry counters are cumulative for the
        # process (the Prometheus contract), but THIS trainer's counters
        # view — and run(max_batches=) — must start at zero even when a
        # second trainer joins a server whose registry already has counts
        self._c_base: Dict[str, int] = {k: c.value
                                        for k, c in self._c.items()}

    @property
    def counters(self) -> Dict[str, int]:
        """Legacy-alias dict view over the ``tmog_continual_*`` registry
        counters (obs/metrics.py), relative to this trainer's start."""
        return {k: c.value - self._c_base[k] for k, c in self._c.items()}

    # -- the loop ------------------------------------------------------------
    def run(self, max_batches: Optional[int] = None) -> Dict[str, Any]:
        """Consume the stream until it drains (bounded readers) or
        ``max_batches`` land; returns :meth:`metrics`."""
        for ds in self._reader.stream_datasets(self._raws):
            records = list(getattr(self._reader, "last_records", []) or [])
            results = self._score_batch(records)
            if self._on_batch is not None:
                self._on_batch(records, results)
            # output delivered -> the batch's offset is safe to commit
            commit = getattr(self._reader, "commit", None)
            if commit is not None:
                commit()
            self._c["batches"].inc()
            self._c["records"].inc(len(records))
            self._ingest(ds, records)
            self._tick()
            self._poll_slo()
            if max_batches is not None \
                    and self._c["batches"].value \
                    - self._c_base["batches"] >= max_batches:
                break
        return self.metrics()

    # -- scoring -------------------------------------------------------------
    def _score_batch(self, records: Sequence[Mapping[str, Any]]) -> List[Any]:
        from ..serve import QueueFullError

        futures: List[Any] = []
        out: List[Any] = []
        for r in records:
            while True:
                try:
                    futures.append(self._server.submit(r))
                    break
                except QueueFullError:
                    out.append(self._resolve(futures.pop(0)))
        out.extend(self._resolve(f) for f in futures)
        return out

    def _resolve(self, future) -> Any:
        try:
            return future.result()
        except Exception as e:  # noqa: BLE001 — per-record outcome row
            self._c["record_errors"].inc()
            return {"error": str(e), "error_type": type(e).__name__}

    # -- drift bookkeeping ---------------------------------------------------
    def _ingest(self, ds: Dataset, records: Sequence[Mapping[str, Any]]) -> None:
        if self._label_name is not None:
            labeled = [r for r in records if isinstance(r, Mapping)
                       and r.get(self._label_name) is not None]
        else:
            labeled = [r for r in records if isinstance(r, Mapping)]
        self._window.extend(labeled)
        if len(self._window) > self.window_records:
            del self._window[:len(self._window) - self.window_records]
        if self._detector is None:
            # CLI bootstrap mode: anchor the baseline on the stream's head
            self._bootstrap.extend(r for r in records
                                   if isinstance(r, Mapping))
            if len(self._bootstrap) >= self.bootstrap_records:
                base = rows_to_snapshot(self._bootstrap, self._raws)
                self._detector = DriftDetector(base, **self._drift_params)
                self._bootstrap = []
            return
        self._detector.observe(ds)

    # -- the state machine ---------------------------------------------------
    def _tick(self) -> None:
        self._observe_rollback()
        if getattr(self._server, "has_candidate", lambda: False)():
            self._evaluate_candidate()
            return
        if getattr(self._server, "in_probation", lambda: False)():
            return  # settle before considering another refit
        if self._detector is None:
            return
        try:
            with obs_trace.span("continual.drift", cat="continual",
                                records=self._detector.records):
                report = self._detector.evaluate()
        except Exception as e:  # noqa: BLE001 — injected drift faults
            log.warning("drift evaluation failed (%s: %s)",
                        type(e).__name__, e)
            return
        self._c["drift_evaluations"].inc()
        self._note(d for d in report if d.code != "TM804")
        if self.refit_enabled and DriftDetector.drifted(report) \
                and len(self._window) >= min(self.window_records,
                                             self._detector.min_records):
            self._c["drift_events"].inc()
            obs_flight.record_event(
                "drift", codes=sorted({d.code for d in report
                                       if d.code != "TM804"}),
                records=self._detector.records)
            self._refit_and_stage()

    def _observe_rollback(self) -> None:
        """Re-sync the control plane after a server-side rollback.

        The swapper rolls back autonomously (breaker trip in probation) on
        the scoring path; when its rollback counter moves, the trainer must
        stop tracking the rolled-back candidate: restore the pre-swap model
        / metric / drift baseline, rebase the refit controller, and revert
        the durable CURRENT pointer (TM808)."""
        swap = getattr(self._server, "swap_metrics", None)
        if not callable(swap):
            return
        m = swap()
        rollbacks = int(m.get("rollbacks", 0))
        if rollbacks <= self._last_rollbacks:
            self._last_rollbacks = rollbacks
            return
        self._last_rollbacks = rollbacks
        self._note([make_diagnostic(
            "TM808",
            f"server rolled back to model version {m.get('active_version')}"
            "; control-plane state restored to the last-known-good "
            "generation")])
        pre = self._pre_swap
        self._pre_swap = None
        if pre is None:
            return  # manual rollback beyond our retained generation
        self._model = pre["model"]
        self._active_metric = pre["metric"]
        if self._refit is not None:
            self._refit.rebase(self._model)
            if self._refit.checkpoint_dir:
                # CURRENT must name a model that actually serves
                try:
                    if pre["ckpt"]:
                        self._refit.mark_current(pre["ckpt"])
                    else:
                        self._refit.clear_current()
                except Exception as e:  # noqa: BLE001 — pointer only
                    log.warning("CURRENT pointer revert failed (%s: %s)",
                                type(e).__name__, e)
            self._marked_ckpt = pre["ckpt"]
        if self._detector is not None:
            if pre["snapshot"] is not None:
                self._detector.rebase(pre["snapshot"])
            else:
                self._detector.reset()

    def _refit_and_stage(self) -> None:
        from ..readers.base import rows_to_dataset

        if self._refit is None:
            self._refit = RefitController(self._model,
                                          device=self._server.plan.device)
        window_ds = rows_to_dataset(self._window, self._raws)
        try:
            if not self._primed:
                self._refit.prime(window_ds)
                self._primed = True
            result = self._refit.refit(window_ds)
        except Exception as e:  # noqa: BLE001 — serving model untouched
            self._c["refit_failures"].inc()
            if isinstance(e, RefitError):
                self._note(e.diagnostics)
            else:
                self._note([make_diagnostic(
                    "TM805", f"warm refit failed ({type(e).__name__}: {e}); "
                    "serving model unchanged")])
            log.warning("refit failed (%s: %s); serving model unchanged",
                        type(e).__name__, e)
            self._reset_detector()  # re-accumulate before trying again
            return
        self._c["refits"].inc()
        self.last_refit = result
        self._note(result.diagnostics)
        self._last_window_ds = window_ds
        try:
            self._server.stage_candidate(result.model)
        except Exception as e:  # noqa: BLE001 — incompatible candidate
            self._c["refit_failures"].inc()
            log.warning("candidate staging refused (%s: %s)",
                        type(e).__name__, e)
            self._reset_detector()
            return
        self._c["candidates_staged"].inc()
        self._swap_attempts = 0
        self._candidate_model = result.model

    def _evaluate_candidate(self) -> None:
        # readiness from the CHEAP counters first (no backlog drain): the
        # stream loop must not wait on the mirror worker every batch while
        # the candidate is still accumulating.  ATTEMPTED mirrors count —
        # a candidate whose shadow path only ever fails must still reach
        # the gate (and be refused there) instead of mirroring forever.
        m = self._server.swap_metrics()
        attempted = m.get("shadow_mirrored", 0) + m.get("shadow_failures", 0)
        if attempted < self._gate.min_shadow_records:
            return  # keep mirroring
        # gate time: drain the mirror backlog once for a consistent view
        shadow = self._server.shadow_report()
        attempted = shadow["mirrored_records"] + shadow["shadow_failures"]
        if attempted < self._gate.min_shadow_records:
            return
        cand_metric = best_validation_metric(self._candidate_model) \
            if getattr(self, "_candidate_model", None) is not None else None
        with obs_trace.span("continual.gate", cat="continual",
                            mirrored=shadow["mirrored_records"]):
            refusals = self._gate.check(shadow, self._active_metric, cand_metric)
        if refusals:
            self._note(refusals)
            self._c["gate_rejections"].inc()
            self._server.discard_candidate()
            self._reset_detector()
            return
        # retained for the rollback observer: the generation that serves
        # again if the promoted candidate trips its breaker in probation
        pre = {"model": self._model, "metric": self._active_metric,
               "snapshot": self._detector.snapshot
               if self._detector is not None else None,
               "ckpt": self._marked_ckpt}
        try:
            with obs_trace.span("continual.swap", cat="continual"):
                swap = self._server.promote(probation_batches=self.probation_batches)
        except Exception as e:  # noqa: BLE001 — injected swap faults
            self._c["swap_failures"].inc()
            self._swap_attempts += 1
            log.warning("swap failed (%s: %s); still serving the active "
                        "model", type(e).__name__, e)
            if self._swap_attempts > self.swap_retries:
                self._server.discard_candidate()
                self._reset_detector()
            return
        self._c["promotions"].inc()
        self._pre_swap = pre
        self._note([make_diagnostic(
            "TM807",
            f"swap committed: {swap['from'][:12]} -> {swap['to'][:12]} "
            f"(shared prefix executables: {swap['shared_prefix']})")])
        # only NOW does the candidate's checkpoint become last-known-good
        # (the rollback observer reverts it if probation trips)
        if self._refit is not None and self.last_refit is not None \
                and self.last_refit.checkpoint_path:
            try:
                self._refit.mark_current(self.last_refit.checkpoint_path)
                self._marked_ckpt = self.last_refit.checkpoint_path
            except Exception as e:  # noqa: BLE001 — serving already swapped
                log.warning("CURRENT pointer update failed (%s: %s); the "
                            "previous checkpoint remains marked",
                            type(e).__name__, e)
        if getattr(self, "_candidate_model", None) is not None:
            self._model = self._candidate_model
            self._active_metric = cand_metric or self._active_metric
            if self._refit is not None:
                # keep the controller's config; the frozen prep (and with it
                # the prefix fingerprint + zero-compile guarantee) carries
                # over from the promoted model's fitted stages
                self._refit.rebase(self._model)
        if self._detector is not None and self._last_window_ds is not None:
            # the refit window becomes the new drift anchor
            self._detector.rebase(TrainingSnapshot.from_dataset(
                self._last_window_ds, features=self._raws))
        else:
            self._reset_detector()

    def _reset_detector(self) -> None:
        # the detector is None while the CLI bootstrap mode is still
        # anchoring — a staged candidate (embedded stage_candidate callers)
        # must not crash the loop on the guardless deref
        if self._detector is not None:
            self._detector.reset()

    def _note(self, diags) -> None:
        """Record diagnostics, bounded: keep the newest max_diagnostics."""
        self.diagnostics.extend(diags)
        if len(self.diagnostics) > self.max_diagnostics:
            del self.diagnostics[:len(self.diagnostics)
                                 - self.max_diagnostics]

    def _poll_slo(self) -> None:
        """Drive the SLO monitor at stream cadence and fold its new
        TM902/TM903 findings into the trainer's diagnostics."""
        if self._slo_monitor is None:
            return
        self._slo_monitor.poll()
        diags = self._slo_monitor.diagnostics()
        if len(diags) > self._slo_diags_seen:
            self._note(diags[self._slo_diags_seen:])
            self._slo_diags_seen = len(diags)

    # -- observability -------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.counters)
        out["diagnostics_recorded"] = len(self.diagnostics)
        if self._slo_monitor is not None:
            out["slo"] = self._slo_monitor.status()
        if self._detector is not None:
            out["drift"] = {"records": self._detector.records,
                            "features": self._detector.feature_stats()}
        swap = getattr(self._server, "swap_metrics", None)
        if callable(swap):
            out["swap"] = swap()
        if self.last_refit is not None:
            out["last_refit"] = {
                "backend_compiles": self.last_refit.backend_compiles,
                "prefix_reused": self.last_refit.prefix_reused,
                "attempts": self.last_refit.attempts,
                "seconds": round(self.last_refit.seconds, 3),
                "checkpoint": self.last_refit.checkpoint_path,
            }
        return out



def rows_to_snapshot(records: Sequence[Mapping[str, Any]], raw_features,
                     bins: int = 10) -> TrainingSnapshot:
    """Snapshot drift baselines straight from record dicts (the CLI
    bootstrap path): extract the raw columns scoring-style, then snapshot
    the numeric predictors."""
    from ..readers.base import rows_to_dataset

    ds = rows_to_dataset(list(records), raw_features,
                         allow_missing_response=True)
    return TrainingSnapshot.from_dataset(ds, features=raw_features, bins=bins)
