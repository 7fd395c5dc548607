"""Data preparation (the holdout splitter, the binary balancer, the
multiclass label cutter) and validation (k-fold CV and one train/validation
split); counterpart of ``transmogrifai_tpu/models/tuning.py``.

Fold membership and class rebalancing are sample weights over one fixed row
block, as in the reference: the numpy draws are the reference's, so both
packages see the same folds.  ``validate`` launches every family's sweep on
the device before it reads any metric (phase 1), then gathers them in launch
order (phase 2); it times both phases per family on the host clock
(``family_seconds``).  The reference's sweep journal, mesh, fault points and
resilience ladder are not ported: a family that raises is logged and left
out of selection, as the reference does without them.  A kernel's or the
device's failure (``dispatch.is_kernel_fault``) is not the family's and
raises.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..evaluators.base import Evaluator
from ..perf.kernels import dispatch
from .base import PredictionEstimatorBase

log = logging.getLogger(__name__)


@dataclass
class PrepSummary:
    kind: str = "none"
    details: Dict[str, Any] = field(default_factory=dict)


class DataSplitter:
    """Reserve a test fraction (zero training weight); no label-based prep."""

    def __init__(self, reserve_test_fraction: float = 0.0, seed: int = 42):
        self.reserve_test_fraction = reserve_test_fraction
        self.seed = seed
        self.holdout_mask: Optional[np.ndarray] = None

    def prepare(self, y: np.ndarray) -> Tuple[np.ndarray, PrepSummary]:
        w, details = self._holdout_weights(y)
        return w, PrepSummary("DataSplitter", details)

    def _holdout_weights(self, y: np.ndarray) -> Tuple[np.ndarray, Dict[str, Any]]:
        f = float(self.reserve_test_fraction)
        if f > 0.0:
            rng = np.random.default_rng(self.seed)
            self.holdout_mask = rng.random(len(y)) < f
            w = np.where(self.holdout_mask, 0.0, 1.0).astype(np.float32)
            return w, {"reserveTestFraction": f,
                       "holdoutRows": int(self.holdout_mask.sum())}
        self.holdout_mask = None
        return np.ones_like(y, dtype=np.float32), {}


class DataBalancer(DataSplitter):
    """Binary-label rebalancing by sample weights: the majority is weighted
    down until the minority's weighted fraction reaches ``sample_fraction``."""

    def __init__(self, sample_fraction: float = 0.1, seed: int = 42,
                 reserve_test_fraction: float = 0.0):
        super().__init__(reserve_test_fraction, seed)
        self.sample_fraction = sample_fraction

    def prepare(self, y: np.ndarray) -> Tuple[np.ndarray, PrepSummary]:
        base, holdout_details = self._holdout_weights(y)
        train_rows = base > 0.0
        pos = float(((y == 1.0) & train_rows).sum())
        neg = float(train_rows.sum()) - pos
        n = pos + neg
        summary = PrepSummary("DataBalancer", {
            "positiveCount": pos, "negativeCount": neg,
            "sampleFraction": self.sample_fraction, **holdout_details})
        if pos == 0 or neg == 0 or n == 0:
            return base, summary
        small, big = (pos, neg) if pos <= neg else (neg, pos)
        small_is_pos = pos <= neg
        if small / n >= self.sample_fraction:
            return base, summary
        target_big = small * (1.0 - self.sample_fraction) / self.sample_fraction
        big_w = target_big / big
        w = np.ones(len(y), dtype=np.float32)
        if small_is_pos:
            w[y != 1.0] = big_w
        else:
            w[y == 1.0] = big_w
        summary.details["downSampleFraction"] = big_w
        return (w * base).astype(np.float32), summary


class DataCutter(DataSplitter):
    """Multiclass label pruning: labels rarer than ``min_label_fraction`` of
    the training rows get weight 0, and past ``max_label_categories`` only
    the most frequent are kept (``labelsKept`` / ``labelsDropped``)."""

    def __init__(self, min_label_fraction: float = 0.0, max_label_categories: int = 100,
                 seed: int = 42, reserve_test_fraction: float = 0.0):
        super().__init__(reserve_test_fraction, seed)
        self.min_label_fraction = min_label_fraction
        self.max_label_categories = max_label_categories

    def prepare(self, y: np.ndarray) -> Tuple[np.ndarray, PrepSummary]:
        base, holdout_details = self._holdout_weights(y)
        train_y = y[base > 0.0]
        labels, counts = np.unique(train_y, return_counts=True)
        fracs = counts / max(len(train_y), 1)
        keep = fracs >= self.min_label_fraction
        if keep.sum() > self.max_label_categories:
            order = np.argsort(-counts)
            keep = np.zeros_like(keep)
            keep[order[: self.max_label_categories]] = True
        kept_labels = set(labels[keep].tolist())
        w = np.array([1.0 if v in kept_labels else 0.0 for v in y], dtype=np.float32)
        summary = PrepSummary("DataCutter", {
            "labelsKept": sorted(kept_labels),
            "labelsDropped": sorted(set(labels.tolist()) - kept_labels),
            **holdout_details})
        return (w * base).astype(np.float32), summary


@dataclass
class ModelEvaluation:
    model_name: str
    model_uid: str
    grid: Dict[str, Any]
    metric_name: str
    metric_values: List[float]          # per fold
    mean_metric: float = 0.0

    def __post_init__(self):
        finite = [v for v in self.metric_values if np.isfinite(v)]
        self.mean_metric = float(np.mean(finite)) if finite else float("nan")


@dataclass
class ValidationResult:
    evaluations: List[ModelEvaluation]
    best_index: int
    #: families whose every (grid, fold) metric was non-finite
    failed_models: List[str] = field(default_factory=list)
    #: family -> host seconds of its launch and its gather
    family_seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def best(self) -> ModelEvaluation:
        return self.evaluations[self.best_index]


def sweep_families(models: Sequence[Tuple[PredictionEstimatorBase,
                                           List[Dict[str, Any]]]],
                   x: np.ndarray, y: np.ndarray, train_w: np.ndarray,
                   val_w: np.ndarray, metric_fn, device
                   ) -> Tuple[List[np.ndarray], Dict[str, float]]:
    """Every family's (grid, fold) metric matrix over the folds of
    ``train_w`` / ``val_w`` (k, n): each family's sweep is launched on the
    device before any metric is read, then gathered in launch order.  A
    family that raises is logged and scores NaN; a kernel's or the device's
    fault raises.  Returns (matrices, host seconds by family)."""
    seconds: Dict[str, float] = {}
    launched = []
    for est, grids in models:
        grids = grids or [{}]
        name = type(est).__name__
        t0 = time.perf_counter()
        try:
            gather = est.cv_sweep_async(x, y, train_w, val_w, grids,
                                        metric_fn, device)
        except Exception as e:
            if dispatch.is_kernel_fault(e):
                raise
            log.warning("model %s failed in CV launch (%s); excluded from "
                        "selection", name, e)
            gather = None
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        launched.append((name, grids, gather))
    out: List[np.ndarray] = []
    for name, grids, gather in launched:
        t0 = time.perf_counter()
        scores = np.full((len(grids), train_w.shape[0]), np.nan)
        if gather is not None:
            try:
                scores = np.asarray(gather(), dtype=np.float64)
            except Exception as e:
                if dispatch.is_kernel_fault(e):
                    raise
                log.warning("model %s failed in CV (%s); excluded from "
                            "selection", name, e)
        seconds[name] += time.perf_counter() - t0
        out.append(scores)
    return out, seconds


class CrossValidator:
    """k-fold CV over (estimator, grid) pairs; grids with non-finite metrics
    on any fold lose to grids evaluated on every fold."""

    def __init__(self, evaluator: Evaluator, num_folds: int = 3, seed: int = 42,
                 stratify: bool = False):
        self.evaluator = evaluator
        self.num_folds = num_folds
        self.seed = seed
        self.stratify = stratify

    def fold_weights(self, y: np.ndarray, base_w: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(train_w, val_w) of shape (k, n) from fold assignment."""
        n = len(y)
        rng = np.random.default_rng(self.seed)
        if self.stratify:
            fold_id = np.empty(n, dtype=np.int64)
            for lbl in np.unique(y):
                idx = np.flatnonzero(y == lbl)
                idx = rng.permutation(idx)
                fold_id[idx] = np.arange(len(idx)) % self.num_folds
        else:
            fold_id = rng.permutation(n) % self.num_folds
        k = self.num_folds
        train_w = np.zeros((k, n), dtype=np.float32)
        val_w = np.zeros((k, n), dtype=np.float32)
        for f in range(k):
            in_val = fold_id == f
            train_w[f] = np.where(in_val, 0.0, base_w)
            val_w[f] = np.where(in_val, base_w, 0.0)
        return train_w, val_w

    def validate(self, models: Sequence[Tuple[PredictionEstimatorBase,
                                              List[Dict[str, Any]]]],
                 x: np.ndarray, y: np.ndarray, base_w: Optional[np.ndarray],
                 device) -> ValidationResult:
        base_w = np.ones_like(y, dtype=np.float32) if base_w is None else base_w
        train_w, val_w = self.fold_weights(y, base_w)
        scores, seconds = sweep_families(models, x, y, train_w, val_w,
                                         self.evaluator.metric_fn(), device)
        return self.result(models, scores, seconds)

    def result(self, models, scores: List[np.ndarray],
               seconds: Dict[str, float]) -> ValidationResult:
        """The ValidationResult of per-family (grid, fold) metric matrices:
        one evaluation per (family, grid), the families whose every metric
        is non-finite listed as failed."""
        evaluations: List[ModelEvaluation] = []
        failed: List[str] = []
        for (est, grids), sc in zip(models, scores):
            name = type(est).__name__
            if not np.isfinite(sc).any():
                failed.append(name)
                log.error("model family %s produced no finite CV metric; it "
                          "did not compete in selection", name)
            for gi, grid in enumerate(grids or [{}]):
                evaluations.append(ModelEvaluation(
                    model_name=name, model_uid=est.uid, grid=grid,
                    metric_name=self.evaluator.default_metric,
                    metric_values=[float(v) for v in sc[gi]]))
        return ValidationResult(evaluations, self._best_index(evaluations),
                                failed, seconds)

    def _best_index(self, evaluations: List[ModelEvaluation]) -> int:
        sign = 1.0 if self.evaluator.larger_is_better else -1.0

        def key(i: int):
            ev = evaluations[i]
            n_ok = sum(1 for v in ev.metric_values if np.isfinite(v))
            mean = ev.mean_metric if np.isfinite(ev.mean_metric) else -np.inf * sign
            return (n_ok, sign * mean)

        if not evaluations:
            raise ValueError("no models to validate")
        return max(range(len(evaluations)), key=key)


class TrainValidationSplit(CrossValidator):
    """One split: each row validates with probability 1 - ``train_ratio``
    (a numpy draw from ``seed``, the reference's)."""

    def __init__(self, evaluator: Evaluator, train_ratio: float = 0.75, seed: int = 42,
                 stratify: bool = False):
        super().__init__(evaluator, num_folds=1, seed=seed, stratify=stratify)
        self.train_ratio = train_ratio

    def fold_weights(self, y, base_w):
        rng = np.random.default_rng(self.seed)
        in_val = rng.random(len(y)) >= self.train_ratio
        train_w = np.where(in_val, 0.0, base_w)[None, :].astype(np.float32)
        val_w = np.where(in_val, base_w, 0.0)[None, :].astype(np.float32)
        return train_w, val_w
