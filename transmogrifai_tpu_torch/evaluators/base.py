"""Evaluators — metric suites per problem type (counterpart of
``transmogrifai_tpu/evaluators/base.py``): binary classification (with its
threshold curves), multiclass classification, regression, forecast and
calibration by bins.

The device metrics (binary, regression) run in float32 torch on the tensors'
device, as the reference's are float32 XLA; the multiclass, forecast and bin
score suites are the reference's float64 numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import Dataset
from ..models.prediction import PredictionColumn
from . import metrics as M


class Evaluator:
    """Base evaluator: a named default metric and a full metric dict."""

    default_metric: str = ""
    problem: str = ""

    @property
    def larger_is_better(self) -> bool:
        return self.default_metric in M.LARGER_IS_BETTER

    def metric_fn(self):
        """(scores, y, w) tensors -> scalar tensor, used by CV sweeps."""
        raise NotImplementedError

    def evaluate_arrays(self, y: np.ndarray, pred: PredictionColumn,
                        w: Optional[np.ndarray] = None) -> Dict[str, float]:
        raise NotImplementedError

    def evaluate(self, ds: Dataset, label_name: str, pred_name: str,
                 w: Optional[np.ndarray] = None) -> Dict[str, float]:
        """Metrics of the prediction column ``pred_name`` against the label
        column ``label_name`` of a scored dataset."""
        y = ds[label_name].data.astype(np.float64)
        pred = ds[pred_name]
        if not isinstance(pred, PredictionColumn):
            raise TypeError(f"column {pred_name!r} is not a prediction column")
        return self.evaluate_arrays(y, pred, w)


class BinaryClassificationEvaluator(Evaluator):
    """AuROC, AuPR, precision/recall/F1/error at 0.5 and confusion counts."""

    problem = "binary"

    def __init__(self, metric: str = "auPR", num_thresholds: int = 0):
        if metric not in M.METRICS_BINARY:
            raise ValueError(f"unknown binary metric {metric!r}; "
                             f"have {sorted(M.METRICS_BINARY)}")
        self.default_metric = metric
        #: > 0 adds the thresholds / precision / recall / fpr curves
        self.num_thresholds = int(num_thresholds)

    def metric_fn(self):
        return M.METRICS_BINARY[self.default_metric]

    def evaluate_arrays(self, y, pred, w=None) -> Dict[str, float]:
        """Metrics of a host prediction column, computed in float32 on the
        host (the reference's precision), with the threshold curves where
        ``num_thresholds`` asks for them."""
        w = np.ones_like(y) if w is None else w
        score, y32, w32 = _f32(pred.score), _f32(y), _f32(w)
        out = self.evaluate_device(score, _f32(pred.pred), y32, w32)
        if self.num_thresholds > 0:
            curves = M.threshold_curves(score, y32, w32, self.num_thresholds)
            for k, v in zip(("thresholds", "precisionByThreshold",
                             "recallByThreshold", "falsePositiveRateByThreshold"),
                            curves):
                out[k] = v.numpy().tolist()
        return out

    def evaluate_device(self, score, pred, y, w) -> Dict[str, float]:
        """All ten point metrics from aligned 1-D tensors on one device, with
        one host copy."""
        vals = M.binary_summary(score, pred, y, w).cpu().numpy()
        return dict(zip(M.BINARY_SUMMARY_KEYS, (float(v) for v in vals)))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


class MultiClassificationEvaluator(Evaluator):
    """Weighted precision / recall / F1 / error, the confusion matrix, top-N
    accuracy and, with ``thresholds``, the reference's threshold metrics:
    per (top N, threshold) the weight of correct, incorrect and withheld
    predictions (the largest probability below the threshold)."""

    problem = "multiclass"

    def __init__(self, metric: str = "error", top_ns=(1, 3), thresholds=()):
        self.default_metric = metric
        self.top_ns = top_ns
        self.thresholds = tuple(thresholds)

    def metric_fn(self):
        if self.default_metric == "error":
            return M.multiclass_error
        raise ValueError(f"no device metric {self.default_metric!r} for multiclass")

    def evaluate_arrays(self, y, pred, w=None) -> Dict[str, float]:
        w = np.ones_like(y) if w is None else w
        yi = y.astype(np.int64)
        prob = pred.prob
        n_classes = prob.shape[1]
        phat = np.argmax(prob, axis=1)
        conf = np.zeros((n_classes, n_classes))
        np.add.at(conf, (yi, phat), w)
        sw = w.sum()
        per_class_tp = np.diag(conf)
        per_class_pred = conf.sum(axis=0)
        per_class_true = conf.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec_c = np.where(per_class_pred > 0, per_class_tp / per_class_pred, 0.0)
            rec_c = np.where(per_class_true > 0, per_class_tp / per_class_true, 0.0)
            f1_c = np.where(prec_c + rec_c > 0,
                            2 * prec_c * rec_c / (prec_c + rec_c), 0.0)
        class_w = per_class_true / sw
        out = {
            "precision": float((prec_c * class_w).sum()),
            "recall": float((rec_c * class_w).sum()),
            "f1": float((f1_c * class_w).sum()),
            "error": float(1.0 - per_class_tp.sum() / sw),
            "confusion": conf.tolist(),
        }
        order = np.argsort(-prob, axis=1)
        hits = {topn: (order[:, :topn] == yi[:, None]).any(axis=1)
                for topn in self.top_ns}
        for topn in self.top_ns:
            out[f"top{topn}_accuracy"] = float((w * hits[topn]).sum() / sw)
        if self.thresholds:
            max_prob = prob.max(axis=1)
            tm = {"topNs": list(self.top_ns), "thresholds": list(self.thresholds),
                  "correctCounts": {}, "incorrectCounts": {},
                  "noPredictionCounts": {}}
            for topn in self.top_ns:
                hit = hits[topn]
                cc, ic, npred = [], [], []
                for t in self.thresholds:
                    predicted = max_prob >= t
                    cc.append(float((w * (predicted & hit)).sum()))
                    ic.append(float((w * (predicted & ~hit)).sum()))
                    npred.append(float((w * ~predicted).sum()))
                tm["correctCounts"][topn] = cc
                tm["incorrectCounts"][topn] = ic
                tm["noPredictionCounts"][topn] = npred
            out["thresholdMetrics"] = tm
        return out


class RegressionEvaluator(Evaluator):
    """RMSE, MSE, MAE, R2 and SMAPE of the prediction, in float32."""

    problem = "regression"

    def __init__(self, metric: str = "rmse"):
        if metric not in M.METRICS_REGRESSION:
            raise ValueError(f"unknown regression metric {metric!r}; "
                             f"have {sorted(M.METRICS_REGRESSION)}")
        self.default_metric = metric

    def metric_fn(self):
        return M.METRICS_REGRESSION[self.default_metric]

    def evaluate_arrays(self, y, pred, w=None) -> Dict[str, float]:
        w = np.ones_like(y) if w is None else w
        vals = M.regression_summary(_f32(pred.pred), _f32(y), _f32(w)).numpy()
        return dict(zip(M.REGRESSION_SUMMARY_KEYS, (float(v) for v in vals)))


class ForecastEvaluator(RegressionEvaluator):
    """The regression metrics plus MASE and the seasonal naive error."""

    problem = "forecast"

    def __init__(self, metric: str = "smape", seasonal_period: int = 1):
        super().__init__(metric)
        self.seasonal_period = seasonal_period

    def evaluate_arrays(self, y, pred, w=None) -> Dict[str, float]:
        out = super().evaluate_arrays(y, pred, w)
        m = self.seasonal_period
        if len(y) > m:
            naive_mae = np.abs(y[m:] - y[:-m]).mean()
            pred_mae = np.abs(pred.pred - y).mean()
            out["mase"] = float(pred_mae / max(naive_mae, 1e-12))
            out["seasonalError"] = float(naive_mae)
        return out


@dataclass
class BinScoreMetrics:
    """The bin score suite's fields, by the reference's names."""

    bin_centers: list = field(default_factory=list)
    bin_counts: list = field(default_factory=list)
    bin_avg_scores: list = field(default_factory=list)
    bin_avg_labels: list = field(default_factory=list)
    brier_score: float = 0.0


class BinScoreEvaluator(Evaluator):
    """Calibration by score bins and the Brier score."""

    problem = "binary"
    default_metric = "brierScore"

    def __init__(self, num_bins: int = 100):
        self.num_bins = num_bins

    def evaluate_arrays(self, y, pred, w=None) -> Dict[str, float]:
        if pred.prob is None:
            raise ValueError(
                "BinScoreEvaluator needs probability outputs; this model emits only "
                "raw margins (e.g. LinearSVC) — calibrate it first")
        w = np.ones_like(y) if w is None else w
        s = pred.score
        bins = np.clip((s * self.num_bins).astype(int), 0, self.num_bins - 1)
        counts = np.bincount(bins, weights=w, minlength=self.num_bins)
        sum_scores = np.bincount(bins, weights=w * s, minlength=self.num_bins)
        sum_labels = np.bincount(bins, weights=w * y, minlength=self.num_bins)
        nz = counts > 0
        return {
            "brierScore": float((w * (s - y) ** 2).sum() / w.sum()),
            "binCenters": ((np.arange(self.num_bins) + 0.5) / self.num_bins)[nz].tolist(),
            "binCounts": counts[nz].tolist(),
            "binAvgScores": np.divide(sum_scores, counts, out=np.zeros_like(counts),
                                      where=nz)[nz].tolist(),
            "binAvgLabels": np.divide(sum_labels, counts, out=np.zeros_like(counts),
                                      where=nz)[nz].tolist(),
        }


class Evaluators:
    """Factory mirroring the reference's ``Evaluators``."""

    @staticmethod
    def binary_classification(metric: str = "auPR") -> BinaryClassificationEvaluator:
        return BinaryClassificationEvaluator(metric)

    @staticmethod
    def multi_classification(metric: str = "error") -> MultiClassificationEvaluator:
        return MultiClassificationEvaluator(metric)

    @staticmethod
    def regression(metric: str = "rmse") -> RegressionEvaluator:
        return RegressionEvaluator(metric)

    @staticmethod
    def forecast(metric: str = "smape", seasonal_period: int = 1) -> ForecastEvaluator:
        return ForecastEvaluator(metric, seasonal_period)

    @staticmethod
    def bin_score(num_bins: int = 100) -> BinScoreEvaluator:
        return BinScoreEvaluator(num_bins)
