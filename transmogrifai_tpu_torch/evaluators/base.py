"""Evaluators — metric suites per problem type (counterpart of
``transmogrifai_tpu/evaluators/base.py``; the binary-classification
evaluator of this slice)."""

from __future__ import annotations

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
        if num_thresholds:
            raise NotImplementedError(
                "threshold curves are not ported to transmogrifai_tpu_torch yet")
        self.default_metric = metric
        self.num_thresholds = 0

    def metric_fn(self):
        return M.METRICS_BINARY[self.default_metric]

    def evaluate_arrays(self, y, pred, w=None) -> Dict[str, float]:
        """Metrics of a host prediction column, computed in float32 on the
        host (the reference's precision)."""
        w = np.ones_like(y) if w is None else w

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32))

        return self.evaluate_device(t(pred.score), t(pred.pred), t(y), t(w))

    def evaluate_device(self, score, pred, y, w) -> Dict[str, float]:
        """All ten point metrics from aligned 1-D tensors on one device, with
        one host copy."""
        vals = M.binary_summary(score, pred, y, w).cpu().numpy()
        return dict(zip(M.BINARY_SUMMARY_KEYS, (float(v) for v in vals)))


class Evaluators:
    """Factory mirroring the reference's ``Evaluators``."""

    @staticmethod
    def binary_classification(metric: str = "auPR") -> BinaryClassificationEvaluator:
        return BinaryClassificationEvaluator(metric)
