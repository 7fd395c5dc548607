"""SelectedModelCombiner: ensemble two model-selector predictions
(counterpart of ``transmogrifai_tpu/models/combiner.py``).

An estimator over (label, prediction1, prediction2) that keeps the better
prediction ("best") or averages the two probability or prediction vectors
with metric-proportional ("weighted") or equal ("equal") weights; the
metrics are the port's evaluators' over the training rows, on the host as
in the reference.
"""

from __future__ import annotations

import numpy as np

from ..data.dataset import Column, Dataset
from ..evaluators.base import (
    BinaryClassificationEvaluator,
    Evaluator,
    MultiClassificationEvaluator,
    RegressionEvaluator,
)
from ..stages.base import Estimator, Param, Transformer
from ..types import Prediction, RealNN
from .prediction import PredictionColumn

STRATEGIES = ("best", "weighted", "equal")


def _default_evaluator(col: PredictionColumn) -> Evaluator:
    """Problem type from the prediction shape (reference reads it from summaries)."""
    if col.prob is not None and col.prob.shape[1] == 2:
        return BinaryClassificationEvaluator()
    if col.prob is not None:
        return MultiClassificationEvaluator()
    return RegressionEvaluator()


def _combine(p1: PredictionColumn, p2: PredictionColumn,
             w1: float, w2: float) -> PredictionColumn:
    if (p1.prob is None) != (p2.prob is None):
        raise ValueError("cannot combine a classifier with a regressor prediction")
    if p1.prob is not None:
        if p1.prob.shape[1] != p2.prob.shape[1]:
            raise ValueError("cannot combine predictions with different class counts")
        prob = w1 * p1.prob + w2 * p2.prob
        raw = prob  # combined log-space raw scores are not meaningful; reuse prob
        return PredictionColumn.classification(raw, prob)
    return PredictionColumn.regression(w1 * p1.pred + w2 * p2.pred)


class SelectedModelCombiner(Estimator):
    """(label, pred1, pred2) -> combined Prediction."""

    input_types = (RealNN, Prediction, Prediction)
    output_type = Prediction
    allow_label_as_input = True

    combination_strategy = Param(default="best", validator=lambda v: v in STRATEGIES)
    metric = Param(default=None, doc="evaluator metric name; None = problem default")

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

    def fit_columns(self, cols, dataset, device):
        label, c1, c2 = cols
        y = label.values_f64()
        p1 = _as_prediction(c1)
        p2 = _as_prediction(c2)
        ev = _default_evaluator(p1)
        if self.metric:
            ev = type(ev)(self.metric)
        name = ev.default_metric
        m1 = ev.evaluate_arrays(y, p1).get(name, 0.0)
        m2 = ev.evaluate_arrays(y, p2).get(name, 0.0)
        strategy = self.combination_strategy
        if strategy == "equal":
            w1 = w2 = 0.5
        elif strategy == "weighted":
            if not ev.larger_is_better:
                # invert so the better (smaller) metric gets the larger weight
                m1, m2 = 1.0 / max(m1, 1e-12), 1.0 / max(m2, 1e-12)
            total = m1 + m2
            w1 = m1 / total if total > 0 else 0.5
            w2 = 1.0 - w1
        else:  # best
            better1 = (m1 >= m2) if ev.larger_is_better else (m1 <= m2)
            w1, w2 = (1.0, 0.0) if better1 else (0.0, 1.0)
        return SelectedCombinerModel(
            weight1=float(w1), weight2=float(w2), strategy=strategy,
            metric_name=name, metric1=float(m1), metric2=float(m2),
        )


class SelectedCombinerModel(Transformer):
    input_types = (RealNN, Prediction, Prediction)
    output_type = Prediction
    allow_label_as_input = True

    def __init__(self, weight1: float, weight2: float, strategy: str,
                 metric_name: str = "", metric1: float = 0.0, metric2: float = 0.0,
                 **kw):
        super().__init__(**kw)
        self.weight1 = weight1
        self.weight2 = weight2
        self.strategy = strategy
        self.metric_name = metric_name
        self.metric1 = metric1
        self.metric2 = metric2

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

    def transform(self, dataset: Dataset) -> Dataset:
        # label may be absent at scoring time
        c1 = dataset[self.inputs[1].name]
        c2 = dataset[self.inputs[2].name]
        out = _combine(_as_prediction(c1), _as_prediction(c2),
                       self.weight1, self.weight2)
        return dataset.with_column(self.output_name, out)

    def transform_columns(self, cols, dataset):
        return _combine(_as_prediction(cols[1]), _as_prediction(cols[2]),
                        self.weight1, self.weight2)


def _as_prediction(col: Column) -> PredictionColumn:
    if isinstance(col, PredictionColumn):
        return col
    # rebuild the dense layout from row maps (e.g. after a serde round-trip)
    values = col.to_values()
    pred = np.array([v.get(Prediction.PredictionName, 0.0) for v in values])
    n_raw = sum(1 for k in (values[0] or {}) if k.startswith(f"{Prediction.RawPredictionName}_"))
    n_prob = sum(1 for k in (values[0] or {}) if k.startswith(f"{Prediction.ProbabilityName}_"))
    raw = (np.array([[v[f"{Prediction.RawPredictionName}_{j}"] for j in range(n_raw)]
                     for v in values]) if n_raw else None)
    prob = (np.array([[v[f"{Prediction.ProbabilityName}_{j}"] for j in range(n_prob)]
                      for v in values]) if n_prob else None)
    return PredictionColumn(pred, raw, prob)
