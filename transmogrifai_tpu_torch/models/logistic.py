"""Binary logistic regression, scoring half (counterpart of
``transmogrifai_tpu/models/logistic.py`` ``LogisticRegressionModel``)."""

from __future__ import annotations

import numpy as np

from ..data.dataset import Column
from .base import PredictionModelBase
from .prediction import PredictionColumn


class LogisticRegressionModel(PredictionModelBase):
    def __init__(self, coef: np.ndarray, intercept: float, **kw):
        super().__init__(**kw)
        self.coef = np.asarray(coef, dtype=np.float64)
        self.intercept = float(intercept)

    def predict_column(self, vec: Column) -> PredictionColumn:
        z = vec.data.astype(np.float64) @ self.coef + self.intercept
        p1 = 1.0 / (1.0 + np.exp(-z))
        prob = np.column_stack([1.0 - p1, p1])
        raw = np.column_stack([-z, z])
        return PredictionColumn.classification(raw, prob)
