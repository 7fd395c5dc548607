"""Prediction column — dense storage for model outputs (counterpart of
``transmogrifai_tpu/models/prediction.py``).

Predictions stay as arrays: pred (n,), raw (n, k), prob (n, k) -- a
regression column has ``pred`` only, a K-class column K raw and K
probability columns; ``to_values`` builds the reference's ``Prediction`` map
per row.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..data.dataset import Column
from ..types import Prediction


class PredictionColumn(Column):
    __slots__ = ("pred", "raw", "prob")

    def __init__(self, pred: np.ndarray, raw: Optional[np.ndarray] = None,
                 prob: Optional[np.ndarray] = None):
        pred = np.asarray(pred, dtype=np.float64).reshape(-1)
        parts = [pred[:, None]]
        if raw is not None:
            raw = np.asarray(raw, dtype=np.float64)
            parts.append(raw)
        if prob is not None:
            prob = np.asarray(prob, dtype=np.float64)
            parts.append(prob)
        super().__init__(Prediction, np.hstack(parts), None, None)
        self.pred = pred
        self.raw = raw
        self.prob = prob

    @classmethod
    def classification(cls, raw: np.ndarray, prob: np.ndarray) -> "PredictionColumn":
        return cls(np.argmax(prob, axis=1).astype(np.float64), raw, prob)

    @classmethod
    def regression(cls, pred: np.ndarray) -> "PredictionColumn":
        return cls(pred)

    @property
    def score(self) -> np.ndarray:
        """Positive-class probability for binary problems, else the raw
        margin of a two-column model without probabilities, else the
        prediction."""
        if self.prob is not None and self.prob.shape[1] == 2:
            return self.prob[:, 1]
        if self.prob is None and self.raw is not None and self.raw.shape[1] == 2:
            return self.raw[:, 1]
        return self.pred

    def present(self) -> np.ndarray:
        return np.ones(len(self), dtype=np.bool_)

    def to_values(self, ftype=None) -> List[dict]:
        keys = [Prediction.PredictionName]
        if self.raw is not None:
            keys += [f"{Prediction.RawPredictionName}_{j}"
                     for j in range(self.raw.shape[1])]
        if self.prob is not None:
            keys += [f"{Prediction.ProbabilityName}_{j}"
                     for j in range(self.prob.shape[1])]
        return [dict(zip(keys, row)) for row in self.data.tolist()]

    def take(self, indices: np.ndarray) -> "PredictionColumn":
        """The rows at ``indices``, a prediction column still."""
        indices = np.asarray(indices)
        return PredictionColumn(
            self.pred[indices],
            self.raw[indices] if self.raw is not None else None,
            self.prob[indices] if self.prob is not None else None)

    def concat(self, *others: Column) -> "PredictionColumn":
        """This column's rows followed by each of ``others``', in one pass;
        every part must be a prediction column."""
        if not all(isinstance(o, PredictionColumn) for o in others):
            raise TypeError("can only concat PredictionColumns")
        parts = (self,) + others
        return PredictionColumn(
            np.concatenate([p.pred for p in parts]),
            np.concatenate([p.raw for p in parts]) if self.raw is not None else None,
            np.concatenate([p.prob for p in parts]) if self.prob is not None else None)
