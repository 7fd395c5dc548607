"""Model stage base, scoring only (counterpart of ``transmogrifai_tpu/models/base.py``).

A fitted model maps (label RealNN, features OPVector) to a Prediction.  The
head runs on the host in float64 numpy, as in the reference: its input is the
device prefix's float32 vector brought back to the host.
"""

from __future__ import annotations

from ..data.dataset import Column, Dataset
from ..stages.base import Transformer
from .prediction import PredictionColumn


class PredictionModelBase(Transformer):
    """Fitted model transformer: scores the feature vector; the label input
    may be absent."""

    def predict_column(self, vec: Column) -> PredictionColumn:
        raise NotImplementedError

    def transform(self, dataset: Dataset) -> Dataset:
        vec = dataset[self.inputs[1].name]
        return dataset.with_column(self.output_name, self.predict_column(vec))

    def transform_columns(self, cols, dataset):
        return self.predict_column(cols[-1])
