"""Selected model, scoring half (counterpart of ``transmogrifai_tpu/models/selector.py``
``SelectedModel``).  The selection itself (cross-validation over a grid) waits
for the training slice; a loaded model scores with its recorded winner."""

from __future__ import annotations

from ..data.dataset import Column
from .base import PredictionModelBase
from .prediction import PredictionColumn


class SelectedModel(PredictionModelBase):
    """The winning fitted model + selection summary (loaded as plain data)."""

    def __init__(self, model: PredictionModelBase, summary=None,
                 feature_meta=None, **kw):
        super().__init__(**kw)
        self.model = model
        self.summary = summary
        self.feature_meta = feature_meta

    def predict_column(self, vec: Column) -> PredictionColumn:
        return self.model.predict_column(vec)
