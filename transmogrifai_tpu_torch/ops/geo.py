"""Geolocation vectorizer (counterpart of ``transmogrifai_tpu/ops/geo.py``):
missing points take the mean of the present ones, plus a null indicator.
Host work, as in the reference.
"""

from __future__ import annotations

import numpy as np

from ..data.dataset import Column
from ..stages.base import Param, SequenceEstimator, Transformer
from ..types import Geolocation, OPVector
from ..utils.vector_metadata import NULL_INDICATOR, VectorColumnMetadata, VectorMetadata


class GeolocationVectorizer(SequenceEstimator):
    sequence_input_type = Geolocation
    output_type = OPVector

    track_nulls = Param(default=True)

    def fit_columns(self, cols, dataset, device):
        fills = []
        for c in cols:
            present = c.present()
            fills.append(c.data[present].mean(axis=0) if present.any() else np.zeros(3))
        return GeolocationVectorizerModel(fills=np.array(fills), track_nulls=self.track_nulls)


class GeolocationVectorizerModel(Transformer):
    sequence_input_type = Geolocation
    output_type = OPVector

    def __init__(self, fills: np.ndarray, track_nulls: bool = True, **kw):
        super().__init__(**kw)
        self.fills = np.asarray(fills, dtype=np.float64)
        self.track_nulls = track_nulls

    def transform_columns(self, cols, dataset):
        blocks = []
        meta_cols = []
        for j, (f, c) in enumerate(zip(self.inputs, cols)):
            present = c.present()
            filled = np.where(present[:, None], c.data, self.fills[j][None, :])
            parts = [filled.astype(np.float32)]
            for d in ("lat", "lon", "accuracy"):
                meta_cols.append(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=f.name, descriptor_value=d))
            if self.track_nulls:
                parts.append((~present).astype(np.float32)[:, None])
                meta_cols.append(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=f.name,
                    indicator_value=NULL_INDICATOR))
            blocks.append(np.hstack(parts))
        meta = VectorMetadata(self.output_name, meta_cols,
                              {f.name: f.history() for f in self.inputs}).reindexed()
        return Column.vector(np.hstack(blocks), meta)
