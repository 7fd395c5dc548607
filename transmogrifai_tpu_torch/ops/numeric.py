"""Numeric vectorizers: imputation + null tracking (counterpart of
``transmogrifai_tpu/ops/numeric.py``).

A group of same-typed numeric features becomes one (n, N) block, or (n, 2N)
with a null indicator after each value slot.  ``NumericVectorizer`` fits the
fills on the host in float64 numpy, as the reference does (mean, mode or a
constant), so fitted states come out bitwise equal.  The device halves take
the canonical float32-with-NaN lift of each input and run as plain torch
ops; the fills enter them rounded to float32, as the reference's program
bakes them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..data.dataset import Column
from ..stages.base import Param, SequenceEstimator, SequenceTransformer, Transformer
from ..types import Binary, OPNumeric, OPVector, RealNN
from ..utils.vector_metadata import NULL_INDICATOR, VectorColumnMetadata, VectorMetadata
from ._consts import device_const


def _stack_f64(cols: List[Column]) -> np.ndarray:
    return np.column_stack([c.values_f64() for c in cols])


def _numeric_meta(stage, track_nulls: bool) -> VectorMetadata:
    cols = []
    for f in stage.inputs:
        cols.append(VectorColumnMetadata(f.name, f.ftype.__name__))
        if track_nulls:
            cols.append(VectorColumnMetadata(f.name, f.ftype.__name__,
                                             grouping=f.name,
                                             indicator_value=NULL_INDICATOR))
    meta = VectorMetadata(stage.output_name, cols,
                          {f.name: f.history().to_dict() for f in stage.inputs})
    return meta.reindexed()


def _emit(values: np.ndarray, isnan: Optional[np.ndarray], meta: VectorMetadata) -> Column:
    """Interleave per-feature [value, null_indicator] columns into one block."""
    n, N = values.shape
    if isnan is None:
        return Column.vector(values.astype(np.float32), meta)
    out = np.empty((n, 2 * N), dtype=np.float32)
    out[:, 0::2] = values
    out[:, 1::2] = isnan
    return Column.vector(out, meta)


def _device_interleave(values: torch.Tensor, isnan: torch.Tensor) -> torch.Tensor:
    """[v0, n0, v1, n1, ...] slot interleave of two (n, N) blocks."""
    n, N = values.shape
    return torch.stack([values, isnan.to(values.dtype)], dim=2).reshape(n, 2 * N)


class NumericVectorizer(SequenceEstimator):
    """Impute (mean/mode/constant) + optional null indicators for nullable numerics."""

    sequence_input_type = OPNumeric
    output_type = OPVector

    fill_strategy = Param(default="mean", doc="mean | mode | constant",
                          validator=lambda v: v in ("mean", "mode", "constant"))
    fill_constant = Param(default=0.0)
    track_nulls = Param(default=True)

    def fit_columns(self, cols, dataset, device):
        x = _stack_f64(cols)
        if self.fill_strategy == "constant":
            fills = np.full(x.shape[1], float(self.fill_constant))
        elif self.fill_strategy == "mode":
            fills = np.array([_col_mode(x[:, j]) for j in range(x.shape[1])])
        else:
            with np.errstate(invalid="ignore"):
                fills = np.nan_to_num(np.nanmean(x, axis=0), nan=0.0)
        return NumericVectorizerModel(fills=fills, track_nulls=self.track_nulls)


def _col_mode(v: np.ndarray) -> float:
    """The most frequent present value (the smallest among ties), 0 when
    every value is missing."""
    v = v[~np.isnan(v)]
    if v.size == 0:
        return 0.0
    vals, counts = np.unique(v, return_counts=True)
    return float(vals[np.argmax(counts)])


class NumericVectorizerModel(Transformer):
    """Fill missing values with the fitted fills, plus optional null indicators."""

    sequence_input_type = OPNumeric
    output_type = OPVector

    def __init__(self, fills: np.ndarray, track_nulls: bool = True, **kw):
        super().__init__(**kw)
        self.fills = np.asarray(fills, dtype=np.float64)
        self.track_nulls = track_nulls

    def device_transform(self, *xs: torch.Tensor) -> torch.Tensor:
        x = torch.stack(xs, dim=1)
        nan = torch.isnan(x)
        fills = device_const(self, "fills", self.fills, np.float32, x.device)
        filled = torch.where(nan, fills, x)
        if not self.track_nulls:
            return filled
        return _device_interleave(filled, nan)

    def transform_columns(self, cols, dataset):
        x = _stack_f64(cols)
        nan = np.isnan(x)
        filled = np.where(nan, self.fills[None, :], x)
        meta = _numeric_meta(self, self.track_nulls)
        return _emit(filled, nan.astype(np.float32) if self.track_nulls else None, meta)


class RealNNVectorizer(SequenceTransformer):
    """Non-nullable reals: direct passthrough into the vector."""

    sequence_input_type = RealNN
    output_type = OPVector

    def device_transform(self, *xs: torch.Tensor) -> torch.Tensor:
        return torch.stack(xs, dim=1)

    def transform_columns(self, cols, dataset):
        x = np.column_stack([c.data.astype(np.float64) for c in cols])
        return _emit(x, None, _numeric_meta(self, track_nulls=False))


class BinaryVectorizer(SequenceTransformer):
    """Booleans -> {0,1} + null indicator (missing treated as 0)."""

    sequence_input_type = Binary
    output_type = OPVector

    track_nulls = Param(default=True)

    def device_transform(self, *xs: torch.Tensor) -> torch.Tensor:
        x = torch.stack(xs, dim=1)
        absent = torch.isnan(x)
        vals = torch.where(absent, torch.zeros((), dtype=x.dtype, device=x.device), x)
        if not self.track_nulls:
            return vals
        return _device_interleave(vals, absent)

    def transform_columns(self, cols, dataset):
        vals = np.column_stack([c.data.astype(np.float64) for c in cols])
        present = np.column_stack([c.present() for c in cols])
        vals = np.where(present, vals, 0.0)
        meta = _numeric_meta(self, self.track_nulls)
        isnan = (~present).astype(np.float32) if self.track_nulls else None
        return _emit(vals, isnan, meta)
