"""Mean fill, z-normalization, the fixed-split bucketizer and the
percentile calibrator (counterpart of ``transmogrifai_tpu/ops/scalers.py``:
``FillMissingWithMean``, ``StandardScaler``, ``NumericBucketizer``,
``PercentileCalibrator`` and their models).

The fits are host float64 numpy, as in the reference.  The fitted constants
are Python floats.  The reference's jnp code rounds them
to float32 before the arithmetic (JAX's weak typing), so the device halves
here hand torch float32 tensors, never Python scalars.

``NumericBucketizer``'s device half is a left-closed bucketize slot of the
encode kernel (``perf/kernels/encode.py``), so a prefix encodes it in the
same launch as every other one-hot and bucketize slot; the reference
computes it in plain XLA.  ``PercentileCalibratorModel``'s device half is an
index, not a one-hot, and stays a torch op, as the reference's is XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..data.dataset import Column
from ..perf.kernels import encode as KE
from ..stages.base import Param, UnaryEstimator, UnaryTransformer
from ..types import OPNumeric, OPVector, RealNN
from ..utils.vector_metadata import NULL_INDICATOR, VectorColumnMetadata, VectorMetadata
from ._consts import device_const


class FillMissingWithMean(UnaryEstimator):
    """Real -> RealNN with train-mean imputation."""

    input_types = (OPNumeric,)
    output_type = RealNN

    default_value = Param(default=0.0, doc="fill when the training column is all-empty")

    def fit_columns(self, cols, dataset, device):
        v = cols[0].values_f64()
        ok = ~np.isnan(v)
        mean = float(v[ok].mean()) if ok.any() else float(self.default_value)
        return FillMissingWithMeanModel(mean=mean)


class FillMissingWithMeanModel(UnaryTransformer):
    """Real -> RealNN with the training mean in place of missing values."""

    input_types = (OPNumeric,)
    output_type = RealNN

    def __init__(self, mean: float, **kw):
        super().__init__(**kw)
        self.mean = mean

    def device_transform(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``where(isnan(x), float32(mean), x)``: its
        float32 constant is strongly typed, so a bf16 ``x`` (a reduced
        serving class) comes out float32 there; torch's 0-dim tensors do not
        promote, so the port widens ``x`` itself."""
        mean = device_const(self, "mean", self.mean, np.float32, x.device)
        if x.dtype != torch.float32:
            x = x.to(torch.promote_types(x.dtype, torch.float32))
        return torch.where(torch.isnan(x), mean, x)

    def transform_columns(self, cols, dataset):
        v = cols[0].values_f64()
        filled = np.where(np.isnan(v), self.mean, v)
        return Column(RealNN, filled, np.ones(len(filled), dtype=np.bool_))


class StandardScaler(UnaryEstimator):
    """z-normalization (reference OpScalarStandardScaler)."""

    input_types = (RealNN,)
    output_type = RealNN

    with_mean = Param(default=True)
    with_std = Param(default=True)

    def fit_columns(self, cols, dataset, device):
        v = cols[0].data.astype(np.float64)
        mean = float(v.mean()) if self.with_mean else 0.0
        std = float(v.std())
        if not self.with_std or std < 1e-12:
            std = 1.0
        return StandardScalerModel(mean=mean, std=std)


class StandardScalerModel(UnaryTransformer):
    """z-normalization ``(x - mean) / std`` in float32."""

    input_types = (RealNN,)
    output_type = RealNN

    def __init__(self, mean: float, std: float, **kw):
        super().__init__(**kw)
        self.mean = mean
        self.std = std

    def device_transform(self, x: torch.Tensor) -> torch.Tensor:
        """``(x - mean) * (1 / std)``: the reference's ``(x - mean) / std``
        as XLA compiles it into the serving program, where division by the
        baked constant becomes a multiply by its float32 reciprocal (the
        two round differently in the last bit)."""
        if x.dtype == torch.bfloat16:
            return self._bf16_transform(x)
        mean = device_const(self, "mean", self.mean, np.float32, x.device)
        inv = device_const(self, "inv_std",
                           np.float32(1.0) / np.float32(self.std), np.float32,
                           x.device)
        return (x - mean) * inv

    def _bf16_transform(self, x: torch.Tensor) -> torch.Tensor:
        """A bf16 ``x`` (a reduced serving class), as XLA compiles the
        reference's ``(x - mean) / std`` for it: the weakly typed constants
        become bf16, the subtraction is rounded to bf16, and the division
        becomes a float32 multiply by the reciprocal of the bf16 ``std``,
        rounded to bf16.  torch would round a 0-dim float32 factor to bf16
        first, so the float32 steps are written out."""
        mean16 = torch.tensor(self.mean, dtype=torch.float64).to(torch.bfloat16).item()  # opcheck: allow(TM301) a host scalar: a CPU tensor of a Python float, rounded to bf16
        std16 = torch.tensor(self.std, dtype=torch.float64).to(torch.bfloat16).item()  # opcheck: allow(TM301) a host scalar: a CPU tensor of a Python float, rounded to bf16
        inv = float(np.float32(1.0) / np.float32(std16))
        d = (x.to(torch.float32) - mean16).to(torch.bfloat16)
        return (d.to(torch.float32) * inv).to(torch.bfloat16)

    def transform_columns(self, cols, dataset):
        v = (cols[0].data.astype(np.float64) - self.mean) / self.std
        return Column(RealNN, v, np.ones(len(v), dtype=np.bool_))


class NumericBucketizer(UnaryTransformer):
    """Fixed-split bucketizer -> one-hot OPVector over the left-closed
    buckets ``[s[i], s[i+1])`` (the last one closed on both sides), then the
    optional invalid and null columns.  Out-of-range values fall into the
    nearest edge bucket unless ``track_invalid`` gives them their own
    column; +-inf counts as present."""

    input_types = (OPNumeric,)
    output_type = OPVector

    splits = Param(default=(-np.inf, 0.0, np.inf))
    track_nulls = Param(default=True)
    track_invalid = Param(default=False)

    def device_slot_specs(self) -> Optional[Tuple[KE.SlotSpec, ...]]:
        return (KE.bucketize_slot(self.splits, self.track_nulls,
                                  self.track_invalid, closed="left"),)

    def device_transform(self, x: torch.Tensor) -> torch.Tensor:
        """The left-closed bucketize one-hot of ``x`` (float32, NaN for
        missing): one slot of the encode kernel on the card, its plain
        version on the CPU."""
        # a bf16 ``x`` (a reduced serving class) compares exactly as its
        # float32 widening, as the reference's float32 splits promote it
        return KE.encode_slots([x.to(torch.float32)],
                               KE.slot_table(self.device_slot_specs()))

    def transform_columns(self, cols, dataset):
        f = self.inputs[0]
        splits = np.asarray(self.splits, dtype=np.float64)
        v = cols[0].values_f64()
        ok = ~np.isnan(v)
        n = len(v)
        n_buckets = len(splits) - 1
        in_range = ok & (v >= splits[0]) & (v <= splits[-1])
        invalid = ok & ~in_range
        idx = np.clip(np.searchsorted(splits, np.nan_to_num(v), side="right") - 1,
                      0, n_buckets - 1)
        width = n_buckets + (1 if self.track_invalid else 0) \
            + (1 if self.track_nulls else 0)
        block = np.zeros((n, width), dtype=np.float32)
        block[np.arange(n)[in_range], idx[in_range]] = 1.0
        meta_cols = [
            VectorColumnMetadata(f.name, f.ftype.__name__, grouping=f.name,
                                 indicator_value=f"{splits[i]}-{splits[i + 1]}")
            for i in range(n_buckets)
        ]
        col_at = n_buckets
        if self.track_invalid:
            block[invalid, col_at] = 1.0
            meta_cols.append(VectorColumnMetadata(
                f.name, f.ftype.__name__, grouping=f.name,
                indicator_value="OutOfBounds"))
            col_at += 1
        else:
            # out-of-range values land in the nearest edge bucket
            block[np.arange(n)[invalid], idx[invalid]] = 1.0
        if self.track_nulls:
            block[~ok, col_at] = 1.0
            meta_cols.append(VectorColumnMetadata(
                f.name, f.ftype.__name__, grouping=f.name,
                indicator_value=NULL_INDICATOR))
        meta = VectorMetadata(self.output_name, meta_cols,
                              {f.name: f.history().to_dict()}).reindexed()
        return Column.vector(block, meta)


class PercentileCalibrator(UnaryEstimator):
    """Map a score into [0, buckets - 1] percentile buckets."""

    input_types = (RealNN,)
    output_type = RealNN

    buckets = Param(default=100)

    def fit_columns(self, cols, dataset, device):
        v = cols[0].data.astype(np.float64)
        qs = np.quantile(v, np.linspace(0, 1, self.buckets + 1))
        return PercentileCalibratorModel(splits=qs)


class PercentileCalibratorModel(UnaryTransformer):
    """A score's percentile bucket: the count of inner quantile edges at or
    below it."""

    input_types = (RealNN,)
    output_type = RealNN

    def __init__(self, splits: np.ndarray, **kw):
        super().__init__(**kw)
        self.splits = np.asarray(splits, dtype=np.float64)

    def device_transform(self, x: torch.Tensor) -> torch.Tensor:
        """The bucket index as float32: ``searchsorted(inner, x,
        right=True)`` over the float32 inner edges, clipped to [0, S], as
        the reference's XLA (a score within one float32 ulp of an edge can
        land one bucket off the float64 host path, there too)."""
        inner = device_const(self, "inner", self.splits[1:-1], np.float32, x.device)
        idx = torch.searchsorted(inner, x.contiguous(), right=True)
        return idx.clamp(0, int(inner.shape[0])).to(torch.float32)

    def transform_columns(self, cols, dataset):
        v = cols[0].data.astype(np.float64)
        idx = np.clip(np.searchsorted(self.splits[1:-1], v, side="right"),
                      0, len(self.splits) - 2)
        return Column(RealNN, idx.astype(np.float64),
                      np.ones(len(v), dtype=np.bool_))
