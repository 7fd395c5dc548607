"""Mean fill and z-normalization (counterpart of ``transmogrifai_tpu/ops/scalers.py``,
scoring halves of ``FillMissingWithMeanModel`` and ``StandardScalerModel``).

The fitted constants are Python floats.  The reference's jnp code rounds them
to float32 before the arithmetic (JAX's weak typing), so the device halves
here hand torch float32 tensors, never Python scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.dataset import Column
from ..stages.base import Transformer
from ..types import RealNN
from ._consts import device_const


class FillMissingWithMeanModel(Transformer):
    """Real -> RealNN with the training mean in place of missing values."""

    def __init__(self, mean: float, **kw):
        super().__init__(**kw)
        self.mean = mean

    def device_transform(self, x: torch.Tensor) -> torch.Tensor:
        mean = device_const(self, "mean", self.mean, np.float32, x.device)
        return torch.where(torch.isnan(x), mean, x)

    def transform_columns(self, cols, dataset):
        v = cols[0].values_f64()
        filled = np.where(np.isnan(v), self.mean, v)
        return Column(RealNN, filled, np.ones(len(filled), dtype=np.bool_))


class StandardScalerModel(Transformer):
    """z-normalization ``(x - mean) / std`` in float32."""

    def __init__(self, mean: float, std: float, **kw):
        super().__init__(**kw)
        self.mean = mean
        self.std = std

    def device_transform(self, x: torch.Tensor) -> torch.Tensor:
        """``(x - mean) * (1 / std)``: the reference's ``(x - mean) / std``
        as XLA compiles it into the serving program, where division by the
        baked constant becomes a multiply by its float32 reciprocal (the
        two round differently in the last bit)."""
        mean = device_const(self, "mean", self.mean, np.float32, x.device)
        inv = device_const(self, "inv_std",
                           np.float32(1.0) / np.float32(self.std), np.float32,
                           x.device)
        return (x - mean) * inv

    def transform_columns(self, cols, dataset):
        v = (cols[0].data.astype(np.float64) - self.mean) / self.std
        return Column(RealNN, v, np.ones(len(v), dtype=np.bool_))
