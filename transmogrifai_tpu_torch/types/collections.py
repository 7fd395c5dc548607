"""Vector feature type (counterpart of ``transmogrifai_tpu/types/collections.py``)."""

from __future__ import annotations

from typing import Any

import numpy as np

from .base import ColumnKind, FeatureType, FeatureTypeError, register


class OPCollection(FeatureType):
    __slots__ = ()


@register
class OPVector(OPCollection):
    """Numeric vector — the universal model-input type.  A column of it is
    one (n, d) float32 block with attached vector metadata."""

    __slots__ = ()
    kind = ColumnKind.VECTOR
    is_nullable = False

    @classmethod
    def _convert(cls, value: Any) -> np.ndarray:
        if value is None:
            return np.zeros((0,), dtype=np.float32)
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim != 1:
            raise FeatureTypeError(f"{cls.__name__} expects a 1-D vector")
        return arr
