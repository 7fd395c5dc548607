"""Collection feature types: lists, sets, geolocation and vector
(counterpart of ``transmogrifai_tpu/types/collections.py``)."""

from __future__ import annotations

import numbers
from typing import Any, List, Set

import numpy as np

from .base import (
    ColumnKind,
    FeatureType,
    FeatureTypeError,
    Location,
    MultiResponse,
    register,
)


class OPCollection(FeatureType):
    __slots__ = ()


class OPList(OPCollection):
    __slots__ = ()


@register
class TextList(OPList):
    """List of strings (e.g. tokens)."""

    __slots__ = ()
    kind = ColumnKind.TEXT_LIST

    @classmethod
    def _convert(cls, value: Any) -> List[str]:
        if value is None:
            return []
        if isinstance(value, str):
            raise FeatureTypeError(f"{cls.__name__} expects a sequence of strings")
        out = list(value)
        for v in out:
            if not isinstance(v, str):
                raise FeatureTypeError(f"{cls.__name__} expects strings, got {v!r}")
        return out


@register
class DateList(OPList):
    """List of epoch-millis longs."""

    __slots__ = ()
    kind = ColumnKind.INT_LIST

    @classmethod
    def _convert(cls, value: Any) -> List[int]:
        if value is None:
            return []
        out = []
        for v in value:
            if isinstance(v, bool) or not isinstance(v, numbers.Integral):
                raise FeatureTypeError(f"{cls.__name__} expects integers, got {v!r}")
            out.append(int(v))
        return out


@register
class DateTimeList(DateList):
    __slots__ = ()


class OPSet(OPCollection):
    __slots__ = ()


@register
class MultiPickList(MultiResponse, OPSet):
    """Multi-select categorical: set of strings."""

    __slots__ = ()
    kind = ColumnKind.TEXT_SET

    @classmethod
    def _convert(cls, value: Any) -> Set[str]:
        if value is None:
            return set()
        if isinstance(value, str):
            raise FeatureTypeError(f"{cls.__name__} expects a collection of strings")
        out = set(value)
        for v in out:
            if not isinstance(v, str):
                raise FeatureTypeError(f"{cls.__name__} expects strings, got {v!r}")
        return out


@register
class Geolocation(Location, OPList):
    """(lat, lon, accuracy) triple; accuracy is an integer rank; empty = []."""

    __slots__ = ()
    kind = ColumnKind.GEO

    @classmethod
    def _convert(cls, value: Any) -> List[float]:
        if value is None:
            return []
        vals = [float(v) for v in value]
        if len(vals) == 0:
            return []
        if len(vals) != 3:
            raise FeatureTypeError(
                f"{cls.__name__} expects [lat, lon, accuracy], got {value!r}")
        lat, lon, acc = vals
        if not (-90.0 <= lat <= 90.0):
            raise FeatureTypeError(f"Latitude out of range: {lat}")
        if not (-180.0 <= lon <= 180.0):
            raise FeatureTypeError(f"Longitude out of range: {lon}")
        return [lat, lon, acc]


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
