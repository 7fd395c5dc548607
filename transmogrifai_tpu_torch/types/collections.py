"""Collection feature types: lists, sets, geolocation, vector.

Reference: features/.../types/Lists.scala, Sets.scala, Geolocation.scala:1-206, OPVector.scala.
"""

from __future__ import annotations

import math
import numbers
from typing import Any, List, Optional, Set

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

    @classmethod
    def _default_non_null(cls):
        return []


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

    @classmethod
    def _default_non_null(cls):
        return []


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

    @classmethod
    def _default_non_null(cls):
        return set()


@register
class Geolocation(Location, OPList):
    """(lat, lon, accuracy) triple.  Reference: Geolocation.scala:1-206.

    accuracy is an integer rank (reference GeolocationAccuracy enum ordinal); empty = [].
    """

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
                f"{cls.__name__} expects [lat, lon, accuracy], got {value!r}"
            )
        lat, lon, acc = vals
        if not (-90.0 <= lat <= 90.0):
            raise FeatureTypeError(f"Latitude out of range: {lat}")
        if not (-180.0 <= lon <= 180.0):
            raise FeatureTypeError(f"Longitude out of range: {lon}")
        return [lat, lon, acc]

    @classmethod
    def _default_non_null(cls):
        return []

    @property
    def lat(self) -> Optional[float]:
        return self._value[0] if self._value else None

    @property
    def lon(self) -> Optional[float]:
        return self._value[1] if self._value else None

    @property
    def accuracy(self) -> Optional[float]:
        return self._value[2] if self._value else None

    def to_unit_sphere(self) -> Optional[np.ndarray]:
        """Project to 3-D unit-sphere coordinates (used by the geo vectorizer)."""
        if self.is_empty:
            return None
        lat, lon = math.radians(self._value[0]), math.radians(self._value[1])
        return np.array(
            [math.cos(lat) * math.cos(lon), math.cos(lat) * math.sin(lon), math.sin(lat)]
        )


@register
class OPVector(OPCollection):
    """Dense/sparse numeric vector — the universal model-input type.

    Values are 1-D float arrays; the columnar path stores a whole column as a single
    (n, d) device array with attached vector metadata (see utils/vector_metadata.py).
    """

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

    @classmethod
    def _default_non_null(cls):
        return np.zeros((0,), dtype=np.float32)

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and np.array_equal(self._value, other._value)

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._value.tobytes()))

    @property
    def is_empty(self) -> bool:
        return self._value.size == 0
