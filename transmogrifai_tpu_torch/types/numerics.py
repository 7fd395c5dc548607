"""Numeric feature types (counterpart of ``transmogrifai_tpu/types/numerics.py``)."""

from __future__ import annotations

import numbers
from typing import Any, Optional

from .base import (
    ColumnKind,
    FeatureType,
    FeatureTypeError,
    NonNullable,
    SingleResponse,
    register,
)


class OPNumeric(FeatureType):
    """Abstract numeric type; value is an optional scalar."""

    __slots__ = ()


@register
class Real(OPNumeric):
    """Optional double."""

    __slots__ = ()
    kind = ColumnKind.FLOAT

    @classmethod
    def _convert(cls, value: Any) -> Optional[float]:
        if value is None:
            return None
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        if isinstance(value, numbers.Real):
            return float(value)
        raise FeatureTypeError(f"{cls.__name__} expects a number, got {value!r}")


@register
class RealNN(NonNullable, Real):
    """Non-nullable real — the only legal label/response scalar."""

    __slots__ = ()


@register
class Currency(Real):
    __slots__ = ()


@register
class Percent(Real):
    __slots__ = ()


@register
class Integral(OPNumeric):
    """Optional long."""

    __slots__ = ()
    kind = ColumnKind.INT

    @classmethod
    def _convert(cls, value: Any) -> Optional[int]:
        if value is None:
            return None
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, numbers.Integral):
            return int(value)
        raise FeatureTypeError(f"{cls.__name__} expects an integer, got {value!r}")


@register
class Date(Integral):
    """Epoch-millis date."""

    __slots__ = ()


@register
class DateTime(Date):
    __slots__ = ()


@register
class Binary(SingleResponse, OPNumeric):
    """Optional boolean."""

    __slots__ = ()
    kind = ColumnKind.BOOL

    @classmethod
    def _convert(cls, value: Any) -> Optional[bool]:
        if value is None:
            return None
        if isinstance(value, bool):
            return value
        if isinstance(value, numbers.Real) and float(value) in (0.0, 1.0):
            return bool(value)
        raise FeatureTypeError(f"{cls.__name__} expects a boolean, got {value!r}")
