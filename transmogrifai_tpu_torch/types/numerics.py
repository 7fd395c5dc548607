"""Numeric feature types.  Reference: features/.../types/Numerics.scala, OPNumeric.scala."""

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

    def to_double(self) -> Optional[float]:
        return None if self._value is None else float(self._value)


@register
class Real(OPNumeric):
    """Optional double.  Reference: Numerics.scala `Real`."""

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

    @classmethod
    def _default_non_null(cls) -> float:
        return 0.0


@register
class RealNN(NonNullable, Real):
    """Non-nullable real — the only legal label/response scalar.  Reference: `RealNN`."""

    __slots__ = ()


@register
class Currency(Real):
    __slots__ = ()


@register
class Percent(Real):
    __slots__ = ()


@register
class Integral(OPNumeric):
    """Optional long.  Reference: Numerics.scala `Integral`."""

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

    @classmethod
    def _default_non_null(cls) -> int:
        return 0


@register
class Date(Integral):
    """Epoch-millis date.  Reference: Numerics.scala `Date`."""

    __slots__ = ()


@register
class DateTime(Date):
    __slots__ = ()


@register
class Binary(SingleResponse, OPNumeric):
    """Optional boolean.  Reference: Numerics.scala `Binary`."""

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

    @classmethod
    def _default_non_null(cls) -> bool:
        return False

    def to_double(self) -> Optional[float]:
        return None if self._value is None else float(self._value)
