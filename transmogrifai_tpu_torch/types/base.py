"""Feature type system — the port's copy of the reference type hierarchy.

Counterpart of ``transmogrifai_tpu/types/base.py``.  Each class is both a
cheap value wrapper (``Real(1.0)``) and a column schema: ``kind`` says how a
column of the type is stored (numeric arrays + validity masks, host object
arrays, or an (n, d) float32 vector block).

Only the types the ported slices reach are ported (see ``types/__init__``):
every type but the typed maps.  ``feature_type_by_name`` refuses every other
name, so a saved model using one fails at load time instead of scoring with
a half-built DAG.
"""

from __future__ import annotations

import enum
from typing import Any, ClassVar, Dict, Type


class ColumnKind(enum.Enum):
    """Physical storage class of a column of a given FeatureType."""

    FLOAT = "float"          # np.float64 values + bool mask
    INT = "int"              # np.int64 values + bool mask
    BOOL = "bool"            # np.bool_ values + bool mask
    TEXT = "text"            # object array of str | None
    TEXT_LIST = "text_list"  # object array of list[str]
    INT_LIST = "int_list"    # object array of list[int]
    TEXT_SET = "text_set"    # object array of set[str]
    MAP = "map"              # object array of dict[str, value]
    GEO = "geo"              # (n, 3) float64 [lat, lon, accuracy] + mask
    VECTOR = "vector"        # (n, d) float32 block, never null


class FeatureTypeError(TypeError):
    """Raised when a value cannot be converted to the requested FeatureType."""


class NonNullableEmptyException(FeatureTypeError):
    """Raised when a NonNullable feature type is constructed with an empty value."""


class FeatureType:
    """Base of all feature types.  Subclasses set ``kind`` and implement ``_convert``."""

    __slots__ = ("_value",)

    kind: ClassVar[ColumnKind]
    is_nullable: ClassVar[bool] = True
    # mixin markers (the reference's Categorical / SingleResponse /
    # MultiResponse / Location)
    is_categorical: ClassVar[bool] = False
    is_single_response: ClassVar[bool] = False
    is_multi_response: ClassVar[bool] = False
    is_location: ClassVar[bool] = False

    def __init__(self, value: Any = None):
        v = self._convert(value)
        if v is None and not self.is_nullable:
            raise NonNullableEmptyException(
                f"{type(self).__name__} cannot be empty")
        self._value = v

    @classmethod
    def _convert(cls, value: Any) -> Any:
        return value

    @property
    def value(self) -> Any:
        return self._value

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._value!r})"


class NonNullable:
    is_nullable = False


class Categorical:
    is_categorical = True


class SingleResponse(Categorical):
    is_single_response = True


class MultiResponse(Categorical):
    is_multi_response = True


class Location:
    is_location = True


_REGISTRY: Dict[str, Type[FeatureType]] = {}


def register(cls: Type[FeatureType]) -> Type[FeatureType]:
    _REGISTRY[cls.__name__] = cls
    return cls


def feature_type_by_name(name: str) -> Type[FeatureType]:
    """Resolve a feature type class from its reference name; raises on a name
    the port does not have yet."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise FeatureTypeError(
            f"feature type {name!r} is not ported to transmogrifai_tpu_torch "
            f"yet (ported: {sorted(_REGISTRY)})") from None
