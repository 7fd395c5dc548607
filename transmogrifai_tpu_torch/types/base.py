"""Feature type system — the port's copy of the reference type hierarchy
(``transmogrifai_tpu/types/base.py``, itself after TransmogrifAI's
FeatureType.scala:44-124, registry :265-324).

The hierarchy serves two roles:

1. A lightweight value wrapper (``Real(1.0)``, ``PickList("a")``) used by extract functions,
   the testkit, and local scoring — cheap ``__slots__`` objects.
2. A *column schema*: each class carries ``kind`` (how a column of this type is stored:
   float/int/bool arrays + validity masks, object arrays on host, or an (n, d) float32
   vector block), the numpy dtype and nullability.  The columnar path is what reaches
   the device; values never cross to it one at a time.
"""

from __future__ import annotations

import enum
from typing import Any, ClassVar, Dict, Optional, Type


def _freeze(v: Any):
    """Recursively convert a value to a hashable form (lists/sets/dicts frozen)."""
    if isinstance(v, (set, frozenset)):
        return frozenset(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


class ColumnKind(enum.Enum):
    """Physical storage class of a column of a given FeatureType.

    Numeric kinds (FLOAT/INT/BOOL) are stored as dense numpy/JAX arrays plus a validity bitmap
    (True = present) so they can be moved straight to HBM.  Host kinds (TEXT/lists/sets/maps)
    live in CPU DRAM as object arrays until a vectorizer turns them into device tensors.
    """

    FLOAT = "float"          # np.float64 values + bool mask
    INT = "int"              # np.int64 values + bool mask
    BOOL = "bool"            # np.bool_ values + bool mask
    TEXT = "text"            # object array of str | None
    TEXT_LIST = "text_list"  # object array of list[str]
    INT_LIST = "int_list"    # object array of list[int]
    TEXT_SET = "text_set"    # object array of set[str]
    MAP = "map"              # object array of dict[str, value]
    GEO = "geo"              # (n, 3) float64 [lat, lon, accuracy] + mask
    VECTOR = "vector"        # (n, d) float32 device array, never null


class FeatureTypeError(TypeError):
    """Raised when a value cannot be converted to the requested FeatureType."""


class NonNullableEmptyException(FeatureTypeError):
    """Raised when a NonNullable feature type is constructed with an empty value."""


class FeatureType:
    """Base of all feature types.  Subclasses set ``kind`` and implement ``_convert``."""

    __slots__ = ("_value",)

    kind: ClassVar[ColumnKind]
    is_nullable: ClassVar[bool] = True
    # mixin markers (reference: NonNullable / Categorical / SingleResponse / MultiResponse / Location)
    is_categorical: ClassVar[bool] = False
    is_single_response: ClassVar[bool] = False
    is_multi_response: ClassVar[bool] = False
    is_location: ClassVar[bool] = False

    def __init__(self, value: Any = None):
        v = self._convert(value)
        if v is None and not self.is_nullable:
            raise NonNullableEmptyException(
                f"{type(self).__name__} cannot be empty"
            )
        self._value = v

    # -- conversion ---------------------------------------------------------
    @classmethod
    def _convert(cls, value: Any) -> Any:
        return value

    # -- accessors ----------------------------------------------------------
    @property
    def value(self) -> Any:
        return self._value

    @property
    def is_empty(self) -> bool:
        v = self._value
        if v is None:
            return True
        if isinstance(v, (list, set, dict, tuple, str)):
            return len(v) == 0
        return False

    @property
    def non_empty(self) -> bool:
        return not self.is_empty

    def exists(self, predicate) -> bool:
        return (not self.is_empty) and bool(predicate(self._value))

    # -- dunder -------------------------------------------------------------
    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and self._value == other._value

    def __hash__(self) -> int:
        return hash((type(self).__name__, _freeze(self._value)))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._value!r})"

    # -- schema helpers -----------------------------------------------------
    @classmethod
    def type_name(cls) -> str:
        return cls.__name__

    @classmethod
    def empty(cls) -> "FeatureType":
        """The default/empty instance of this type (FeatureTypeDefaults equivalent)."""
        return cls(None) if cls.is_nullable else cls(cls._default_non_null())

    @classmethod
    def _default_non_null(cls) -> Any:  # pragma: no cover - overridden
        raise NotImplementedError

    @classmethod
    def is_subtype_of(cls, other: Type["FeatureType"]) -> bool:
        return issubclass(cls, other)


# ---------------------------------------------------------------------------
# Mixins (markers, matching the reference trait names)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Registry — reference FeatureType.scala:265-324
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[FeatureType]] = {}


def register(cls: Type[FeatureType]) -> Type[FeatureType]:
    _REGISTRY[cls.__name__] = cls  # opcheck: allow(TM306) class registration, at import time
    return cls


def feature_type_by_name(name: str) -> Type[FeatureType]:
    """FeatureTypeFactory equivalent: resolve a feature type class from its name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise FeatureTypeError(f"Unknown feature type: {name!r}") from None


def all_feature_types() -> Dict[str, Type[FeatureType]]:
    return dict(_REGISTRY)


def is_feature_type_name(name: str) -> bool:
    return name in _REGISTRY
