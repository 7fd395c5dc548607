"""Text feature types (counterpart of ``transmogrifai_tpu/types/text.py``)."""

from __future__ import annotations

from typing import Any, Optional

from .base import (
    Categorical,
    ColumnKind,
    FeatureType,
    FeatureTypeError,
    Location,
    register,
)


@register
class Text(FeatureType):
    """Optional string."""

    __slots__ = ()
    kind = ColumnKind.TEXT

    @classmethod
    def _convert(cls, value: Any) -> Optional[str]:
        if value is None:
            return None
        if isinstance(value, str):
            return value
        raise FeatureTypeError(f"{cls.__name__} expects a string, got {value!r}")


@register
class TextArea(Text):
    __slots__ = ()


@register
class Email(Text):
    __slots__ = ()


@register
class URL(Text):
    __slots__ = ()


@register
class Phone(Text):
    __slots__ = ()


@register
class ID(Text):
    __slots__ = ()


@register
class Base64(Text):
    __slots__ = ()


@register
class PickList(Categorical, Text):
    """Single-select categorical string."""

    __slots__ = ()


@register
class ComboBox(Text):
    __slots__ = ()


@register
class Country(Location, Text):
    __slots__ = ()


@register
class State(Location, Text):
    __slots__ = ()


@register
class City(Location, Text):
    __slots__ = ()


@register
class PostalCode(Location, Text):
    __slots__ = ()


@register
class Street(Location, Text):
    __slots__ = ()
