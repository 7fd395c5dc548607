"""Text feature types.  Reference: features/.../types/Text.scala (305 LoC, 14 subtypes)."""

from __future__ import annotations

from typing import Any, Optional

from .base import (
    ColumnKind,
    FeatureType,
    FeatureTypeError,
    Categorical,
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

    @classmethod
    def _default_non_null(cls) -> str:
        return ""


@register
class TextArea(Text):
    __slots__ = ()


@register
class Email(Text):
    __slots__ = ()

    @property
    def prefix(self) -> Optional[str]:
        p = self._split()
        return p[0] if p else None

    @property
    def domain(self) -> Optional[str]:
        p = self._split()
        return p[1] if p else None

    def _split(self):
        v = self._value
        if not v or "@" not in v:
            return None
        prefix, _, domain = v.partition("@")
        if not prefix or not domain or "@" in domain:
            return None
        return prefix, domain


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
