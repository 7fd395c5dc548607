"""Text feature types (counterpart of ``transmogrifai_tpu/types/text.py``)."""

from __future__ import annotations

from typing import Any, Optional

from .base import Categorical, ColumnKind, FeatureType, FeatureTypeError, register


class Text(FeatureType):
    """Optional string (base of the categorical text types)."""

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
class PickList(Categorical, Text):
    """Single-select categorical string."""

    __slots__ = ()
