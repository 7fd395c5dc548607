"""Prediction map type (counterpart of ``transmogrifai_tpu/types/maps.py``)."""

from __future__ import annotations

import numbers
from typing import Any, Dict

from .base import ColumnKind, FeatureType, FeatureTypeError, NonNullable, register


class OPMap(FeatureType):
    __slots__ = ()
    kind = ColumnKind.MAP

    @classmethod
    def _convert_value(cls, v: Any) -> Any:
        return v

    @classmethod
    def _convert(cls, value: Any) -> Dict[str, Any]:
        if value is None:
            return {}
        if not isinstance(value, dict):
            raise FeatureTypeError(f"{cls.__name__} expects a dict, got {value!r}")
        out = {}
        for k, v in value.items():
            if not isinstance(k, str):
                raise FeatureTypeError(f"{cls.__name__} keys must be strings, got {k!r}")
            out[k] = cls._convert_value(v)
        return out


@register
class Prediction(NonNullable, OPMap):
    """Model output map with reserved keys ``prediction``,
    ``rawPrediction_<i>`` and ``probability_<i>``."""

    __slots__ = ()

    PredictionName = "prediction"
    RawPredictionName = "rawPrediction"
    ProbabilityName = "probability"

    @classmethod
    def _convert_value(cls, v: Any) -> float:
        if isinstance(v, bool) or not isinstance(v, numbers.Real):
            raise FeatureTypeError(f"{cls.__name__} values must be numbers, got {v!r}")
        return float(v)

    @classmethod
    def _convert(cls, value: Any) -> Dict[str, float]:
        out = super()._convert(value)
        if cls.PredictionName not in out:
            raise FeatureTypeError(
                f"Prediction map must contain '{cls.PredictionName}' key, got {sorted(out)}")
        return out
