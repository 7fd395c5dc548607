"""Map feature types — row-wise Map[String, V].  Reference: features/.../types/Maps.scala:1-424.

24 map types mirroring every scalar/collection type, plus ``Prediction`` (a RealMap with
reserved keys ``prediction`` / ``probability_*`` / ``rawPrediction_*``).
"""

from __future__ import annotations

import numbers
from typing import Any, Dict, List, Set

from .base import ColumnKind, FeatureType, FeatureTypeError, NonNullable, register
from .collections import Geolocation


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

    @classmethod
    def _default_non_null(cls):
        return {}


class _StringMap(OPMap):
    __slots__ = ()

    @classmethod
    def _convert_value(cls, v: Any) -> str:
        if not isinstance(v, str):
            raise FeatureTypeError(f"{cls.__name__} values must be strings, got {v!r}")
        return v


class _DoubleMap(OPMap):
    __slots__ = ()

    @classmethod
    def _convert_value(cls, v: Any) -> float:
        if isinstance(v, bool) or not isinstance(v, numbers.Real):
            raise FeatureTypeError(f"{cls.__name__} values must be numbers, got {v!r}")
        return float(v)


class _LongMap(OPMap):
    __slots__ = ()

    @classmethod
    def _convert_value(cls, v: Any) -> int:
        if isinstance(v, bool) or not isinstance(v, numbers.Integral):
            raise FeatureTypeError(f"{cls.__name__} values must be integers, got {v!r}")
        return int(v)


class _BooleanMap(OPMap):
    __slots__ = ()

    @classmethod
    def _convert_value(cls, v: Any) -> bool:
        if not isinstance(v, bool):
            raise FeatureTypeError(f"{cls.__name__} values must be booleans, got {v!r}")
        return v


class _SetMap(OPMap):
    __slots__ = ()

    @classmethod
    def _convert_value(cls, v: Any) -> Set[str]:
        if isinstance(v, str):
            raise FeatureTypeError(
                f"{cls.__name__} values must be collections of strings, got a bare string"
            )
        out = set(v)
        for x in out:
            if not isinstance(x, str):
                raise FeatureTypeError(f"{cls.__name__} set values must be strings")
        return out


# --- string maps ------------------------------------------------------------

@register
class TextMap(_StringMap):
    __slots__ = ()


@register
class TextAreaMap(_StringMap):
    __slots__ = ()


@register
class EmailMap(_StringMap):
    __slots__ = ()


@register
class URLMap(_StringMap):
    __slots__ = ()


@register
class PhoneMap(_StringMap):
    __slots__ = ()


@register
class IDMap(_StringMap):
    __slots__ = ()


@register
class PickListMap(_StringMap):
    __slots__ = ()


@register
class ComboBoxMap(_StringMap):
    __slots__ = ()


@register
class Base64Map(_StringMap):
    __slots__ = ()


@register
class CountryMap(_StringMap):
    __slots__ = ()


@register
class StateMap(_StringMap):
    __slots__ = ()


@register
class CityMap(_StringMap):
    __slots__ = ()


@register
class PostalCodeMap(_StringMap):
    __slots__ = ()


@register
class StreetMap(_StringMap):
    __slots__ = ()


# --- numeric maps -----------------------------------------------------------

@register
class RealMap(_DoubleMap):
    __slots__ = ()


@register
class CurrencyMap(_DoubleMap):
    __slots__ = ()


@register
class PercentMap(_DoubleMap):
    __slots__ = ()


@register
class IntegralMap(_LongMap):
    __slots__ = ()


@register
class DateMap(_LongMap):
    __slots__ = ()


@register
class DateTimeMap(DateMap):  # DateTimeMap extends DateMap (reference Maps.scala)
    __slots__ = ()


@register
class BinaryMap(_BooleanMap):
    __slots__ = ()


# --- collection maps --------------------------------------------------------

@register
class MultiPickListMap(_SetMap):
    __slots__ = ()


@register
class GeolocationMap(OPMap):
    __slots__ = ()

    @classmethod
    def _convert_value(cls, v: Any) -> List[float]:
        return Geolocation._convert(v)


# --- Prediction -------------------------------------------------------------

@register
class Prediction(NonNullable, _DoubleMap):
    """Model output map with reserved keys.  Reference: Maps.scala `Prediction`.

    Keys: ``prediction`` (required), ``probability_<i>``, ``rawPrediction_<i>``.
    """

    __slots__ = ()

    PredictionName = "prediction"
    RawPredictionName = "rawPrediction"
    ProbabilityName = "probability"

    @classmethod
    def _convert(cls, value: Any) -> Dict[str, float]:
        out = super()._convert(value)
        if cls.PredictionName not in out:
            raise FeatureTypeError(
                f"Prediction map must contain '{cls.PredictionName}' key, got {sorted(out)}"
            )
        for k in out:
            if k == cls.PredictionName:
                continue
            prefix, _, idx = k.rpartition("_")
            if prefix not in (cls.RawPredictionName, cls.ProbabilityName) or not idx.isdigit():
                raise FeatureTypeError(f"Invalid Prediction key: {k!r}")
        return out

    @classmethod
    def make(cls, prediction: float, raw_prediction=None, probability=None) -> "Prediction":
        m: Dict[str, float] = {cls.PredictionName: float(prediction)}
        if raw_prediction is not None:
            raw = list(raw_prediction) if hasattr(raw_prediction, "__iter__") else [raw_prediction]
            for i, v in enumerate(raw):
                m[f"{cls.RawPredictionName}_{i}"] = float(v)
        if probability is not None:
            prob = list(probability) if hasattr(probability, "__iter__") else [probability]
            for i, v in enumerate(prob):
                m[f"{cls.ProbabilityName}_{i}"] = float(v)
        return cls(m)

    @property
    def prediction(self) -> float:
        return self._value[self.PredictionName]

    @property
    def raw_prediction(self) -> List[float]:
        return self._keyed(self.RawPredictionName)

    @property
    def probability(self) -> List[float]:
        return self._keyed(self.ProbabilityName)

    def _keyed(self, prefix: str) -> List[float]:
        items = [
            (int(k.rsplit("_", 1)[1]), v)
            for k, v in self._value.items()
            if k.startswith(prefix + "_")
        ]
        return [v for _, v in sorted(items)]

    def score(self) -> float:
        """Probability of the positive class if present, else the prediction."""
        prob = self.probability
        if prob:
            return prob[-1] if len(prob) == 2 else max(prob)
        return self.prediction
