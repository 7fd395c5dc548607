"""FeatureBuilder — typed factory for raw features (counterpart of
``transmogrifai_tpu/features/builder.py``)::

    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    vec = FeatureBuilder.of("d", OPVector).extract_field().as_predictor()
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Type

from ..types import FeatureType, feature_type_by_name
from .feature import Feature, _NamedExtract, feature_uid
from .generator import FeatureGeneratorStage


class _TypedBuilder:
    """Builder for one named feature of a fixed type."""

    def __init__(self, name: str, ftype: Type[FeatureType]):
        self.name = name
        self.ftype = ftype
        self._extract_fn: Optional[Callable[[Any], Any]] = None

    def extract(self, fn: Callable[[Any], Any]) -> "_TypedBuilder":
        self._extract_fn = fn
        return self

    def extract_field(self, key: Optional[str] = None) -> "_TypedBuilder":
        """Extract a named field from dict or attribute records."""
        self._extract_fn = _NamedExtract(key or self.name)
        return self

    def _build(self, is_response: bool) -> Feature:
        stage = FeatureGeneratorStage(
            extract_fn=self._extract_fn or _NamedExtract(self.name),
            ftype=self.ftype, output_name=self.name, is_response=is_response)
        stage._output_feature = Feature(
            name=self.name, ftype=self.ftype, is_response=is_response,
            origin_stage=stage, uid=feature_uid())
        return stage._output_feature

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        return self._build(is_response=True)


class _FeatureBuilderMeta(type):
    def __getattr__(cls, type_name: str):
        if type_name.startswith("_"):
            raise AttributeError(type_name)
        try:
            ftype = feature_type_by_name(type_name)
        except Exception:
            raise AttributeError(
                f"FeatureBuilder has no feature type {type_name!r}") from None
        return lambda name: _TypedBuilder(name, ftype)


class FeatureBuilder(metaclass=_FeatureBuilderMeta):
    """``FeatureBuilder.<TypeName>(name)`` for every feature type the port has."""

    @staticmethod
    def of(name: str, ftype) -> _TypedBuilder:
        """Builder for ``name`` typed as ``ftype`` (a FeatureType subclass or
        a type name)."""
        if isinstance(ftype, str):
            ftype = feature_type_by_name(ftype)
        elif not (isinstance(ftype, type) and issubclass(ftype, FeatureType)):
            raise TypeError(
                f"ftype must be a FeatureType subclass or type name, got {ftype!r}")
        return _TypedBuilder(name, ftype)
