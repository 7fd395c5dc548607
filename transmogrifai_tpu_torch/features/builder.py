"""FeatureBuilder — typed factory for raw features (counterpart of
``transmogrifai_tpu/features/builder.py``)::

    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    vec = FeatureBuilder.of("d", OPVector).extract_field().as_predictor()
    amount = FeatureBuilder.Real("amount").extract_field().window(86_400_000) \
        .as_predictor()                      # folded by the aggregate readers
    features, ds = FeatureBuilder.from_dataframe(df, response="survived")

``from_dataframe`` imports pandas inside it, as the reference does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import numpy as np

from ..types import Binary, FeatureType, Integral, Real, RealNN, Text, feature_type_by_name
from .feature import Feature, _NamedExtract, feature_uid
from .generator import FeatureGeneratorStage


def _raw_feature(name: str, ftype: Type[FeatureType], is_response: bool,
                 extract_fn: Optional[Callable[[Any], Any]] = None,
                 aggregator=None, window_ms: Optional[int] = None) -> Feature:
    """A raw feature and its generator stage."""
    stage = FeatureGeneratorStage(
        extract_fn=extract_fn or _NamedExtract(name), ftype=ftype,
        output_name=name, is_response=is_response, aggregator=aggregator,
        aggregate_window_ms=window_ms)
    stage._output_feature = Feature(
        name=name, ftype=ftype, is_response=is_response, origin_stage=stage,
        uid=feature_uid())
    return stage._output_feature


class _TypedBuilder:
    """Builder for one named feature of a fixed type."""

    def __init__(self, name: str, ftype: Type[FeatureType]):
        self.name = name
        self.ftype = ftype
        self._extract_fn: Optional[Callable[[Any], Any]] = None
        self._aggregator = None
        self._window_ms: Optional[int] = None

    def extract(self, fn: Callable[[Any], Any]) -> "_TypedBuilder":
        self._extract_fn = fn
        return self

    def extract_field(self, key: Optional[str] = None) -> "_TypedBuilder":
        """Extract a named field from dict or attribute records."""
        self._extract_fn = _NamedExtract(key or self.name)
        return self

    def aggregate(self, aggregator) -> "_TypedBuilder":
        """Fold a key's events with ``aggregator`` (a MonoidAggregator) in
        the aggregate readers, instead of the type's default."""
        self._aggregator = aggregator
        return self

    def window(self, window_ms: int) -> "_TypedBuilder":
        """Fold only the events within ``window_ms`` of the cutoff."""
        self._window_ms = window_ms
        return self

    def _build(self, is_response: bool) -> Feature:
        return _raw_feature(self.name, self.ftype, is_response, self._extract_fn,
                            self._aggregator, self._window_ms)

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

    # -- schema inference (fromDataFrame/fromSchema equivalents) --------------
    @staticmethod
    def from_dataframe(df, response: Optional[str] = None,
                       response_type: Type[FeatureType] = RealNN,
                       ftypes: Optional[Dict[str, Type[FeatureType]]] = None,
                       ) -> Tuple[List[Feature], "Dataset"]:
        """Infer typed features from a pandas DataFrame; returns (features,
        Dataset).  The response column (if named) becomes a response of
        ``response_type``; the others map by dtype: float -> Real, int ->
        Integral, bool -> Binary, anything else -> Text (or the type
        ``ftypes`` names)."""
        from ..data.dataset import Column, Dataset

        ftypes = dict(ftypes or {})
        features: List[Feature] = []
        cols: Dict[str, Column] = {}
        for name in df.columns:
            series = df[name]
            if name == response:
                ftype, is_response = ftypes.get(name, response_type), True
            else:
                ftype, is_response = ftypes.get(name) or _infer_ftype(series), False
            features.append(_raw_feature(name, ftype, is_response))
            cols[name] = Column.from_values(ftype, _clean_series(series, ftype))
        return features, Dataset(cols)

    @staticmethod
    def from_schema(schema: Dict[str, str], response: Optional[str] = None
                    ) -> List[Feature]:
        """Raw features from a {name: feature type name} mapping."""
        return [_raw_feature(name, feature_type_by_name(tname), name == response)
                for name, tname in schema.items()]


def _infer_ftype(series) -> Type[FeatureType]:
    import pandas as pd

    dt = series.dtype
    if pd.api.types.is_bool_dtype(dt):
        return Binary
    if pd.api.types.is_integer_dtype(dt):
        return Integral
    if pd.api.types.is_float_dtype(dt):
        return Real
    # object columns stay Text: whether to pivot or hash is SmartText's call
    return Text


def _clean_series(series, ftype: Type[FeatureType]) -> List[Any]:
    """A pandas series as python values of ``ftype``: None for NaN, None and
    pd.NA; text as str; integral floats as int."""
    import pandas as pd

    out = []
    for v in series.tolist():
        if v is None or (isinstance(v, float) and np.isnan(v)) or v is pd.NA:
            out.append(None)
        elif ftype.kind.value == "text" and not isinstance(v, str):
            out.append(str(v))
        elif ftype.kind.value == "int" and isinstance(v, float):
            out.append(int(v))
        else:
            out.append(v)
    return out
