"""Small value transformers, the vector slot dropper and the invertible
scalers (counterpart of ``transmogrifai_tpu/ops/misc.py``).

Host stages, copied from the reference: each maps a column's values (or a
vector's slots) on the host and has no device half.  The stages that take a
function (a predicate, a match) save it by registered name or importable
path (``stages/functions.py``), as the reference does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Type

import numpy as np

from ..data.dataset import Column
from ..stages.base import BinaryTransformer, Param, UnaryTransformer
from ..types import Binary, FeatureType, OPVector, Real, RealNN, Text
from ..utils.vector_metadata import VectorColumnMetadata, VectorMetadata


class ExistsTransformer(UnaryTransformer):
    """value -> Binary(predicate(value)) (reference ExistsTransformer.scala:40-49)."""

    input_types = (FeatureType,)
    output_type = Binary

    def __init__(self, predicate: Callable[[Any], bool],
                 input_type: Type[FeatureType] = FeatureType, **kw):
        self.input_types = (input_type,)
        super().__init__(**kw)
        self.predicate = predicate

    def transform_columns(self, cols, dataset):
        vals = cols[0].to_values()
        return Column.from_values(Binary, [bool(self.predicate(v)) for v in vals])


class FilterTransformer(UnaryTransformer):
    """Keep values passing the predicate, else a default (FilterTransformer.scala:39-49)."""

    input_types = (FeatureType,)

    def __init__(self, predicate: Callable[[Any], bool], default: Any,
                 input_type: Type[FeatureType] = FeatureType, **kw):
        self.input_types = (input_type,)
        self.output_type = input_type
        super().__init__(**kw)
        self.predicate = predicate
        self.default = default

    def transform_columns(self, cols, dataset):
        vals = cols[0].to_values()
        out = [v if self.predicate(v) else self.default for v in vals]
        return Column.from_values(self.output_type, out)


class ReplaceTransformer(UnaryTransformer):
    """Replace one value with another (ReplaceTransformer.scala:39-49)."""

    input_types = (FeatureType,)

    old_value = Param(default=None)
    new_value = Param(default=None)

    def __init__(self, input_type: Type[FeatureType] = FeatureType, **kw):
        self.input_types = (input_type,)
        self.output_type = input_type
        super().__init__(**kw)

    def transform_columns(self, cols, dataset):
        vals = cols[0].to_values()
        out = [self.new_value if v == self.old_value else v for v in vals]
        return Column.from_values(self.output_type, out)


class SubstringTransformer(BinaryTransformer):
    """(needle, haystack) -> Binary containment (SubstringTransformer.scala:48-60)."""

    input_types = (Text, Text)
    output_type = Binary

    to_lowercase = Param(default=True)

    def transform_columns(self, cols, dataset):
        subs = cols[0].to_values()
        fulls = cols[1].to_values()
        out: List[Optional[bool]] = []
        for s, f in zip(subs, fulls):
            if s is None or f is None:
                out.append(None)
            elif self.to_lowercase:
                out.append(s.lower() in f.lower())
            else:
                out.append(s in f)
        return Column.from_values(Binary, out)


class ToOccurTransformer(UnaryTransformer):
    """value -> RealNN 1.0/0.0 occurrence flag (ToOccurTransformer.scala).

    Default match: non-empty and, for numerics/booleans, truthy/nonzero.
    """

    input_types = (FeatureType,)
    output_type = RealNN

    def __init__(self, match_fn: Optional[Callable[[Any], bool]] = None,
                 input_type: Type[FeatureType] = FeatureType, **kw):
        self.input_types = (input_type,)
        super().__init__(**kw)
        self.match_fn = match_fn

    @staticmethod
    def _default_match(v: Any) -> bool:
        if v is None:
            return False
        if isinstance(v, bool):
            return v
        if isinstance(v, (int, float)):
            return not math.isnan(float(v)) and float(v) != 0.0
        if isinstance(v, (str, list, set, dict, tuple)):
            return len(v) > 0
        return True

    def transform_columns(self, cols, dataset):
        fn = self.match_fn or self._default_match
        vals = cols[0].to_values()
        out = np.array([1.0 if fn(v) else 0.0 for v in vals])
        return Column(RealNN, out, np.ones(len(out), dtype=np.bool_))


class DropIndicesByTransformer(UnaryTransformer):
    """Drop feature-vector slots whose column metadata matches a predicate.

    Reference: DropIndicesByTransformer.scala:50-90 — e.g. drop all null-indicator
    columns, or all columns of one parent feature, before modeling.
    """

    input_types = (OPVector,)
    output_type = OPVector

    def __init__(self, match_fn: Callable[[VectorColumnMetadata], bool], **kw):
        super().__init__(**kw)
        self.match_fn = match_fn

    def transform_columns(self, cols, dataset):
        col = cols[0]
        meta = col.meta
        if meta is None:
            raise ValueError(
                "DropIndicesByTransformer needs vector metadata on its input column")
        keep = [i for i, cm in enumerate(meta.columns) if not self.match_fn(cm)]
        block = np.asarray(col.data)[:, keep]
        new_meta = VectorMetadata(
            self.output_name, [meta.columns[i] for i in keep], meta.history,
        ).reindexed()
        return Column.vector(block.astype(np.float32), new_meta)


# ---------------------------------------------------------------------------
# Invertible scaling (ScalerTransformer / DescalerTransformer)
# ---------------------------------------------------------------------------

SCALING_TYPES = ("linear", "logarithmic")


def _scale(v: np.ndarray, kind: str, slope: float, intercept: float) -> np.ndarray:
    if kind == "linear":
        return slope * v + intercept
    return np.log(v)


def _descale(v: np.ndarray, kind: str, slope: float, intercept: float) -> np.ndarray:
    if kind == "linear":
        return (v - intercept) / slope
    return np.exp(v)


class ScalerTransformer(UnaryTransformer):
    """Invertible scaling whose args travel with the stage (ScalerTransformer.scala:144+).

    A paired DescalerTransformer recovers the original value — used to model a scaled
    response and descale predictions back to the original units.
    """

    input_types = (Real,)
    output_type = Real

    scaling_type = Param(default="linear", validator=lambda v: v in SCALING_TYPES)
    slope = Param(default=1.0)
    intercept = Param(default=0.0)

    def transform_columns(self, cols, dataset):
        v = cols[0].values_f64()
        out = _scale(v, self.scaling_type, self.slope, self.intercept)
        return Column(Real, out, cols[0].present() & ~np.isnan(out))


class DescalerTransformer(BinaryTransformer):
    """(value, scaled_reference) -> value descaled by the reference's scaler.

    Reference: DescalerTransformer.scala:56-80 reads ScalerMetadata off the second
    input's column metadata; here the scaling args are found on the second input
    feature's origin ScalerTransformer (the metadata carrier in this design).
    """

    input_types = (Real, Real)
    output_type = Real

    def _scaler_of(self, feature) -> ScalerTransformer:
        stage = feature.origin_stage
        if isinstance(stage, ScalerTransformer):
            return stage
        raise ValueError(
            f"DescalerTransformer: input feature {feature.name!r} was not produced by "
            "a ScalerTransformer, so there are no scaling args to invert")

    def transform_columns(self, cols, dataset):
        scaler = self._scaler_of(self.inputs[1])
        v = cols[0].values_f64()
        out = _descale(v, scaler.scaling_type, scaler.slope, scaler.intercept)
        return Column(Real, out, cols[0].present() & ~np.isnan(out))
