"""Map and list plumbing: key filtering, value-transformer lifting and the
date-map circles (counterpart of ``transmogrifai_tpu/ops/collections_lift.py``).

``FilterMap`` keeps or drops map keys and empty values; ``LiftToMap`` and
``LiftToList`` run any ported value-level transformer over every map value
or list element in one batched call; ``DateMapToUnitCircleVectorizer``
places each key's date on the unit circle per time period.  Host work, as
in the reference: strings never reach the device, and the date-map
vectorizer's dense (n, keys x periods x 2) float32 block is its output.
"""

from __future__ import annotations

from typing import List, Optional, Type

import numpy as np

from ..data.dataset import Column, Dataset
from ..stages.base import (
    Param,
    SequenceEstimator,
    Transformer,
    UnaryTransformer,
)
from ..types import FeatureType, OPList, OPMap, OPVector
from ..types.maps import DateMap
from ..utils.vector_metadata import VectorColumnMetadata, VectorMetadata
from .dates import _PERIOD_SIZE, _period_values, TIME_PERIODS


class FilterMap(UnaryTransformer):
    """OPMap -> OPMap with key white/black-listing and empty-value dropping.

    Reference FilterMap semantics: whiteListKeys keeps only those keys,
    blackListKeys removes keys, filterEmpty drops None/empty values.
    """

    input_types = (OPMap,)
    output_type = OPMap

    white_list_keys = Param(default=())
    black_list_keys = Param(default=())
    filter_empty = Param(default=True)

    def _output_ftype(self) -> Type[FeatureType]:
        return self.inputs[0].ftype  # same concrete map type in as out

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        white = set(self.white_list_keys or ())
        black = set(self.black_list_keys or ())
        out = np.empty(len(cols[0]), dtype=object)
        for i, m in enumerate(cols[0].data):
            kept = {}
            for k, v in (m or {}).items():
                if white and k not in white:
                    continue
                if k in black:
                    continue
                if self.filter_empty and (v is None or v == "" or v == set()
                                          or v == [] or v == {}):
                    continue
                kept[k] = v
            out[i] = kept
        return Column(self._output_ftype(), out)


def _lift_apply(inner: Transformer, values: List, value_type: Type[FeatureType]):
    """Run a value-level transformer over a flat value list in ONE batched call.

    The inner stage must be a value transformer whose transform_columns depends
    only on its input columns (math/text/misc scalar stages qualify).
    """
    if not values:
        return []
    ds = Dataset.from_features({"__lift__": values}, {"__lift__": value_type})
    out = inner.transform_columns([ds["__lift__"]], ds)
    return out.to_values()


class _LiftBase(UnaryTransformer):
    def __init__(self, inner: Optional[Transformer] = None,
                 value_type: Optional[Type[FeatureType]] = None,
                 output_collection_type: Optional[Type[FeatureType]] = None, **kw):
        super().__init__(**kw)
        self.inner = inner
        self.value_type = value_type
        self.output_collection_type = output_collection_type

    def _output_ftype(self) -> Type[FeatureType]:
        return self.output_collection_type or self.inputs[0].ftype

    def _value_type(self) -> Type[FeatureType]:
        if self.value_type is not None:
            return self.value_type
        vt = self.inner.input_types[0]
        if vt is FeatureType:
            raise ValueError(
                "inner transformer's value type is generic; pass value_type=")
        return vt


class LiftToMap(_LiftBase):
    """Apply a value-level transformer to every map value (OPCollectionTransformer).

    All map values flatten into one column, the inner transformer runs once over
    the batch, and results scatter back per key.  Empty maps stay empty
    (reference: empty input -> empty output).
    """

    input_types = (OPMap,)
    output_type = OPMap

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        if self.inner is None:
            raise ValueError("LiftToMap needs an inner transformer")
        flat: List = []
        spans: List[List[str]] = []
        for m in cols[0].data:
            keys = list((m or {}).keys())
            spans.append(keys)
            flat.extend((m or {})[k] for k in keys)
        transformed = _lift_apply(self.inner, flat, self._value_type())
        out = np.empty(len(cols[0]), dtype=object)
        pos = 0
        for i, keys in enumerate(spans):
            out[i] = {k: transformed[pos + j] for j, k in enumerate(keys)}
            pos += len(keys)
        return Column(self._output_ftype(), out)


class LiftToList(_LiftBase):
    """Apply a value-level transformer to every list element (list lift)."""

    input_types = (OPList,)
    output_type = OPList

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        if self.inner is None:
            raise ValueError("LiftToList needs an inner transformer")
        flat: List = []
        lengths: List[int] = []
        for xs in cols[0].data:
            xs = list(xs or ())
            lengths.append(len(xs))
            flat.extend(xs)
        transformed = _lift_apply(self.inner, flat, self._value_type())
        out = np.empty(len(cols[0]), dtype=object)
        pos = 0
        for i, ln in enumerate(lengths):
            out[i] = list(transformed[pos:pos + ln])
            pos += ln
        return Column(self._output_ftype(), out)


class DateMapToUnitCircleVectorizer(SequenceEstimator):
    """DateMap -> per-key [cos, sin] unit-circle encoding per time period.

    Fit learns the key set per input map (sorted, stable); transform places each
    key's date on the unit circle for every configured period — the map variant
    of DateToUnitCircleVectorizer (missing key -> origin, matching the scalar
    vectorizer's null convention).
    """

    sequence_input_type = DateMap
    output_type = OPVector

    time_periods = Param(default=("HourOfDay", "DayOfWeek"))

    def fit_columns(self, cols: List[Column], dataset, device) -> Transformer:
        key_sets: List[List[str]] = []
        for col in cols:
            keys = set()
            for m in col.data:
                keys.update((m or {}).keys())
            key_sets.append(sorted(keys))
        return DateMapToUnitCircleVectorizerModel(
            key_sets=key_sets, time_periods=tuple(self.time_periods))


class DateMapToUnitCircleVectorizerModel(Transformer):
    sequence_input_type = DateMap
    output_type = OPVector

    def __init__(self, key_sets: List[List[str]], time_periods=("HourOfDay",), **kw):
        super().__init__(**kw)
        self.key_sets = [list(k) for k in key_sets]
        self.time_periods = tuple(time_periods)

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        bad = [p for p in self.time_periods if p not in _PERIOD_SIZE]
        if bad:
            raise ValueError(f"Unknown time periods {bad}; valid: {TIME_PERIODS}")
        n = len(cols[0])
        blocks: List[np.ndarray] = []
        meta_cols: List[VectorColumnMetadata] = []
        for f, col, keys in zip(self.inputs, cols, self.key_sets):
            for key in keys:
                ms = np.zeros(n, np.int64)
                present = np.zeros(n, bool)
                for i, m in enumerate(col.data):
                    v = (m or {}).get(key)
                    if v is not None:
                        ms[i] = int(v)
                        present[i] = True
                for period in self.time_periods:
                    size = _PERIOD_SIZE[period]
                    angle = 2.0 * np.pi * _period_values(ms, period) / size
                    cos = np.where(present, np.cos(angle), 0.0)
                    sin = np.where(present, np.sin(angle), 0.0)
                    blocks.append(np.column_stack([cos, sin]).astype(np.float32))
                    for axis in ("x", "y"):
                        meta_cols.append(VectorColumnMetadata(
                            f.name, f.ftype.__name__, grouping=f"{f.name}_{key}",
                            descriptor_value=f"{axis}_{period}"))
        if not blocks:
            blocks = [np.zeros((n, 0), np.float32)]
        meta = VectorMetadata(
            self.output_name, meta_cols,
            {f.name: f.history() for f in self.inputs},
        ).reindexed()
        return Column.vector(np.hstack(blocks), meta)
