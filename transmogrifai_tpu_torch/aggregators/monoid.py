"""Monoid aggregation — label-leakage-safe temporal join machinery
(counterpart of ``transmogrifai_tpu/aggregators/monoid.py``, copied).

Reference: features/.../aggregators/ (MonoidAggregatorDefaults.scala:52-130, Event.scala,
FeatureAggregator.scala, TimeBasedAggregator.scala:1-225, CutOffTime.scala).

Every feature type has a default associative aggregator used by aggregate/conditional readers
to fold a key's event records into one value, respecting predictor/response time windows
relative to a per-key cutoff.  Associativity is what lets these reductions run as tree
reductions on device or host without ordering constraints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Generic, Optional, Type, TypeVar

from ..types import (
    Binary,
    BinaryMap,
    ColumnKind,
    FeatureType,
    Geolocation,
    GeolocationMap,
    MultiPickListMap,
    Prediction,
)

T = TypeVar("T")


@dataclass(frozen=True)
class Event(Generic[T]):
    """A timestamped feature value.  Reference: aggregators/Event.scala."""

    timestamp_ms: int
    value: Any
    is_response: bool = False


class MonoidAggregator:
    """Associative fold with identity: prepare -> reduce -> present."""

    __slots__ = ("zero", "plus", "prepare_fn", "present_fn")

    def __init__(self, zero: Any, plus: Callable[[Any, Any], Any],
                 prepare: Optional[Callable] = None, present: Optional[Callable] = None):
        self.zero = zero
        self.plus = plus
        self.prepare_fn = prepare
        self.present_fn = present

    def prepare(self, v: Any) -> Any:
        return self.prepare_fn(v) if self.prepare_fn else v

    def present(self, acc: Any) -> Any:
        return self.present_fn(acc) if self.present_fn else acc

    def reduce(self, values) -> Any:
        acc = self.zero
        for v in values:
            acc = self.plus(acc, self.prepare(v))
        return self.present(acc)


def _sum_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _or_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a or b


def _min_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def _concat_text(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + " " + b


def _union_map_sum(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out[k] + v if k in out else v
    return out


def _union_map_last(a: dict, b: dict) -> dict:
    out = dict(a)
    out.update(b)
    return out


def _union_map_or(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = (out[k] or v) if k in out else v
    return out


def _union_map_set(a: dict, b: dict) -> dict:
    out = {k: set(v) for k, v in a.items()}
    for k, v in b.items():
        out[k] = (out[k] | set(v)) if k in out else set(v)
    return out


def _geo_mid(a, b):
    """Geolocation midpoint weighted by accuracy count — keeps associativity via running sums."""
    if not a:
        return b
    if not b:
        return a
    # accumulate as (lat_sum, lon_sum, acc_min, count) lists of 4
    al = a if len(a) == 4 else [a[0], a[1], a[2], 1.0]
    bl = b if len(b) == 4 else [b[0], b[1], b[2], 1.0]
    return [al[0] + bl[0], al[1] + bl[1], min(al[2], bl[2]), al[3] + bl[3]]


def _geo_present(acc):
    if not acc:
        return []
    if len(acc) == 4 and acc[3] > 0:
        return [acc[0] / acc[3], acc[1] / acc[3], acc[2]]
    return acc[:3]


def default_aggregator(ftype: Type[FeatureType]) -> MonoidAggregator:
    """Per-type default aggregator.  Reference: MonoidAggregatorDefaults.aggregatorOf[O]."""
    kind = ftype.kind
    if issubclass(ftype, Binary):
        return MonoidAggregator(None, _or_opt)
    if issubclass(ftype, Geolocation):
        return MonoidAggregator([], _geo_mid, present=_geo_present)
    if kind in (ColumnKind.FLOAT, ColumnKind.INT):
        # numerics sum; dates take min (earliest event)
        from ..types import Date

        if issubclass(ftype, Date):
            return MonoidAggregator(None, _min_opt)
        return MonoidAggregator(None, _sum_opt)
    if kind is ColumnKind.TEXT:
        return MonoidAggregator(None, _concat_text)
    if kind in (ColumnKind.TEXT_LIST, ColumnKind.INT_LIST):
        return MonoidAggregator([], lambda a, b: a + b)
    if kind is ColumnKind.TEXT_SET:
        return MonoidAggregator(set(), lambda a, b: a | b)
    if issubclass(ftype, (MultiPickListMap,)):
        return MonoidAggregator({}, _union_map_set)
    if issubclass(ftype, (BinaryMap,)):
        return MonoidAggregator({}, _union_map_or)
    if issubclass(ftype, GeolocationMap):
        return MonoidAggregator({}, _union_map_last)
    if issubclass(ftype, Prediction):
        return MonoidAggregator({}, _union_map_last)
    if kind is ColumnKind.MAP:
        from ..types.maps import _DoubleMap, _LongMap

        if issubclass(ftype, (_DoubleMap, _LongMap)):
            return MonoidAggregator({}, _union_map_sum)
        return MonoidAggregator({}, _union_map_last)
    if kind is ColumnKind.VECTOR:
        import numpy as np

        return MonoidAggregator(
            None, lambda a, b: b if a is None else a + b,
            present=lambda a: a if a is not None else np.zeros(0, dtype=np.float32),
        )
    if kind is ColumnKind.GEO:
        return MonoidAggregator([], _geo_mid, present=_geo_present)
    raise TypeError(f"No default aggregator for {ftype.__name__}")


@dataclass(frozen=True)
class CutOffTime:
    """Per-key time cutoff separating predictor history from response future.

    Reference: aggregators/CutOffTime.scala.  kind: 'unix' (fixed ms), 'no_cutoff',
    or 'function' (record -> ms).
    """

    kind: str = "no_cutoff"
    timestamp_ms: Optional[int] = None
    fn: Optional[Callable[[Any], Optional[int]]] = None

    @staticmethod
    def unix(ts_ms: int) -> "CutOffTime":
        return CutOffTime(kind="unix", timestamp_ms=ts_ms)

    @staticmethod
    def no_cutoff() -> "CutOffTime":
        return CutOffTime(kind="no_cutoff")

    @staticmethod
    def function(fn: Callable[[Any], Optional[int]]) -> "CutOffTime":
        return CutOffTime(kind="function", fn=fn)

    def cutoff_for(self, record: Any) -> Optional[int]:
        if self.kind == "unix":
            return self.timestamp_ms
        if self.kind == "function" and self.fn is not None:
            return self.fn(record)
        return None


def aggregate_events(
    ftype: Type[FeatureType],
    events,
    aggregator: Optional[MonoidAggregator] = None,
    is_response: bool = False,
    cutoff_ms: Optional[int] = None,
    window_ms: Optional[int] = None,
) -> Any:
    """Fold a key's events into one value with time-window semantics.

    Reference: FeatureAggregator.extract + TimeBasedAggregator — predictors aggregate events
    strictly BEFORE the cutoff (within ``window_ms`` looking back), responses aggregate events
    at/after the cutoff (within ``window_ms`` looking forward).  This is the label-leakage
    guard: response data can never leak into predictor aggregates.
    """
    agg = aggregator or default_aggregator(ftype)
    selected = []
    for ev in events:
        t = ev.timestamp_ms
        if cutoff_ms is not None:
            if is_response:
                if t < cutoff_ms:
                    continue
                if window_ms is not None and t >= cutoff_ms + window_ms:
                    continue
            else:
                if t >= cutoff_ms:
                    continue
                if window_ms is not None and t < cutoff_ms - window_ms:
                    continue
        selected.append(ev.value)
    return agg.reduce(selected)
