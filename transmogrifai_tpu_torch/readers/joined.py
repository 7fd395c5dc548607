"""Joined readers — typed joins between readers producing combined raw rows
(counterpart of ``transmogrifai_tpu/readers/joined.py``, copied).

Reference: readers/.../JoinedDataReader.scala:1-442 (JoinKeys, JoinedReader.getJoinedData,
JoinedDataReader.withSecondaryAggregation, JoinedAggregateDataReader.postJoinAggregate),
JoinTypes.scala.

The join is a host-side columnar hash join over key arrays (the reference
shuffles through Spark); the joined Dataset then feeds the usual vectorize-to-device path.
One-to-many matches duplicate the left rows (SQL semantics); outer variants emit
empty-filled rows for the unmatched side.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..aggregators.monoid import Event, aggregate_events
from ..data.dataset import Column, Dataset
from ..features.feature import Feature
from .base import Reader, _generators


class JoinType(enum.Enum):
    """Reference JoinTypes.scala: Inner | LeftOuter | RightOuter | FullOuter."""

    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"


@dataclass(frozen=True)
class TimeColumn:
    """Time column for post-join aggregation (reference TimeColumn: name + keep)."""

    name: str
    keep: bool = True


@dataclass(frozen=True)
class TimeBasedFilter:
    """Time-based filter for conditional post-join aggregation.

    Reference TimeBasedFilter: the ``condition`` column's value per key defines the
    aggregation cutoff; ``primary`` is each event's timestamp; ``window_ms`` bounds
    how far before the cutoff predictor events are folded.
    """

    condition: TimeColumn
    primary: TimeColumn
    window_ms: Optional[int] = None


def _join_indices(left_keys: Sequence[str], right_keys: Sequence[str],
                  join_type: JoinType) -> Tuple[np.ndarray, np.ndarray]:
    """(left_idx, right_idx) row pairs; -1 marks the missing side of an outer row."""
    right_map: Dict[str, List[int]] = {}
    for j, k in enumerate(right_keys):
        right_map.setdefault(k, []).append(j)
    li: List[int] = []
    ri: List[int] = []
    matched = np.zeros(len(right_keys), dtype=np.bool_)
    for i, k in enumerate(left_keys):
        js = right_map.get(k)
        if js:
            for j in js:
                li.append(i)
                ri.append(j)
                matched[j] = True
        elif join_type in (JoinType.LEFT_OUTER, JoinType.FULL_OUTER):
            li.append(i)
            ri.append(-1)
    if join_type in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
        for j in np.nonzero(~matched)[0]:
            li.append(-1)
            ri.append(int(j))
    return np.asarray(li, dtype=np.int64), np.asarray(ri, dtype=np.int64)


def _take_with_missing(ds: Dataset, idx: np.ndarray) -> Dict[str, Column]:
    """Gather rows by index, emitting empty values where idx == -1 (outer fill)."""
    cols: Dict[str, Column] = {}
    for name in ds.names:
        col = ds[name]
        vals = col.to_values()
        cols[name] = Column.from_values(
            col.ftype, [vals[i] if i >= 0 else None for i in idx], meta=col.meta)
    return cols


class JoinedReader(Reader):
    """Join two readers' raw-feature datasets on their record keys.

    Reference: JoinedDataReader (JoinedDataReader.scala:220-240).  Feature ownership
    is explicit (``left_feature_names`` / the rest go right) since Python extract
    functions carry no record-type tags to dispatch on.  The left side may itself be
    a ``JoinedReader`` so joins chain left-deep, as in the reference.
    """

    def __init__(self, left: Reader, right: Reader,
                 left_feature_names: Sequence[str],
                 join_type: JoinType = JoinType.LEFT_OUTER):
        super().__init__(key_fn=None)
        self.left = left
        self.right = right
        self.left_feature_names = set(left_feature_names)
        self.join_type = join_type

    def with_secondary_aggregation(self, time_filter: TimeBasedFilter) -> "JoinedAggregateReader":
        """Aggregate joined child rows per key after the join (reference :231-239)."""
        return JoinedAggregateReader(
            self.left, self.right, self.left_feature_names, self.join_type, time_filter)

    # -- internals -----------------------------------------------------------
    def _partition(self, raw_features: Sequence[Feature]):
        # A left name absent from the request is fine (scoring subsets request fewer
        # features), but one that case-insensitively matches a requested feature is
        # almost certainly a typo that would silently route the feature to the
        # wrong reader.
        names = {f.name for f in raw_features}
        lowered = {n.lower(): n for n in names}
        for unknown in self.left_feature_names - names:
            hit = lowered.get(unknown.lower())
            if hit is not None:
                raise ValueError(
                    f"left_feature_names entry {unknown!r} does not match any requested "
                    f"raw feature but differs only in case from {hit!r} — check for "
                    "typos; names must match exactly")
        lf = [f for f in raw_features if f.name in self.left_feature_names]
        rf = [f for f in raw_features if f.name not in self.left_feature_names]
        return lf, rf

    @staticmethod
    def _side(reader: Reader, features: Sequence[Feature]) -> Tuple[Dataset, List[str]]:
        """(dataset, keys) for one side of the join."""
        if isinstance(reader, JoinedReader):
            return reader._generate_with_keys(features)
        if reader.key_fn is None:
            raise ValueError(
                f"{type(reader).__name__} needs a key_fn to participate in a join")
        if hasattr(reader, "generate_dataset_with_keys"):
            # aggregate/conditional readers: one row per kept key (keys may drop)
            ds, keys = reader.generate_dataset_with_keys(features)
            return ds, [str(k) for k in keys]
        from .base import Reader as _BaseReader, rows_to_dataset

        if type(reader).generate_dataset is _BaseReader.generate_dataset:
            # record-based reader: one materialized pass — keys and rows come from
            # the SAME read so a non-deterministic source (DB query, directory
            # listing) cannot pair keys with the wrong rows, and the source is
            # not read twice
            records = list(reader.read_records())
            keys = [str(reader.key_fn(r)) for r in records]
            ds = rows_to_dataset(records, features)
            return ds, keys
        # columnar reader (e.g. DataFrameReader): keep its fast path + dtype/NaN
        # cleaning; a second row pass for keys is deterministic over the
        # materialized frame
        ds = reader.generate_dataset(features)
        keys = [str(reader.key_fn(r)) for r in reader.read_records()]
        if features and ds.n_rows != len(keys):
            raise ValueError(
                f"reader produced {ds.n_rows} rows for {len(keys)} keys")
        return ds, keys

    def _generate_with_keys(self, raw_features: Sequence[Feature]) -> Tuple[Dataset, List[str]]:
        lf, rf = self._partition(raw_features)
        left_ds, left_keys = self._side(self.left, lf)
        right_ds, right_keys = self._side(self.right, rf)
        li, ri = _join_indices(left_keys, right_keys, self.join_type)
        cols = _take_with_missing(left_ds, li)
        cols.update(_take_with_missing(right_ds, ri))
        out_keys = [left_keys[i] if i >= 0 else right_keys[j]
                    for i, j in zip(li, ri)]
        return Dataset(cols), out_keys

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        ds, _ = self._generate_with_keys(raw_features)
        return ds

    def read_records(self):  # pragma: no cover - joins are columnar only
        raise NotImplementedError("JoinedReader produces datasets, not records")


class JoinedAggregateReader(JoinedReader):
    """Join then aggregate child rows per key (reference JoinedAggregateDataReader).

    Left (parent) features keep one copy per key; right (child) features fold their
    events through the feature's monoid aggregator with the key's cutoff taken from
    the ``condition`` time column (predictors strictly before the cutoff, bounded by
    ``window_ms``; responses at/after — the §2.4 leakage-safe semantics).
    """

    def __init__(self, left: Reader, right: Reader, left_feature_names,
                 join_type: JoinType, time_filter: TimeBasedFilter):
        super().__init__(left, right, left_feature_names, join_type)
        self.time_filter = time_filter

    def _generate_with_keys(self, raw_features: Sequence[Feature]) -> Tuple[Dataset, List[str]]:
        """Join, then fold child rows per key.

        Overridden here (not just ``generate_dataset``) so the aggregation also runs
        when this reader is nested as a side of another join — otherwise post-cutoff
        child events would leak into the outer join's rows.
        """
        joined, keys = super()._generate_with_keys(raw_features)
        lf, _ = self._partition(raw_features)
        gens = dict(zip([f.name for f in raw_features], _generators(raw_features)))

        cond_name = self.time_filter.condition.name
        prim_name = self.time_filter.primary.name
        missing = [n for n in (cond_name, prim_name) if n not in joined]
        if missing:
            # silently skipping the cutoff would fold post-cutoff events into
            # predictors — exactly the leakage this reader exists to prevent
            raise ValueError(
                f"secondary aggregation time columns {missing} are not among the "
                f"requested raw features {sorted(joined.names)}")
        cond_vals = joined[cond_name].to_values()
        prim_vals = joined[prim_name].to_values()

        by_key: Dict[str, List[int]] = {}
        for i, k in enumerate(keys):
            by_key.setdefault(k, []).append(i)
        ordered = sorted(by_key)

        cols: Dict[str, Column] = {}
        for f in raw_features:
            g = gens[f.name]
            vals = joined[f.name].to_values()
            out: List[Any] = []
            for k in ordered:
                rows = by_key[k]
                if f in lf or f.name in (cond_name,):
                    # parent data: one copy per key (reference dummy aggregators)
                    first = next((vals[i] for i in rows if vals[i] is not None), None)
                    out.append(first)
                    continue
                cutoff = None
                if cond_vals is not None:
                    cutoff = next(
                        (cond_vals[i] for i in rows if cond_vals[i] is not None), None)
                events = []
                for i in rows:
                    t = prim_vals[i] if prim_vals is not None else None
                    if vals[i] is None and t is None:
                        continue
                    events.append(Event(int(t) if t is not None else 0,
                                        vals[i], g.is_response))
                out.append(aggregate_events(
                    g.ftype, events,
                    aggregator=g.aggregator,
                    is_response=g.is_response,
                    cutoff_ms=int(cutoff) if cutoff is not None else None,
                    window_ms=self.time_filter.window_ms,
                ))
            cols[f.name] = Column.from_values(g.ftype, out)
        return Dataset(cols), ordered

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        ds, _ = self._generate_with_keys(raw_features)
        drop = [tc.name for tc in (self.time_filter.condition, self.time_filter.primary)
                if not tc.keep and tc.name in ds]
        return ds.drop(drop) if drop else ds
