"""Readers — data ingestion producing columnar Datasets from raw features
(counterpart of ``transmogrifai_tpu/readers/base.py``, copied).

Reference: readers/.../Reader.scala, DataReader.scala:57-198 (generateDataFrame :173-188),
CSVReaders.scala, ParquetProductReader.scala, DataReaders.scala factory.

Ingestion is host work: columnar from a pandas frame with a fast path when a
feature's extract function is a named-field read, per record for arbitrary
extract functions, and aggregate/conditional readers apply monoid event
aggregation with cutoff semantics.  ``generate_chunked`` streams the
records straight into a chunked spill store (``data/chunked.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from ..aggregators.monoid import CutOffTime, Event, aggregate_events
from ..data.dataset import Column, Dataset
from ..features.feature import Feature, _NamedExtract
from ..features.generator import FeatureGeneratorStage
from ..types.base import FeatureType


def _generators(raw_features: Sequence[Feature]) -> List[FeatureGeneratorStage]:
    gens = []
    for f in raw_features:
        st = f.origin_stage
        if not isinstance(st, FeatureGeneratorStage):
            raise ValueError(f"Feature {f.name!r} is not a raw feature")
        gens.append(st)
    return gens


class Reader:
    """Base reader: produce a Dataset containing one column per raw feature."""

    def __init__(self, key_fn: Optional[Callable[[Any], str]] = None):
        self.key_fn = key_fn

    def read_records(self) -> Iterable[Any]:
        """Yield raw records (dict-like).  Implemented by subclasses."""
        raise NotImplementedError

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        records = list(self.read_records())
        return rows_to_dataset(records, raw_features)

    def generate_chunked(self, raw_features: Sequence[Feature],
                         chunk_rows: Optional[int] = None,
                         spill_dir: Optional[str] = None):
        """Out-of-core ingestion: stream ``read_records()`` straight into a
        chunked spill store, ``chunk_rows`` records (default 8192) a chunk,
        so the whole table is never resident on the host; returns a
        :class:`~..data.chunked.ChunkedDataset`."""
        from ..data.chunked import DEFAULT_CHUNK_ROWS, ChunkedDatasetWriter

        chunk_rows = int(chunk_rows or DEFAULT_CHUNK_ROWS)
        gens = _generators(raw_features)
        named = [(f.name, g) for f, g in zip(raw_features, gens)]
        writer = ChunkedDatasetWriter(chunk_rows=chunk_rows, spill_dir=spill_dir)
        buf: List[Any] = []
        for r in self.read_records():
            buf.append(r)
            if len(buf) == chunk_rows:
                writer.append(Dataset(extract_columns(buf, named)))
                buf = []
        if buf:
            writer.append(Dataset(extract_columns(buf, named)))
        return writer.finish()


def extract_columns(records: Sequence[Any], named_gens,
                    allow_missing_response: bool = False) -> Dict[str, Column]:
    """Extract (name, generator) pairs over records into columns.

    ``allow_missing_response=True`` is the SCORING-time contract (streaming /
    serving batches legitimately carry no label): a response whose source is
    genuinely ABSENT from the records is skipped — the model stages never
    read it.  A response that is PRESENT but malformed still raises (a
    data-quality bug must not silently drop the label column), as do all
    predictor failures; on training/evaluate paths (the default) every
    response failure raises, so a typo'd label key surfaces at ingest."""
    from ..features.feature import _NamedExtract

    cols: Dict[str, Column] = {}
    for name, g in named_gens:
        try:
            cols[name] = Column.from_values(g.ftype, _extracted(g, records))
        except Exception:
            if not (allow_missing_response and g.is_response):
                raise
            fn = getattr(g, "extract_fn", None)
            if isinstance(fn, _NamedExtract):
                present = any(
                    isinstance(r, dict) and r.get(fn.key) is not None
                    for r in records)
                if present:
                    raise  # label supplied but malformed: surface the bug
            # absent label (or non-introspectable extract): tolerated
    return cols


def _extracted(g, records: Sequence[Any]) -> list:
    """``g``'s raw values over the records, left for ``Column.from_values``
    to convert: the conversion ``g.extract`` would do, run once (a
    non-nullable type raises the same ``NonNullableEmptyException``).  A
    typed value an extract function returns must be of ``g``'s type, as
    ``g.extract`` checks."""
    values = list(map(g.extract_fn, records))
    for v in values:
        if isinstance(v, FeatureType) and not isinstance(v, g.ftype):
            raise TypeError(
                f"extract for {g.raw_name!r} returned {type(v).__name__},"
                f" expected {g.ftype.__name__}")
    return values


def rows_to_dataset(records: Sequence[Any], raw_features: Sequence[Feature],
                    allow_missing_response: bool = False) -> Dataset:
    """Run every raw feature's extract over the records (DataReader.generateRow path)."""
    gens = _generators(raw_features)
    return Dataset(extract_columns(
        records, [(f.name, g) for f, g in zip(raw_features, gens)],
        allow_missing_response=allow_missing_response))


class DataFrameReader(Reader):
    """Columnar fast path over a pandas DataFrame (named-field extracts read directly)."""

    def __init__(self, df, key_fn=None):
        super().__init__(key_fn)
        self.df = df

    def read_records(self):
        return self.df.to_dict("records")

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        from ..features.builder import _clean_series

        gens = _generators(raw_features)
        missing = [g.extract_fn.key for g in gens
                   if isinstance(g.extract_fn, _NamedExtract)
                   and g.extract_fn.key not in self.df.columns]
        if missing:
            raise KeyError(
                f"DataFrame is missing columns for raw features: {sorted(missing)}; "
                f"available: {sorted(self.df.columns)}")
        cols: Dict[str, Column] = {}
        slow: List[int] = []
        for i, (f, g) in enumerate(zip(raw_features, gens)):
            fn = g.extract_fn
            if isinstance(fn, _NamedExtract):
                cols[f.name] = Column.from_values(
                    g.ftype, _clean_series(self.df[fn.key], g.ftype))
            else:
                slow.append(i)
        if slow:
            records = self.read_records()
            for i in slow:
                f, g = raw_features[i], gens[i]
                cols[f.name] = Column.from_values(
                    g.ftype, [g.extract(r).value for r in records])
        return Dataset(cols)


class CustomReader(Reader):
    """Wrap any record-producing function (reference CustomReader)."""

    def __init__(self, fn: Callable[[], Iterable[Any]], key_fn=None):
        super().__init__(key_fn)
        self.fn = fn

    def read_records(self):
        return self.fn()


class AggregateReader(Reader):
    """Group records by key and monoid-aggregate each feature's events.

    Reference: AggregatedReader/AggregateDataReader (DataReader.scala:206-280) —
    the label-leakage-safe temporal aggregation: predictors fold events strictly before
    the cutoff, responses at/after it.
    """

    def __init__(self, inner: Reader, key_fn: Callable[[Any], str],
                 time_fn: Callable[[Any], int],
                 cutoff: CutOffTime = CutOffTime.no_cutoff()):
        super().__init__(key_fn)
        self.inner = inner
        self.time_fn = time_fn
        self.cutoff = cutoff

    def read_records(self):
        return self.inner.read_records()

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        return self.generate_dataset_with_keys(raw_features)[0]

    def generate_chunked(self, raw_features, chunk_rows=None, spill_dir=None):
        """Refused: the base streaming path would emit one row per EVENT,
        silently skipping the key grouping, monoid aggregation, and cutoff
        label-leakage protection this reader exists for.  Aggregate the
        table first, then spill it."""
        raise NotImplementedError(
            f"{type(self).__name__}.generate_chunked: aggregate/conditional "
            f"readers group and fold events per key — streaming chunks of "
            f"raw events would yield a different (leaky, per-event) table. "
            f"Use generate_dataset(...) then "
            f"ChunkedDataset.from_dataset(ds) to spill the aggregated rows.")

    def generate_dataset_with_keys(self, raw_features: Sequence[Feature]):
        """(dataset, row keys) — aggregate readers emit one row per kept key."""
        gens = _generators(raw_features)
        by_key: Dict[str, List[Any]] = {}
        for r in self.read_records():
            by_key.setdefault(self.key_fn(r), []).append(r)
        keys = sorted(by_key)
        cols: Dict[str, Column] = {}
        for f, g in zip(raw_features, gens):
            values = []
            for k in keys:
                recs = by_key[k]
                cutoff_ms = self.cutoff.cutoff_for(recs[0])
                events = [Event(self.time_fn(r), g.extract(r).value,
                                g.is_response) for r in recs]
                values.append(aggregate_events(
                    g.ftype, events,
                    aggregator=g.aggregator,
                    is_response=g.is_response,
                    cutoff_ms=cutoff_ms,
                    window_ms=g.aggregate_window_ms,
                ))
            cols[f.name] = Column.from_values(g.ftype, values)
        return Dataset(cols), keys


class ConditionalReader(AggregateReader):
    """Per-key cutoff defined by a predicate event (e.g. 'first purchase').

    Reference: ConditionalDataReader — records matching ``condition_fn`` define the key's
    cutoff time; keys with no matching event are dropped.
    """

    def __init__(self, inner: Reader, key_fn, time_fn,
                 condition_fn: Callable[[Any], bool], drop_if_no_condition: bool = True):
        super().__init__(inner, key_fn, time_fn)
        self.condition_fn = condition_fn
        self.drop_if_no_condition = drop_if_no_condition

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        return self.generate_dataset_with_keys(raw_features)[0]

    def generate_dataset_with_keys(self, raw_features: Sequence[Feature]):
        gens = _generators(raw_features)
        by_key: Dict[str, List[Any]] = {}
        for r in self.read_records():
            by_key.setdefault(self.key_fn(r), []).append(r)
        kept: List[str] = []
        cols_values: Dict[str, List[Any]] = {f.name: [] for f in raw_features}
        for k in sorted(by_key):
            recs = by_key[k]
            times = [self.time_fn(r) for r in recs if self.condition_fn(r)]
            if not times:
                if self.drop_if_no_condition:
                    continue
                cutoff_ms = None
            else:
                cutoff_ms = min(times)
            kept.append(k)
            for f, g in zip(raw_features, gens):
                events = [Event(self.time_fn(r), g.extract(r).value, g.is_response)
                          for r in recs]
                cols_values[f.name].append(aggregate_events(
                    g.ftype, events,
                    aggregator=g.aggregator,
                    is_response=g.is_response,
                    cutoff_ms=cutoff_ms,
                    window_ms=g.aggregate_window_ms,
                ))
        return Dataset({
            f.name: Column.from_values(g.ftype, cols_values[f.name])
            for f, g in zip(raw_features, gens)
        }), kept
