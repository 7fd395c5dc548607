"""Date vectorizers (counterpart of ``transmogrifai_tpu/ops/dates.py``):
calendar periods, the unit-circle projection of dates and the date-list
pivots.

``extract_time_period`` is numpy ``datetime64`` calendar math in UTC with
java.time's conventions, as in the reference; torch has no calendar math, and
the whole family is host work there too.
"""

from __future__ import annotations

import time as _time
from typing import List

import numpy as np

from ..data.dataset import Column
from ..stages.base import Param, SequenceTransformer
from ..types import Date, DateList, OPVector
from ..utils.vector_metadata import NULL_INDICATOR, VectorColumnMetadata, VectorMetadata

#: the periods DateToUnitCircleVectorizer projects by default, and their sizes
TIME_PERIODS = ("HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear")
_PERIOD_SIZE = {"HourOfDay": 24.0, "DayOfWeek": 7.0, "DayOfMonth": 31.0, "DayOfYear": 366.0}

#: the 7 calendar periods of TransmogrifAI's TimePeriod (java.time 1-based conventions)
ALL_TIME_PERIODS = ("DayOfMonth", "DayOfWeek", "DayOfYear", "HourOfDay",
                    "MonthOfYear", "WeekOfMonth", "WeekOfYear")


def extract_time_period(ms: np.ndarray, period: str) -> np.ndarray:
    """Calendar-period ordinal of epoch-millis (UTC), vectorized.

    DayOfMonth 1-31, DayOfWeek 1=Mon..7=Sun, DayOfYear 1-366, HourOfDay
    0-23, MonthOfYear 1-12, WeekOfMonth/WeekOfYear with Monday-start weeks
    and a minimal 1-day first week (java.time's WeekFields.of(MONDAY, 1)).
    """
    secs = ms.astype("datetime64[ms]").astype("datetime64[s]")
    days = secs.astype("datetime64[D]")
    if period == "HourOfDay":
        return ((secs - days).astype("timedelta64[h]").astype(np.int64)) % 24
    if period == "DayOfWeek":
        return ((days.astype(np.int64) + 3) % 7) + 1  # 1970-01-01 was a Thursday
    if period == "DayOfMonth":
        return (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    if period == "DayOfYear":
        return (days - days.astype("datetime64[Y]")).astype(np.int64) + 1
    if period == "MonthOfYear":
        return (days.astype("datetime64[M]").astype(np.int64) % 12) + 1
    if period in ("WeekOfMonth", "WeekOfYear"):
        unit = "M" if period == "WeekOfMonth" else "Y"
        first = days.astype(f"datetime64[{unit}]").astype("datetime64[D]")
        first_dow = (first.astype(np.int64) + 3) % 7  # Mon=0 of the 1st day
        ordinal = (days - first).astype(np.int64)  # 0-based day within month/year
        return (ordinal + first_dow) // 7 + 1
    raise ValueError(f"Unknown time period {period!r}")


def _period_values(ms: np.ndarray, period: str) -> np.ndarray:
    """Period ordinal as float64, 0-based (the unit circle's angle)."""
    vals = extract_time_period(ms, period).astype(np.float64)
    if period in ("DayOfWeek", "DayOfMonth", "DayOfYear"):
        vals -= 1.0  # extract_time_period is 1-based for these
    return vals


DATE_LIST_PIVOTS = ("SinceFirst", "SinceLast", "ModeDay", "ModeMonth", "ModeHour")
_MODE_SPECS = {
    # pivot -> (period, cardinality, 1-based)
    "ModeDay": ("DayOfWeek", 7, True),
    "ModeMonth": ("MonthOfYear", 12, True),
    "ModeHour": ("HourOfDay", 24, False),
}
_DAY_MS = 24 * 3600 * 1000


class DateListVectorizer(SequenceTransformer):
    """Pivot of date lists.  SinceFirst/SinceLast: days from the first/last
    event to ``reference_date_ms``; ModeDay/ModeMonth/ModeHour: one-hot of
    the modal weekday/month/hour."""

    sequence_input_type = DateList
    output_type = OPVector

    pivot = Param(default="SinceFirst", validator=lambda v: v in DATE_LIST_PIVOTS)
    fill_value = Param(default=0.0, doc="SinceFirst/SinceLast value for empty lists")
    reference_date_ms = Param(
        default=None,
        doc="epoch millis; None snapshots 'now' ONCE at stage construction")
    track_nulls = Param(default=True)

    def __init__(self, **kw):
        super().__init__(**kw)
        # "now" is read once, here, and kept as a param: transforms stay
        # deterministic and a saved model carries it into serving
        if self.reference_date_ms is None:
            self.reference_date_ms = int(_time.time() * 1000)

    def _since_block(self, lists, ref_ms: int, first: bool):
        out = np.full(len(lists), float(self.fill_value))
        present = np.zeros(len(lists), dtype=np.bool_)
        for i, lst in enumerate(lists):
            if lst:
                t = min(lst) if first else max(lst)
                out[i] = (ref_ms - int(t)) / _DAY_MS
                present[i] = True
        return out, present

    def _mode_block(self, lists, pivot: str):
        period, card, one_based = _MODE_SPECS[pivot]
        n = len(lists)
        block = np.zeros((n, card), dtype=np.float32)
        present = np.zeros(n, dtype=np.bool_)
        for i, lst in enumerate(lists):
            if not lst:
                continue
            ords = extract_time_period(np.asarray(lst, dtype=np.int64), period)
            vals, counts = np.unique(ords, return_counts=True)
            block[i, int(vals[np.argmax(counts)]) - (1 if one_based else 0)] = 1.0
            present[i] = True
        return block, present

    def transform_columns(self, cols: List[Column], dataset):
        ref_ms = self.reference_date_ms
        blocks: List[np.ndarray] = []
        meta_cols: List[VectorColumnMetadata] = []
        for f, col in zip(self.inputs, cols):
            lists = col.to_values()
            if self.pivot in ("SinceFirst", "SinceLast"):
                vals, present = self._since_block(
                    lists, ref_ms, first=self.pivot == "SinceFirst")
                blocks.append(vals[:, None].astype(np.float32))
                meta_cols.append(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=f.name,
                    descriptor_value=self.pivot))
            else:
                block, present = self._mode_block(lists, self.pivot)
                blocks.append(block)
                period, card, one_based = _MODE_SPECS[self.pivot]
                lo = 1 if one_based else 0
                meta_cols.extend(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=f.name,
                    indicator_value=f"{period}_{j + lo}") for j in range(card))
            if self.track_nulls:
                blocks.append((~present).astype(np.float32)[:, None])
                meta_cols.append(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=f.name,
                    indicator_value=NULL_INDICATOR))
        meta = VectorMetadata(self.output_name, meta_cols,
                              {f.name: f.history() for f in self.inputs}).reindexed()
        return Column.vector(np.hstack(blocks), meta)


class DateToUnitCircleVectorizer(SequenceTransformer):
    """Epoch-millis dates -> [cos, sin] per configured time period (a
    missing date -> the origin)."""

    sequence_input_type = Date
    output_type = OPVector

    time_periods = Param(default=tuple(TIME_PERIODS))

    def transform_columns(self, cols: List[Column], dataset):
        blocks = []
        meta_cols = []
        for f, col in zip(self.inputs, cols):
            ms = col.data.astype(np.int64)
            present = col.present()
            for period in self.time_periods:
                angle = 2.0 * np.pi * _period_values(ms, period) / _PERIOD_SIZE[period]
                cos = np.where(present, np.cos(angle), 0.0)
                sin = np.where(present, np.sin(angle), 0.0)
                blocks.append(np.column_stack([cos, sin]).astype(np.float32))
                for axis in ("x", "y"):
                    meta_cols.append(VectorColumnMetadata(
                        f.name, f.ftype.__name__, grouping=f.name,
                        descriptor_value=f"{axis}_{period}"))
        meta = VectorMetadata(self.output_name, meta_cols,
                              {f.name: f.history() for f in self.inputs}).reindexed()
        return Column.vector(np.hstack(blocks), meta)
