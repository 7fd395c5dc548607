"""Columnar dataset on the host (counterpart of ``transmogrifai_tpu/data/dataset.py``).

A ``Dataset`` is an ordered mapping of name -> ``Column``.  Numeric columns
are dense numpy arrays plus validity masks; text, list and set columns are
object arrays; a geolocation column is an (n, 3) float64 block of [lat, lon,
accuracy] plus a validity mask (zeros where missing); OPVector columns are (n, d) float32 blocks with attached ``VectorMetadata``.
Device tensors never live here: the transform plans (``workflow/plan.py``,
``serve/plan.py``) move the operands they need to the device and bring their
outputs back as numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Type

import numpy as np

from ..types import ColumnKind, FeatureType, NonNullableEmptyException, OPVector
from ..utils.vector_metadata import VectorMetadata

_NUMERIC_DTYPES = {
    ColumnKind.FLOAT: np.float64,
    ColumnKind.INT: np.int64,
    ColumnKind.BOOL: np.bool_,
}


class Column:
    """A single typed column: values + (for numeric kinds) validity mask."""

    __slots__ = ("ftype", "data", "mask", "meta")

    def __init__(self, ftype: Type[FeatureType], data: np.ndarray,
                 mask: Optional[np.ndarray] = None,
                 meta: Optional[VectorMetadata] = None):
        self.ftype = ftype
        self.data = data
        self.mask = mask
        self.meta = meta

    @classmethod
    def from_values(cls, ftype: Type[FeatureType], values: Sequence[Any],
                    meta: Optional[VectorMetadata] = None) -> "Column":
        """Build a column from raw python values (validated/converted through ftype)."""
        kind = ftype.kind
        conv = [ftype._convert(v.value if isinstance(v, FeatureType) else v)
                for v in values]
        if not ftype.is_nullable:
            for i, v in enumerate(conv):
                if v is None:
                    raise NonNullableEmptyException(
                        f"{ftype.__name__} column cannot contain missing values (row {i})")
        n = len(conv)
        if kind in _NUMERIC_DTYPES:
            mask = np.array([v is not None for v in conv], dtype=np.bool_)
            data = np.zeros(n, dtype=_NUMERIC_DTYPES[kind])
            for i, v in enumerate(conv):
                if v is not None:
                    data[i] = v
            return cls(ftype, data, mask, meta)
        if kind is ColumnKind.GEO:
            mask = np.array([len(v) == 3 for v in conv], dtype=np.bool_)
            data = np.zeros((n, 3), dtype=np.float64)
            for i, v in enumerate(conv):
                if len(v) == 3:
                    data[i] = v
            return cls(ftype, data, mask, meta)
        if kind is ColumnKind.VECTOR:
            width = max((len(v) for v in conv), default=0)
            data = np.zeros((n, width), dtype=np.float32)
            for i, v in enumerate(conv):
                data[i, : len(v)] = v
            return cls(ftype, data, None, meta)
        arr = np.empty(n, dtype=object)
        for i, v in enumerate(conv):
            arr[i] = v
        return cls(ftype, arr, None, meta)

    @classmethod
    def vector(cls, data: np.ndarray, meta: Optional[VectorMetadata] = None) -> "Column":
        data = np.asarray(data)
        if data.ndim != 2:
            raise ValueError(f"vector column must be 2-D, got shape {data.shape}")
        if meta is not None and meta.size != data.shape[1]:
            raise ValueError(
                f"vector metadata size {meta.size} != column width {data.shape[1]}")
        return cls(OPVector, data.astype(np.float32, copy=False), None, meta)

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def take(self, indices: np.ndarray) -> "Column":
        """The rows at ``indices`` (positions), type and metadata kept."""
        indices = np.asarray(indices)
        mask = self.mask[indices] if self.mask is not None else None
        return Column(self.ftype, self.data[indices], mask, self.meta)

    @property
    def kind(self) -> ColumnKind:
        return self.ftype.kind

    @property
    def width(self) -> int:
        return int(self.data.shape[1]) if self.data.ndim == 2 else 1

    @property
    def is_numeric(self) -> bool:
        return self.kind in _NUMERIC_DTYPES

    def values_f64(self) -> np.ndarray:
        """Numeric values as float64 with NaN for missing."""
        if not self.is_numeric:
            raise TypeError(f"values_f64 on non-numeric column of kind {self.kind}")
        out = self.data.astype(np.float64)
        if self.mask is not None:
            out = np.where(self.mask, out, np.nan)
        return out

    def present(self) -> np.ndarray:
        if self.mask is not None:
            return self.mask
        if self.kind is ColumnKind.VECTOR:
            return np.ones(len(self), dtype=np.bool_)
        return np.array([not _is_empty_obj(v) for v in self.data], dtype=np.bool_)

    def to_values(self) -> List[Any]:
        """Raw python values (None where missing; [] for a missing
        geolocation, and lists and sets as stored)."""
        if self.is_numeric:
            py = self.data.tolist()
            if self.mask is None:
                return py
            return [v if m else None for v, m in zip(py, self.mask)]
        if self.kind is ColumnKind.GEO:
            return [list(row) if m else []
                    for row, m in zip(self.data.tolist(), self.present())]
        if self.kind is ColumnKind.VECTOR:
            return [np.asarray(row) for row in self.data]
        return list(self.data)

    def __repr__(self) -> str:
        return f"Column<{self.ftype.__name__}>(n={len(self)}, kind={self.kind.value})"


def _is_empty_obj(v: Any) -> bool:
    if v is None:
        return True
    if isinstance(v, (str, list, set, dict, tuple)):
        return len(v) == 0
    return False


class Dataset:
    """Immutable ordered collection of equal-length columns."""

    __slots__ = ("_columns",)

    def __init__(self, columns: Mapping[str, Column]):
        ns = {len(c) for c in columns.values()}
        if len(ns) > 1:
            raise ValueError(
                f"Column length mismatch: { {k: len(c) for k, c in columns.items()} }")
        self._columns: Dict[str, Column] = dict(columns)

    @classmethod
    def from_features(cls, values: Mapping[str, Sequence[Any]],
                      ftypes: Mapping[str, Type[FeatureType]]) -> "Dataset":
        return cls({k: Column.from_values(ftypes[k], v) for k, v in values.items()})

    @property
    def n_rows(self) -> int:
        for c in self._columns.values():
            return len(c)
        return 0

    @property
    def names(self) -> List[str]:
        return list(self._columns)

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, name: str) -> Column:
        try:
            return self._columns[name]
        except KeyError:
            raise KeyError(
                f"No column {name!r}; available: {sorted(self._columns)}") from None

    def with_column(self, name: str, col: Column) -> "Dataset":
        new = dict(self._columns)
        new[name] = col
        return Dataset(new)

    def with_columns(self, cols: Mapping[str, Column]) -> "Dataset":
        new = dict(self._columns)
        new.update(cols)
        return Dataset(new)

    def select(self, names: Iterable[str]) -> "Dataset":
        return Dataset({n: self[n] for n in names})

    def drop(self, names: Iterable[str]) -> "Dataset":
        drop = set(names)
        return Dataset({n: c for n, c in self._columns.items() if n not in drop})

    def take(self, indices: np.ndarray) -> "Dataset":
        """The rows at ``indices`` (positions) of every column."""
        idx = np.asarray(indices)
        return Dataset({n: c.take(idx) for n, c in self._columns.items()})

    def split(self, test_fraction: float, seed: int = 42):
        """(train, test): a numpy permutation from ``seed``, its first
        round(n * test_fraction) rows the test part -- the reference's
        draw, so both packages split alike."""
        n = self.n_rows
        perm = np.random.default_rng(seed).permutation(n)
        n_test = int(round(n * test_fraction))
        return self.take(perm[n_test:]), self.take(perm[:n_test])

    def to_pandas(self):
        """A pandas DataFrame of the python values (a vector column's rows as
        arrays); imports pandas here, as the reference does."""
        import pandas as pd

        out = {}
        for name, col in self._columns.items():
            if col.kind is ColumnKind.VECTOR:
                out[name] = list(col.data)
            else:
                out[name] = col.to_values()
        return pd.DataFrame(out)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.ftype.__name__}" for n, c in self._columns.items())
        return f"Dataset(n={self.n_rows}, [{cols}])"
