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

#: slab granularity of the memmap-aware gather — matches the chunked store's
#: row-bucket tile (data/chunked.py), so a spilled column's pages are touched
#: once, chunk by chunk, in ascending order
_GATHER_SLAB_ROWS = 8192


def _gather_rows(data: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Row gather that is memory-map aware.

    Plain arrays take the numpy fancy-index fast path.  For a ``np.memmap``
    source the indices are visited in ASCENDING order in bounded slabs
    (chunk-local gather): each touched page is read once, sequentially, and
    the full column is never materialized in host DRAM — peak RSS is the
    output plus one slab (``tests/test_torch_ooc.py`` pins this).
    """
    if not isinstance(data, np.memmap):
        return data[idx]
    if idx.dtype == np.bool_:
        idx = np.flatnonzero(idx)
    idx = idx.astype(np.intp, copy=False)
    n_rows = data.shape[0]
    if idx.size and (int(idx.min()) < -n_rows or int(idx.max()) >= n_rows):
        # same contract as the plain-array path (numpy raises); a single
        # +n wrap would silently alias out-of-range indices to valid rows
        raise IndexError(
            f"take index out of bounds for memmap of {n_rows} rows")
    idx = np.where(idx < 0, idx + n_rows, idx)
    order = np.argsort(idx, kind="stable")
    sorted_idx = idx[order]
    out = np.empty((idx.shape[0],) + data.shape[1:], dtype=data.dtype)
    row_bytes = int(np.prod(data.shape[1:], dtype=np.int64)) \
        * data.dtype.itemsize
    release = _mmap_releaser(data)
    step = _GATHER_SLAB_ROWS
    s = 0
    while s < sorted_idx.size:
        # one slab-aligned group of indices at a time, ascending
        slab = int(sorted_idx[s]) // step
        e = int(np.searchsorted(sorted_idx, (slab + 1) * step, side="left"))
        sl, pos = sorted_idx[s:e], order[s:e]
        if sl.size * 32 >= step:
            # dense group: one sequential slab read, in-memory gather
            lo = slab * step
            block = np.asarray(data[lo:min(lo + step, data.shape[0])])
            out[pos] = block[sl - lo]
        else:
            # sparse group: per-element reads touch only the pages holding
            # the requested rows (a whole-group fancy-index on a memmap
            # faults the entire map resident)
            for j in range(sl.size):
                out[pos[j]] = data[sl[j]]
        # drop the map's resident pages up to the end of this group: the
        # ascending walk never revisits them, and without the release the
        # kernel's fault-around keeps every touched (clean, file-backed)
        # page counted in RSS until memory pressure — exactly the residency
        # the budget gate is supposed to bound
        release((slab + 1) * step * row_bytes)
        s = e
    return out


def _mmap_releaser(data: "np.memmap"):
    """Page-release hook for the ascending memmap gather: returns
    ``release(end_byte)`` advising the kernel the map's prefix up to
    ``end_byte`` (array-relative) is no longer needed.  No-op where madvise
    is unavailable; pages refault transparently if re-read later."""
    import mmap as _mmap_mod

    buf = getattr(data, "_mmap", None)
    advise = getattr(buf, "madvise", None)
    dontneed = getattr(_mmap_mod, "MADV_DONTNEED", None)
    if advise is None or dontneed is None:  # pragma: no cover — non-linux
        return lambda end_byte: None
    page = _mmap_mod.PAGESIZE
    base = int(getattr(data, "offset", 0))
    prev = 0  # high-water mark: advise only the newly-consumed delta

    def release(end_byte: int) -> None:
        nonlocal prev
        end = min(((base + end_byte) // page) * page,  # floor: never drop ahead
                  len(buf))
        if end <= prev:
            return
        try:
            advise(dontneed, prev, end - prev)
        except (OSError, ValueError):  # pragma: no cover — best-effort
            pass
        prev = end

    return release



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
        mask = _gather_rows(self.mask, indices) if self.mask is not None else None
        return Column(self.ftype, _gather_rows(self.data, indices), mask, self.meta)

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

    def fill_rate(self) -> float:
        n = len(self)
        return float(self.present().sum() / n) if n else 0.0

    def to_values(self, ftype: Optional[Type[FeatureType]] = None) -> List[Any]:
        """Raw python values (None where missing; [] for a missing
        geolocation, and lists and sets as stored).  ``ftype`` is the
        reference's signature; the values are the same for any type."""
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

    def to_feature_values(self) -> List[FeatureType]:
        return [self.ftype(v) for v in self.to_values()]

    def concat(self, *others: "Column") -> "Column":
        """This column's rows followed by each of ``others``', in one pass
        (same type; the metadata is this column's)."""
        if any(o.ftype is not self.ftype for o in others):
            raise TypeError("cannot concat columns of different types")
        parts = (self,) + others
        data = np.concatenate([p.data for p in parts])
        if all(p.mask is None for p in parts):
            mask = None
        else:
            mask = np.concatenate([p.mask if p.mask is not None
                                   else np.ones(len(p), dtype=np.bool_)
                                   for p in parts])
        return Column(self.ftype, data, mask, self.meta)

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

    @classmethod
    def empty(cls) -> "Dataset":
        return cls({})

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

    def concat(self, other: "Dataset") -> "Dataset":
        """This dataset's rows followed by ``other``'s (the same columns)."""
        if set(self.names) != set(other.names):
            raise ValueError("cannot concat datasets with different columns")
        return Dataset({n: c.concat(other[n]) for n, c in self._columns.items()})

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

    def row(self, i: int) -> Dict[str, Any]:
        """Row ``i`` as {name: python value} (None / [] where missing; a
        vector column's row as an array)."""
        out: Dict[str, Any] = {}
        for n, c in self._columns.items():
            if c.is_numeric:
                out[n] = c.data[i].item() if (c.mask is None or c.mask[i]) else None
            elif c.kind is ColumnKind.GEO:
                out[n] = list(c.data[i]) if (c.mask is None or c.mask[i]) else []
            elif c.kind is ColumnKind.VECTOR:
                out[n] = np.asarray(c.data[i])
            else:
                out[n] = c.data[i]
        return out

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.ftype.__name__}" for n, c in self._columns.items())
        return f"Dataset(n={self.n_rows}, [{cols}])"
