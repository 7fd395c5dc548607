"""Out-of-core chunked columnar store: tables bigger than host DRAM
(counterpart of ``transmogrifai_tpu/data/chunked.py``, copied).

A :class:`ChunkedDataset` holds columns as fixed-row-count chunks spilled to
disk as ``.npy`` files (numeric and vector kinds also readable as
memory-maps), so the host working set is a few chunk tiles, not the table.

- chunks are ``DEFAULT_CHUNK_ROWS`` = 8192 rows, the reference's value (the
  spill layout, the chunk offsets and the tail padding are what the parity
  tests compare); a chunked epoch (``workflow/ooc.py``) runs every chunk
  through the one chunk tile of its training plan, whose pinned staging and
  encode buffer are allocated once an epoch;
- spilling is driven by a host byte budget (``TMOG_HOST_BUDGET``, or
  ``Workflow.train(host_budget=)``): small tables stay plain in-memory
  ``Dataset`` objects, big ones spill;
- ``take`` gathers CHUNK-LOCALLY: indices are grouped by owning chunk and
  each chunk is read once, so peak RSS is one chunk plus the output, never
  the whole column (the fold takes and the test-split rely on this);
- new columns (a plan's outputs, model predictions) append chunk by chunk
  through :class:`ColumnChunkWriter`, which is what makes a chunked epoch
  crash-resumable: chunks already on disk are skipped on a re-run
  (``workflow/ooc.py`` + ``readers.OffsetCheckpoint``).
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple, Type

import numpy as np

from ..types import ColumnKind, FeatureType
from ..utils.vector_metadata import VectorMetadata
from .dataset import Column, Dataset

#: chunk row count (the reference's): one chunk == one tile of the epoch's
#: training plan, whose device buffers every chunk reuses
DEFAULT_CHUNK_ROWS = 8192

#: the longest column directory name (``ChunkStore._slug``)
MAX_SLUG = 200


def host_budget() -> Optional[int]:
    """The process host-DRAM byte budget (``TMOG_HOST_BUDGET``), or None.

    A malformed value RAISES instead of silently disabling the budget —
    the armed residency contract must fail closed (same philosophy as
    TM606), not fall back to unbounded materialization."""
    raw = os.environ.get("TMOG_HOST_BUDGET")
    if not raw:
        return None
    try:
        return int(float(raw))
    except ValueError:
        raise ValueError(
            f"TMOG_HOST_BUDGET must be a byte count, got {raw!r} — an "
            f"unparseable budget must not silently disarm the residency "
            f"gate") from None


def column_nbytes(col) -> int:
    """Host bytes a column materializes (data + validity mask)."""
    if isinstance(col, ChunkedColumn):
        return col.nbytes
    n = col.data.nbytes if col.data.dtype != object else \
        int(col.data.shape[0]) * 64  # object columns: rough per-ref estimate
    if col.mask is not None:
        n += col.mask.nbytes
    return int(n)


def dataset_nbytes(ds) -> int:
    return sum(column_nbytes(ds[name]) for name in ds.names)


class ChunkStore:
    """Directory of per-(column, chunk) ``.npy`` spill files + a manifest.

    Layout: ``<root>/<slug(column)>/c<chunk>.npy`` (+ ``.mask.npy``), with
    ``<root>/manifest.json`` recording column schemas after a finished
    write.  Numeric/vector chunks round-trip bitwise through ``np.save``;
    object-kind chunks (strings, lists, maps) pickle inside the npy
    container.  A store created without an explicit directory owns a temp
    dir and removes it at process exit.
    """

    def __init__(self, root: Optional[str] = None):
        if root is None:
            root = tempfile.mkdtemp(prefix="tmog-spill-")
            atexit.register(shutil.rmtree, root, True)
        os.makedirs(root, exist_ok=True)
        self.root = root

    @staticmethod
    def _slug(name: str) -> str:
        """The directory name of a column: its name with every character
        outside ``[A-Za-z0-9_.-]`` made ``_``.  A file name holds at most
        255 bytes and a combined vector's name lists every input, so a slug
        past :data:`MAX_SLUG` keeps its head and a digest of the name (the
        reference fails to spill such a column)."""
        import hashlib
        import re

        slug = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
        if len(slug) > MAX_SLUG:
            digest = hashlib.sha256(name.encode()).hexdigest()[:16]
            slug = f"{slug[:MAX_SLUG - 17]}-{digest}"
        return slug

    def _paths(self, name: str, ci: int) -> Tuple[str, str]:
        d = os.path.join(self.root, self._slug(name))
        return (os.path.join(d, f"c{ci:06d}.npy"),
                os.path.join(d, f"c{ci:06d}.mask.npy"))

    def has_chunk(self, name: str, ci: int) -> bool:
        return os.path.exists(self._paths(name, ci)[0])

    def write_chunk(self, name: str, ci: int, data: np.ndarray,
                    mask: Optional[np.ndarray]) -> int:
        """Persist one chunk; returns bytes written.  Writes go through a
        tmp+rename so a crash mid-write never leaves a torn chunk that a
        resumed epoch would mistake for a finished one."""
        dpath, mpath = self._paths(name, ci)
        os.makedirs(os.path.dirname(dpath), exist_ok=True)
        written = 0
        for path, arr in ((dpath, data), (mpath, mask)):
            if arr is None:
                continue
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                np.save(fh, arr, allow_pickle=arr.dtype == object)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            written += os.path.getsize(path)
        return written

    def read_chunk(self, name: str, ci: int, mmap: bool = False
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        dpath, mpath = self._paths(name, ci)
        mode = "r" if mmap else None
        data = np.load(dpath, mmap_mode=mode, allow_pickle=True)
        mask = np.load(mpath, mmap_mode=mode) if os.path.exists(mpath) \
            else None
        return data, mask

    def save_manifest(self, payload: Dict[str, Any]) -> None:
        tmp = os.path.join(self.root, "manifest.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True, default=repr)
        os.replace(tmp, os.path.join(self.root, "manifest.json"))


class ChunkedColumn:
    """A typed column stored as fixed-row chunks in a :class:`ChunkStore`.

    Quacks like :class:`Column` for schema purposes (``ftype``/``kind``/
    ``width``/``len``/``meta``) but its values live on disk; reads go chunk
    by chunk (``chunk``), via chunk-local gather (``take``), or through a
    full ``materialize`` (the small-table escape hatch).
    """

    __slots__ = ("ftype", "meta", "store", "name", "n_rows", "chunk_rows",
                 "_trailing", "_dtype", "_has_mask")

    def __init__(self, store: ChunkStore, name: str,
                 ftype: Type[FeatureType], n_rows: int, chunk_rows: int,
                 trailing: Tuple[int, ...], dtype: np.dtype,
                 has_mask: bool, meta: Optional[VectorMetadata] = None):
        self.store = store
        self.name = name
        self.ftype = ftype
        self.n_rows = int(n_rows)
        self.chunk_rows = int(chunk_rows)
        self._trailing = tuple(trailing)
        self._dtype = np.dtype(dtype)
        self._has_mask = bool(has_mask)
        self.meta = meta

    # -- schema ---------------------------------------------------------------
    def __len__(self) -> int:
        return self.n_rows

    @property
    def kind(self) -> ColumnKind:
        return self.ftype.kind

    @property
    def width(self) -> int:
        return self._trailing[0] if self._trailing else 1

    @property
    def is_numeric(self) -> bool:
        return self.kind in (ColumnKind.FLOAT, ColumnKind.INT,
                             ColumnKind.BOOL)

    @property
    def n_chunks(self) -> int:
        return -(-self.n_rows // self.chunk_rows) if self.n_rows else 0

    @property
    def nbytes(self) -> int:
        """Materialized host bytes of the FULL column (what spilling saves)."""
        item = self._dtype.itemsize if self._dtype != np.dtype(object) else 64
        per_row = item * (int(np.prod(self._trailing))
                          if self._trailing else 1)
        return self.n_rows * (per_row + (1 if self._has_mask else 0))

    def _rows_of(self, ci: int) -> int:
        lo = ci * self.chunk_rows
        return min(self.chunk_rows, self.n_rows - lo)

    # -- reads ----------------------------------------------------------------
    def chunk(self, ci: int, mmap: bool = False) -> Column:
        data, mask = self.store.read_chunk(self.name, ci, mmap=mmap)
        return Column(self.ftype, data, mask, self.meta)

    def take(self, indices: np.ndarray) -> Column:
        """Chunk-local gather: touched chunks are read ONCE each and only the
        requested rows copy out — peak RSS is one chunk + the output, never
        the full column (``tests/test_torch_ooc.py`` pins this)."""
        idx = np.asarray(indices)
        if idx.dtype == np.bool_:
            idx = np.flatnonzero(idx)
        idx = idx.astype(np.intp, copy=False)
        if idx.size and (int(idx.min()) < -self.n_rows
                         or int(idx.max()) >= self.n_rows):
            raise IndexError(
                f"take index out of bounds for column of {self.n_rows} rows")
        idx = np.where(idx < 0, idx + self.n_rows, idx)
        out_data = np.empty((idx.size,) + self._trailing, dtype=self._dtype)
        out_mask = np.empty(idx.size, dtype=np.bool_) if self._has_mask \
            else None
        if idx.size == 0:
            return Column(self.ftype, out_data, out_mask, self.meta)
        owner = idx // self.chunk_rows
        order = np.argsort(owner, kind="stable")
        sorted_owner = owner[order]
        starts = np.flatnonzero(np.r_[True, np.diff(sorted_owner) != 0])
        bounds = np.r_[starts, sorted_owner.size]
        for s, e in zip(bounds[:-1], bounds[1:]):
            ci = int(sorted_owner[s])
            pos = order[s:e]                       # output positions
            local = idx[pos] - ci * self.chunk_rows
            data, mask = self.store.read_chunk(self.name, ci)
            out_data[pos] = data[local]
            if out_mask is not None:
                out_mask[pos] = mask[local] if mask is not None else True
        return Column(self.ftype, out_data, out_mask, self.meta)

    def materialize(self) -> Column:
        """Assemble the full column in host memory (small-table/fallback
        path — the estimator-fit working set, see workflow/ooc.py)."""
        full = np.empty((self.n_rows,) + self._trailing, dtype=self._dtype)
        mask = np.empty(self.n_rows, dtype=np.bool_) if self._has_mask \
            else None
        for ci in range(self.n_chunks):
            lo = ci * self.chunk_rows
            data, m = self.store.read_chunk(self.name, ci)
            full[lo:lo + data.shape[0]] = data
            if mask is not None:
                mask[lo:lo + data.shape[0]] = m if m is not None else True
        return Column(self.ftype, full, mask, self.meta)

    def __repr__(self) -> str:
        return (f"ChunkedColumn<{self.ftype.__name__}>(n={self.n_rows}, "
                f"chunks={self.n_chunks}x{self.chunk_rows}, "
                f"kind={self.kind.value})")


class ColumnChunkWriter:
    """Appends one column chunk-by-chunk into a store; ``finish`` yields the
    :class:`ChunkedColumn`.  ``has_chunk`` lets a resumed epoch skip chunks
    a crashed run already persisted (crash-and-resume, workflow/ooc.py)."""

    def __init__(self, store: ChunkStore, name: str, chunk_rows: int):
        self.store = store
        self.name = name
        self.chunk_rows = int(chunk_rows)
        self._schema: Optional[tuple] = None
        self._rows = 0
        self.bytes_written = 0

    def has_chunk(self, ci: int) -> bool:
        return self.store.has_chunk(self.name, ci)

    def _note_schema(self, col: Column) -> None:
        trailing = tuple(col.data.shape[1:])
        sch = (col.ftype, trailing, col.data.dtype,
               col.mask is not None, col.meta)
        if self._schema is None:
            self._schema = sch
        elif sch[:4] != self._schema[:4]:
            raise ValueError(
                f"column {self.name!r}: chunk schema drifted from "
                f"{self._schema[:4]} to {sch[:4]} — chunked columns need a "
                f"fixed trailing shape/dtype (TM503: fix the width upstream)")

    def write(self, ci: int, col: Column) -> None:
        self._note_schema(col)
        self._rows += len(col)
        self.bytes_written += self.store.write_chunk(
            self.name, ci, col.data, col.mask)

    def note_existing(self, rows: int) -> None:
        """Account for a chunk a previous (crashed) run already persisted —
        the resume path skips recomputing it but its rows still count."""
        self._rows += int(rows)

    def finish(self, template: Optional[Column] = None) -> ChunkedColumn:
        """``template`` (a zero-row column from the metadata replay) supplies
        the schema when every chunk was inherited from a previous run."""
        if self._schema is None and template is not None:
            self._note_schema(template)
        if self._schema is None:
            raise ValueError(f"column {self.name!r}: no chunks written")
        ftype, trailing, dtype, has_mask, meta = self._schema
        if template is not None and template.meta is not None:
            meta = template.meta
        return ChunkedColumn(self.store, self.name, ftype, self._rows,
                             self.chunk_rows, trailing, dtype, has_mask,
                             meta)


class ChunkedDataset:
    """Out-of-core counterpart of :class:`Dataset`: equal-length columns that
    are either SPILLED (:class:`ChunkedColumn`, on disk) or RESIDENT (plain
    :class:`Column`, in host memory — small/exotic columns such as
    ``PredictionColumn`` ride along resident).

    Iteration surface: ``chunk(ci)`` returns a plain in-memory ``Dataset``
    of that row range, which is what the training plan and the serving plan
    consume: the chunked path feeds them the same tiles, one chunk at a
    time.
    """

    def __init__(self, spilled: Mapping[str, ChunkedColumn],
                 resident: Optional[Mapping[str, Column]] = None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 store: Optional[ChunkStore] = None,
                 order: Optional[Sequence[str]] = None,
                 data_token: str = ""):
        self._spilled: Dict[str, ChunkedColumn] = dict(spilled)
        self._resident: Dict[str, Column] = dict(resident or {})
        self.chunk_rows = int(chunk_rows)
        self.store = store
        #: identity of the INGESTED DATA (stamped fresh per ingestion, and
        #: persisted in the manifest): the chunked-epoch resume key includes
        #: it, so a re-ingest into the same spill dir can never resume over
        #: a previous ingest's output chunks
        self.data_token = str(data_token)
        ns = {len(c) for c in self._spilled.values()} \
            | {len(c) for c in self._resident.values()}
        if len(ns) > 1:
            raise ValueError(f"Column length mismatch across chunked store: {ns}")
        self._n_rows = next(iter(ns)) if ns else 0
        self._order: List[str] = list(order) if order is not None else \
            list(self._spilled) + [n for n in self._resident
                                   if n not in self._spilled]

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_dataset(cls, ds: Dataset, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                     spill_dir: Optional[str] = None,
                     store: Optional[ChunkStore] = None) -> "ChunkedDataset":
        """Spill an in-memory dataset to chunked form.  Subclassed columns
        (e.g. PredictionColumn, which carries extra state) stay resident."""
        import uuid

        store = store or ChunkStore(spill_dir)
        spilled: Dict[str, ChunkedColumn] = {}
        resident: Dict[str, Column] = {}
        n = ds.n_rows
        for name in ds.names:
            col = ds[name]
            if type(col) is not Column:
                resident[name] = col
                continue
            w = ColumnChunkWriter(store, name, chunk_rows)
            for ci, lo in enumerate(range(0, n, chunk_rows)):
                hi = min(lo + chunk_rows, n)
                mask = col.mask[lo:hi] if col.mask is not None else None
                w.write(ci, Column(col.ftype, col.data[lo:hi], mask,
                                   col.meta))
            spilled[name] = w.finish()
        out = cls(spilled, resident, chunk_rows=chunk_rows, store=store,
                  order=list(ds.names), data_token=uuid.uuid4().hex)
        out._save_manifest()
        return out

    @classmethod
    def open(cls, root: str) -> "ChunkedDataset":
        """Reopen a finished spill store from its manifest — the
        cross-process half of crash-and-resume (the same ``data_token`` is
        restored, so a chunked epoch resumed after a process restart keeps
        its committed offsets; a re-ingest stamps a new token and starts
        clean)."""
        from .. import types as _types

        store = ChunkStore(root)
        with open(os.path.join(root, "manifest.json")) as fh:
            manifest = json.load(fh)
        n_rows = int(manifest["n_rows"])
        chunk_rows = int(manifest["chunk_rows"])
        spilled: Dict[str, ChunkedColumn] = {}
        for name, meta in manifest["columns"].items():
            ftype = getattr(_types, meta["ftype"])
            spilled[name] = ChunkedColumn(
                store, name, ftype, n_rows, chunk_rows,
                tuple(meta["trailing"]), np.dtype(meta["dtype"]),
                bool(meta["has_mask"]))
        return cls(spilled, {}, chunk_rows=chunk_rows, store=store,
                   order=list(manifest["columns"]),
                   data_token=manifest.get("data_token", ""))

    def _save_manifest(self) -> None:
        if self.store is None:
            return
        self.store.save_manifest({
            "n_rows": self.n_rows, "chunk_rows": self.chunk_rows,
            "data_token": self.data_token,
            "columns": {n: {"ftype": c.ftype.__name__,
                            "trailing": list(c._trailing),
                            "dtype": str(c._dtype),
                            "has_mask": c._has_mask}
                        for n, c in self._spilled.items()}})

    # -- properties -----------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def names(self) -> List[str]:
        return list(self._order)

    @property
    def n_chunks(self) -> int:
        return -(-self._n_rows // self.chunk_rows) if self._n_rows else 0

    @property
    def spilled_names(self) -> List[str]:
        return list(self._spilled)

    @property
    def nbytes(self) -> int:
        """Bytes the table WOULD occupy fully materialized in host DRAM."""
        return sum(column_nbytes(self[n]) for n in self._order)

    @property
    def resident_nbytes(self) -> int:
        """Bytes actually resident in host DRAM (the non-spilled columns)."""
        return sum(column_nbytes(c) for c in self._resident.values())

    def __contains__(self, name: str) -> bool:
        return name in self._spilled or name in self._resident

    def __getitem__(self, name: str):
        if name in self._spilled:
            return self._spilled[name]
        if name in self._resident:
            return self._resident[name]
        raise KeyError(
            f"No column {name!r}; available: {sorted(self._order)}")

    def chunk_bounds(self, ci: int) -> Tuple[int, int]:
        lo = ci * self.chunk_rows
        return lo, min(lo + self.chunk_rows, self._n_rows)

    # -- reads ----------------------------------------------------------------
    def chunk(self, ci: int, names: Optional[Iterable[str]] = None) -> Dataset:
        """One row range as a plain in-memory Dataset (the tile every
        downstream consumer runs on)."""
        lo, hi = self.chunk_bounds(ci)
        use = list(names) if names is not None else self._order
        cols: Dict[str, Column] = {}
        for name in use:
            col = self[name]
            if isinstance(col, ChunkedColumn):
                cols[name] = col.chunk(ci)
            else:
                rng = np.arange(lo, hi, dtype=np.intp)
                cols[name] = col.take(rng)
        return Dataset(cols)

    def iter_chunks(self, names: Optional[Iterable[str]] = None
                    ) -> Iterator[Dataset]:
        for ci in range(self.n_chunks):
            yield self.chunk(ci, names=names)

    def take(self, indices: np.ndarray) -> Dataset:
        """Row subset as an IN-MEMORY dataset, gathered chunk-locally per
        column — the CV fold take path (workflow/fit.py) and the splitter
        land here; peak RSS is output + one chunk per column."""
        idx = np.asarray(indices)
        return Dataset({n: self[n].take(idx) for n in self._order})

    def split(self, test_fraction: float, seed: int = 42):
        """(train, test) — both materialize via chunk-local gather; use
        ``test_fraction=0`` for fits whose TRAIN split itself must stay
        out-of-core."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self._n_rows)
        n_test = int(round(self._n_rows * test_fraction))
        return self.take(perm[n_test:]), self.take(perm[:n_test])

    def select(self, names: Iterable[str]) -> "ChunkedDataset":
        keep = list(names)
        missing = [n for n in keep if n not in self]
        if missing:
            raise KeyError(f"No columns {missing!r}")
        return ChunkedDataset(
            {n: self._spilled[n] for n in keep if n in self._spilled},
            {n: self._resident[n] for n in keep if n in self._resident},
            chunk_rows=self.chunk_rows, store=self.store, order=keep,
            data_token=self.data_token)

    def materialize(self, names: Optional[Iterable[str]] = None) -> Dataset:
        """Assemble (a subset of) the table in host memory — the estimator
        fit working set and the small-table fallback."""
        use = list(names) if names is not None else self._order
        cols: Dict[str, Column] = {}
        for name in use:
            col = self[name]
            cols[name] = col.materialize() if isinstance(col, ChunkedColumn) \
                else col
        return Dataset(cols)

    # -- functional updates ---------------------------------------------------
    def with_resident_column(self, name: str, col: Column) -> "ChunkedDataset":
        resident = dict(self._resident)
        resident[name] = col
        order = self._order + ([name] if name not in self._order else [])
        return ChunkedDataset(self._spilled, resident,
                              chunk_rows=self.chunk_rows, store=self.store,
                              order=order, data_token=self.data_token)

    def with_spilled_columns(self, cols: Mapping[str, ChunkedColumn]
                             ) -> "ChunkedDataset":
        spilled = dict(self._spilled)
        spilled.update(cols)
        order = self._order + [n for n in cols if n not in self._order]
        return ChunkedDataset(spilled, self._resident,
                              chunk_rows=self.chunk_rows, store=self.store,
                              order=order, data_token=self.data_token)

    def __repr__(self) -> str:
        return (f"ChunkedDataset(n={self._n_rows}, "
                f"chunks={self.n_chunks}x{self.chunk_rows}, "
                f"spilled={len(self._spilled)}, "
                f"resident={len(self._resident)})")


class ChunkedDatasetWriter:
    """Streaming ingestion: feed row-chunk Datasets (e.g. straight off a
    Reader's record stream), get a :class:`ChunkedDataset` — the whole table
    is never host-resident.  Chunks must arrive in row order and (except the
    last) carry exactly ``chunk_rows`` rows; the readers' ingestion loop
    re-buckets arbitrary record batches upstream."""

    def __init__(self, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 spill_dir: Optional[str] = None,
                 store: Optional[ChunkStore] = None):
        self.chunk_rows = int(chunk_rows)
        self.store = store or ChunkStore(spill_dir)
        self._writers: Dict[str, ColumnChunkWriter] = {}
        self._order: List[str] = []
        self._ci = 0
        self._rows = 0
        self.bytes_written = 0

    def append(self, ds_chunk: Dataset) -> None:
        n = ds_chunk.n_rows
        if self._ci and self._rows != self._ci * self.chunk_rows:
            raise ValueError("only the final appended chunk may be partial")
        if n > self.chunk_rows:
            raise ValueError(f"chunk of {n} rows exceeds chunk_rows="
                             f"{self.chunk_rows}")
        for name in ds_chunk.names:
            w = self._writers.get(name)
            if w is None:
                if self._ci:
                    raise ValueError(
                        f"column {name!r} appeared mid-stream (chunk "
                        f"{self._ci}); all chunks must share one schema")
                w = self._writers[name] = ColumnChunkWriter(
                    self.store, name, self.chunk_rows)
                self._order.append(name)
            w.write(self._ci, ds_chunk[name])
        missing = set(self._writers) - set(ds_chunk.names)
        if missing:
            raise ValueError(f"chunk {self._ci} is missing columns "
                             f"{sorted(missing)}")
        self._ci += 1
        self._rows += n
        self.bytes_written = sum(w.bytes_written
                                 for w in self._writers.values())

    def finish(self) -> ChunkedDataset:
        import uuid

        spilled = {n: w.finish() for n, w in self._writers.items()}
        out = ChunkedDataset(spilled, {}, chunk_rows=self.chunk_rows,
                             store=self.store, order=self._order,
                             data_token=uuid.uuid4().hex)
        out._save_manifest()
        return out


def maybe_chunk(ds, budget: Optional[int] = None,
                chunk_rows: int = DEFAULT_CHUNK_ROWS,
                spill_dir: Optional[str] = None):
    """Spill ``ds`` to a :class:`ChunkedDataset` when its materialized bytes
    exceed the budget (explicit argument, else ``TMOG_HOST_BUDGET``); the
    in-memory Dataset is the small-table fast path and returns unchanged.
    Chunked input passes through untouched."""
    if isinstance(ds, ChunkedDataset):
        return ds
    budget = host_budget() if budget is None else int(budget)
    if budget is None or dataset_nbytes(ds) <= budget:
        return ds
    from ..obs import flight as obs_flight

    # a spill activation is a capacity incident worth a postmortem trail:
    # the flight recorder (when installed) keeps the exact trigger sizes
    obs_flight.record_event("spill_activation",
                            dataset_bytes=int(dataset_nbytes(ds)),
                            host_budget=int(budget),
                            chunk_rows=int(chunk_rows))
    return ChunkedDataset.from_dataset(ds, chunk_rows=chunk_rows,
                                       spill_dir=spill_dir)


def as_dataset(ds, names: Optional[Iterable[str]] = None) -> Dataset:
    """Materialize a (possibly chunked) dataset — evaluation and other
    whole-column consumers funnel through here."""
    if isinstance(ds, ChunkedDataset):
        return ds.materialize(names=names)
    return ds.select(names) if names is not None else ds
