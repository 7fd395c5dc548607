"""Serving-prefix encode kernel: level-code one-hot (K4) and bucketize (K5)
slots, all of a batch in one launch driven by a slot table.

Counterpart of ``transmogrifai_tpu/perf/kernels/encode.py``, whose two Pallas
kernels become one CUDA kernel (``csrc/encode.cu``).  The pieces here:

- the planner (:func:`plan_slots` -> :class:`SlotTable`), pure Python: each
  slot's kind, width and column offset in the table's one output, the
  splits packed into one buffer, and the chunks of at most
  :data:`MAX_SLOTS` slots one launch takes, whose splits fit in shared
  memory (:data:`MAX_SPLITS`); a bucketize slot with more splits than that
  is a chunk of its own, whose launch reads them from global memory;
  :func:`slot_table` caches the plan of a tuple of slots;
- the wrapper (:func:`encode_slots`): checks device, dtype, shape,
  contiguity and alignment, launches the kernel once per chunk on the current
  stream without synchronising, and counts each launch in
  ``encode_slots_launches`` (and the slots in ``slots_encoded``), and in
  the launching thread's own count (:func:`thread_encode_launches`: a
  training flush reads its own launches while a server's batches launch
  on other threads).  A CPU tensor takes the plain version instead; a meta
  tensor gets its output's shape only (``checkers/plancheck.py`` sizes the
  prefix with them); any other device raises, and a failed build or
  launch raises :class:`dispatch.KernelError`;
- the plain PyTorch version (:func:`encode_slots_torch`): the reference's XLA
  formulas (:func:`onehot_codes_torch`, :func:`bucketize_right_encode_torch`,
  bitwise equal to the JAX kernels, and :func:`bucketize_left_encode_torch`,
  bitwise equal to ``NumericBucketizer.device_transform``) applied slot by
  slot.  The CPU plan and
  the tests use it, and ``chip_smoke.py`` holds the kernel against it;
- the one-slot wrappers :func:`onehot_codes` and
  :func:`bucketize_right_encode`, one-slot tables of the same kernel, each
  with its own launch counter (``onehot_launches``, ``bucketize_launches``).

Every counter is a plain integer that only a kernel launch increments.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dispatch

onehot_launches = 0
bucketize_launches = 0
encode_slots_launches = 0
slots_encoded = 0
#: launches of encode_slots whose chunk held a left-closed bucketize slot,
#: and those slots
left_closed_launches = 0
left_closed_slots = 0
#: the encode_slots launches of each thread (``encode_slots`` attribute)
_thread = threading.local()

#: slots a launch takes: the table travels as a kernel parameter of <= 4 KB
#: (encode.cu: kMaxSlots); a longer table launches in chunks
MAX_SLOTS = 64
#: splits a launch stages in shared memory (encode.cu: kMaxSplits); a slot
#: with more is launched alone and reads its splits from global memory
MAX_SPLITS = 4096
#: columns of an output (keeps the kernel's column indices in int32)
MAX_OUTPUT_WIDTH = 1 << 24

ONEHOT, BUCKETIZE = "onehot", "bucketize"
#: which edge of a bucket belongs to it: "right" (K5's ``(s[i], s[i+1]]``,
#: the tree bucketizer's) or "left" (``[s[i], s[i+1])``, NumericBucketizer's)
CLOSED = ("right", "left")
_KIND_BUCKETIZE, _TRACK_INVALID, _TRACK_NULLS, _LEFT_CLOSED = 1, 2, 4, 8
#: int64 fields of a table row: col, width, kind, split_off, n_splits
#: (encode.cu: tmog_encode_slots)
_FIELDS = 5

_VP, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"tmog_encode_slots": (_VP, _VP, _INT, _I64, _VP, _I64, _VP, _INT, _VP)}


def reset_launch_counts() -> None:
    global onehot_launches, bucketize_launches, encode_slots_launches, slots_encoded
    global left_closed_launches, left_closed_slots
    onehot_launches = bucketize_launches = 0
    encode_slots_launches = slots_encoded = 0
    left_closed_launches = left_closed_slots = 0
    _thread.encode_slots = 0


def launch_counts() -> dict:
    return {"onehot_codes": onehot_launches,
            "bucketize_right_encode": bucketize_launches,
            "encode_slots": encode_slots_launches,
            "encode_slots.slots": slots_encoded}


def thread_encode_launches() -> int:
    """The calling thread's encode_slots launches (zeroed for it by
    :func:`reset_launch_counts`)."""
    return getattr(_thread, "encode_slots", 0)


def _lib():
    return dispatch.load("encode", _SIGNATURES)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on unsupported device {t.device}")


# -- the slot planner -----------------------------------------------------------

class SlotSpec(NamedTuple):
    """One slot: a one-hot of ``width`` columns over int32 codes, or a
    bucketize one-hot over float32 values with its ``splits``, flags and
    closed edge (``closed``, default "right": a table saved before the
    left-closed kind keeps its meaning)."""
    kind: str
    width: int = 0
    splits: Tuple[float, ...] = ()
    track_nulls: bool = False
    track_invalid: bool = False
    closed: str = "right"


def onehot_slot(width: int) -> SlotSpec:
    return SlotSpec(ONEHOT, width=int(width))


def bucketize_slot(splits: Sequence[float], track_nulls: bool,
                   track_invalid: bool, closed: str = "right") -> SlotSpec:
    splits = tuple(float(s) for s in np.asarray(splits, np.float32))
    return SlotSpec(BUCKETIZE, width=bucket_width(len(splits), track_nulls,
                                                  track_invalid),
                    splits=splits, track_nulls=bool(track_nulls),
                    track_invalid=bool(track_invalid), closed=closed)


def bucket_width(n_splits: int, track_nulls: bool, track_invalid: bool) -> int:
    return n_splits - 1 + int(bool(track_invalid)) + int(bool(track_nulls))


class SlotTable:
    """A planned slot table (:func:`plan_slots`): its slots write adjacent
    columns of one (n, ``width``) output, in slot order.

    ``col[k]`` is slot k's first column, ``splits`` the slots' splits packed
    in slot order (``split_off[k]`` is slot k's first), ``chunks`` the
    ``(first, end)`` slot ranges one launch each takes, and ``rows`` the
    int64 fields of each slot's table row, its split offset counted from its
    chunk's first split (the input pointers are added at launch)."""

    def __init__(self, specs: Sequence[SlotSpec]):
        self.specs = tuple(specs)
        self.col: List[int] = []
        self.split_off: List[int] = []
        width, packed = 0, []
        for s in self.specs:
            self.col.append(width)
            self.split_off.append(len(packed))
            width += s.width
            packed.extend(s.splits)
        if width > MAX_OUTPUT_WIDTH:
            raise ValueError(f"an output of {width} columns exceeds {MAX_OUTPUT_WIDTH}")
        self.width = width
        self.splits = np.asarray(packed, np.float32)
        self.in_dtypes = tuple(torch.int32 if s.kind == ONEHOT else torch.float32
                               for s in self.specs)
        self.chunks: List[Tuple[int, int]] = []
        lo = 0
        for k, s in enumerate(self.specs):
            n_split = self.split_off[k] + len(s.splits) - self.split_off[lo]
            if k > lo and (k - lo == MAX_SLOTS or n_split > MAX_SPLITS
                           or len(s.splits) > MAX_SPLITS):
                self.chunks.append((lo, k))
                lo = k
            if len(s.splits) > MAX_SPLITS:      # alone: its splits stay global
                self.chunks.append((lo, k + 1))
                lo = k + 1
        if lo < len(self.specs):
            self.chunks.append((lo, len(self.specs)))
        self.rows = np.zeros((len(self.specs), _FIELDS), np.int64)
        bounds = self.split_off + [len(packed)]
        #: per chunk: (first slot, slots, its rows' address, its splits' first
        #: and count) -- what a launch passes besides pointers
        self._launches: List[Tuple[int, int, int, int, int]] = []
        for lo, hi in self.chunks:
            for k in range(lo, hi):
                s = self.specs[k]
                kind = 0 if s.kind == ONEHOT else (
                    _KIND_BUCKETIZE | _TRACK_INVALID * s.track_invalid
                    | _TRACK_NULLS * s.track_nulls
                    | _LEFT_CLOSED * (s.closed == "left"))
                self.rows[k] = (self.col[k], s.width, kind,
                                self.split_off[k] - bounds[lo], len(s.splits))
            self._launches.append((lo, hi - lo,
                                   self.rows.ctypes.data + 8 * _FIELDS * lo,
                                   bounds[lo], bounds[hi] - bounds[lo]))
        left = [s.kind == BUCKETIZE and s.closed == "left" for s in self.specs]
        #: left-closed slots, and the chunks that hold one
        self.n_left = sum(left)
        self.left_chunks = sum(any(left[lo:hi]) for lo, hi in self.chunks)
        self._splits_on = {}

    def __len__(self) -> int:
        return len(self.specs)

    def splits_on(self, device: torch.device) -> torch.Tensor:
        """The packed splits on ``device``, copied there once."""
        t = self._splits_on.get(device)
        if t is None:
            t = torch.from_numpy(self.splits.copy()).to(device)
            self._splits_on[device] = t
        return t


def plan_slots(specs: Sequence[SlotSpec]) -> SlotTable:
    """Plan a slot table; refuses an empty table, a width <= 0, a bucketize
    slot with fewer than 2 splits, an unknown kind and an unknown closed
    edge.  A bucketize slot takes any count of splits past that."""
    specs = list(specs)
    if not specs:
        raise ValueError("a slot table needs at least one slot")
    for k, s in enumerate(specs):
        if s.kind not in (ONEHOT, BUCKETIZE):
            raise ValueError(f"slot {k}: unknown kind {s.kind!r}")
        if s.kind == BUCKETIZE:
            if len(s.splits) < 2:
                raise ValueError(f"slot {k}: a bucketize slot needs at least 2 "
                                 f"splits, got {len(s.splits)}")
            if s.closed not in CLOSED:
                raise ValueError(f"slot {k}: unknown closed edge {s.closed!r}")
            if s.width != bucket_width(len(s.splits), s.track_nulls, s.track_invalid):
                raise ValueError(f"slot {k}: width {s.width} does not match its "
                                 "splits and flags")
        if s.width <= 0:
            raise ValueError(f"slot {k}: width must be positive, got {s.width}")
    return SlotTable(specs)


@functools.lru_cache(maxsize=1024)
def slot_table(specs: Tuple[SlotSpec, ...]) -> SlotTable:
    """:func:`plan_slots` of ``specs``, planned once for each tuple of slots
    (a stage that encodes its own slots asks for its table every call)."""
    return plan_slots(specs)


# -- plain versions -------------------------------------------------------------

def onehot_codes_torch(codes: torch.Tensor, width: int) -> torch.Tensor:
    """(n, width) float32 one-hot of int32 codes with ``jax.nn.one_hot``
    semantics: a negative or out-of-range code gives an all-zero row."""
    ids = torch.arange(width, dtype=torch.int32, device=codes.device)
    return (codes.to(torch.int32)[:, None] == ids).to(torch.float32)


def bucketize_right_encode_torch(x: torch.Tensor, splits: torch.Tensor,
                                 track_nulls: bool,
                                 track_invalid: bool) -> torch.Tensor:
    """Right-inclusive bucketize one-hot of ``x`` (float32, NaN = missing)
    over ``splits`` (S >= 2 sorted edges): buckets ``(s[i], s[i+1]]``, then
    the optional invalid and null columns — the reference's XLA formula
    (``ops/bucketizers.py:183-194``)."""
    n_buckets = int(splits.shape[0]) - 1
    present = ~torch.isnan(x)
    finite = present & torch.isfinite(x)
    v0 = torch.nan_to_num(x)
    idx = torch.clamp(torch.searchsorted(splits, v0, side="left") - 1,
                      0, n_buckets - 1)
    in_range = finite & (x > splits[0]) & (x <= splits[-1])
    ids = torch.arange(n_buckets, device=x.device)
    parts = [(idx[:, None] == ids).to(torch.float32)
             * in_range.to(torch.float32)[:, None]]
    if track_invalid:
        parts.append((present & ~in_range).to(torch.float32)[:, None])
    if track_nulls:
        parts.append((~present).to(torch.float32)[:, None])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def bucketize_left_encode_torch(x: torch.Tensor, splits: torch.Tensor,
                                track_nulls: bool,
                                track_invalid: bool) -> torch.Tensor:
    """Left-closed bucketize one-hot of ``x`` (float32, NaN = missing) over
    ``splits`` (S >= 2 sorted edges): bucket ``count(s <= v0) - 1`` clipped
    to [0, S-2], ``v0 = nan_to_num(x)``; the bucket's column is set when
    ``s[0] <= x <= s[S-1]`` (on ``x``: +inf is in range when ``s[S-1]`` is
    +inf), or for any present value without ``track_invalid`` (out of range
    clamps to the edge bucket); then the optional invalid and null columns
    -- the reference's ``NumericBucketizer.device_transform``
    (``ops/scalers.py:115-138``)."""
    n_buckets = int(splits.shape[0]) - 1
    ok = ~torch.isnan(x)
    v0 = torch.nan_to_num(x)
    idx = torch.clamp(torch.searchsorted(splits, v0, side="right") - 1,
                      0, n_buckets - 1)
    in_range = ok & (x >= splits[0]) & (x <= splits[-1])
    sel = in_range if track_invalid else ok
    ids = torch.arange(n_buckets, device=x.device)
    parts = [(idx[:, None] == ids).to(torch.float32)
             * sel.to(torch.float32)[:, None]]
    if track_invalid:
        parts.append((ok & ~in_range).to(torch.float32)[:, None])
    if track_nulls:
        parts.append((~ok).to(torch.float32)[:, None])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def encode_slots_torch(inputs: Sequence[torch.Tensor], table: SlotTable,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`encode_slots`: each slot's block by the
    reference's formula, written into its columns of the output."""
    out = _output(table, _check_inputs(inputs, table), inputs[0].device, out)
    for k, (x, s) in enumerate(zip(inputs, table.specs)):
        if s.kind == ONEHOT:
            block = onehot_codes_torch(x, s.width)
        else:
            off = table.split_off[k]
            splits = table.splits_on(x.device)[off:off + len(s.splits)]
            plain = (bucketize_left_encode_torch if s.closed == "left"
                     else bucketize_right_encode_torch)
            block = plain(x, splits, s.track_nulls, s.track_invalid)
        out[:, table.col[k]:table.col[k] + s.width] = block
    return out


# -- the kernel's wrappers ------------------------------------------------------

def _check_inputs(inputs: Sequence[torch.Tensor], table: SlotTable) -> int:
    """Check the inputs against the table in one pass; returns their rows."""
    if len(inputs) != len(table):
        raise ValueError(f"{len(inputs)} inputs for a table of {len(table)} slots")
    x0 = inputs[0]
    n, dev = (int(x0.shape[0]) if x0.dim() == 1 else -1), x0.device
    for k, (x, want) in enumerate(zip(inputs, table.in_dtypes)):
        if x.dtype == want and x.dim() == 1 and x.shape[0] == n \
                and x.device == dev and x.is_contiguous():
            continue
        _check(x, f"input {k}", want, 1)   # raises with the reason
        if x.device != dev:
            raise ValueError(f"input {k} on {x.device}, input 0 on {dev}")
        raise ValueError(f"input {k} has {int(x.shape[0])} rows, input 0 has {n}")
    return n


def _output(table: SlotTable, n: int, dev: torch.device,
            out: Optional[torch.Tensor]) -> torch.Tensor:
    """Check ``out`` against the table, or allocate it."""
    if out is None:
        return torch.empty((n, table.width), dtype=torch.float32, device=dev)
    if out.dtype != torch.float32 or out.dim() != 2:
        raise TypeError("the output must be a 2-D float32 tensor")
    if tuple(out.shape) != (n, table.width):
        raise ValueError(f"the output has shape {tuple(out.shape)}, the table "
                         f"writes ({n}, {table.width})")
    if out.device != dev:
        raise ValueError(f"the output on {out.device}, inputs on {dev}")
    if out.stride(1) != 1 or (n > 1 and out.stride(0) < table.width):
        raise ValueError(f"the output's columns must be contiguous, strides "
                         f"{out.stride()}")
    if out.data_ptr() % 4:
        raise ValueError("the output is not 4-byte aligned")
    return out


def _launch(inputs: Sequence[torch.Tensor], table: SlotTable, out: torch.Tensor,
            splits: Optional[torch.Tensor], what: str) -> int:
    """Launch the kernel once per chunk of the table (``splits``: the packed
    splits on the inputs' device, None for a table without any); returns
    the launches."""
    n = int(inputs[0].shape[0])
    if n == 0:
        return 0
    ins = (_I64 * len(inputs))(*[x.data_ptr() for x in inputs])
    ins_at = ctypes.addressof(ins)
    fn = _lib().tmog_encode_slots
    stream = dispatch.stream_handle(inputs[0].device)
    out_ptr, stride = out.data_ptr(), out.stride(0)
    splits_ptr = splits.data_ptr() if splits is not None else 0
    for lo, count, rows_at, split0, n_splits in table._launches:
        err = fn(ins_at + 8 * lo, rows_at, count, n, out_ptr, stride,
                 splits_ptr + 4 * split0 if n_splits else None, n_splits, stream)
        dispatch.check_launch(err, what)
    return len(table.chunks)


def encode_slots(inputs: Sequence[torch.Tensor], table: SlotTable,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode every slot of ``table`` into its columns of ``out``: the CUDA
    kernel, one launch per chunk of the table, on CUDA tensors; the plain
    version on CPU tensors.  ``inputs[k]`` is slot k's 1-D operand (int32
    codes or float32 values), all with one row count; ``out`` (allocated
    when None) is an (n, ``table.width``) float32 tensor whose columns are
    contiguous -- a view into a wider buffer is fine."""
    global encode_slots_launches, slots_encoded
    global left_closed_launches, left_closed_slots
    if inputs and inputs[0].device.type == "cpu":
        return encode_slots_torch(inputs, table, out)
    n = _check_inputs(inputs, table)
    out = _output(table, n, inputs[0].device, out)
    if out.device.type == "meta":   # shapes only: the static memory estimate
        return out
    launched = _launch(inputs, table, out, table.splits_on(inputs[0].device),
                       "encode_slots")
    encode_slots_launches += launched
    _thread.encode_slots = thread_encode_launches() + launched
    if launched:
        slots_encoded += len(table)
        left_closed_launches += table.left_chunks
        left_closed_slots += table.n_left
    return out


@functools.lru_cache(maxsize=256)
def _one_slot(kind: str, width: int, n_splits: int, track_nulls: bool,
              track_invalid: bool) -> SlotTable:
    """A one-slot table; a bucketize slot's split values come from the
    caller's tensor at launch (placeholders here)."""
    if kind == ONEHOT:
        return plan_slots([onehot_slot(width)])
    return plan_slots([bucketize_slot([0.0] * n_splits, track_nulls, track_invalid)])


def onehot_codes(codes: torch.Tensor, width: int) -> torch.Tensor:
    """One-hot of int32 level codes (one slot of the encode kernel): the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    global onehot_launches
    _check(codes, "codes", torch.int32, 1)
    width = int(width)
    if width <= 0:
        raise ValueError(f"width must be positive, got {width}")
    if codes.device.type == "cpu":
        return onehot_codes_torch(codes, width)
    out = torch.empty((int(codes.shape[0]), width), dtype=torch.float32,
                      device=codes.device)
    onehot_launches += _launch([codes], _one_slot(ONEHOT, width, 0, False, False),
                               out, None, "onehot_codes")
    return out


def bucketize_right_encode(x: torch.Tensor, splits: torch.Tensor,
                           track_nulls: bool, track_invalid: bool) -> torch.Tensor:
    """Bucketize one-hot (one slot of the encode kernel): the CUDA kernel on
    a CUDA tensor, the plain version on a CPU tensor.  ``splits`` lies on the
    same device as ``x``."""
    global bucketize_launches
    _check(x, "x", torch.float32, 1)
    _check(splits, "splits", torch.float32, 1)
    if splits.device != x.device:
        raise ValueError(f"splits on {splits.device}, x on {x.device}")
    n_splits = int(splits.shape[0])
    if n_splits < 2:
        raise ValueError(f"need at least 2 splits, got {n_splits}")
    if x.device.type == "cpu":
        return bucketize_right_encode_torch(x, splits, track_nulls, track_invalid)
    table = _one_slot(BUCKETIZE, 0, n_splits, bool(track_nulls), bool(track_invalid))
    out = torch.empty((int(x.shape[0]), table.width), dtype=torch.float32,
                      device=x.device)
    bucketize_launches += _launch([x], table, out, splits, "bucketize_right_encode")
    return out
