"""CompiledScoringPlan — a fitted model bound for online scoring on the card.

Counterpart of ``transmogrifai_tpu/serve/plan.py``.  A plan scores a batch
of records in three parts, each timed (``last_timings``, ``batch_timings``,
``metrics()``):

1. **host encode** — field extraction; float32 lifts of raw numeric features
   (NaN for missing, one lift shared by every stage that reads the feature);
   stage-owned encodings such as the one-hot level codes;
2. **device prefix** — the machinery shared with the training-time plan
   (``workflow/plan.py::DevicePrefix``): the batch's operands, padded, are
   packed into one pinned host buffer per dtype and reach ``device`` in one
   copy each; every prefix stage whose device half is the encode kernel and
   whose inputs are all operands (the one-hot and bucketize slots) is
   encoded by one launch of it (``perf/kernels/encode.py::encode_slots``);
   the other prefix stages run in topological order as torch ops and the
   port's CUDA kernels; the outputs the host still needs are copied back,
   without blocking, into pinned host buffers;
3. **host remainder** — every other stage (the model head, float64 numpy)
   through its columnar ``transform``; a tree head scores batches above 512
   rows on the plan's device.

``score(records) == begin_score(records)()``: :meth:`begin_score` runs the
host encode and starts the device work (on the card it returns as soon as
the copies and launches are queued), and the closure it returns waits for
that batch's copies back — one CUDA event — then runs the host remainder.
The pipelined batcher (``serve/batcher.py``) encodes batch N+1 while batch
N's device work and host remainder finish; lockstep serving calls the two
halves back to back, so both run the same code.

Buffers shared between batches in flight:

- every batch's device work goes on one stream, the plan's (the device's
  current stream when the plan was built), whatever stream the calling
  thread has set: so batch N+1's copy into a bucket's staging buffers is
  ordered after batch N's kernels that read them, and ``Staging.load``
  waits for batch N's copy out of the pinned host buffer before refilling
  it;
- each bucket has a ring of landing buffers for the copies back (pinned on
  the card), one set per batch in flight, a set handed back only once its
  batch is finalized.  A plan alone scores in lockstep and holds one set;
  the server reserves its pipeline depth + 1 (``reserve_inflight``).  A
  batch that finds every set in use gets a new one (counted in
  ``compile_count``);
- a lock orders the staging refill and the launches of concurrent callers
  (the batcher's flusher, its finalizer's retries, direct ``score``
  callers); another guards the counters and the free sets.

Batches pad to power-of-two row buckets (as the reference, whose jit cache
needed them): the kernels see a handful of shapes, and a batch's padded rows
never reach its real ones because device transforms are row-local.

The plan runs on the CUDA card unless ``device`` names another device; with
no card and no device it raises.  ``device="cpu"`` runs every kernel's plain
PyTorch version — the tests' path, and the reference the card is held to.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkers.diagnostics import DiagnosticReport, OpCheckError, make_diagnostic
from ..data.dataset import Column, Dataset
from ..features.feature import Feature, _NamedExtract
from ..features.generator import FeatureGeneratorStage
from ..perf.kernels.dispatch import resolve_device
from ..types import ColumnKind, NonNullableEmptyException
from ..workflow.dag import compute_dag
from ..workflow.plan import (
    DevicePrefix,
    Staging,
    run_host_stages,
    serving_entry_ok,
)
from ..workflow.workflow import _refuse_unported
from .faults import fault_point

#: precision names the plan serves (the reference's f32 aliases); its
#: reduced classes are refused by name
_F32_NAMES = frozenset({"f32", "float32", "fp32"})
_REDUCED_NAMES = frozenset({"bf16", "bfloat16", "int8", "i8"})


def _normalize_precision(precision) -> str:
    if precision is None:
        return "f32"
    key = str(precision).strip().lower()
    if key in _F32_NAMES:
        return "f32"
    if key in _REDUCED_NAMES:
        _refuse_unported("CompiledScoringPlan", {f"precision={precision!r}": True})
    raise ValueError(f"unknown precision {precision!r}; expected one of "
                     "('f32', 'bf16', 'int8')")


def _unfitted(result_features: Sequence[Feature], fitted: Mapping[str, Any]) -> List[str]:
    from ..stages.base import Estimator

    return [stage.uid for layer in compute_dag(result_features) for stage in layer
            if isinstance(stage, Estimator) and fitted.get(stage.uid) is None]


def resolve_scoring_stages(result_features: Sequence[Feature],
                           fitted: Mapping[str, Any]) -> list:
    """Topologically ordered fitted runners for the scoring path; an
    estimator node without a fitted model is an error."""
    from ..stages.base import Estimator

    runners = []
    for layer in compute_dag(result_features):
        for stage in layer:
            runner = fitted.get(stage.uid)
            if runner is None:
                if isinstance(stage, Estimator):
                    raise ValueError(
                        f"[TM501] Stage {stage.uid} is an unfitted estimator; "
                        "cannot compile a scoring plan")
                runner = stage
            runners.append(runner)
    return runners


def _bucket_for(n: int, min_bucket: int, max_bucket: int) -> int:
    b = max(int(min_bucket), 1 << max(0, (int(n) - 1)).bit_length())
    return min(b, max_bucket)


def _extract(gen: FeatureGeneratorStage, records) -> list:
    fn = gen.extract_fn
    if isinstance(fn, _NamedExtract):
        try:  # dict records: direct field reads
            return [r.get(fn.key) for r in records]
        except AttributeError:
            pass
    return [fn(r) for r in records]


def _lift_builder(gen: FeatureGeneratorStage) -> Callable:
    """records -> float32 operand of a raw numeric or geolocation feature,
    with the same conversions and non-nullable checks as building its typed
    column (a geolocation: (n, 3), zeros where missing)."""
    ftype = gen.ftype
    conv = ftype._convert
    nullable = ftype.is_nullable
    name = gen.raw_name

    if ftype.kind is ColumnKind.GEO:
        def build_geo(records):
            out = np.zeros((len(records), 3), dtype=np.float32)
            for i, v in enumerate(_extract(gen, records)):
                v = conv(v)
                if v is not None and len(v) == 3:
                    out[i] = v
            return out
        return build_geo

    def build(records):
        vals = _extract(gen, records)
        if None in vals:
            if not nullable:
                raise NonNullableEmptyException(
                    f"{ftype.__name__} feature {name!r} cannot be empty")
            vals = [np.nan if v is None else v for v in vals]
        try:
            out = np.asarray(vals, dtype=np.float32)
        except (TypeError, ValueError):
            return np.asarray([np.nan if (c := conv(v)) is None else c
                               for v in vals], dtype=np.float32)
        if str in set(map(type, vals)):  # numpy parses "1.2"; the typed
            for v in vals:               # path must refuse it
                conv(v)
        return out
    return build


def extract_columns(records: Sequence[Any], named_gens,
                    allow_missing_response: bool = False) -> Dict[str, Column]:
    """Typed columns of (name, generator) pairs over the records.  With
    ``allow_missing_response`` a response absent from every record is
    skipped (scoring batches carry no label); a malformed one still raises."""
    cols: Dict[str, Column] = {}
    for name, g in named_gens:
        try:
            cols[name] = Column.from_values(
                g.ftype, [g.extract(r).value for r in records])
        except Exception:
            if not (allow_missing_response and g.is_response):
                raise
            fn = getattr(g, "extract_fn", None)
            if isinstance(fn, _NamedExtract) and any(
                    isinstance(r, dict) and r.get(fn.key) is not None
                    for r in records):
                raise
    return cols


def _plain(v: Any):
    """numpy scalars and arrays -> plain python for the output records."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


class _OutSlot:
    """Landing buffers of one batch in flight: a host tensor per prefix
    output the host needs, ``bucket`` rows each (pinned on the card)."""

    __slots__ = ("host",)

    def __init__(self, specs: List[Tuple[tuple, torch.dtype]], bucket: int,
                 pin: bool):
        self.host = [torch.empty((bucket, *shape), dtype=dt, pin_memory=pin)
                     for shape, dt in specs]


class _Inflight:
    """A begun batch's device half: its landing slot, and on the card the
    events that time the prefix and mark its copies back done."""

    __slots__ = ("bucket", "slot", "n", "start", "end", "done", "t0", "t1")

    def __init__(self, bucket: int, slot: _OutSlot, n: int, start, end,
                 t0: float, t1: float):
        self.bucket, self.slot, self.n = bucket, slot, n
        self.start, self.end, self.done = start, end, None
        self.t0, self.t1 = t0, t1

    def wait(self) -> List[np.ndarray]:
        """Block until the copies back have landed (on the card: the batch's
        one event); the prefix outputs as host arrays over the slot."""
        if self.done is not None:
            self.done.synchronize()
        return [h[:self.n].numpy() for h in self.slot.host]

    def device_ms(self) -> float:
        if self.start is not None:
            return self.start.elapsed_time(self.end)
        return (self.t1 - self.t0) * 1e3


class CompiledScoringPlan(DevicePrefix):
    """Fitted workflow model bound to a device for batch scoring.

    ``plan.score(records)`` returns one ``{result feature name: value}`` dict
    per record, the reference plan's output contract.  The parameters are the
    reference's, in its order, and ``device`` by keyword only.  ``strict``
    refuses a model with an unfitted estimator by :class:`OpCheckError`
    (TM501; without it, a ``ValueError``); the reference's other
    servability checks are not ported.  Its device-memory admission gate
    (``hbm_budget``) and reduced precision classes raise
    ``NotImplementedError`` by name.
    """

    def __init__(self, model, min_bucket: int = 8, max_bucket: int = 1024,
                 strict: bool = True, hbm_budget: Optional[float] = None,
                 precision: Optional[str] = None, *, device=None):
        if max_bucket < min_bucket or min_bucket < 1:
            raise ValueError(f"bad bucket range [{min_bucket}, {max_bucket}]")
        _refuse_unported("CompiledScoringPlan", {"hbm_budget": hbm_budget is not None})
        self._precision = _normalize_precision(precision)
        self.min_bucket = 1 << (int(min_bucket) - 1).bit_length()
        self.max_bucket = 1 << (int(max_bucket) - 1).bit_length()
        self.result_features: List[Feature] = list(model.result_features)
        if strict:
            unfitted = _unfitted(self.result_features, model.fitted)
            if unfitted:
                report = DiagnosticReport()
                report.extend(make_diagnostic(
                    "TM501", "estimator has no fitted model; cannot compile a "
                    "scoring plan", stage_uid=uid) for uid in unfitted)
                raise OpCheckError(report)
        super().__init__(resolve_scoring_stages(self.result_features, model.fitted),
                         serving_entry_ok, resolve_device(device))
        self._generators = self._collect_generators()
        self._build_sources()
        on_card = self.device.type == "cuda"
        #: every batch's device work goes on this stream
        self._stream = torch.cuda.current_stream(self.device) if on_card else None
        #: orders the staging refill and the launches of concurrent callers
        self._dispatch_lock = threading.Lock()
        #: guards the counters, the timings and the free landing sets
        self._lock = threading.Lock()
        #: row bucket -> its staging buffers
        self._staging: Dict[int, Staging] = {}
        #: row bucket -> landing sets not in flight
        self._free: Dict[int, List[_OutSlot]] = {}
        #: landing sets a bucket's ring is built with (``reserve_inflight``)
        self._ring_size = 1
        #: row bucket -> landing sets built; the sets' (shape, dtype) specs
        self._sets: Dict[int, int] = {}
        self._slot_specs: Optional[List[Tuple[tuple, torch.dtype]]] = None
        self._entry_dtypes: Optional[List[np.dtype]] = None
        #: staging and landing-set allocations (the port's counterpart of
        #: the reference's bucket compiles); after ``warm()`` serving adds none
        self.compile_count = 0
        self._counters = {"scored_records": 0, "scored_batches": 0,
                          "bucket_batches": {}, "host_scored_records": 0,
                          "padding_rows": 0, "encode_ms": 0.0, "device_ms": 0.0,
                          "host_ms": 0.0, "h2d_copies": 0}
        #: per-part milliseconds of the last finalized batch: host encode,
        #: device prefix (H2D copies + kernels; CUDA events on the card),
        #: host remainder
        self.last_timings: Dict[str, float] = {}
        #: the same, with rows and bucket, of the most recent batches
        self.batch_timings: "deque[Dict[str, float]]" = deque(maxlen=4096)
        self._content_fingerprint = self.prefix_fingerprint(environment=False)
        self._fingerprint = self.prefix_fingerprint(environment=True)

    # -- introspection -------------------------------------------------------
    @property
    def fingerprint(self) -> str:
        """Hash of the prefix stages' fitted state, the prefix's wiring and
        the device type: equal fingerprints run the same prefix."""
        return self._fingerprint

    @property
    def content_fingerprint(self) -> str:
        """:attr:`fingerprint` without the device type."""
        return self._content_fingerprint

    @property
    def precision(self) -> str:
        return self._precision

    @property
    def device_stage_uids(self) -> List[str]:
        return [s.uid for s in self._prefix]

    @property
    def host_stage_uids(self) -> List[str]:
        return [s.uid for s in self._remainder]

    def bucket_ladder(self) -> List[int]:
        """Every power-of-two bucket in [min_bucket, max_bucket]."""
        out, b = [], self.min_bucket
        while b <= self.max_bucket:
            out.append(b)
            b *= 2
        return out

    def warm_buckets(self) -> List[int]:
        """Buckets whose staging buffers are built."""
        with self._lock:
            return sorted(self._staging)

    def metrics(self) -> Dict[str, Any]:
        """Counters, under the reference's keys where the port has them:
        ``scored_records`` / ``scored_batches`` (finalized batches),
        ``bucket_batches`` (batches per row bucket), ``host_scored_records``
        (records ``score_host`` served), ``compile_count`` (staging and
        landing-set allocations; the port compiles nothing at serving time),
        ``buckets_compiled`` (buckets with staging), ``fused_stages`` /
        ``host_stages``.  The port's own: ``encode_ms`` / ``device_ms`` /
        ``host_ms`` (summed per-part times), ``padding_rows`` (rows padded
        up to the bucket), ``h2d_copies`` (host-to-device copies) and
        ``device``."""
        with self._lock:
            out = {k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in self._counters.items()}
            out.update(compile_count=self.compile_count,
                       buckets_compiled=sorted(self._staging))
        out.update(device=str(self.device), fused_stages=len(self._prefix),
                   host_stages=len(self._remainder))
        return out

    # -- construction helpers ------------------------------------------------
    def _collect_generators(self) -> List[FeatureGeneratorStage]:
        seen: Dict[str, FeatureGeneratorStage] = {}
        for f in self.result_features:
            for raw in f.raw_features():
                st = raw.origin_stage
                if isinstance(st, FeatureGeneratorStage):
                    seen.setdefault(st.uid, st)
        return list(seen.values())

    def _build_sources(self) -> None:
        """Where each entry comes from in a batch of records, and which
        prefix outputs and raw columns the host remainder needs."""
        self._lift_builders: Dict[tuple, Callable] = {
            key: _lift_builder(f.origin_stage) for key, f in self._entry_lifts.items()}
        needed: Dict[str, Feature] = {}
        for runner in self._remainder:
            for f in runner.inputs:
                if f.uid in self._device_uids:
                    needed.setdefault(f.uid, f)
        for f in self.result_features:
            if f.uid in self._device_uids:
                needed.setdefault(f.uid, f)
        self._out_features = list(needed.values())
        self._out_uids = [f.uid for f in self._out_features]
        # raw columns the host still needs: remainder inputs and raw results
        host_needed: Dict[str, FeatureGeneratorStage] = {}
        for runner in self._remainder:
            for f in runner.inputs:
                if isinstance(f.origin_stage, FeatureGeneratorStage):
                    host_needed.setdefault(f.name, f.origin_stage)
        for f in self.result_features:
            if isinstance(f.origin_stage, FeatureGeneratorStage):
                host_needed.setdefault(f.name, f.origin_stage)
        self._host_raw = list(host_needed.items())
        # encoder inputs the host needs for nothing else skip typed conversion
        self._encoder_light: Dict[str, FeatureGeneratorStage] = {}
        for _runner, _slot, f in self._entry_encoders.values():
            gen = f.origin_stage
            if gen.raw_name not in host_needed:
                self._encoder_light[gen.raw_name] = gen

    # -- the device half -------------------------------------------------------
    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _stage(self, entries: List[np.ndarray], n: int,
               bucket: int) -> List[torch.Tensor]:
        """The batch's entries as device operands, through the bucket's
        staging buffers (one copy per dtype).  Caller holds the dispatch
        lock."""
        for e in entries:
            if e.ndim != 1 or e.shape[0] != n:
                raise ValueError(f"a prefix operand must be 1-D with {n} rows, "
                                 f"got shape {e.shape}")
        dtypes = tuple(e.dtype for e in entries)
        st = self._staging.get(bucket)
        if st is None or st.dtypes != dtypes:
            st = Staging(dtypes, bucket, self.device)
            with self._lock:
                self._staging[bucket] = st
                self.compile_count += 1
        copies = st.load(entries, n)
        with self._lock:
            self._counters["h2d_copies"] += copies
        return st.operands

    def reserve_inflight(self, batches: int) -> "CompiledScoringPlan":
        """Landing sets per bucket: how many batches may be begun and not
        yet finalized without an allocation.  A plan alone scores in
        lockstep (1); the server reserves its pipeline depth + 1 (the
        ring's batches and the one its flusher is beginning).  Rings
        already built grow to it."""
        with self._lock:
            self._ring_size = max(1, int(batches))
            for bucket, have in self._sets.items():
                if have < self._ring_size:
                    self._free[bucket].extend(
                        self._new_slots(bucket, self._ring_size - have))
        return self

    def _new_slots(self, bucket: int, count: int) -> List[_OutSlot]:
        """``count`` landing sets of ``bucket``; caller holds the lock."""
        pin = self.device.type == "cuda"
        self._sets[bucket] = self._sets.get(bucket, 0) + count
        self.compile_count += 1
        return [_OutSlot(self._slot_specs, bucket, pin) for _ in range(count)]

    def _take_slot(self, bucket: int, env: Dict[str, torch.Tensor]) -> _OutSlot:
        """A free landing set of ``bucket``; the bucket's first batch builds
        its ring, a batch that finds every set in flight builds one more."""
        with self._lock:
            free = self._free.get(bucket)
            if free:
                return free.pop()
            if self._slot_specs is None:
                self._slot_specs = [(tuple(env[u].shape[1:]), env[u].dtype)
                                    for u in self._out_uids]
            made = self._new_slots(bucket, self._ring_size if free is None else 1)
            self._free[bucket] = made[1:]
            return made[0]

    def _release(self, handle: _Inflight) -> None:
        with self._lock:
            self._free[handle.bucket].append(handle.slot)

    def _dispatch(self, entries: List[np.ndarray], n: int) -> _Inflight:
        """Stage the batch, launch its prefix and start its copies back into
        a landing set, without waiting for any of it on the card."""
        bucket = _bucket_for(n, self.min_bucket, self.max_bucket)
        on_card = self.device.type == "cuda"
        start = end = None
        with self._dispatch_lock, self._on_stream():
            t0 = time.perf_counter()
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            ops_in = self._stage(entries, n, bucket)
            env: Dict[str, torch.Tensor] = {}
            self._encode(ops_in, bucket, env)
            self._run_wiring(ops_in, env)
            if on_card:
                end.record()
            t1 = time.perf_counter()
            slot = self._take_slot(bucket, env)
            handle = _Inflight(bucket, slot, n, start, end, t0, t1)
            try:
                for host, u in zip(slot.host, self._out_uids):
                    host[:n].copy_(env[u][:n], non_blocking=on_card)
                if on_card:
                    handle.done = torch.cuda.Event()
                    handle.done.record()
            except BaseException:
                self._release(handle)
                raise
        return handle

    def _warm_entries(self, rows: int) -> List[np.ndarray]:
        """Zero operands of the entries' dtypes (each encoder's dtype from
        its encoding of an empty column)."""
        if self._entry_dtypes is None:
            dtypes = []
            for key in self._entry_keys:
                if key[0] == "lift":
                    dtypes.append(np.dtype(np.float32))
                else:
                    runner, slot, f = self._entry_encoders[key]
                    empty = Column(f.ftype, np.array([], dtype=object))
                    dtypes.append(np.asarray(runner.encode_device_input(slot, empty)).dtype)
            self._entry_dtypes = dtypes
        return [np.zeros(rows, dt) for dt in self._entry_dtypes]

    def warm(self, buckets: Optional[Sequence[int]] = None) -> "CompiledScoringPlan":
        """Build the staging buffers and the landing ring of ``buckets``
        (default: every power of two in [min_bucket, max_bucket]) and run one
        padded batch of zeros through each, so served batches allocate no
        pinned memory."""
        if not self._prefix:
            return self
        for b in (self.bucket_ladder() if buckets is None else buckets):
            b = _bucket_for(b, self.min_bucket, self.max_bucket)
            handle = self._dispatch(self._warm_entries(b), b)
            try:
                handle.wait()
            finally:
                self._release(handle)
        return self

    # -- the host halves -------------------------------------------------------
    def _encode_records(self, records) -> Tuple[Dict[str, Column], List[np.ndarray]]:
        host_cols = extract_columns(records, self._host_raw,
                                    allow_missing_response=True)
        if not self._prefix:
            return host_cols, []
        enc_cols = dict(host_cols)
        for raw_name, gen in self._encoder_light.items():
            enc_cols[raw_name] = Column(gen.ftype, np.array(_extract(gen, records),
                                                            dtype=object))
        entries = []
        for key in self._entry_keys:
            if key[0] == "lift":
                entries.append(self._lift_builders[key](records))
            else:
                runner, slot, f = self._entry_encoders[key]
                raw_name = f.origin_stage.raw_name
                col = enc_cols.get(raw_name)
                if col is None:
                    raise ValueError(f"raw feature {raw_name!r} is required by "
                                     f"{runner.uid} but absent from the records")
                entries.append(np.asarray(runner.encode_device_input(slot, col)))
        return host_cols, entries

    @staticmethod
    def _materialize(f: Feature, arr: np.ndarray) -> Column:
        if f.ftype.kind is ColumnKind.VECTOR:
            return Column.vector(arr)
        if f.ftype.kind in (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL):
            return Column(f.ftype, arr.astype(np.float64),
                          np.ones(arr.shape[0], dtype=np.bool_))
        return Column(f.ftype, arr)

    # -- scoring -------------------------------------------------------------
    def prefix_outputs(self, records: Sequence[Mapping[str, Any]]) -> List[np.ndarray]:
        """The device prefix's outputs for one batch (at most ``max_bucket``
        records), as host arrays in the order of the features the host needs
        from the device — what ``score`` feeds the host remainder."""
        if not 0 < len(records) <= self.max_bucket:
            raise ValueError(f"prefix_outputs takes 1..{self.max_bucket} records")
        if not self._prefix:
            return []
        handle = self._dispatch(self._encode_records(records)[1], len(records))
        try:
            return [a.copy() for a in handle.wait()]
        finally:
            self._release(handle)

    def score(self, records: Sequence[Mapping[str, Any]]) -> List[Dict[str, Any]]:
        """Batch scoring: host encode, device prefix, host remainder —
        ``begin_score(records)()``."""
        return self.begin_score(records)()

    def begin_score(self, records: Sequence[Mapping[str, Any]]
                    ) -> Callable[[], List[Dict[str, Any]]]:
        """Run the host encode and start the batch's device work now; return
        the closure that finishes it: waits for the batch's copies back,
        runs the host remainder, counts the batch and returns its rows.  The
        closure must be called (it hands the batch's landing set back).
        Batches above ``max_bucket`` records run whole in the closure."""
        n = len(records)
        if n == 0:
            return lambda: []
        if n > self.max_bucket:
            def _finalize_split() -> List[Dict[str, Any]]:
                out: List[Dict[str, Any]] = []
                for i in range(0, n, self.max_bucket):
                    out.extend(self.score(records[i:i + self.max_bucket]))
                return out
            return _finalize_split

        t0 = time.perf_counter()
        fault_point("encode", records=records)
        host_cols, entries = self._encode_records(records)
        encode_ms = (time.perf_counter() - t0) * 1e3
        handle = None
        if self._prefix:
            bucket = _bucket_for(n, self.min_bucket, self.max_bucket)
            fault_point("device", records=records, bucket=bucket)
            handle = self._dispatch(entries, n)

        def _finalize() -> List[Dict[str, Any]]:
            try:
                cols = dict(host_cols)
                device_ms = 0.0
                if handle is not None:
                    for f, arr in zip(self._out_features, handle.wait()):
                        cols[f.name] = self._materialize(f, arr)
                    device_ms = handle.device_ms()
                t1 = time.perf_counter()
                fault_point("host", records=records)
                ds = run_host_stages(Dataset(cols), self._remainder, device=self.device)
                out = self._rows_from(ds, n)
                host_ms = (time.perf_counter() - t1) * 1e3
            finally:
                if handle is not None:
                    self._release(handle)
            timings = {"encode_ms": encode_ms, "device_ms": device_ms,
                       "host_ms": host_ms}
            with self._lock:
                c = self._counters
                for k, v in timings.items():
                    c[k] += v
                c["scored_records"] += n
                c["scored_batches"] += 1
                if handle is not None:
                    bb = c["bucket_batches"]
                    bb[handle.bucket] = bb.get(handle.bucket, 0) + 1
                    c["padding_rows"] += handle.bucket - n
                self.last_timings = timings
                self.batch_timings.append(
                    {**timings, "rows": n,
                     "bucket": handle.bucket if handle is not None else 0})
            return out
        return _finalize

    def score_host(self, records: Sequence[Mapping[str, Any]]
                   ) -> List[Dict[str, Any]]:
        """Every stage, the device prefix's too, through its host columnar
        ``transform`` on the CPU — the degraded path the circuit breaker
        (``serve/resilience.py``) serves from while the device path is
        failing.  Counted in ``host_scored_records``.  Only a plan on the
        CPU has it: a plan on the card never moves its work to the CPU."""
        if self.device.type == "cuda":
            raise RuntimeError("score_host runs on the CPU; a plan on the card "
                               "has no host path (build it with device='cpu')")
        n = len(records)
        if n == 0:
            return []
        ds = Dataset(extract_columns(
            records, [(g.raw_name, g) for g in self._generators],
            allow_missing_response=True))
        ds = run_host_stages(ds, self._runners, device=torch.device("cpu"))
        out = self._rows_from(ds, n)
        with self._lock:
            self._counters["host_scored_records"] += n
        return out

    def _rows_from(self, ds: Dataset, n: int) -> List[Dict[str, Any]]:
        from ..models.prediction import PredictionColumn

        out: List[Dict[str, Any]] = [{} for _ in range(n)]
        for f in self.result_features:
            if f.name not in ds:
                continue
            col = ds[f.name]
            if isinstance(col, PredictionColumn):
                for row, v in zip(out, col.to_values()):
                    row[f.name] = v
            else:
                for row, v in zip(out, col.to_values()):
                    row[f.name] = _plain(v)
        return out

