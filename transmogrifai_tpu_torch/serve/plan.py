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

Precision classes (:class:`Precision`): ``f32`` (default), ``bf16`` and
``int8`` lower the float entries once a batch, over the packed float32
staging buffer (:func:`lower_block`: one row-wise ``amax`` for int8's
per-entry scales, then the elementwise quant-dequant), before the one
encode launch; the encode kernel reads float32 (bf16 values widened
exactly), and the stages after it compute at the class's dtype.  A reduced
class joins the fingerprint.

Plans of one fingerprint on one device share their device-side state
(:class:`_SharedPrefix`: staging buffers, the stages' device constants, the
stream and the dispatch lock), as the reference's plans share executables:
a second plan of a model already warm there allocates nothing on the card.
:meth:`CompiledScoringPlan.release_executables` releases a plan's warm
buckets (the fleet's eviction).

A bucket's executable (:class:`BucketExecutable`) is what the bucket needs
on the card: its staging buffers' and landing ring's specs and the kernel
libraries its prefix loads.  :meth:`CompiledScoringPlan.executable` takes it
from a warm bucket (the deploy artifact's pack side), and
:meth:`~CompiledScoringPlan.adopt_executable` allocates a bucket from it
without running the prefix (the hydrate side, ``deploy/store.py``).

Buffers shared between batches in flight:

- every batch's device work goes on one stream, the shared state's (the
  device's current stream when it was made), whatever stream the calling
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
- the shared state's lock orders the staging refill and the launches of
  concurrent callers (the batcher's flusher, its finalizer's retries,
  direct ``score`` callers, other plans of the fingerprint); another guards
  each plan's counters and free sets.

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
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkers.diagnostics import OpCheckError
from ..obs import flight as obs_flight
from ..obs import reqtrace
from ..obs import trace as obs_trace
from ..obs.profile import maybe_profile
from ..checkers.plancheck import block_bytes
from ..data.dataset import Column, Dataset
from ..features.feature import Feature, _NamedExtract
from ..features.generator import FeatureGeneratorStage
from ..ops._consts import const_store
from ..perf.kernels.dispatch import libraries_used, resolve_device, serve_donation
from ..perf.timers import note_compile
from ..types import ColumnKind, NonNullableEmptyException
from ..workflow.dag import compute_dag
from ..workflow.plan import (
    DevicePrefix,
    Staging,
    run_host_stages,
    serving_entry_ok,
)
from .faults import fault_point

class Precision:
    """Numeric class of the device prefix (the reference's
    ``serve/plan.py::Precision``).

    - ``f32`` — the default: every float operand stays float32, and the
      plan's fingerprint carries no precision tag, so f32 plans share
      prefix state with every f32 plan of the same model.
    - ``bf16`` — float entry operands are rounded to bfloat16 at the prefix
      boundary; the prefix stages compute at bf16 where their operands are
      bf16 (the encode kernel reads them widened back to float32, exactly
      the bf16 values), and float outputs leave as float32.
    - ``int8`` — dynamic per-tensor symmetric quant-dequant of each float
      entry: scaled by ``max|x| / 127`` over its finite values, rounded
      half to even into [-127, 127] and multiplied back to float32; NaN and
      inf pass through.

    Both reduced classes are deterministic per input.  A registry admits a
    reduced-precision plan only past the TM511 calibration parity gate
    (``serve/validator.py::check_precision_parity``), fail-closed.
    """

    F32 = "f32"
    BF16 = "bf16"
    INT8 = "int8"
    ALL = (F32, BF16, INT8)

    _ALIASES = {"f32": F32, "float32": F32, "fp32": F32,
                "bf16": BF16, "bfloat16": BF16,
                "int8": INT8, "i8": INT8}

    @staticmethod
    def normalize(value) -> str:
        """Canonical precision name; ValueError on anything unknown (an
        unrecognized class never serves as f32)."""
        if value is None:
            return Precision.F32
        key = str(value).strip().lower()
        try:
            return Precision._ALIASES[key]
        except KeyError:
            raise ValueError(
                f"unknown precision {value!r}; expected one of "
                f"{Precision.ALL}") from None


#: TM511 parity bounds: max |prediction delta| vs f32 over the calibration
#: batch, per precision class (the reference's values)
TM511_BOUNDS = {Precision.BF16: 1e-2, Precision.INT8: 5e-2}

#: float32(1 / 127): XLA compiles the reference's ``max|x| / 127.0`` into a
#: multiply by this constant (the division by the tensor scale that follows
#: stays a true division)
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def lower_block(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Precision-class lowering of a (k, rows) block of float32 entries, one
    entry a row (the float32 staging buffer): bf16 rounding, or int8's
    quant-dequant with one scale per row (per entry, as the reference's
    per-tensor scale; padded rows are zeros in both packages, so they do
    not move it)."""
    if precision == Precision.BF16:
        return x.to(torch.bfloat16)
    finite = torch.isfinite(x)
    mag = torch.where(finite, x.abs(), torch.zeros((), dtype=x.dtype, device=x.device))
    scale = torch.clamp(mag.amax(dim=1, keepdim=True), min=1e-12) * _INV127
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return torch.where(finite, q.to(torch.float32) * scale, x)


class _SharedPrefix:
    """The device-side state of one prefix on one device, shared by every
    plan of its fingerprint there (the port's counterpart of the
    reference's process-wide executable cache): the prefix machinery of the
    plan that made it (``owner``: its runners run every batch, their device
    constants live in ``consts``, its slot table's splits on the device),
    each row bucket's staging buffers, the stream every batch's device work
    goes on, and the lock that orders the staging refill and the launches.
    ``holders[bucket]`` are the plans holding the bucket warm."""

    def __init__(self, owner: "CompiledScoringPlan", device: torch.device):
        # the owner's prefix machinery without the plan itself: the state
        # outlives the plan that made it, and holds no cycle back to it
        self.owner = DevicePrefix.__new__(DevicePrefix)
        for name in ("device", "_encode_table", "_encode_inputs", "_encode_blocks",
                     "_wiring"):
            setattr(self.owner, name, getattr(owner, name))
        self.device = device
        self.stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        self.lock = threading.Lock()
        self.consts: Dict[tuple, torch.Tensor] = {}
        self.staging: Dict[int, Staging] = {}
        #: row bucket -> the live plans holding it (weakly: a plan dropped
        #: without a release holds nothing)
        self.holders: Dict[int, "weakref.WeakSet[CompiledScoringPlan]"] = {}

    def release_constants(self) -> int:
        """Drop the device constants and the slot table's device splits;
        the bytes freed."""
        freed = sum(_block_bytes(t) for t in self.consts.values())
        self.consts.clear()
        table = self.owner._encode_table
        if table is not None:
            t = table._splits_on.pop(self.device, None)
            if t is not None:
                freed += _block_bytes(t)
        return freed


#: (fingerprint, device) -> the shared device-side prefix state, while a plan
#: references it
_SHARED: "weakref.WeakValueDictionary[Tuple[str, str], _SharedPrefix]" = \
    weakref.WeakValueDictionary()
_SHARED_LOCK = threading.Lock()


def _block_bytes(t: torch.Tensor) -> int:
    """Device bytes a tensor's allocation holds: its storage in the caching
    allocator's 512-byte blocks."""
    return block_bytes(t.untyped_storage().nbytes())


def _staging_bytes(st: Staging) -> int:
    """Device bytes of a bucket's staging buffers (none on the CPU, where
    the packed host buffer is the operand)."""
    return sum(_block_bytes(dev) for _idx, _np, host, dev in st.buffers
               if dev is not host)


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


class BucketExecutable:
    """One row bucket's executable on its plan's device: what the bucket
    needs allocated and loaded to serve, and nothing that runs.

    - ``bucket`` and ``fingerprint`` (the plan's, environment-qualified);
    - ``entry_specs`` — (trailing shape, dtype name) of each prefix entry
      (:attr:`CompiledScoringPlan.entry_specs`);
    - ``staging_dtypes`` — the staging buffers' dtypes, one per entry;
    - ``slot_specs`` — (trailing shape, torch dtype name) of each landing
      buffer a batch's outputs are copied back into;
    - ``libraries`` — the kernel libraries the prefix loads on the card
      (none on the CPU).

    ``to_json`` / ``from_json`` are its serialized form
    (``perf/programs.py::serialize_compiled``)."""

    __slots__ = ("bucket", "fingerprint", "entry_specs", "staging_dtypes",
                 "slot_specs", "libraries")

    def __init__(self, bucket: int, fingerprint: str, entry_specs, staging_dtypes,
                 slot_specs, libraries):
        self.bucket = int(bucket)
        self.fingerprint = str(fingerprint)
        self.entry_specs = [(tuple(int(d) for d in t), str(dt)) for t, dt in entry_specs]
        self.staging_dtypes = [str(dt) for dt in staging_dtypes]
        self.slot_specs = [(tuple(int(d) for d in t), str(dt)) for t, dt in slot_specs]
        self.libraries = sorted(str(n) for n in libraries)

    def to_json(self) -> Dict[str, Any]:
        return {"bucket": self.bucket, "fingerprint": self.fingerprint,
                "entrySpecs": [[list(t), dt] for t, dt in self.entry_specs],
                "stagingDtypes": list(self.staging_dtypes),
                "slotSpecs": [[list(t), dt] for t, dt in self.slot_specs],
                "libraries": list(self.libraries)}

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "BucketExecutable":
        try:
            return cls(d["bucket"], d["fingerprint"], d["entrySpecs"],
                       d["stagingDtypes"], d["slotSpecs"], d["libraries"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed bucket executable: {e!r}") from e


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown torch dtype {name!r}")
    return dt


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
            self.done.synchronize()  # opcheck: allow(TM301) a batch's finalize waits on its own CUDA event by design
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
    runs the servability checks (``serve/validator.py::check_servability``:
    an unfitted estimator is TM501, raised as :class:`OpCheckError`;
    without it, a ``ValueError``).  ``hbm_budget`` (bytes) runs the TM601
    admission gate at construction: a plan whose static peak device-memory
    estimate (``checkers/plancheck.py``) exceeds it refuses to build.
    ``precision`` picks the prefix's numeric class (:class:`Precision`).

    Plans of one fingerprint on one device share their device-side prefix
    state (:class:`_SharedPrefix`): a second plan of a model already warm
    there allocates nothing on the device.
    """

    def __init__(self, model, min_bucket: int = 8, max_bucket: int = 1024,
                 strict: bool = True, hbm_budget: Optional[float] = None,
                 precision: Optional[str] = None, *, device=None):
        if max_bucket < min_bucket or min_bucket < 1:
            raise ValueError(f"bad bucket range [{min_bucket}, {max_bucket}]")
        self._precision = Precision.normalize(precision)
        self._donate = serve_donation()
        self.min_bucket = 1 << (int(min_bucket) - 1).bit_length()
        self.max_bucket = 1 << (int(max_bucket) - 1).bit_length()
        self.result_features: List[Feature] = list(model.result_features)
        if strict:
            from .validator import check_servability

            report = check_servability(self.result_features, fitted=model.fitted)
            if report.errors():
                raise OpCheckError(report)
        super().__init__(resolve_scoring_stages(self.result_features, model.fitted),
                         serving_entry_ok, resolve_device(device))
        self._generators = self._collect_generators()
        self._build_sources()
        #: guards the counters, the timings, the held buckets and the free
        #: landing sets
        self._lock = threading.Lock()
        #: the shared device-side prefix state, once the plan first stages
        self._entry: Optional[_SharedPrefix] = None
        #: row bucket -> the staging buffers this plan holds warm (built by
        #: it, or by another plan of its fingerprint)
        self._staging: Dict[int, Staging] = {}
        #: row bucket -> landing sets not in flight
        self._free: Dict[int, List[_OutSlot]] = {}
        #: landing sets a bucket's ring is built with (``reserve_inflight``)
        self._ring_size = 1
        #: row bucket -> landing sets built; the sets' (shape, dtype) specs
        self._sets: Dict[int, int] = {}
        self._slot_specs: Optional[List[Tuple[tuple, torch.dtype]]] = None
        self._entry_dtypes: Optional[List[np.dtype]] = None
        #: buckets taken warm (staging, whether built or shared) and
        #: landing-set allocations: the port's counterpart of the
        #: reference's bucket compiles; after ``warm()`` serving adds none
        self.compile_count = 0
        #: flips once a full-ladder ``warm()`` finishes: a later bucket
        #: allocation on this plan is an UNEXPECTED warm-path compile
        #: (flight recorder, TM901); ``release_executables`` clears it
        self._warmed = False
        #: device bytes the last :meth:`release_executables` freed
        self.last_released_bytes = 0
        self._counters = {"scored_records": 0, "scored_batches": 0,
                          "bucket_batches": {}, "host_scored_records": 0,
                          "padding_rows": 0, "encode_ms": 0.0, "device_ms": 0.0,
                          "host_ms": 0.0, "dispatch_ms": 0.0, "h2d_copies": 0,
                          "staging_builds": 0}
        #: per-part milliseconds of the last finalized batch: host encode,
        #: device prefix (H2D copies + kernels; CUDA events on the card),
        #: host remainder
        self.last_timings: Dict[str, float] = {}
        #: the same, with rows and bucket, of the most recent batches
        self.batch_timings: "deque[Dict[str, float]]" = deque(maxlen=4096)
        #: the prefetcher's counters of the last chunked :meth:`score_dataset`
        self.last_prefetch: Dict[str, Any] = {}
        self._entry_specs = self._compute_entry_specs()
        # the class joins the hash only when it is not f32, so an f32
        # plan's fingerprint stays what it was before precision classes
        extra = {} if self._precision == Precision.F32 else {"precision": self._precision}
        self._content_fingerprint = self.prefix_fingerprint(environment=False, extra=extra)
        self._fingerprint = self.prefix_fingerprint(environment=True, extra=extra)
        if hbm_budget is not None:
            from .validator import check_plan_admission

            report = check_plan_admission(self, hbm_budget)
            if report.errors():
                raise OpCheckError(report)

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
        """The prefix's numeric class (:class:`Precision`): ``f32``
        (default), ``bf16`` or ``int8``; part of the fingerprint when it is
        not f32."""
        return self._precision

    @property
    def donated(self) -> bool:
        """Whether the plan was built with serve donation on
        (``TMOG_SERVE_DONATE``, resolved at construction).  The reference
        compiles a donated prefix that consumes its padded input buffers;
        the port's entries already live in per-bucket staging buffers that
        every batch overwrites, so donation changes no device program here.
        It joins the fingerprint through the kernel token
        (``perf/kernels/dispatch.py::cache_token``), so a donated artifact
        never hydrates a non-donated plan."""
        return self._donate

    @property
    def entry_specs(self) -> List[Tuple[tuple, str]]:
        """(trailing shape, dtype name) of each prefix entry operand, in the
        reference's entry order: a lift is ``((), "float32")`` (a
        geolocation ``((3,), "float32")``), a stage's encoding its
        ``device_input_spec``."""
        return list(self._entry_specs)

    def _compute_entry_specs(self) -> List[Tuple[tuple, str]]:
        specs = []
        for key in self._entry_keys:
            if key[0] == "lift":
                geo = self._entry_lifts[key].ftype.kind is ColumnKind.GEO
                specs.append(((3,) if geo else (), "float32"))
            else:
                runner, slot, _f = self._entry_encoders[key]
                trailing, dtype = runner.device_input_spec(slot)
                specs.append((tuple(trailing), str(dtype)))
        return specs

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
        """Buckets whose staging buffers this plan holds."""
        with self._lock:
            return sorted(self._staging)

    def metrics(self) -> Dict[str, Any]:
        """Counters, under the reference's keys where the port has them:
        ``scored_records`` / ``scored_batches`` (finalized batches),
        ``bucket_batches`` (batches per row bucket), ``host_scored_records``
        (records ``score_host`` served), ``compile_count`` (buckets taken
        warm and landing sets allocated; the port compiles nothing at
        serving time),
        ``buckets_compiled`` (buckets with staging), ``fused_stages`` /
        ``host_stages``.  The port's own: ``encode_ms`` / ``device_ms`` /
        ``host_ms`` (summed per-part times; ``device_ms`` from CUDA events on
        the card, the host's enqueue inside them), ``dispatch_ms`` (the
        host's clock around each dispatch), ``padding_rows`` (rows padded
        up to the bucket), ``h2d_copies`` (host-to-device copies),
        ``staging_builds`` (staging buffers this plan allocated; a plan
        whose fingerprint is already warm on its device allocates none),
        ``precision`` and ``device``."""
        with self._lock:
            out = {k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in self._counters.items()}
            out.update(compile_count=self.compile_count,
                       buckets_compiled=sorted(self._staging))
        out.update(device=str(self.device), precision=self._precision,
                   fused_stages=len(self._prefix), host_stages=len(self._remainder))
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
    def _shared(self) -> _SharedPrefix:
        """The device-side prefix state of this plan's fingerprint on its
        device: another live plan's, or a new one this plan owns."""
        with self._lock:
            if self._entry is not None:
                return self._entry
        key = (self._fingerprint, str(self.device))
        with _SHARED_LOCK:
            entry = _SHARED.get(key)
            if entry is None:
                entry = _SharedPrefix(self, self.device)
                _SHARED[key] = entry
        with self._lock:
            if self._entry is None:
                self._entry = entry
            return self._entry

    def _stage(self, entries: List[np.ndarray], n: int, bucket: int) -> List[torch.Tensor]:
        """The batch's entries as device operands, through the bucket's
        staging buffers (one copy per dtype)."""
        entry = self._shared()
        with entry.lock:
            return self._load(entry, entries, n, bucket).operands

    def _load(self, entry: _SharedPrefix, entries: List[np.ndarray], n: int,
              bucket: int) -> Staging:
        """The batch's entries loaded into the bucket's staging buffers (one
        copy per dtype): the shared ones when another plan of the
        fingerprint built them.  Caller holds the shared lock."""
        for e in entries:
            if e.ndim != 1 or e.shape[0] != n:
                raise ValueError(f"a prefix operand must be 1-D with {n} rows, "
                                 f"got shape {e.shape}")
        st = self._hold_staging(entry, bucket, tuple(e.dtype for e in entries))
        copies = st.load(entries, n)
        with self._lock:
            self._counters["h2d_copies"] += copies
        return st

    def _hold_staging(self, entry: _SharedPrefix, bucket: int,
                      dtypes: Tuple[np.dtype, ...], shared: bool = True) -> Staging:
        """The bucket's staging buffers for ``dtypes``, held by this plan:
        its own, the fingerprint's shared ones, or new ones (one ``staging``
        compile event; ``shared`` puts them in the shared state for the
        fingerprint's other plans).  Caller holds the shared lock; the plan's
        own table is read under the plan's lock, which guards its every write
        (``release_executables`` clears it under that lock alone)."""
        with self._lock:
            st = self._staging.get(bucket)
        if st is not None and st.dtypes == dtypes:
            return st
        st = entry.staging.get(bucket)
        built = st is None or st.dtypes != dtypes
        if built:
            with obs_flight.compile_context("serve.plan", fingerprint=self._fingerprint,
                                            warm=self._warmed):
                st = Staging(dtypes, bucket, self.device)
                note_compile("staging", bucket=bucket)
            if shared:
                entry.staging[bucket] = st
        if shared:
            entry.holders.setdefault(bucket, weakref.WeakSet()).add(self)
        with self._lock:
            self._staging[bucket] = st
            self.compile_count += 1
            if built:
                self._counters["staging_builds"] += 1
        return st

    def _lowered(self, operands: List[torch.Tensor], blocks: List[tuple]
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(the wiring's operands, the encode group's operands) of a staged
        batch (``blocks``: each packed device buffer with the entries it
        holds, as :class:`Staging` packs them): the staged rows themselves
        for f32; otherwise the float32 block lowered once for all its
        entries (:func:`lower_block`), which the encode kernel reads as
        float32."""
        ops = list(operands)
        if self._precision == Precision.F32:
            return ops, ops
        enc = list(ops)
        for idx, dev in blocks:
            if dev.dtype != torch.float32:
                continue
            low = lower_block(dev, self._precision)
            wide = low if low.dtype == torch.float32 else low.to(torch.float32)
            for r, i in enumerate(idx):
                ops[i], enc[i] = low[r], wide[r]
        return ops, enc

    def _prefix_outputs(self, owner: "CompiledScoringPlan", operands: List[torch.Tensor],
                        blocks: List[tuple], rows: int) -> Dict[str, torch.Tensor]:
        """Run the prefix over staged operands (the lowering, the encode
        group's one launch, the other stages through ``owner``'s runners,
        whose fingerprint is this plan's) and return the outputs the host
        needs, by feature uid.  On the card the caller holds the shared
        lock, inside the shared stream and constant store."""
        ops, enc = self._lowered(operands, blocks)
        env: Dict[str, torch.Tensor] = {}
        owner._encode(enc, rows, env)
        owner._run_wiring(ops, env, unify=self._precision != Precision.F32)
        outs = {u: env[u] for u in self._out_uids}
        if self._precision == Precision.BF16:
            # float outputs leave the device as float32 whatever the class
            outs = {u: t.to(torch.float32) if t.is_floating_point() else t
                    for u, t in outs.items()}
        return outs

    def _device_scope(self, entry: _SharedPrefix):
        """The shared lock, the shared stream and the shared constant
        store, entered together."""
        stack = contextlib.ExitStack()
        stack.enter_context(entry.lock)
        if entry.stream is not None:
            stack.enter_context(torch.cuda.stream(entry.stream))
        stack.enter_context(const_store(entry.consts))
        return stack

    def release_executables(self, drop_shared: bool = True) -> int:
        """Release every warm bucket this plan holds — the eviction hook of
        the fleet's admission controller (``serve/registry.py``): its
        staging buffers and its landing sets; the next batch builds them
        again and counts in ``compile_count``.  ``drop_shared`` also drops
        the buckets from the fingerprint's shared state (and, once it holds
        no bucket, the prefix's device constants); a caller that knows
        another warm plan shares the fingerprint passes ``False``, so that
        plan keeps serving without an allocation.  Returns the buckets
        released; :attr:`last_released_bytes` is the device memory freed."""
        with self._lock:
            entry = self._entry
            buckets = dict(self._staging)
            self._staging.clear()
            self._free.clear()
            self._sets.clear()
            self._warmed = False
        freed = 0
        if entry is not None:
            with entry.lock:
                for b, st in buckets.items():
                    holders = entry.holders.get(b, weakref.WeakSet())
                    holders.discard(self)
                    if drop_shared and entry.staging.get(b) is st:
                        del entry.staging[b]
                        entry.holders.pop(b, None)
                        if not holders:
                            freed += _staging_bytes(st)
                if drop_shared and not entry.staging:
                    freed += entry.release_constants()
        self.last_released_bytes = freed
        if buckets:
            obs_flight.record_event(
                "executable_release", fingerprint=self._fingerprint,
                buckets=sorted(buckets), drop_shared=bool(drop_shared),
                released_bytes=freed)
        return len(buckets)

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
        with obs_flight.compile_context("serve.plan", fingerprint=self._fingerprint,
                                        warm=self._warmed):
            made = [_OutSlot(self._slot_specs, bucket, pin) for _ in range(count)]
            note_compile("landing", bucket=bucket, sets=count)
        return made

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
            free = self._free.get(handle.bucket)
            if free is not None:  # else released since (release_executables)
                free.append(handle.slot)

    def _dispatch(self, entries: List[np.ndarray], n: int) -> _Inflight:
        """Stage the batch, launch its prefix and start its copies back into
        a landing set, without waiting for any of it on the card."""
        bucket = _bucket_for(n, self.min_bucket, self.max_bucket)
        on_card = self.device.type == "cuda"
        start = end = None
        entry = self._shared()
        with self._device_scope(entry):
            t0 = time.perf_counter()
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            st = self._load(entry, entries, n, bucket)
            outs = self._prefix_outputs(entry.owner, st.operands,
                                        [(idx, dev) for idx, _np, _h, dev in st.buffers],
                                        bucket)
            if on_card:
                end.record()
            t1 = time.perf_counter()
            slot = self._take_slot(bucket, outs)
            handle = _Inflight(bucket, slot, n, start, end, t0, t1)
            try:
                for host, u in zip(slot.host, self._out_uids):
                    host[:n].copy_(outs[u][:n], non_blocking=on_card)
                if on_card:
                    handle.done = torch.cuda.Event()
                    handle.done.record()
            except BaseException:
                self._release(handle)
                raise
        return handle

    def _fused(self, *entries: np.ndarray) -> List[np.ndarray]:
        """The device prefix over raw entry operands (one array per entry,
        in :attr:`entry_specs` order, at most ``max_bucket`` rows): its
        outputs as host arrays — what the TM511 synthetic calibration gate
        compares between a plan and its f32 twin."""
        n = int(entries[0].shape[0]) if entries else 0
        if not self._prefix or not 0 < n <= self.max_bucket:
            raise ValueError(f"_fused takes 1..{self.max_bucket} rows of a "
                             "plan with a device prefix")
        handle = self._dispatch([np.ascontiguousarray(e) for e in entries], n)
        try:
            return [a.copy() for a in handle.wait()]
        finally:
            self._release(handle)

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
        full_ladder = buckets is None
        for b in (self.bucket_ladder() if buckets is None else buckets):
            self._warm_bucket(_bucket_for(b, self.min_bucket, self.max_bucket))
        if full_ladder:
            # only a FULL bucket-ladder warm arms the TM901 expectation: a
            # partial warm legitimately allocates its missing buckets later
            with self._lock:
                self._warmed = True
        return self

    def _warm_bucket(self, bucket: int) -> None:
        """One padded batch of zeros through ``bucket``."""
        handle = self._dispatch(self._warm_entries(bucket), bucket)
        try:
            handle.wait()
        finally:
            self._release(handle)

    def executable(self, bucket: int) -> BucketExecutable:
        """The executable of ``bucket`` (warming it: one padded batch of
        zeros through the prefix, which also records the kernel libraries
        its launches load) — the deploy pack side's accessor."""
        if not self._prefix:
            raise ValueError("a plan without a device prefix has no executables")
        bucket = _bucket_for(bucket, self.min_bucket, self.max_bucket)
        with libraries_used() as libs:
            self._warm_bucket(bucket)
        with self._lock:
            st = self._staging[bucket]
        return BucketExecutable(bucket, self._fingerprint, self._entry_specs,
                                [np.dtype(dt).name for dt in st.dtypes],
                                self._slot_spec_names(), libs)

    def _slot_spec_names(self) -> Optional[List[Tuple[tuple, str]]]:
        """The landing specs with torch dtype names, once known."""
        with self._lock:
            specs = self._slot_specs
        if specs is None:
            return None
        return [(tuple(shape), str(dt).replace("torch.", "")) for shape, dt in specs]

    def check_executable(self, exe: BucketExecutable,
                         bucket: Optional[int] = None) -> None:
        """Raise ``ValueError`` unless ``exe`` is an executable of this plan
        (its fingerprint, entries, staging dtypes and landing specs) for a
        bucket of its ladder (``bucket`` when given)."""
        if not isinstance(exe, BucketExecutable):
            raise ValueError(f"not a bucket executable: {type(exe).__name__}")
        if bucket is not None and exe.bucket != bucket:
            raise ValueError(f"executable of bucket {exe.bucket} filed under {bucket}")
        if exe.bucket not in self.bucket_ladder():
            raise ValueError(f"bucket {exe.bucket} is not on the plan's ladder "
                             f"{self.bucket_ladder()}")
        if exe.fingerprint != self._fingerprint:
            raise ValueError(f"executable of fingerprint {exe.fingerprint[:16]}..., "
                             f"the plan's is {self._fingerprint[:16]}...")
        if exe.entry_specs != [(tuple(t), d) for t, d in self._entry_specs]:
            raise ValueError("executable entry specs differ from the plan's")
        if exe.staging_dtypes != [e.dtype.name for e in self._warm_entries(0)]:
            raise ValueError(f"executable staging dtypes {exe.staging_dtypes} differ "
                             "from the plan's encodings")
        specs = self._slot_spec_names()
        if specs is not None and specs != exe.slot_specs:
            raise ValueError("executable landing specs differ from the plan's")
        for _t, dt in exe.slot_specs:
            _torch_dtype(dt)

    def adopt_executable(self, bucket: int, exe: BucketExecutable,
                         shared: bool = True) -> None:
        """Allocate ``bucket`` from a pre-built executable — the deploy
        artifact's hydration hook: its staging buffers (through the shared
        state of the fingerprint with ``shared``, so the fingerprint's later
        plans find them there and allocate none) and its landing ring (this
        plan's reserved sets), each counted as a compile event as the first
        batch's allocations are.  Nothing runs on the device.  Once every
        bucket of the ladder is held the plan counts as warmed (a later
        allocation is a TM901 unexpected recompile), as after a full
        :meth:`warm`."""
        bucket = _bucket_for(bucket, self.min_bucket, self.max_bucket)
        self.check_executable(exe, bucket)
        dtypes = tuple(np.dtype(dt) for dt in exe.staging_dtypes)
        entry = self._shared()
        with entry.lock:
            self._hold_staging(entry, bucket, dtypes, shared=shared)
        with self._lock:
            if self._slot_specs is None:
                self._slot_specs = [(tuple(t), _torch_dtype(dt)) for t, dt in exe.slot_specs]
            if bucket not in self._sets:
                self._free[bucket] = self._new_slots(bucket, self._ring_size)
            if not self._warmed and all(b in self._staging and b in self._sets
                                        for b in self.bucket_ladder()):
                self._warmed = True

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
        return self._fused(*self._encode_records(records)[1])

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

        # request-scoped attribution (obs/reqtrace.py), captured here on the
        # submitting thread and baked into the closure: phase marks feed the
        # per-tenant device-time cost counters, and the tenant arg on the
        # phase spans attributes a fleet flush's sub-batches to their
        # tenants.  One contextvar read each outside a batcher flush.
        # batch_seq rides every phase span so reconstruct_request rebuilds
        # the causal chain even when pipelined batches interleave.
        bt = reqtrace.active_batch()
        tenant = reqtrace.current_tenant()
        t_attr: Dict[str, Any] = {} if tenant is None else {"tenant": tenant}
        if bt is not None:
            t_attr["batch_seq"] = bt.seq

        t0 = time.perf_counter()
        with obs_trace.span("serve.encode", cat="serve", records=n, **t_attr):
            fault_point("encode", records=records)
            host_cols, entries = self._encode_records(records)
        encode_s = time.perf_counter() - t0
        if bt is not None:
            reqtrace.mark_phase("encode", t0, encode_s, records=n)
        handle = None
        dispatch_s = 0.0
        if self._prefix:
            bucket = _bucket_for(n, self.min_bucket, self.max_bucket)
            td = time.perf_counter()
            with obs_trace.span("serve.device", cat="serve", records=n,
                                bucket=bucket, padded=bucket - n, **t_attr):
                fault_point("device", records=records, bucket=bucket)
                with maybe_profile("serve"):  # TMOG_PROFILE dispatch hook
                    handle = self._dispatch(entries, n)
            dispatch_s = time.perf_counter() - td

        def _finalize() -> List[Dict[str, Any]]:
            try:
                cols = dict(host_cols)
                device_ms = 0.0
                if handle is not None:
                    for f, arr in zip(self._out_features, handle.wait()):
                        cols[f.name] = self._materialize(f, arr)
                    device_ms = handle.device_ms()
                    if bt is not None:
                        # the device mark is the prefix as the card's events
                        # time it (the figure metrics()["device_ms"] sums),
                        # with the host's dispatch seconds beside it; on the
                        # CPU both are the host's clock
                        bt.marks.append(reqtrace.Mark(
                            "device", handle.t0, device_ms / 1e3, tenant,
                            {"records": n, "bucket": handle.bucket,
                             "padded": handle.bucket - n,
                             "dispatch_s": dispatch_s}))
                t1 = time.perf_counter()
                with obs_trace.span("serve.host", cat="serve", records=n, **t_attr):
                    fault_point("host", records=records)
                    # per-stage phase spans only at the heavy "requests"
                    # detail: serve.host already times the whole remainder
                    tracer = obs_trace.active_tracer()
                    ds = run_host_stages(
                        Dataset(cols), self._remainder, device=self.device,
                        phases=tracer is None or tracer.detail == "requests")
                    out = self._rows_from(ds, n)
                host_s = time.perf_counter() - t1
                if bt is not None:
                    bt.marks.append(reqtrace.Mark("host", t1, host_s, tenant,
                                                  {"records": n}))
            finally:
                if handle is not None:
                    self._release(handle)
            timings = {"encode_ms": encode_s * 1e3, "device_ms": device_ms,
                       "host_ms": host_s * 1e3}
            with self._lock:
                c = self._counters
                for k, v in timings.items():
                    c[k] += v
                c["dispatch_ms"] += dispatch_s * 1e3
                c["scored_records"] += n
                c["scored_batches"] += 1
                if handle is not None:
                    bb = c["bucket_batches"]
                    bb[handle.bucket] = bb.get(handle.bucket, 0) + 1
                    c["padding_rows"] += handle.bucket - n
                self.last_timings = timings
                self.batch_timings.append(
                    {**timings, "dispatch_ms": dispatch_s * 1e3, "rows": n,
                     "bucket": handle.bucket if handle is not None else 0})
            return out
        return _finalize

    def score_dataset(self, dataset, sink=None):
        """Batch scoring of a (possibly chunked) dataset of raw columns.

        An in-memory ``Dataset`` decodes to records and runs through
        :meth:`score`; a :class:`~..data.chunked.ChunkedDataset` goes chunk
        by chunk, the NEXT chunk's disk read and record decode prefetched
        behind the current chunk's scoring (``readers/prefetch.py``), each
        chunk one :meth:`score` call: one encode launch when the chunk fits
        ``max_bucket``.  ``last_prefetch`` keeps the prefetcher's counters.

        Without a ``sink`` the rows of the WHOLE table return as one list;
        ``sink(rows)`` (called once per chunk, in order) streams them
        instead and the call returns the row count, so host residency stays
        one chunk.  Only features with named-field extracts can be scored
        from columns (a custom extract's record shape cannot be rebuilt:
        score those records with :meth:`score`)."""
        from ..data.chunked import ChunkedDataset

        if not isinstance(dataset, ChunkedDataset):
            rows = self.score(self._records_of(dataset))
            if sink is None:
                return rows
            sink(rows)
            return len(rows)
        from ..readers.prefetch import ChunkPrefetcher, PrefetchStats

        raw_names = [g.raw_name for g in self._generators if g.raw_name in dataset]
        self._check_named_extracts(dataset)

        def loader(ci):
            # the whole ingest half runs on the prefetch worker: the chunk's
            # raw columns off the spill store and their decode to records
            return self._records_of(dataset.chunk(ci, names=raw_names))

        out: List[Dict[str, Any]] = []
        count = 0
        stats = PrefetchStats()
        with ChunkPrefetcher(loader, dataset.n_chunks, stats=stats) as chunks:
            for _ci, records in chunks:
                rows = self.score(records)
                count += len(rows)
                if sink is None:
                    out.extend(rows)
                else:
                    sink(rows)
        self.last_prefetch = stats.to_dict()
        return count if sink is not None else out

    def _check_named_extracts(self, ds) -> None:
        """Refuse dataset scoring when a generator has a custom extract:
        re-running it over the rebuilt {field: value} record would read the
        wrong shape."""
        custom = [g.raw_name for g in self._generators
                  if g.raw_name in ds
                  and not isinstance(getattr(g, "extract_fn", None), _NamedExtract)]
        if custom:
            raise ValueError(
                f"score_dataset needs named-field extracts, but feature(s) "
                f"{sorted(custom)} use custom extract fns whose original "
                f"record shape cannot be rebuilt from columns — score the "
                f"raw records via plan.score(records) instead")

    def _records_of(self, ds: Dataset) -> List[Dict[str, Any]]:
        """Raw-record dicts (keyed by each generator's extract key) from a
        dataset of raw columns: the columnar-to-record decode dataset
        scoring feeds through :meth:`score`."""
        self._check_named_extracts(ds)
        keys = [(g.extract_fn.key, g.raw_name) for g in self._generators
                if g.raw_name in ds]
        cols = {raw: ds[raw].to_values() for _k, raw in keys}
        return [{k: cols[raw][i] for k, raw in keys} for i in range(ds.n_rows)]

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
        bt = reqtrace.active_batch()
        tenant = reqtrace.current_tenant()
        t_attr = {} if tenant is None else {"tenant": tenant}
        t0 = time.perf_counter()
        with obs_trace.span("serve.host_fallback", cat="serve", records=n,
                            **t_attr):
            # same per-stage-span gating as begin_score(): at the default
            # batch detail the degraded path must not flood the tracer
            tracer = obs_trace.active_tracer()
            ds = run_host_stages(
                ds, self._runners, device=torch.device("cpu"),
                phases=tracer is None or tracer.detail == "requests")
        if bt is not None:
            reqtrace.mark_phase("host_fallback", t0,
                                time.perf_counter() - t0, records=n)
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


def compile_plan(model, min_bucket: int = 8, max_bucket: int = 1024,
                 strict: bool = True, hbm_budget: Optional[float] = None,
                 precision: Optional[str] = None, *, device=None) -> CompiledScoringPlan:
    """Bind a fitted model for online scoring (the reference's
    ``compile_plan``): ``hbm_budget`` (bytes) arms the TM601 admission
    gate, ``precision`` picks the numeric class (:class:`Precision`)."""
    return CompiledScoringPlan(model, min_bucket=min_bucket, max_bucket=max_bucket,
                               strict=strict, hbm_budget=hbm_budget,
                               precision=precision, device=device)
