"""Device prefix of a fitted DAG and the training-time transform plan
(counterpart of ``transmogrifai_tpu/workflow/plan.py``).

Given topologically ordered fitted runners, :func:`partition_device_prefix`
splits them into a maximal **device prefix** (runners exposing
``device_transform`` whose device inputs are reachable from entry operands
or other prefix outputs) and a **host remainder** (everything else, run
through the ordinary columnar ``transform``).  What may enter the prefix is
the caller's rule: the serving plan (``serve/plan.py``) admits raw features
only, lifted or stage-encoded from records; the dataset plan here admits any
materialized column whose kind lifts (:data:`DATASET_LIFT_KINDS`, vector
blocks included) or that its stage encodes.

:class:`DevicePrefix` is the machinery both plans share: the entry operands
(``("lift", feature_uid)``, the canonical float32 lift shared by every
consumer, or ``("enc", stage_uid, slot)``, a stage's own host encoding), the
wiring of every prefix stage to its operands, and the **encode group**: every
prefix stage whose device half is the encode kernel and whose inputs are all
entry operands (the one-hot and bucketize slots) is encoded by one
``encode_slots`` call into one buffer, one launch per chunk of its slot
table (``perf/kernels/encode.py``).  1-D operands reach the device packed,
one pinned host buffer and one copy per dtype (:class:`Staging`).

:class:`ColumnarTransformPlan` runs a prefix over a whole ``Dataset``: the
training flushes of ``workflow/fit.py`` and ``WorkflowModel.score(dataset)``.
The table goes through in one pass (not in serving's row buckets), and every
prefix stage's output comes back to the host as a full ``Column`` with the
metadata its host ``transform`` gives (recovered by replaying those
transforms over zero rows).  :class:`JointPrefix` is the one executor of
such plans: a flush runs one, :class:`FoldTransformPlan` the k fold-fitted
variants of one prefix (workflow-level CV), every fold's encode slots in
one slot table.  Unlike the reference, a planning or launch failure
raises: nothing falls back to the per-stage host path.

A chunked epoch (``workflow/ooc.py``) runs one plan over every chunk of a
table with ``apply_prefix(chunk, tile=rows)``: the chunk is staged into the
plan's one :class:`TileBuffers` (pinned staging, vector blocks and encode
buffer of ``tile`` rows, allocated at the first chunk and counted as one
compile), so chunks 2..N allocate nothing.  ``hbm_budget`` arms the TM601
gate (:func:`check_plan_hbm_budget`) before any launch.
"""

from __future__ import annotations

import functools
import hashlib
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Column, Dataset
from ..features.generator import FeatureGeneratorStage
from ..perf.kernels import encode as KE
from ..parallel import mesh as PM
from ..perf.kernels.dispatch import resolve_device
from ..types import ColumnKind

#: kinds with a canonical device lift everywhere: float32 rows, NaN where
#: missing (a geolocation: its (n, 3) block, zeros where missing).  VECTOR
#: is absent on purpose: a serving plan's output width must not depend on
#: the batch.
DEVICE_LIFT_KINDS = frozenset(
    {ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL, ColumnKind.GEO})

#: the dataset path also lifts materialized OPVector columns (their float32
#: block): each run sees the concrete table
DATASET_LIFT_KINDS = DEVICE_LIFT_KINDS | {ColumnKind.VECTOR}


def mesh_aligned_tile(n: int) -> int:
    """The row tile for ``n`` rows: ``n`` rounded up to the ambient mesh's
    data-axis multiple, so a tile splits evenly across the ranks.  The one
    place encoding the tile x mesh rule: a chunked epoch
    (``workflow/ooc.py``) takes it once, and every chunk pads to it.  (The
    reference also rounds up to a power-of-two bucket, one XLA program per
    row count; torch's programs take any count.)"""
    mesh = PM.current_mesh()
    n = int(n)
    if mesh is not None:
        n += (-n) % int(mesh.shape[PM.DATA_AXIS])
    return n


def encode_buffer(rows: int, width: int, device: torch.device) -> torch.Tensor:
    """An (rows, width) float32 view whose row stride is rounded up to 4
    floats, so the encode kernel's rows start 16-byte aligned."""
    return torch.empty((rows, -(-width // 4) * 4), dtype=torch.float32,
                       device=device)[:, :width]


def device_slots(runner) -> Tuple[int, ...]:
    """Input slots a runner's ``device_transform`` consumes (default: all)."""
    slots = getattr(runner, "device_input_slots", None)
    if slots is None:
        return tuple(range(len(runner.inputs)))
    return tuple(slots)


def partition_device_prefix(runners: Sequence[Any], entry_ok: Callable):
    """Split topo-ordered runners into ``(prefix, remainder, device_uids)``,
    ``device_uids`` being the feature uids the prefix materializes."""
    device_uids: set = set()
    prefix: List[Any] = []
    remainder: List[Any] = []
    for runner in runners:
        ok = callable(getattr(runner, "device_transform", None)) \
            and len(runner.inputs) > 0
        if ok:
            for slot in device_slots(runner):
                f = runner.inputs[slot]
                if f.uid in device_uids or entry_ok(runner, slot, f):
                    continue
                ok = False
                break
        if ok:
            prefix.append(runner)
            device_uids.add(runner.get_output().uid)
        else:
            remainder.append(runner)
    return prefix, remainder, device_uids


def serving_entry_ok(runner, slot, f) -> bool:
    """Serving rule: raw features only, canonical lift or stage encoding."""
    return isinstance(f.origin_stage, FeatureGeneratorStage) and (
        f.ftype.kind in DEVICE_LIFT_KINDS or runner.device_lifts_input(slot))


def _unify_float_dtypes(ops: List[torch.Tensor]) -> List[torch.Tensor]:
    """Promote every float operand to the widest float dtype present."""
    floats = {o.dtype for o in ops if o.is_floating_point()}
    if len(floats) <= 1:
        return ops
    widest = functools.reduce(torch.promote_types, floats)
    return [o.to(widest) if o.is_floating_point() else o for o in ops]


def run_host_stages(dataset: Dataset, runners: Sequence[Any],
                    device=None, phases: bool = True,
                    per_runner: Optional[List[Tuple[Any, float, float]]] = None,
                    phase_name: Optional[Callable[[Any], str]] = None
                    ) -> Dataset:
    """The host remainder: each runner's columnar ``transform`` in order.
    A runner that ``scores_on_device`` (a fitted model) is told ``device``,
    where it may score large batches.  With ``per_runner`` (a list),
    appends ``(runner, start wall time, seconds)`` for each.  Each runner is
    a ``transform.<class>`` phase (``perf/timers.py``: a no-op unless a
    recorder or tracer is active; ``phase_name`` names it otherwise);
    ``phases=False`` skips them — the serving path passes it at the
    tracer's default ``batch`` detail, where the enclosing ``serve.host``
    span times the whole remainder."""
    from ..perf.timers import phase

    out = dataset
    for runner in runners:
        t0 = time.perf_counter()
        w0 = time.time() if per_runner is not None else 0.0
        if phases:
            name = phase_name(runner) if phase_name is not None \
                else type(runner).__name__
            with phase(f"transform.{name}"):
                out = _run_host_stage(runner, out, device)
        else:
            out = _run_host_stage(runner, out, device)
        if per_runner is not None:
            per_runner.append((runner, w0, time.perf_counter() - t0))
    return out


def _run_host_stage(runner, dataset: Dataset, device) -> Dataset:
    if getattr(runner, "scores_on_device", False):
        return runner.transform(dataset, device=device)
    return runner.transform(dataset)


class Staging:
    """A prefix's 1-D operands for ``rows`` rows: one packed host buffer and
    one device buffer per entry dtype (on the card the host buffer is
    pinned, so its copy is one asynchronous DMA).  ``operands[i]`` is entry
    i's contiguous row of its device buffer."""

    def __init__(self, dtypes: Tuple[np.dtype, ...], rows: int,
                 device: torch.device):
        groups: Dict[np.dtype, List[int]] = {}
        for i, dt in enumerate(dtypes):
            groups.setdefault(dt, []).append(i)
        on_card = device.type == "cuda"
        self.dtypes = dtypes
        self.buffers: List[tuple] = []
        self.operands: List[torch.Tensor] = [None] * len(dtypes)
        for dt, idx in groups.items():
            host = torch.from_numpy(np.zeros((len(idx), rows), dt))
            if on_card:
                host = host.pin_memory()
            dev = host.to(device) if on_card else host
            self.buffers.append((idx, host.numpy(), host, dev))
            for r, i in enumerate(idx):
                self.operands[i] = dev[r]
        self.device = device
        self.copied = torch.cuda.Event() if on_card else None

    def load(self, entries: List[np.ndarray], n: int) -> int:
        """Fill the buffers with the entries (rows past ``n`` zeroed) and
        start their copies to the device; returns the copies issued."""
        if self.copied is not None:
            # a pinned buffer is refilled only once the previous copy out of
            # it has finished
            self.copied.synchronize()  # opcheck: allow(TM301) the last copy from the pinned buffer must land before it is refilled
        copies = 0
        for idx, host_np, host, dev in self.buffers:
            for r, i in enumerate(idx):
                host_np[r, :n] = entries[i]
            host_np[:, n:] = 0
            if dev is not host:
                dev.copy_(host, non_blocking=True)
                copies += 1
        if self.copied is not None:
            self.copied.record(torch.cuda.current_stream(self.device))
        return copies


def place_entries(entries: List[np.ndarray], keys: Sequence[tuple], n: int,
                  device: torch.device) -> Tuple[List[torch.Tensor], int]:
    """Host entries on ``device``: the 1-D ones packed, one copy per dtype
    (:class:`Staging`); each vector block its own copy.  ``keys`` name the
    entries in errors.  Returns (operands, copies)."""
    ops: List[Optional[torch.Tensor]] = [None] * len(entries)
    flat = [i for i, e in enumerate(entries) if e.ndim == 1]
    copies = 0
    if flat:
        for i in flat:
            if entries[i].shape[0] != n:
                raise ValueError(f"operand {keys[i]} has "
                                 f"{entries[i].shape[0]} rows, the table {n}")
        st = Staging(tuple(entries[i].dtype for i in flat), n, device)
        copies += st.load([entries[i] for i in flat], n)
        for j, i in enumerate(flat):
            ops[i] = st.operands[j]
    for i, e in enumerate(entries):
        if ops[i] is None:
            ops[i] = torch.from_numpy(np.ascontiguousarray(e)).to(device)
            copies += int(device.type == "cuda")
    return ops, copies


class TileBuffers:
    """The device buffers of one chunk tile of ``tile`` rows, allocated once
    and refilled by every chunk of an epoch: the 1-D entries packed in one
    :class:`Staging`, each vector entry in its own pinned host buffer and
    device block, and the encode buffer (:func:`encode_buffer`).  Rows past
    a chunk's ``n`` are zeroed, so the tail chunk runs the same tile.  The
    allocation is counted as one ``chunk_tile`` compile
    (``perf/timers.py::note_compile``)."""

    def __init__(self, entries: List[np.ndarray], tile: int, width: int,
                 device: torch.device):
        from ..perf.timers import note_compile

        t0 = time.perf_counter()
        on_card = device.type == "cuda"
        self.tile = int(tile)
        self._flat = [i for i, e in enumerate(entries) if e.ndim == 1]
        self.staging = Staging(tuple(entries[i].dtype for i in self._flat),
                               self.tile, device) if self._flat else None
        self._blocks: Dict[int, tuple] = {}
        for i, e in enumerate(entries):
            if e.ndim == 1:
                continue
            host = torch.from_numpy(np.zeros((self.tile, *e.shape[1:]), e.dtype))
            if on_card:
                host = host.pin_memory()
            self._blocks[i] = (host.numpy(), host,
                               host.to(device) if on_card else host)
        self.copied = torch.cuda.Event() if on_card and self._blocks else None
        self.encode = encode_buffer(self.tile, width, device) if width else None
        note_compile("chunk_tile", time.perf_counter() - t0, rows=self.tile,
                     entries=len(entries))

    def load(self, entries: List[np.ndarray], n: int
             ) -> Tuple[List[torch.Tensor], int]:
        """The chunk's ``n`` rows of entries into the tile's buffers, their
        copies to the device started; returns (operands, copies)."""
        if n > self.tile:
            raise ValueError(f"a chunk of {n} rows exceeds the tile of {self.tile}")
        ops: List[Optional[torch.Tensor]] = [None] * len(entries)
        copies = 0
        if self.staging is not None:
            copies += self.staging.load([entries[i] for i in self._flat], n)
            for j, i in enumerate(self._flat):
                ops[i] = self.staging.operands[j]
        if self.copied is not None:
            # a pinned block is refilled only once its last copy finished
            self.copied.synchronize()  # opcheck: allow(TM301) the last copy from the pinned buffer must land before it is refilled
        for i, (host_np, host, dev) in self._blocks.items():
            host_np[:n] = entries[i]
            host_np[n:] = 0
            if dev is not host:
                dev.copy_(host, non_blocking=True)
                copies += 1
            ops[i] = dev
        if self.copied is not None:
            self.copied.record(torch.cuda.current_stream(dev.device))
        return ops, copies


class DevicePrefix:
    """The device prefix of topo-ordered fitted ``runners`` under an entry
    rule, wired for execution on ``device`` (the shared half of the serving
    and dataset plans).

    After construction: ``_prefix`` / ``_remainder`` (the partition),
    ``_entry_keys`` (the entry operands in order; ``_entry_lifts[key]`` is a
    lift's feature, ``_entry_encoders[key]`` an encoding's (runner, slot,
    feature)), ``_wiring`` (the prefix stages outside the encode group, each
    with its operand sources) and ``_encode_table`` (the encode group's slot
    table, or None)."""

    def __init__(self, runners: Sequence[Any], entry_ok: Callable,
                 device: torch.device):
        self.device = device
        self._runners = list(runners)
        self._prefix, self._remainder, self._device_uids = \
            partition_device_prefix(self._runners, entry_ok)
        self._build_entries()
        self._build_wiring()
        self._build_encode_group()

    def _build_entries(self) -> None:
        entry_keys: List[tuple] = []
        entry_index: Dict[tuple, int] = {}
        self._entry_lifts: Dict[tuple, Any] = {}
        self._entry_encoders: Dict[tuple, Tuple[Any, int, Any]] = {}
        self._slot_sources: Dict[Tuple[str, int], tuple] = {}
        for runner in self._prefix:
            for slot in device_slots(runner):
                f = runner.inputs[slot]
                if f.uid in self._device_uids:
                    self._slot_sources[(runner.uid, slot)] = ("env", f.uid)
                    continue
                if f.ftype.kind in DATASET_LIFT_KINDS \
                        and not runner.device_lifts_input(slot):
                    key = ("lift", f.uid)
                    if key not in entry_index:  # one lift per feature
                        entry_index[key] = len(entry_keys)
                        entry_keys.append(key)
                        self._entry_lifts[key] = f
                else:
                    key = ("enc", runner.uid, slot)
                    entry_index[key] = len(entry_keys)
                    entry_keys.append(key)
                    self._entry_encoders[key] = (runner, slot, f)
                self._slot_sources[(runner.uid, slot)] = ("entry", entry_index[key])
        self._entry_keys = entry_keys

    def _build_wiring(self) -> None:
        self._wiring: List[Tuple[Any, List[tuple], str]] = [
            (runner, [self._slot_sources[(runner.uid, slot)]
                      for slot in device_slots(runner)], runner.get_output().uid)
            for runner in self._prefix]

    def _build_encode_group(self) -> None:
        """Take out of the wiring every stage that describes encode slots and
        reads operands only: one slot table encodes them all into one
        buffer, each stage's output a block of its columns."""
        specs: List[KE.SlotSpec] = []
        self._encode_inputs: List[int] = []
        self._encode_blocks: List[Tuple[str, int, int]] = []
        rest = []
        for runner, srcs, out_uid in self._wiring:
            slot_specs = runner.device_slot_specs()
            if slot_specs is None or any(tag != "entry" for tag, _ in srcs):
                rest.append((runner, srcs, out_uid))
                continue
            col = sum(s.width for s in specs)
            specs.extend(slot_specs)
            self._encode_inputs.extend(key for _, key in srcs)
            self._encode_blocks.append(
                (out_uid, col, sum(s.width for s in slot_specs)))
        self._wiring = rest
        self._encode_table = KE.plan_slots(specs) if specs else None

    def _encode(self, ops_in: List[torch.Tensor], rows: int,
                env: Dict[str, torch.Tensor]) -> None:
        """The grouped stages' outputs, by one encode_slots call into one
        buffer (:func:`encode_buffer`), each stage's block a view of it."""
        table = self._encode_table
        if table is None:
            return
        inputs = [ops_in[i] for i in self._encode_inputs]
        buf = encode_buffer(rows, table.width, inputs[0].device)
        KE.encode_slots(inputs, table, buf)
        for uid, col, w in self._encode_blocks:
            env[uid] = buf[:, col:col + w]

    def prefix_fingerprint(self, environment: bool = False,
                           extra: Optional[Dict[str, Any]] = None) -> str:
        """sha256 of the prefix stages' fitted state (encoded as the port's
        ``workflow/serde.py`` saves it, so a reloaded copy of a model hashes
        equal), the prefix's wiring (entries, outputs) and ``extra`` (the
        serving plan's precision class when it is not f32); ``environment``
        adds the device type, the kernel token
        (``perf/kernels/dispatch.py::cache_token``: the kernels' sources and
        the serve-donation choice) and, under a mesh, its token
        (``parallel/mesh.py::mesh_token``), so a meshed plan never aliases an
        unmeshed one.  Equal fingerprints run the same prefix."""
        from ..parallel.mesh import mesh_token
        from ..perf.kernels.dispatch import cache_token
        from .serde import _Encoder, encode_stage

        enc = _Encoder()
        payload = {"stages": [encode_stage(s, enc, full=True) for s in self._prefix],
                   "extra": {"entries": [list(k) for k in self._entry_keys],
                             "outs": self._out_uids, **(extra or {})}}
        if environment:
            payload["device"] = self.device.type
            payload["kernels"] = cache_token()
            if mesh_token() is not None:
                payload["mesh"] = mesh_token()
        h = hashlib.sha256(json.dumps(payload, sort_keys=True, default=repr).encode())
        for key in sorted(enc.arrays):
            arr = np.ascontiguousarray(enc.arrays[key])
            h.update(f"{key}:{arr.shape}:{arr.dtype}".encode())
            h.update(arr.tobytes())
        return h.hexdigest()

    def _run_wiring(self, ops_in: List[torch.Tensor],
                    env: Dict[str, torch.Tensor], unify: bool = False) -> None:
        """Every prefix stage outside the encode group, in topological order.
        With ``unify`` (a reduced-precision serving class), each stage's
        float operands are first promoted to the widest float dtype among
        them, as the reference's ``_unify_float_dtypes``: a bf16 entry can
        meet a sibling a stage already made float32."""
        for runner, srcs, out_uid in self._wiring:
            ops = [env[key] if tag == "env" else ops_in[key] for tag, key in srcs]
            if unify:
                ops = _unify_float_dtypes(ops)
            env[out_uid] = runner.device_transform(*ops)


# ---------------------------------------------------------------------------
# Columnar (Dataset -> Dataset) plan
# ---------------------------------------------------------------------------

def _lift_column(col: Column) -> np.ndarray:
    """Canonical device operand of a materialized column: float32 rows, NaN
    where missing; a vector or geolocation column ships its block (missing
    points are zeros there already)."""
    if col.kind in (ColumnKind.VECTOR, ColumnKind.GEO):
        return np.asarray(col.data, np.float32)
    return col.values_f64().astype(np.float32)


def _materialize_from(template: Column, arr: np.ndarray) -> Column:
    """A prefix output as the column the host ``transform`` would have built
    (``template``: that column over zero rows, for its type and metadata)."""
    kind = template.kind
    if kind is ColumnKind.VECTOR:
        return Column.vector(np.ascontiguousarray(arr), template.meta)
    if kind in (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL):
        mask = ~np.isnan(arr)
        data = np.where(mask, arr.astype(np.float64), 0.0)
        if kind is not ColumnKind.FLOAT:
            data = data.astype(template.data.dtype)
        return Column(template.ftype, data, mask, template.meta)
    return Column(template.ftype, np.asarray(arr), None, template.meta)


class ColumnarTransformPlan(DevicePrefix):
    """Fitted topo-ordered runners over a dataset of the columns
    ``available``: :meth:`apply_prefix` runs the device prefix over the whole
    table on ``device`` (through :class:`JointPrefix`) and appends every
    prefix stage's output column; the caller runs ``remainder`` on the
    host.  ``last_timings``: the last :meth:`apply_prefix`'s, as
    :class:`JointPrefix` gives them."""

    def __init__(self, runners: Sequence[Any], available: frozenset,
                 device: torch.device):
        self._available = frozenset(available)

        def entry_ok(runner, slot, f):
            if f.name not in self._available:
                return False
            return (f.ftype.kind in DATASET_LIFT_KINDS
                    or runner.device_lifts_input(slot))

        super().__init__(runners, entry_ok, device)
        # every prefix output materializes (a later fit may read any)
        self._out_uids = [r.get_output().uid for r in self._prefix]
        self._out_names = {r.get_output().uid: r.output_name for r in self._prefix}
        self._needed = sorted({f.name for r in self._prefix for f in r.inputs})
        #: the replayed output metadata of inputs that carry none (raw
        #: columns), by the inputs' types: a plan kept across batches
        #: (``local/scoring.py``) replays the prefix's metadata once
        self._info_cache: Dict[tuple, Dict[str, Column]] = {}
        #: the chunk tile's buffers (:class:`TileBuffers`), kept across the
        #: chunks of an epoch
        self._tile_buffers: Optional[TileBuffers] = None
        self.last_timings: Dict[str, float] = {}

    @property
    def remainder(self) -> List[Any]:
        return list(self._remainder)

    def _out_info(self, dataset: Dataset) -> Dict[str, Column]:
        """Each prefix output's (type, metadata, kind), by replaying the
        prefix's host transforms over zero rows: metadata depends on the
        fitted state and the input metadata only, so inputs without
        metadata replay once per set of input types."""
        present = [n for n in self._needed if n in dataset]
        key = None
        if all(dataset[n].meta is None for n in present):
            key = tuple((n, dataset[n].ftype) for n in present)
            hit = self._info_cache.get(key)
            if hit is not None:
                return hit
        empty = np.zeros(0, dtype=np.intp)
        ds0 = Dataset({name: dataset[name].take(empty) for name in present})
        info: Dict[str, Column] = {}
        for runner in self._prefix:
            ds0 = runner.transform(ds0)
            info[runner.get_output().uid] = ds0[runner.output_name]
        if key is not None:
            self._info_cache[key] = info
        return info

    def _host_entry(self, key: tuple, dataset: Dataset) -> np.ndarray:
        if key[0] == "lift":
            return _lift_column(dataset[self._entry_lifts[key].name])
        runner, slot, f = self._entry_encoders[key]
        return np.asarray(runner.encode_device_input(slot, dataset[f.name]))

    def encode_operands(self, dataset: Dataset) -> List[torch.Tensor]:
        """The encode group's operands over ``dataset``, placed on the
        plan's device (what :meth:`apply_prefix` passes to its launch)."""
        return JointPrefix([self]).encode_operands(dataset)

    def apply_prefix(self, dataset: Dataset, tile: Optional[int] = None) -> Dataset:
        """Run the device prefix over the whole table, appending every
        prefix stage's output column.  ``tile`` (a chunked epoch's chunk
        rows) runs the table through this plan's :class:`TileBuffers` of
        that many rows instead of buffers sized to the table."""
        from ..perf.timers import phase

        if not self._prefix:
            return dataset
        joint = JointPrefix([self])
        with phase("transform.fused_plan"):
            (out,) = joint.apply_prefix(dataset, tile=tile)
        self.last_timings = joint.last_timings
        return out


# ---------------------------------------------------------------------------
# One or more prefixes over one dataset, their encode groups in one launch
# ---------------------------------------------------------------------------

class JointPrefix:
    """The executor of :class:`ColumnarTransformPlan` prefixes over one
    dataset (one plan for a flush; k fold-fitted variants of one prefix for
    workflow-level CV).  Every plan's encode group joins ONE slot table:
    slot (f, s) is plan f's slot s with its own splits and width, and the
    table writes one ``(n, sum_f W_f)`` buffer whose column block
    ``[off_f, off_f + W_f)`` is plan f's.  A lift every plan reads is placed
    once; a stage-encoded entry (a fold's own vocabulary) once per plan.
    The rest of each prefix then runs on its views; the caller runs each
    plan's ``remainder`` on the host.  A failure to plan or to launch
    raises.

    ``last_timings`` (seconds) splits the last :meth:`apply_prefix` into
    host encode (entries and the zero-row metadata replay), the copies to
    the device, the device prefixes (the joint launch is also timed alone,
    ``encode_ms``, with CUDA events on the card), the copies back, and
    building the output columns; ``h2d_copies`` / ``d2h_copies`` count its
    copies across the host-device boundary (0 on the CPU) and
    ``encode_launches`` the encode kernel's launches by this call's thread."""

    def __init__(self, plans: Sequence[ColumnarTransformPlan]):
        self.plans = list(plans)
        self.device = self.plans[0].device
        specs: List[KE.SlotSpec] = []
        #: per slot of the joint table: (plan, entry index in that plan)
        self._inputs: List[Tuple[int, int]] = []
        #: per plan: its block's first column in the joint buffer
        self._offsets: List[int] = []
        for f, p in enumerate(self.plans):
            self._offsets.append(sum(s.width for s in specs))
            if p._encode_table is not None:
                specs.extend(p._encode_table.specs)
                self._inputs.extend((f, i) for i in p._encode_inputs)
        self.table = (self.plans[0]._encode_table if len(self.plans) == 1
                      else KE.plan_slots(specs) if specs else None)
        self.last_timings: Dict[str, Any] = {}

    @property
    def remainders(self) -> List[List[Any]]:
        return [p.remainder for p in self.plans]

    def _entries(self, dataset: Dataset):
        """(host entries, their keys, per plan the indices of its entries
        among them): a lift every plan reads is one entry."""
        keys: List[tuple] = []
        index: Dict[tuple, int] = {}
        plan_ops: List[List[int]] = []
        entries: List[np.ndarray] = []
        for f, p in enumerate(self.plans):
            mine = []
            for key in p._entry_keys:
                g = key if key[0] == "lift" else (f, *key)
                if g not in index:
                    index[g] = len(keys)
                    keys.append(g)
                    entries.append(p._host_entry(key, dataset))
                mine.append(index[g])
            plan_ops.append(mine)
        return entries, keys, plan_ops

    def encode_operands(self, dataset: Dataset) -> List[torch.Tensor]:
        """The joint slot table's operands over ``dataset``, placed on the
        device (what :meth:`apply_prefix` passes to its launch)."""
        entries, keys, plan_ops = self._entries(dataset)
        ops, _ = place_entries(entries, keys, dataset.n_rows, self.device)
        return [ops[plan_ops[f][i]] for f, i in self._inputs]

    def _tile(self, entries: List[np.ndarray], tile: int) -> TileBuffers:
        """The first plan's tile buffers, built at its first chunk of
        ``tile`` rows (a plan's entries keep their dtypes and widths)."""
        owner = self.plans[0]
        if owner._tile_buffers is None or owner._tile_buffers.tile != tile:
            owner._tile_buffers = TileBuffers(
                entries, tile, self.table.width if self.table is not None else 0,
                self.device)
        return owner._tile_buffers

    def apply_prefix(self, dataset: Dataset, keep: Optional[frozenset] = None,
                     tile: Optional[int] = None) -> List[Dataset]:
        """Every plan's prefix over the whole table: one dataset per plan,
        ``dataset`` plus that plan's prefix outputs (only the columns named
        in ``keep``, when given).  With ``tile`` the table (at most ``tile``
        rows) runs through the first plan's :class:`TileBuffers`: every
        launch covers the tile's rows, the outputs' first ``n`` come back.

        Under a mesh whose data axis splits the rows (``parallel/mesh.py``),
        each rank places and encodes its span of the table only (one encode
        launch) and the output columns are gathered back in row order, so
        every rank's dataset holds the whole table, equal to an unmeshed
        flush (the prefix is row by row)."""
        n = dataset.n_rows
        span = PM.row_span(n) if tile is None and PM.sharded() else None
        n_mine = n if span is None else span.stop - span.start
        rows = n_mine if tile is None else int(tile)
        on_card = self.device.type == "cuda"

        def sync():
            if on_card:
                torch.cuda.synchronize(self.device)  # opcheck: allow(TM301) the flush's parts are timed: host encode, copies, device

        t0 = time.perf_counter()
        infos = [p._out_info(dataset) for p in self.plans]
        entries, keys, plan_ops = self._entries(dataset)
        placed = entries if span is None else [e[span] for e in entries]
        t1 = time.perf_counter()
        if tile is None:
            ops, h2d = place_entries(placed, keys, n_mine, self.device)
            buf = None
        else:
            tb = self._tile(entries, rows)
            ops, h2d = tb.load(entries, n)
            buf = tb.encode
        sync()
        t2 = time.perf_counter()
        envs: List[Dict[str, torch.Tensor]] = [{} for _ in self.plans]
        launches0 = KE.thread_encode_launches()
        if self.table is not None:
            if buf is None:
                buf = encode_buffer(rows, self.table.width, self.device)
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            KE.encode_slots([ops[plan_ops[f][i]] for f, i in self._inputs],
                            self.table, buf)
            if on_card:
                end.record()
            for f, p in enumerate(self.plans):
                off = self._offsets[f]
                for uid, col, w in p._encode_blocks:
                    envs[f][uid] = buf[:, off + col:off + col + w]
        for f, p in enumerate(self.plans):
            p._run_wiring([ops[g] for g in plan_ops[f]], envs[f])
        sync()
        t3 = time.perf_counter()
        # on the CPU ``.cpu()`` aliases: a tile's buffers are refilled by the
        # next chunk, so its outputs are copied out
        own = tile is not None and not on_card

        def host(t: torch.Tensor) -> np.ndarray:
            if span is not None:
                t = PM.gather_rows(t[:n_mine].contiguous(), n)
            arr = t[:n].cpu().numpy()
            return arr.copy() if own else arr

        outs = [{u: host(envs[f][u]) for u in p._out_uids
                 if keep is None or p._out_names[u] in keep}
                for f, p in enumerate(self.plans)]
        t4 = time.perf_counter()
        out = [dataset.with_columns({p._out_names[u]: _materialize_from(infos[f][u], arr)
                                     for u, arr in outs[f].items()})
               for f, p in enumerate(self.plans)]
        t5 = time.perf_counter()
        arrays = [a for o in outs for a in o.values()]
        self.last_timings = {
            "rows": n, "plans": len(self.plans),
            "stages": sum(len(p._prefix) for p in self.plans),
            "encode_slots": len(self.table) if self.table is not None else 0,
            "encode_width": self.table.width if self.table is not None else 0,
            "host_encode_s": t1 - t0, "h2d_s": t2 - t1, "device_s": t3 - t2,
            "d2h_s": t4 - t3, "columns_s": t5 - t4,
            "encode_ms": start.elapsed_time(end)
            if on_card and self.table is not None else None,
            "encode_launches": KE.thread_encode_launches() - launches0,
            "h2d_copies": h2d, "d2h_copies": len(arrays) if on_card else 0,
            # the bytes this rank copied: its span up (``placed``), and back
            # the whole columns the gather left on its device
            "h2d_bytes": sum(e.nbytes for e in placed),
            "d2h_bytes": sum(a.nbytes for a in arrays)}
        return out


class FoldTransformPlan(JointPrefix):
    """k fold-fitted variants of the same topo-ordered runners over one
    dataset: ``fold_runners[f]`` is fold f's list (copies share uids, each
    fold with its own fitted state).  Each fold gets its own
    :class:`ColumnarTransformPlan` (a bucketizer that found no split in one
    fold is a wired torch op there and an encode slot in another), and
    every fold's encode slots run in one launch (:class:`JointPrefix`)."""

    def __init__(self, fold_runners: Sequence[Sequence[Any]], available: frozenset,
                 device: torch.device):
        super().__init__([ColumnarTransformPlan(r, available, device)
                          for r in fold_runners])


def check_plan_hbm_budget(plan: ColumnarTransformPlan, dataset, hbm_budget: float,
                          rows: Optional[int] = None):
    """TM601 admission gate on a training plan: its static peak
    device-memory estimate over ``dataset`` at ``rows`` rows
    (``checkers/plancheck.py::analyze_transform_plan``, a meta-tensor trace:
    nothing is allocated) against ``hbm_budget``; an over-budget plan raises
    :class:`~..checkers.diagnostics.OpCheckError` before anything launches.
    Returns the :class:`~..checkers.plancheck.PlanCostReport` of an admitted
    plan.  An analyzer failure fails closed as TM606: the armed budget
    cannot be evaluated, and running the unchecked plan would admit
    anything."""
    from ..checkers.diagnostics import DiagnosticReport, OpCheckError, make_diagnostic
    from ..checkers.plancheck import analyze_transform_plan, cost_diagnostics

    try:
        report = analyze_transform_plan(plan, dataset, rows)
        diags = [d for d in cost_diagnostics(report, hbm_budget=hbm_budget)
                 if d.code == "TM601"]
    except Exception as e:  # noqa: BLE001 — fail closed, not raw
        raise OpCheckError(DiagnosticReport(diagnostics=[make_diagnostic(
            "TM606",
            f"hbm_budget contract requested but the plan cost could not be "
            f"computed ({type(e).__name__}: {e})")])) from e
    if diags:
        raise OpCheckError(DiagnosticReport(diagnostics=diags, plan_cost=report))
    return report


def fused_fold_transforms(dataset: Dataset, during: Sequence[Any],
                          fold_runner_maps: Sequence[Dict[str, Any]], device=None,
                          keep: Optional[frozenset] = None,
                          profile: Optional[list] = None,
                          hbm_budget: Optional[float] = None) -> List[Dataset]:
    """Apply every fold's fitted ``during`` stages to ALL rows of
    ``dataset``: the device prefixes through one :class:`FoldTransformPlan`
    (all folds' encode slots in one ``encode_slots`` call), then each fold's
    host remainder.  ``fold_runner_maps[f]`` maps a stage uid to fold f's
    runner (a plain transformer maps to itself).  With ``profile`` (a
    list), appends one ``{"kind": "fold_transform", ...}`` record.

    ``hbm_budget`` (bytes): each fold's plan passes the TM601 gate
    (:func:`check_plan_hbm_budget`) or the call raises before any launch.
    The joint launch holds every fold's buffers at once, so when the folds'
    estimates sum past the budget the folds run one plan at a time (the
    reference's per-fold plans when its vmapped program would not fit)."""
    t0 = time.perf_counter()
    resolved = [[m.get(s.uid, s) for s in during] for m in fold_runner_maps]
    dev = resolve_device(device)
    plan = FoldTransformPlan(resolved, frozenset(dataset.names), dev)
    from ..perf.timers import phase

    if keep is not None:
        keep = frozenset(keep) | {f.name for rem in plan.remainders
                                  for r in rem for f in r.inputs}
    execs = [plan]
    if hbm_budget is not None:
        costs = [check_plan_hbm_budget(p, dataset, hbm_budget) for p in plan.plans]
        if sum(c.peak_hbm_bytes for c in costs) > hbm_budget:
            execs = [JointPrefix([p]) for p in plan.plans]
    with phase("transform.fused_fold_plan"):
        out = [ds for ex in execs for ds in ex.apply_prefix(dataset, keep)]
    t1 = time.perf_counter()
    out = [run_host_stages(ds, rem, device=dev)
           for ds, rem in zip(out, plan.remainders)]
    if profile is not None:
        profile.append({"kind": "fold_transform", "seconds": time.perf_counter() - t0,
                        "host_stages_s": time.perf_counter() - t1,
                        "host_stages": sum(len(r) for r in plan.remainders),
                        **execs[-1].last_timings,
                        "encode_launches": sum(e.last_timings["encode_launches"]
                                               for e in execs)})
    return out


def plan_for_features(dataset: Dataset, result_features, fitted, device=None
                      ) -> Optional[ColumnarTransformPlan]:
    """The whole-table plan ``transform_dag`` would run for a fitted
    workflow over ``dataset`` (None when a stage is unfitted), built and
    not run: its :meth:`~DevicePrefix.prefix_fingerprint` names the prefix
    (``workflow/continual.py`` compares a refit's with its base model's)."""
    from .dag import compute_dag
    from .fit import _resolve

    runners = []
    for layer in compute_dag(result_features):
        for stage in layer:
            runner = _resolve(stage, dict(fitted))
            if runner is None:
                return None
            runners.append(runner)
    return ColumnarTransformPlan(runners, frozenset(dataset.names),
                                 resolve_device(device))


def operation_name(stage) -> str:
    """A stage's name in phase paths: its operation name, else its class."""
    return getattr(stage, "operation_name", None) or type(stage).__name__


def notify_listeners(dataset: Dataset, runners: Sequence[Any], timed: list,
                     prefix_ms: float, started: float) -> None:
    """Hand the active stage-metrics listeners one ``transform`` record per
    runner, in order, with the rows of ``dataset`` and the columns each
    stage saw and made, as the reference's per-stage path reports them:
    a host-remainder stage (in ``timed``: ``(runner, start, seconds)``) its
    own time, a prefix stage ``prefix_ms`` from ``started``."""
    from ..utils.listener import notify_stage

    own = {id(r): (w, dt * 1e3) for r, w, dt in timed}
    names = list(dataset.names)
    for r in runners:
        n_in = len(names)
        if r.output_name not in names:
            names.append(r.output_name)
        w, ms = own.get(id(r), (started, prefix_ms))
        notify_stage(r, "transform", ms, dataset.n_rows, n_in, len(names), w)


def fused_transform(dataset: Dataset, runners: Sequence[Any], device=None,
                    profile: Optional[list] = None,
                    hbm_budget: Optional[float] = None) -> Dataset:
    """Transform ``dataset`` by ``runners`` on ``device`` (the CUDA card
    unless it names another): the device prefix through one
    :class:`ColumnarTransformPlan` over the whole table, then the host
    remainder.  A failure to plan or to launch raises; nothing falls back to
    the per-stage path.  With ``profile`` (a list), appends the flush's
    timings as one ``{"kind": "flush", ...}`` record (``host_stage_seconds``:
    the host remainder's seconds by stage class).

    With a stage-metrics listener active (``utils/listener.py``) the flush
    still runs as one plan — its prefix stays one encode launch on the
    device — and hands the listeners one ``transform`` record per stage it
    ran, in ``runners`` order, with the rows and columns the stage saw and
    made: a host-remainder stage's own seconds, a prefix stage the wall
    time of the whole prefix (:func:`notify_listeners`).

    ``hbm_budget`` (bytes) arms the TM601 gate on the plan
    (:func:`check_plan_hbm_budget`): over budget it raises before anything
    launches."""
    from ..utils.listener import active_listeners

    listening = bool(active_listeners())
    t0 = time.perf_counter()
    w0 = time.time()
    plan = ColumnarTransformPlan(runners, frozenset(dataset.names),
                                 resolve_device(device))
    if hbm_budget is not None:
        check_plan_hbm_budget(plan, dataset, hbm_budget)
    out = plan.apply_prefix(dataset)
    t1 = time.perf_counter()
    timed: Optional[list] = [] if listening or profile is not None else None
    # a flush with no device prefix names its stages' phases as the
    # reference's per-stage path does (by operation name)
    out = run_host_stages(out, plan.remainder, device=device, per_runner=timed,
                          phase_name=None if plan._prefix else operation_name)
    if listening:
        notify_listeners(dataset, runners, timed, (t1 - t0) * 1e3, w0)
    if profile is not None:
        host: Dict[str, float] = {}
        for r, _w, dt in timed:
            host[type(r).__name__] = host.get(type(r).__name__, 0.0) + dt
        profile.append({"kind": "flush", "seconds": time.perf_counter() - t0,
                        "host_stages_s": time.perf_counter() - t1,
                        "host_stages": len(plan.remainder),
                        "host_stage_seconds": host, **plan.last_timings})
    return out
