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
transforms over zero rows).  Unlike the reference, a planning or launch
failure raises: nothing falls back to the per-stage host path.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Column, Dataset
from ..features.generator import FeatureGeneratorStage
from ..perf.kernels import encode as KE
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


def run_host_stages(dataset: Dataset, runners: Sequence[Any],
                    device=None, seconds: Optional[Dict[str, float]] = None) -> Dataset:
    """The host remainder: each runner's columnar ``transform`` in order.
    A runner that ``scores_on_device`` (a fitted model) is told ``device``,
    where it may score large batches.  With ``seconds`` (a dict), adds each
    runner's seconds under its class name."""
    out = dataset
    for runner in runners:
        t0 = time.perf_counter()
        if getattr(runner, "scores_on_device", False):
            out = runner.transform(out, device=device)
        else:
            out = runner.transform(out)
        if seconds is not None:
            name = type(runner).__name__
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
    return out


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
            self.copied.synchronize()
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
        """The grouped stages' outputs, by one encode_slots call: a buffer
        whose row stride is rounded up to 4 floats (so the kernel's rows
        start 16-byte aligned), each stage's block a view of it."""
        table = self._encode_table
        if table is None:
            return
        width = table.width
        buf = torch.empty((rows, -(-width // 4) * 4), dtype=torch.float32,
                          device=self.device)[:, :width]
        KE.encode_slots([ops_in[i] for i in self._encode_inputs], table, buf)
        for uid, col, w in self._encode_blocks:
            env[uid] = buf[:, col:col + w]

    def _run_wiring(self, ops_in: List[torch.Tensor],
                    env: Dict[str, torch.Tensor]) -> None:
        """Every prefix stage outside the encode group, in topological order."""
        for runner, srcs, out_uid in self._wiring:
            ops = [env[key] if tag == "env" else ops_in[key] for tag, key in srcs]
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
    table on ``device`` and appends every prefix stage's output column;
    the caller runs ``remainder`` on the host.

    ``last_timings`` (seconds) splits the last :meth:`apply_prefix` into
    host encode (entries and the zero-row metadata replay), the copies to
    the device, the device prefix (the encode group's launch is also timed
    alone, ``encode_ms``, with CUDA events on the card), the copies back,
    and building the output columns; ``h2d_copies`` / ``d2h_copies`` count
    its copies across the host-device boundary (0 on the CPU)."""

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
        self.last_timings: Dict[str, float] = {}

    @property
    def remainder(self) -> List[Any]:
        return list(self._remainder)

    def _out_info(self, dataset: Dataset) -> Dict[str, Column]:
        """Each prefix output's (type, metadata, kind), by replaying the
        prefix's host transforms over zero rows: metadata depends on the
        fitted state and the input metadata only."""
        empty = np.zeros(0, dtype=np.intp)
        needed = {f.name for runner in self._prefix for f in runner.inputs}
        ds0 = Dataset({name: dataset[name].take(empty)
                       for name in needed if name in dataset})
        info: Dict[str, Column] = {}
        for runner in self._prefix:
            ds0 = runner.transform(ds0)
            info[runner.get_output().uid] = ds0[runner.output_name]
        return info

    def _host_entries(self, dataset: Dataset) -> List[np.ndarray]:
        out = []
        for key in self._entry_keys:
            if key[0] == "lift":
                out.append(_lift_column(dataset[self._entry_lifts[key].name]))
            else:
                runner, slot, f = self._entry_encoders[key]
                out.append(np.asarray(runner.encode_device_input(slot, dataset[f.name])))
        return out

    def _place(self, entries: List[np.ndarray], n: int) -> Tuple[List[torch.Tensor], int]:
        """The entries on the device: 1-D ones packed, one copy per dtype;
        each vector block its own copy.  Returns (operands, copies)."""
        ops: List[Optional[torch.Tensor]] = [None] * len(entries)
        flat = [i for i, e in enumerate(entries) if e.ndim == 1]
        copies = 0
        if flat:
            for i in flat:
                if entries[i].shape[0] != n:
                    raise ValueError(f"operand {self._entry_keys[i]} has "
                                     f"{entries[i].shape[0]} rows, the table {n}")
            st = Staging(tuple(entries[i].dtype for i in flat), n, self.device)
            copies += st.load([entries[i] for i in flat], n)
            for j, i in enumerate(flat):
                ops[i] = st.operands[j]
        for i, e in enumerate(entries):
            if ops[i] is None:
                ops[i] = torch.from_numpy(np.ascontiguousarray(e)).to(self.device)
                copies += int(self.device.type == "cuda")
        return ops, copies

    def apply_prefix(self, dataset: Dataset) -> Dataset:
        """Run the device prefix over the whole table, appending every
        prefix stage's output column."""
        if not self._prefix:
            return dataset
        n = dataset.n_rows
        on_card = self.device.type == "cuda"

        def sync():
            if on_card:
                torch.cuda.synchronize(self.device)

        t0 = time.perf_counter()
        info = self._out_info(dataset)
        entries = self._host_entries(dataset)
        t1 = time.perf_counter()
        ops_in, h2d = self._place(entries, n)
        sync()
        t2 = time.perf_counter()
        env: Dict[str, torch.Tensor] = {}
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        self._encode(ops_in, n, env)
        if on_card:
            end.record()
        self._run_wiring(ops_in, env)
        sync()
        t3 = time.perf_counter()
        outs = [env[u].cpu().numpy() for u in self._out_uids]
        t4 = time.perf_counter()
        cols = {self._out_names[u]: _materialize_from(info[u], arr)
                for u, arr in zip(self._out_uids, outs)}
        out = dataset.with_columns(cols)
        t5 = time.perf_counter()
        self.last_timings = {
            "rows": n, "stages": len(self._prefix),
            "encode_slots": len(self._encode_table) if self._encode_table else 0,
            "host_encode_s": t1 - t0, "h2d_s": t2 - t1, "device_s": t3 - t2,
            "d2h_s": t4 - t3, "columns_s": t5 - t4,
            "encode_ms": start.elapsed_time(end)
            if on_card and self._encode_table is not None else None,
            "h2d_copies": h2d, "d2h_copies": len(outs) if on_card else 0,
            "h2d_bytes": sum(e.nbytes for e in entries),
            "d2h_bytes": sum(a.nbytes for a in outs)}
        return out


def fused_transform(dataset: Dataset, runners: Sequence[Any], device=None,
                    profile: Optional[list] = None) -> Dataset:
    """Transform ``dataset`` by ``runners`` on ``device`` (the CUDA card
    unless it names another): the device prefix through one
    :class:`ColumnarTransformPlan` over the whole table, then the host
    remainder.  A failure to plan or to launch raises; nothing falls back to
    the per-stage path.  With ``profile`` (a list), appends the flush's
    timings as one ``{"kind": "flush", ...}`` record (``host_stage_seconds``:
    the host remainder's seconds by stage class)."""
    t0 = time.perf_counter()
    plan = ColumnarTransformPlan(runners, frozenset(dataset.names),
                                 resolve_device(device))
    out = plan.apply_prefix(dataset)
    t1 = time.perf_counter()
    host: Optional[Dict[str, float]] = {} if profile is not None else None
    out = run_host_stages(out, plan.remainder, device=device, seconds=host)
    if profile is not None:
        profile.append({"kind": "flush", "seconds": time.perf_counter() - t0,
                        "host_stages_s": time.perf_counter() - t1,
                        "host_stages": len(plan.remainder),
                        "host_stage_seconds": host, **plan.last_timings})
    return out
