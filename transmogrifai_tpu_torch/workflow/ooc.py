"""Out-of-core chunked execution of fitted-stage runs (counterpart of
``transmogrifai_tpu/workflow/ooc.py``): the residency layer under
``fit_dag`` / ``transform_dag`` for a :class:`~..data.chunked.ChunkedDataset`.

A chunked epoch runs one :class:`~.plan.ColumnarTransformPlan` over every
chunk of the table, one chunk tile at a time: the next chunk's disk read is
prefetched behind the current chunk's device prefix
(``readers/prefetch.py``), and every output column spills back to the chunk
store as it lands.

- **one tile**: every chunk runs through the plan's one set of tile buffers
  (pinned staging, vector blocks, encode buffer of ``chunk_rows`` rows;
  ``workflow/plan.py::TileBuffers``), allocated at the first chunk and
  counted as one ``chunk_tile`` compile; the tail chunk pads up to the
  tile.  The device prefix is one encode launch per chunk over the slot
  table the in-memory flush of the same runners uses.
- **bitwise parity**: device transforms are row-local and host transforms
  apply fitted state row by row, so the chunks' outputs concatenate to the
  whole-table outputs.
- **bounded residency**: an epoch holds the prefetch depth times one
  chunk's inputs plus one chunk's outputs; an estimator fit materializes
  only its input columns (and ``__sample_weight__``), behind the TM607 gate
  of an armed ``host_budget``.
- **crash and resume**: with an :class:`~..readers.OffsetCheckpoint` the
  epoch commits its chunk offset once a chunk's outputs are on disk; a
  re-run skips the committed prefix.

Two departures from the reference, by the port's rules.  **No demotion to
the host**: the reference drops to the per-stage host path for the rest of
an epoch when its fused dispatch fails; here a planning failure or a
``KernelError`` fails the epoch (work on the card never moves to the CPU),
and a transient fault under ``resilient_training`` re-runs the same chunk
on the card (``retry_call(..., "ingest_chunk")``).  **A listener keeps the
fused epoch**: with a stage-metrics listener active each chunk still runs
the plan, and the listener gets one ``transform`` record per stage a chunk,
in the reference's order, with the chunk's rows.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..data.chunked import ChunkedDataset, ColumnChunkWriter
from ..data.dataset import Column, Dataset
from ..obs import flight as obs_flight

log = logging.getLogger(__name__)

#: process-unique tokens for runners whose state does not serialize (a
#: lambda): their epochs never resume
_UNHASHABLE = itertools.count()


@dataclass
class EpochStats:
    """What one chunked epoch did: chunks, spilled bytes, the prefetcher's
    counters, the chunks' encode launches and tile allocations, and its
    seconds by part (``seconds``: the whole prefix, and within it the plan's
    host encode, copies, device work and its encode launches, output
    columns; the host remainder; the spill)."""

    chunks_total: int = 0
    chunks_skipped: int = 0
    chunks_processed: int = 0
    bytes_spilled: int = 0
    prefetch: Dict[str, Any] = field(default_factory=dict)
    encode_launches: int = 0
    tile_allocations: int = 0
    seconds: Dict[str, float] = field(default_factory=dict)

    def add_seconds(self, part: str, value: float) -> None:
        self.seconds[part] = self.seconds.get(part, 0.0) + value


def _pad_chunk(ds: Dataset, rows: int) -> Optional[Dataset]:
    """Pad a partial tail chunk up to the full chunk tile with garbage rows
    (mask off / None), so the tail runs the same tile as every other chunk;
    device transforms are row-local, so the padded rows are sliced off
    after.  None when a column cannot be padded (an exotic subclass)."""
    n = ds.n_rows
    pad = rows - n
    if pad <= 0:
        return ds
    cols: Dict[str, Column] = {}
    for name in ds.names:
        c = ds[name]
        if type(c) is not Column:
            return None
        if c.data.dtype == object:
            extra = np.empty(pad, dtype=object)
            data = np.concatenate([c.data, extra])
            mask = None
        else:
            data = np.concatenate(
                [c.data, np.zeros((pad,) + c.data.shape[1:], c.data.dtype)])
            old = c.mask if c.mask is not None \
                else np.ones(n, dtype=np.bool_)
            mask = np.concatenate([old, np.zeros(pad, dtype=np.bool_)]) \
                if (c.mask is not None or c.is_numeric) else None
        cols[name] = Column(c.ftype, data, mask, c.meta)
    return Dataset(cols)


def _zero_row_templates(cds: ChunkedDataset, runners: Sequence[Any], device
                        ) -> Dict[str, Column]:
    """Output-column templates (type, metadata, dtype, trailing shape) from
    the runners' host transforms over a ZERO-ROW slice: metadata is a
    function of fitted state and input metadata only, never of values."""
    from .plan import run_host_stages

    empty = np.zeros(0, dtype=np.intp)
    needed = set()
    for r in runners:
        needed.update(f.name for f in r.inputs)
    ds0 = cds.select([n for n in cds.names if n in needed]).take(empty)
    out: Dict[str, Column] = {}
    for r in runners:
        ds0 = run_host_stages(ds0, [r], device=device, phases=False)
        out[r.output_name] = ds0[r.output_name]
    return out


def _epoch_fingerprint(runners: Sequence[Any]) -> str:
    """sha256 of the runners' fitted content, encoded as the port's
    ``workflow/serde.py`` saves it (a runner that does not serialize gets a
    process-unique token)."""
    from .serde import _Encoder, encode_stage

    enc = _Encoder()
    try:
        payload = [encode_stage(r, enc, full=True) for r in runners]
    except Exception:  # noqa: BLE001 — unhashable state: never resumes
        return f"unhashable-{next(_UNHASHABLE)}"
    h = hashlib.sha256(json.dumps(payload, sort_keys=True, default=repr).encode())
    for key in sorted(enc.arrays):
        arr = np.ascontiguousarray(enc.arrays[key])
        h.update(f"{key}:{arr.shape}:{arr.dtype}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _epoch_id(fp: str, cds: ChunkedDataset) -> str:
    """Resume key of one epoch: the runners' content, the table's shape and
    the INGESTED DATA's token (a re-ingest into the same spill directory
    stamps a new one, so stale offsets never resume over it)."""
    return (f"epoch:{fp[:24]}:{cds.n_rows}x{cds.chunk_rows}"
            f":{cds.data_token[:16]}")


def chunked_transform_epoch(cds: ChunkedDataset, runners: Sequence[Any],
                            hbm_budget: Optional[float] = None,
                            checkpoint=None,
                            checkpoint_id: Optional[str] = None,
                            stats: Optional[EpochStats] = None, *,
                            device=None,
                            profile: Optional[list] = None) -> ChunkedDataset:
    """Apply fitted ``runners`` to every row of ``cds``, chunk by chunk, on
    ``device`` (the CUDA card unless it names another).

    The device prefix runs through one plan whose tile every chunk reuses,
    the host remainder per chunk, and each chunk's outputs spill to the
    chunk store before the chunk's offset commits.  Exotic output columns
    (``PredictionColumn``) cannot spill and stay resident; an epoch that
    makes one does not resume (a skipped chunk would hole it).

    ``hbm_budget`` arms the TM601 gate on the chunk tile before the first
    chunk; ``checkpoint`` (default: the active ``resilient_training``'s
    chunk checkpoint) makes the epoch resumable.  With ``profile`` (a list)
    appends one ``{"kind": "epoch", ...}`` record."""
    from ..perf.kernels.dispatch import resolve_device
    from ..perf.timers import compile_snapshot, phase
    from ..readers.prefetch import PrefetchStats, prefetch_chunks
    from ..serve.faults import fault_point
    from ..utils.listener import active_listeners
    from . import resilience
    from .plan import (ColumnarTransformPlan, check_plan_hbm_budget,
                       mesh_aligned_tile, notify_listeners, operation_name,
                       run_host_stages)

    runners = list(runners)
    if not runners:
        return cds
    t_epoch = time.perf_counter()
    dev = resolve_device(device)
    if checkpoint is None:
        # Workflow.train(resume=dir) parks the checkpoint on the active
        # resilience context, so every epoch it reaches commits progress
        checkpoint = resilience.active_chunk_checkpoint()
    stats = stats if stats is not None else EpochStats()
    plan = ColumnarTransformPlan(runners, frozenset(cds.names), dev)
    templates = _zero_row_templates(cds, runners, dev)
    out_names = list(templates)
    spillable = {n for n, t in templates.items() if type(t) is Column}
    resident_out = [n for n in out_names if n not in spillable]

    n_chunks = cds.n_chunks
    chunk_rows = cds.chunk_rows
    # once an epoch: every chunk pads to the mesh-aligned tile
    tile = mesh_aligned_tile(chunk_rows)
    stats.chunks_total = n_chunks
    if hbm_budget is not None and plan._prefix and n_chunks:
        # the gate sizes the tile every chunk runs through
        check_plan_hbm_budget(plan, cds, hbm_budget, rows=tile)

    store = cds.store
    if store is None:
        from ..data.chunked import ChunkStore

        store = ChunkStore()
    # output chunk files are namespaced by the runners' content: two epochs
    # with different fitted stages over one table keep their own files,
    # while a re-run (and a resume) of the same content lands on the same
    epoch_fp = _epoch_fingerprint(runners)
    writers = {n: ColumnChunkWriter(store, f"{n}@{epoch_fp[:12]}", chunk_rows)
               for n in spillable}

    # -- resume: skip the committed chunk prefix (outputs already on disk) --
    start = 0
    epoch_id = checkpoint_id or _epoch_id(epoch_fp, cds)
    if checkpoint is not None and not resident_out:
        start = min(int(checkpoint.load(epoch_id, 0)), n_chunks)
        # every skipped chunk's spill files must exist: a store holed
        # behind the checkpoint rewinds to the first missing chunk
        for ci in range(start):
            if not all(w.has_chunk(ci) for w in writers.values()):
                start = ci
                break
        for ci in range(start):
            chunk_n = min(chunk_rows, cds.n_rows - ci * chunk_rows)
            for w in writers.values():
                w.note_existing(chunk_n)
        stats.chunks_skipped = start
        if start:
            obs_flight.record_event("chunk_resume", epoch=epoch_id,
                                    skipped_chunks=start,
                                    total_chunks=n_chunks)
    elif checkpoint is not None and resident_out:
        log.info("chunked epoch %s produces resident column(s) %s: "
                 "crash-resume disabled for this epoch", epoch_id,
                 resident_out)

    needed = set()
    for r in runners:
        needed.update(f.name for f in r.inputs)
    in_names = [n for n in cds.names if n in needed]
    resident_parts: Dict[str, List[Column]] = {n: [] for n in resident_out}
    listening = bool(active_listeners())
    phase_name = None if plan._prefix else operation_name
    tiles0 = compile_snapshot().events.get("chunk_tile", 0)

    pf_stats = PrefetchStats()
    with phase("transform.chunked_epoch"), \
            prefetch_chunks(cds, names=in_names, start=start,
                            stats=pf_stats) as chunks:
        for ci, ds_chunk in chunks:
            n = ds_chunk.n_rows

            def _process_chunk(_ci=ci, _chunk=ds_chunk, _n=n):
                # retried under resilient_training: a transient fault re-runs
                # THIS chunk on the card (its outputs overwrite in place; the
                # offset commits only after the spill below)
                fault_point("ingest_chunk", chunk=_ci, epoch=epoch_id)
                t0 = time.perf_counter()
                w0 = time.time()
                padded = (_pad_chunk(_chunk, tile) or _chunk) if plan._prefix \
                    else _chunk
                out = plan.apply_prefix(padded, tile=tile)
                if padded is not _chunk:
                    out = out.take(np.arange(_n, dtype=np.intp))
                t1 = time.perf_counter()
                timed: Optional[list] = [] if listening else None
                out = run_host_stages(out, plan.remainder, device=dev,
                                      per_runner=timed, phase_name=phase_name)
                t2 = time.perf_counter()
                if listening:
                    notify_listeners(_chunk, runners, timed, (t1 - t0) * 1e3, w0)
                return out, t1 - t0, t2 - t1

            out, prefix_s, host_s = resilience.retry_call(
                _process_chunk, "ingest_chunk", chunk=ci, epoch=epoch_id)
            stats.add_seconds("prefix", prefix_s)
            stats.add_seconds("host_stages", host_s)
            timings = plan.last_timings if plan._prefix else {}
            for part in ("host_encode_s", "h2d_s", "device_s", "d2h_s", "columns_s"):
                stats.add_seconds(part[:-2], timings.get(part, 0.0))
            stats.encode_launches += timings.get("encode_launches", 0)
            if timings.get("encode_ms") is not None:   # the launch, CUDA events
                stats.add_seconds("encode", timings["encode_ms"] / 1e3)
            t3 = time.perf_counter()
            for name in spillable:
                writers[name].write(ci, out[name])
            for name in resident_out:
                resident_parts[name].append(out[name])
            stats.add_seconds("spill", time.perf_counter() - t3)
            stats.chunks_processed += 1
            if checkpoint is not None and not resident_out:
                checkpoint.commit(epoch_id, ci + 1)

    stats.prefetch = pf_stats.to_dict()
    stats.tile_allocations = compile_snapshot().events.get("chunk_tile", 0) - tiles0
    new_spilled = {}
    for name, w in writers.items():
        new_spilled[name] = w.finish(template=templates[name])
        stats.bytes_spilled += w.bytes_written
    out_cds = cds.with_spilled_columns(new_spilled) if new_spilled else cds
    for name in resident_out:
        parts = resident_parts[name]
        # one pass over the chunks' parts (pairwise concats would re-copy
        # the accumulated block every chunk)
        col = parts[0].concat(*parts[1:]) if parts else templates[name]
        out_cds = out_cds.with_resident_column(name, col)
    if profile is not None:
        profile.append({"kind": "epoch", "seconds": time.perf_counter() - t_epoch,
                        "stages": len(runners), "device_stages": len(plan._prefix),
                        "encode_slots": len(plan._encode_table)
                        if plan._encode_table is not None else 0,
                        "chunks": n_chunks, "chunks_skipped": stats.chunks_skipped,
                        "encode_launches": stats.encode_launches,
                        "tile_allocations": stats.tile_allocations,
                        "bytes_spilled": stats.bytes_spilled,
                        "parts_s": dict(stats.seconds), "prefetch": stats.prefetch})
    return out_cds


def _gate_fit_residency(cds: ChunkedDataset, stage, names,
                        host_budget: Optional[float]) -> None:
    """TM607 runtime gate: an estimator's input columns are the one working
    set a chunked fit cannot avoid materializing, so an armed
    ``host_budget`` refuses it BEFORE the columns assemble."""
    if host_budget is None:
        return
    from ..data.chunked import column_nbytes

    need = sum(column_nbytes(cds[n]) for n in names)
    if need > host_budget:
        from ..checkers.diagnostics import (DiagnosticReport, OpCheckError,
                                            make_diagnostic)

        raise OpCheckError(DiagnosticReport(diagnostics=[make_diagnostic(
            "TM607",
            f"stage {stage.uid}: fitting requires materializing "
            f"{need} bytes of input columns ({', '.join(names)}) in host "
            f"DRAM, over the armed host_budget of {int(host_budget)} bytes",
            stage_uid=stage.uid)]))


def fit_stage_list_chunked(cds: ChunkedDataset, stages, fitted, on_fit=None,
                           hbm_budget: Optional[float] = None,
                           host_budget: Optional[float] = None,
                           checkpoint=None, *, device=None,
                           profile: Optional[list] = None) -> ChunkedDataset:
    """The out-of-core twin of ``fit_stage_list``: pending fitted runners
    run as chunked epochs (the same flush rule: an estimator's epoch runs
    only the pending runners that make its missing inputs), and each
    estimator fit materializes ONLY its input columns (and
    ``__sample_weight__``), behind the TM607 gate of ``host_budget``."""
    from .fit import _fit_stage, _needed, _resolve

    pending: list = []
    for stage in stages:
        runner = _resolve(stage, fitted)
        if runner is None:
            if pending and any(f.name not in cds for f in stage.inputs):
                now = _needed(pending, stage, cds)
                cds = chunked_transform_epoch(cds, now, hbm_budget=hbm_budget,
                                              checkpoint=checkpoint,
                                              device=device, profile=profile)
                pending = [r for r in pending if all(r is not x for x in now)]
            need = {f.name for f in stage.inputs} | {"__sample_weight__"}
            names = [n for n in cds.names if n in need]
            _gate_fit_residency(cds, stage, names, host_budget)
            runner = _fit_stage(stage, cds.materialize(names), fitted,
                                device=device, profile=profile, on_fit=on_fit)
        pending.append(runner)
    if pending:
        cds = chunked_transform_epoch(cds, pending, hbm_budget=hbm_budget,
                                      checkpoint=checkpoint, device=device,
                                      profile=profile)
    return cds


def transform_dag_chunked(cds: ChunkedDataset, result_features, fitted,
                          device=None, checkpoint=None) -> ChunkedDataset:
    """Chunked scoring: every fitted runner of the DAG over ``cds``, chunk
    by chunk, in one epoch."""
    from .fit import _runners

    return chunked_transform_epoch(cds, _runners(result_features, fitted),
                                   checkpoint=checkpoint, device=device)
