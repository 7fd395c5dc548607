"""Static device-memory estimates of scoring and training transform plans
(the part of ``transmogrifai_tpu/checkers/plancheck.py`` that admission
needs: TM601 and the fleet's TM509).

The reference takes its number from XLA's live-buffer analysis of the traced
program.  The port has no traced program, so it sizes the prefix itself,
with shape arithmetic on ``torch.device("meta")`` tensors (nothing is
allocated on any device), at every bucket of the plan's ladder:

- **resident** — what a warm plan keeps on the card: the staging buffers of
  every bucket of its ladder (``warm()`` builds them all), its stages'
  device constants and the encode slot table's packed splits;
- **transient** — the prefix of one batch at the bucket run over meta
  operands (the precision lowering, the encode buffer, every wiring stage
  with its temporaries, the copies back), each storage counted once and
  all of them held to the end of the batch — more than the card keeps
  alive at once, never less.

A training plan (``workflow/plan.py::ColumnarTransformPlan``) is sized the
same way at one row count — the whole table for a flush, the chunk tile for
a chunked epoch (:func:`analyze_transform_plan`): the staging of its
entries (the packed 1-D block per dtype and every vector block), the encode
buffer, every wiring stage with its temporaries and the copies back, all
held together, plus its stages' constants and the packed splits.

Each allocation is rounded as the CUDA caching allocator rounds its blocks
(512 bytes), and one above 1 MiB gets 1 MiB more: a cached block that size
is handed out whole when the rest would be smaller than that.  The bytes
are therefore the port's own and do not equal the reference's; the two
packages are compared on the decisions the estimates drive.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .diagnostics import Diagnostic, make_diagnostic

#: the CUDA caching allocator's block granularity, and the largest remainder
#: it leaves unsplit in a large cached block
_ROUND = 512
_LARGE_SLACK = 1 << 20


def block_bytes(nbytes: int) -> int:
    """The block the caching allocator hands out for ``nbytes`` when it
    splits a cached block: ``nbytes`` rounded up to 512 bytes."""
    return max(-(-int(nbytes) // _ROUND) * _ROUND, _ROUND)


def allocation_bound(nbytes: int) -> int:
    """The most device memory the caching allocator charges for one
    allocation of ``nbytes``."""
    return block_bytes(nbytes) + (_LARGE_SLACK if nbytes > _LARGE_SLACK else 0)


@dataclass
class BucketCost:
    """The estimate at one row bucket of the ladder (bytes)."""

    bucket: int
    resident_bytes: int
    transient_bytes: int

    @property
    def peak_hbm_bytes(self) -> int:
        return self.resident_bytes + self.transient_bytes


@dataclass
class PlanCostReport:
    """The static device-memory report of one scoring plan."""

    plan: str
    buckets: List[BucketCost] = field(default_factory=list)
    #: the resident parts: staging over the ladder, constants, splits
    staging_bytes: int = 0
    constant_bytes: int = 0
    notes: List[str] = field(default_factory=list)

    @property
    def peak_hbm_bytes(self) -> int:
        return max((b.peak_hbm_bytes for b in self.buckets), default=0)


class _Allocations(TorchDispatchMode):
    """Records the storage of every meta tensor the ops run inside it make
    (each storage once, so views count nothing) and keeps the tensors alive,
    so no storage is freed and its address reused within the trace; tensors
    made from host tensors are the stages' constants, counted apart."""

    def __init__(self):
        super().__init__()
        self.storages: Dict[int, int] = {}
        self._alive: List[torch.Tensor] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in tree_leaves((args, kwargs))):
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "meta":
                st = t.untyped_storage()
                self.storages.setdefault(st._cdata, st.nbytes())
                self._alive.append(t)
        return out


def _torch_dtype(name: str) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


def _meta_batch(plan, rows: int, specs=None):
    """Meta operands of one batch of ``rows`` rows (``specs``: the entries'
    (trailing shape, dtype), default ``plan.entry_specs``), packed as
    :class:`~..workflow.plan.Staging` packs them, an entry with a trailing
    shape (a vector block) in a buffer of its own: (operands, blocks,
    staging bytes)."""
    specs = plan.entry_specs if specs is None else specs
    groups: Dict[str, List[int]] = {}
    operands: List[Optional[torch.Tensor]] = [None] * len(specs)
    staged = 0
    for i, (trailing, dtype) in enumerate(specs):
        if trailing:
            operands[i] = torch.empty((rows, *trailing), dtype=_torch_dtype(dtype),
                                      device="meta")
            staged += allocation_bound(operands[i].untyped_storage().nbytes())
        else:
            groups.setdefault(dtype, []).append(i)
    blocks = []
    for dtype, idx in groups.items():
        dev = torch.empty((len(idx), rows), dtype=_torch_dtype(dtype), device="meta")
        staged += allocation_bound(dev.untyped_storage().nbytes())
        blocks.append((idx, dev))
        for r, i in enumerate(idx):
            operands[i] = dev[r]
    return operands, blocks, staged


def _trace_batch(plan, rows: int):
    """(transient bytes, constant bytes) of one batch of ``rows`` rows."""
    from ..ops._consts import const_store

    operands, blocks, _ = _meta_batch(plan, rows)
    with const_store({}) as consts, _Allocations() as allocs:
        outs = plan._prefix_outputs(plan, operands, blocks, rows)
        for t in outs.values():      # a copy back needs a contiguous source
            t[:rows].contiguous()
    transient = sum(allocation_bound(n) for n in allocs.storages.values())
    constants = sum(allocation_bound(t.untyped_storage().nbytes())
                    for t in consts.values())
    return transient, constants


def analyze_scoring_plan(plan, buckets: Optional[Sequence[int]] = None
                         ) -> PlanCostReport:
    """The static device-memory estimate of a
    :class:`~..serve.plan.CompiledScoringPlan` at each of ``buckets``
    (default: its whole ladder); ``peak_hbm_bytes`` is the largest."""
    ladder = plan.bucket_ladder()
    report = PlanCostReport(plan=f"scoring/{len(plan.device_stage_uids)}stages/"
                                 f"{plan.fingerprint[:12]}")
    if not plan.device_stage_uids:
        report.notes.append("empty device prefix: every stage runs on host")
        return report
    report.staging_bytes = sum(_meta_batch(plan, b)[2] for b in ladder)
    table = plan._encode_table
    splits = allocation_bound(table.splits.nbytes) if table is not None \
        and table.splits.size else 0
    for b in (ladder if buckets is None else buckets):
        transient, constants = _trace_batch(plan, b)
        report.constant_bytes = constants + splits
        report.buckets.append(BucketCost(
            bucket=b, resident_bytes=report.staging_bytes + constants + splits,
            transient_bytes=transient))
    return report


def transform_entry_specs(plan, dataset) -> List[tuple]:
    """(trailing shape, dtype name) of each entry of a
    :class:`~..workflow.plan.ColumnarTransformPlan` over ``dataset`` (a
    ``Dataset`` or ``ChunkedDataset``), from the columns' kinds and widths:
    nothing is lifted or encoded."""
    from ..types import ColumnKind

    specs = []
    for key in plan._entry_keys:
        if key[0] == "lift":
            col = dataset[plan._entry_lifts[key].name]
            trailing = ((int(col.width),) if col.kind is ColumnKind.VECTOR
                        else (3,) if col.kind is ColumnKind.GEO else ())
            specs.append((trailing, "float32"))
        else:
            runner, slot, _f = plan._entry_encoders[key]
            trailing, dtype = runner.device_input_spec(slot)
            specs.append((tuple(trailing), str(np.dtype(dtype))))
    return specs


def analyze_transform_plan(plan, dataset, rows: Optional[int] = None
                           ) -> PlanCostReport:
    """The static device-memory estimate of a training
    :class:`~..workflow.plan.ColumnarTransformPlan` over ``dataset`` at
    ``rows`` rows (default the dataset's: a whole-table flush; a chunked
    epoch passes its chunk tile).  One bucket: resident = the staging of the
    entries, the stages' constants and the packed splits; transient = the
    encode buffer, the wiring stages and the copies back, all held."""
    from ..ops._consts import const_store

    rows = int(dataset.n_rows if rows is None else rows)
    report = PlanCostReport(plan=f"transform/{len(plan._prefix)}stages/{rows}rows")
    if not plan._prefix:
        report.notes.append("empty device prefix: every stage runs on host")
        return report
    specs = transform_entry_specs(plan, dataset)
    operands, _, staged = _meta_batch(plan, rows, specs)
    with const_store({}) as consts, _Allocations() as allocs:
        env: Dict[str, torch.Tensor] = {}
        plan._encode(operands, rows, env)
        plan._run_wiring(operands, env)
        for uid in plan._out_uids:   # a copy back needs a contiguous source
            env[uid].contiguous()
    transient = sum(allocation_bound(n) for n in allocs.storages.values())
    constants = sum(allocation_bound(t.untyped_storage().nbytes())
                    for t in consts.values())
    table = plan._encode_table
    splits = allocation_bound(table.splits.nbytes) if table is not None \
        and table.splits.size else 0
    report.staging_bytes = staged
    report.constant_bytes = constants + splits
    report.buckets.append(BucketCost(bucket=rows,
                                     resident_bytes=staged + constants + splits,
                                     transient_bytes=transient))
    return report


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{b}B"
        b /= 1024
    return f"{b}B"


def cost_diagnostics(report: PlanCostReport,
                     hbm_budget: Optional[float] = None) -> List[Diagnostic]:
    """TM601 when the peak estimate at some bucket (a scoring plan's row
    bucket, a training plan's rows) exceeds ``hbm_budget``."""
    diags: List[Diagnostic] = []
    if hbm_budget is not None and report.buckets:
        worst = max(report.buckets, key=lambda b: b.peak_hbm_bytes)
        if worst.peak_hbm_bytes > hbm_budget:
            diags.append(make_diagnostic(
                "TM601",
                f"plan {report.plan}: peak live-buffer HBM estimate "
                f"{_fmt_bytes(worst.peak_hbm_bytes)} at bucket "
                f"{worst.bucket} exceeds the device budget "
                f"{_fmt_bytes(int(hbm_budget))}"))
    return diags
