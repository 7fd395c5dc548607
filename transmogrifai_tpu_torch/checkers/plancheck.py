"""Static cost analysis of the port's device programs (counterpart of
``transmogrifai_tpu/checkers/plancheck.py``).

The reference walks the jaxpr of each traced program.  The port has no
traced program: it runs the program itself on ``torch.device("meta")``
operands (shape arithmetic only, nothing allocated on any device) inside a
``TorchDispatchMode`` that sees every aten op, and the hand-written kernels
hand it a node each (``perf/kernels/trace.py``): they launch through ctypes,
below the dispatcher.  From that one trace it reports:

- **FLOPs** per aten op: ``mm``/``addmm``/``bmm``/``baddbmm`` exactly
  (2·m·n·k), solves and factorizations at their cubic counts, elementwise
  ops and reductions at one per element; a kernel node its module's
  ``bound_ops``;
- **bytes read/written**: each op's operand and result storage (a kernel
  node its ``bound_bytes``); views move nothing;
- **arithmetic intensity** per segment (the encode group and each wiring
  stage of a plan), TM604 below :data:`MEMORY_BOUND_INTENSITY`;
- **peak device memory** per bucket (TM601), sized as below;
- the **recompile-hazard map** (TM602), **float sorts** (TM605), and the
  mesh fields: a program traced under a mesh (``parallel/mesh.py``; a
  ``virtual_mesh`` needs no processes) hands the trace each collective it
  calls (``parallel/collectives.py`` runs nothing on meta operands), whose
  operand bytes are ``collective_bytes``; host constants copied in are its
  replicated bytes.  TM603 fires on collectives in a plan validated as
  single-host, TM608 on collective volume that grows with the rows, TM609
  on replicated operands over the per-host share; without a mesh all three
  are quiet, as the reference's are;
- the **host-DRAM residency** of a fitted DAG at a row count (TM607,
  :func:`estimate_host_residency`), the reference's zero-row replay.

Peak device memory, the number admission (TM601, the fleet's TM509) uses,
is sized at every bucket of the plan's ladder:

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

Admission reads only the memory estimate: the FLOP and byte tally rides
the same trace, and the per-stage segments and the hazard map are traced
only where a caller asks (:func:`check_plan_cost`), so ``register``'s path
pays nothing new.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..types import ColumnKind
from .diagnostics import Diagnostic, make_diagnostic


#: the CUDA caching allocator's block granularity, and the largest remainder
#: it leaves unsplit in a large cached block
_ROUND = 512
_LARGE_SLACK = 1 << 20

#: arithmetic-intensity threshold (FLOPs per byte) below which a segment is
#: reported memory-bound (TM604): the reference's value, kept so the two
#: packages make the same decisions
MEMORY_BOUND_INTENSITY = 2.0

#: the card the port targets, with the peak rates its ridge point comes from
#: (the H100 SXM's datasheet figures at its 700 W limit: HBM3 3.35 TB/s,
#: 67 TFLOP/s float32 without tensor cores)
CARD = "NVIDIA H100 80GB HBM3, 700 W"
CARD_BYTES_PER_S = 3.35e12
CARD_FLOPS_PER_S = 67e12
#: FLOPs per byte at which the card's two limits meet (20.0)
CARD_RIDGE_INTENSITY = CARD_FLOPS_PER_S / CARD_BYTES_PER_S

#: TM608 / TM609 thresholds (the reference's; quiet without a mesh)
ROWS_PROPORTIONAL_FRACTION = 0.5
REPLICATED_HBM_SHARE = 0.5


def block_bytes(nbytes: int) -> int:
    """The block the caching allocator hands out for ``nbytes`` when it
    splits a cached block: ``nbytes`` rounded up to 512 bytes."""
    return max(-(-int(nbytes) // _ROUND) * _ROUND, _ROUND)


def allocation_bound(nbytes: int) -> int:
    """The most device memory the caching allocator charges for one
    allocation of ``nbytes``."""
    return block_bytes(nbytes) + (_LARGE_SLACK if nbytes > _LARGE_SLACK else 0)


# ---------------------------------------------------------------------------
# the per-op cost model
# ---------------------------------------------------------------------------

#: ops that move or make data and compute nothing
_NO_FLOP_OPS = frozenset({
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "fill", "fill_", "zero_", "copy", "copy_", "clone",
    "_to_copy", "to", "cat", "stack", "index", "index_select", "gather",
    "scatter", "scatter_", "index_put", "index_put_", "masked_scatter",
    "arange", "constant_pad_nd", "repeat", "repeat_interleave", "lift_fresh",
    "lift_fresh_copy", "_local_scalar_dense", "resize_", "set_", "flip",
    "roll", "tril", "triu", "diag_embed", "embedding", "masked_select",
    "nonzero", "unique", "_unique2", "scalar_tensor", "where", "narrow_copy",
    "slice_scatter", "select_scatter", "diagonal_scatter", "as_strided_scatter",
    "_reshape_copy", "expand_copy", "permute_copy", "t_copy", "view_copy",
})
#: ops whose result holds no new data (and whose operands are not read)
_NO_TRAFFIC_OPS = frozenset({
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "lift_fresh", "_local_scalar_dense", "resize_", "set_",
})
_REDUCE_OPS = frozenset({
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax", "argmin",
    "any", "all", "norm", "linalg_vector_norm", "var", "std", "var_mean",
    "std_mean", "logsumexp", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "count_nonzero", "nansum", "_softmax", "_log_softmax",
    "softmax", "log_softmax", "bincount", "histc", "index_add", "index_add_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
})
_SORT_OPS = frozenset({"sort", "argsort", "topk", "msort", "kthvalue", "median",
                       "searchsorted", "bucketize"})
#: float accumulations whose result depends on the reduction's order
_ORDER_ACCUM_OPS = frozenset({"sum", "mm", "addmm", "bmm", "baddbmm", "cumsum",
                              "mean", "mv", "dot", "index_add", "scatter_add"})
#: float sorts: order/implementation-dependent for equal keys and NaNs
_ORDER_SORT_OPS = frozenset({"sort", "argsort", "topk", "msort"})


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def _matmul_flops(name: str, args) -> int:
    ts = _tensors(args)
    if name in ("mm", "addmm"):
        a, b = (ts[-2], ts[-1])
        return 2 * int(a.shape[0]) * int(a.shape[1]) * int(b.shape[1])
    if name in ("bmm", "baddbmm"):
        a, b = (ts[-2], ts[-1])
        return 2 * int(a.shape[0]) * int(a.shape[1]) * int(a.shape[2]) * int(b.shape[2])
    if name in ("mv", "addmv"):
        a = ts[-2]
        return 2 * int(a.shape[0]) * int(a.shape[1])
    if name in ("dot", "vdot"):
        return 2 * int(ts[0].numel())
    return 0


def _op_flops(name: str, args, outs: List[torch.Tensor]) -> int:
    """FLOPs of one aten op (the reference's per-primitive model)."""
    if name in ("mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot"):
        return _matmul_flops(name, args)
    ins = _tensors(args)
    in_elems = sum(int(t.numel()) for t in ins)
    out_elems = sum(int(t.numel()) for t in outs)
    if name in ("linalg_solve_ex", "_linalg_solve_ex", "linalg_solve",
                "linalg_lu_factor_ex", "linalg_lu", "lu_solve", "linalg_lu_solve",
                "linalg_inv_ex", "_linalg_det", "linalg_det"):
        a = ins[0]
        n = int(a.shape[-1])
        batch = int(a.numel()) // max(n * n, 1)
        rhs = (int(ins[1].numel()) // max(batch * n, 1)) if len(ins) > 1 else 0
        return int(((2 / 3) * n ** 3 + 2 * n * n * rhs) * max(batch, 1))
    if name in ("linalg_cholesky_ex", "cholesky", "linalg_cholesky"):
        n = int(ins[0].shape[-1])
        batch = int(ins[0].numel()) // max(n * n, 1)
        return int((1 / 3) * n ** 3 * max(batch, 1))
    if name in ("triangular_solve", "linalg_solve_triangular", "cholesky_solve"):
        n = int(ins[0].shape[-1])
        return n * int(ins[1].numel()) if len(ins) > 1 else n * n
    if name in _SORT_OPS:
        n = max(in_elems, 2)
        return int(n * math.log2(n))
    if name in _REDUCE_OPS:
        return in_elems
    if name in _NO_FLOP_OPS:
        return 0
    return out_elems


@dataclass
class _Tally:
    flops: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    op_counts: Dict[str, int] = field(default_factory=dict)
    order_accums: int = 0
    order_sorts: int = 0
    kernels: List[Any] = field(default_factory=list)
    collectives: Dict[str, int] = field(default_factory=dict)
    collective_bytes: int = 0
    replicated_bytes: int = 0


class _CostMode(TorchDispatchMode):
    """The trace: records the storage of every meta tensor the ops run
    inside it make (each storage once, so views count nothing) and keeps the
    tensors alive, so no storage is freed and its address reused within the
    trace; tensors made from host tensors are the stages' constants, counted
    apart.  Beside the storages it tallies each op's FLOPs and bytes, and
    takes the hand-written kernels' nodes (``perf/kernels/trace.py``)."""

    def __init__(self):
        super().__init__()
        self.storages: Dict[int, int] = {}
        self._alive: List[torch.Tensor] = []
        self.tally = _Tally()
        self._sink = None

    def __enter__(self):
        from ..perf.kernels import trace

        self._sink = trace.sink(self)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._sink.__exit__(*exc)

    def _hold(self, outs) -> None:
        for t in outs:
            if t.device.type == "meta":
                st = t.untyped_storage()
                self.storages.setdefault(st._cdata, st.nbytes())
                self._alive.append(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = _tensors((args, kwargs))
        if any(a.device.type == "cpu" for a in ins):
            # a host constant copied in: every rank of a mesh holds it whole
            self.tally.replicated_bytes += sum(
                _nbytes(t) for t in _tensors(out) if t.device.type == "meta")
            return out
        outs = _tensors(out)
        self._hold(outs)
        name = func.overloadpacket.__name__
        tally = self.tally
        tally.op_counts[name] = tally.op_counts.get(name, 0) + 1
        if getattr(func, "is_view", False) or name in _NO_TRAFFIC_OPS:
            return out
        tally.flops += _op_flops(name, (args, kwargs), outs)
        mutated = name.endswith("_")
        tally.bytes_read += sum(_nbytes(t) for t in (ins[1:] if mutated else ins))
        tally.bytes_written += sum(_nbytes(t) for t in outs)
        if any(t.is_floating_point() for t in ins):
            tally.order_accums += name in _ORDER_ACCUM_OPS
            tally.order_sorts += name in _ORDER_SORT_OPS
        return out

    def kernel(self, node, inputs, outputs) -> None:
        tally = self.tally
        written = sum(_nbytes(t) for t in outputs)
        tally.flops += node.flops
        tally.bytes_written += written
        tally.bytes_read += max(node.bytes - written, 0)
        key = f"kernel:{node.name}"
        tally.op_counts[key] = tally.op_counts.get(key, 0) + 1
        tally.kernels.append(node)

    def collective(self, op: str, nbytes: int) -> None:
        tally = self.tally
        tally.collectives[op] = tally.collectives.get(op, 0) + 1
        tally.collective_bytes += nbytes

    def transient_bytes(self) -> int:
        return sum(allocation_bound(n) for n in self.storages.values())

    def segment(self, name: str, extra_peak: int = 0) -> "SegmentCost":
        t = self.tally
        return SegmentCost(
            name=name, flops=t.flops, bytes_read=t.bytes_read,
            bytes_written=t.bytes_written,
            peak_live_bytes=extra_peak + self.transient_bytes(),
            op_counts=dict(t.op_counts), order_accums=t.order_accums,
            order_sorts=t.order_sorts,
            kernels=[k.to_dict() for k in t.kernels],
            collectives=dict(t.collectives), collective_bytes=t.collective_bytes,
            replicated_bytes=t.replicated_bytes)


# ---------------------------------------------------------------------------
# public dataclasses
# ---------------------------------------------------------------------------

@dataclass
class SegmentCost:
    """Static cost of one segment (a whole program or one stage)."""

    name: str
    flops: int
    bytes_read: int
    bytes_written: int
    peak_live_bytes: int = 0
    op_counts: Dict[str, int] = field(default_factory=dict)
    collectives: Dict[str, int] = field(default_factory=dict)
    #: operand bytes of the segment's collectives (0 without a mesh)
    collective_bytes: int = 0
    #: per-host replicated entry bytes (0 without a mesh)
    replicated_bytes: int = 0
    order_accums: int = 0
    order_sorts: int = 0
    notes: List[str] = field(default_factory=list)
    #: the hand-written kernels' nodes in the segment (``KernelNode.to_dict``)
    kernels: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def bytes_total(self) -> int:
        return self.bytes_read + self.bytes_written

    @property
    def intensity(self) -> float:
        """Arithmetic intensity: FLOPs per byte of modeled device traffic."""
        return self.flops / max(self.bytes_total, 1)

    @property
    def memory_bound(self) -> bool:
        return self.intensity < MEMORY_BOUND_INTENSITY

    @property
    def bound_ms(self) -> float:
        """The least time the card could take: bytes over its memory rate or
        FLOPs over its float32 rate, whichever is larger."""
        return max(self.bytes_total / CARD_BYTES_PER_S,
                   self.flops / CARD_FLOPS_PER_S) * 1e3

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "flops": self.flops,
            "bytesRead": self.bytes_read, "bytesWritten": self.bytes_written,
            "peakLiveBytes": self.peak_live_bytes,
            "intensity": round(self.intensity, 4),
            "memoryBound": self.memory_bound,
            "collectives": dict(self.collectives),
            "collectiveBytes": self.collective_bytes,
            "orderSensitiveOps": {"accumulations": self.order_accums,
                                  "sorts": self.order_sorts},
            "kernels": list(self.kernels),
            "notes": list(self.notes),
        }


@dataclass
class BucketCost:
    """The estimate at one row bucket of the ladder: device memory (bytes)
    and the batch's FLOPs and traffic."""

    bucket: int
    resident_bytes: int
    transient_bytes: int
    flops: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    collective_bytes: int = 0

    @property
    def peak_hbm_bytes(self) -> int:
        return self.resident_bytes + self.transient_bytes

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes_read + self.bytes_written, 1)

    @property
    def bound_ms(self) -> float:
        return max((self.bytes_read + self.bytes_written) / CARD_BYTES_PER_S,
                   self.flops / CARD_FLOPS_PER_S) * 1e3

    def to_dict(self) -> Dict[str, Any]:
        return {
            "bucket": self.bucket, "flops": self.flops,
            "bytesRead": self.bytes_read, "bytesWritten": self.bytes_written,
            "peakHbmBytes": self.peak_hbm_bytes,
            "residentBytes": self.resident_bytes,
            "transientBytes": self.transient_bytes,
            "collectiveBytes": self.collective_bytes,
            "intensity": round(self.intensity, 4),
        }


@dataclass
class RecompileHazard:
    """One input shape the row-bucket ladder cannot cover."""

    kind: str            # "data_dependent_width"
    detail: str
    stage_uid: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "detail": self.detail,
                "stageUid": self.stage_uid}


@dataclass
class PlanCostReport:
    """The static cost report of one plan or program."""

    plan: str
    buckets: List[BucketCost] = field(default_factory=list)
    #: the resident parts: staging over the ladder, constants, splits
    staging_bytes: int = 0
    constant_bytes: int = 0
    notes: List[str] = field(default_factory=list)
    segments: List[SegmentCost] = field(default_factory=list)
    hazards: List[RecompileHazard] = field(default_factory=list)
    collectives: Dict[str, int] = field(default_factory=dict)
    replicated_bytes: int = 0
    order_accums: int = 0
    order_sorts: int = 0
    #: the mesh the plan was traced under (None: one card)
    mesh: Optional[str] = None

    @property
    def total_flops(self) -> int:
        return self.buckets[-1].flops if self.buckets else 0

    @property
    def total_bytes(self) -> int:
        b = self.buckets[-1] if self.buckets else None
        return (b.bytes_read + b.bytes_written) if b else 0

    @property
    def peak_hbm_bytes(self) -> int:
        return max((b.peak_hbm_bytes for b in self.buckets), default=0)

    @property
    def collective_bytes_per_step(self) -> int:
        return self.buckets[-1].collective_bytes if self.buckets else 0

    def memory_bound_segments(self) -> List[SegmentCost]:
        return [s for s in self.segments if s.memory_bound and s.bytes_total]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "plan": self.plan,
            "totalFlops": self.total_flops,
            "totalBytes": self.total_bytes,
            "peakHbmBytes": self.peak_hbm_bytes,
            "stagingBytes": self.staging_bytes,
            "constantBytes": self.constant_bytes,
            "collectiveBytesPerStep": self.collective_bytes_per_step,
            "replicatedBytes": self.replicated_bytes,
            "buckets": [b.to_dict() for b in self.buckets],
            "segments": [s.to_dict() for s in self.segments],
            "recompileHazards": [h.to_dict() for h in self.hazards],
            "collectives": dict(self.collectives),
            "orderSensitiveOps": {"accumulations": self.order_accums,
                                  "sorts": self.order_sorts},
            "mesh": self.mesh,
            "memoryBoundIntensity": MEMORY_BOUND_INTENSITY,
            "card": {"name": CARD, "ridgeIntensity": CARD_RIDGE_INTENSITY},
            "notes": list(self.notes),
        }

    def pretty(self) -> str:
        lines = [f"PlanCostReport [{self.plan}]"]
        lines.append(f"  mesh: {self.mesh or 'no mesh (one card)'}")
        if self.buckets:
            lines.append("  bucket      FLOPs        bytes        peak HBM     AI")
            for b in self.buckets:
                lines.append(
                    f"  {b.bucket:<10d}  {b.flops:<11.3e}  "
                    f"{b.bytes_read + b.bytes_written:<11.3e}  "
                    f"{_fmt_bytes(b.peak_hbm_bytes):<11s}  "
                    f"{b.intensity:.3f}")
        lines.append(f"  memory-bound below {MEMORY_BOUND_INTENSITY:.1f} FLOPs/byte "
                     f"(the reference's threshold); the card's ridge point: "
                     f"{CARD_RIDGE_INTENSITY:.1f} FLOPs/byte ({CARD}: "
                     f"{CARD_FLOPS_PER_S / 1e12:.0f} TFLOP/s float32, "
                     f"{CARD_BYTES_PER_S / 1e12:.2f} TB/s)")
        if self.segments:
            lines.append(f"  segments @ bucket "
                         f"{self.buckets[-1].bucket if self.buckets else '?'}:")
            for s in self.segments:
                tag = "  [memory-bound]" if s.memory_bound else ""
                lines.append(
                    f"    {s.name}: flops={s.flops:.3e} "
                    f"bytes={s.bytes_total:.3e} AI={s.intensity:.3f}{tag}")
        if self.collectives:
            inv = ", ".join(f"{k} x{v}" for k, v in sorted(self.collectives.items()))
            lines.append(f"  collectives/resharding: {inv} "
                         f"({_fmt_bytes(self.collective_bytes_per_step)}/step)")
        else:
            lines.append("  collectives/resharding: none")
        if self.order_accums or self.order_sorts:
            lines.append(f"  order-sensitive ops: "
                         f"{self.order_accums} float accumulation(s), "
                         f"{self.order_sorts} float sort(s)")
        for h in self.hazards:
            lines.append(f"  recompile hazard [{h.kind}]: {h.detail}")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{b}B"
        b /= 1024
    return f"{b}B"


# ---------------------------------------------------------------------------
# tracing entry points (meta operands only: nothing allocated, nothing built)
# ---------------------------------------------------------------------------

def meta_spec(x) -> torch.Tensor:
    """A meta tensor of ``x``'s shape and dtype: ``x`` a tensor (any
    device) or a ``(shape, dtype)`` pair."""
    if isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    shape, dtype = x
    if not isinstance(dtype, torch.dtype):
        dtype = _torch_dtype(str(np.dtype(dtype)))
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def trace_cost(fn, *specs, name: str = "program") -> SegmentCost:
    """Run ``fn`` on meta operands of ``specs`` (tensors or ``(shape,
    dtype)`` pairs) and return its :class:`SegmentCost`.  Nothing
    is allocated on a device, built or launched; the peak is the operands
    plus every storage the run made, all held."""
    from ..ops._consts import const_store

    ops = [meta_spec(s) for s in specs]
    inputs = sum(allocation_bound(_nbytes(t)) for t in ops)
    with const_store({}), _CostMode() as mode:
        fn(*ops)
    return mode.segment(name, extra_peak=inputs)


def analyze_program(fn, specs_per_bucket, label: str = "program") -> PlanCostReport:
    """Static cost report of a program across a row-bucket ladder:
    ``specs_per_bucket`` is ``[(bucket, [specs...]), ...]`` (statics bound
    by ``functools.partial`` or a lambda before the call).  Under a mesh
    the report carries its token and, per bucket, the collectives' bytes;
    the replicated bytes are the largest bucket's host constants."""
    from ..parallel.mesh import current_mesh, mesh_token

    report = PlanCostReport(plan=label)
    meshed = current_mesh() is not None
    if meshed:
        report.mesh = repr(mesh_token())
    for bucket, specs in specs_per_bucket:
        seg = trace_cost(fn, *specs, name=f"bucket{bucket}")
        report.buckets.append(BucketCost(
            bucket=int(bucket), resident_bytes=0,
            transient_bytes=seg.peak_live_bytes, flops=seg.flops,
            bytes_read=seg.bytes_read, bytes_written=seg.bytes_written,
            collective_bytes=seg.collective_bytes))
        report.order_accums = max(report.order_accums, seg.order_accums)
        report.order_sorts = max(report.order_sorts, seg.order_sorts)
        for op, c in seg.collectives.items():
            report.collectives[op] = max(report.collectives.get(op, 0), c)
        if meshed:
            report.replicated_bytes = max(report.replicated_bytes,
                                          seg.replicated_bytes)
    return report


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name (no tensor is made)."""
    return getattr(torch, np.dtype(name).name)


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



def _trace_batch(plan, rows: int) -> _CostMode:
    """The trace of one batch of ``rows`` rows: its storages (the transient
    bytes), its tally and, as ``mode.constants``, the stages' constant
    bytes."""
    from ..ops._consts import const_store

    operands, blocks, _ = _meta_batch(plan, rows)
    with const_store({}) as consts, _CostMode() as mode:
        outs = plan._prefix_outputs(plan, operands, blocks, rows)
        for t in outs.values():      # a copy back needs a contiguous source
            t[:rows].contiguous()
    mode.constants = sum(allocation_bound(t.untyped_storage().nbytes())
                         for t in consts.values())
    return mode


def _segments(encode, wiring, env: Dict[str, torch.Tensor], unify: bool,
              encode_name: str) -> List[SegmentCost]:
    """Per-segment costs of one batch: the encode group's one call
    (``encode(env)``, which returns the wiring's operands), then each wiring
    stage alone, in order."""
    from ..ops._consts import const_store
    from ..workflow.plan import _unify_float_dtypes

    segments: List[SegmentCost] = []
    with const_store({}):
        with _CostMode() as mode:
            ops = encode(env)
        if mode.tally.op_counts:
            segments.append(mode.segment(encode_name))
        for runner, srcs, out_uid in wiring:
            args = [env[key] if tag == "env" else ops[key] for tag, key in srcs]
            if unify:
                args = _unify_float_dtypes(args)
            with _CostMode() as mode:
                env[out_uid] = runner.device_transform(*args)
            segments.append(mode.segment(f"{type(runner).__name__}({runner.uid})"))
    return segments


def _encode_name(plan) -> str:
    table = plan._encode_table
    return f"encode_slots({len(table)} slots)" if table is not None else "lowering"


def _scoring_segments(plan, rows: int) -> List[SegmentCost]:
    """The segments of one batch of a scoring plan at ``rows`` rows: the
    precision lowering with the encode group, then each wiring stage."""
    from ..serve.plan import Precision

    operands, blocks, _ = _meta_batch(plan, rows)

    def encode(env):
        ops, enc = plan._lowered(operands, blocks)
        plan._encode(enc, rows, env)
        return ops

    return _segments(encode, plan._wiring, {}, plan._precision != Precision.F32,
                     _encode_name(plan))


def analyze_scoring_plan(plan, buckets: Optional[Sequence[int]] = None,
                         segments: bool = False) -> PlanCostReport:
    """The static estimate of a :class:`~..serve.plan.CompiledScoringPlan`
    at each of ``buckets`` (default: its whole ladder): device memory
    (``peak_hbm_bytes`` is the largest; the number admission compares), and
    each batch's FLOPs and bytes.  ``segments`` adds the per-stage segments
    at the largest bucket."""
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
        mode = _trace_batch(plan, b)
        report.constant_bytes = mode.constants + splits
        t = mode.tally
        report.buckets.append(BucketCost(
            bucket=b, resident_bytes=report.staging_bytes + mode.constants + splits,
            transient_bytes=mode.transient_bytes(), flops=t.flops,
            bytes_read=t.bytes_read, bytes_written=t.bytes_written))
        report.order_accums = max(report.order_accums, t.order_accums)
        report.order_sorts = max(report.order_sorts, t.order_sorts)
    if segments and report.buckets:
        report.segments = _scoring_segments(plan, report.buckets[-1].bucket)
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


def analyze_transform_plan(plan, dataset, rows: Optional[int] = None,
                           segments: bool = False) -> PlanCostReport:
    """The static estimate of a training
    :class:`~..workflow.plan.ColumnarTransformPlan` over ``dataset`` at
    ``rows`` rows (default the dataset's: a whole-table flush; a chunked
    epoch passes its chunk tile).  One bucket: resident = the staging of the
    entries, the stages' constants and the packed splits; transient = the
    encode buffer, the wiring stages and the copies back, all held; and the
    run's FLOPs and bytes.  ``segments`` adds the per-stage segments."""
    from ..ops._consts import const_store

    rows = int(dataset.n_rows if rows is None else rows)
    report = PlanCostReport(plan=f"transform/{len(plan._prefix)}stages/{rows}rows")
    if not plan._prefix:
        report.notes.append("empty device prefix: every stage runs on host")
        return report
    specs = transform_entry_specs(plan, dataset)
    operands, _, staged = _meta_batch(plan, rows, specs)
    with const_store({}) as consts, _CostMode() as mode:
        env: Dict[str, torch.Tensor] = {}
        plan._encode(operands, rows, env)
        plan._run_wiring(operands, env)
        for uid in plan._out_uids:   # a copy back needs a contiguous source
            env[uid].contiguous()
    constants = sum(allocation_bound(t.untyped_storage().nbytes())
                    for t in consts.values())
    table = plan._encode_table
    splits = allocation_bound(table.splits.nbytes) if table is not None \
        and table.splits.size else 0
    report.staging_bytes = staged
    report.constant_bytes = constants + splits
    t = mode.tally
    report.buckets.append(BucketCost(bucket=rows,
                                     resident_bytes=staged + constants + splits,
                                     transient_bytes=mode.transient_bytes(),
                                     flops=t.flops, bytes_read=t.bytes_read,
                                     bytes_written=t.bytes_written))
    report.order_accums, report.order_sorts = t.order_accums, t.order_sorts
    if segments:
        ops2, _, _ = _meta_batch(plan, rows, specs)

        def encode(env):
            plan._encode(ops2, rows, env)
            return ops2

        report.segments = _segments(encode, plan._wiring, {}, False, _encode_name(plan))
    return report


def _width_hazards(runners) -> List[RecompileHazard]:
    """Data-dependent-width recompile hazards among ``runners``: a raw
    OPVector feature feeding a device-capable stage — the row-bucket ladder
    amortizes rows only, so every new width makes a fresh set of buffers
    and launch shapes.  (One rule for the fitted scoring plan and the
    unfitted workflow, so the two reports cannot drift.)"""
    from ..features.generator import FeatureGeneratorStage
    from ..workflow.plan import device_slots

    hazards: List[RecompileHazard] = []
    seen: set = set()
    for runner in runners:
        if not callable(getattr(runner, "device_transform", None)):
            continue
        for slot in device_slots(runner):
            if slot >= len(runner.inputs):
                continue
            f = runner.inputs[slot]
            if isinstance(f.origin_stage, FeatureGeneratorStage) \
                    and f.ftype.kind is ColumnKind.VECTOR \
                    and f.uid not in seen:
                seen.add(f.uid)
                hazards.append(RecompileHazard(
                    kind="data_dependent_width",
                    detail=f"raw feature {f.name!r} is an OPVector whose "
                           f"width is only known from the data; the row "
                           f"bucket ladder cannot cover it — every new "
                           f"width compiles a fresh executable",
                    stage_uid=runner.uid))
    return hazards


def scoring_hazards(plan) -> List[RecompileHazard]:
    """Recompile-hazard map of a scoring plan: raw feature shapes the bucket
    ladder cannot amortize (widths only known from the data)."""
    return _width_hazards(list(plan._prefix) + list(plan._remainder))


def analyze_transform(dataset, result_features, fitted) -> Optional[PlanCostReport]:
    """Cost report of the transform plan ``transform_dag`` would run over
    ``dataset`` (None when a stage is unfitted), built on the meta device."""
    from ..workflow.plan import plan_for_features

    plan = plan_for_features(dataset, result_features, fitted, device="meta")
    if plan is None:
        return None
    return analyze_transform_plan(plan, dataset, segments=True)


def scalability_diagnostics(report: PlanCostReport,
                            hbm_budget: Optional[float] = None) -> List[Diagnostic]:
    """TM608/TM609, the reference's static scalability pass.  Mesh-scoped:
    quiet for a plan traced without a mesh."""
    diags: List[Diagnostic] = []
    if report.mesh is None:
        return diags
    if len(report.buckets) >= 2:
        ladder = sorted(report.buckets, key=lambda b: b.bucket)
        lo, hi = ladder[0], ladder[-1]
        if hi.bucket > lo.bucket and hi.collective_bytes > 0:
            rows_ratio = hi.bucket / lo.bucket
            vol_ratio = hi.collective_bytes / max(lo.collective_bytes, 1)
            if vol_ratio >= ROWS_PROPORTIONAL_FRACTION * rows_ratio:
                diags.append(make_diagnostic(
                    "TM608",
                    f"plan {report.plan}: per-step collective volume grows "
                    f"with global rows ({_fmt_bytes(lo.collective_bytes)} at "
                    f"bucket {lo.bucket} -> {_fmt_bytes(hi.collective_bytes)} "
                    f"at bucket {hi.bucket})"))
    if hbm_budget is not None and report.replicated_bytes > \
            REPLICATED_HBM_SHARE * hbm_budget:
        diags.append(make_diagnostic(
            "TM609",
            f"plan {report.plan}: {_fmt_bytes(report.replicated_bytes)} of "
            f"per-host replicated operands exceed "
            f"{REPLICATED_HBM_SHARE:.0%} of the {_fmt_bytes(int(hbm_budget))} "
            f"per-host budget"))
    return diags


# ---------------------------------------------------------------------------
# TM6xx diagnostics
# ---------------------------------------------------------------------------

def cost_diagnostics(report: PlanCostReport,
                     hbm_budget: Optional[float] = None,
                     single_host: bool = False,
                     intensity_threshold: float = MEMORY_BOUND_INTENSITY
                     ) -> List[Diagnostic]:
    """Map a :class:`PlanCostReport` to TM601-TM605 (and the mesh-scoped
    TM608/TM609) diagnostics.  TM601 when the peak estimate at some bucket
    (a scoring plan's row bucket, a training plan's rows) exceeds
    ``hbm_budget``."""
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
    for h in report.hazards:
        diags.append(make_diagnostic("TM602", f"plan {report.plan}: {h.detail}",
                                     stage_uid=h.stage_uid))
    if report.collectives and single_host:
        inv = ", ".join(f"{k} x{v}" for k, v in sorted(report.collectives.items()))
        diags.append(make_diagnostic(
            "TM603",
            f"plan {report.plan} contains cross-device collective ops ({inv}) "
            f"but was validated as single-host"))
    slow = [s for s in report.segments
            if s.bytes_total and s.intensity < intensity_threshold]
    if slow:
        names = ", ".join(f"{s.name} (AI={s.intensity:.2f})" for s in slow)
        diags.append(make_diagnostic(
            "TM604",
            f"plan {report.plan}: {len(slow)} memory-bound segment(s) below "
            f"{intensity_threshold:.1f} FLOPs/byte (the card's ridge point is "
            f"{CARD_RIDGE_INTENSITY:.1f}: {CARD}) — fused-kernel candidates: "
            f"{names}"))
    diags.extend(scalability_diagnostics(report, hbm_budget=hbm_budget))
    sorts, accums = report.order_sorts, report.order_accums
    if sorts or (accums and report.mesh is not None):
        what = []
        if sorts:
            what.append(f"{sorts} float sort(s)")
        if accums and report.mesh is not None:
            what.append(f"{accums} float accumulation(s) under mesh {report.mesh}")
        diags.append(make_diagnostic(
            "TM605",
            f"plan {report.plan}: {', '.join(what)} — results depend on "
            f"reduction order/layout; bitwise parity across backends is not "
            f"guaranteed"))
    return diags


class _ModelShim:
    """Minimal (result_features, fitted) carrier for CompiledScoringPlan."""

    def __init__(self, result_features, fitted):
        self.result_features = list(result_features)
        self.fitted = dict(fitted)


def check_plan_cost(result_features, fitted=None,
                    hbm_budget: Optional[float] = None,
                    single_host: bool = False,
                    intensity_threshold: float = MEMORY_BOUND_INTENSITY,
                    min_bucket: int = 8, max_bucket: int = 1024
                    ) -> Tuple[Optional[PlanCostReport], List[Diagnostic]]:
    """TM6xx entry point of ``validate(cost=True, ...)`` and ``cli lint
    --cost``.  With a complete ``fitted`` mapping the scoring plan is
    partitioned as serving would build it, on the meta device, and traced
    at every bucket of its ladder.  Without one (an untrained Workflow) only
    the recompile-hazard map is computable; an armed budget then fails
    closed (TM606)."""
    from ..stages.base import Estimator
    from ..workflow.dag import all_stages

    stages = all_stages(result_features)
    unfitted = [s for s in stages if isinstance(s, Estimator)
                and (fitted is None or s.uid not in fitted)]
    if unfitted:
        report = PlanCostReport(plan="unfitted-workflow",
                                hazards=_width_hazards(stages))
        report.notes.append(
            f"{len(unfitted)} unfitted estimator(s): the device prefix's cost "
            "is a property of the fitted stages — train (or pass a fitted "
            "model) for FLOPs/bytes/HBM analysis")
        diags = cost_diagnostics(report, hbm_budget=None, single_host=False,
                                 intensity_threshold=intensity_threshold)
        if hbm_budget is not None or single_host:
            what = [w for w, on in (("hbm_budget", hbm_budget is not None),
                                    ("single_host", single_host)) if on]
            diags.append(make_diagnostic(
                "TM606",
                f"{'/'.join(what)} contract requested but the plan cost "
                f"cannot be computed: {len(unfitted)} unfitted "
                f"estimator(s) in the DAG "
                f"({', '.join(s.uid for s in unfitted[:3])}"
                f"{', ...' if len(unfitted) > 3 else ''})"))
        return report, diags

    from ..serve.plan import CompiledScoringPlan

    plan = CompiledScoringPlan(_ModelShim(result_features, fitted or {}),
                               min_bucket=min_bucket, max_bucket=max_bucket,
                               strict=False, device="meta")
    report = analyze_scoring_plan(plan, segments=True)
    report.hazards = scoring_hazards(plan)
    return report, cost_diagnostics(report, hbm_budget=hbm_budget,
                                    single_host=single_host,
                                    intensity_threshold=intensity_threshold)


# ---------------------------------------------------------------------------
# TM607: static host-DRAM residency estimate
# ---------------------------------------------------------------------------

@dataclass
class HostResidencyReport:
    """Static host-DRAM residency estimate of one fitted plan at a row count.

    Two modes are modeled: the IN-MEMORY path materializes the whole table
    (raw + every produced column) at once; the CHUNKED out-of-core path
    (data/chunked.py + workflow/ooc.py) holds only the prefetch-depth chunk
    tiles, the resident (non-spillable) output columns, and — transiently,
    one estimator at a time — that estimator's input columns.  The TM607
    gate compares the CHUNKED peak against the budget: it is the smallest
    working set any ingestion mode can achieve, so exceeding it cannot be
    fixed by spilling harder.
    """

    n_rows: int
    chunk_rows: int
    table_bytes: int = 0              #: full materialized table (in-memory mode)
    chunk_buffer_bytes: int = 0       #: prefetch-depth chunk tiles
    resident_bytes: int = 0           #: non-spillable outputs (predictions)
    fit_sets: List[Dict[str, Any]] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    @property
    def max_fit_set_bytes(self) -> int:
        return max((int(f["bytes"]) for f in self.fit_sets), default=0)

    @property
    def peak_in_memory_bytes(self) -> int:
        return self.table_bytes

    @property
    def peak_chunked_bytes(self) -> int:
        return (self.chunk_buffer_bytes + self.resident_bytes
                + self.max_fit_set_bytes)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "nRows": self.n_rows, "chunkRows": self.chunk_rows,
            "tableBytes": self.table_bytes,
            "chunkBufferBytes": self.chunk_buffer_bytes,
            "residentBytes": self.resident_bytes,
            "peakInMemoryBytes": self.peak_in_memory_bytes,
            "peakChunkedBytes": self.peak_chunked_bytes,
            "fitSets": list(self.fit_sets),
            "notes": list(self.notes),
        }

    def pretty(self) -> str:
        lines = [f"HostResidencyReport @ {self.n_rows} rows "
                 f"(chunks of {self.chunk_rows})",
                 f"  in-memory table: {_fmt_bytes(self.table_bytes)}",
                 f"  chunked peak:    {_fmt_bytes(self.peak_chunked_bytes)} "
                 f"(buffers {_fmt_bytes(self.chunk_buffer_bytes)} + "
                 f"resident {_fmt_bytes(self.resident_bytes)} + "
                 f"largest fit set {_fmt_bytes(self.max_fit_set_bytes)})"]
        for f in self.fit_sets:
            lines.append(f"    fit {f['stageUid']}: "
                         f"{_fmt_bytes(int(f['bytes']))} "
                         f"({', '.join(f['columns'])})")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)


def _col_row_bytes(col) -> int:
    """Per-row host bytes of a (zero-row template) column."""
    data = col.data
    if data.dtype == object:
        per = 64  # object refs + smallish payloads: a rough floor
    else:
        per = data.dtype.itemsize * int(np.prod(data.shape[1:])) \
            if data.ndim > 1 else data.dtype.itemsize
    return per + (1 if col.mask is not None or col.is_numeric else 0)


def estimate_host_residency(result_features, fitted,
                            n_rows: int,
                            chunk_rows: Optional[int] = None,
                            schema_dataset=None) -> HostResidencyReport:
    """Zero-row replay of the fitted DAG → per-column row bytes → the
    :class:`HostResidencyReport` at ``n_rows``.  Touches no data and
    launches nothing: every fitted runner transforms a ZERO-ROW dataset on
    the host (metadata/width are functions of fitted state only, the same
    principle the fused planner's metadata replay rests on).

    ``schema_dataset`` supplies raw-column widths/dtypes when available (a
    real or chunked dataset); without one the raw schema derives from the
    feature generators' declared types (raw OPVector widths then unknown —
    noted, counted at zero).
    """
    from ..data.chunked import DEFAULT_CHUNK_ROWS
    from ..data.dataset import Column, Dataset
    from ..readers.prefetch import prefetch_depth
    from ..workflow.dag import compute_dag
    from ..workflow.fit import _resolve
    from ..workflow.workflow import dedup_raw_features

    chunk_rows = int(chunk_rows or DEFAULT_CHUNK_ROWS)
    report = HostResidencyReport(n_rows=int(n_rows), chunk_rows=chunk_rows)

    empty = np.zeros(0, dtype=np.intp)
    cols: Dict[str, Any] = {}
    if schema_dataset is not None:
        for name in schema_dataset.names:
            cols[name] = schema_dataset[name].take(empty)
    else:
        for f in dedup_raw_features(result_features):
            gen = f.origin_stage
            cols[f.name] = Column.from_values(gen.ftype, [])
            if gen.ftype.kind is ColumnKind.VECTOR:
                report.notes.append(
                    f"raw vector column {f.name!r}: width unknown without a "
                    f"schema dataset — counted at zero bytes")
    ds0 = Dataset(cols)

    from ..stages.base import Estimator

    per_row: Dict[str, int] = {n: _col_row_bytes(c) for n, c in cols.items()}
    resident_per_row = 0
    stages = [s for layer in compute_dag(result_features) for s in layer]
    for stage in stages:
        runner = _resolve(stage, dict(fitted))
        if runner is None:
            raise ValueError(
                f"stage {stage.uid} is unfitted: the residency estimate "
                "needs the fitted widths")
        # the estimator's fit-time working set: its input columns (plus the
        # sample-weight column when the schema carries one) at n_rows
        if isinstance(stage, Estimator):
            names = [f.name for f in stage.inputs if f.name in per_row]
            if "__sample_weight__" in per_row:
                names.append("__sample_weight__")
            report.fit_sets.append({
                "stageUid": stage.uid,
                "columns": names,
                "bytes": int(n_rows) * sum(per_row[n] for n in names)})
        ds0 = runner.transform(ds0)
        out = ds0[runner.output_name]
        per_row[runner.output_name] = _col_row_bytes(out)
        if type(out) is not Column:
            # non-spillable output (PredictionColumn): resident in chunked
            # mode too
            resident_per_row += _col_row_bytes(out)

    row_total = sum(per_row.values())
    report.table_bytes = int(n_rows) * row_total
    # ingest buffers: the prefetch queue's staged chunks + the one being
    # consumed + the output tile being spilled — all at full-table row width
    report.chunk_buffer_bytes = (prefetch_depth() + 2) * chunk_rows * row_total
    report.resident_bytes = int(n_rows) * resident_per_row
    return report


def host_residency_diagnostics(report: HostResidencyReport,
                               host_budget: Optional[float]
                               ) -> List[Diagnostic]:
    """TM607 when even the chunked out-of-core working set exceeds the
    armed budget (the in-memory overage alone is only a note: spilling —
    ``train(host_budget=)`` / ``maybe_chunk`` — resolves it)."""
    diags: List[Diagnostic] = []
    if host_budget is None:
        return diags
    if report.peak_chunked_bytes > host_budget:
        worst = max(report.fit_sets, key=lambda f: f["bytes"], default=None)
        detail = ""
        if worst is not None and worst["bytes"] == report.max_fit_set_bytes \
                and worst["bytes"] > 0:
            detail = (f"; largest fit set: stage {worst['stageUid']} "
                      f"({', '.join(worst['columns'])} = "
                      f"{_fmt_bytes(int(worst['bytes']))})")
        diags.append(make_diagnostic(
            "TM607",
            f"host-DRAM residency estimate "
            f"{_fmt_bytes(report.peak_chunked_bytes)} at {report.n_rows} "
            f"rows exceeds the armed host budget "
            f"{_fmt_bytes(int(host_budget))} even in chunked out-of-core "
            f"mode{detail}"))
    elif report.peak_in_memory_bytes > host_budget:
        report.notes.append(
            f"in-memory table ({_fmt_bytes(report.peak_in_memory_bytes)}) "
            f"exceeds the budget but the chunked out-of-core path fits "
            f"({_fmt_bytes(report.peak_chunked_bytes)}) — "
            f"train(host_budget=)/TMOG_HOST_BUDGET spills automatically")
    return diags


def check_host_residency(result_features, fitted=None,
                         host_budget: Optional[float] = None,
                         n_rows: Optional[int] = None,
                         chunk_rows: Optional[int] = None,
                         schema_dataset=None
                         ) -> Tuple[Optional[HostResidencyReport],
                                    List[Diagnostic]]:
    """TM607 entry point for ``validate(host_budget=...)`` and
    ``cli lint --cost --host-budget``.  Fails CLOSED (TM606) when the armed
    contract cannot be evaluated: unfitted estimators (no widths) or a
    missing row count (residency is linear in rows — without one there is
    nothing to compare)."""
    if host_budget is None:
        return None, []
    if not n_rows:
        return None, [make_diagnostic(
            "TM606",
            "host_budget contract requested but no row count provided "
            "(pass rows=/--rows: the residency estimate is linear in rows "
            "and a gate evaluated at zero rows would admit anything)")]
    try:
        report = estimate_host_residency(result_features, fitted or {},
                                         n_rows=n_rows,
                                         chunk_rows=chunk_rows,
                                         schema_dataset=schema_dataset)
    except Exception as e:  # noqa: BLE001 — fail closed, never silently green
        return None, [make_diagnostic(
            "TM606",
            f"host_budget contract requested but the residency estimate "
            f"could not be computed ({type(e).__name__}: {e})")]
    return report, host_residency_diagnostics(report, host_budget)
