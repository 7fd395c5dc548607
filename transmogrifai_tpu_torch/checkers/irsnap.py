"""irsnap — the golden corpus of the port's op graphs and their semantic
differ (TM7xx; counterpart of ``transmogrifai_tpu/checkers/irsnap.py``).

Reference: the JAX package lowers each program family to StableHLO,
canonicalizes it, fingerprints it and diffs it against a checked-in corpus,
so a jax bump or an innocent-looking kernel edit that changes what a program
computes fails a gate with every Python-level test still green.  The port
has no lowered program.  It captures instead the **aten-op graph** of a run
of each family on ``torch.device("meta")`` operands — a ``TorchDispatchMode``
sees every aten op, and the hand-written kernels, which launch through
ctypes below the dispatcher, add a node each (``perf/kernels/trace.py``).
Nothing is allocated on a device, built or launched.

**Canonical form.**  One line per op: its name with overload
(``aten.mm.default``, or ``kernel.hist_level`` for a hand-written kernel with
its default launch plan and the host decisions it took), its arguments —
earlier results by SSA name, renumbered in order (``%v0``, ...), the
program's operands as ``%a0``, ..., scalars by value — and the shapes and
dtypes of its operands and results.  Device arguments are dropped (a graph
captured with CUDA operands reads as one captured on meta).  Constant
payloads (tensors made from host memory, the stages' constants) are
content-hashed.  Allocations (``aten.empty``) appear only where their buffer
is read by a later op, so a kernel's private scratch buffer is not part of
the graph.

**The differ** classifies a delta between a golden and a current snapshot:

- **TM700** info — corpus membership drift (a family added or removed);
- **TM701** info — benign text drift (every semantic feature equal);
- **TM702** warning — the op histogram shifted (ops added, removed, fused);
- **TM703** warning — collectives added or removed (none without a mesh);
- **TM704** error — the dtype inventory changed (widening/narrowing);
- **TM705** error — the reference's sharded-sort miscompile class.  It
  needs the reference's sharded corpus families (a sort whose operand is
  sharded), which are not ported yet: the corpus captures programs without
  a mesh, so TM703 and TM705 report nothing until those families land.

**Families.**  The scoring prefix (f32, bf16, int8), the training transform
prefix, the chunk tile (its fingerprint equals the transform prefix's:
chunking must not fork the program), the workflow-CV fold prefix, the linear
sweep programs, the tree growth, and one family per hand-written kernel.
The IRLS sweep and the tree growth make host decisions inside their loops
on real data (convergence, depth), so their families snapshot one iteration
of the loop (``oneIteration`` in the index).

Entry points: ``cli lint --ir`` (compare), ``cli lint --ir
--update-goldens`` (re-golden; the index records the torch version and the
platform), and ``tools/torch_ir_gate.py``.  Goldens live in
``tests/goldens/torch_ir/``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import platform as _platform
import re
import sys
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .diagnostics import Diagnostic, make_diagnostic

log = logging.getLogger(__name__)

#: corpus file-format version (bump on incompatible index/layout changes)
CORPUS_VERSION = 1

#: op namespaces of cross-device collectives (the TM703 inventory)
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                          "_dtensor")

#: kwargs that name where a tensor lives, not what the program computes
_PLACEMENT_KWARGS = frozenset({"device", "pin_memory", "non_blocking"})

#: allocation ops: a buffer with no data, shown only where it is read
_ALLOC_OPS = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                        "new_empty_strided"})

_DTYPE_SHORT = {
    "float32": "f32", "float64": "f64", "float16": "f16", "bfloat16": "bf16",
    "int8": "i8", "int16": "i16", "int32": "i32", "int64": "i64",
    "uint8": "u8", "bool": "b1", "complex64": "c64", "complex128": "c128",
}


def _dt(dtype) -> str:
    name = str(dtype).replace("torch.", "")
    return _DTYPE_SHORT.get(name, name)


def _ty(t) -> str:
    return f"{_dt(t.dtype)}[{','.join(str(int(s)) for s in t.shape)}]"


def _hash_payload(arr: np.ndarray) -> str:
    h = hashlib.blake2b(np.ascontiguousarray(arr).tobytes(), digest_size=6).hexdigest()
    return f"#blake2b:{h}"


def ir_fingerprint(canonical_text: str) -> str:
    return hashlib.blake2b(canonical_text.encode(), digest_size=16).hexdigest()


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

def _graph_mode_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
    from torch.utils._pytree import tree_leaves

    class _GraphMode(TorchDispatchMode):
        """Writes the canonical line of every aten op (and, as the kernels'
        trace sink, of every kernel node) run inside it."""

        def __init__(self):
            super().__init__()
            self.lines: List[str] = []
            self._names: Dict[int, str] = {}
            self._pending: Dict[int, Tuple[str, str]] = {}
            self._alive: List[Any] = []
            self._n = 0
            self._args = 0

        # -- value naming ---------------------------------------------------
        def _new(self, t) -> str:
            name = f"%v{self._n}"
            self._n += 1
            self._names[id(t)] = name
            self._alive.append(t)
            return name

        def _use(self, t) -> str:
            key = id(t)
            name = self._names.get(key)
            if name is not None:
                return name
            pending = self._pending.pop(key, None)
            if pending is not None:
                op, payload = pending
                name = self._new(t)
                self.lines.append(f"{name} = {op}{payload} : -> {_ty(t)}")
                return name
            name = f"%a{self._args}"
            self._args += 1
            self._names[key] = name
            self._alive.append(t)
            return name

        def _fmt(self, x) -> str:
            if isinstance(x, torch.Tensor):
                return self._use(x)
            if isinstance(x, (list, tuple)):
                return "[" + ", ".join(self._fmt(v) for v in x) + "]"
            if isinstance(x, torch.dtype):
                return _dt(x)
            if isinstance(x, float):
                return repr(x)
            if isinstance(x, (bool, int, str)) or x is None:
                return repr(x)
            if isinstance(x, torch.memory_format):
                return str(x).replace("torch.", "")
            if isinstance(x, torch.layout):
                return str(x).replace("torch.", "")
            return type(x).__name__

        # -- ops --------------------------------------------------------------
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            if ins and all(t.device.type == "cpu" for t in ins):
                # host work; a host tensor moved onto the device is a
                # constant, content-hashed (read with no mode active, so
                # the read itself is no op of any trace)
                moved = [t for t in outs if t.device.type != "cpu"]
                if moved:
                    with _disable_current_modes():
                        payload = "<" + ",".join(
                            f"{_hash_payload(t.detach().numpy())}/{_ty(t)}"
                            for t in ins) + ">"
                    for t in moved:
                        self._pending[id(t)] = ("const", payload)
                        self._alive.append(t)
                return out
            if not ins and not outs:
                # a host-side helper (``promote_types``): no device value
                return out
            if name in _ALLOC_OPS:
                for t in outs:
                    self._pending[id(t)] = ("alloc", "")
                    self._alive.append(t)
                return out
            arg_text = ", ".join(
                [self._fmt(a) for a in args]
                + [f"{k}={self._fmt(v)}" for k, v in sorted(kwargs.items())
                   if k not in _PLACEMENT_KWARGS])
            in_types = ", ".join(_ty(t) for t in ins)
            results = []
            for t in outs:
                results.append((self._new(t), _ty(t)))
            lhs = ", ".join(r[0] for r in results) or "_"
            rtypes = ", ".join(r[1] for r in results) or "scalar"
            self.lines.append(f"{lhs} = aten.{name}.{func._overloadname}({arg_text})"
                              f" : {in_types} -> {rtypes}")
            return out

        def kernel(self, node, inputs, outputs) -> None:
            arg_text = ", ".join(self._use(t) for t in inputs)
            in_types = ", ".join(_ty(t) for t in inputs)
            results = [(self._new(t), _ty(t)) for t in outputs]
            attrs = json.dumps({"plan": node.plan, "decisions": node.decisions},
                               sort_keys=True, default=str)
            self.lines.append(
                f"{', '.join(r[0] for r in results)} = kernel.{node.name}({arg_text}) "
                f"{attrs} : {in_types} -> {', '.join(r[1] for r in results)}")

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

        def finish(self, result) -> str:
            outs = [t for t in tree_leaves(result) if isinstance(t, torch.Tensor)]
            rets = ", ".join(self._use(t) for t in outs)
            return "\n".join(self.lines + [f"return {rets}"]) + "\n"

    return _GraphMode


def capture(fn, *operands) -> str:
    """The canonical op-graph text of ``fn(*operands)`` (meta operands for a
    static capture; the program runs on whatever device its operands are
    on), with a constant store of its own."""
    from ..ops._consts import const_store

    mode = _graph_mode_class()()
    with const_store({}):
        with mode:
            result = fn(*operands)
    return mode.finish(result)


# ---------------------------------------------------------------------------
# semantic features (pure text analysis: goldens reload from disk)
# ---------------------------------------------------------------------------

_LINE_RE = re.compile(r"^(?P<lhs>[^=]+) = (?P<op>[A-Za-z_][A-Za-z0-9_.]*)(?P<rest>.*)$")
_TYPE_RE = re.compile(r"\b([a-z]+[0-9]*)\[[0-9,]*\]")
_SORT_RE = re.compile(r"^(?P<lhs>[^=]+) = aten\.(?:sort|argsort|msort|topk)\.[A-Za-z_0-9]+"
                      r"\((?P<args>[^)]*)\)\s*:\s*(?P<t>[a-z0-9]+\[[0-9,]*\])")


def _op_histogram(text: str) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for line in text.splitlines():
        m = _LINE_RE.match(line)
        if m is None:
            continue
        op = m.group("op")
        counts[op] = counts.get(op, 0) + 1
    return counts


def _dtype_histogram(text: str) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for line in text.splitlines():
        sig = line.rsplit(" : ", 1)
        if len(sig) != 2:
            continue
        for m in _TYPE_RE.finditer(sig[1]):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def _collectives(op_counts: Dict[str, int]) -> Dict[str, int]:
    return {op: n for op, n in op_counts.items()
            if op.split(".")[0] in _COLLECTIVE_NAMESPACES}


@dataclass
class SortSignature:
    """One sort op in the graph, with its sharding context (the corpus
    captures programs without a mesh: ``sharded_sort_dim`` stays False until
    the sharded corpus families are ported)."""

    dimension: int
    rank: int
    shape: str
    sharding: Optional[str] = None
    sharded_sort_dim: bool = False

    def key(self) -> tuple:
        return (self.dimension, self.rank, self.shape, self.sharded_sort_dim)

    def to_dict(self) -> Dict[str, Any]:
        return {"dimension": self.dimension, "rank": self.rank,
                "shape": self.shape, "sharding": self.sharding,
                "shardedSortDim": self.sharded_sort_dim}


def _sort_signatures(text: str) -> List[SortSignature]:
    out: List[SortSignature] = []
    for line in text.splitlines():
        m = _SORT_RE.match(line)
        if m is None:
            continue
        t = m.group("t")
        dims = t[t.index("[") + 1:-1]
        rank = len([d for d in dims.split(",") if d])
        args = [a.strip() for a in m.group("args").split(",")]
        dim = -1
        if len(args) > 1 and re.fullmatch(r"-?\d+", args[1]):
            dim = int(args[1])
        out.append(SortSignature(dimension=dim % max(rank, 1), rank=rank, shape=t))
    return out


@dataclass
class IRSnapshot:
    """Canonical op graph of one program family and its semantic features.

    Every feature derives from ``text`` alone (``from_text``), so goldens
    reload from disk with full differ fidelity — and a reviewer can tamper a
    golden file to see which class fires."""

    key: str
    text: str
    ir_fingerprint: str
    op_counts: Dict[str, int] = field(default_factory=dict)
    dtype_counts: Dict[str, int] = field(default_factory=dict)
    collectives: Dict[str, int] = field(default_factory=dict)
    sorts: List[SortSignature] = field(default_factory=list)
    #: content fingerprint of the program (a plan's fingerprint, or the
    #: program's qualified name and operand specs); not part of the diff
    content_fingerprint: Optional[str] = None
    min_devices: int = 1
    #: True where the family snapshots one iteration of a loop whose trip
    #: count is a host decision on real data
    one_iteration: bool = False

    @classmethod
    def from_text(cls, key: str, text: str,
                  content_fingerprint: Optional[str] = None,
                  min_devices: int = 1, one_iteration: bool = False) -> "IRSnapshot":
        canonical = "\n".join(ln.rstrip() for ln in text.replace("\r\n", "\n")
                              .split("\n") if ln.strip()) + "\n"
        ops = _op_histogram(canonical)
        return cls(key=key, text=canonical,
                   ir_fingerprint=ir_fingerprint(canonical), op_counts=ops,
                   dtype_counts=_dtype_histogram(canonical),
                   collectives=_collectives(ops),
                   sorts=_sort_signatures(canonical),
                   content_fingerprint=content_fingerprint,
                   min_devices=min_devices, one_iteration=one_iteration)

    def sharded_sort_hazards(self) -> List[SortSignature]:
        return [s for s in self.sorts if s.sharded_sort_dim]

    def kernels(self) -> Dict[str, int]:
        """The hand-written kernels' nodes in the graph, by name."""
        return {op.split(".", 1)[1]: n for op, n in self.op_counts.items()
                if op.startswith("kernel.")}

    def to_index_entry(self) -> Dict[str, Any]:
        return {"irFingerprint": self.ir_fingerprint,
                "contentFingerprint": self.content_fingerprint,
                "minDevices": self.min_devices,
                "oneIteration": self.one_iteration,
                "kernels": self.kernels(),
                "sorts": [s.to_dict() for s in self.sorts],
                "collectives": dict(self.collectives)}


def snapshot_program(key: str, fn, specs: Sequence[Any], device: str = "meta",
                     statics: Optional[Dict[str, Any]] = None,
                     one_iteration: bool = False) -> IRSnapshot:
    """Run ``fn(*operands, **statics)`` over operands of ``specs``
    (``(shape, dtype)`` pairs) made on ``device`` (meta: nothing allocated)
    and snapshot its op graph.  The content fingerprint names the program
    and its operand specs."""
    statics = dict(statics or {})
    operands = [_operand(s, device) for s in specs]
    text = capture(partial(fn, **statics) if statics else fn, *operands)
    content = hashlib.sha256(json.dumps(
        [f"{fn.__module__}.{fn.__qualname__}",
         [[list(s), str(d)] for s, d in specs],
         sorted((k, repr(v)) for k, v in statics.items())]).encode()).hexdigest()
    return IRSnapshot.from_text(key, text, content_fingerprint=content,
                                one_iteration=one_iteration)


def _torch_dtype(dtype):
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(np.dtype(dtype)) if str(dtype) != "bool" else "bool")


def _operand(spec, device: str):
    """A program operand of ``spec`` on ``device``: a meta tensor, or zeros
    (integer operands: zeros too, every index in range)."""
    import torch

    shape, dtype = spec
    dt = _torch_dtype(dtype)
    if device == "meta":
        return torch.empty(tuple(shape), dtype=dt, device="meta")
    return torch.zeros(tuple(shape), dtype=dt, device=device)


def _batch(plan, rows: int, device: str, specs=None):
    """A batch of ``rows`` rows packed as the plan stages it (operands,
    blocks), on ``device``."""
    import torch

    from .plancheck import _meta_batch

    operands, blocks, _ = _meta_batch(plan, rows, specs)
    if device == "meta":
        return operands, blocks
    real_blocks = []
    moved: Dict[int, Any] = {}
    for idx, blk in blocks:
        dev_blk = torch.zeros(tuple(blk.shape), dtype=blk.dtype, device=device)
        real_blocks.append((idx, dev_blk))
        for r, i in enumerate(idx):
            moved[i] = dev_blk[r]
    ops = [moved[i] if i in moved else
           torch.zeros(tuple(t.shape), dtype=t.dtype, device=device)
           for i, t in enumerate(operands)]
    return ops, real_blocks


def snapshot_scoring_plan(plan, bucket: Optional[int] = None,
                          key: str = "serve.plan.scoring_prefix",
                          device: str = "meta") -> IRSnapshot:
    """Snapshot the device prefix of a
    :class:`~..serve.plan.CompiledScoringPlan` at one bucket (default its
    largest): the precision lowering, the encode group's one launch, every
    wiring stage and the copies back, as a batch runs them."""
    bucket = plan.max_bucket if bucket is None else int(bucket)
    operands, blocks = _batch(plan, bucket, device)

    def prefix(*_):
        outs = plan._prefix_outputs(plan, operands, blocks, bucket)
        return [t[:bucket].contiguous() for _, t in sorted(outs.items())]

    return IRSnapshot.from_text(key, capture(prefix),
                                content_fingerprint=plan.fingerprint)


def snapshot_transform_plan(plan, dataset=None, rows: int = 64,
                            key: str = "workflow.plan.transform_prefix",
                            device: str = "meta") -> IRSnapshot:
    """Snapshot the device prefix of a training
    :class:`~..workflow.plan.ColumnarTransformPlan` at ``rows`` rows (a
    flush, or a chunked epoch's tile): the encode group and every wiring
    stage, as ``apply_prefix`` runs them.  ``dataset`` is needed only when
    a lifted entry is an OPVector column (its width)."""
    from .plancheck import transform_entry_specs

    specs = transform_entry_specs(plan, dataset) if dataset is not None \
        else _lift_specs(plan)
    operands, _ = _batch(plan, rows, device, specs)

    def prefix(*_):
        env: Dict[str, Any] = {}
        plan._encode(operands, rows, env)
        plan._run_wiring(operands, env)
        return [env[u].contiguous() for u in plan._out_uids]

    return IRSnapshot.from_text(key, capture(prefix),
                                content_fingerprint=plan.prefix_fingerprint())


def _lift_specs(plan) -> List[tuple]:
    """Entry specs of a plan whose lifted entries are all scalar columns."""
    out = []
    for k in plan._entry_keys:
        if k[0] == "lift":
            out.append(((), "float32"))
        else:
            runner, slot, _f = plan._entry_encoders[k]
            trailing, dtype = runner.device_input_spec(slot)
            out.append((tuple(trailing), str(np.dtype(dtype))))
    return out


# ---------------------------------------------------------------------------
# the semantic differ (TM700-TM705)
# ---------------------------------------------------------------------------

def diff_snapshots(old: Optional[IRSnapshot], new: Optional[IRSnapshot],
                   key: Optional[str] = None) -> List[Diagnostic]:
    """Classify the delta between a golden and a current snapshot.

    Exactly one snapshot may be None (corpus membership drift, TM700).  For
    a changed graph the most severe applicable class wins per dimension:
    dtype drift (TM704) and a new sharded-sort hazard (TM705) are errors;
    collective drift (TM703) and op-histogram drift (TM702) are warnings; a
    text change with every semantic feature equal is TM701 info.  Equal
    fingerprints yield no diagnostics."""
    key = key or (new.key if new is not None else old.key)

    def _d(code: str, message: str) -> Diagnostic:
        return make_diagnostic(code, message, location=key)

    def _tm705(s: SortSignature) -> Diagnostic:
        return _d("TM705",
                  f"IR of {key!r}: sort over {s.shape} has its sort dimension "
                  f"{s.dimension} SHARDED ({s.sharding}) while batch dimensions "
                  f"stay replicated — the sharded-sort miscompile pattern")
    if old is None and new is None:
        return []
    if old is None:
        return [_d("TM700", f"IR corpus: new program family {key!r} has no golden "
                            f"snapshot yet — record it with "
                            f"`cli lint --ir --update-goldens`")] \
            + [_tm705(s) for s in new.sharded_sort_hazards()]
    if new is None:
        return [_d("TM700", f"IR corpus: golden program family {key!r} is no "
                            f"longer emitted (or was skipped in this environment) "
                            f"— refresh the corpus if intentional")]
    if old.ir_fingerprint == new.ir_fingerprint:
        return []

    diags: List[Diagnostic] = []
    old_hazards = {s.key() for s in old.sharded_sort_hazards()}
    diags.extend(_tm705(s) for s in new.sharded_sort_hazards()
                 if s.key() not in old_hazards)

    old_dt, new_dt = old.dtype_counts, new.dtype_counts
    if set(old_dt) != set(new_dt):
        appeared = sorted(set(new_dt) - set(old_dt))
        vanished = sorted(set(old_dt) - set(new_dt))
        what = []
        if appeared:
            what.append(f"appeared: {', '.join(appeared)}")
        if vanished:
            what.append(f"vanished: {', '.join(vanished)}")
        diags.append(_d("TM704",
                        f"IR of {key!r}: element-type inventory changed "
                        f"({'; '.join(what)}) — numeric semantics (precision, "
                        f"accumulation grade) may have silently shifted"))
    else:
        floats = [d for d in old_dt if d.startswith(("f", "bf"))]
        shifted = [d for d in floats if old_dt[d] != new_dt[d]]
        if len(shifted) >= 2:
            moves = ", ".join(f"{d}: {old_dt[d]} -> {new_dt[d]}" for d in sorted(shifted))
            diags.append(_d("TM704",
                            f"IR of {key!r}: tensor counts migrated between float "
                            f"widths ({moves}) — a widening/narrowing drift"))

    if old.collectives != new.collectives:
        def inv(c):
            return ", ".join(f"{k} x{v}" for k, v in sorted(c.items())) or "none"
        diags.append(_d("TM703",
                        f"IR of {key!r}: collective inventory changed "
                        f"({inv(old.collectives)} -> {inv(new.collectives)})"))

    if old.op_counts != new.op_counts:
        deltas = [f"{op}: {old.op_counts.get(op, 0)} -> {new.op_counts.get(op, 0)}"
                  for op in sorted(set(old.op_counts) | set(new.op_counts))
                  if old.op_counts.get(op, 0) != new.op_counts.get(op, 0)]
        shown = "; ".join(deltas[:6]) + (
            f"; ... {len(deltas) - 6} more" if len(deltas) > 6 else "")
        diags.append(_d("TM702",
                        f"IR of {key!r}: op histogram changed ({shown}) — "
                        f"the program's structure drifted; verify perf and "
                        f"parity expectations still hold"))

    if not diags:
        diags.append(_d("TM701",
                        f"IR of {key!r}: canonical text drifted "
                        f"({old.ir_fingerprint[:12]} -> {new.ir_fingerprint[:12]}) "
                        f"with identical op/dtype/collective/sort signatures — "
                        f"benign; refresh the corpus at leisure"))
    return diags


def diff_corpus(goldens: Dict[str, IRSnapshot], current: Dict[str, IRSnapshot],
                skipped: Sequence[str] = ()) -> List[Diagnostic]:
    """Diff a whole corpus; ``skipped`` keys are exempt from TM700."""
    diags: List[Diagnostic] = []
    for key in sorted(set(goldens) | set(current)):
        if key in skipped and key not in current:
            continue
        diags.extend(diff_snapshots(goldens.get(key), current.get(key), key=key))
    return diags


# ---------------------------------------------------------------------------
# program-family registry
# ---------------------------------------------------------------------------

@dataclass
class CorpusEntry:
    """One program family: a builder returning its snapshot on ``device``."""

    key: str
    build: Callable[[str], IRSnapshot]
    min_devices: int = 1


class CorpusUnavailable(RuntimeError):
    """Raised by a family builder this environment cannot capture;
    build_corpus records the family as skipped."""


#: the corpus shapes: the structure is what it pins, rows only scale dims
_N, _D, _K, _G = 64, 4, 2, 2


def _binary_metric():
    from ..evaluators import metrics as M

    return M.METRICS_BINARY["auPR"]


def _sweep_entries() -> List[CorpusEntry]:
    """The linear sweep programs and the tree growth on small shapes."""
    n, d, k, g = _N, _D, _K, _G
    f32, i32, i8 = "float32", "int32", "int8"

    def irls(device):
        from ..models.logistic import _irls_sweep

        # one IRLS step: a fit's trip count is its own, a host decision
        return snapshot_program(
            "models.logistic.irls_sweep", _irls_sweep,
            [((n, d + 1), f32), ((n,), f32), ((k, n), f32), ((g,), f32)], device,
            statics=dict(max_iter=1, has_intercept=True), one_iteration=True)

    def fista(device):
        from ..models.logistic import _fista_sweep

        return snapshot_program(
            "models.logistic.fista_sweep", _fista_sweep,
            [((n, d + 1), f32), ((n,), f32), ((k, n), f32), ((g,), f32), ((g,), f32)],
            device, statics=dict(max_iter=3, has_intercept=True))

    def ridge(device):
        from ..models.linear import _ridge_sweep

        return snapshot_program(
            "models.linear.ridge_sweep", _ridge_sweep,
            [((n, d + 1), f32), ((n,), f32), ((k, n), f32), ((g,), f32)], device,
            statics=dict(has_intercept=True))

    def svc(device):
        from ..models.svm import _svc_cv_program

        return snapshot_program(
            "models.svm.svc_cv_program", _svc_cv_program,
            [((n, d), f32), ((n,), f32), ((n,), f32), ((k, n), f32), ((k, n), f32),
             ((g,), f32)], device,
            statics=dict(max_iter=3, has_intercept=True, metric_fn=_binary_metric()))

    def eval_linear(device):
        from ..models.base import eval_linear_sweep

        return snapshot_program(
            "models.base.eval_linear_sweep", eval_linear_sweep,
            [((n, d + 1), f32), ((n,), f32), ((g, k, d + 1), f32), ((k, n), f32)],
            device, statics=dict(metric_fn=_binary_metric(), link="sigmoid"))

    def eval_softmax(device):
        from ..evaluators import metrics as M
        from ..models.base import eval_softmax_sweep

        c = 3
        return snapshot_program(
            "models.base.eval_softmax_sweep", eval_softmax_sweep,
            [((n, d + 1), f32), ((n,), f32), ((g, k, d + 1, c), f32), ((k, n), f32)],
            device, statics=dict(metric_fn=M.multiclass_error))

    def grow(int_exact: bool):
        def build(device):
            from ..models.trees import _grow_trees

            L, n_bins = 2, 8

            def level(binned, grad, hess, feat_mask):
                return _grow_trees(binned, grad, hess, feat_mask, (7,), 1, n_bins,
                                   1.0, 0.0, 0.0, 1.0, 1.0, 0.0,
                                   int_exact=int_exact)

            # one level: the growth's depth loop stops on data (empty or
            # gainless nodes), so the family pins one iteration of it
            return snapshot_program(
                f"models.trees.grow_level@{'int8' if int_exact else 'f32'}", level,
                [((n, d), i32), ((L, n, 1), f32), ((L, n, 1), f32), ((L, d), f32)],
                device, one_iteration=True)
        return build

    return [
        CorpusEntry("models.logistic.irls_sweep", irls),
        CorpusEntry("models.logistic.fista_sweep", fista),
        CorpusEntry("models.linear.ridge_sweep", ridge),
        CorpusEntry("models.svm.svc_cv_program", svc),
        CorpusEntry("models.base.eval_linear_sweep", eval_linear),
        CorpusEntry("models.base.eval_softmax_sweep", eval_softmax),
        CorpusEntry("models.trees.grow_level@int8", grow(True)),
        CorpusEntry("models.trees.grow_level@f32", grow(False)),
    ]


def _plan_fixture_runners():
    """A fitted runner DAG from hand-set state (no training, no data, no
    RNG): two Real features through a NumericVectorizerModel with fixed
    fills, a Binary feature through a BinaryVectorizer, a PickList through a
    OneHotVectorizerModel (the encode kernel's one-hot slots), all into a
    VectorsCombiner."""
    from ..features.builder import FeatureBuilder
    from ..ops.combiner import VectorsCombiner
    from ..ops.numeric import BinaryVectorizer, NumericVectorizerModel
    from ..ops.onehot import OneHotVectorizerModel
    from ..serve.plan import resolve_scoring_stages

    x1 = FeatureBuilder.Real("x1").extract_field().as_predictor()
    x2 = FeatureBuilder.Real("x2").extract_field().as_predictor()
    b1 = FeatureBuilder.Binary("b1").extract_field().as_predictor()
    p1 = FeatureBuilder.PickList("p1").extract_field().as_predictor()
    vec = x1.transform_with(
        NumericVectorizerModel(fills=np.array([0.5, -1.25]), track_nulls=True), x2)
    bvec = b1.transform_with(BinaryVectorizer())
    pvec = p1.transform_with(OneHotVectorizerModel(vocabs=[["a", "b", "c"]]))
    out = vec.transform_with(VectorsCombiner(), bvec, pvec)
    return [out], resolve_scoring_stages([out], {})


class _Shim:
    """Minimal (result_features, fitted) carrier for CompiledScoringPlan."""

    def __init__(self, result_features, fitted):
        self.result_features = list(result_features)
        self.fitted = dict(fitted)


_FIXTURE_COLUMNS = frozenset({"x1", "x2", "b1", "p1"})


def _plan_entries() -> List[CorpusEntry]:
    rows = 64

    def transform_prefix(device):
        import torch

        from ..workflow.plan import ColumnarTransformPlan

        _features, runners = _plan_fixture_runners()
        plan = ColumnarTransformPlan(runners, _FIXTURE_COLUMNS, torch.device(device))
        return snapshot_transform_plan(plan, rows=rows, device=device)

    def transform_prefix_chunk(device):
        # the chunked epoch's program (workflow/ooc.py): one plan an epoch
        # over the chunk's column names, every chunk through the tile; the
        # corpus pins that it equals the in-memory family's graph
        import torch

        from ..workflow.plan import ColumnarTransformPlan

        _features, runners = _plan_fixture_runners()
        plan = ColumnarTransformPlan(runners, _FIXTURE_COLUMNS, torch.device(device))
        return snapshot_transform_plan(plan, rows=rows, device=device,
                                       key="workflow.plan.transform_prefix@chunk")

    def fold_prefix(device):
        # the workflow-CV fold transform: every fold's encode slots in one
        # joint table and launch, then each fold's wiring
        import torch

        from ..perf.kernels import encode as KE
        from ..workflow.plan import FoldTransformPlan

        folds = [_plan_fixture_runners()[1] for _ in range(2)]
        joint = FoldTransformPlan(folds, _FIXTURE_COLUMNS, torch.device(device))
        per_plan = [_batch(p, rows, device, _lift_specs(p))[0] for p in joint.plans]

        def prefix(*_):
            envs: List[Dict[str, Any]] = [{} for _ in joint.plans]
            if joint.table is not None:
                from ..workflow.plan import encode_buffer

                buf = encode_buffer(rows, joint.table.width, per_plan[0][0].device)
                KE.encode_slots([per_plan[f][i] for f, i in joint._inputs],
                                joint.table, buf)
                for f, p in enumerate(joint.plans):
                    off = joint._offsets[f]
                    for uid, col, w in p._encode_blocks:
                        envs[f][uid] = buf[:, off + col:off + col + w]
            outs = []
            for f, p in enumerate(joint.plans):
                p._run_wiring(per_plan[f], envs[f])
                outs.extend(envs[f][u].contiguous() for u in p._out_uids)
            return outs

        return IRSnapshot.from_text("workflow.plan.fold_prefix", capture(prefix),
                                    content_fingerprint=joint.plans[0].prefix_fingerprint())

    def scoring(precision: Optional[str], key: str):
        def build(device):
            from ..serve.plan import CompiledScoringPlan

            features, _runners = _plan_fixture_runners()
            plan = CompiledScoringPlan(_Shim(features, {}), min_bucket=8,
                                       max_bucket=rows, strict=False,
                                       precision=precision, device=device)
            return snapshot_scoring_plan(plan, bucket=rows, key=key, device=device)
        return build

    return [
        CorpusEntry("workflow.plan.transform_prefix", transform_prefix),
        CorpusEntry("workflow.plan.transform_prefix@chunk", transform_prefix_chunk),
        CorpusEntry("workflow.plan.fold_prefix", fold_prefix),
        CorpusEntry("serve.plan.scoring_prefix", scoring(None, "serve.plan.scoring_prefix")),
        CorpusEntry("serve.plan.scoring_prefix@bf16",
                    scoring("bf16", "serve.plan.scoring_prefix@bf16")),
        CorpusEntry("serve.plan.scoring_prefix@int8",
                    scoring("int8", "serve.plan.scoring_prefix@int8")),
    ]


def _kernel_entries() -> List[CorpusEntry]:
    """One family per hand-written kernel, each its wrapper alone."""
    L, n, d, nn, n_bins = 2, 256, _D, 2, 8
    B = n_bins + 1

    def encode(device):
        from ..perf.kernels import encode as KE

        table = KE.slot_table((KE.onehot_slot(7),
                               KE.bucketize_slot([0.0, 0.5, 1.0, 2.0, 4.0], True, False)))

        def program(codes, x):
            return KE.encode_slots([codes, x], table)

        return snapshot_program("perf.kernels.encode", program,
                                [((n,), "int32"), ((n,), "float32")], device)

    def hist(int_exact: bool):
        def build(device):
            from ..perf.kernels.histogram import hist_level

            def program(local, ghT, binned):
                return hist_level(local, ghT, binned, nn, n_bins, int_exact=int_exact)

            return snapshot_program(
                f"perf.kernels.hist@{'int8' if int_exact else 'f32'}", program,
                [((L, n), "int32"), ((L, 2, n), "int8" if int_exact else "float32"),
                 ((n, d), "int32")], device)
        return build

    def split(device):
        from ..perf.kernels.splitscan import split_scan

        def program(hg, hh, G, H, mask):
            return split_scan(hg, hh, G, H, mask, n_bins, 1.0, 0.0, 0.0, 1.0)

        return snapshot_program(
            "perf.kernels.split_scan", program,
            [((L, nn, 1, d, B), "float32"), ((L, nn, 1, d, B), "float32"),
             ((L, nn, 1), "float32"), ((L, nn, 1), "float32"), ((L, d), "float32")],
            device)

    def route(device):
        from ..perf.kernels.routing import row_select_lanes

        return snapshot_program("perf.kernels.route", row_select_lanes,
                                [((n, d), "int32"), ((L, n), "int32")], device)

    return [
        CorpusEntry("perf.kernels.encode", encode),
        CorpusEntry("perf.kernels.hist@int8", hist(True)),
        CorpusEntry("perf.kernels.hist@f32", hist(False)),
        CorpusEntry("perf.kernels.split_scan", split),
        CorpusEntry("perf.kernels.route", route),
    ]


def corpus_entries() -> List[CorpusEntry]:
    """Every builtin program family, in stable key order."""
    return _sweep_entries() + _plan_entries() + _kernel_entries()


def build_corpus(families: Optional[Sequence[str]] = None, device: str = "meta"
                 ) -> Tuple[Dict[str, IRSnapshot], List[str]]:
    """Snapshots of every (matching) family, captured with operands on
    ``device`` (default meta: nothing allocated, built or launched; a CUDA
    device runs the families on the card, kernels launched, to hold the
    meta graphs against what runs).  Returns ``(snapshots, skipped)``;
    ``families`` filters by substring of the key."""
    snaps: Dict[str, IRSnapshot] = {}
    skipped: List[str] = []
    for entry in corpus_entries():
        if families and not any(f in entry.key for f in families):
            skipped.append(entry.key)
            continue
        try:
            snap = entry.build(device)
        except CorpusUnavailable as e:
            log.info("irsnap: skipping %s (%s)", entry.key, e)
            skipped.append(entry.key)
            continue
        snap.min_devices = entry.min_devices
        snaps[snap.key] = snap
    return snaps, skipped


# ---------------------------------------------------------------------------
# golden-corpus persistence
# ---------------------------------------------------------------------------

def default_goldens_dir() -> str:
    """``tests/goldens/torch_ir`` of the checkout holding this package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "tests", "goldens", "torch_ir")


def _slug(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


def current_platform() -> str:
    """The platform a corpus is captured on (OS and machine; the capture
    device is recorded apart and does not change the graph)."""
    return f"{sys.platform}-{_platform.machine()}"


def save_corpus(snaps: Dict[str, IRSnapshot], goldens_dir: str,
                device: str = "meta") -> str:
    """Write the canonical graph files and the index (fingerprints, kernel
    nodes, the torch version and the platform).  Returns the index path."""
    import torch

    os.makedirs(goldens_dir, exist_ok=True)
    index = {"version": CORPUS_VERSION, "torchVersion": torch.__version__,
             "platform": current_platform(), "captureDevice": device,
             "entries": {}}
    for key in sorted(snaps):
        snap = snaps[key]
        fname = f"{_slug(key)}.aten.txt"
        with open(os.path.join(goldens_dir, fname), "w") as fh:
            fh.write(snap.text)
        index["entries"][key] = {"file": fname, **snap.to_index_entry()}
    keep = {f"{_slug(k)}.aten.txt" for k in snaps}
    for f in os.listdir(goldens_dir):
        if f.endswith(".aten.txt") and f not in keep:
            os.remove(os.path.join(goldens_dir, f))
    index_path = os.path.join(goldens_dir, "index.json")
    with open(index_path, "w") as fh:
        json.dump(index, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return index_path


def load_corpus(goldens_dir: str) -> Tuple[Dict[str, IRSnapshot], Dict]:
    """Reload a golden corpus: snapshots are re-derived from the text files,
    the index supplies provenance.  Raises FileNotFoundError when the
    corpus (or a file it names) is absent: a gate must not pass on a
    missing corpus."""
    with open(os.path.join(goldens_dir, "index.json")) as fh:
        index = json.load(fh)
    snaps: Dict[str, IRSnapshot] = {}
    for key, meta in index.get("entries", {}).items():
        with open(os.path.join(goldens_dir, meta["file"])) as fh:
            text = fh.read()
        snaps[key] = IRSnapshot.from_text(
            key, text, content_fingerprint=meta.get("contentFingerprint"),
            min_devices=int(meta.get("minDevices", 1)),
            one_iteration=bool(meta.get("oneIteration", False)))
    return snaps, index


@dataclass
class CorpusDiff:
    """Result of one corpus comparison (the ``irDiff`` JSONL payload)."""

    compared: int
    changed: List[str]
    skipped: List[str]
    diagnostics: List[Diagnostic]
    golden_torch_version: Optional[str] = None
    current_torch_version: Optional[str] = None
    golden_platform: Optional[str] = None
    current_platform: Optional[str] = None
    capture_device: str = "meta"

    def to_dict(self) -> Dict[str, Any]:
        return {"compared": self.compared, "changed": list(self.changed),
                "skipped": list(self.skipped),
                "counts": _count_by_code(self.diagnostics),
                "goldenTorchVersion": self.golden_torch_version,
                "currentTorchVersion": self.current_torch_version,
                "goldenPlatform": self.golden_platform,
                "currentPlatform": self.current_platform,
                "captureDevice": self.capture_device}


def _count_by_code(diags: Sequence[Diagnostic]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for d in diags:
        out[d.code] = out.get(d.code, 0) + 1
    return out


def check_ir_corpus(goldens_dir: Optional[str] = None,
                    families: Optional[Sequence[str]] = None,
                    device: str = "meta") -> Tuple[CorpusDiff, Dict[str, IRSnapshot]]:
    """Capture the current families (operands on ``device``) and diff them
    against the golden corpus; returns the structured diff and the fresh
    snapshots (for ``--update-goldens``)."""
    import torch

    goldens_dir = goldens_dir or default_goldens_dir()
    goldens, index = load_corpus(goldens_dir)   # refuse a missing corpus first
    current, skipped = build_corpus(families=families, device=device)
    if families:
        goldens = {k: v for k, v in goldens.items() if any(f in k for f in families)}
    diags = diff_corpus(goldens, current, skipped=skipped)
    changed = sorted(k for k in set(goldens) & set(current)
                     if goldens[k].ir_fingerprint != current[k].ir_fingerprint)
    diff = CorpusDiff(compared=len(set(goldens) & set(current)), changed=changed,
                      skipped=sorted(set(skipped)), diagnostics=diags,
                      golden_torch_version=index.get("torchVersion"),
                      current_torch_version=torch.__version__,
                      golden_platform=index.get("platform"),
                      current_platform=current_platform(),
                      capture_device=str(device))
    if diff.golden_platform and diff.golden_platform != diff.current_platform:
        diff.diagnostics.append(make_diagnostic(
            "TM700",
            f"IR corpus was goldened on platform {diff.golden_platform!r} but "
            f"this run captures on {diff.current_platform!r} — drift below may "
            f"be the platform, not a torch upgrade"))
    return diff, current
