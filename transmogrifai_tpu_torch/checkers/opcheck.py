"""opcheck — static DAG validator and device-hazard lint, no data touched
(counterpart of ``transmogrifai_tpu/checkers/opcheck.py``).

Reference: TransmogrifAI's compile-time type safety (SURVEY §1): the Scala
feature DAG rejects invalid compositions at compile time via FeatureLike type
parameters and OpWorkflow.scala:265-323 validation.  The JAX package
re-creates that guarantee as a pre-execution static-analysis pass producing
typed :class:`~.diagnostics.Diagnostic` findings (stable ``TM1xx``-``TM4xx``
codes); this module is its port, so a dtype mismatch, a cycle, or a leaking
label surfaces *before* a job of many minutes starts on the card, not as an
opaque error deep inside fit().

Analyzer families:

1. **structural** — cycle detection with the offending path (TM101), duplicate
   stage uids (TM102), orphaned/rewired stage outputs (TM103), duplicate raw
   column names (TM104), >1 ModelSelector (TM105), registry/serde
   round-trip-ability of every stage (TM106).  Host logic, copied.
2. **type & shape inference** — declared ``FeatureType`` propagation edge by
   edge (TM201-TM203) and a run of each stage's device half on
   ``torch.device("meta")`` operands (TM204): shape arithmetic only, no
   buffer is allocated on any device and no kernel is launched or built (a
   hand-written kernel's wrapper returns its outputs' shapes on meta
   operands, ``perf/kernels/trace.py``).  ``torch.cat`` and broadcasting
   accept what ``lax.concatenate`` refuses, so TM204 fires on an exception
   under the meta run **and** when the meta output's dtype or shape differs
   from what the stage's declared output type needs (float32 — the port
   lifts every numeric column as float32 with NaN where missing — rank 1 or
   2, the batch's rows).  The reference's second form of this check, the stacked-fold
   trace of ``device_transform_stateful``, is not ported: the port has no
   ``device_transform_stateful`` (its fold transforms run one plan per fold
   in one launch, ``workflow/plan.py::FoldTransformPlan``).
3. **device-hazard AST lint** — walks ``transform_columns``/``fit_columns``/
   ``device_transform`` implementations for the torch counterparts of the
   reference's JAX hazards: host syncs on a device tensor (TM301:
   ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``/
   ``int()``/``bool()`` of a tensor expression, ``np.asarray`` of one,
   ``torch.cuda.synchronize`` and ``Event``/``Stream.synchronize``), Python
   row loops (TM302), and compiling inside a hot path (TM303/TM304:
   ``torch.compile``, ``torch.jit.script``, ``torch.jit.trace`` called or
   used as a decorator).  Device values are the results of ``torch.*``
   calls and the names bound to them; ``shape``, ``ndim``, ``dtype``,
   ``device`` and ``numel`` are host metadata.
4. **leakage** — label-derived features reaching the model's feature input
   (TM401) and a replay of ``cut_dag``'s reasoning to advise when
   label-dependent estimators fit outside the CV folds (TM402).  Copied.

Entry points: :func:`validate_result_features` (used by
``Workflow.validate()`` and the ``train(strict=True)`` gate), and the AST-lint
API (:func:`lint_file`, :func:`lint_stage_class`) shared by the
``python -m transmogrifai_tpu_torch.cli lint`` subcommand and the
self-hosted style gate in tests/test_torch_style_validation.py.  Inline
``# opcheck: allow(TMxxx) <reason>`` markers keep the reference's grammar.
"""

from __future__ import annotations

import ast
import inspect
import re
import textwrap
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..types import ColumnKind
from .diagnostics import Diagnostic, DiagnosticReport, Severity, make_diagnostic

#: function names whose bodies are device/columnar hot paths worth linting
HAZARD_FUNCTION_NAMES = frozenset(
    {"transform_columns", "fit_columns", "device_transform"})

#: names that produce device values when used as a call root (``torch.sum(x)``)
_DEVICE_ROOTS = frozenset({"torch"})

#: ``torch.*`` calls whose result is not a device tensor (host objects,
#: settings, CPU wrappers of numpy memory): never a device root
_HOST_TORCH_CALLS = (
    "torch.device", "torch.dtype", "torch.iinfo", "torch.finfo", "torch.Size",
    "torch.is_tensor", "torch.is_floating_point", "torch.cuda.", "torch.version",
    "torch.backends", "torch.get_default_dtype", "torch.get_num_threads",
    "torch.set_num_threads", "torch.utils", "torch.library", "torch.no_grad",
    "torch.inference_mode", "torch.manual_seed", "torch.Generator",
    "torch.profiler", "torch.autograd", "torch.compile", "torch.jit",
    "torch.promote_types", "torch.result_type", "torch.can_cast",
    "torch.from_numpy", "torch.set_grad_enabled", "torch.get_device",
)

#: attribute accesses on a device value that are static host metadata, not a
#: device->host transfer (``int(x.shape[0])`` must not flag TM301)
_HOST_METADATA_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "device",
                                  "numel", "is_cuda", "layout", "element_size"})

#: method calls that copy a device tensor to the host
_TO_HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: calls that compile a program: a hot path that calls them recompiles
_COMPILE_CALLS = frozenset({"torch.compile", "torch.jit.script", "torch.jit.trace"})

#: abstract row count for shape specs — any small constant works, no data is
#: allocated; 2 (not 1) so accidental squeezes change the shape and get caught
_ABSTRACT_ROWS = 2


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def validate_result_features(result_features: Sequence[Feature],
                             workflow_cv: bool = False,
                             serving: bool = False,
                             fitted=None,
                             cost: bool = False,
                             hbm_budget: Optional[float] = None,
                             single_host: bool = False,
                             host_budget: Optional[float] = None,
                             rows: Optional[int] = None,
                             chunk_rows: Optional[int] = None
                             ) -> DiagnosticReport:
    """Run every analyzer over the DAG reached from ``result_features``.

    Touches no data: type propagation walks declared FeatureTypes and the
    shape/dtype pass runs the device halves on meta tensors.

    ``serving=True`` adds the TM5xx servability analyzers
    (serve/validator.py); ``fitted`` (uid -> fitted transformer) switches
    them to scoring-path mode, where an unfitted estimator is a TM501 error.

    ``cost=True`` (implied by a non-None ``hbm_budget`` or
    ``single_host=True``) adds the TM6xx plan-cost analyzers
    (checkers/plancheck.py): the device prefix is traced on meta operands
    (nothing allocated, built or launched) and the resulting
    :class:`~.plancheck.PlanCostReport` is attached as
    ``report.plan_cost``.
    """
    from ..workflow.dag import all_stages
    from .diagnostics import DagCycleError

    report = DiagnosticReport()
    try:
        stages = all_stages(result_features)
    except DagCycleError as e:
        # a cyclic graph has no topological order; every downstream analyzer
        # would loop, so TM101 is the only finding that can be reported
        report.extend([e.diagnostic])
        return report
    generators = _all_generators(result_features)
    report.extend(check_structure(result_features, stages, generators))
    report.extend(check_types(stages))
    report.extend(check_shapes(stages, generators))
    report.extend(check_device_hazards(stages))
    report.extend(check_leakage(result_features, stages, workflow_cv))
    if serving:
        from ..serve.validator import check_servability

        report.extend(check_servability(result_features, fitted=fitted))
    if cost or hbm_budget is not None or single_host:
        from .plancheck import check_plan_cost

        cost_report, diags = check_plan_cost(
            result_features, fitted=fitted, hbm_budget=hbm_budget,
            single_host=single_host)
        report.plan_cost = cost_report
        report.extend(diags)
    if host_budget is not None:
        # TM607 (ISSUE 13): static host-DRAM residency vs the armed budget —
        # fails closed (TM606) on unfitted estimators or a missing row count
        from .plancheck import check_host_residency

        res_report, res_diags = check_host_residency(
            result_features, fitted=fitted, host_budget=host_budget,
            n_rows=rows, chunk_rows=chunk_rows)
        report.host_residency = res_report
        report.extend(res_diags)
    return report


def _all_generators(result_features: Sequence[Feature]
                    ) -> List[FeatureGeneratorStage]:
    """Every generator stage object, deduplicated by IDENTITY only.

    dag.raw_feature_generators dedups by uid, which would hide exactly the
    duplicate-uid corruption TM102/TM104 exist to report.
    """
    seen_ids: Set[int] = set()
    out: List[FeatureGeneratorStage] = []
    for f in result_features:
        for raw in f.raw_features():
            st = raw.origin_stage
            if isinstance(st, FeatureGeneratorStage) and id(st) not in seen_ids:
                seen_ids.add(id(st))
                out.append(st)
    return out


# ---------------------------------------------------------------------------
# 1. structural analyzers (TM102-TM106; TM101 handled by the caller)
# ---------------------------------------------------------------------------

def check_structure(result_features: Sequence[Feature], stages: Sequence[Any],
                    generators: Sequence[FeatureGeneratorStage]
                    ) -> List[Diagnostic]:
    diags: List[Diagnostic] = []

    # TM102 — duplicate uids among distinct stage objects
    by_uid: Dict[str, List[Any]] = {}
    for s in list(stages) + list(generators):
        by_uid.setdefault(s.uid, [])
        if all(existing is not s for existing in by_uid[s.uid]):
            by_uid[s.uid].append(s)
    for uid, objs in sorted(by_uid.items()):
        if len(objs) > 1:
            diags.append(make_diagnostic(
                "TM102",
                f"{len(objs)} distinct stages share uid {uid!r} "
                f"({', '.join(sorted(type(o).__name__ for o in objs))}); "
                "scoring substitution by uid will silently shadow one of them",
                stage_uid=uid))

    # TM103 — feature whose origin stage has been rewired to a different output
    seen_feats: Set[str] = set()
    for root in result_features:
        for f in root.all_features():
            if f.uid in seen_feats:
                continue
            seen_feats.add(f.uid)
            st = f.origin_stage
            if st is None:
                continue
            out = getattr(st, "_output_feature", None)
            if out is not None and out is not f:
                diags.append(make_diagnostic(
                    "TM103",
                    f"feature {f.name!r} was produced by stage {st.uid}, but "
                    f"the stage's current output is {out.name!r}; this branch "
                    "of the DAG is detached from what the stage will compute",
                    stage_uid=st.uid))

    # TM104 — distinct generator stages emitting the same raw column name
    by_raw: Dict[str, List[FeatureGeneratorStage]] = {}
    for g in generators:
        by_raw.setdefault(g.raw_name, []).append(g)
    for name, gens in sorted(by_raw.items()):
        if len(gens) > 1:
            diags.append(make_diagnostic(
                "TM104",
                f"{len(gens)} distinct raw feature generators all emit column "
                f"{name!r} and will read the same input column",
                stage_uid=gens[0].uid))

    # TM105 — more than one ModelSelector
    from ..models.selector import ModelSelector
    from ..workflow.dag import is_a

    selectors = [s for s in stages if is_a(s, ModelSelector)]
    if len(selectors) > 1:
        diags.append(make_diagnostic(
            "TM105",
            f"DAG contains {len(selectors)} ModelSelectors "
            f"({', '.join(s.uid for s in selectors)}); cut_dag and "
            "workflow-level CV require exactly one",
            stage_uid=selectors[1].uid))

    # TM106 — registry/serde round-trip-ability, once per stage class
    diags.extend(_check_serde(stages, generators))
    return diags


def _check_serde(stages: Sequence[Any],
                 generators: Sequence[FeatureGeneratorStage]) -> List[Diagnostic]:
    from ..stages.base import Estimator, STAGE_REGISTRY
    from ..workflow.serde import _Encoder, _has_unserializable, encode_stage

    diags: List[Diagnostic] = []
    seen_classes: Set[type] = set()
    for s in list(stages) + list(generators):
        cls = type(s)
        if cls in seen_classes:
            continue
        seen_classes.add(cls)
        registered = STAGE_REGISTRY.get(cls.__name__)
        if registered is not cls:
            what = "shadowed by another class of the same name" \
                if registered is not None else "not registered"
            diags.append(make_diagnostic(
                "TM106",
                f"stage class {cls.__name__} is {what} in STAGE_REGISTRY; "
                "a saved model using it cannot be reloaded faithfully",
                stage_uid=s.uid))
            continue
        try:
            # estimators persist as identity stubs (params only) — mirror the
            # save path exactly so validate() predicts what save() will do
            state = encode_stage(s, _Encoder(), full=not isinstance(s, Estimator))
        except Exception as e:
            diags.append(make_diagnostic(
                "TM106",
                f"stage class {cls.__name__} fails to serialize: {e}",
                stage_uid=s.uid))
            continue
        if isinstance(s, FeatureGeneratorStage):
            if _has_unserializable(state.get("generator", {}).get("extract", {})):
                # info, not warning: the loader falls back to by-name field
                # extraction, but the lambda's transformation logic is lost
                diags.append(make_diagnostic(
                    "TM106",
                    f"raw feature {s.raw_name!r} extracts via a lambda/local "
                    "function; a reloaded model falls back to plain by-name "
                    "field extraction, dropping the lambda's logic",
                    stage_uid=s.uid,
                    severity=Severity.INFO))
        elif _has_unserializable(state):
            diags.append(make_diagnostic(
                "TM106",
                f"stage class {cls.__name__} carries a non-serializable "
                "callable (lambda/local function); save() will refuse it",
                stage_uid=s.uid))
    return diags


# ---------------------------------------------------------------------------
# 2. type & shape inference (TM201-TM204)
# ---------------------------------------------------------------------------

def check_types(stages: Sequence[Any]) -> List[Diagnostic]:
    """Re-propagate declared FeatureTypes edge by edge.

    ``set_input`` already checks this at wiring time, but serde-loaded DAGs,
    manual ``_input_features`` assignment, and post-wiring param edits all
    bypass it — the validator re-derives every edge from current state.
    """
    diags: List[Diagnostic] = []
    for st in stages:
        feats = st.inputs
        if st.sequence_input_type is not None:
            fixed = len(st.input_types)
            if len(feats) < fixed + st.min_sequence_inputs:
                diags.append(make_diagnostic(
                    "TM201",
                    f"{type(st).__name__} expects at least "
                    f"{fixed + st.min_sequence_inputs} inputs, got {len(feats)}",
                    stage_uid=st.uid))
                continue
            expected = list(st.input_types) + \
                [st.sequence_input_type] * (len(feats) - fixed)
        else:
            if len(feats) != len(st.input_types):
                diags.append(make_diagnostic(
                    "TM201",
                    f"{type(st).__name__} expects {len(st.input_types)} "
                    f"inputs, got {len(feats)}",
                    stage_uid=st.uid))
                continue
            expected = list(st.input_types)
        for exp, f in zip(expected, feats):
            if not issubclass(f.ftype, exp):
                diags.append(make_diagnostic(
                    "TM202",
                    f"input {f.name!r} of {type(st).__name__} has type "
                    f"{f.ftype.__name__}, expected {exp.__name__}",
                    stage_uid=st.uid))
        out = getattr(st, "_output_feature", None)
        if out is None:
            continue
        try:
            expected_out = st._output_ftype()
        except Exception:
            continue  # input-dependent output types may need data; skip
        if out.ftype is not expected_out:
            diags.append(make_diagnostic(
                "TM203",
                f"output feature {out.name!r} is declared "
                f"{out.ftype.__name__} but {type(st).__name__} now produces "
                f"{expected_out.__name__}",
                stage_uid=st.uid))
    return diags


_KIND_DTYPES = {
    # device-canonical dtypes: what a column becomes on the card, not the
    # host float64/int64 storage dtypes.  The port lifts every numeric kind
    # as float32 rows with NaN where missing (``workflow/plan.py::
    # _lift_column``), and reads an integral or binary prefix output back
    # the same way, where the reference lifts int32 and bool
    ColumnKind.FLOAT: "float32",
    ColumnKind.INT: "float32",
    ColumnKind.BOOL: "float32",
}


def _feature_spec(ftype, width: int = 1):
    """A meta tensor of a feature's device representation (no storage on
    any device).  Host kinds (text/lists/maps) have none -> None."""
    import torch

    kind = ftype.kind
    if kind in _KIND_DTYPES:
        return torch.empty((_ABSTRACT_ROWS,), dtype=getattr(torch, _KIND_DTYPES[kind]),
                           device="meta")
    if kind is ColumnKind.GEO:
        return torch.empty((_ABSTRACT_ROWS, 3), dtype=torch.float32, device="meta")
    if kind is ColumnKind.VECTOR:
        return torch.empty((_ABSTRACT_ROWS, max(width, 1)), dtype=torch.float32,
                           device="meta")
    return None


def _sig(t) -> tuple:
    return (tuple(int(s) for s in t.shape), str(t.dtype).replace("torch.", ""))


def _output_mismatch(traced, expected, vector: bool) -> Optional[str]:
    """What is wrong with a meta output against the declared output type's
    device representation (``expected``), or None."""
    if traced.dtype != expected.dtype:
        return (f"output dtype {str(traced.dtype).replace('torch.', '')} where "
                f"the declared output type needs "
                f"{str(expected.dtype).replace('torch.', '')}")
    if traced.dim() != expected.dim() or int(traced.shape[0]) != _ABSTRACT_ROWS \
            or (not vector and tuple(traced.shape) != tuple(expected.shape)):
        return (f"output shape {tuple(traced.shape)} where the declared output "
                f"type needs {('(rows, width)' if vector else tuple(expected.shape))}"
                f" over {_ABSTRACT_ROWS} rows")
    return None


def _meta_run(device_fn, specs):
    """``device_fn`` on meta operands, with a constant store of its own (a
    stage's device constants land there, on the meta device)."""
    from ..ops._consts import const_store

    with const_store({}):
        return device_fn(*specs)


def check_shapes(stages: Sequence[Any],
                 generators: Sequence[FeatureGeneratorStage]) -> List[Diagnostic]:
    """Run each stage's device half on meta operands (TM204).

    Feature specs propagate topologically; a stage exposing a
    ``device_transform(*tensors)`` method runs on meta tensors of its input
    specs — shape/dtype incompatibilities surface here as TM204 without
    allocating a single device buffer.  The output must also be what the
    stage's declared output type needs (:func:`_output_mismatch`): torch
    promotes and broadcasts where XLA refuses, so an exception alone would
    miss what the reference's ``lax`` ops catch.

    Vector widths that are only known after fitting (a vectorizer's vocab
    size, say) propagate as *placeholders*, and stages fed by a placeholder
    width are NOT run: width-sensitive kernels (the sanity checker's
    kept-slot gather) would otherwise fail against a fabricated width and
    report phantom TM204s.  The tradeoff is reduced dtype coverage
    downstream of unfitted vectorizers; fitted scoring DAGs re-check when
    the serving plan is built.
    """
    import torch

    diags: List[Diagnostic] = []
    specs: Dict[str, Any] = {}
    #: feature uids whose VECTOR width is a placeholder (data-dependent or
    #: derived from one)
    placeholder: Set[str] = set()
    for g in generators:
        out = g.get_output()
        specs[out.uid] = _feature_spec(out.ftype)
        if out.ftype.kind is ColumnKind.VECTOR:
            placeholder.add(out.uid)

    for st in stages:
        out = getattr(st, "_output_feature", None)
        if out is None:
            continue
        in_specs = [specs.get(f.uid) for f in st.inputs]
        widths = [int(s.shape[1]) for s in in_specs
                  if s is not None and s.dim() == 2]
        widths_known = widths and all(s is not None for s in in_specs) \
            and not any(f.uid in placeholder for f in st.inputs)
        vector = out.ftype.kind is ColumnKind.VECTOR
        out_width = sum(widths) if vector and widths_known else 1
        out_spec = _feature_spec(out.ftype, width=out_width)
        if vector and not widths_known:
            placeholder.add(out.uid)

        device_fn = getattr(st, "device_transform", None)
        # stages may restrict device_transform to a subset of input slots
        # (e.g. a model's optional label slot is never wired at serve time)
        slots = getattr(st, "device_input_slots", None)
        if slots is None:
            dev_slots = list(range(len(st.inputs)))
        else:
            dev_slots = [i for i in slots if i < len(st.inputs)]
        dev_specs = [in_specs[i] for i in dev_slots]
        if callable(device_fn) and dev_specs and \
                all(s is not None for s in dev_specs) and \
                not any(st.inputs[i].uid in placeholder for i in dev_slots):
            where = [_sig(s) for s in dev_specs]
            try:
                traced = _meta_run(device_fn, dev_specs)
            except Exception as e:  # noqa: BLE001 — every failure is a finding
                msg = str(e).split("\n")[0]
                diags.append(make_diagnostic(
                    "TM204",
                    f"{type(st).__name__}.device_transform fails on meta "
                    f"operands {where}: {msg}",
                    stage_uid=st.uid))
            else:
                if isinstance(traced, torch.Tensor):
                    bad = _output_mismatch(traced, out_spec, vector) \
                        if out_spec is not None else None
                    if bad is not None:
                        diags.append(make_diagnostic(
                            "TM204",
                            f"{type(st).__name__}.device_transform on meta "
                            f"operands {where}: {bad}",
                            stage_uid=st.uid))
                    else:
                        out_spec = traced
        specs[out.uid] = out_spec
    return diags


# ---------------------------------------------------------------------------
# 3. device-hazard AST lint (TM301-TM304)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LintFinding:
    """A raw AST-lint hit, convertible to a Diagnostic."""

    code: str
    message: str
    qualname: str
    filename: str
    lineno: int

    def to_diagnostic(self, stage_uid: Optional[str] = None) -> Diagnostic:
        return make_diagnostic(
            self.code, f"{self.qualname}: {self.message}",
            stage_uid=stage_uid,
            location=f"{self.filename}:{self.lineno}")


def _assigned_names(target: ast.AST) -> List[str]:
    """Names an assignment target binds to the assigned value.

    For ``out[i] = <device>`` only the container ``out`` is tainted — the
    subscript index ``i`` stays a host value (walking the whole target node
    would mark it device and cascade false TM301s onto e.g. ``float(i)``).
    """
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _assigned_names(e)]
    if isinstance(target, ast.Starred):
        return _assigned_names(target.value)
    if isinstance(target, ast.Subscript):
        return _assigned_names(target.value)
    return []  # attribute targets (self.x = ...) are out of scope


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name for Name/Attribute chains ('np.asarray'), else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_HOST_SYNC_CALLS = frozenset({
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "np.float64", "np.float32", "np.int64", "np.int32",
})
#: calls that wait for the card whatever their operands
_DEVICE_SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
_HOST_SYNC_BUILTINS = frozenset({"float", "int", "bool", "complex"})

#: inline suppression: a finding on a line containing e.g. ``# opcheck:
#: allow(TM301)`` is an acknowledged, intentional hazard and is skipped
_ALLOW_RE = re.compile(r"opcheck:\s*allow\(([A-Z0-9,\s]+)\)")


def _is_host_conversion(node: ast.AST) -> bool:
    """True when a call's RESULT lives on host even if its args are device
    values: the sync happens (and is flagged) at the call itself, so the
    assigned name must not stay tainted as device."""
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Name) and func.id in _HOST_SYNC_BUILTINS:
        return True
    if isinstance(func, ast.Attribute) and func.attr in _TO_HOST_METHODS:
        return True
    chain = _attr_chain(func)
    if chain in _HOST_SYNC_CALLS:
        return True
    # map(_to_np, device_tuple) style: a named to-host helper applied per
    # element — recognize conversion helpers by name
    if isinstance(func, ast.Name) and func.id == "map" and node.args:
        f0 = node.args[0]
        name = f0.id if isinstance(f0, ast.Name) else \
            f0.attr if isinstance(f0, ast.Attribute) else ""
        if "np" in name or "numpy" in name or "host" in name:
            return True
    return False


class _FunctionLinter:
    """Single-function AST lint with a small device-value dataflow.

    Names assigned from ``torch.`` calls are tracked as device values
    (fixpoint over assignments, so chained assignments converge); host
    conversions applied to device expressions are flagged as TM301.
    """

    def __init__(self, fn: ast.AST, filename: str, qualname: str,
                 line_offset: int = 0, lines: Optional[List[str]] = None):
        self.fn = fn
        self.filename = filename
        self.qualname = qualname
        self.line_offset = line_offset
        self.lines = lines or []  # snippet source, for `opcheck: allow(...)`
        self.device_names: Set[str] = set()

    def _is_device_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_METADATA_ATTRS:
                return False  # x.shape / x.dtype are static host metadata
            return self._is_device_expr(node.value)
        if isinstance(node, ast.Name):
            return node.id in self.device_names
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and node.func.id == "len":
                return False  # len(device_array) is a host int
            if _is_host_conversion(node):
                return False  # the sync is flagged at this call, not cascaded
            chain = _attr_chain(node.func)
            if chain is not None and chain.split(".")[0] in _DEVICE_ROOTS:
                return not chain.startswith(_HOST_TORCH_CALLS)
        return any(self._is_device_expr(c) for c in ast.iter_child_nodes(node))

    def _collect_device_names(self) -> None:
        assigns: List[Tuple[List[ast.AST], ast.AST]] = []
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Assign):
                assigns.append((node.targets, node.value))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                    and node.value is not None:
                assigns.append(([node.target], node.value))
        changed = True
        while changed:
            changed = False
            for targets, value in assigns:
                if _is_host_conversion(value) or not self._is_device_expr(value):
                    continue
                for t in targets:
                    for name in _assigned_names(t):
                        if name not in self.device_names:
                            self.device_names.add(name)
                            changed = True

    def _finding(self, code: str, node: ast.AST, message: str) -> LintFinding:
        return LintFinding(code=code, message=message, qualname=self.qualname,
                           filename=self.filename,
                           lineno=getattr(node, "lineno", 0) + self.line_offset)

    def _suppressed(self, f: LintFinding) -> bool:
        local = f.lineno - self.line_offset
        if not (0 < local <= len(self.lines)):
            return False
        m = _ALLOW_RE.search(self.lines[local - 1])
        return bool(m) and f.code in m.group(1)

    def run(self) -> List[LintFinding]:
        self._collect_device_names()
        out: List[LintFinding] = []
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Call):
                out.extend(self._lint_call(node))
            elif isinstance(node, ast.For):
                out.extend(self._lint_for(node))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not self.fn:
                out.extend(self._lint_nested_def(node))
        return [f for f in out if not self._suppressed(f)]

    def _lint_call(self, node: ast.Call) -> List[LintFinding]:
        out: List[LintFinding] = []
        func = node.func
        # .item() / .tolist() / .cpu() / .numpy() on a device tensor
        if isinstance(func, ast.Attribute) and func.attr in _TO_HOST_METHODS \
                and self._is_device_expr(func.value):
            out.append(self._finding(
                "TM301", node,
                f".{func.attr}() on a device tensor forces a blocking "
                "device->host sync"))
        chain = _attr_chain(func)
        # torch.cuda.synchronize() / event.synchronize() / stream.synchronize()
        if chain in _DEVICE_SYNC_CALLS or (
                isinstance(func, ast.Attribute) and func.attr == "synchronize"):
            out.append(self._finding(
                "TM301", node,
                f"{chain or '.synchronize'}() waits for the card: a blocking "
                "device->host sync"))
        arg0 = node.args[0] if node.args else None
        if arg0 is not None and self._is_device_expr(arg0):
            if isinstance(func, ast.Name) and func.id in _HOST_SYNC_BUILTINS:
                out.append(self._finding(
                    "TM301", node,
                    f"{func.id}() on a device tensor forces a blocking "
                    "device->host sync"))
            elif chain in _HOST_SYNC_CALLS:
                out.append(self._finding(
                    "TM301", node,
                    f"{chain}() on a device tensor pulls the buffer to host"))
        if chain in _COMPILE_CALLS:
            out.append(self._finding(
                "TM303", node,
                f"{chain} called inside the hot path compiles on every call"))
        return out

    def _lint_for(self, node: ast.For) -> List[LintFinding]:
        it = node.iter
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "range" and it.args:
            a0 = it.args[0]
            if isinstance(a0, ast.Call) and isinstance(a0.func, ast.Name) \
                    and a0.func.id == "len":
                return [self._finding(
                    "TM302", node,
                    "per-row Python loop (for ... in range(len(...)))")]
            if isinstance(a0, ast.Subscript) \
                    and isinstance(a0.value, ast.Attribute) \
                    and a0.value.attr == "shape":
                return [self._finding(
                    "TM302", node,
                    "per-row Python loop (for ... in range(x.shape[...]))")]
        return []

    def _lint_nested_def(self, node: ast.AST) -> List[LintFinding]:
        for dec in getattr(node, "decorator_list", []):
            target = dec.func if isinstance(dec, ast.Call) else dec
            chains = {_attr_chain(target)}
            if isinstance(dec, ast.Call):  # partial(torch.compile, ...)
                chains.update(_attr_chain(a) for a in dec.args)
            if chains & _COMPILE_CALLS:
                return [self._finding(
                    "TM304", node,
                    f"compiled closure {node.name!r} defined per call "
                    "compiles afresh every invocation")]
        return []


def _iter_functions(tree: ast.AST, qualprefix: str = ""):
    """Yield (qualname, FunctionDef) for module/class-level functions."""
    body = getattr(tree, "body", [])
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield f"{qualprefix}{node.name}", node
        elif isinstance(node, ast.ClassDef):
            yield from _iter_functions(node, qualprefix=f"{qualprefix}{node.name}.")


def lint_source(source: str, filename: str = "<string>",
                only_names: Optional[frozenset] = HAZARD_FUNCTION_NAMES,
                tree: Optional[ast.AST] = None) -> List[LintFinding]:
    """AST-lint a python source string; ``only_names=None`` lints every
    function.  ``tree`` reuses an already-parsed AST of ``source``."""
    if tree is None:
        tree = ast.parse(source, filename=filename)
    lines = source.splitlines()
    out: List[LintFinding] = []
    for qualname, fn in _iter_functions(tree):
        if only_names is not None and fn.name not in only_names:
            continue
        out.extend(_FunctionLinter(fn, filename, qualname, lines=lines).run())
    return out


def lint_file(path: str,
              only_names: Optional[frozenset] = HAZARD_FUNCTION_NAMES
              ) -> List[LintFinding]:
    with open(path) as fh:
        return lint_source(fh.read(), filename=path, only_names=only_names)


def lint_stage_class(cls: type) -> List[LintFinding]:
    """Lint the hazard methods a stage class defines itself (not inherited)."""
    out: List[LintFinding] = []
    for name in sorted(HAZARD_FUNCTION_NAMES):
        fn = cls.__dict__.get(name)
        if fn is None or not callable(fn):
            continue
        try:
            src, start = inspect.getsourcelines(fn)
            filename = inspect.getsourcefile(fn) or "<unknown>"
        except (OSError, TypeError):
            continue  # dynamically-created function; nothing to parse
        try:
            tree = ast.parse(textwrap.dedent("".join(src)))
        except SyntaxError:
            continue
        fn_node = tree.body[0]
        if not isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # snippet line L maps to file line start + (L - 1); fn_node.lineno is
        # NOT 1 when the method is decorated, so don't subtract it
        out.extend(_FunctionLinter(
            fn_node, filename, f"{cls.__name__}.{name}",
            line_offset=start - 1, lines=src).run())
    return out


# -- TM306: unsynchronized module-level mutable state -----------------------

#: method calls that mutate a dict/list/set in place (reads like .get/.keys
#: are not flagged — the hazard is the unsynchronized read-modify-write)
_MUTATOR_METHODS = frozenset({
    "append", "extend", "insert", "pop", "popitem", "clear", "update",
    "setdefault", "remove", "sort", "reverse", "add", "discard",
})

#: constructor calls whose result is a module-level mutable container
_MUTABLE_CTORS = frozenset({
    "dict", "list", "set", "defaultdict", "OrderedDict", "Counter", "deque",
})


def _is_mutable_ctor(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                         ast.ListComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = node.func.id if isinstance(node.func, ast.Name) else \
            node.func.attr if isinstance(node.func, ast.Attribute) else ""
        return name in _MUTABLE_CTORS
    return False


def _looks_like_lock(expr: ast.AST) -> bool:
    """True when a with-item's context expression names a lock (heuristic:
    the final dotted segment contains 'lock', e.g. ``_CACHE_LOCK``,
    ``self._lock``, ``threading.Lock()``)."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    chain = _attr_chain(expr)
    if chain is None:
        return False
    return "lock" in chain.rsplit(".", 1)[-1].lower()


def lint_module_concurrency(source: str, filename: str = "<string>",
                            tree: Optional[ast.AST] = None
                            ) -> List[LintFinding]:
    """TM306: module-level mutable dict/list/set read-modify-written inside a
    function without a ``with <lock>:`` frame (AST heuristic; suppress an
    intentional single-threaded site with the usual inline opcheck allow
    marker carrying code TM306).

    Only mutations inside function bodies are flagged — module top-level
    mutation runs once, single-threaded, at import time.  ``tree`` reuses an
    already-parsed AST of ``source``.

    The rule is a DELEGATE: its engine (mutable-global discovery, the
    with-lock scope tracker, the allow-marker check) lives in the TM31x
    concurrency analyzer (checkers/threadcheck.py) so the shallow
    module-global rule and the class-level lockset rules cannot drift.
    The import is lazy to keep threadcheck -> opcheck the only module-level
    import direction between the two.
    """
    from .threadcheck import module_global_findings

    return module_global_findings(source, filename=filename, tree=tree)


def lint_file_concurrency(path: str) -> List[LintFinding]:
    with open(path) as fh:
        return lint_module_concurrency(fh.read(), filename=path)


def check_device_hazards(stages: Sequence[Any]) -> List[Diagnostic]:
    """TM3xx lint over every stage class in the DAG (once per class)."""
    diags: List[Diagnostic] = []
    seen: Set[type] = set()
    for st in stages:
        cls = type(st)
        if cls in seen:
            continue
        seen.add(cls)
        for finding in lint_stage_class(cls):
            diags.append(finding.to_diagnostic(stage_uid=st.uid))
    return diags


# ---------------------------------------------------------------------------
# 4. leakage analyzers (TM401-TM402)
# ---------------------------------------------------------------------------

def check_leakage(result_features: Sequence[Feature], stages: Sequence[Any],
                  workflow_cv: bool) -> List[Diagnostic]:
    from ..models.selector import ModelSelector
    from ..stages.base import Estimator
    from ..workflow.dag import is_a

    diags: List[Diagnostic] = []

    # TM401a — a stage consumes a response feature outside any label slot
    # (set_input refuses this, but serde-loaded or hand-wired DAGs bypass it)
    for st in stages:
        for f in st.inputs:
            if f.is_response and not st._is_label_slot(f, st.inputs) \
                    and not st.allow_label_as_input:
                diags.append(make_diagnostic(
                    "TM401",
                    f"stage {type(st).__name__} consumes response feature "
                    f"{f.name!r} as a plain input",
                    stage_uid=st.uid))

    selectors = [s for s in stages if is_a(s, ModelSelector)]
    if len(selectors) != 1:
        return diags  # TM105 already reported; cut_dag replay needs one
    sel = selectors[0]

    # TM401b — a response-derived feature reaches the selector's FEATURE input
    # through non-label-slot edges (descent through a declared label slot is
    # the sanctioned path: that is how SanityChecker et al. consume the label)
    visited: Set[str] = set()
    frontier = [f for f in sel.inputs if not sel._is_label_slot(f, sel.inputs)]
    while frontier:
        f = frontier.pop()
        if f.uid in visited:
            continue
        visited.add(f.uid)
        if f.is_response:
            diags.append(make_diagnostic(
                "TM401",
                f"response-derived feature {f.name!r} reaches the "
                f"ModelSelector's feature input — the label leaks into the "
                "predictor vector",
                stage_uid=f.origin_stage.uid if f.origin_stage else sel.uid))
            continue
        st = f.origin_stage
        if st is None or isinstance(st, FeatureGeneratorStage):
            continue
        for p in st.inputs:
            if not st._is_label_slot(p, st.inputs):
                frontier.append(p)

    # TM402 — replay cut_dag: label-dependent estimators upstream of the
    # selector fit once over all rows unless workflow-level CV re-fits them
    # per fold.  Informational because the pattern is the reference default
    # (withWorkflowCV is opt-in there too).
    if not workflow_cv:
        from ..workflow.dag import cut_dag

        try:
            cut = cut_dag(result_features)
        except ValueError:
            cut = None
        if cut is not None:
            _before, during, _sel = cut
            leaky = [s for s in during if isinstance(s, Estimator)
                     and any(f.is_response for f in s.inputs)]
            if leaky:
                names = ", ".join(f"{type(s).__name__}({s.uid})" for s in leaky)
                diags.append(make_diagnostic(
                    "TM402",
                    f"label-dependent estimator(s) {names} fit outside the "
                    "CV folds; their fit sees validation labels, biasing the "
                    "CV estimate",
                    stage_uid=leaky[0].uid))
    return diags
