"""``lint`` subcommand — static diagnostics from the command line
(counterpart of ``transmogrifai_tpu/cli/lint.py``, every flag of its parser).

Reference: the reference CLI's pre-flight checks (cli/.../CliExec.scala role)
combined with the static validator (checkers/opcheck.py, SURVEY §1): print
typed TM-code diagnostics and exit non-zero, so CI can gate on them before
any time on the card is spent.

Modes, combinable:

- ``--path FILE_OR_DIR``  AST-lints python sources for device hazards (TM3xx) in
  ``transform_columns``/``fit_columns``/``device_transform`` bodies
  (``--all-functions`` widens to every function; ``--concurrency`` adds the
  TM306 unsynchronized-module-state rule; ``--threads`` runs the TM31x
  whole-program concurrency analyzer — lockset inference, lock-order
  deadlock graph, blocking-under-lock — over ALL --path files at once).
- ``--workflow module:attr``  imports ``attr`` from ``module`` (a Workflow, a
  fitted WorkflowModel, a zero-arg factory returning either, or a list of
  result features) and runs the full analyzer suite over the DAG — no data
  is touched.
- ``--model DIR``  loads a saved WorkflowModel (``model.save(path)``) and
  validates it scoring-path aware (TM501+ servability enabled).
- ``--cost``  adds the TM6xx plan-cost analyzers (checkers/plancheck.py):
  the device prefix traces on meta operands (nothing allocated, built or
  launched) and the
  :class:`PlanCostReport` — FLOPs, bytes, per-bucket peak-HBM estimates,
  recompile hazards, collective inventory — prints before the diagnostics.
  ``--hbm-budget BYTES`` arms the TM601 admission error;
  ``--single-host`` makes any collective/resharding op a TM603 error.

Output: human text by default; ``--format json`` emits ONE JSON OBJECT PER
LINE — each diagnostic as ``{"code", "severity", "stageUid", "location",
"message", "fixHint"}``, preceded (under ``--cost``) by one
``{"planCostReport": {...}}`` line and (under ``--threads``) by one
``{"threadModel": {...}}`` line — the machine contract
``tools/torch_lint_gate.py`` consumes.  (``--json``, kept for compatibility,
prints the old single JSON array.)

Exit status: 1 when any finding reaches ``--fail-on`` (default: warning),
else 0.  For a CI gate that only fails on NEW errors (INFO/WARNING never
flip rc) use ``tools/torch_lint_gate.py``; ``tools/torch_ir_gate.py`` and
``tools/torch_static_gate.py`` gate the IR corpus the same way.
"""

from __future__ import annotations

import importlib
import os
from typing import List


def add_lint_parser(sub) -> None:
    p = sub.add_parser(
        "lint", help="static DAG validation + device-hazard lint (exits "
                     "non-zero on findings)")
    p.add_argument("--path", action="append", default=[],
                   help="python file or directory to AST-lint (repeatable)")
    p.add_argument("--workflow", default=None, metavar="MODULE:ATTR",
                   help="import a Workflow / WorkflowModel (or factory / "
                        "result-feature list) and validate its DAG")
    p.add_argument("--model", default=None, metavar="DIR",
                   help="saved WorkflowModel directory to validate "
                        "(scoring-path aware: TM501+ enabled)")
    p.add_argument("--all-functions", action="store_true",
                   help="lint every function, not just "
                        "transform_columns/fit_columns/device_transform")
    p.add_argument("--concurrency", action="store_true",
                   help="add the TM306 rule to --path lint: module-level "
                        "mutable dict/list mutated outside a threading lock")
    p.add_argument("--threads", action="store_true",
                   help="run the TM31x whole-program concurrency analyzer "
                        "(checkers/threadcheck.py) over every --path file: "
                        "lockset/guarded-by inference (TM311/TM312/TM314), "
                        "lock-order deadlock graph (TM313), blocking under a "
                        "held lock (TM315); --format json adds one "
                        "{\"threadModel\": ...} summary line")
    p.add_argument("--serving", action="store_true",
                   help="add the TM5xx servability analyzers (host "
                        "round-trips in the fused scoring prefix, unbounded "
                        "shapes breaking padding buckets) to --workflow "
                        "validation")
    p.add_argument("--cost", action="store_true",
                   help="add the TM6xx plan-cost analyzers: a meta-tensor "
                        "trace of the device prefix for FLOPs/bytes/HBM "
                        "(prints a PlanCostReport)")
    p.add_argument("--hbm-budget", type=float, default=None,
                   dest="hbm_budget", metavar="BYTES",
                   help="device HBM budget in bytes; a plan whose static "
                        "peak estimate exceeds it is a TM601 error")
    p.add_argument("--single-host", action="store_true", dest="single_host",
                   help="assert the plan runs single-host: any "
                        "collective/resharding op inside it is a TM603 error")
    p.add_argument("--host-budget", type=float, default=None,
                   dest="host_budget", metavar="BYTES",
                   help="host DRAM budget in bytes; a plan whose static "
                        "residency estimate (checkers/plancheck.py TM607) "
                        "exceeds it even in chunked out-of-core mode is an "
                        "error — requires --rows")
    p.add_argument("--rows", type=int, default=None,
                   help="row count the --host-budget residency estimate is "
                        "evaluated at (the estimate is linear in rows)")
    p.add_argument("--ir", action="store_true",
                   help="snapshot every builtin program family to its "
                        "canonical aten-op graph (a meta-tensor run, nothing "
                        "launched) and diff against the golden corpus "
                        "(tests/goldens/torch_ir) — TM7xx diagnostics")
    p.add_argument("--update-goldens", action="store_true",
                   dest="update_goldens",
                   help="with --ir: rewrite the golden IR corpus from the "
                        "current snapshots and exit 0 (use after a REVIEWED "
                        "torch upgrade or kernel change)")
    p.add_argument("--goldens", default=None, metavar="DIR",
                   help="golden IR corpus directory (default: the repo's "
                        "tests/goldens/torch_ir)")
    p.add_argument("--ir-family", action="append", default=[],
                   dest="ir_families", metavar="SUBSTR",
                   help="restrict --ir to families whose key contains "
                        "SUBSTR (repeatable)")
    p.add_argument("--fail-on", choices=["info", "warning", "error"],
                   default="warning",
                   help="lowest severity that makes the exit status non-zero")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   dest="out_format",
                   help="'json' emits one JSON object per line (one per "
                        "diagnostic; plus one planCostReport line under "
                        "--cost) — the contract tools/torch_lint_gate.py "
                        "consumes")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit diagnostics as a single JSON array "
                        "(legacy; prefer --format json)")


def _python_files(path: str) -> List[str]:
    if os.path.isfile(path):
        return [path]
    if not os.path.isdir(path):
        raise SystemExit(f"lint: --path {path!r} does not exist")
    out: List[str] = []
    for root, _dirs, files in os.walk(path):
        out.extend(os.path.join(root, f) for f in sorted(files)
                   if f.endswith(".py"))
    if not out:
        # a gate that silently lints zero files would go green on a typo'd dir
        raise SystemExit(f"lint: --path {path!r} contains no .py files")
    return out


def _resolve_workflow(spec: str):
    """'pkg.module:attr' -> (result features, workflow_cv, fitted-or-None).

    Accepts a Workflow, a fitted WorkflowModel, a zero-arg factory returning
    either, or a plain list of result features.
    """
    from ..workflow.workflow import Workflow, WorkflowModel

    if ":" not in spec:
        raise SystemExit(f"--workflow expects MODULE:ATTR, got {spec!r}")
    mod_name, attr = spec.split(":", 1)
    obj = getattr(importlib.import_module(mod_name), attr)
    if callable(obj) and not isinstance(obj, (Workflow, WorkflowModel)):
        obj = obj()
    if isinstance(obj, WorkflowModel):
        return obj.result_features, obj.workflow_cv, obj.fitted
    if isinstance(obj, Workflow):
        return obj.result_features, obj._workflow_cv, None
    return list(obj), False, None


def run_lint(ns) -> int:
    from ..checkers.diagnostics import DiagnosticReport, Severity
    from ..checkers.opcheck import (HAZARD_FUNCTION_NAMES,
                                    lint_module_concurrency, lint_source,
                                    validate_result_features)

    ir = ns.ir or ns.update_goldens or ns.ir_families
    if not ns.workflow and not ns.path and not ns.model and not ir:
        # a gate invoked with no target (flag lost in CI YAML quoting, say)
        # must not go silently green
        raise SystemExit(
            "lint: nothing to lint — pass --path, --workflow, --model "
            "and/or --ir")
    cost = ns.cost or ns.hbm_budget is not None or ns.single_host
    if (cost or ns.host_budget is not None) \
            and not (ns.workflow or ns.model):
        raise SystemExit("lint: --cost/--hbm-budget/--host-budget/"
                         "--single-host need a --workflow or --model target")
    if ns.host_budget is not None and ns.rows is None:
        raise SystemExit("lint: --host-budget needs --rows N (the TM607 "
                         "residency estimate is linear in rows)")
    if ns.threads and not ns.path:
        raise SystemExit("lint: --threads needs --path targets (the TM31x "
                         "analyzer runs over the given source files)")
    report = DiagnosticReport()
    ir_diff = None
    if ir:
        ir_diff = _run_ir(ns, report)
        if ns.update_goldens and not (ns.path or ns.workflow or ns.model):
            return 0
        # a refresh combined with other lint targets falls through: the
        # corpus was rewritten (nothing left to diff), but the requested
        # --path/--workflow/--model lint must still run and set the rc
    cost_reports = []  # one PlanCostReport per --workflow/--model target
    residency_reports = []  # one HostResidencyReport per target (TM607)
    targets = []
    if ns.workflow:
        targets.append(_resolve_workflow(ns.workflow))
    if ns.model:
        from ..workflow.workflow import WorkflowModel

        model = WorkflowModel.load(ns.model)
        targets.append((model.result_features, model.workflow_cv,
                        model.fitted))
    for features, workflow_cv, fitted in targets:
        sub = validate_result_features(
            features, workflow_cv=workflow_cv,
            serving=getattr(ns, "serving", False) or fitted is not None,
            fitted=fitted, cost=cost, hbm_budget=ns.hbm_budget,
            single_host=ns.single_host, host_budget=ns.host_budget,
            rows=ns.rows)
        report.extend(sub)
        if sub.plan_cost is not None:
            cost_reports.append(sub.plan_cost)
        if sub.host_residency is not None:
            residency_reports.append(sub.host_residency)
    if cost_reports:
        report.plan_cost = cost_reports[-1]
    only = None if ns.all_functions else HAZARD_FUNCTION_NAMES
    thread_items = []  # (src, fname, tree): the --threads whole-program set
    for path in ns.path:
        for fname in _python_files(path):
            try:
                import ast

                with open(fname) as fh:
                    src = fh.read()
                tree = ast.parse(src, filename=fname)  # parse ONCE
                findings = list(lint_source(src, filename=fname,
                                            only_names=only, tree=tree))
                if ns.concurrency:
                    findings += lint_module_concurrency(src, filename=fname,
                                                        tree=tree)
            except (SyntaxError, ValueError, UnicodeDecodeError) as e:
                # one unparseable file must not abort the lint of the rest
                from ..checkers.diagnostics import make_diagnostic

                report.extend([make_diagnostic(
                    "TM305", f"cannot parse: {e}",
                    location=f"{fname}:{getattr(e, 'lineno', 0) or 0}")])
                continue
            report.extend(f.to_diagnostic() for f in findings)
            if ns.threads:
                thread_items.append((src, fname, tree))
    thread_model = None
    if ns.threads and thread_items:
        # whole-program pass: lock-order cycles (TM313) span modules, so the
        # analyzer sees every parseable --path file in ONE run
        from ..checkers.threadcheck import analyze_parsed

        analysis = analyze_parsed(thread_items)
        report.extend(f.to_diagnostic() for f in analysis.findings)
        thread_model = analysis.model

    if ns.as_json:
        import json

        # legacy shape: one array — diagnostics first, then (only when
        # --cost/--ir ran) one {"planCostReport"/"irDiff"} element per target
        blob = report.to_dicts()
        blob += [{"planCostReport": rep.to_dict()} for rep in cost_reports]
        blob += [{"hostResidencyReport": rep.to_dict()}
                 for rep in residency_reports]
        if ir_diff is not None:
            blob.append({"irDiff": ir_diff.to_dict()})
        if thread_model is not None:
            blob.append({"threadModel": thread_model.to_dict()})
        print(json.dumps(blob, indent=2))
    elif ns.out_format == "json":
        import json

        # one object per line: planCostReport/irDiff summary lines first,
        # then one line per diagnostic — the tools/*_gate.py contract
        for rep in cost_reports:
            print(json.dumps({"planCostReport": rep.to_dict()}))
        for rep in residency_reports:
            print(json.dumps({"hostResidencyReport": rep.to_dict()}))
        if ir_diff is not None:
            print(json.dumps({"irDiff": ir_diff.to_dict()}))
        if thread_model is not None:
            print(json.dumps({"threadModel": thread_model.to_dict()}))
        for d in report:
            print(json.dumps(d.to_dict()))
    else:
        for rep in cost_reports:
            print(rep.pretty())
        for rep in residency_reports:
            print(rep.pretty())
        if ir_diff is not None:
            print(_ir_pretty(ir_diff))
        if thread_model is not None:
            print(_thread_model_pretty(thread_model))
        print(report.pretty())

    threshold = Severity[ns.fail_on.upper()]
    return 1 if report.at_least(threshold) else 0


def _run_ir(ns, report):
    """The ``--ir`` mode: snapshot + diff (or re-golden) the IR corpus.

    Returns the :class:`~..checkers.irsnap.CorpusDiff` (None under
    --update-goldens) and extends ``report`` with the TM7xx diagnostics.
    A missing corpus is a hard refusal, not a silent pass — the gate exists
    to catch exactly the run that forgot its baseline.
    """
    from ..checkers.irsnap import (build_corpus, check_ir_corpus,
                                   default_goldens_dir, save_corpus)

    goldens_dir = ns.goldens or default_goldens_dir()
    families = ns.ir_families or None
    if ns.update_goldens:
        snaps, skipped = build_corpus(families=families)
        # SKIPPED families (filtered out by --ir-family, or unbuildable in
        # this environment) keep their existing goldens; families removed
        # from the registry entirely (neither built nor skipped) are the
        # only ones dropped.
        if skipped:
            from ..checkers.irsnap import load_corpus

            try:
                kept, _index = load_corpus(goldens_dir)
            except FileNotFoundError:
                kept = {}
            snaps = {**{k: v for k, v in kept.items() if k in skipped},
                     **snaps}
        index_path = save_corpus(snaps, goldens_dir)
        print(f"lint --ir: golden corpus updated with {len(snaps)} "
              f"program famil{'y' if len(snaps) == 1 else 'ies'} "
              f"({len(skipped)} skipped) -> {index_path}")
        return None
    try:
        diff, _current = check_ir_corpus(goldens_dir=goldens_dir,
                                         families=families)
    except FileNotFoundError as e:
        raise SystemExit(
            f"lint --ir: no golden IR corpus at {goldens_dir!r} ({e}); "
            f"record one with `cli lint --ir --update-goldens` "
            f"(or pass --goldens DIR)") from e
    if diff.compared == 0:
        # a typo'd --ir-family (or a filter this environment cannot capture)
        # compares nothing — refusing keeps the gate fail-closed, same
        # contract as the no-target and missing-corpus refusals
        what = (f"--ir-family {', '.join(families)} matched nothing"
                if families else "the corpus is empty")
        raise SystemExit(
            f"lint --ir: 0 program families compared ({what} in this "
            f"environment) — refusing to report a green nothing")
    report.extend(diff.diagnostics)
    return diff


def _thread_model_pretty(model) -> str:
    m = model.to_dict()
    lines = [f"Thread model: {len(m['threads'])} thread entry point"
             f"{'' if len(m['threads']) == 1 else 's'}, "
             f"{len(m['sharedClasses'])} shared-reachable class"
             f"{'' if len(m['sharedClasses']) == 1 else 'es'}, "
             f"{len(m['lockOrderEdges'])} lock-order edge"
             f"{'' if len(m['lockOrderEdges']) == 1 else 's'} "
             f"({m['analyzedFiles']} files)"]
    for t in m["threads"]:
        lines.append(f"  thread: {t['target']} ({t['file']}:{t['line']})")
    for outer, inner in m["lockOrderEdges"]:
        lines.append(f"  lock order: {outer} -> {inner}")
    return "\n".join(lines)


def _ir_pretty(diff) -> str:
    lines = [f"IR corpus: {diff.compared} famil"
             f"{'y' if diff.compared == 1 else 'ies'} compared, "
             f"{len(diff.changed)} changed, {len(diff.skipped)} skipped"]
    if diff.golden_torch_version or diff.current_torch_version:
        lines.append(f"  torch: golden {diff.golden_torch_version} / current "
                     f"{diff.current_torch_version}; platform: golden "
                     f"{diff.golden_platform} / current "
                     f"{diff.current_platform}")
    for key in diff.changed:
        lines.append(f"  changed: {key}")
    return "\n".join(lines)
