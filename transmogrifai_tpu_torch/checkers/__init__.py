"""Checkers — data-driven (sanity) and static (opcheck, threadcheck,
plancheck, irsnap) workflow validation (counterpart of
``transmogrifai_tpu/checkers``; every name it exports but the StableHLO
canonicalizer, which has no counterpart in an aten-op graph).

Reference: core/.../SanityChecker.scala for the data-driven checker; the
static validator ports the compile-time type safety of the Scala feature DAG
(SURVEY §1) as a pre-execution analysis pass.
"""

from .diagnostics import (
    DIAGNOSTIC_CODES,
    DagCycleError,
    Diagnostic,
    DiagnosticReport,
    OpCheckError,
    Severity,
    make_diagnostic,
)
from .irsnap import (
    CorpusDiff,
    IRSnapshot,
    build_corpus,
    check_ir_corpus,
    diff_corpus,
    diff_snapshots,
    load_corpus,
    save_corpus,
    snapshot_program,
    snapshot_scoring_plan,
    snapshot_transform_plan,
)
from .plancheck import (
    BucketCost,
    PlanCostReport,
    RecompileHazard,
    SegmentCost,
    analyze_scoring_plan,
    analyze_transform,
    analyze_transform_plan,
    check_plan_cost,
    cost_diagnostics,
    trace_cost,
)
from .threadcheck import (
    ThreadAnalysis,
    ThreadModel,
    analyze_files,
    analyze_source,
)

__all__ = [
    "DIAGNOSTIC_CODES",
    "BucketCost",
    "CorpusDiff",
    "DagCycleError",
    "Diagnostic",
    "DiagnosticReport",
    "IRSnapshot",
    "OpCheckError",
    "PlanCostReport",
    "RecompileHazard",
    "SegmentCost",
    "Severity",
    "ThreadAnalysis",
    "ThreadModel",
    "analyze_files",
    "analyze_scoring_plan",
    "analyze_source",
    "analyze_transform",
    "analyze_transform_plan",
    "build_corpus",
    "check_ir_corpus",
    "check_plan_cost",
    "cost_diagnostics",
    "diff_corpus",
    "diff_snapshots",
    "load_corpus",
    "make_diagnostic",
    "save_corpus",
    "snapshot_program",
    "snapshot_scoring_plan",
    "snapshot_transform_plan",
    "trace_cost",
]
