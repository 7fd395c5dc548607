"""Typed diagnostics (the port's copy of
``transmogrifai_tpu/checkers/diagnostics.py``).

Validators report findings as :class:`Diagnostic` objects with stable
codes, so tooling matches on codes instead of message text.  The code table
is the reference's whole table; the port emits these families so far:

- ``TM101`` — a cyclic feature graph (:class:`DagCycleError`, raised by
  ``workflow/dag.py::compute_dag``);
- ``TM5xx`` — servability and the serving fleet: unfitted estimators
  (TM501), host round-trips and data-dependent widths (TM502/TM503), the
  planner split (TM504), the fault-tolerance configuration (TM505/TM506),
  swap admission (TM507/TM508), fleet device-memory admission (TM509) and
  reduced-precision calibration parity (TM511), ``serve/validator.py``;
  refused deploy artifacts (TM510), ``deploy/bundle.py``;
- ``TM601`` — a plan whose static peak device-memory estimate exceeds its
  budget (``checkers/plancheck.py``);
- ``TM8xx`` — continual training (``workflow/continual.py``) and training
  resilience (``workflow/resilience.py``);
- ``TM902`` / ``TM903`` — SLO error-budget burn and exhaustion
  (``obs/slo.py``).

The entries for TM508, TM510, TM809 and TM821 carry the port's fix hints: it
compiles no XLA program and has no mesh.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


class Severity(enum.IntEnum):
    """Ordered so gates can threshold (``sev >= Severity.WARNING``)."""

    INFO = 10
    WARNING = 20
    ERROR = 30

    def __str__(self) -> str:  # "error", not "Severity.ERROR", in CLI output
        return self.name.lower()


#: code -> (default severity, short title, default fix hint)
DIAGNOSTIC_CODES: Dict[str, Tuple[Severity, str, str]] = {
    # -- structural ---------------------------------------------------------
    "TM101": (Severity.ERROR, "cycle in feature DAG",
              "break the cycle: a stage's inputs must not depend, transitively, "
              "on its own output (check manual rewiring of _input_features)"),
    "TM102": (Severity.ERROR, "duplicate stage uid",
              "give each stage a unique uid; shared uids make scoring substitute "
              "one fitted model for every stage with that uid"),
    "TM103": (Severity.ERROR, "orphaned stage wiring",
              "the stage was re-wired after this feature was created; rebuild the "
              "feature via stage.get_output() so the DAG matches what will run"),
    "TM104": (Severity.WARNING, "duplicate raw feature name",
              "two distinct generator stages emit the same column name and will "
              "silently read the same input column; rename one of them"),
    "TM105": (Severity.ERROR, "multiple ModelSelectors",
              "a workflow may contain at most one ModelSelector; split into "
              "separate workflows or combine the model grids into one selector"),
    "TM106": (Severity.WARNING, "stage not serde round-trippable",
              "use module-level functions (or @register_function) for stage "
              "callables and keep the class importable under its own name so "
              "save/load can reconstruct it from STAGE_REGISTRY"),
    # -- type & shape -------------------------------------------------------
    "TM201": (Severity.ERROR, "input arity mismatch",
              "wire the stage with set_input() using the declared number of "
              "input features"),
    "TM202": (Severity.ERROR, "input feature type mismatch",
              "convert the feature to the declared input type (e.g. via a "
              "vectorizer or map/cast stage) before this stage"),
    "TM203": (Severity.ERROR, "output feature type mismatch",
              "the feature's declared type no longer matches what the stage "
              "will produce; re-derive the output via stage.get_output() after "
              "changing stage params"),
    "TM204": (Severity.ERROR, "device shape/dtype error",
              "the stage's device transform fails shape/dtype checking under "
              "jax.eval_shape; fix operand shapes/dtypes before launching a "
              "device job"),
    # -- JAX hazards (AST lint) ---------------------------------------------
    "TM301": (Severity.WARNING, "host sync on device value",
              "item()/float()/np.asarray on a jax value forces a device->host "
              "transfer and blocks dispatch; keep the computation in jnp and "
              "fetch once at the end"),
    "TM302": (Severity.WARNING, "Python loop over rows",
              "a per-row Python loop defeats columnar vectorization; rewrite "
              "with vectorized numpy/jnp operations over the whole column"),
    "TM303": (Severity.WARNING, "jax.jit inside hot path",
              "jit-compiling inside transform/fit re-traces on every call; "
              "move the jitted function to module level"),
    "TM304": (Severity.WARNING, "jit recompilation hazard",
              "a jit-decorated closure defined inside the function creates a "
              "fresh cache entry per call; hoist it to module level so the "
              "compiled program is reused"),
    "TM305": (Severity.ERROR, "unparseable source file",
              "fix the syntax error (or exclude the file from the lint path); "
              "an unparseable file cannot be checked and must not silently "
              "mask findings elsewhere"),
    "TM306": (Severity.WARNING, "unsynchronized module-level mutable state",
              "a module-level dict/list is mutated inside a function without "
              "holding a threading lock; concurrent scorers/trainers race on "
              "it — wrap the mutation in `with <lock>:`, or mark a "
              "single-threaded-by-design site with an inline opcheck "
              "allow marker for TM306"),
    # -- concurrency (TM31x threadcheck analyzer, cli lint --threads) --------
    "TM311": (Severity.ERROR, "inconsistent lockset on shared attribute",
              "the attribute is accessed both under and outside its inferred "
              "guard lock; hoist the unguarded access into `with <lock>:` "
              "(or justify a benign pattern like double-checked locking with "
              "an inline opcheck allow marker for TM311)"),
    "TM312": (Severity.ERROR, "unlocked read-modify-write on shared state",
              "a `+=`/in-place mutation of a thread-shared attribute or "
              "module global holds no lock, so concurrent updates lose "
              "increments; wrap the read-modify-write in `with <lock>:`"),
    "TM313": (Severity.ERROR, "lock-order cycle (potential deadlock)",
              "two lock acquisitions nest in opposite orders on different "
              "call paths; pick one global order (or collapse to a single "
              "lock) so no cycle remains in the acquired-while-held graph"),
    "TM314": (Severity.WARNING, "torn multi-field read of guarded state",
              "a single statement reads several attributes that writers "
              "update together under a lock; take the same lock around the "
              "multi-field read so it cannot observe a half-applied update"),
    "TM315": (Severity.WARNING, "blocking call under a held lock",
              "a potentially unbounded wait (queue get/put, Thread.join, "
              "future.result, Condition.wait on a different lock, device "
              "sync) runs while holding a lock, stalling every other "
              "acquirer; move the wait outside the `with` block"),
    # -- servability (serving path, opt-in via validate(serving=True)) ------
    "TM501": (Severity.ERROR, "unfitted estimator in scoring path",
              "train the workflow (or warm-start the missing stage) before "
              "building a scoring plan; an estimator without a fitted model "
              "cannot transform at request time"),
    "TM502": (Severity.WARNING, "host stage forces a device round-trip",
              "the stage sits between device-capable stages but has no "
              "device_transform, so the fused scoring prefix must stop, copy "
              "to host, and re-upload; implement device_transform (plus "
              "encode_device_input for host-kind inputs) to keep the prefix "
              "fused"),
    "TM503": (Severity.WARNING, "unbounded feature shape breaks bucketing",
              "the feature's device width is only known from the data (e.g. "
              "a raw OPVector column), so padding buckets cannot amortize "
              "compilation — every new width recompiles; fix the width "
              "upstream (declare/enforce a constant vector width) or keep "
              "its consumers on the host path"),
    "TM504": (Severity.INFO, "fused transform planner split",
              "informational: how the transform planner partitions this DAG "
              "into the jit-fused device prefix and the per-stage host "
              "remainder; widen the prefix by implementing device_transform "
              "on the listed host stages"),
    "TM505": (Severity.ERROR, "invalid fault-tolerance configuration",
              "fix the serving resilience parameters: retry counts must be "
              ">= 0, backoff seconds > 0, breaker failure_threshold and "
              "recovery_batches >= 1, and the dead-letter hook (if set) "
              "must be callable"),
    "TM506": (Severity.WARNING, "deadline tighter than the batch flush wait",
              "the default request deadline is not longer than the "
              "batcher's max_wait_ms, so every request that waits for a "
              "full flush window expires in the queue and is evicted "
              "unscored; raise the deadline or lower max_wait_ms"),
    "TM507": (Severity.ERROR, "candidate model incompatible with serving schema",
              "the staged candidate does not serve the same result feature "
              "names as the active model; a swap would silently change the "
              "response schema under live clients — refit the same workflow "
              "(same result features) or deploy as a new server instead"),
    "TM508": (Severity.INFO, "blue/green swap compiles a fresh prefix",
              "the candidate's prefix fingerprint differs from the active "
              "plan's, so the swap cannot share the active plan's prefix "
              "(a warm refit that froze the prep stages would); the swap is "
              "still atomic, but the candidate sets up its own buckets"),
    "TM509": (Severity.ERROR, "fleet HBM admission refused",
              "the multi-tenant registry cannot admit this model: the sum "
              "of static peak-HBM estimates across resident warm "
              "executables plus the candidate exceeds the fleet hbm_budget "
              "even after evicting every cold tenant's buckets (LRU by "
              "last-scored); raise hbm_budget, shrink the bucket ladder "
              "(max_bucket), or unregister tenants"),
    "TM510": (Severity.ERROR, "deploy artifact refused",
              "the packed serving artifact is stale, tampered or foreign — "
              "truncated/hash-mismatched object bytes (a kernel library "
              "included), a manifest whose plan content fingerprint no "
              "longer matches the live model, an IR-corpus fingerprint that "
              "drifted since pack time, an artifact another package packed, "
              "or a kernel library built by a CUDA toolkit newer than the "
              "driver — and is "
              "REFUSED, never loaded (fail-closed, like TM606); serving "
              "falls back to a live build, so re-pack the bundle (`cli "
              "deploy pack`) from the current model and environment"),
    "TM511": (Severity.ERROR, "reduced-precision plan fails calibration parity",
              "the bf16/int8 scoring-prefix plan's max prediction delta vs "
              "the same model's f32 plan over the calibration batch exceeds "
              "the precision class's documented bound (serve/plan.py "
              "TM511_BOUNDS); the registry refuses the plan fail-closed — "
              "serve the model at f32, pick the wider class, or fix the "
              "numerically unstable stage the delta points at"),
    # -- plan cost (jaxpr-level static analysis, checkers/plancheck.py) -----
    "TM601": (Severity.ERROR, "plan exceeds the HBM budget",
              "the fused program's peak live-buffer estimate at its largest "
              "row bucket exceeds the configured device budget; shrink the "
              "bucket ladder (max_bucket), narrow the feature vector, or "
              "raise hbm_budget if the device really has the headroom"),
    "TM602": (Severity.WARNING, "recompile hazard: shape outside the bucket ladder",
              "an input shape is only known from the data (e.g. a raw "
              "OPVector width), so the pow2/8192 row-bucket ladder cannot "
              "amortize it — every new shape compiles a fresh executable; "
              "declare/enforce a static width upstream or keep the consumer "
              "on the host path"),
    "TM603": (Severity.ERROR, "collective in a single-host plan",
              "the plan contains cross-device collective/resharding ops but "
              "validate() was told the deployment is single-host; drop the "
              "sharding annotations (or validate without single_host=True "
              "and deploy on the mesh the plan was built for)"),
    "TM604": (Severity.INFO, "memory-bound fused segment",
              "the segment's arithmetic intensity (FLOPs per HBM byte) is "
              "below the threshold, so it is bandwidth-bound on any "
              "accelerator — a candidate for the Pallas fused-kernel "
              "worklist (see ROADMAP: tree hot loops)"),
    "TM606": (Severity.ERROR, "budget gate armed but plan cost unavailable",
              "an hbm_budget/single_host contract was requested but the "
              "fused-prefix cost cannot be computed (unfitted estimators in "
              "the DAG); a gate that silently passed here would admit "
              "anything — train the workflow (or validate the fitted "
              "WorkflowModel) so the admission check can actually run"),
    "TM607": (Severity.ERROR, "host-DRAM residency exceeds the budget",
              "the plan's materialized host working set (estimator-input "
              "columns at the stated row count, plus chunk ingest buffers) "
              "exceeds the armed host_budget even in chunked out-of-core "
              "mode; raise host_budget, narrow the feature vector, or "
              "reduce rows — spilling cannot shrink a working set the fit "
              "itself must assemble"),
    "TM608": (Severity.WARNING, "collective volume scales with global rows",
              "the plan's per-step cross-device collective volume grows "
              "proportionally with the row bucket (a replicated pin or "
              "all-gather of a row-shaped operand), so adding hosts adds "
              "DCN traffic instead of removing work — the program won't "
              "scale past one host; keep row operands pinned to the data "
              "axis (parallel/mesh.py:constrain_rows) so collectives carry "
              "only per-feature statistics, and replicate only (d,)-sized "
              "blocks"),
    "TM609": (Severity.WARNING, "replicated operands exceed per-host HBM share",
              "operands replicated on every host (baked constants / "
              "fully-replicated pins) exceed the per-host share of the armed "
              "hbm_budget; replication cannot be sharded away by adding "
              "hosts, so the plan stops scaling when one host's copy no "
              "longer fits — shard the operand over the data/model axis or "
              "shrink the baked state"),
    "TM605": (Severity.WARNING, "layout/order-dependent numerics",
              "the plan contains ops whose floating-point result depends on "
              "reduction order or data layout (float sort keys, "
              "accumulations under a sharded mesh); bitwise parity across "
              "backends/meshes is not guaranteed — pin the layout (e.g. "
              "C-contiguous blocks, replicated metric inputs) where parity "
              "matters"),
    # -- IR corpus (StableHLO golden differ, checkers/irsnap.py) ------------
    "TM700": (Severity.INFO, "IR corpus membership drift",
              "a program family appeared without a golden snapshot (or a "
              "golden family is no longer emitted); review the change and "
              "refresh the corpus with `cli lint --ir --update-goldens`"),
    "TM701": (Severity.INFO, "benign IR text drift",
              "the canonical StableHLO text changed but every semantic "
              "feature (op histogram, dtypes, collectives, sort signatures) "
              "is identical — typically an MLIR printer or metadata change; "
              "refresh the corpus at leisure"),
    "TM702": (Severity.WARNING, "IR fusion/layout change",
              "the op histogram of a lowered program shifted (ops "
              "added/removed/recounted); performance and fusion structure "
              "drifted — re-run the bench sections covering this family "
              "before re-goldening"),
    "TM703": (Severity.WARNING, "IR collective/resharding drift",
              "cross-device collective or resharding ops were added or "
              "removed from a lowered program; communication volume and "
              "reduction-order numerics moved — validate mesh parity "
              "(test_use_mesh) before re-goldening"),
    "TM704": (Severity.ERROR, "IR dtype/widening drift",
              "the element-type inventory of a lowered program changed "
              "(a dtype appeared/vanished, or tensor counts migrated "
              "between float widths); numeric precision semantics shifted "
              "silently — audit the kernel (or the jax upgrade notes) "
              "before re-goldening"),
    "TM705": (Severity.ERROR, "sharded-sort-dim miscompile hazard",
              "a sort op's sort dimension is sharded while its batch "
              "dimensions stay replicated — the exact GSPMD pattern that "
              "miscompiled the eval sweeps (metrics near -n, no error) "
              "before PR 4 pinned metric inputs to replicated; replicate "
              "the sort operand (models/base.py:_replicator) or shard a "
              "batch dimension instead"),
    # -- continual training (drift-gated warm refit, workflow/continual.py) --
    "TM801": (Severity.WARNING, "covariate drift: PSI beyond threshold",
              "the streamed distribution of this feature diverged from its "
              "train-time snapshot (population stability index over the "
              "snapshot's quantile bins); the serving model was fitted on a "
              "population that no longer matches live traffic — let the "
              "refit controller retrain, or raise psi_threshold if this "
              "feature is expected to wander"),
    "TM802": (Severity.WARNING, "feature mean shift beyond z threshold",
              "the streamed mean of this feature sits more than z_threshold "
              "standard errors from its train-time mean (two-sample z over "
              "the snapshot moments); investigate an upstream pipeline "
              "change, or let the refit controller retrain"),
    "TM803": (Severity.WARNING, "missing-rate shift beyond threshold",
              "the fraction of missing values in this feature moved beyond "
              "missing_shift from its train-time rate — often an upstream "
              "extraction outage rather than real drift; check the producer "
              "before trusting a refit on the degraded window"),
    "TM804": (Severity.INFO, "insufficient streamed rows for drift evaluation",
              "fewer than min_records rows observed since the last refit "
              "anchor; drift statistics at this sample size would fire on "
              "noise, so the evaluation is deferred — stream more data or "
              "lower min_records"),
    "TM805": (Severity.ERROR, "warm refit failed; serving model unchanged",
              "every bounded retry of the drift-triggered refit failed; the "
              "server keeps the last-known-good model and the stream keeps "
              "scoring — inspect the attached cause, then retrigger by "
              "streaming more drifted data or refitting manually"),
    "TM806": (Severity.WARNING, "shadow gate failed; candidate not promoted",
              "the candidate model's mirrored-traffic scores violated the "
              "promotion gate (shadow failures, non-finite or oversized "
              "prediction deltas, or a metric regression); the candidate "
              "was discarded and the active model keeps serving — loosen "
              "max_prediction_delta only if the delta is the expected "
              "consequence of real drift"),
    "TM807": (Severity.INFO, "model swap committed",
              "informational: the candidate passed the shadow gate and an "
              "atomic blue/green swap made it the active serving model; "
              "the previous model is retained for rollback through the "
              "probation window"),
    "TM808": (Severity.WARNING, "post-swap rollback to last-known-good",
              "the promoted model tripped its circuit breaker inside the "
              "probation window and the server rolled back to the retained "
              "last-known-good model; treat the candidate as bad — inspect "
              "its refit window before promoting again"),
    "TM809": (Severity.WARNING, "warm refit recompiled the transform prefix",
              "the refit was expected to reuse the built kernel libraries "
              "and the frozen prefix (frozen prep stages) but kernel builds "
              "or library loads were observed "
              "(perf/timers.py::measure_compiles); check that the prep "
              "stages are really frozen"),
    # -- training resilience (workflow/resilience.py) -----------------------
    "TM820": (Severity.INFO, "retryable training fault; retrying",
              "a transient training-path failure (chunk read, prefetch, "
              "stage fit, sweep dispatch, device sync) was retried with "
              "bounded exponential backoff + jitter; informational unless "
              "it recurs — persistent retries escalate to a degradation "
              "ladder (TM821/TM822) or exhaust into the original error"),
    "TM821": (Severity.WARNING, "training degraded to a shrunk device mesh",
              "a device fault persisted through every in-place retry under "
              "a mesh, so the sweep re-dispatched with the data axis halved; "
              "the run completes at reduced parallelism — investigate the "
              "failing devices before the next full-mesh run (the port has "
              "no mesh yet, so it never emits this code)"),
    "TM822": (Severity.WARNING, "sweep degraded to a smaller row bucket",
              "repeated resource exhaustion (OOM) made the dispatched row "
              "bucket infeasible, so the sweep retried on the next-smaller "
              "power-of-two row cap; CV metrics for the degraded block are "
              "computed on the capped rows — lower hbm pressure (smaller "
              "chunk/bucket, fewer grids per dispatch) to avoid the cap"),
    "TM823": (Severity.ERROR, "training failed fast on a non-retryable "
              "error",
              "a non-retryable error (bad input, poison payload, programming "
              "error) surfaced inside a resilient training run; it was NOT "
              "retried — the sweep journal keeps every completed "
              "(family, fold-block) so a fixed re-run resumes past them "
              "(train(resume=...) / cli train --resume)"),
    # -- telemetry (flight recorder, obs/flight.py) -------------------------
    "TM901": (Severity.WARNING, "unexpected backend recompile in warm path",
              "a backend compilation fired inside a path declared warm (a "
              "warmed serving plan or a frozen-prep refit) — the plan/"
              "executable caches were expected to serve it at zero "
              "compiles; check the flight-recorder compile event's site + "
              "fingerprint against the TM602 static recompile-hazard map "
              "(an unkeyed shape/static, a cache eviction, or prep that is "
              "not actually frozen)"),
    "TM902": (Severity.WARNING, "SLO error budget burning too fast",
              "the tenant's bad-event ratio (shed + deadline-expired + "
              "failed vs completed) over the burn lookback window exceeds "
              "the sustainable rate for its SLO class; at this rate the "
              "window budget exhausts well before the window ends — shed "
              "upstream load, raise the tenant's class, or add capacity "
              "before TM903 fires (obs/slo.py, docs/observability.md)"),
    "TM903": (Severity.ERROR, "SLO error budget exhausted",
              "the tenant consumed its whole error budget for the current "
              "window; when shed-tier escalation is armed "
              "(FleetServer.arm_slo_monitor) the tenant is degraded so it "
              "absorbs further shedding cuts instead of tenants still "
              "inside budget — it re-arms automatically once the budget "
              "recovers past the re-arm threshold"),
    # -- leakage ------------------------------------------------------------
    "TM401": (Severity.ERROR, "label leaks into feature path",
              "a response(-derived) feature reaches the model's feature input "
              "through a non-label slot; remove it from the predictor set"),
    "TM402": (Severity.INFO, "label-dependent fit outside CV folds",
              "label-dependent estimators upstream of the ModelSelector fit "
              "once on all rows, so their fit leaks validation labels into the "
              "CV estimate; use Workflow.with_workflow_cv() to re-fit them "
              "inside every fold"),
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code + severity + location + actionable fix hint."""

    code: str
    severity: Severity
    message: str
    stage_uid: Optional[str] = None
    location: Optional[str] = None  # "file.py:123" for AST-lint findings
    fix_hint: str = ""

    @property
    def title(self) -> str:
        return DIAGNOSTIC_CODES[self.code][1] if self.code in DIAGNOSTIC_CODES \
            else self.code

    def pretty(self) -> str:
        where = self.stage_uid or self.location or "<workflow>"
        lines = [f"{self.code} [{self.severity}] {where}: {self.message}"]
        if self.fix_hint:
            lines.append(f"       fix: {self.fix_hint}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "severity": str(self.severity),
            "stageUid": self.stage_uid,
            "location": self.location,
            "message": self.message,
            "fixHint": self.fix_hint,
        }


def make_diagnostic(code: str, message: str, stage_uid: Optional[str] = None,
                    location: Optional[str] = None,
                    severity: Optional[Severity] = None,
                    fix_hint: Optional[str] = None) -> Diagnostic:
    """Build a Diagnostic, filling severity/fix hint from the code table."""
    default_sev, _title, default_hint = DIAGNOSTIC_CODES.get(
        code, (Severity.WARNING, code, ""))
    return Diagnostic(
        code=code,
        severity=default_sev if severity is None else severity,
        message=message,
        stage_uid=stage_uid,
        location=location,
        fix_hint=default_hint if fix_hint is None else fix_hint,
    )


@dataclass
class DiagnosticReport:
    """Ordered collection of diagnostics with severity filters and rendering."""

    diagnostics: List[Diagnostic] = field(default_factory=list)
    #: PlanCostReport attached by the TM6xx cost analyzers (validate(cost=True)
    #: / ``cli lint --cost``); None when the cost pass did not run
    plan_cost: Optional[object] = None
    #: HostResidencyReport attached by the TM607 residency analyzer
    #: (validate(host_budget=...) / ``cli lint --cost --host-budget``)
    host_residency: Optional[object] = None

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity >= Severity.ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.WARNING]

    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.INFO]

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def at_least(self, severity: Severity) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity >= severity]

    def pretty(self) -> str:
        if not self.diagnostics:
            return "opcheck: no issues found"
        counts = (f"{len(self.errors())} error(s), {len(self.warnings())} "
                  f"warning(s), {len(self.infos())} info")
        body = "\n".join(d.pretty() for d in self.diagnostics)
        return f"opcheck: {counts}\n{body}"

    def to_dicts(self) -> List[dict]:
        return [d.to_dict() for d in self.diagnostics]


class OpCheckError(ValueError):
    """Raised by the ``strict=True`` train gate on error-severity findings."""

    def __init__(self, report: DiagnosticReport):
        self.report = report
        errs = report.errors()
        super().__init__(
            f"workflow validation failed with {len(errs)} error(s):\n"
            + "\n".join(d.pretty() for d in errs))


class DagCycleError(ValueError):
    """Cyclic feature graph, carrying the TM101 diagnostic with the cycle path.

    Raised by workflow/dag.py:compute_dag instead of looping/recursing forever
    when a feature graph is cyclic.
    """

    def __init__(self, cycle_uids: List[str]):
        self.cycle_uids = list(cycle_uids)
        self.diagnostic = make_diagnostic(
            "TM101",
            "feature DAG contains a cycle through stages: "
            + " -> ".join(self.cycle_uids),
            stage_uid=self.cycle_uids[0] if self.cycle_uids else None,
        )
        super().__init__(f"[TM101] {self.diagnostic.message}")
