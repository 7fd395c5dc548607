"""``serve`` subcommand — drive the in-process scoring server from the CLI.

Counterpart of ``transmogrifai_tpu/cli/serve.py``.  Reference role: the
reference CLI's scoring entry points (CliExec.scala run types) combined
with the port's serving engine (``serve/``), on ``--device`` (default: the
card).
There is no HTTP or stdio protocol here — :class:`ScoringServer` is an
in-process API; this subcommand loads a saved model, replays a JSONL record
stream through the micro-batcher (every record goes through ``submit``, so
batching/backpressure/deadline/fault-isolation policies are exercised
exactly as a real embedding would), writes one JSON result per line, and
emits the merged plan + batcher + resilience counters as a final JSON
metrics object.

Robust replay: malformed JSONL lines are skipped-and-counted (stderr
warning, ``replay.skipped_malformed`` in the metrics) instead of crashing
the stream, and a record whose scoring fails (poison quarantine, expired
deadline, ...) emits an ``{"error": ..., "error_type": ...}`` output line in
its position — the replay finishes and exits nonzero instead of dying on
the first bad future.

Run::

    python -m transmogrifai_tpu_torch.cli serve --model ./model \\
        --records requests.jsonl --output scores.jsonl --metrics-out m.json
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Tuple


def add_serve_parser(sub) -> None:
    p = sub.add_parser(
        "serve", help="score a JSONL record stream through the micro-batched "
                      "in-process serving engine")
    p.add_argument("--model", default=None,
                   help="saved WorkflowModel directory (model.save(path))")
    p.add_argument("--models", default=None, metavar="DIR",
                   help="multi-tenant fleet replay (serve/registry.py): DIR "
                        "holds one saved model per subdirectory, the "
                        "subdirectory name is the tenant id; every input "
                        "record must carry a 'tenant' field (an optional "
                        "'slo' field overrides the tenant's class), both "
                        "stripped before scoring, and every output row "
                        "echoes the tenant column")
    p.add_argument("--hbm-budget", type=float, default=None,
                   help="fleet HBM admission budget in bytes (--models "
                        "mode): cold tenants' executables are evicted LRU "
                        "before a registration is refused with TM509")
    p.add_argument("--records", required=True,
                   help="JSONL file of records to score ('-' for stdin)")
    p.add_argument("--output", default="-",
                   help="JSONL results destination (default: stdout)")
    p.add_argument("--metrics-out", default=None,
                   help="write the metrics JSON here instead of stderr")
    p.add_argument("--max-batch", type=int, default=256,
                   help="flush-on-size threshold (default 256)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="flush-on-deadline for the oldest queued request "
                        "(default 2 ms)")
    p.add_argument("--max-queue", type=int, default=4096,
                   help="admission-control queue bound (default 4096)")
    p.add_argument("--min-bucket", type=int, default=8,
                   help="smallest power-of-two padding bucket (default 8)")
    p.add_argument("--no-warm", action="store_true",
                   help="skip ahead-of-time bucket compilation")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request deadline enforced in the batch queue "
                        "(expired requests are evicted unscored)")
    p.add_argument("--no-resilience", action="store_true",
                   help="disable the fault-tolerance layer (quarantine, "
                        "retry, circuit breaker); one bad record then fails "
                        "its whole co-batch")
    # -- streaming follow / continual refit mode (workflow/continual.py) ----
    p.add_argument("--follow", action="store_true",
                   help="tail --records as a live JSONL stream through the "
                        "micro-batch streaming reader (offset-checkpointed, "
                        "at-least-once) instead of a one-shot replay")
    p.add_argument("--offsets", default=None,
                   help="offset checkpoint JSON path (follow mode); resume "
                        "lands exactly after the last committed batch")
    p.add_argument("--batch-interval", type=float, default=0.5,
                   help="follow-mode micro-batch tick seconds (default 0.5)")
    p.add_argument("--max-batch-records", type=int, default=1024,
                   help="follow-mode per-tick record ceiling (default 1024)")
    p.add_argument("--max-empty-polls", type=int, default=None,
                   help="stop after this many consecutive empty ticks "
                        "(default: tail forever)")
    p.add_argument("--refit", action="store_true",
                   help="enable the drift-gated continual retrain loop "
                        "(labeled stream required): drift fires a warm "
                        "refit, the candidate shadow-scores mirrored "
                        "traffic, and promotion is an atomic model swap "
                        "with post-swap rollback")
    p.add_argument("--baseline", default=None,
                   help="train-time TrainingSnapshot JSON for the drift "
                        "baseline; omitted, the baseline bootstraps from "
                        "the head of the stream")
    p.add_argument("--drift-psi", type=float, default=0.25,
                   help="PSI threshold per feature (default 0.25)")
    p.add_argument("--drift-min-records", type=int, default=200,
                   help="rows required before a drift evaluation counts")
    p.add_argument("--window-records", type=int, default=512,
                   help="labeled-record window a warm refit trains on")
    p.add_argument("--shadow-records", type=int, default=64,
                   help="mirrored records required before the promotion "
                        "gate evaluates")
    p.add_argument("--probation-batches", type=int, default=8,
                   help="post-swap batches during which a breaker trip "
                        "auto-rolls back")
    p.add_argument("--checkpoint-dir", default=None,
                   help="atomic model checkpoint directory for promoted "
                        "refits (CURRENT pointer names last-known-good)")
    # -- unified telemetry (obs/) -------------------------------------------
    p.add_argument("--telemetry", default=None, metavar="DIR",
                   help="enable the obs telemetry backbone and write "
                        "trace.json (Chrome trace, Perfetto-loadable), "
                        "flight.json (flight-recorder dump), metrics.jsonl "
                        "and metrics.prom under DIR on exit (default: the "
                        "TMOG_TELEMETRY env var; unset = telemetry off)")
    p.add_argument("--trace-detail", default="batch",
                   choices=("batch", "requests"),
                   help="trace granularity on the serve path: per-batch "
                        "spans (default) or additionally one instant event "
                        "per enqueued request")
    p.add_argument("--snapshot-interval", type=float, default=None,
                   metavar="SECONDS",
                   help="follow mode: emit a metrics-snapshot JSONL line at "
                        "least this many seconds apart (0 = every batch) "
                        "alongside the scores; scoring output and offset "
                        "commits are unaffected")
    p.add_argument("--snapshots-out", default=None,
                   help="destination for the periodic metrics-snapshot "
                        "JSONL lines (default: metrics.jsonl in the "
                        "--telemetry dir, else stderr)")
    p.add_argument("--statusz-out", default=None, metavar="FILE",
                   help="--models mode: append FleetServer.statusz() JSONL "
                        "lines (per-tenant rps/p99/budget/breaker/HBM) "
                        "here during the replay — the `cli top` console's "
                        "data source")
    p.add_argument("--statusz-interval", type=float, default=1.0,
                   help="minimum seconds between statusz lines "
                        "(default 1.0; a final line always lands)")
    p.add_argument("--device", default=None,
                   help="device the server, the fleet and a refit run on "
                        "(default: the card)")


def _read_records(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """(records, skipped_malformed).  Bad JSONL lines are skipped-and-counted
    (a poisoned replay file must not kill the whole replay); only an
    entirely empty stream aborts."""
    fh = sys.stdin if path == "-" else open(path)
    records: List[Dict[str, Any]] = []
    skipped = 0
    try:
        for lineno, line in enumerate(fh, 1):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                skipped += 1
                print(f"serve: skipping malformed JSONL line {lineno}: {e}",
                      file=sys.stderr)
    finally:
        if fh is not sys.stdin:
            fh.close()
    if not records:
        raise SystemExit(f"serve: no records in {path!r}")
    return records, skipped


def _resolve(future) -> Tuple[Dict[str, Any], bool]:
    """(output row, ok): a failed future becomes an error row in the record's
    position instead of killing the replay."""
    try:
        return future.result(), True
    except Exception as e:  # noqa: BLE001 — every failure becomes a row
        return {"error": str(e), "error_type": type(e).__name__}, False


def _write_replay_outputs(ns, results, metrics) -> None:
    """One-shot replay epilogue shared by the single-model and fleet
    paths: the JSONL result rows, then the metrics blob to --metrics-out
    (or stderr)."""
    out = sys.stdout if ns.output == "-" else open(ns.output, "w")
    try:
        for r in results:
            out.write(json.dumps(r) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    blob = json.dumps(metrics, indent=2, default=str)
    if ns.metrics_out:
        with open(ns.metrics_out, "w") as fh:
            fh.write(blob + "\n")
    else:
        print(blob, file=sys.stderr)


def _resolve_cli_telemetry(ns):
    """The CLI's Telemetry bundle (or None): --telemetry DIR wins, else the
    TMOG_TELEMETRY env var — BOTH honor --trace-detail."""
    import os

    from ..obs import TELEMETRY_ENV, Telemetry, telemetry_active

    out_dir = ns.telemetry or os.environ.get(TELEMETRY_ENV, "")
    if not out_dir or (not ns.telemetry and telemetry_active()):
        return None  # off, or an outer session already owns telemetry
    return Telemetry(out_dir=out_dir,
                     detail=getattr(ns, "trace_detail", "batch"))


def _run_follow(ns, model) -> int:
    """Follow mode: drive the micro-batch streaming reader end-to-end —
    tail the JSONL file, score every batch through the server, write one
    JSON row per record, commit offsets AFTER the rows are written, and
    (with ``--refit``) run the drift-gated continual retrain loop.

    Observability: ``--snapshot-interval`` emits a periodic metrics-snapshot
    JSONL line (canonical registry names + stream progress) to
    ``--snapshots-out`` / the telemetry dir / stderr — a long-running loop
    is inspectable without disturbing scores or offsets."""
    from ..readers import (JsonlTailSource, MicroBatchStreamingReader,
                           OffsetCheckpoint)
    from ..serve import ScoringServer
    from ..workflow.continual import (ContinualTrainer, DriftDetector,
                                      PromotionGate, RefitController,
                                      TrainingSnapshot)

    if ns.records == "-":
        raise SystemExit("serve: --follow needs a tailable file, not stdin")
    # skip_malformed: a poison line at the committed offset must not wedge
    # the long-running follow loop (mirrors the one-shot replay's
    # skip-and-count contract)
    source = JsonlTailSource(ns.records, skip_malformed=True)
    reader = MicroBatchStreamingReader(
        source,
        checkpoint=OffsetCheckpoint(ns.offsets) if ns.offsets else None,
        batch_interval=ns.batch_interval,
        max_batch_records=ns.max_batch_records,
        max_empty_polls=ns.max_empty_polls)

    # APPEND, never truncate: committed offsets mean a resumed follow run
    # skips already-scored records — truncating would permanently lose
    # their output rows despite the at-least-once offset contract
    out = sys.stdout if ns.output == "-" else open(ns.output, "a")
    errors = 0

    tel = _resolve_cli_telemetry(ns)

    # periodic metrics-snapshot stream: its own sink (never the scores file)
    snap_fh = None
    snap_close = False
    if ns.snapshot_interval is not None:
        if ns.snapshots_out:
            snap_fh, snap_close = open(ns.snapshots_out, "a"), True
        elif tel is not None and tel.out_dir:
            import os as _os

            _os.makedirs(tel.out_dir, exist_ok=True)
            snap_fh = open(_os.path.join(tel.out_dir, "metrics.jsonl"), "a")
            snap_close = True
        else:
            snap_fh = sys.stderr
    snap_state = {"last": 0.0, "server": None, "trainer": None, "lines": 0}

    def _maybe_snapshot():
        import time as _time

        now = _time.monotonic()
        if now - snap_state["last"] < (ns.snapshot_interval or 0.0):
            return
        snap_state["last"] = now
        server = snap_state["server"]
        trainer = snap_state["trainer"]
        if server is None:
            return
        extra = {"type": "metrics_snapshot"}
        if trainer is not None:
            extra["continual"] = trainer.counters
        # one serializer for the snapshot line format (obs/metrics.py)
        server.registry.write_jsonl(snap_fh, extra=extra)
        snap_fh.flush()
        snap_state["lines"] += 1

    def on_batch(_records, results):
        nonlocal errors
        for r in results:
            if isinstance(r, dict) and "error_type" in r:
                errors += 1
            out.write(json.dumps(r, default=str) + "\n")
        out.flush()
        if snap_fh is not None:
            _maybe_snapshot()

    detector = None
    if ns.baseline:
        detector = DriftDetector(TrainingSnapshot.load(ns.baseline),
                                 psi_threshold=ns.drift_psi,
                                 min_records=ns.drift_min_records)
    refit = RefitController(model, checkpoint_dir=ns.checkpoint_dir,
                            device=ns.device) if ns.refit else None
    metrics: Dict[str, Any] = {}
    prom = None
    try:
        if tel is not None:
            tel.start()
        with ScoringServer(model, max_batch=ns.max_batch,
                           max_wait_ms=ns.max_wait_ms,
                           max_queue=ns.max_queue, min_bucket=ns.min_bucket,
                           warm=not ns.no_warm,
                           resilience=not ns.no_resilience,
                           deadline_ms=ns.deadline_ms,
                           device=ns.device) as server:
            snap_state["server"] = server
            trainer = ContinualTrainer(
                server, model, reader,
                detector=detector,
                refit=refit,
                gate=PromotionGate(min_shadow_records=ns.shadow_records),
                window_records=ns.window_records,
                bootstrap_records=max(ns.drift_min_records, 1),
                probation_batches=ns.probation_batches,
                drift_params={"psi_threshold": ns.drift_psi,
                              "min_records": ns.drift_min_records},
                on_batch=on_batch,
                # --refit off: the loop still streams, scores, commits, and
                # tracks drift statistics — it just never retrains
                refit_enabled=ns.refit)
            snap_state["trainer"] = trainer
            metrics = trainer.run()
            metrics["server"] = server.metrics()
            metrics["skipped_malformed"] = source.skipped_malformed
            metrics["metrics_snapshots_emitted"] = snap_state["lines"]
            prom = server.prometheus()
    finally:
        # dump INSIDE the finally: a crashed follow loop is exactly when
        # the flight-recorder postmortem matters most
        if tel is not None:
            tel.stop()
            tel.dump(metrics_payload={"source": "cli serve --follow",
                                      "metrics": metrics},
                     prometheus=prom)
        if out is not sys.stdout:
            out.close()
        if snap_close and snap_fh is not None:
            snap_fh.close()
    blob = json.dumps(metrics, indent=2, default=str)
    if ns.metrics_out:
        with open(ns.metrics_out, "w") as fh:
            fh.write(blob + "\n")
    else:
        print(blob, file=sys.stderr)
    return 0 if errors == 0 else 1


def _run_fleet(ns) -> int:
    """Multi-tenant replay (``--models DIR``): every subdirectory of DIR is
    one tenant's saved model; records route by their ``tenant`` column
    through the shared SLO-tiered micro-batcher and each output row echoes
    the tenant back — the JSONL in/out contract stays line-per-record.

    A record without a (known) tenant becomes an error row in its position;
    the replay finishes and exits nonzero, mirroring the single-model
    hardening contract."""
    import os

    from ..serve import FleetServer, QueueFullError, UnknownTenantError
    from ..workflow.workflow import WorkflowModel

    tenant_dirs = sorted(
        d for d in os.listdir(ns.models)
        if os.path.isdir(os.path.join(ns.models, d)))
    if not tenant_dirs:
        raise SystemExit(f"serve: no model subdirectories in {ns.models!r}")
    records, skipped = _read_records(ns.records)

    from collections import deque

    errors = 0
    tel = _resolve_cli_telemetry(ns)
    metrics: Dict[str, Any] = {}
    prom = None
    results: List[Dict[str, Any]] = []
    # statusz stream (cli top's data source): append-only, time-gated, its
    # own sink — never the scores file
    statusz_fh = open(ns.statusz_out, "a") if ns.statusz_out else None
    statusz_state = {"last": 0.0, "lines": 0}

    def _maybe_statusz(fleet, force=False):
        if statusz_fh is None:
            return
        import time as _time

        now = _time.monotonic()
        if not force and now - statusz_state["last"] < ns.statusz_interval:
            return
        statusz_state["last"] = now
        statusz_fh.write(json.dumps(fleet.statusz(), sort_keys=True,
                                    default=str) + "\n")
        statusz_fh.flush()
        statusz_state["lines"] += 1

    try:
        if tel is not None:
            tel.start()
        with FleetServer(max_batch=ns.max_batch, max_wait_ms=ns.max_wait_ms,
                         max_queue=ns.max_queue, min_bucket=ns.min_bucket,
                         resilience=not ns.no_resilience,
                         deadline_ms=ns.deadline_ms,
                         hbm_budget=ns.hbm_budget,
                         device=ns.device) as fleet:
            # the burn-rate monitor rides every fleet replay: statusz
            # polls it, so budget/burn columns are live in `cli top`
            fleet.arm_slo_monitor()
            for tenant in tenant_dirs:
                fleet.register(
                    tenant,
                    WorkflowModel.load(os.path.join(ns.models, tenant)),
                    warm=not ns.no_warm)

            def resolve(tenant, future):
                # a submit-time refusal is already row-shaped; output rows
                # stay in input order either way
                if isinstance(future, dict):
                    return future, False
                row, ok = _resolve(future)
                return {"tenant": tenant, **row}, ok

            futures: deque = deque()
            for r in records:
                r = dict(r)
                tenant = r.pop("tenant", None)
                slo = r.pop("slo", None)
                try:
                    while True:
                        try:
                            futures.append(
                                (tenant, fleet.submit(tenant, r, slo=slo)))
                            break
                        except QueueFullError:
                            # backpressure: wait out the oldest in-flight
                            # request (shed futures resolve here too)
                            row, ok = resolve(*futures.popleft())
                            errors += not ok
                            results.append(row)
                except (UnknownTenantError, ValueError) as e:
                    futures.append((tenant,
                                    {"tenant": tenant, "error": str(e),
                                     "error_type": type(e).__name__}))
            for tenant, f in futures:
                row, ok = resolve(tenant, f)
                errors += not ok
                results.append(row)
                _maybe_statusz(fleet)
            _maybe_statusz(fleet, force=True)
            metrics = fleet.metrics()
            prom = fleet.prometheus()
    finally:
        if tel is not None:
            tel.stop()
            tel.dump(metrics_payload={"source": "cli serve --models",
                                      "metrics": metrics},
                     prometheus=prom)
        if statusz_fh is not None:
            statusz_fh.close()
    metrics["replay"] = {"records": len(records),
                         "tenants": tenant_dirs,
                         "skipped_malformed": skipped,
                         "record_errors": errors,
                         "statusz_lines": statusz_state["lines"]}
    _write_replay_outputs(ns, results, metrics)
    return 0 if errors == 0 else 1


def run_serve(ns) -> int:
    from ..serve import ScoringServer
    from ..workflow.workflow import WorkflowModel

    if ns.model and ns.models:
        raise SystemExit("serve: --model and --models are mutually exclusive")
    if not ns.model and not ns.models:
        raise SystemExit("serve: one of --model or --models is required")
    if ns.models:
        if ns.follow:
            raise SystemExit("serve: --follow is single-model only "
                             "(use --model)")
        return _run_fleet(ns)
    model = WorkflowModel.load(ns.model)
    if ns.follow:
        return _run_follow(ns, model)
    records, skipped = _read_records(ns.records)

    from collections import deque

    from ..serve import QueueFullError

    errors = 0
    tel = _resolve_cli_telemetry(ns)
    metrics: Dict[str, Any] = {}
    prom = None
    try:
        if tel is not None:
            tel.start()
        with ScoringServer(model, max_batch=ns.max_batch,
                           max_wait_ms=ns.max_wait_ms,
                           max_queue=ns.max_queue,
                           min_bucket=ns.min_bucket, warm=not ns.no_warm,
                           resilience=not ns.no_resilience,
                           deadline_ms=ns.deadline_ms,
                           device=ns.device) as server:
            futures: deque = deque()
            results = []
            for r in records:
                while True:
                    try:
                        futures.append(server.submit(r))
                        break
                    except QueueFullError:
                        # backpressure: wait for the oldest in-flight request
                        row, ok = _resolve(futures.popleft())
                        errors += not ok
                        results.append(row)
            for f in futures:
                row, ok = _resolve(f)
                errors += not ok
                results.append(row)
            metrics = server.metrics()
            prom = server.prometheus()
    finally:
        # dump INSIDE the finally: a crashed replay is exactly when the
        # flight-recorder postmortem matters most
        if tel is not None:
            tel.stop()
            tel.dump(metrics_payload={"source": "cli serve",
                                      "metrics": metrics},
                     prometheus=prom)
    metrics["replay"] = {"records": len(records),
                         "skipped_malformed": skipped,
                         "record_errors": errors}
    _write_replay_outputs(ns, results, metrics)
    return 0 if errors == 0 else 1
