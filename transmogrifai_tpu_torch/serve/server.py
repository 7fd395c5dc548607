"""ScoringServer — the in-process online scoring engine (counterpart of
``transmogrifai_tpu/serve/server.py``).

A plan (``serve/plan.py``) behind a micro-batcher (``serve/batcher.py``),
exposed as a plain in-process object, so any transport can embed it::

    server = ScoringServer(model, max_batch=1024, max_wait_ms=2)
    future = server.submit(record)          # one request
    row = future.result()                   # {result feature name: value}

Between the batcher and the plan sit the blue/green swapper
(``serve/swap.py``) and the fault-tolerance layer (``serve/resilience.py``,
on by default): poison records quarantine individually instead of
co-failing their batch, transient device errors retry with backoff, and a
circuit breaker opens when the device path keeps failing (a plan on the
CPU then serves from its host path; a plan on the card has none, so the
batch fails instead of moving to the CPU); a kernel or device fault fails
its batch and is never hidden.
``resilience=False`` serves from the bare plan; ``resilience={...}``
overrides the layer's parameters (validated up front — TM505/TM506,
``serve/validator.py``).

The server runs on the CUDA card unless ``device`` names another device;
with no card and no device it raises.
"""

from __future__ import annotations

import itertools
import logging
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

from ..checkers.diagnostics import OpCheckError
from ..obs.metrics import MetricsRegistry
from ..perf.kernels.dispatch import resolve_device
from .batcher import MicroBatcher
from .pipeline import pipeline_depth as _env_pipeline_depth
from .plan import CompiledScoringPlan
from .resilience import ResilientScorer
from .swap import ModelEntry, SwappableScorer
from .validator import check_resilience_config, check_swap_compatibility

log = logging.getLogger(__name__)

#: ResilientScorer keyword defaults the server exposes for override
_RESILIENCE_DEFAULTS = {
    "max_retries": 2,
    "backoff_base_s": 0.05,
    "backoff_cap_s": 1.0,
    "failure_threshold": 3,
    "recovery_batches": 8,
    "dead_letter": None,
    "seed": None,
}


def default_max_bucket(max_batch: int, min_bucket: int) -> int:
    """Smallest power-of-two padding bucket that holds a full flush: every
    flushed batch fits one bucket, so one prefix dispatch (one encode
    launch) serves the largest flush the batcher can produce."""
    return max(1 << (max(max_batch, 1) - 1).bit_length(), min_bucket)


def resolve_resilience_params(resilience: Union[bool, Mapping[str, Any]],
                              deadline_ms: Optional[float],
                              max_wait_ms: float) -> Optional[Dict[str, Any]]:
    """Merge and statically validate the fault-tolerance configuration:
    the resolved ResilientScorer keyword arguments (None when the layer is
    off), raising :class:`OpCheckError` on TM505 findings and logging TM506
    warnings — before any request is accepted."""
    if not resilience:
        return None
    params = dict(_RESILIENCE_DEFAULTS)
    if isinstance(resilience, Mapping):
        unknown = set(resilience) - set(params)
        if unknown:
            raise TypeError(f"unknown resilience parameter(s): {sorted(unknown)}")
        params.update(resilience)
    report = check_resilience_config(
        max_retries=params["max_retries"],
        backoff_base_s=params["backoff_base_s"],
        backoff_cap_s=params["backoff_cap_s"],
        failure_threshold=params["failure_threshold"],
        recovery_batches=params["recovery_batches"],
        dead_letter=params["dead_letter"],
        default_deadline_ms=deadline_ms,
        max_wait_ms=max_wait_ms)
    if report.errors():
        raise OpCheckError(report)
    for d in report.warnings():
        log.warning("%s", d.pretty())
    return params


class ScoringServer:
    """Plan + fault-tolerance layer + micro-batcher, one metrics registry.

    - ``submit(record, deadline_ms=...) -> Future`` — asynchronous,
      micro-batched (rejects with QueueFullError under pressure, evicts with
      DeadlineExceededError when the deadline passes in the queue).
    - ``score(record)`` — synchronous convenience over ``submit``.
    - ``score_batch(records)`` — straight into the active plan (callers that
      already hold a batch; no fault isolation).
    - ``stage_candidate(model)`` / ``promote()`` / ``rollback()`` — shadow
      scoring and atomic blue/green swap (``serve/swap.py``).
    - ``metrics()`` / ``prometheus()`` / ``metrics_snapshot()`` /
      ``statusz()`` — plan, batcher, resilience and swap counters.

    The parameters are the reference's, in its order, and ``device`` by
    keyword only.  ``hbm_budget`` (bytes) arms every plan's TM601
    admission gate (``serve/validator.py::check_plan_admission``): a model
    whose static peak device-memory estimate exceeds it is refused.
    """

    def __init__(self, model, max_batch: int = 256, max_wait_ms: float = 2.0,
                 max_queue: int = 4096, min_bucket: int = 8,
                 max_bucket: Optional[int] = None, warm: bool = True,
                 resilience: Union[bool, Mapping[str, Any]] = True,
                 deadline_ms: Optional[float] = None,
                 hbm_budget: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 pipeline_depth: Optional[int] = None, *, device=None):
        self.device = resolve_device(device)
        self.hbm_budget = hbm_budget
        # one registry per server: the batcher/swap/breaker series are
        # unlabeled fixed names, so two servers sharing a registry would
        # merge their counters
        self.registry = registry if registry is not None else MetricsRegistry()
        if max_bucket is None:
            max_bucket = default_max_bucket(max_batch, min_bucket)
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.default_deadline_ms = deadline_ms
        self._resilience_params = resolve_resilience_params(
            resilience, deadline_ms, max_wait_ms)
        self._versions = itertools.count(1)
        # the server decides the depth; each plan reserves a landing set per
        # batch the pipeline can hold begun and not yet finalized
        self._depth = _env_pipeline_depth() if pipeline_depth is None \
            else max(0, int(pipeline_depth))
        # every model (the first and each staged candidate) builds through
        # one path; the swapper is the batcher-facing atomic reference
        self._swapper = SwappableScorer(self._build_entry(model, warm=warm),
                                        registry=self.registry)
        self.batcher = MicroBatcher(self._swapper, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms, max_queue=max_queue,
                                    registry=self.registry,
                                    pipeline_depth=self._depth)

    def _build_entry(self, model, warm: bool = True) -> ModelEntry:
        plan = CompiledScoringPlan(model, self.min_bucket, self.max_bucket,
                                   hbm_budget=self.hbm_budget, device=self.device)
        plan.reserve_inflight(self._depth + 1)
        if warm:
            plan.warm()
        version = next(self._versions)
        res = ResilientScorer(plan, registry=self.registry,
                              labels={"entry": str(version)},
                              **self._resilience_params) \
            if self._resilience_params is not None else None
        return ModelEntry(model, plan, res, version)

    # -- active-entry views ----------------------------------------------------
    @property
    def plan(self) -> CompiledScoringPlan:
        return self._swapper.active.plan

    @property
    def resilience(self) -> Optional[ResilientScorer]:
        return self._swapper.active.resilience

    # -- request paths -------------------------------------------------------
    def submit(self, record: Mapping[str, Any],
               deadline_ms: Optional[float] = None) -> Future:
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        return self.batcher.submit(record, deadline_ms=deadline_ms)

    def score(self, record: Mapping[str, Any], timeout: Optional[float] = None,
              deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        return self.submit(record, deadline_ms=deadline_ms).result(timeout)

    def score_batch(self, records: Sequence[Mapping[str, Any]]) -> List[Dict[str, Any]]:
        return self.plan.score(records)

    # -- blue/green swap -------------------------------------------------------
    def stage_candidate(self, model, warm: bool = True) -> str:
        """Build and stage a candidate model for shadow scoring: its own
        plan on the server's device and, with the fault-tolerance layer on,
        its own ResilientScorer and breaker.  Refuses an incompatible
        candidate with TM507 (``serve/validator.py``) before its buckets
        are set up; logs TM508 when its prefix fingerprint differs from the
        active plan's.  Returns the candidate's plan fingerprint."""
        entry = self._build_entry(model, warm=False)
        report = check_swap_compatibility(self.plan, entry.plan)
        if report.errors():
            raise OpCheckError(report)
        for d in report:
            log.info("%s", d.pretty())
        if warm:
            entry.plan.warm()
        self._swapper.stage(entry)
        self._prune_entry_metrics()
        return entry.fingerprint

    def _prune_entry_metrics(self) -> None:
        """Drop the registry series of model entries no longer held
        (active, previous or candidate), so restaging does not grow the
        registry without bound."""
        live = {str(e.version) for e in self._swapper.live_entries()}
        for version in self.registry.labeled_values("entry"):
            if version not in live:
                self.registry.drop_labeled("entry", version)

    def discard_candidate(self) -> None:
        self._swapper.discard_candidate()

    def shadow_report(self) -> Dict[str, Any]:
        """Mirrored-traffic statistics of the staged candidate."""
        return self._swapper.shadow_report()

    def has_candidate(self) -> bool:
        return self._swapper.has_candidate()

    def in_probation(self) -> bool:
        return self._swapper.in_probation()

    def promote(self, probation_batches: int = 8) -> Dict[str, Any]:
        """Atomic blue/green swap to the staged candidate: in-flight batches
        complete on the old model, the old entry is kept as the rollback
        target, and a breaker trip within ``probation_batches`` flushed
        batches rolls back.  Returns the swap record."""
        # batches already begun complete on the entry they captured; the
        # drain makes every one of them routed before the swap
        self.batcher.drain_pipeline()
        return self._swapper.promote(probation_batches=probation_batches)

    def rollback(self) -> Dict[str, Any]:
        """Restore the retained last-known-good model."""
        self.batcher.drain_pipeline()
        return self._swapper.rollback()

    def swap_metrics(self) -> Dict[str, Any]:
        return self._swapper.metrics()

    # -- lifecycle -----------------------------------------------------------
    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        self.batcher.shutdown(drain=drain, timeout=timeout)

    def __enter__(self) -> "ScoringServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability -------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"plan": self.plan.metrics(),
                               "batcher": self.batcher.metrics(),
                               "swap": self._swapper.metrics()}
        if self.resilience is not None:
            out["resilience"] = self.resilience.metrics()
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition of the server's registry (canonical
        ``tmog_serve_*`` names, HELP/TYPE lines for the whole table)."""
        return self.registry.to_prometheus(all_canonical=True)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Stable-key-ordered JSON-able snapshot of the registry."""
        return self.registry.snapshot()

    def statusz(self) -> Dict[str, Any]:
        """One JSON-able status line.  ``device_seconds`` and
        ``padding_rows`` are the batcher's canonical counters
        (``tmog_serve_batcher_device_seconds_total``: the device prefix as
        the card's events time it; ``..._padding_rows_total``)."""
        bat = self.batcher.metrics()
        plan = self.plan.metrics()
        res = self.resilience
        return {
            "ts": round(time.time(), 3),
            "fingerprint": self.plan.fingerprint[:16],
            "device": plan["device"],
            "queue_depth": bat["queue_depth"],
            "completed": bat["completed"],
            "failed": bat["failed"],
            "deadline_expired": bat["deadline_expired"],
            "p99_ms": bat["latency_p99_ms"],
            "device_seconds": bat["device_seconds"],
            "padding_rows": bat["padding_rows"],
            "breaker": res.breaker.state if res is not None else None,
            "warm_buckets": len(self.plan.warm_buckets()),
            "candidate_staged": self.has_candidate(),
            "pipeline_depth": bat["pipeline"]["depth"],
            "pipeline_overlap": bat["pipeline"]["overlap_fraction"],
        }
