"""MicroBatcher — adaptive request batching in front of a plan
(counterpart of ``transmogrifai_tpu/serve/batcher.py``).

Requests enqueue into a bounded queue and a flusher thread drains them in
batches under two policies:

- **flush-on-size**: a full ``max_batch`` flushes immediately;
- **flush-on-deadline**: otherwise the batch flushes when the oldest queued
  request has waited ``max_wait_ms`` (a lone request never waits for peers
  that may not come).

Backpressure is admission control: a full queue rejects ``submit`` with
:class:`QueueFullError` instead of buffering unboundedly.
``shutdown(drain=True)`` stops admission, drains the queue in full batches
with no deadline waits, and joins the flusher.

SLO classes: ``submit(record, tenant=..., slo=...)`` tags the request with
an :class:`SloClass` — a shedding tier (higher survives longer) and an
optional default deadline.  Under backpressure the eviction scan is
deadline-then-tier: expired-deadline entries are reclaimed first, then
queued entries whose effective tier sits strictly below the incoming
request's are shed lowest-tier-first (oldest within a tier) with
:class:`~.faults.LoadShedError`.  A tenant marked degraded
(``set_degraded``) has its requests demoted below every configured tier.
``shed`` / ``cancelled`` / ``deadline_expired`` stay distinct: a shed entry
was live and evicted for tier, a cancelled one was abandoned client-side,
an expired one outlived its deadline.

Request deadlines: ``submit(record, deadline_ms=...)`` bounds the request's
queue life — an expired request is evicted with
:class:`~.faults.DeadlineExceededError` inside the queue (making room under
backpressure) and again at flush time, before any device work is spent on
it.

Per-record fault isolation: a scorer exposing ``score_isolated(records) ->
[result | Exception, ...]`` (``serve/resilience.py``, ``serve/swap.py``)
gets per-record outcomes routed to per-record futures.
A fleet scorer exposing ``score_isolated_tenants(records, tenants)``
(``serve/registry.py::FleetServer``) also gets each request's tenant, and
fans the flushed batch out per tenant; ``drop_tenant`` forgets a removed
tenant's labeled series and degraded flag.

Pipelined flushing: with ``pipeline_depth`` > 0 (default: the
``TMOG_SERVE_PIPELINE_DEPTH`` knob, 2) and a scorer exposing the staged
``begin_*`` protocol, the flusher thread claims batch N+1 and runs its host
encode and device dispatch while a finalizer thread waits for batch N's
device outputs, runs its host remainder and routes its futures.  The
in-flight window is a bounded ring (``serve/pipeline.py``): a full window
blocks the flusher, which backs pressure into the submit queue.  Batches
finalize in flush order and each runs the lockstep code
(``score() == begin_score()()``), so results equal lockstep's.
``pipeline_depth=0`` is the lockstep loop.

Every counter lives in a :class:`~..obs.metrics.MetricsRegistry` under the
canonical ``tmog_serve_batcher_*`` names; ``metrics()`` is a plain-dict
view over it.  Each flushed batch carries a ``BatchTrace``
(``obs/reqtrace.py``, always on): the plan's device marks feed the
``tmog_serve_batcher_device_seconds_total`` and
``tmog_serve_batcher_padding_rows_total`` counters, per tenant too, when the
batch completes.  When an ``obs`` tracer is installed, each flushed batch
emits a ``serve.flush`` span (tagged with the ``batch_seq`` join key); at
``detail="requests"`` every request also exports its own async track —
submit → queue → flush → response with the outcome — linked to its batch
via ``batch_seq``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)

from ..obs import reqtrace
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry
from ..obs.overlap import OverlapStats
from .faults import DeadlineExceededError, LoadShedError, fault_point
from .pipeline import STALL_THRESHOLD_S, InflightRing
from .pipeline import pipeline_depth as _env_pipeline_depth


class QueueFullError(RuntimeError):
    """Admission rejected: the request queue is at capacity (backpressure)."""


class BatcherClosedError(RuntimeError):
    """submit() after shutdown began."""


class SloClass(NamedTuple):
    """One service class: shedding tier (higher = survives backpressure
    longer) and an optional tiered default request deadline."""

    name: str
    tier: int
    deadline_ms: Optional[float] = None


#: the default three-class ladder; deadlines default to None so a class
#: only bounds queue life when the deployment configures it
DEFAULT_SLO_CLASSES: Dict[str, SloClass] = {
    "gold": SloClass("gold", 2),
    "silver": SloClass("silver", 1),
    "bronze": SloClass("bronze", 0),
}

#: tier demotion applied to every request of a degraded (breaker-open)
#: tenant: large enough to sink below any configured tier, so degraded
#: tenants absorb the shedding cuts first
_DEGRADED_TIER_PENALTY = 1_000_000


class _Request:
    __slots__ = ("record", "future", "t_enqueue", "deadline", "tenant",
                 "tier", "slo", "ctx")

    def __init__(self, record: Mapping[str, Any],
                 deadline_ms: Optional[float] = None,
                 tenant: Optional[str] = None, tier: int = 0,
                 slo: Optional[str] = None):
        self.record = record
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        self.deadline = None if deadline_ms is None \
            else self.t_enqueue + float(deadline_ms) / 1e3
        self.tenant = tenant
        self.tier = tier
        self.slo = slo
        #: request trace id (obs/reqtrace.py mint_request) — None unless a
        #: tracer with detail="requests" is installed at submit time;
        #: cleared when the request's track is emitted
        self.ctx = None


class MicroBatcher:
    """Bounded request queue + flusher thread over a batch scoring function.

    ``score_batch`` is any ``records -> results`` callable returning one
    result per record in order (``CompiledScoringPlan.score``, a
    :class:`~.swap.SwappableScorer`, anything list-shaped in tests).
    """

    def __init__(self, score_batch: Callable[[List[Any]], Sequence[Any]],
                 max_batch: int = 256, max_wait_ms: float = 2.0,
                 max_queue: int = 4096,
                 registry: Optional[MetricsRegistry] = None,
                 slo_classes: Optional[Mapping[str, SloClass]] = None,
                 pipeline_depth: Optional[int] = None):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self._score = score_batch
        # multi-tenant routing protocol (serve/registry.py): the fleet
        # dispatcher receives the per-request tenant ids beside the records
        # and fans each sub-batch out to its tenant's scoring stack
        self._fleet = callable(getattr(score_batch, "score_isolated_tenants", None))
        # per-record isolation protocol (serve/resilience.py): outcomes are
        # routed future-by-future instead of all-or-nothing
        self._isolated = callable(getattr(score_batch, "score_isolated", None))
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self.slo_classes: Dict[str, SloClass] = dict(
            DEFAULT_SLO_CLASSES if slo_classes is None else slo_classes)

        self._pending: "deque[_Request]" = deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._open = True
        #: tenants whose requests are demoted below every tier
        self._degraded: set = set()
        # per-tenant labeled metric cache; its own lock because the shed
        # path reaches it while holding the non-reentrant batcher lock
        self._tenant_metrics: Dict[Tuple[str, str], Any] = {}
        self._tenant_metrics_lock = threading.Lock()
        # canonical counters (obs/metrics.py) — metrics() is a view
        self.registry = registry if registry is not None else MetricsRegistry()
        from ..obs.metrics import canonical_help as _h

        def _c(name):
            return self.registry.counter(name, _h(name))

        self._c_submitted = _c("tmog_serve_batcher_submitted_total")
        self._c_rejected = _c("tmog_serve_batcher_rejected_total")
        self._c_completed = _c("tmog_serve_batcher_completed_total")
        self._c_failed = _c("tmog_serve_batcher_failed_total")
        self._c_cancelled = _c("tmog_serve_batcher_cancelled_total")
        self._c_deadline = _c("tmog_serve_batcher_deadline_expired_total")
        self._c_shed = _c("tmog_serve_batcher_shed_total")
        self._c_batches = _c("tmog_serve_batcher_batches_total")
        self._c_device_seconds = _c("tmog_serve_batcher_device_seconds_total")
        self._c_padding = _c("tmog_serve_batcher_padding_rows_total")
        self._g_depth = self.registry.gauge(
            "tmog_serve_batcher_queue_depth",
            _h("tmog_serve_batcher_queue_depth"))
        self._h_batch_size = self.registry.histogram(
            "tmog_serve_batcher_batch_size",
            _h("tmog_serve_batcher_batch_size"), exact=True)
        self._h_latency = self.registry.histogram(
            "tmog_serve_batcher_latency_seconds",
            _h("tmog_serve_batcher_latency_seconds"))

        # pipelined flush path: depth from the ctor (the server's) or the
        # TMOG_SERVE_PIPELINE_DEPTH knob; 0 = lockstep.  The ring and the
        # finalizer thread exist only when pipelining.
        self.pipeline_depth = _env_pipeline_depth() \
            if pipeline_depth is None else max(0, int(pipeline_depth))
        self._pipe_stats = OverlapStats()
        self._g_pipe_depth = self.registry.gauge(
            "tmog_serve_pipeline_depth", _h("tmog_serve_pipeline_depth"))
        self._g_pipe_depth.set(self.pipeline_depth)
        self._g_pipe_overlap = self.registry.gauge(
            "tmog_serve_pipeline_overlap_fraction",
            _h("tmog_serve_pipeline_overlap_fraction"))
        self._c_pipe_stalls = _c("tmog_serve_pipeline_stalls_total")
        self._ring: Optional[InflightRing] = \
            InflightRing(self.pipeline_depth) if self.pipeline_depth > 0 \
            else None
        self._fin_thread: Optional[threading.Thread] = None
        if self._ring is not None:
            self._fin_thread = threading.Thread(
                target=self._finalize_loop, daemon=True,
                name="transmogrifai-microbatcher-finalize")
            self._fin_thread.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="transmogrifai-microbatcher")
        self._thread.start()

    # -- client API ----------------------------------------------------------
    def _resolve_slo(self, slo: Union[None, str, SloClass]
                     ) -> Optional[SloClass]:
        if slo is None or isinstance(slo, SloClass):
            return slo
        cls = self.slo_classes.get(slo)
        if cls is None:
            raise ValueError(f"unknown SLO class {slo!r}; configured: "
                             f"{sorted(self.slo_classes)}")
        return cls

    def submit(self, record: Mapping[str, Any],
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               slo: Union[None, str, SloClass] = None) -> Future:
        """Enqueue one record; resolves to its result dict.

        ``deadline_ms`` bounds the request's queue life: once it expires the
        request is evicted with :class:`DeadlineExceededError` instead of
        spending a device call on it.  ``slo`` (a configured class name or
        an :class:`SloClass`) sets the shedding tier and, when
        ``deadline_ms`` is not given, the class's tiered default deadline.
        Raises :class:`QueueFullError` when the queue is at capacity and no
        lower-tier entry can be shed, and :class:`BatcherClosedError` after
        shutdown began.
        """
        slo_cls = self._resolve_slo(slo)
        if deadline_ms is None and slo_cls is not None:
            deadline_ms = slo_cls.deadline_ms
        req = _Request(record, deadline_ms, tenant=tenant,
                       tier=slo_cls.tier if slo_cls is not None else 0,
                       slo=slo_cls.name if slo_cls is not None else None)
        # minted BEFORE the request enters the queue: the flusher may claim
        # it the instant the lock releases, and an id attached late would
        # miss its own flush (obs/reqtrace.py; None at batch detail).  With
        # no tracer installed the submit pays this one module-global read.
        if obs_trace._TRACER is not None:
            req.ctx = reqtrace.mint_request()
        expired: List[_Request] = []
        shed: List[_Request] = []
        try:
            with self._wake:
                if not self._open:
                    raise BatcherClosedError("MicroBatcher is shut down")
                if len(self._pending) >= self.max_queue:
                    # deadline-then-tier reclaim: expired requests are dead
                    # weight and go first; live lower-tier entries are shed
                    # only for a strictly higher-tier incoming request.
                    # The fault point fires BEFORE any entry is claimed, so
                    # an injected shed fault leaves the queue untouched.
                    fault_point("shed", tenant=tenant,
                                tier=self._eff_tier_locked(req),
                                queue_depth=len(self._pending))
                    expired, shed = self._reclaim_locked(
                        self._eff_tier_locked(req))
                if len(self._pending) >= self.max_queue:
                    self._c_rejected.inc()
                    raise QueueFullError(
                        f"request queue at capacity ({self.max_queue}); "
                        "shed load or retry")
                self._c_submitted.inc()
                self._pending.append(req)
                depth = len(self._pending)
                # gauge set UNDER the batcher lock: a deferred write could
                # land after the flusher's drain-side update and pin a
                # phantom nonzero depth on an idle queue
                self._g_depth.set(depth)
                self._wake.notify_all()
        except BaseException as e:
            reqtrace.finish_request(req, f"rejected:{type(e).__name__}")
            raise
        finally:
            # resolve evicted futures OUTSIDE the lock: set_exception runs
            # client done-callbacks synchronously, and a callback touching
            # the batcher would deadlock on the non-reentrant lock
            for r in expired:
                reqtrace.finish_request(r, "deadline_expired")
                r.future.set_exception(DeadlineExceededError(
                    "request deadline expired while queued"))
            for r in shed:
                reqtrace.finish_request(r, "shed")
                r.future.set_exception(LoadShedError(
                    f"request shed at tier {r.tier} to admit higher-tier "
                    "traffic under backpressure",
                    tenant=r.tenant, tier=r.tier))
        return req.future

    def _eff_tier_locked(self, req: _Request) -> int:
        """Effective shedding tier (lock held): the SLO tier, demoted below
        every configured class while the request's tenant is degraded."""
        if req.tenant is not None and req.tenant in self._degraded:
            return req.tier - _DEGRADED_TIER_PENALTY
        return req.tier

    def _pop_expired_locked(self) -> List[_Request]:
        """Remove queued requests whose deadline passed (lock held) and
        return the CLAIMED ones for the caller to fail outside the lock."""
        now = time.monotonic()
        if not any(r.deadline is not None and r.deadline <= now
                   for r in self._pending):
            return []
        keep: "deque[_Request]" = deque()
        expired: List[_Request] = []
        for r in self._pending:
            if r.deadline is not None and r.deadline <= now:
                if r.future.set_running_or_notify_cancel():
                    self._c_deadline.inc()
                    if r.tenant is not None:
                        self._tenant_counter(
                            "tmog_serve_batcher_deadline_expired_total",
                            r.tenant).inc()
                    expired.append(r)
                else:
                    self._c_cancelled.inc()
                    reqtrace.finish_request(r, "cancelled")
            else:
                keep.append(r)
        self._pending = keep
        return expired

    def _reclaim_locked(self, incoming_tier: int
                        ) -> Tuple[List[_Request], List[_Request]]:
        """Deadline-then-tier eviction scan under backpressure (lock held).

        Returns ``(expired, shed)`` — the CLAIMED requests for the caller
        to fail outside the lock.  The counter split stays exact: expired
        deadlines count ``deadline_expired``, tier evictions count ``shed``
        (globally and per tenant), and entries found already cancelled
        client-side count ``cancelled`` — a shed is a live request the
        server chose to drop, never a client abandonment.
        """
        expired = self._pop_expired_locked()
        shed: List[_Request] = []
        while len(self._pending) >= self.max_queue:
            victim_i, victim_tier = -1, incoming_tier
            for i, r in enumerate(self._pending):
                t = self._eff_tier_locked(r)
                if t < victim_tier:  # strict: equal tiers are never shed
                    victim_i, victim_tier = i, t
            if victim_i < 0:
                break
            victim = self._pending[victim_i]
            del self._pending[victim_i]
            if victim.future.set_running_or_notify_cancel():
                self._c_shed.inc()
                if victim.tenant is not None:
                    self._tenant_counter("tmog_serve_batcher_shed_total",
                                         victim.tenant).inc()
                shed.append(victim)
            else:
                self._c_cancelled.inc()
                reqtrace.finish_request(victim, "cancelled")
        return expired, shed

    # -- per-tenant state ------------------------------------------------------
    def set_degraded(self, tenant: str, degraded: bool) -> None:
        """Mark/unmark ``tenant`` as degraded: its queued and incoming
        requests drop below every configured tier, so shedding consumes the
        degraded tenant's traffic first."""
        with self._lock:
            if degraded:
                self._degraded.add(tenant)
            else:
                self._degraded.discard(tenant)

    def drop_tenant(self, tenant: str) -> None:
        """Forget a tenant's cached labeled metrics and degraded flag (the
        registry's unregister hook; the registry drops the exported series
        itself with ``drop_labeled``)."""
        with self._lock:
            self._degraded.discard(tenant)
        with self._tenant_metrics_lock:
            for key in [k for k in self._tenant_metrics if k[1] == tenant]:
                del self._tenant_metrics[key]

    def _tenant_metric(self, ctor, name: str, tenant: str, **kw):
        key = (name, tenant)
        with self._tenant_metrics_lock:
            m = self._tenant_metrics.get(key)
            if m is None:
                from ..obs.metrics import canonical_help as _h

                m = ctor(name, _h(name), labels={"tenant": tenant}, **kw)
                self._tenant_metrics[key] = m
            return m

    def _tenant_counter(self, name: str, tenant: str):
        return self._tenant_metric(self.registry.counter, name, tenant)

    def _tenant_latency(self, tenant: str):
        return self._tenant_metric(self.registry.histogram,
                                   "tmog_serve_batcher_latency_seconds",
                                   tenant)

    def tenant_metrics(self) -> Dict[str, Dict[str, Any]]:
        """{tenant: {shed, completed, failed, deadline_expired,
        device_seconds, latency_p50_ms/p95/p99}} over the per-tenant labeled
        series this batcher has created."""
        with self._tenant_metrics_lock:
            items = dict(self._tenant_metrics)
        counters = {"tmog_serve_batcher_shed_total": "shed",
                    "tmog_serve_batcher_completed_total": "completed",
                    "tmog_serve_batcher_failed_total": "failed",
                    "tmog_serve_batcher_deadline_expired_total":
                        "deadline_expired"}
        out: Dict[str, Dict[str, Any]] = {}
        for (name, tenant), m in sorted(items.items()):
            row = out.setdefault(tenant, {})
            if name in counters:
                row[counters[name]] = m.value
            elif name == "tmog_serve_batcher_device_seconds_total":
                row["device_seconds"] = m.value
            elif name == "tmog_serve_batcher_latency_seconds":
                for q, key in ((0.50, "latency_p50_ms"),
                               (0.95, "latency_p95_ms"),
                               (0.99, "latency_p99_ms")):
                    v = m.quantile(q)
                    row[key] = round(v * 1e3, 4) if v is not None else None
        return out

    def score(self, record: Mapping[str, Any],
              timeout: Optional[float] = None,
              deadline_ms: Optional[float] = None) -> Any:
        """Synchronous single-record convenience: submit + wait."""
        return self.submit(record, deadline_ms=deadline_ms).result(timeout)

    def __call__(self, record: Mapping[str, Any]) -> Any:
        return self.score(record)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop admission; drain (or fail) queued requests; join the flusher."""
        evicted: List[_Request] = []
        with self._wake:
            self._open = False
            if not drain:
                while self._pending:
                    req = self._pending.popleft()
                    if req.future.set_running_or_notify_cancel():
                        evicted.append(req)
                    # server-side cancellation, not a scoring failure — same
                    # bucket as a client-side cancel() the claim filter sees
                    self._c_cancelled.inc()
            self._wake.notify_all()
        for req in evicted:  # outside the lock: done-callbacks may re-enter
            reqtrace.finish_request(req, "closed")
            req.future.set_exception(BatcherClosedError(
                "batcher shut down before flush"))
        self._thread.join(timeout)
        # in-flight pipelined batches ALWAYS finalize (drain or not): a
        # claimed batch is past admission, exactly like the batch a lockstep
        # flusher is mid-scoring at shutdown — nothing dropped, nothing
        # double-scored.  The flusher closed the ring on exit, so the
        # finalizer exits once the backlog drains.
        if self._fin_thread is not None:
            self._fin_thread.join(timeout)

    def drain_pipeline(self, timeout: Optional[float] = None) -> bool:
        """Wait until no pipelined batch is in flight (True at once in
        lockstep mode).  The swap/rollback paths call this before mutating
        the active model — batches begun earlier still complete on the
        entry they captured (serve/swap.py); this makes the cutover clean:
        every batch begun before it is routed first."""
        if self._ring is None:
            return True
        return self._ring.drain(timeout)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def metrics(self) -> Dict[str, Any]:
        """Counters as a plain dict — a view over the canonical registry
        names (obs/metrics.py ``CANONICAL_METRICS``)."""
        out: Dict[str, Any] = {
            "submitted": self._c_submitted.value,
            "rejected": self._c_rejected.value,
            "completed": self._c_completed.value,
            "failed": self._c_failed.value,
            "cancelled": self._c_cancelled.value,
            "deadline_expired": self._c_deadline.value,
            "shed": self._c_shed.value,
            "batches": self._c_batches.value,
            # unrounded: per-tenant amortized shares must sum EXACTLY to
            # this total (the cost-accounting invariant) — rounding belongs
            # to display surfaces
            "device_seconds": self._c_device_seconds.value,
            "padding_rows": self._c_padding.value,
        }
        with self._lock:
            out["queue_depth"] = len(self._pending)
        out["batch_size_hist"] = {str(k): v for k, v in sorted(
            self._h_batch_size.exact_counts().items())}
        for q, name in ((0.50, "latency_p50_ms"), (0.95, "latency_p95_ms"),
                        (0.99, "latency_p99_ms")):
            v = self._h_latency.quantile(q)
            out[name] = round(v * 1e3, 4) if v is not None else None
        out["max_batch"] = self.max_batch
        out["max_wait_ms"] = self.max_wait_s * 1e3
        out["max_queue"] = self.max_queue
        pipe = self._pipe_stats.to_dict()
        pipe["depth"] = self.pipeline_depth
        pipe["batches"] = pipe.pop("chunks")  # serve items are batches
        out["pipeline"] = pipe
        return out

    # -- flusher -------------------------------------------------------------
    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until a flush condition holds; None means flusher exit."""
        with self._wake:
            while self._open and not self._pending:
                self._wake.wait()  # submit()/shutdown() notify
            if not self._pending:  # wait loop only exits empty when closed
                return None
            if self._open:
                deadline = self._pending[0].t_enqueue + self.max_wait_s
                while self._open and len(self._pending) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._wake.wait(remaining)
            # shutdown drains immediately, full batches at a time
            take = min(self.max_batch, len(self._pending))
            batch = [self._pending.popleft() for _ in range(take)]
            self._g_depth.set(len(self._pending))
            return batch

    def _claim(self, batch: List[_Request]) -> List[_Request]:
        """Claim futures and evict expired requests before any device call.

        Claiming every future before scoring matters: a client-side cancel()
        on a still-pending future would otherwise make the later
        set_result/set_exception raise InvalidStateError and kill the flusher
        thread, hanging all subsequent requests.  Deadline eviction happens
        HERE — after the queue wait, before the scorer — so an expired
        request never costs a device dispatch.
        """
        now = time.monotonic()
        claimed: List[_Request] = []
        cancelled = expired = 0
        for r in batch:
            if not r.future.set_running_or_notify_cancel():
                cancelled += 1
                reqtrace.finish_request(r, "cancelled")
                continue
            if r.deadline is not None and r.deadline <= now:
                expired += 1
                if r.tenant is not None:
                    self._tenant_counter(
                        "tmog_serve_batcher_deadline_expired_total",
                        r.tenant).inc()
                reqtrace.finish_request(r, "deadline_expired")
                r.future.set_exception(DeadlineExceededError(
                    "request deadline expired before flush"))
                continue
            claimed.append(r)
        if cancelled:
            self._c_cancelled.inc(cancelled)
        if expired:
            self._c_deadline.inc(expired)
        return claimed

    def _run(self) -> None:
        if self._ring is not None:
            self._run_pipelined()
            return
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            batch = self._claim(batch)
            if not batch:
                continue
            # the batch trace is ALWAYS minted (a slotted object + a few
            # phase marks): the per-tenant device-time cost counters must
            # accumulate with telemetry fully off (obs/reqtrace.py)
            bt, token = reqtrace.begin_batch(len(batch))
            try:
                self._flush(batch, bt)
            finally:
                reqtrace.end_batch(token)
                self._account_batch(bt, batch)

    # -- pipelined flusher ---------------------------------------------------
    def _begin_batch(self, batch: List[_Request]) -> Callable[[], Sequence[Any]]:
        """Run the staged scorer's begin stage (encode + device dispatch)
        and return its finalize closure.  Scorers without the staged
        ``begin_*`` protocol defer the whole lockstep dispatch to finalize —
        full semantics, no overlap."""
        records = [r.record for r in batch]
        if self._fleet:
            tenants = [r.tenant for r in batch]
            begin = getattr(self._score, "begin_isolated_tenants", None)
            if callable(begin):
                return begin(records, tenants)
            return lambda: self._score.score_isolated_tenants(records, tenants)
        if self._isolated:
            begin = getattr(self._score, "begin_isolated", None)
            if callable(begin):
                return begin(records)
            return lambda: self._score.score_isolated(records)
        begin = getattr(self._score, "begin_score", None)
        if callable(begin):
            return begin(records)
        return lambda: self._score(records)

    def _run_pipelined(self) -> None:
        """Producer half of the double-buffered flush path: claim batch
        N+1, run its encode and device dispatch, and stage it in the
        in-flight ring while the finalizer thread is still busy with batch
        N's device wait and host remainder.  A begin-stage exception is
        deferred into the finalize closure, so the batch-level failure path
        (futures, counters) runs in one place on the finalizer thread, as in
        lockstep."""
        try:
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                batch = self._claim(batch)
                if not batch:
                    continue
                t_claim = time.monotonic()
                bt, token = reqtrace.begin_batch(len(batch))
                t0 = time.perf_counter()
                try:
                    fin = self._begin_batch(batch)
                except Exception as e:  # noqa: BLE001 — re-raised at finalize
                    err = e

                    def fin(_e: BaseException = err) -> Sequence[Any]:
                        raise _e
                finally:
                    reqtrace.end_batch(token)
                self._pipe_stats.add_load(time.perf_counter() - t0)
                self._ring.put((batch, bt, t_claim, fin))
        finally:
            self._ring.close()

    def _finalize_loop(self) -> None:
        """Consumer half: wait for batch N's device outputs, run its host
        remainder, route its futures and account the batch, in flush order,
        re-entering the flusher's batch trace via ``reqtrace.batch_scope`` so
        the host and device marks land on the right BatchTrace.  Ring waits
        on an empty window are starvation (the finalizer outran the
        flusher's encode) and count toward the stall counter."""
        while True:
            empty = self._ring.empty()
            t0 = time.perf_counter()
            item = self._ring.get()
            wait = time.perf_counter() - t0
            stalled = empty and wait > STALL_THRESHOLD_S and item is not None
            self._pipe_stats.add_wait(wait, stalled=stalled)
            if stalled:
                self._c_pipe_stalls.inc()
            if item is None:
                return
            batch, bt, t_claim, fin = item
            try:
                with reqtrace.batch_scope(bt):
                    self._flush_finalize(batch, bt, t_claim, fin)
            finally:
                self._account_batch(bt, batch)
                self._pipe_stats.add_chunk()
                self._g_pipe_overlap.set(self._pipe_stats.overlap_fraction)
                self._ring.task_done()

    def _flush_finalize(self, batch: List[_Request], bt, t_claim: float,
                        fin: Callable[[], Sequence[Any]]) -> None:
        # pipelined twin of _flush: the serve.flush span lives on the
        # finalizer thread; phase spans carry batch_seq, so the causal
        # chain joins on the key, not the tid (obs/reqtrace.py)
        with obs_trace.span("serve.flush", cat="serve",
                            batch=len(batch), batch_seq=bt.seq,
                            pipelined=True):
            self._route_results(batch, bt, t_claim, lambda: fin())

    def _flush(self, batch: List[_Request], bt) -> None:
        t_claim = time.monotonic()
        # serve.flush: the whole batch lifecycle on this worker thread —
        # the plan's encode/device/host spans nest inside it, and batch_seq
        # is the join key per-request async events link through
        with obs_trace.span("serve.flush", cat="serve",
                            batch=len(batch), batch_seq=bt.seq):
            self._route_results(batch, bt, t_claim, lambda: self._dispatch(batch))

    def _dispatch(self, batch: List[_Request]) -> Sequence[Any]:
        """Lockstep scorer dispatch across the three scorer protocols."""
        if self._fleet:
            return self._score.score_isolated_tenants(
                [r.record for r in batch], [r.tenant for r in batch])
        if self._isolated:
            return self._score.score_isolated(
                [r.record for r in batch])
        return self._score([r.record for r in batch])

    def _route_results(self, batch: List[_Request], bt, t_claim: float,
                       score_fn: Callable[[], Sequence[Any]]) -> None:
        """Score the batch and route results/failures to futures and
        counters — the shared body of the lockstep and the pipelined loops
        (identical accounting either way)."""
        try:
            results = score_fn()
            if len(results) != len(batch):
                raise RuntimeError(
                    f"score_batch returned {len(results)} results "
                    f"for {len(batch)} records")
        except Exception as e:  # noqa: BLE001 - failures to futures
            self._c_failed.inc(len(batch))
            self._c_batches.inc()
            self._h_batch_size.observe(len(batch))
            tenant_failed: Dict[str, int] = {}
            for r in batch:
                if r.tenant is not None:
                    tenant_failed[r.tenant] = \
                        tenant_failed.get(r.tenant, 0) + 1
            for tenant, n in tenant_failed.items():
                self._tenant_counter(
                    "tmog_serve_batcher_failed_total", tenant).inc(n)
            err = f"error:{type(e).__name__}"
            for r in batch:
                r.future.set_exception(e)
            self._emit_request_tracks(
                bt, t_claim,
                [(r, err) for r in batch if r.ctx is not None])
            return
        now = time.monotonic()
        ok = [not isinstance(res, Exception) for res in results]
        self._c_completed.inc(sum(ok))
        self._c_failed.inc(len(batch) - sum(ok))
        self._c_batches.inc()
        self._h_batch_size.observe(len(batch))
        tenant_outcomes: Dict[Tuple[str, bool], int] = {}
        for r, good in zip(batch, ok):
            if r.tenant is not None:
                key = (r.tenant, good)
                tenant_outcomes[key] = tenant_outcomes.get(key, 0) + 1
            if good:
                lat = now - r.t_enqueue
                self._h_latency.observe(lat)
                if r.tenant is not None:
                    self._tenant_latency(r.tenant).observe(lat)
        for (tenant, good), n in tenant_outcomes.items():
            name = "tmog_serve_batcher_completed_total" if good \
                else "tmog_serve_batcher_failed_total"
            self._tenant_counter(name, tenant).inc(n)
        tracked = []
        for r, res, good in zip(batch, results, ok):
            if good:
                r.future.set_result(res)
            else:
                r.future.set_exception(res)
            if r.ctx is not None:
                tracked.append(
                    (r, "ok" if good
                     else f"error:{type(res).__name__}"))
        self._emit_request_tracks(bt, t_claim, tracked)

    def _emit_request_tracks(self, bt, t_claim: float, tracked) -> None:
        """Export the flushed batch's request tracks as ONE ring slot
        (obs/reqtrace.py): ``tracked`` is [(request, outcome), ...] for the
        requests that were minted ids at submit.  Per-request cost is one
        small tuple."""
        if not tracked:
            return
        tracer = obs_trace.active_tracer()
        if tracer is None:
            return
        rows = []
        for r, outcome in tracked:
            rows.append((r.ctx, r.t_enqueue, r.tenant, r.slo, outcome))
            r.ctx = None
        tracer.add_request_batch(bt.seq, t_claim, rows)

    def _account_batch(self, bt, batch: List[_Request]) -> None:
        """Per-tenant device-time cost accounting: amortize the flushed
        batch's device phase marks across its constituent tenants (exact
        for the fleet's per-tenant sub-batch dispatches; record-share for
        untagged time) — the per-tenant totals sum to the batch total."""
        # the tenants are read only when untagged device time is amortized
        device_s, per_tenant, padded = reqtrace.batch_device_cost(
            bt, (r.tenant for r in batch))
        if padded:
            self._c_padding.inc(padded)
        if device_s <= 0.0:
            return
        self._c_device_seconds.inc(device_s)
        for tenant, secs in per_tenant.items():
            self._tenant_counter("tmog_serve_batcher_device_seconds_total",
                                 tenant).inc(secs)
