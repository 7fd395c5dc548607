"""Multi-tenant serving fleet: a model registry and an SLO-tiered shared
batcher (counterpart of ``transmogrifai_tpu/serve/registry.py``).

After Clipper (Crankshaw et al., NSDI'17): many tenants' models behind one
adaptive batching layer, each with its own lifecycle and overload
protection.

- :class:`ModelRegistry` — the control plane.  Hosts N tenants, each with
  its own :class:`~.swap.SwappableScorer` lifecycle (stage / promote /
  rollback per tenant) built as :class:`~.server.ScoringServer` builds
  its.  Plans of one fingerprint on one device share their device-side
  prefix state (``serve/plan.py::_SharedPrefix``: staging buffers,
  constants, the dispatch lock), so a tenant whose fingerprint is already
  warm allocates nothing on the card; the registry counts such
  registrations (``shared_prefix_registrations``).
- **Device-memory admission and eviction** — on ``register()`` /
  ``stage_candidate()`` the registry sums the static peak estimates
  (``checkers/plancheck.py``, nothing allocated) of every distinct warm
  fingerprint plus the candidate's.  Over ``hbm_budget`` it releases cold
  tenants' warm buckets, least recently scored first
  (:meth:`~.plan.CompiledScoringPlan.release_executables`, sparing
  fingerprints another warm tenant shares); a candidate that still does
  not fit is refused with **TM509** (``serve/validator.py``).
- :class:`FleetServer` — the data plane.  One shared
  :class:`~.batcher.MicroBatcher` fronts every tenant:
  ``submit(tenant, record, slo=...)`` tags requests with per-tenant SLO
  classes, backpressure sheds the lowest tier first, and a tenant whose
  circuit breaker opens is marked degraded, so its traffic takes the
  shedding cuts.  A flushed batch fans out per tenant
  (``score_isolated_tenants`` / ``begin_isolated_tenants``): each tenant
  sub-batch is one plan batch, one launch of the encode kernel, and the
  ``route`` fault point fires per tenant sub-batch, so one tenant's fault
  fails only its records.

Per-tenant labels flow through the shared metrics registry
(``obs/metrics.py``): resilience, breaker and swap series carry
``{tenant="...", entry="<tenant>/<version>"}``, the batcher adds labeled
shed counters and latency histograms, and :meth:`ModelRegistry.unregister`
prunes every series of a removed tenant.  Not ported: the reference's
deploy artifacts (``register(artifact=)`` raises by name), and its request
traces and flight-recorder events.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

from ..checkers.diagnostics import OpCheckError
from ..obs import flight as obs_flight
from ..obs import reqtrace
from ..obs.metrics import MetricsRegistry, canonical_help
from ..perf.kernels.dispatch import resolve_device
from ..workflow.workflow import _refuse_unported
from .batcher import DEFAULT_SLO_CLASSES, MicroBatcher, SloClass
from .faults import fault_point
from .pipeline import pipeline_depth as _env_pipeline_depth
from .plan import CompiledScoringPlan
from .resilience import ResilientScorer
from .server import default_max_bucket, resolve_resilience_params
from .swap import ModelEntry, SwappableScorer

log = logging.getLogger(__name__)


class UnknownTenantError(LookupError):
    """The tenant id is not (or no longer) registered in the fleet."""


class TenantState:
    """One tenant's registry row: SLO class, swappable scorer lifecycle,
    and the LRU clock the eviction policy orders by."""

    __slots__ = ("tenant", "slo", "swapper", "versions", "last_scored",
                 "registered_at")

    def __init__(self, tenant: str, slo: str, swapper: SwappableScorer):
        self.tenant = tenant
        self.slo = slo
        self.swapper = swapper
        self.versions = itertools.count(2)  # version 1 is the initial entry
        self.last_scored = time.monotonic()
        self.registered_at = time.monotonic()

    def live_plans(self) -> List[CompiledScoringPlan]:
        return [e.plan for e in self.swapper.live_entries()]

    def breaker(self):
        res = self.swapper.active.resilience
        return getattr(res, "breaker", None) if res is not None else None


class ModelRegistry:
    """The fleet control plane: tenant table, per-tenant model lifecycle,
    and the device-memory admission/eviction controller.

    Plans of one fingerprint share their device-side prefix state
    (``serve/plan.py``); the registry's own state is the tenant table plus
    a fingerprint -> static peak estimate memo (each fingerprint analyzed
    once, nothing allocated).  Plans run on ``device`` (the CUDA card
    unless it names another).
    """

    def __init__(self, *, min_bucket: int = 8, max_bucket: int = 1024,
                 hbm_budget: Optional[float] = None,
                 resilience: Union[bool, Mapping[str, Any]] = True,
                 deadline_ms: Optional[float] = None,
                 max_wait_ms: float = 2.0,
                 slo_classes: Optional[Mapping[str, SloClass]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device=None):
        self.device = resolve_device(device)
        #: landing sets each plan reserves per bucket (``reserve_inflight``):
        #: a fleet sets its pipeline depth + 1
        self.inflight = 1
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.hbm_budget = hbm_budget
        self.slo_classes: Dict[str, SloClass] = dict(
            DEFAULT_SLO_CLASSES if slo_classes is None else slo_classes)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._resilience_params = resolve_resilience_params(
            resilience, deadline_ms, max_wait_ms)
        self._lock = threading.Lock()
        # serializes the control plane (register/stage/unregister): the
        # admission pass is check-then-act over the whole residency view,
        # so two concurrent registrations must not both pass the budget
        # check before either's buckets become resident
        self._admission_lock = threading.Lock()
        self._tenants: Dict[str, TenantState] = {}
        self._plan_bytes: Dict[str, int] = {}  # fingerprint -> peak HBM

        def _c(name):
            return self.registry.counter(name, canonical_help(name))

        self._c_registrations = _c("tmog_serve_fleet_registrations_total")
        self._c_shared_prefix = _c("tmog_serve_fleet_shared_prefix_total")
        self._c_evictions = _c("tmog_serve_fleet_evictions_total")
        self._c_refusals = _c("tmog_serve_fleet_admission_refusals_total")
        self._g_tenants = self.registry.gauge(
            "tmog_serve_fleet_tenants",
            canonical_help("tmog_serve_fleet_tenants"))

    # -- tenant table --------------------------------------------------------
    def get(self, tenant: str) -> TenantState:
        with self._lock:
            state = self._tenants.get(tenant)
        if state is None:
            raise UnknownTenantError(
                f"tenant {tenant!r} is not registered; known: "
                f"{self.tenants()}")
        return state

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def __contains__(self, tenant: str) -> bool:
        with self._lock:
            return tenant in self._tenants

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    # -- registration / lifecycle --------------------------------------------
    def register(self, tenant: str, model, slo: str = "bronze",
                 warm: bool = True, artifact=None,
                 precision: Optional[str] = None,
                 calibration: Optional[Sequence[Mapping[str, Any]]] = None
                 ) -> TenantState:
        """Admit ``model`` for ``tenant`` under SLO class ``slo``.

        Builds the tenant's plan and fault-tolerance layer as
        :class:`~.server.ScoringServer` does, runs the fleet's admission
        pass (evicting cold tenants' warm buckets when over budget; TM509
        when eviction cannot make room), then warms the bucket ladder —
        allocating nothing on the device when another tenant already holds
        the fingerprint there.

        ``precision`` picks the plan's numeric class
        (:class:`~.plan.Precision`: ``f32``/``bf16``/``int8``).  A reduced
        class faces the TM511 calibration parity gate before admission:
        the plan's max prediction delta vs the same model's f32 plan over
        the calibration batch must sit within the class bound, or
        registration raises.  ``calibration`` supplies real records for
        that batch; without it a deterministic synthetic batch runs through
        the device prefix with magnitude-normalized deltas.  Reduced
        classes carry the class in their fingerprint, so they never share
        prefix state with f32 tenants.

        ``artifact`` (the reference's deploy artifact store) is not ported
        and raises ``NotImplementedError`` by name.
        """
        _refuse_unported("ModelRegistry.register",
                         {"artifact (deploy/)": artifact is not None})
        if slo not in self.slo_classes:
            raise ValueError(f"unknown SLO class {slo!r}; configured: "
                             f"{sorted(self.slo_classes)}")
        with self._admission_lock:  # one admission decision at a time
            with self._lock:
                if tenant in self._tenants:
                    raise ValueError(
                        f"tenant {tenant!r} is already registered; "
                        "stage_candidate() replaces its model")
            # the fault point fires BEFORE any state mutates: an injected
            # register fault leaves the fleet exactly as it was
            fault_point("register", tenant=tenant, slo=slo)
            entry = self._build_entry(tenant, model, version=1,
                                      precision=precision)
            self._check_precision(tenant, model, entry.plan,
                                  calibration=calibration)
            shared = self._is_resident(entry.plan.fingerprint)
            self._admit(tenant, entry.plan)
            if warm:
                entry.plan.warm()
            swapper = SwappableScorer(entry, registry=self.registry,
                                      labels={"tenant": tenant},
                                      tenant=tenant)
            state = TenantState(tenant, slo, swapper)
            with self._lock:
                self._tenants[tenant] = state
                self._g_tenants.set(len(self._tenants))
            self._c_registrations.inc()
            if shared:
                self._c_shared_prefix.inc()
            # per-tenant scored-records series exists from registration on,
            # so a scrape shows the tenant even before its first request
            self._scored_counter(tenant)
        obs_flight.record_event("fleet_register", tenant=tenant, slo=slo,
                                fingerprint=entry.fingerprint,
                                shared_prefix=shared)
        return state

    def unregister(self, tenant: str) -> None:
        """Remove a tenant: release its warm buckets (sparing fingerprints
        another tenant still serves warm) and prune every metric series
        labeled with it from exposition."""
        with self._admission_lock:
            state = self.get(tenant)
            with self._lock:
                del self._tenants[tenant]
                self._g_tenants.set(len(self._tenants))
            for plan in state.live_plans():
                plan.release_executables(
                    drop_shared=not self._is_resident(plan.fingerprint))
        self.registry.drop_labeled("tenant", tenant)
        # entry-labeled series are namespaced "<tenant>/<version>"
        for value in self.registry.labeled_values("entry"):
            if value.startswith(f"{tenant}/"):
                self.registry.drop_labeled("entry", value)
        obs_flight.record_event("fleet_unregister", tenant=tenant)

    def _build_entry(self, tenant: str, model, version: int,
                     warm: bool = False,
                     precision: Optional[str] = None) -> ModelEntry:
        plan = CompiledScoringPlan(model, min_bucket=self.min_bucket,
                                   max_bucket=self.max_bucket,
                                   precision=precision, device=self.device)
        plan.reserve_inflight(self.inflight)
        if warm:
            plan.warm()
        res = None
        if self._resilience_params is not None:
            res = ResilientScorer(
                plan, registry=self.registry,
                labels={"tenant": tenant, "entry": f"{tenant}/{version}"},
                tenant=tenant, **self._resilience_params)
        return ModelEntry(model, plan, res, version)

    def _check_precision(self, tenant: str, model,
                         plan: CompiledScoringPlan,
                         calibration: Optional[
                             Sequence[Mapping[str, Any]]] = None) -> None:
        """TM511 admission gate: a reduced-precision plan must match the
        same model's f32 plan within its class bound over the calibration
        batch, or the registry refuses it.  Not run for f32.  The f32 twin
        exists only for the gate: its device state is released after it,
        and a refused candidate's too."""
        from .plan import Precision
        from .validator import check_precision_parity

        if plan.precision == Precision.F32:
            return
        f32_plan = CompiledScoringPlan(model, min_bucket=self.min_bucket,
                                       max_bucket=self.max_bucket,
                                       strict=False, device=self.device)
        try:
            report = check_precision_parity(f32_plan, plan, records=calibration)
        finally:
            f32_plan.release_executables(
                drop_shared=not self._is_resident(f32_plan.fingerprint))
        delta = report.max_precision_delta
        if report.errors():
            plan.release_executables(drop_shared=not self._is_resident(plan.fingerprint))
            obs_flight.record_event(
                "fleet_precision_refused", tenant=tenant,
                precision=plan.precision, max_delta=delta)
            raise OpCheckError(report)
        obs_flight.record_event(
            "fleet_precision_admitted", tenant=tenant,
            precision=plan.precision, max_delta=delta)

    # -- blue/green lifecycle, per tenant ------------------------------------
    def stage_candidate(self, tenant: str, model, warm: bool = True,
                        precision: Optional[str] = None,
                        calibration: Optional[
                            Sequence[Mapping[str, Any]]] = None) -> str:
        """Build + stage a candidate for ``tenant``'s shadow scoring —
        TM507 swap-compatibility (result schema AND precision class),
        TM511 calibration parity for reduced-precision candidates, and
        fleet admission all run (the candidate's buckets stay resident until
        promote/discard) before any bucket is built.  Returns the
        candidate's fingerprint."""
        from .validator import check_swap_compatibility

        with self._admission_lock:
            state = self.get(tenant)
            entry = self._build_entry(tenant, model,
                                      version=next(state.versions),
                                      precision=precision)
            report = check_swap_compatibility(state.swapper.active.plan,
                                              entry.plan)
            if report.errors():
                raise OpCheckError(report)
            self._check_precision(tenant, model, entry.plan,
                                  calibration=calibration)
            for d in report:
                log.info("%s", d.pretty())
            self._admit(tenant, entry.plan)
            if warm:
                entry.plan.warm()
            state.swapper.stage(entry)
        self._prune_entry_metrics(state)
        return entry.fingerprint

    def promote(self, tenant: str, probation_batches: int = 8
                ) -> Dict[str, Any]:
        record = self.get(tenant).swapper.promote(
            probation_batches=probation_batches)
        self._prune_entry_metrics(self.get(tenant))
        return record

    def rollback(self, tenant: str, reason: str = "manual") -> Dict[str, Any]:
        record = self.get(tenant).swapper.rollback(reason=reason)
        self._prune_entry_metrics(self.get(tenant))
        return record

    def discard_candidate(self, tenant: str) -> None:
        state = self.get(tenant)
        state.swapper.discard_candidate()
        self._prune_entry_metrics(state)

    def shadow_report(self, tenant: str) -> Dict[str, Any]:
        return self.get(tenant).swapper.shadow_report()

    def _prune_entry_metrics(self, state: TenantState) -> None:
        """Drop exported series of this tenant's dead model entries (the
        same bounded-exposition contract as ScoringServer, namespaced per
        tenant so generations never collide across the fleet)."""
        live = {f"{state.tenant}/{e.version}"
                for e in state.swapper.live_entries()}
        for value in self.registry.labeled_values("entry"):
            if value.startswith(f"{state.tenant}/") and value not in live:
                self.registry.drop_labeled("entry", value)

    # -- device-memory admission / eviction ----------------------------------
    def _peak_bytes(self, plan: CompiledScoringPlan) -> int:
        """Static peak device-memory estimate of ``plan`` (TM601's number),
        memoized per fingerprint — the meta trace runs once per distinct
        plan."""
        fp = plan.fingerprint
        with self._lock:
            cached = self._plan_bytes.get(fp)
        if cached is not None:
            return cached
        if not plan.device_stage_uids:
            peak = 0
        else:
            from ..checkers.plancheck import analyze_scoring_plan

            peak = int(analyze_scoring_plan(plan).peak_hbm_bytes)
        with self._lock:
            self._plan_bytes[fp] = peak
        return peak

    def _warm_fingerprints(self, exclude_tenant: Optional[str] = None
                           ) -> Dict[str, int]:
        """{fingerprint: peak bytes} over every live plan currently holding
        warm buckets (the fleet's device residency view)."""
        with self._lock:
            states = [s for t, s in self._tenants.items()
                      if t != exclude_tenant]
            # snapshot under the same lock _peak_bytes writes under — the
            # per-plan loop below must not race a concurrent memoization
            plan_bytes = dict(self._plan_bytes)
        out: Dict[str, int] = {}
        for s in states:
            for plan in s.live_plans():
                if plan.warm_buckets():
                    out[plan.fingerprint] = plan_bytes.get(
                        plan.fingerprint, 0)
        return out

    def _is_resident(self, fingerprint: str) -> bool:
        return fingerprint in self._warm_fingerprints()

    def resident_hbm_bytes(self) -> int:
        return sum(self._warm_fingerprints().values())

    def _admit(self, tenant: str, plan: CompiledScoringPlan) -> None:
        """Fleet admission of one candidate plan: evict cold tenants' warm
        buckets (least recently scored first) until the candidate fits, or
        refuse with TM509.  No budget: always admit."""
        # the static estimate is memoized unconditionally so the fleet's
        # resident_hbm_bytes figure is meaningful even without a budget
        need = self._peak_bytes(plan)
        if self.hbm_budget is None:
            return
        evicted: List[str] = []
        while True:
            resident = self._warm_fingerprints()
            resident.pop(plan.fingerprint, None)  # shared prefix: already paid
            if need + sum(resident.values()) <= self.hbm_budget:
                return
            victim = self._coldest_warm_tenant(exclude=tenant)
            if victim is None:
                break
            # fires BEFORE the eviction mutates anything: an injected evict
            # fault aborts admission with every tenant still warm
            fault_point("evict", tenant=victim.tenant)
            freed = self._release_tenant(victim)
            evicted.append(victim.tenant)
            self._c_evictions.inc()
            obs_flight.record_event("fleet_evict", tenant=victim.tenant,
                                    freed_buckets=freed,
                                    for_tenant=tenant)
            log.warning("fleet admission: evicted cold tenant %r "
                        "(%d warm buckets) to admit %r",
                        victim.tenant, freed, tenant)
        resident = self._warm_fingerprints()
        resident.pop(plan.fingerprint, None)
        from .validator import check_fleet_admission

        report = check_fleet_admission(tenant, need, sum(resident.values()),
                                       self.hbm_budget, evicted=evicted)
        if report.errors():
            self._c_refusals.inc()
            obs_flight.record_event("fleet_admission_refused", tenant=tenant,
                                    need_bytes=need,
                                    resident_bytes=sum(resident.values()))
            raise OpCheckError(report)

    def _coldest_warm_tenant(self, exclude: str) -> Optional[TenantState]:
        """LRU eviction victim.  Prefers tenants whose release actually
        frees resident bytes — a tenant whose every warm fingerprint some
        other warm tenant shares frees nothing, so evicting it first would
        only cost its warm state.  When no single tenant frees bytes (a
        fingerprint held only by a group of evictable sharers) fall back
        to plain LRU: releasing the group one by one converges."""
        with self._lock:
            candidates = [s for t, s in self._tenants.items() if t != exclude]
        candidates = [s for s in candidates
                      if any(p.warm_buckets() for p in s.live_plans())]
        if not candidates:
            return None

        def frees_bytes(s: TenantState) -> bool:
            others = self._warm_fingerprints(exclude_tenant=s.tenant)
            return any(p.warm_buckets() and p.fingerprint not in others
                       for p in s.live_plans())

        pool = [s for s in candidates if frees_bytes(s)] or candidates
        return min(pool, key=lambda s: s.last_scored)

    def _release_tenant(self, state: TenantState) -> int:
        """Release every warm bucket the tenant holds; a fingerprint some
        other tenant still serves warm keeps its shared state, so the
        sharer serves on without an allocation."""
        freed = 0
        for plan in state.live_plans():
            if not plan.warm_buckets():
                continue
            others = self._warm_fingerprints(exclude_tenant=state.tenant)
            freed += plan.release_executables(
                drop_shared=plan.fingerprint not in others)
        return freed

    # -- observability -------------------------------------------------------
    def _scored_counter(self, tenant: str):
        return self.registry.counter(
            "tmog_serve_fleet_scored_records_total",
            canonical_help("tmog_serve_fleet_scored_records_total"),
            labels={"tenant": tenant})

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            states = dict(self._tenants)
        tenants: Dict[str, Any] = {}
        for t, s in sorted(states.items()):
            active = s.swapper.active
            tenants[t] = {
                "slo": s.slo,
                "fingerprint": active.fingerprint,
                "precision": active.plan.precision,
                "warm_buckets": active.plan.warm_buckets(),
                "plan": active.plan.metrics(),
                "swap": s.swapper.metrics(),
                "scored_records": self._scored_counter(t).value,
            }
            if active.resilience is not None:
                tenants[t]["resilience"] = active.resilience.metrics()
        return {
            "tenants": tenants,
            "fleet": {
                "tenants": len(states),
                "registrations": self._c_registrations.value,
                "shared_prefix_registrations": self._c_shared_prefix.value,
                "evictions": self._c_evictions.value,
                "admission_refusals": self._c_refusals.value,
                "hbm_budget": self.hbm_budget,
                "resident_hbm_bytes": self.resident_hbm_bytes(),
            },
        }


class FleetServer:
    """N tenants' models behind one shared micro-batcher (the data plane).

    - ``register(tenant, model, slo=...)`` / ``unregister(tenant)`` —
      tenant lifecycle through the :class:`ModelRegistry` control plane
      (device-memory admission, eviction, shared prefix state).
    - ``submit(tenant, record, slo=..., deadline_ms=...) -> Future`` — the
      production request path: micro-batched across tenants, SLO-tiered
      load shedding under backpressure, per-tenant fault isolation.
    - ``stage_candidate(tenant, ...)`` / ``promote(tenant)`` /
      ``rollback(tenant)`` — per-tenant blue/green lifecycle.
    - ``metrics()`` — fleet + per-tenant + batcher counters, one dict; the
      shared metrics registry exports everything labeled by tenant.

    The parameters are the reference's, in its order, and ``device`` by
    keyword only: every tenant's plan runs there (the CUDA card unless it
    names another).
    """

    def __init__(self, max_batch: int = 256, max_wait_ms: float = 2.0,
                 max_queue: int = 4096, min_bucket: int = 8,
                 max_bucket: Optional[int] = None,
                 resilience: Union[bool, Mapping[str, Any]] = True,
                 deadline_ms: Optional[float] = None,
                 hbm_budget: Optional[float] = None,
                 slo_classes: Optional[Mapping[str, SloClass]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 pipeline_depth: Optional[int] = None, *, device=None):
        if max_bucket is None:
            max_bucket = default_max_bucket(max_batch, min_bucket)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.default_deadline_ms = deadline_ms
        depth = _env_pipeline_depth() if pipeline_depth is None \
            else max(0, int(pipeline_depth))
        self.models = ModelRegistry(
            min_bucket=min_bucket, max_bucket=max_bucket,
            hbm_budget=hbm_budget, resilience=resilience,
            deadline_ms=deadline_ms, max_wait_ms=max_wait_ms,
            slo_classes=slo_classes, registry=self.registry, device=device)
        # each plan reserves a landing set per batch the pipeline can hold
        # begun and not yet finalized
        self.models.inflight = depth + 1
        self.batcher = MicroBatcher(self, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    max_queue=max_queue,
                                    registry=self.registry,
                                    slo_classes=self.models.slo_classes,
                                    pipeline_depth=depth)
        #: armed by :meth:`arm_slo_monitor`; polled by statusz()
        self.slo_monitor = None
        #: {tenant: (monotonic ts, completed)} — the statusz() rps baseline
        self._statusz_prev: Dict[str, Any] = {}

    # -- tenant lifecycle (delegates to the control plane) -------------------
    def register(self, tenant: str, model, slo: str = "bronze",
                 warm: bool = True, artifact=None,
                 precision: Optional[str] = None,
                 calibration: Optional[Sequence[Mapping[str, Any]]] = None
                 ) -> "FleetServer":
        self.models.register(tenant, model, slo=slo, warm=warm,
                             artifact=artifact, precision=precision,
                             calibration=calibration)
        return self

    def unregister(self, tenant: str) -> None:
        self.batcher.drain_pipeline()  # in-flight batches may hold the tenant
        self.models.unregister(tenant)
        self.batcher.drop_tenant(tenant)

    def tenants(self) -> List[str]:
        return self.models.tenants()

    def stage_candidate(self, tenant: str, model, warm: bool = True,
                        precision: Optional[str] = None,
                        calibration: Optional[
                            Sequence[Mapping[str, Any]]] = None) -> str:
        return self.models.stage_candidate(tenant, model, warm=warm,
                                           precision=precision,
                                           calibration=calibration)

    def promote(self, tenant: str, probation_batches: int = 8
                ) -> Dict[str, Any]:
        # drain the pipelined window first (no-op in lockstep): in-flight
        # batches complete on the entry they captured at begin, so the
        # promotion can never split one — draining makes the cutover
        # observable-clean for the swap record and probation accounting
        self.batcher.drain_pipeline()
        return self.models.promote(tenant,
                                   probation_batches=probation_batches)

    def rollback(self, tenant: str, reason: str = "manual") -> Dict[str, Any]:
        self.batcher.drain_pipeline()
        return self.models.rollback(tenant, reason=reason)

    def discard_candidate(self, tenant: str) -> None:
        self.models.discard_candidate(tenant)

    def shadow_report(self, tenant: str) -> Dict[str, Any]:
        return self.models.shadow_report(tenant)

    # -- request paths -------------------------------------------------------
    def submit(self, tenant: str, record: Mapping[str, Any],
               deadline_ms: Optional[float] = None,
               slo: Union[None, str, SloClass] = None) -> Future:
        """Enqueue one record for ``tenant``; the SLO class defaults to the
        tenant's registered class."""
        state = self.models.get(tenant)  # UnknownTenantError before queueing
        if slo is None:
            slo = state.slo
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        return self.batcher.submit(record, deadline_ms=deadline_ms,
                                   tenant=tenant, slo=slo)

    def score(self, tenant: str, record: Mapping[str, Any],
              timeout: Optional[float] = None,
              deadline_ms: Optional[float] = None,
              slo: Union[None, str, SloClass] = None) -> Dict[str, Any]:
        return self.submit(tenant, record, deadline_ms=deadline_ms,
                           slo=slo).result(timeout)

    def score_isolated_tenants(self, records: Sequence[Mapping[str, Any]],
                               tenants: Sequence[Optional[str]]
                               ) -> List[Any]:
        """The batcher-facing fan-out: one outcome per record, each scored
        on its tenant's swappable stack.  An unknown tenant (unregistered
        between submit and flush) fails only its own records, and the
        per-tenant ``route`` fault point makes one tenant's injected fault
        invisible to every co-flushed tenant.  After each sub-batch the
        tenant's breaker state drives the batcher's degraded set (shedding
        escalation)."""
        groups: Dict[Optional[str], List[int]] = {}
        for i, t in enumerate(tenants):
            groups.setdefault(t, []).append(i)
        out: List[Any] = [None] * len(records)
        for tenant, idxs in groups.items():
            sub = [records[i] for i in idxs]
            try:
                if tenant is None:
                    raise UnknownTenantError(
                        "fleet submit requires a tenant id")
                state = self.models.get(tenant)
                fault_point("route", tenant=tenant, records=len(sub))
                # tenant scope: the sub-batch's phase marks and serve spans
                # carry this tenant, so a shared flush's device time bills
                # each tenant exactly (obs/reqtrace.py cost accounting)
                with reqtrace.tenant_scope(tenant):
                    results = state.swapper.score_isolated(sub)
            except Exception as e:  # noqa: BLE001 — outcome-shaped per tenant
                results = [e] * len(sub)
                state = None
            for i, r in zip(idxs, results):
                out[i] = r
            if state is not None:
                state.last_scored = time.monotonic()
                ok = sum(1 for r in results if not isinstance(r, Exception))
                if ok:
                    self.models._scored_counter(tenant).inc(ok)
                breaker = state.breaker()
                if breaker is not None:
                    self.batcher.set_degraded(
                        tenant, breaker.state != breaker.CLOSED)
        return out

    def begin_isolated_tenants(self, records: Sequence[Mapping[str, Any]],
                               tenants: Sequence[Optional[str]]
                               ) -> Any:
        """Staged variant of :meth:`score_isolated_tenants` for the
        pipelined batcher (``serve/pipeline.py``): every tenant sub-batch
        runs its host encode and starts its device work now (on the flusher
        thread) and one finalize closure waits for the device outputs, runs
        the host remainders and does the per-tenant bookkeeping (LRU clock,
        scored counters, breaker-driven degraded set) on the finalizer
        thread.  Routing errors and begin-stage
        failures are captured per sub-batch and surface as that tenant's
        outcomes at finalize — the same isolation contract as lockstep."""
        groups: Dict[Optional[str], List[int]] = {}
        for i, t in enumerate(tenants):
            groups.setdefault(t, []).append(i)
        staged: List[Any] = []  # (tenant, idxs, state, sub, fin | None, err)
        for tenant, idxs in groups.items():
            sub = [records[i] for i in idxs]
            try:
                if tenant is None:
                    raise UnknownTenantError(
                        "fleet submit requires a tenant id")
                state = self.models.get(tenant)
                fault_point("route", tenant=tenant, records=len(sub))
                with reqtrace.tenant_scope(tenant):
                    fin = state.swapper.begin_isolated(sub)
                staged.append((tenant, idxs, state, sub, fin, None))
            except Exception as e:  # noqa: BLE001 — outcome-shaped per tenant
                staged.append((tenant, idxs, None, sub, None, e))

        def _finalize() -> List[Any]:
            out: List[Any] = [None] * len(records)
            for tenant, idxs, state, sub, fin, err in staged:
                if err is not None:
                    results: Sequence[Any] = [err] * len(sub)
                else:
                    try:
                        with reqtrace.tenant_scope(tenant):
                            results = fin()
                    except Exception as e:  # noqa: BLE001
                        results = [e] * len(sub)
                        state = None
                for i, r in zip(idxs, results):
                    out[i] = r
                if state is not None:
                    state.last_scored = time.monotonic()
                    ok = sum(1 for r in results
                             if not isinstance(r, Exception))
                    if ok:
                        self.models._scored_counter(tenant).inc(ok)
                    breaker = state.breaker()
                    if breaker is not None:
                        self.batcher.set_degraded(
                            tenant, breaker.state != breaker.CLOSED)
            return out

        return _finalize

    # -- lifecycle -----------------------------------------------------------
    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        self.batcher.shutdown(drain=drain, timeout=timeout)

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability -------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        out = self.models.metrics()
        out["batcher"] = self.batcher.metrics()
        per_tenant = self.batcher.tenant_metrics()
        for t, row in out["tenants"].items():
            row.update(per_tenant.get(t, {}))
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition of the fleet's shared registry —
        every series labeled by tenant, with HELP/TYPE headers for the
        whole canonical name table (docs/observability.md)."""
        return self.registry.to_prometheus(all_canonical=True)

    def metrics_snapshot(self) -> Dict[str, Any]:
        return self.registry.snapshot()

    def arm_slo_monitor(self, budgets=None, escalate: bool = True,
                        **kw):
        """Attach an :class:`~..obs.slo.SloMonitor` over the fleet's live
        tenant table and shared registry.  ``escalate=True`` wires budget
        exhaustion to :meth:`MicroBatcher.set_degraded` — the exhausted
        tenant joins the degraded set and absorbs the shedding cuts, so
        tenants still inside budget keep their p99 (shed-tier escalation).
        Pull-based: ``poll()`` runs from :meth:`statusz` or the caller's
        own cadence.
        Re-arming first disarms the previous monitor, so tenants it
        degraded are released instead of orphaned in the degraded set."""
        from ..obs.slo import SloMonitor

        if self.slo_monitor is not None:
            self.slo_monitor.disarm()

        def live_tenants() -> Dict[str, str]:
            out: Dict[str, str] = {}
            for t in self.models.tenants():
                try:
                    out[t] = self.models.get(t).slo
                except UnknownTenantError:  # raced an unregister
                    continue
            return out

        self.slo_monitor = SloMonitor(
            self.registry, live_tenants, budgets=budgets,
            escalate=self.batcher.set_degraded if escalate else None, **kw)
        return self.slo_monitor

    def statusz(self) -> Dict[str, Any]:
        """One JSON-able fleet status snapshot.

        Per tenant: request rate since the previous ``statusz()`` call,
        p99 latency, shed/deadline/failure counts, the device seconds its
        sub-batches spent (``tmog_serve_batcher_device_seconds_total``: the
        device prefix as the card's events time it), breaker state, warm buckets and, when
        :meth:`arm_slo_monitor` was called, the SLO budget and burn status
        (polling the monitor as a side effect)."""
        now = time.monotonic()
        slo_status = self.slo_monitor.poll() \
            if self.slo_monitor is not None else {}
        per_tenant = self.batcher.tenant_metrics()
        batcher = self.batcher.metrics()
        prev = self._statusz_prev
        nxt: Dict[str, Any] = {}
        tenants: Dict[str, Any] = {}
        for t in self.models.tenants():
            try:
                state = self.models.get(t)
            except UnknownTenantError:
                continue
            bt = per_tenant.get(t, {})
            completed = bt.get("completed", 0)
            last = prev.get(t)
            dt = (now - last[0]) if last is not None else None
            rps = round((completed - last[1]) / dt, 1) \
                if last is not None and dt and dt > 0 else None
            nxt[t] = (now, completed)
            active = state.swapper.active
            breaker = state.breaker()
            row: Dict[str, Any] = {
                "slo": state.slo,
                "precision": active.plan.precision,
                "rps": rps,
                "completed": completed,
                "failed": bt.get("failed", 0),
                "shed": bt.get("shed", 0),
                "deadline_expired": bt.get("deadline_expired", 0),
                "device_seconds": bt.get("device_seconds", 0.0),
                "p99_ms": bt.get("latency_p99_ms"),
                "breaker": breaker.state if breaker is not None else None,
                "warm_buckets": len(active.plan.warm_buckets()),
                "fingerprint": active.fingerprint[:16],
            }
            if t in slo_status:
                s = slo_status[t]
                row.update({"budget_remaining": s["budget_remaining"],
                            "burn_fast": s["burn_fast"],
                            "burn_slow": s["burn_slow"],
                            "slo_firing": s["firing"],
                            "escalated": s["escalated"]})
            tenants[t] = row
        self._statusz_prev = nxt
        return {
            "ts": round(time.time(), 3),
            "tenants": tenants,
            "fleet": {
                "tenants": len(tenants),
                "queue_depth": self.batcher.queue_depth,
                "resident_hbm_bytes": self.models.resident_hbm_bytes(),
                "hbm_budget": self.models.hbm_budget,
                "evictions": self.models._c_evictions.value,
                "shed": batcher["shed"],
                "device_seconds": batcher["device_seconds"],
                "slo_monitor_armed": self.slo_monitor is not None,
                "pipeline_depth": batcher["pipeline"]["depth"],
                "pipeline_overlap": batcher["pipeline"]["overlap_fraction"],
                "pipeline_stalls": batcher["pipeline"]["stalls"],
            },
        }
