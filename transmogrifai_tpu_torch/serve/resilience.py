"""Fault-isolated scoring: quarantine, retry/backoff, and a circuit breaker
(counterpart of ``transmogrifai_tpu/serve/resilience.py``).

:class:`ResilientScorer` sits between the micro-batcher and the plan and
turns batch-level failures into per-record outcomes:

- **poison isolation** — a permanent batch failure bisect-and-retries:
  halves rescore until the records that fail alone are singled out and
  quarantined (:class:`~.faults.PoisonRecordError`, ``quarantined``
  counter, optional dead-letter callback); survivors rescore through the
  same plan, so their results equal a clean run's (row-local kernels,
  padding buckets).
- **transient retry** — retryable failures (:func:`~.faults.is_retryable`:
  :class:`~.faults.TransientScoringError`, ``torch.OutOfMemoryError``) back
  off exponentially with seeded jitter, at most ``max_retries`` times; a
  failure that survives the retries falls back to scoring in halves
  (smaller padding buckets) before it counts as a device failure.
- **circuit breaker** — ``failure_threshold`` consecutive device failures
  open the breaker: batches are served by the host path, logged at warning
  level, while every ``recovery_batches`` host-served batches a half-open
  probe tries the device again; one success recloses it.  The default host
  path is ``CompiledScoringPlan.score_host`` for a plan on the CPU only: a
  plan on the card has none by default, so a batch that still fails after
  the retries and splits fails its records (with the error, and with
  :class:`~.faults.CircuitOpenError` while the breaker is open) instead of
  moving to the CPU.

A kernel's or the device's own fault (``dispatch.is_kernel_fault``: a
:class:`KernelError`, ``torch.AcceleratorError``) is neither poison nor
transient: it fails every record of its batch with that error, and is never
bisected, quarantined, retried, counted toward the breaker or served from
the host path — a card or kernel that fails must show, not hide behind the
CPU.

Recovery is measured in batches, not wall-clock, so breaker behaviour is
deterministic under the fault harness (``serve/faults.py``).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from ..obs import flight as obs_flight
from ..obs import reqtrace
from ..obs.metrics import MetricsRegistry, canonical_help
from ..perf.kernels.dispatch import is_kernel_fault
from .faults import CircuitOpenError, PoisonRecordError, is_retryable

log = logging.getLogger(__name__)

#: bisect depth bound: 2^20 records per batch is far beyond any flush size
_MAX_SPLIT_DEPTH = 20


class CircuitBreaker:
    """closed -> open -> half-open state machine around the device plan.

    ``failure_threshold`` consecutive device failures open it; while open,
    every batch serves from the host path and after ``recovery_batches`` of
    those a half-open probe lets one batch try the device again — success
    recloses, failure re-opens (and restarts the recovery count).
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    #: numeric encoding of the state gauge
    _STATE_CODE = {"closed": 0, "open": 1, "half_open": 2}

    def __init__(self, failure_threshold: int = 3, recovery_batches: int = 8,
                 registry: Optional[MetricsRegistry] = None,
                 labels: Optional[Mapping[str, str]] = None):
        if failure_threshold < 1 or recovery_batches < 1:
            raise ValueError("failure_threshold and recovery_batches "
                             "must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.recovery_batches = int(recovery_batches)
        self.state = self.CLOSED
        self._lock = threading.Lock()
        self._consecutive = 0
        self._host_since_open = 0
        self._held_open = False
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg

        def _c(name):
            return reg.counter(name, canonical_help(name), labels=labels)

        self._c_opened = _c("tmog_serve_breaker_opened_total")
        self._c_reclosed = _c("tmog_serve_breaker_reclosed_total")
        self._c_probes = _c("tmog_serve_breaker_probes_total")
        self._g_state = reg.gauge("tmog_serve_breaker_state",
                                  canonical_help("tmog_serve_breaker_state"),
                                  labels=labels)
        #: bounded: a flapping dependency must not grow memory; totals live
        #: in the counters
        self.transitions: "deque[str]" = deque(maxlen=64)

    def _to(self, state: str) -> None:
        # flight-recorder event BEFORE the assignment so the record carries
        # both sides of the transition (obs/flight.py; no-op uninstalled)
        obs_flight.record_event("breaker_transition",
                                **{"from": self.state, "to": state})
        self.transitions.append(f"{self.state}->{state}")
        self.state = state
        self._g_state.set(self._STATE_CODE[state])

    # -- decision + outcome hooks (called once per batch) --------------------
    def allow_device(self) -> bool:
        """True when this batch may try the device plan (closed, or an open
        breaker due a half-open probe)."""
        with self._lock:
            if self.state == self.CLOSED or self.state == self.HALF_OPEN:
                return True
            if self._held_open:
                return False
            if self._host_since_open >= self.recovery_batches:
                self._to(self.HALF_OPEN)
                self._c_probes.inc()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self.state == self.HALF_OPEN:
                self._to(self.CLOSED)
                self._c_reclosed.inc()
            self._consecutive = 0

    def record_failure(self) -> None:
        with self._lock:
            if self.state == self.HALF_OPEN:
                # a failed probe is a fresh open
                self._to(self.OPEN)
                self._c_opened.inc()
                self._host_since_open = 0
                return
            self._consecutive += 1
            if self.state == self.CLOSED \
                    and self._consecutive >= self.failure_threshold:
                self._to(self.OPEN)
                self._c_opened.inc()
                self._host_since_open = 0

    def record_host_batch(self) -> None:
        with self._lock:
            if self.state == self.OPEN:
                self._host_since_open += 1

    # -- operator overrides ----------------------------------------------------
    def force_open(self) -> None:
        """Pin the breaker open (no half-open probes) until force_close()."""
        with self._lock:
            if self.state != self.OPEN:
                self._to(self.OPEN)
                self._c_opened.inc()
            self._held_open = True
            self._host_since_open = 0

    def force_close(self) -> None:
        with self._lock:
            self._held_open = False
            if self.state != self.CLOSED:
                self._to(self.CLOSED)
            self._consecutive = 0

    def metrics(self) -> Dict[str, Any]:
        """View over the ``tmog_serve_breaker_*`` registry counters."""
        with self._lock:
            state = self.state
            consecutive = self._consecutive
            transitions = list(self.transitions)
        return {"state": state,
                "consecutive_failures": consecutive,
                "transitions": transitions,
                "opened": self._c_opened.value,
                "reclosed": self._c_reclosed.value,
                "probes": self._c_probes.value}


class ResilientScorer:
    """Per-record fault isolation over a plan and its host path
    (``host_score``; by default the plan's ``score_host`` unless the plan is
    on the card).

    The micro-batcher detects ``score_isolated`` and uses it instead of the
    all-or-nothing batch contract: the return value is one entry per record,
    each either a result dict or an ``Exception`` (set on that record's
    future alone).
    """

    def __init__(self, plan, host_score: Optional[Callable] = None, *,
                 max_retries: int = 2, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0, failure_threshold: int = 3,
                 recovery_batches: int = 8,
                 dead_letter: Optional[Callable] = None,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 registry: Optional[MetricsRegistry] = None,
                 labels: Optional[Mapping[str, str]] = None,
                 tenant: Optional[str] = None):
        self._plan = plan
        self.tenant = tenant
        on_card = getattr(getattr(plan, "device", None), "type", None) == "cuda"
        if host_score is None and not on_card:
            host_score = getattr(plan, "score_host", None)
        self._host = host_score
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self.breaker = CircuitBreaker(failure_threshold=failure_threshold,
                                      recovery_batches=recovery_batches,
                                      registry=reg, labels=labels)
        self._dead_letter = dead_letter
        self._rng = random.Random(seed)
        self._sleep = sleep

        def _c(name):
            return reg.counter(name, canonical_help(name), labels=labels)

        self._c = {key: _c(f"tmog_serve_resilience_{key}_total")
                   for key in ("quarantined", "retries", "bucket_splits",
                               "bisect_batches", "device_failures",
                               "fallback_batches", "fallback_records")}

    # -- public entry points -------------------------------------------------
    def score_isolated(self, records: Sequence[Mapping[str, Any]]) -> List[Any]:
        """One outcome per record: a result dict, or the Exception that fails
        (only) that record's future."""
        if not records:
            return []
        if self.breaker.allow_device():
            try:
                out = self._device_with_retry(list(records))
                self.breaker.record_success()
                return out
            except Exception as e:  # noqa: BLE001 — classified below
                return self._classify_failure(records, e)
        return self._host_fallback(records)

    def begin_isolated(self, records: Sequence[Mapping[str, Any]]
                       ) -> Callable[[], List[Any]]:
        """Stage-split twin of :meth:`score_isolated` for the pipelined
        batcher: runs the plan's encode and device dispatch now
        (``plan.begin_score``) and returns a closure producing the per-record
        outcomes.  The breaker decides once, here; a failure at either stage
        resumes the lockstep recovery (``_device_with_retry`` with the
        observed exception as its first attempt, then the same
        classification) on the finalizer thread."""
        if not records:
            return lambda: []
        records = list(records)
        if not self.breaker.allow_device():
            return lambda: self._host_fallback(records)
        begin = getattr(self._plan, "begin_score", None)
        if begin is None:
            def _deferred() -> List[Any]:
                try:
                    out = self._device_with_retry(records)
                    self.breaker.record_success()
                    return out
                except Exception as e:  # noqa: BLE001 — classified below
                    return self._classify_failure(records, e)
            return _deferred
        try:
            fin = begin(records)
        except Exception as e:  # noqa: BLE001 — recovered at finalize
            err = e

            def _recover_begin() -> List[Any]:
                return self._resume_after(records, err)
            return _recover_begin

        def _finalize() -> List[Any]:
            try:
                out = fin()
            except Exception as e:  # noqa: BLE001 — recovered below
                return self._resume_after(records, e)
            self.breaker.record_success()
            return out
        return _finalize

    def _resume_after(self, records: List[Any], e: BaseException) -> List[Any]:
        """Re-enter the lockstep retry/classification path after a failed
        pipelined first attempt."""
        try:
            out = self._device_with_retry(records, pending=e)
            self.breaker.record_success()
            return out
        except Exception as e2:  # noqa: BLE001 — classified below
            return self._classify_failure(records, e2)

    def _classify_failure(self, records: Sequence[Mapping[str, Any]],
                          e: BaseException) -> List[Any]:
        """The post-retry failure classification both entry points share."""
        if is_kernel_fault(e):
            return self._kernel_fault(records, e)
        if is_retryable(e):
            # an infrastructure failure that survived the retries and the
            # split into smaller buckets: a device problem, not a record
            # problem — count it toward the breaker and serve this batch
            # from the host path, or fail it with the error where there is
            # none (a plan on the card)
            self.breaker.record_failure()
            self._c["device_failures"].inc()
            if self._host is None:
                self.breaker.record_host_batch()
                log.warning("device scoring failed after retries (%s: %s); "
                            "no host path, failing the batch of %d record(s)",
                            type(e).__name__, e, len(records))
                return [e for _ in records]
            log.warning("device scoring failed after retries (%s: "
                        "%s); serving batch from the host path",
                        type(e).__name__, e)
            return self._host_fallback(records)
        # permanent failure: some record(s) in the batch are poison —
        # bisect so only those are quarantined
        try:
            out = self._isolate(list(records), self._device_with_retry, e)
        except Exception as e2:  # noqa: BLE001 — only kernel faults escape
            if is_kernel_fault(e2):
                return self._kernel_fault(records, e2)
            raise
        if any(not isinstance(r, Exception) for r in out):
            # the device path served the survivors: a healthy plan
            self.breaker.record_success()
        return out

    def _kernel_fault(self, records: Sequence[Any], e: BaseException) -> List[Any]:
        log.error("kernel or device fault (%s: %s); failing the batch of %d "
                  "record(s)", type(e).__name__, e, len(records))
        return [e for _ in records]

    def __call__(self, records: Sequence[Mapping[str, Any]]) -> List[Dict[str, Any]]:
        """All-or-nothing contract: raise the first per-record error."""
        out = self.score_isolated(records)
        for r in out:
            if isinstance(r, Exception):
                raise r
        return out

    def metrics(self) -> Dict[str, Any]:
        """View over the ``tmog_serve_resilience_*`` registry counters."""
        out: Dict[str, Any] = {k: c.value for k, c in self._c.items()}
        out["breaker"] = self.breaker.metrics()
        return out

    # -- device path ---------------------------------------------------------
    def _device_with_retry(self, records: List[Any], depth: int = 0,
                           pending: Optional[BaseException] = None):
        """Retry loop around ``plan.score``.  ``pending`` is an exception the
        pipelined first attempt already observed: it takes the loop's first
        try, so the retry/split accounting equals lockstep's."""
        attempt = 0
        while True:
            try:
                if pending is not None:
                    e, pending = pending, None
                    raise e
                return self._plan.score(records)
            except Exception as e:  # noqa: BLE001 — classified below
                if not is_retryable(e):
                    raise
                if attempt < self.max_retries:
                    delay = min(self.backoff_cap_s,
                                self.backoff_base_s * (2 ** attempt))
                    # full jitter (seeded when the caller needs determinism)
                    self._sleep(delay * (0.5 + 0.5 * self._rng.random()))
                    attempt += 1
                    self._c["retries"].inc()
                    # the retry lands in the request causal chain
                    reqtrace.mark_phase("retry", time.perf_counter(), 0.0,
                                        attempt=attempt,
                                        cause=type(e).__name__)
                    continue
                if len(records) > 1 and depth < _MAX_SPLIT_DEPTH:
                    # batch-shaped failure (memory scales with the padding
                    # bucket): halve into smaller buckets
                    self._c["bucket_splits"].inc()
                    mid = len(records) // 2
                    return (self._device_with_retry(records[:mid], depth + 1)
                            + self._device_with_retry(records[mid:], depth + 1))
                raise

    # -- poison isolation ----------------------------------------------------
    def _isolate(self, records: List[Any], score_fn: Callable,
                 exc: BaseException) -> List[Any]:
        """Bisect-and-retry: rescore halves until the failing records are
        singled out; survivors come back equal to a clean run.  A kernel
        fault met on the way is raised, not bisected."""
        if len(records) == 1:
            return [self._quarantine(records[0], exc)]
        self._c["bisect_batches"].inc()
        reqtrace.mark_phase("bisect", time.perf_counter(), 0.0,
                            records=len(records))
        mid = len(records) // 2
        out: List[Any] = []
        for half in (records[:mid], records[mid:]):
            try:
                out.extend(score_fn(half))
            except Exception as e:  # noqa: BLE001 — recurse to singletons
                if is_kernel_fault(e):
                    raise
                out.extend(self._isolate(half, score_fn, e))
        return out

    def _quarantine(self, record, exc: BaseException) -> PoisonRecordError:
        self._c["quarantined"].inc()
        # flight-recorder postmortem trail (cause TYPE only — a record
        # payload must never leak into a telemetry dump); the fleet's
        # tenant attribution threads through
        attribution = {} if self.tenant is None else {"tenant": self.tenant}
        obs_flight.record_event("quarantine", cause=type(exc).__name__,
                                **attribution)
        err = PoisonRecordError(
            f"record quarantined: scoring failed with "
            f"{type(exc).__name__}: {exc}", cause=exc)
        if self._dead_letter is not None:
            try:
                self._dead_letter(record, exc)
                obs_flight.record_event("dead_letter",
                                        cause=type(exc).__name__,
                                        **attribution)
            except Exception as dl:  # noqa: BLE001 — DLQ must not break serving
                log.warning("dead-letter callback failed: %s", dl)
        return err

    # -- degraded host path --------------------------------------------------
    def _host_fallback(self, records: Sequence[Mapping[str, Any]]) -> List[Any]:
        self.breaker.record_host_batch()
        if self._host is None:
            err = CircuitOpenError(
                "device plan unavailable and no host fallback configured")
            return [err for _ in records]
        log.warning("serving a batch of %d record(s) from the host path "
                    "(breaker %s)", len(records), self.breaker.state)
        try:
            out = self._host(list(records))
        except Exception as e:  # noqa: BLE001 — isolate on the host path too
            out = self._isolate(list(records), self._host, e)
        self._c["fallback_batches"].inc()
        self._c["fallback_records"].inc(
            sum(1 for r in out if not isinstance(r, Exception)))
        return out
