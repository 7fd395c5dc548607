"""Atomic blue/green model swap and shadow scoring (counterpart of
``transmogrifai_tpu/serve/swap.py``).

:class:`SwappableScorer` is one swappable reference between the
micro-batcher and the fault-tolerance layer of :class:`~.server.ScoringServer`:

- **one active entry at a time** — every flushed batch reads the active
  (plan, resilience) entry once under the swap lock and scores entirely on
  it, so a concurrent swap can never split a batch across models: in-flight
  requests complete on the old model, nothing is dropped or double-scored;
- **shadow scoring** — while a candidate is staged, each flushed batch is
  handed (with its primary outcomes) to a background mirror worker that
  scores it on the candidate's own plan and resilience layer; the flush
  threads never wait on the mirror, a saturated mirror queue sheds batches
  (``shadow_dropped``), and statistics are tagged with the candidate they
  were scored on;
- **swap keyed on plan fingerprints** — the swap history records the
  (from, to) prefix fingerprints; equal fingerprints mean the candidate runs
  the same prefix as the active plan;
- **probation + auto-rollback** — after a swap the previous entry is kept as
  last-known-good; if the promoted entry's circuit breaker opens within
  ``probation_batches`` flushed batches, the swapper rolls back to it.

The ``swap`` and ``rollback`` fault points fire through the
:class:`~.faults.FaultHarness` before any state mutates, so an injected swap
fault leaves the old model serving.
"""

from __future__ import annotations

import logging
import math
import threading
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence

from ..obs import flight as obs_flight
from ..obs import reqtrace
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry, canonical_help
from .faults import fault_point

log = logging.getLogger(__name__)

#: bounded swap-history log (metrics export; totals live in the counters)
_HISTORY_MAX = 32

#: mirror backlog bound: beyond this many queued batches the shadow path
#: sheds instead of growing memory (the candidate is too slow to shadow
#: full traffic — the gate still sees every batch that DID mirror)
_SHADOW_QUEUE_MAX = 64


class ModelEntry:
    """One servable model version: plan + optional fault-tolerance layer."""

    __slots__ = ("model", "plan", "resilience", "version")

    def __init__(self, model, plan, resilience, version: int):
        self.model = model
        self.plan = plan
        self.resilience = resilience
        self.version = version

    @property
    def fingerprint(self) -> str:
        return self.plan.fingerprint

    def score_isolated(self, records: Sequence[Mapping[str, Any]]
                       ) -> List[Any]:
        """Per-record outcomes through this entry's scoring stack.  Without
        a resilience layer a batch failure becomes the same exception on
        every record (the pre-swap all-or-nothing contract, future-shaped)."""
        if self.resilience is not None:
            return self.resilience.score_isolated(records)
        try:
            return list(self.plan.score(records))
        except Exception as e:  # noqa: BLE001 — outcome-shaped, not raised
            return [e for _ in records]

    def begin_isolated(self, records: Sequence[Mapping[str, Any]]):
        """Stage-split twin of :meth:`score_isolated` (pipelined batcher):
        encode + async device dispatch now, per-record outcomes from the
        returned finalize closure."""
        if self.resilience is not None:
            return self.resilience.begin_isolated(records)
        begin = getattr(self.plan, "begin_score", None)
        if begin is None:
            return lambda: self.score_isolated(records)
        try:
            fin = begin(records)
        except Exception as e:  # noqa: BLE001 — outcome-shaped, not raised
            err = e  # ``e`` is unbound once the handler ends
            return lambda: [err for _ in records]

        def _finalize() -> List[Any]:
            try:
                return list(fin())
            except Exception as e:  # noqa: BLE001 — outcome-shaped
                return [e for _ in records]
        return _finalize


def prediction_delta(a: Any, b: Any) -> Optional[float]:
    """Max abs numeric delta between two result rows (prediction dicts
    compare their shared numeric keys); None when nothing is comparable,
    ``inf`` when a compared value is non-finite in one side only."""
    if not isinstance(a, Mapping) or not isinstance(b, Mapping):
        return None
    worst: Optional[float] = None
    for k, va in a.items():
        vb = b.get(k)
        if isinstance(va, Mapping) and isinstance(vb, Mapping):
            pairs = [(va[kk], vb[kk]) for kk in set(va) & set(vb)]
        else:
            pairs = [(va, vb)]
        for x, y in pairs:
            if isinstance(x, (int, float)) and isinstance(y, (int, float)) \
                    and not isinstance(x, bool) and not isinstance(y, bool):
                d = abs(float(x) - float(y))
                if math.isnan(d):
                    d = float("inf")
                worst = d if worst is None else max(worst, d)
    return worst


class SwappableScorer:
    """The batcher-facing scorer: an atomic reference to the active
    :class:`ModelEntry`, with staged-candidate mirroring and post-swap
    probation.  Exposes ``score_isolated`` so the MicroBatcher routes
    per-record outcomes regardless of which entry serves them.
    """

    def __init__(self, entry: ModelEntry,
                 registry: Optional[MetricsRegistry] = None,
                 labels: Optional[Mapping[str, str]] = None,
                 tenant: Optional[str] = None):
        self._lock = threading.Lock()
        self._active = entry
        self._previous: Optional[ModelEntry] = None
        self._candidate: Optional[ModelEntry] = None
        self._probation_left = 0
        self._opened_at_swap = 0
        #: ``labels`` (e.g. {"tenant": ...}) namespaces the swap counters,
        #: so scorers sharing one registry never merge
        self.tenant = tenant
        # canonical counters (obs/metrics.py); metrics() is a view
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self._c = {key: reg.counter(f"tmog_serve_swap_{key}_total",
                                    canonical_help(
                                        f"tmog_serve_swap_{key}_total"),
                                    labels=labels)
                   for key in ("swaps", "rollbacks", "rollback_failures",
                               "shadow_mirrored", "shadow_failures",
                               "shadow_batches", "shadow_dropped")}
        self._delta_count = 0
        self._delta_sum = 0.0
        self._delta_max: Optional[float] = None
        self.history: List[Dict[str, Any]] = []
        # background mirror worker: the flush thread only enqueues, so
        # shadow scoring can never delay primary futures or expire live
        # request deadlines
        self._shadow_cv = threading.Condition(self._lock)
        self._shadow_queue: "deque[tuple]" = deque()
        self._shadow_pending = 0
        self._shadow_thread: Optional[threading.Thread] = None

    # -- introspection -------------------------------------------------------
    @property
    def active(self) -> ModelEntry:
        with self._lock:
            return self._active

    @property
    def previous(self) -> Optional[ModelEntry]:
        with self._lock:
            return self._previous

    def has_candidate(self) -> bool:
        with self._lock:
            return self._candidate is not None

    def live_entries(self) -> List[ModelEntry]:
        """The entries currently held (active, retained previous, staged
        candidate)."""
        with self._lock:
            return [e for e in (self._active, self._previous,
                                self._candidate) if e is not None]

    def in_probation(self) -> bool:
        with self._lock:
            return self._probation_left > 0

    # -- the scoring path ----------------------------------------------------
    def score_isolated(self, records: Sequence[Mapping[str, Any]]
                       ) -> List[Any]:
        with self._lock:
            entry = self._active
            candidate = self._candidate
        out = entry.score_isolated(records)
        if candidate is not None:
            self._enqueue_shadow(candidate, records, out)
        self._post_batch()
        return out

    def begin_isolated(self, records: Sequence[Mapping[str, Any]]):
        """Stage-split scoring for the pipelined batcher: the active entry
        AND the staged candidate are captured ONCE here, under the swap
        lock — a promote/rollback racing the window finds this batch
        already bound to its model, so a swap can never split an in-flight
        batch (the server also drains the window before mutating —
        serve/server.py).  Shadow mirroring and the
        probation bookkeeping run at finalize, exactly where the lockstep
        path runs them relative to the primary outcomes."""
        with self._lock:
            entry = self._active
            candidate = self._candidate
        fin = entry.begin_isolated(records)

        def _finalize() -> List[Any]:
            out = fin()
            if candidate is not None:
                self._enqueue_shadow(candidate, records, out)
            self._post_batch()
            return out
        return _finalize

    def _enqueue_shadow(self, candidate: ModelEntry,
                        records: Sequence[Mapping[str, Any]],
                        out: List[Any]) -> None:
        # the mirror runs on its own thread, so the flusher's batch
        # trace contextvar will not reach it — carry the batch_seq
        # through the queue so the mirror span links into the flushed
        # batch's causal chain (obs/reqtrace.py)
        bt = reqtrace.active_batch()
        batch_seq = bt.seq if bt is not None else None
        # hand the batch to the mirror worker: the flush thread never
        # waits on shadow scoring, so a staged candidate cannot delay
        # primary futures or expire live deadlines
        with self._shadow_cv:
            if len(self._shadow_queue) >= _SHADOW_QUEUE_MAX:
                self._c["shadow_dropped"].inc(len(records))
            else:
                self._ensure_shadow_thread_locked()
                self._shadow_queue.append(
                    (candidate, list(records), list(out), batch_seq))
                self._shadow_pending += 1
                self._shadow_cv.notify_all()

    def _ensure_shadow_thread_locked(self) -> None:
        if self._shadow_thread is None or not self._shadow_thread.is_alive():
            self._shadow_thread = threading.Thread(
                target=self._shadow_worker, daemon=True,
                name="transmogrifai-shadow-mirror")
            self._shadow_thread.start()

    def _shadow_worker(self) -> None:
        while True:
            with self._shadow_cv:
                while not self._shadow_queue:
                    self._shadow_cv.wait()
                (candidate, records, primary,
                 batch_seq) = self._shadow_queue.popleft()
            try:
                self._mirror(candidate, records, primary, batch_seq)
            finally:
                with self._shadow_cv:
                    self._shadow_pending -= 1
                    self._shadow_cv.notify_all()

    def _drain_shadow(self, timeout: float = 30.0) -> bool:
        """Wait for the mirror backlog to clear (gate/report determinism);
        False when the worker could not drain in time."""
        with self._shadow_cv:
            return self._shadow_cv.wait_for(
                lambda: self._shadow_pending == 0, timeout=timeout)

    def _mirror(self, candidate: ModelEntry,
                records: Sequence[Mapping[str, Any]],
                primary: List[Any],
                batch_seq: Optional[int] = None) -> None:
        """Shadow-score one batch on the candidate; failures (including
        injected ``shadow`` faults) are counted, never raised.  Accumulated
        statistics are tagged by candidate identity: a mirror finishing
        after its candidate was discarded/replaced is dropped, never
        credited to a different candidate's gate.  ``batch_seq`` links the
        mirror span back to the primary flush it shadows."""
        seq_attr = {} if batch_seq is None else {"batch_seq": batch_seq}
        try:
            with obs_trace.span("serve.shadow_mirror", cat="serve",
                                records=len(records), **seq_attr):
                fault_point("shadow", records=records)
                shadow = candidate.score_isolated(records)
        except Exception as e:  # noqa: BLE001 — shadow never breaks primary
            with self._lock:
                if self._candidate is candidate:
                    self._c["shadow_failures"].inc(len(records))
                    self._c["shadow_batches"].inc()
            log.warning("shadow scoring failed (%s: %s)",
                        type(e).__name__, e)
            return
        mirrored = failures = 0
        deltas: List[float] = []
        for p, s in zip(primary, shadow):
            if isinstance(s, Exception):
                failures += 1
                continue
            mirrored += 1
            if isinstance(p, Exception):
                continue  # primary failed this record; nothing to compare
            d = prediction_delta(p, s)
            if d is not None:
                deltas.append(d)
        with self._lock:
            if self._candidate is not candidate:
                return  # displaced mid-mirror: stats belong to no one
            self._c["shadow_mirrored"].inc(mirrored)
            self._c["shadow_failures"].inc(failures)
            self._c["shadow_batches"].inc()
            for d in deltas:
                self._delta_count += 1
                self._delta_sum += d
                self._delta_max = d if self._delta_max is None \
                    else max(self._delta_max, d)

    def _post_batch(self) -> None:
        """Probation bookkeeping: a breaker trip on the promoted entry
        inside the window triggers the automatic rollback."""
        with self._lock:
            if self._probation_left <= 0:
                return
            self._probation_left -= 1
            breaker = getattr(self._active.resilience, "breaker", None)
            tripped = breaker is not None and (
                breaker.state != breaker.CLOSED
                or breaker.metrics()["opened"] > self._opened_at_swap)
        if tripped:
            try:
                self.rollback(reason="breaker trip in probation")
            except Exception as e:  # noqa: BLE001 — injected rollback faults
                self._c["rollback_failures"].inc()
                log.warning("automatic rollback failed (%s: %s); will retry "
                            "next batch", type(e).__name__, e)
                with self._lock:
                    self._probation_left = max(self._probation_left, 1)

    # -- candidate lifecycle -------------------------------------------------
    def stage(self, entry: ModelEntry) -> None:
        """Stage ``entry`` for shadow scoring (replaces any prior candidate
        and resets the shadow statistics)."""
        with self._lock:
            self._candidate = entry
            self._reset_shadow_locked()

    def discard_candidate(self) -> None:
        with self._lock:
            self._candidate = None
            self._reset_shadow_locked()

    def _reset_shadow_locked(self) -> None:
        # per-candidate statistics restart with each staged candidate (a
        # documented counter reset — obs/metrics.py CANONICAL_METRICS)
        self._c["shadow_mirrored"].reset()
        self._c["shadow_failures"].reset()
        self._c["shadow_batches"].reset()
        self._c["shadow_dropped"].reset()
        self._delta_count = 0
        self._delta_sum = 0.0
        self._delta_max = None

    def shadow_report(self) -> Dict[str, Any]:
        # drain the mirror backlog first: gate decisions must see every
        # batch that was handed to the worker, not a racing snapshot
        self._drain_shadow()
        with self._lock:
            return {
                "staged": self._candidate is not None,
                "candidate_fingerprint":
                    self._candidate.fingerprint if self._candidate else None,
                "mirrored_records": self._c["shadow_mirrored"].value,
                "shadow_failures": self._c["shadow_failures"].value,
                "shadow_batches": self._c["shadow_batches"].value,
                "shadow_dropped": self._c["shadow_dropped"].value,
                "compared_records": self._delta_count,
                "mean_abs_delta": (self._delta_sum / self._delta_count
                                   if self._delta_count else None),
                "max_abs_delta": self._delta_max,
            }

    # -- swap / rollback -----------------------------------------------------
    def promote(self, probation_batches: int = 8) -> Dict[str, Any]:
        """Atomically make the staged candidate the active model.

        The ``swap`` fault point fires BEFORE any state mutates: an injected
        fault leaves the old model serving and the candidate staged.  The
        displaced entry is retained as the last-known-good rollback target
        through (and beyond) the probation window.
        """
        with self._lock:
            candidate = self._candidate
            active = self._active
        if candidate is None:
            raise ValueError("no candidate staged; call stage() first")
        fault_point("swap", from_fingerprint=active.fingerprint,
                    to_fingerprint=candidate.fingerprint)
        with self._lock:
            if self._candidate is not candidate:  # raced with discard/stage
                raise RuntimeError("candidate changed during promote")
            self._previous = self._active
            self._active = candidate
            self._candidate = None
            self._reset_shadow_locked()
            breaker = getattr(candidate.resilience, "breaker", None)
            self._opened_at_swap = breaker.metrics()["opened"] \
                if breaker is not None else 0
            self._probation_left = max(0, int(probation_batches))
            record = {"event": "swap",
                      "from": self._previous.fingerprint,
                      "to": candidate.fingerprint,
                      "from_version": self._previous.version,
                      "to_version": candidate.version,
                      "shared_prefix": (self._previous.fingerprint
                                        == candidate.fingerprint)}
            if self.tenant is not None:
                record["tenant"] = self.tenant
            self._c["swaps"].inc()
            self._append_history_locked(record)
        obs_flight.record_event("swap", **record)
        return record

    def rollback(self, reason: str = "manual") -> Dict[str, Any]:
        """Restore the retained last-known-good entry; the displaced (bad)
        entry is dropped.  The ``rollback`` fault point fires first."""
        fault_point("rollback", reason=reason)
        with self._lock:
            if self._previous is None:
                raise ValueError("no retained model to roll back to")
            bad, good = self._active, self._previous
            self._active = good
            self._previous = None
            self._probation_left = 0
            record = {"event": "rollback", "reason": reason,
                      "from": bad.fingerprint, "to": good.fingerprint,
                      "from_version": bad.version,
                      "to_version": good.version}
            if self.tenant is not None:
                record["tenant"] = self.tenant
            self._c["rollbacks"].inc()
            self._append_history_locked(record)
        obs_flight.record_event("rollback", **record)
        log.warning("rolled back to model version %d (%s)",
                    good.version, reason)
        return record

    def _append_history_locked(self, record: Dict[str, Any]) -> None:
        self.history.append(record)
        if len(self.history) > _HISTORY_MAX:
            del self.history[:len(self.history) - _HISTORY_MAX]

    # -- observability -------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """Legacy-alias view over the ``tmog_serve_swap_*`` registry
        counters (obs/metrics.py)."""
        with self._lock:
            out: Dict[str, Any] = {k: c.value for k, c in self._c.items()}
            out.update({
                "active_version": self._active.version,
                "active_fingerprint": self._active.fingerprint,
                "previous_version":
                    self._previous.version if self._previous else None,
                "candidate_staged": self._candidate is not None,
                "probation_left": self._probation_left,
                "history": list(self.history),
            })
        return out
