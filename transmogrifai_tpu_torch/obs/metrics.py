"""Metrics registry (counterpart of ``transmogrifai_tpu/obs/metrics.py``):
counters, gauges and histograms with labels, the one source of truth for the
serving server's counters and the continual trainer's.

Components create their metrics in a :class:`MetricsRegistry` under the
canonical Prometheus-style names of :data:`CANONICAL_METRICS`; their
``metrics()`` plain dicts are views over the registry.  The registry exports
as Prometheus text (:meth:`MetricsRegistry.to_prometheus`) and as a JSON-able
snapshot (:meth:`MetricsRegistry.snapshot`).  Every metric object has its own
lock, so the batcher's flusher and finalizer, the shadow-mirror worker and
the control plane update them without a global lock.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Tuple

#: bounded percentile reservoir per histogram
_RESERVOIR = 4096

#: bound on distinct exact-valued histogram buckets
_EXACT_MAX = 256


class Counter:
    """Monotonic counter.  ``reset()`` exists for the shadow-scoring stats,
    which restart per staged candidate (Prometheus treats a counter reset
    like a process restart)."""

    __slots__ = ("name", "labels", "help", "_lock", "_v")

    kind = "counter"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    def reset(self) -> None:
        with self._lock:
            self._v = 0

    @property
    def value(self):
        with self._lock:
            return self._v


class Gauge:
    """Point-in-time value."""

    __slots__ = ("name", "labels", "help", "_lock", "_v")

    kind = "gauge"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self):
        with self._lock:
            return self._v


class Histogram:
    """Distribution: count/sum/min/max + a bounded reservoir for quantiles.

    ``exact=True`` also keeps exact per-value counts (at most ``_EXACT_MAX``
    distinct values) — the batch-size histogram's ``{size: count}`` shape.
    """

    __slots__ = ("name", "labels", "help", "_lock", "_count", "_sum",
                 "_min", "_max", "_reservoir", "_exact", "exact_overflow")

    kind = "histogram"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 help: str = "", exact: bool = False):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._reservoir: "deque[float]" = deque(maxlen=_RESERVOIR)
        self._exact: Optional[Dict[Any, int]] = {} if exact else None
        self.exact_overflow = 0

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            self._reservoir.append(v)
            if self._exact is not None:
                key = int(v) if v.is_integer() else v
                if key in self._exact or len(self._exact) < _EXACT_MAX:
                    self._exact[key] = self._exact.get(key, 0) + 1
                else:
                    self.exact_overflow += 1

    def quantile(self, q: float) -> Optional[float]:
        """Quantile over the bounded reservoir (recent window), or None."""
        with self._lock:
            vals = sorted(self._reservoir)
        if not vals:
            return None
        return vals[min(int(len(vals) * q), len(vals) - 1)]

    def exact_counts(self) -> Dict[Any, int]:
        with self._lock:
            return dict(self._exact or {})

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def summary(self) -> Dict[str, Any]:
        """JSON-able snapshot of the distribution (stable key order)."""
        with self._lock:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
            vals = sorted(self._reservoir)
            exact = dict(self._exact) if self._exact is not None else None
        out: Dict[str, Any] = {"count": count, "sum": round(total, 6),
                               "min": mn, "max": mx}
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            out[key] = vals[min(int(len(vals) * q), len(vals) - 1)] \
                if vals else None
        if exact is not None:
            out["counts"] = {str(k): v for k, v in sorted(exact.items())}
        return out


#: metric kind -> Prometheus exposition type (histograms export as
#: summaries: quantile series + _count/_sum)
_PROM_TYPE = {"counter": "counter", "gauge": "gauge", "histogram": "summary"}


def _label_key(labels: Optional[Mapping[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _render_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class MetricsRegistry:
    """Get-or-create registry of named, labeled metrics.

    Re-registering the same (name, labels) returns the existing metric;
    re-registering under a different kind is an error (one name, one type —
    the Prometheus contract).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, Any] = {}

    def _get_or_create(self, cls, name: str, labels: Optional[Mapping[str, str]],
                       help: str, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels=key[1], help=help, **kw)
                self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, labels, help)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Mapping[str, str]] = None,
                  exact: bool = False) -> Histogram:
        return self._get_or_create(Histogram, name, labels, help, exact=exact)

    def metrics(self) -> List[Any]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str,
            labels: Optional[Mapping[str, str]] = None) -> Optional[Any]:
        """The registered metric under (name, labels), or None: the
        read-only accessor of consumers such as the SLO monitor
        (``obs/slo.py``), without get-or-create side effects."""
        with self._lock:
            return self._metrics.get((name, _label_key(labels)))

    def labeled_values(self, label: str) -> List[str]:
        """Distinct values of ``label`` across registered metrics."""
        label = str(label)
        with self._lock:
            return sorted({v for _name, labels in self._metrics
                           for (k, v) in labels if k == label})

    def drop_labeled(self, label: str, value: str) -> int:
        """Remove every metric carrying ``label=value`` from exposition (the
        holders may keep updating them; the values just stop exporting)."""
        pair = (str(label), str(value))
        with self._lock:
            dead = [k for k in self._metrics if pair in k[1]]
            for k in dead:
                del self._metrics[k]
        return len(dead)

    # -- exposition ----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """{rendered name: value} in sorted (stable) key order; histogram
        values are their :meth:`Histogram.summary` dicts.  JSON-able."""
        out: Dict[str, Any] = {}
        for m in self.metrics():
            key = m.name + _render_labels(m.labels)
            out[key] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def to_prometheus(self, all_canonical: bool = False) -> str:
        """Prometheus text exposition format (0.0.4).  Histograms render as
        summaries (quantile series + ``_count``/``_sum``).  With
        ``all_canonical`` every :data:`CANONICAL_METRICS` entry not yet
        registered gets its ``# HELP``/``# TYPE`` lines too (zero-sample
        families are legal exposition)."""
        by_name: Dict[str, List[Any]] = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        names = set(by_name)
        if all_canonical:
            names.update(CANONICAL_METRICS)
        lines: List[str] = []
        for name in sorted(names):
            group = by_name.get(name, [])
            if not group:
                kind, _owner, _alias, help_text = CANONICAL_METRICS[name]
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {_PROM_TYPE[kind]}")
                continue
            first = group[0]
            help_text = first.help or canonical_help(name)
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {_PROM_TYPE[first.kind]}")
            for m in group:
                lab = _render_labels(m.labels)
                if isinstance(m, Histogram):
                    for q in (0.5, 0.95, 0.99):
                        v = m.quantile(q)
                        if v is not None:
                            qlab = _render_labels(m.labels + (("quantile", str(q)),))
                            lines.append(f"{name}{qlab} {v}")
                    lines.append(f"{name}_count{lab} {m.count}")
                    lines.append(f"{name}_sum{lab} {m.sum}")
                else:
                    lines.append(f"{name}{lab} {m.value}")
        return "\n".join(lines) + "\n"


#: canonical name -> (kind, owner, legacy alias key, help): the serving
#: server's metrics under the reference's names.  The aliases are the keys
#: of the components' ``metrics()`` views.
CANONICAL_METRICS: Dict[str, Tuple[str, str, Optional[str], str]] = {
    # -- MicroBatcher (serve/batcher.py) ------------------------------------
    "tmog_serve_batcher_submitted_total":
        ("counter", "batcher", "submitted", "requests admitted to the queue"),
    "tmog_serve_batcher_rejected_total":
        ("counter", "batcher", "rejected", "requests refused at admission "
         "(QueueFullError backpressure)"),
    "tmog_serve_batcher_completed_total":
        ("counter", "batcher", "completed", "requests resolved with a result"),
    "tmog_serve_batcher_failed_total":
        ("counter", "batcher", "failed", "requests resolved with an error"),
    "tmog_serve_batcher_cancelled_total":
        ("counter", "batcher", "cancelled", "futures cancelled client-side "
         "or evicted by non-drain shutdown"),
    "tmog_serve_batcher_deadline_expired_total":
        ("counter", "batcher", "deadline_expired", "requests evicted because "
         "their deadline passed in the queue"),
    "tmog_serve_batcher_shed_total":
        ("counter", "batcher", "shed", "queued requests shed "
         "lowest-tier-first to admit higher-tier traffic under "
         "backpressure (also exported per tenant)"),
    "tmog_serve_batcher_batches_total":
        ("counter", "batcher", "batches", "flushed batches"),
    "tmog_serve_batcher_queue_depth":
        ("gauge", "batcher", "queue_depth", "requests currently queued"),
    "tmog_serve_batcher_batch_size":
        ("histogram", "batcher", "batch_size_hist", "flushed batch sizes "
         "(exact counts)"),
    "tmog_serve_batcher_latency_seconds":
        ("histogram", "batcher", None, "enqueue-to-result latency "
         "(legacy view: latency_p50_ms/p95/p99; also exported per tenant)"),
    # -- Pipelined flush path (serve/pipeline.py via serve/batcher.py) ------
    "tmog_serve_pipeline_depth":
        ("gauge", "pipeline", None, "configured in-flight window of the "
         "pipelined flush path (TMOG_SERVE_PIPELINE_DEPTH; 0 = lockstep)"),
    "tmog_serve_pipeline_overlap_fraction":
        ("gauge", "pipeline", None, "fraction of flusher encode+dispatch "
         "time hidden behind finalize (1 - finalizer wait / flusher load)"),
    "tmog_serve_pipeline_stalls_total":
        ("counter", "pipeline", None, "finalizer waits on an empty "
         "in-flight ring longer than the stall threshold — the encode "
         "stage failed to stay ahead of the device"),
    # -- ResilientScorer (serve/resilience.py) ------------------------------
    "tmog_serve_resilience_quarantined_total":
        ("counter", "resilience", "quarantined", "poison records isolated"),
    "tmog_serve_resilience_retries_total":
        ("counter", "resilience", "retries", "transient-failure retries"),
    "tmog_serve_resilience_bucket_splits_total":
        ("counter", "resilience", "bucket_splits", "batch halvings into "
         "smaller padding buckets"),
    "tmog_serve_resilience_bisect_batches_total":
        ("counter", "resilience", "bisect_batches", "poison-isolation "
         "bisection steps"),
    "tmog_serve_resilience_device_failures_total":
        ("counter", "resilience", "device_failures", "batches the device "
         "path failed after retries"),
    "tmog_serve_resilience_fallback_batches_total":
        ("counter", "resilience", "fallback_batches", "batches served from "
         "the host path"),
    "tmog_serve_resilience_fallback_records_total":
        ("counter", "resilience", "fallback_records", "records served from "
         "the host path"),
    # -- CircuitBreaker (serve/resilience.py) -------------------------------
    "tmog_serve_breaker_opened_total":
        ("counter", "breaker", "opened", "breaker open transitions"),
    "tmog_serve_breaker_reclosed_total":
        ("counter", "breaker", "reclosed", "successful half-open probes"),
    "tmog_serve_breaker_probes_total":
        ("counter", "breaker", "probes", "half-open probe attempts"),
    "tmog_serve_breaker_state":
        ("gauge", "breaker", "state", "0=closed 1=open 2=half_open"),
    # -- SwappableScorer (serve/swap.py) ------------------------------------
    "tmog_serve_swap_swaps_total":
        ("counter", "swap", "swaps", "committed blue/green promotions"),
    "tmog_serve_swap_rollbacks_total":
        ("counter", "swap", "rollbacks", "restores of last-known-good"),
    "tmog_serve_swap_rollback_failures_total":
        ("counter", "swap", "rollback_failures", "automatic rollbacks that "
         "themselves failed"),
    "tmog_serve_swap_shadow_mirrored_total":
        ("counter", "swap", "shadow_mirrored", "records shadow-scored on "
         "the staged candidate (resets per candidate)"),
    "tmog_serve_swap_shadow_failures_total":
        ("counter", "swap", "shadow_failures", "shadow scoring failures "
         "(resets per candidate)"),
    "tmog_serve_swap_shadow_batches_total":
        ("counter", "swap", "shadow_batches", "batches mirrored (resets per "
         "candidate)"),
    "tmog_serve_swap_shadow_dropped_total":
        ("counter", "swap", "shadow_dropped", "records shed by a saturated "
         "mirror queue (resets per candidate)"),
    # -- ModelRegistry / FleetServer (serve/registry.py) --------------------
    "tmog_serve_fleet_tenants":
        ("gauge", "fleet", None, "tenants currently registered in the "
         "fleet"),
    "tmog_serve_fleet_registrations_total":
        ("counter", "fleet", "registrations", "tenant models admitted to "
         "the registry"),
    "tmog_serve_fleet_shared_prefix_total":
        ("counter", "fleet", "shared_prefix_registrations", "registrations "
         "whose plan fingerprint was already resident — the fleet-wide "
         "executable-dedup (zero-compile) figure"),
    "tmog_serve_fleet_evictions_total":
        ("counter", "fleet", "evictions", "cold tenants whose warm bucket "
         "executables the HBM admission controller evicted (LRU by "
         "last-scored)"),
    "tmog_serve_fleet_admission_refusals_total":
        ("counter", "fleet", "admission_refusals", "registrations/stagings "
         "refused with TM509 after eviction could not make room"),
    "tmog_serve_fleet_scored_records_total":
        ("counter", "fleet", None, "records scored per tenant (labeled "
         "tenant=...)"),
    # -- ContinualTrainer (workflow/continual.py) ---------------------------
    "tmog_continual_batches_total":
        ("counter", "continual", "batches", "streamed batches processed"),
    "tmog_continual_records_total":
        ("counter", "continual", "records", "streamed records processed"),
    "tmog_continual_record_errors_total":
        ("counter", "continual", "record_errors", "records whose scoring "
         "future failed"),
    "tmog_continual_drift_evaluations_total":
        ("counter", "continual", "drift_evaluations", "drift evaluations "
         "run"),
    "tmog_continual_drift_events_total":
        ("counter", "continual", "drift_events", "evaluations that fired "
         "TM801-TM803"),
    "tmog_continual_refits_total":
        ("counter", "continual", "refits", "successful warm refits"),
    "tmog_continual_refit_failures_total":
        ("counter", "continual", "refit_failures", "refits or stagings that "
         "failed (TM805)"),
    "tmog_continual_candidates_staged_total":
        ("counter", "continual", "candidates_staged", "candidates staged "
         "for shadow scoring"),
    "tmog_continual_gate_rejections_total":
        ("counter", "continual", "gate_rejections", "promotion-gate "
         "refusals (TM806)"),
    "tmog_continual_promotions_total":
        ("counter", "continual", "promotions", "committed promotions "
         "(TM807)"),
    "tmog_continual_swap_failures_total":
        ("counter", "continual", "swap_failures", "promote() attempts that "
         "raised"),
}


def canonical_help(name: str) -> str:
    entry = CANONICAL_METRICS.get(name)
    return entry[3] if entry else ""

