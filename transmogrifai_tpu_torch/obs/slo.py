"""SLO error-budget accounting and burn-rate monitoring over the metrics
registry (the port's copy of ``transmogrifai_tpu/obs/slo.py``).

After the SRE workbook's multiwindow burn-rate alerting: an SLO is a
good-event ratio target over a budget window, and the *burn rate* is how
many times faster than sustainable the error budget is being spent.

- :class:`SloBudget` — one class's contract: availability ``target`` over
  ``window_s``, plus fast/slow burn thresholds over short/long lookback
  windows.
- :class:`SloMonitor` — pull-based (``poll()``): reads each tenant's
  good/bad counters from the shared :class:`~.metrics.MetricsRegistry`
  (``completed`` vs ``shed`` + ``deadline_expired`` + ``failed``, the
  batcher's per-tenant series), keeps a sliding window of cumulative
  samples per tenant, and on a burn-rate transition records the typed
  **TM902** finding — before the window budget is spent.  Exhaustion is
  **TM903** and, with an ``escalate`` callback
  (``FleetServer.arm_slo_monitor`` wires ``MicroBatcher.set_degraded``),
  puts the tenant in the batcher's degraded set, so it absorbs the
  shedding cuts while tenants inside budget keep their p99; recovery past
  the re-arm threshold takes it out again.

``poll()`` runs from ``FleetServer.statusz()`` and the continual trainer's
batch loop; there is no background thread, so tests drive it with a fake
clock and exact counter states.  The reference also writes ``slo_burn`` and
``slo_escalation`` events to its flight recorder, which the port does not
have yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

from .metrics import MetricsRegistry

#: per-tenant sliding-window sample bound (one sample per poll; a 1s poll
#: cadence holds >1h of history)
_WINDOW_SAMPLES = 4096

#: bad-event counter names summed per tenant (the batcher's canonical
#: per-tenant series, obs/metrics.py)
_BAD_SERIES = ("tmog_serve_batcher_shed_total",
               "tmog_serve_batcher_deadline_expired_total",
               "tmog_serve_batcher_failed_total")
_GOOD_SERIES = "tmog_serve_batcher_completed_total"


class SloBudget:
    """One SLO class's error-budget contract."""

    __slots__ = ("target", "window_s", "fast_burn", "slow_burn",
                 "short_window_s", "long_window_s")

    def __init__(self, target: float = 0.999, window_s: float = 3600.0,
                 fast_burn: float = 14.0, slow_burn: float = 6.0,
                 short_window_s: float = 60.0, long_window_s: float = 300.0):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if window_s <= 0 or short_window_s <= 0 or long_window_s <= 0:
            raise ValueError("windows must be positive")
        if fast_burn <= 0 or slow_burn <= 0:
            raise ValueError("burn thresholds must be positive")
        self.target = float(target)
        self.window_s = float(window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)

    @property
    def budget_frac(self) -> float:
        """The error budget: the bad-event ratio the target tolerates."""
        return 1.0 - self.target

    def to_dict(self) -> Dict[str, Any]:
        return {"target": self.target, "window_s": self.window_s,
                "fast_burn": self.fast_burn, "slow_burn": self.slow_burn,
                "short_window_s": self.short_window_s,
                "long_window_s": self.long_window_s}


#: default ladder matching the batcher's DEFAULT_SLO_CLASSES tiers
#: (docs/serving.md SLO table): tighter targets burn budget faster for the
#: same error ratio, so gold pages first
DEFAULT_BUDGETS: Dict[str, SloBudget] = {
    "gold": SloBudget(target=0.999),
    "silver": SloBudget(target=0.99),
    "bronze": SloBudget(target=0.95),
}


class _TenantWindow:
    """Cumulative (ts, total, bad) samples + lookback-delta rates."""

    __slots__ = ("samples",)

    def __init__(self):
        self.samples: "deque[tuple]" = deque(maxlen=_WINDOW_SAMPLES)

    def add(self, ts: float, total: float, bad: float) -> None:
        self.samples.append((ts, total, bad))

    def delta_over(self, window_s: float, now: float
                   ) -> "tuple[float, float]":
        """(total delta, bad delta) vs the newest sample at least
        ``window_s`` old (the oldest retained when none is old enough —
        a short history reads as the full observed span)."""
        if not self.samples:
            return 0.0, 0.0
        newest = self.samples[-1]
        base = self.samples[0]
        for s in reversed(self.samples):
            if now - s[0] >= window_s:
                base = s
                break
        return max(0.0, newest[1] - base[1]), max(0.0, newest[2] - base[2])


class SloMonitor:
    """Burn-rate/error-budget monitor over per-tenant registry counters.

    ``tenants`` is a ``{tenant: slo class name}`` mapping or a zero-arg
    callable returning one (the fleet's live tenant table).  ``escalate``
    (optional) is called ``escalate(tenant, degraded: bool)`` on budget
    exhaustion/recovery — the PR 12 shed-tier escalation hook.
    """

    def __init__(self, registry: MetricsRegistry,
                 tenants: Union[Mapping[str, str],
                                Callable[[], Mapping[str, str]]],
                 budgets: Optional[Mapping[str, SloBudget]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 escalate: Optional[Callable[[str, bool], None]] = None,
                 rearm_remaining: float = 0.25):
        self._registry = registry
        self._tenants = tenants if callable(tenants) \
            else (lambda t=dict(tenants): t)
        self.budgets: Dict[str, SloBudget] = dict(
            DEFAULT_BUDGETS if budgets is None else budgets)
        self._clock = clock
        self._escalate = escalate
        self.rearm_remaining = float(rearm_remaining)
        self._lock = threading.Lock()
        self._windows: Dict[str, _TenantWindow] = {}
        self._firing: Dict[str, set] = {}
        self._escalated: set = set()
        #: bounded TM902/TM903 findings (dict form; .diagnostics() types
        #: them — same contract as FlightRecorder's TM901 ring)
        self._diags: "deque[dict]" = deque(maxlen=64)
        self.last_status: Dict[str, Dict[str, Any]] = {}

    # -- counter reads -------------------------------------------------------
    def _value(self, name: str, tenant: Optional[str]) -> float:
        labels = {"tenant": tenant} if tenant is not None else None
        m = self._registry.get(name, labels)
        return float(m.value) if m is not None else 0.0

    def _read(self, tenant: Optional[str]) -> "tuple[float, float]":
        """(total, bad) cumulative request outcomes for one tenant."""
        bad = sum(self._value(n, tenant) for n in _BAD_SERIES)
        good = self._value(_GOOD_SERIES, tenant)
        return good + bad, bad

    # -- the poll loop -------------------------------------------------------
    def poll(self, now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """Sample every tenant's counters, evaluate burn rates and budget,
        record TM902/TM903 on transitions, drive escalation.
        Returns (and retains as ``last_status``) the per-tenant status.

        Rates are counter DELTAS between retained samples, so a tenant's
        first poll is its baseline — traffic before it is invisible to the
        windows (the conservative direction: less good history in the
        window means the budget reads as burning faster, never slower).
        Poll once right after arming to anchor the baseline."""
        now = self._clock() if now is None else float(now)
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            tenant_slos = dict(self._tenants())
            for tenant in sorted(tenant_slos, key=str):
                slo = tenant_slos[tenant]
                budget = self.budgets.get(slo)
                if budget is None:
                    continue
                total, bad = self._read(tenant)
                win = self._windows.setdefault(str(tenant), _TenantWindow())
                win.add(now, total, bad)
                out[str(tenant)] = self._evaluate_locked(
                    str(tenant), slo, budget, win, now)
            self.last_status = out
        return out

    def _burn(self, win: _TenantWindow, budget: SloBudget, window_s: float,
              now: float) -> "tuple[float, float]":
        """(burn rate, error ratio) over one lookback window."""
        total, bad = win.delta_over(window_s, now)
        if total <= 0.0:
            return 0.0, 0.0
        ratio = bad / total
        return ratio / budget.budget_frac, ratio

    def _evaluate_locked(self, tenant: str, slo: str, budget: SloBudget,
                         win: _TenantWindow, now: float) -> Dict[str, Any]:
        burn_fast, _ = self._burn(win, budget, budget.short_window_s, now)
        burn_slow, _ = self._burn(win, budget, budget.long_window_s, now)
        w_total, w_bad = win.delta_over(budget.window_s, now)
        consumed = (w_bad / (w_total * budget.budget_frac)) \
            if w_total > 0.0 else 0.0
        remaining = 1.0 - consumed
        firing = self._firing.setdefault(tenant, set())

        for kind, rate, threshold in (("fast", burn_fast, budget.fast_burn),
                                      ("slow", burn_slow, budget.slow_burn)):
            if rate >= threshold and kind not in firing:
                firing.add(kind)
                self._fire("TM902", tenant,
                           f"tenant {tenant!r} ({slo}) is burning its SLO "
                           f"error budget at {rate:.1f}x the sustainable "
                           f"rate ({kind} window; threshold "
                           f"{threshold:.1f}x, budget remaining "
                           f"{remaining:.0%})")
            elif rate < threshold / 2.0:
                firing.discard(kind)  # hysteresis: re-arm at half threshold

        if remaining <= 0.0 and "exhausted" not in firing:
            firing.add("exhausted")
            self._fire("TM903", tenant,
                       f"tenant {tenant!r} ({slo}) exhausted its "
                       f"{budget.window_s:.0f}s error budget "
                       f"(target {budget.target}); shed-tier escalation "
                       + ("armed" if self._escalate else "not armed"))
            if self._escalate is not None and tenant not in self._escalated:
                self._escalated.add(tenant)
                self._escalate(tenant, True)
        elif remaining >= self.rearm_remaining:
            firing.discard("exhausted")
            if self._escalate is not None and tenant in self._escalated:
                self._escalated.discard(tenant)
                self._escalate(tenant, False)

        return {"slo": slo,
                "burn_fast": round(burn_fast, 3),
                "burn_slow": round(burn_slow, 3),
                "budget_remaining": round(remaining, 4),
                "window_total": w_total,
                "window_bad": w_bad,
                "firing": sorted(firing),
                "escalated": tenant in self._escalated}

    def _fire(self, code: str, tenant: str, message: str) -> None:
        self._diags.append({"code": code, "message": message,
                            "location": f"tenant:{tenant}"})

    def disarm(self) -> None:
        """Release every tenant this monitor escalated (degraded) — the
        hand-off hook for replacing a monitor: without it a re-arm would
        orphan previously degraded tenants, since the successor's empty
        escalation set can never issue their recovery call."""
        with self._lock:
            escalated = list(self._escalated)
            self._escalated.clear()
        if self._escalate is not None:
            for tenant in escalated:
                self._escalate(tenant, False)

    # -- introspection -------------------------------------------------------
    def diagnostics(self) -> List[Any]:
        """Recorded TM902/TM903 findings as typed Diagnostics."""
        from ..checkers.diagnostics import make_diagnostic

        with self._lock:
            raw = list(self._diags)
        return [make_diagnostic(d["code"], d["message"],
                                location=d["location"]) for d in raw]

    def status(self) -> Dict[str, Dict[str, Any]]:
        """The last ``poll()`` result (no new sampling)."""
        with self._lock:
            return {t: dict(v) for t, v in self.last_status.items()}
