"""obs — the telemetry layer (counterpart of ``transmogrifai_tpu/obs/``):
train, serve and the continual refit share one set of sinks.

- ``obs.trace``   — trace spans with contextvar nesting, exported as
  Chrome trace-event JSON (Perfetto-loadable).  The ``perf/timers.py``
  phase sites, the serve request lifecycle, and the continual control loop
  all emit here when a tracer is installed.
- ``obs.metrics`` — the metrics registry (counters/gauges/histograms with
  labels): the source of truth behind the batcher/swap/breaker/trainer
  ``metrics()`` dict views, with Prometheus text exposition and JSONL
  snapshots.
- ``obs.flight``  — the flight recorder: a bounded ring of structured
  events (kernel builds and loads and a plan's bucket allocations, tagged
  with plan fingerprints — one in a warm path raises TM901 — breaker
  transitions, swap/rollback, drift firings, quarantines, injected faults)
  dumpable to JSON.
- ``obs.profile`` — the ``TMOG_PROFILE`` ``torch.profiler`` hook around the
  serving plan's dispatch and the sweep's family launches.
- ``obs.reqtrace`` — request-scoped causal tracing: per-request async
  tracks linked to their flushed batch, plus the always-on per-tenant
  device-time cost accounting.
- ``obs.slo``     — SLO error-budget/burn-rate monitoring over the
  registry's per-tenant counters (TM902/TM903, shed-tier escalation).
- ``obs.overlap`` — the pipelined flush's overlap statistics.

:class:`Telemetry` bundles a tracer + flight recorder + output directory
behind one switch: ``Workflow.train(telemetry=...)`` and the
``TMOG_TELEMETRY=<dir>`` env var resolve here.  Everything is DEFAULT-OFF:
with no telemetry active, every instrumentation site costs one module-global
or contextvar read, and served records and trained models are the same
with it on or off.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping, Optional, Union

from . import (  # noqa: F401 — submodule API
    flight,
    metrics,
    overlap,
    profile,
    reqtrace,
    slo,
    trace,
)
from .flight import (  # noqa: F401
    FlightRecorder,
    active_recorder,
    compile_context,
    record_event,
)
from .metrics import (  # noqa: F401
    CANONICAL_METRICS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    canonical_help,
)
from .overlap import OverlapStats  # noqa: F401
from .reqtrace import reconstruct_request, request_events  # noqa: F401
from .slo import DEFAULT_BUDGETS, SloBudget, SloMonitor  # noqa: F401
from .trace import Tracer, active_tracer, instant, span  # noqa: F401

#: env switch: a directory path enables telemetry for the train entry point
TELEMETRY_ENV = "TMOG_TELEMETRY"


class Telemetry:
    """One tracer + one flight recorder + an optional output directory.

    Usable as a context manager: entering installs both process-wide,
    exiting uninstalls and (when ``out_dir`` is set) dumps ``trace.json``,
    ``flight.json``, and appends a ``metrics.jsonl`` snapshot line.
    """

    def __init__(self, out_dir: Optional[str] = None,
                 trace_capacity: int = trace._DEFAULT_CAPACITY,
                 flight_capacity: int = flight._DEFAULT_CAPACITY,
                 detail: str = "batch"):
        self.out_dir = out_dir
        self.tracer = Tracer(capacity=trace_capacity, detail=detail)
        self.recorder = FlightRecorder(capacity=flight_capacity,
                                       dump_dir=out_dir)
        self._active = False
        #: per-``with`` ownership: a nested enter on an already-started
        #: bundle must NOT tear the outer session down on exit
        self._cm_owned: list = []

    # -- lifecycle -----------------------------------------------------------
    def activate(self) -> bool:
        """Install tracer + recorder process-wide; True when THIS call did
        the activation (False = already active — the caller does not own
        the session and must not stop it)."""
        if self._active:
            return False
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
        trace.install_tracer(self.tracer)
        try:
            flight.install_recorder(self.recorder)
        except RuntimeError:
            trace.uninstall_tracer(self.tracer)
            raise
        self._active = True
        return True

    def start(self) -> "Telemetry":
        self.activate()
        return self

    def stop(self) -> None:
        if not self._active:
            return
        trace.uninstall_tracer(self.tracer)
        flight.uninstall_recorder(self.recorder)
        self._active = False

    def __enter__(self) -> "Telemetry":
        self._cm_owned.append(self.activate())
        return self

    def __exit__(self, *exc) -> None:
        owned = self._cm_owned.pop() if self._cm_owned else True
        if not owned:
            return  # an enclosing owner keeps recording (and dumps later)
        self.stop()
        if self.out_dir:
            self.dump()

    # -- export --------------------------------------------------------------
    def dump(self, metrics_payload: Optional[Mapping[str, Any]] = None,
             prometheus: Optional[str] = None) -> Optional[str]:
        """Write ``trace.json`` + ``flight.json`` (+ optional
        ``metrics.jsonl`` line and ``metrics.prom`` exposition) under
        ``out_dir``; returns the directory (None when unset)."""
        d = self.out_dir
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        self.tracer.export(os.path.join(d, "trace.json"))
        self.recorder.dump(os.path.join(d, "flight.json"), reason="exit")
        if metrics_payload is not None:
            with open(os.path.join(d, "metrics.jsonl"), "a") as fh:
                fh.write(json.dumps(
                    {"ts": round(time.time(), 3), **dict(metrics_payload)},
                    sort_keys=True, default=str) + "\n")
        if prometheus is not None:
            with open(os.path.join(d, "metrics.prom"), "w") as fh:
                fh.write(prometheus)
        return d


def telemetry_active() -> bool:
    """True when any tracer or flight recorder is installed."""
    return trace.active_tracer() is not None \
        or flight.active_recorder() is not None


def resolve_telemetry(arg: Union[None, str, Telemetry] = None
                      ) -> Optional[Telemetry]:
    """Resolve a telemetry argument for an entry point (CLI, train).

    - a :class:`Telemetry` instance is returned as-is;
    - a string is an output directory (a new bundle is built over it);
    - ``None`` consults ``TMOG_TELEMETRY`` — but only when no telemetry is
      already active, so an outer session is not fought by inner
      ``train()`` calls.
    """
    if isinstance(arg, Telemetry):
        return arg
    if isinstance(arg, str) and arg:
        return Telemetry(out_dir=arg)
    if arg is None:
        env = os.environ.get(TELEMETRY_ENV, "")
        if env and not telemetry_active():
            return Telemetry(out_dir=env)
    return None


__all__ = [
    "CANONICAL_METRICS",
    "DEFAULT_BUDGETS",
    "FlightRecorder",
    "MetricsRegistry",
    "SloBudget",
    "SloMonitor",
    "TELEMETRY_ENV",
    "Telemetry",
    "Tracer",
    "active_recorder",
    "active_tracer",
    "compile_context",
    "flight",
    "instant",
    "metrics",
    "profile",
    "reconstruct_request",
    "record_event",
    "reqtrace",
    "request_events",
    "resolve_telemetry",
    "slo",
    "span",
    "telemetry_active",
    "trace",
]
