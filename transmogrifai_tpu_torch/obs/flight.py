"""Flight recorder — a bounded ring buffer of structured serving, refit
and training events, dumpable to JSON on demand and automatically on
injected faults (the port's copy of ``transmogrifai_tpu/obs/flight.py``).

The recorder answers "why was this request slow / why did that swap roll
back" without re-running anything.  It keeps the newest ``capacity``
events of:

- ``backend_compile`` — the port's counterpart of a backend compilation:
  an ``nvcc`` build of a kernel library, the load of a kernel library, or a
  serving plan's first allocation for a row bucket (its staging buffers or
  a landing set).  ``perf/timers.py::note_compile`` records each one from
  the site that does it, tagged with the :func:`compile_context` active
  there: the plan fingerprint and whether the path was EXPECTED to be warm.
  One inside a warm context is an *unexpected recompile*: the event is
  flagged and a typed **TM901** diagnostic is recorded.
- ``breaker_transition`` — circuit-breaker state changes
  (serve/resilience.py).
- ``swap`` / ``rollback`` — blue/green promotions and restores with their
  plan fingerprints (serve/swap.py).
- ``drift`` — drift evaluations that fired TM801-TM803
  (workflow/continual.py).
- ``quarantine`` / ``dead_letter`` — poison-record isolation outcomes.
- ``executable_release`` — a plan released its warm buckets (fleet
  eviction, unregister, or an explicit release): the fingerprint, the
  released buckets, and whether the shared state went too — so an incident
  dump shows *why* a tenant went cold next to the allocation it later paid
  (serve/plan.py).
- ``artifact_packed`` / ``artifact_hydrated`` / ``artifact_miss`` /
  ``artifact_refused`` — the deploy artifact store (deploy/store.py): a
  pack (``root``, ``fingerprint``, ``buckets``), a hydrate (``root``,
  ``tenant``, ``fingerprint``, the adopted ``buckets`` and the
  ``live_compile_buckets`` left to a live build), a clean miss on
  environment drift (``root``, ``tenant``, ``reasons``) and a TM510 refusal
  (``code``, ``root``, ``tenant``, ``reasons``), each beside the
  allocations and library loads it saved or caused.
- ``fleet_register`` / ``fleet_unregister`` / ``fleet_evict`` /
  ``fleet_admission_refused`` (serve/registry.py) and ``slo_burn`` /
  ``slo_escalation`` (obs/slo.py).
- ``fault_injected`` — every failure the deterministic
  :class:`~..serve.faults.FaultHarness` injected; when the recorder has a
  ``dump_dir``, each injected fault auto-dumps the ring buffer (bounded
  count), so the harness run leaves a postmortem artifact.
- ``train_retry`` / ``degrade_bucket_shrink`` / ``sweep_block_resume`` /
  ``chunk_resume`` — the training resilience trail (workflow/resilience.py,
  models/tuning.py, workflow/ooc.py): every backoff retry with its fault
  point and delay, every next-smaller row bucket, every sweep block a
  durable journal let a re-run skip, and every chunked-epoch prefix a
  committed chunk offset let a re-run skip (``epoch``,
  ``skipped_chunks``, ``total_chunks``).
- ``spill_activation`` — a table over the host budget spilled to the
  chunked store (data/chunked.py ``maybe_chunk``: ``dataset_bytes``,
  ``host_budget``, ``chunk_rows``).
- ``prefetch_stall`` — the chunk consumer waited on an empty prefetch
  buffer for longer than a millisecond (readers/prefetch.py: ``chunk``,
  ``wait_s``).

Like the fault harness, the recorder is process-global while installed (the
batcher flusher is another thread, so a contextvar would not reach it);
:func:`compile_context` — the *tagging* side — IS contextvar-based and
inherits the warm expectation from enclosing contexts, so a warm-refit
context marks compiles as unexpected even when an inner layer opens its own
context.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)

_DEFAULT_CAPACITY = 4096
#: at most this many automatic fault dumps per recorder (a scripted storm
#: of faults must not write unbounded files)
_MAX_AUTO_DUMPS = 8

#: stack of compile-site tags; the innermost entry names the site, the warm
#: expectation is inherited (sticky) from every enclosing entry
_COMPILE_CTX: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "transmogrifai_tpu_torch_obs_compile_ctx", default=())


@contextlib.contextmanager
def compile_context(site: str, fingerprint: Optional[str] = None,
                    warm: bool = False):
    """Tag backend compiles (kernel builds and loads, bucket allocations)
    performed inside the block.

    ``fingerprint`` is the plan fingerprint of the program being set up;
    ``warm=True`` declares the path is expected to be compile-free (a warm
    refit, a warmed serving plan) — a compile seen
    under it records as unexpected (TM901).  Contexts nest; the warm flag
    is inherited from enclosing contexts, and a missing fingerprint falls
    back to the enclosing one.
    """
    stack = _COMPILE_CTX.get()
    if stack:
        warm = warm or stack[-1]["warm"]
        if fingerprint is None:
            fingerprint = stack[-1]["fingerprint"]
    entry = {"site": site, "fingerprint": fingerprint, "warm": warm}
    token = _COMPILE_CTX.set(stack + (entry,))
    try:
        yield
    finally:
        _COMPILE_CTX.reset(token)


def current_compile_context() -> Optional[Dict[str, Any]]:
    stack = _COMPILE_CTX.get()
    return dict(stack[-1]) if stack else None


class FlightRecorder:
    """Bounded structured event log with JSON dumps.

    ``dump_dir`` enables automatic dumps: one JSON file per
    fault-harness-injected failure (bounded), plus :meth:`dump` on demand.
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 dump_dir: Optional[str] = None):
        self._lock = threading.Lock()
        self._events: "deque[dict]" = deque(maxlen=int(capacity))
        self._seq = 0
        self.dropped = 0
        self.dump_dir = dump_dir
        self._auto_dumps = 0
        self.unexpected_compiles = 0
        #: bounded TM901 findings (dict form; .diagnostics() types them)
        self._diags: "deque[dict]" = deque(maxlen=64)

    # -- recording -----------------------------------------------------------
    def record(self, kind: str, **data) -> None:
        ev = {"seq": None, "ts": round(time.time(), 6), "kind": kind,
              "data": data}
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def _on_backend_compile(self, ctx: Optional[Dict[str, Any]],
                            seconds: float, what: str = "compile",
                            **data) -> None:
        ctx = ctx or {"site": "untracked", "fingerprint": None,
                      "warm": False}
        unexpected = bool(ctx["warm"])
        self.record("backend_compile", site=ctx["site"],
                    fingerprint=ctx["fingerprint"],
                    seconds=round(seconds, 4), unexpected=unexpected,
                    what=what, **data)
        if unexpected:
            fp = ctx["fingerprint"]
            msg = (f"unexpected backend compile ({what}) in warm path "
                   f"{ctx['site']!r}"
                   + (f" (plan fingerprint {fp[:16]})" if fp else "")
                   + f": {seconds:.3f}s — the built kernels and the plan's "
                   "warm buckets were expected to serve this path at zero "
                   "compiles")
            with self._lock:
                self.unexpected_compiles += 1
                self._diags.append({"code": "TM901", "message": msg,
                                    "location": ctx["site"]})
            log.warning("TM901 %s", msg)

    def on_fault_injected(self, point: str, error: str,
                          tenant: Optional[str] = None) -> None:
        """Record an injected fault; auto-dump when a dump_dir is set.
        ``tenant`` carries the fleet attribution of per-tenant fault
        points (register/evict/route/shed — serve/faults.py) into the
        event AND the auto-dumped snapshot, so a scripted fleet fault is
        attributable to its tenant postmortem."""
        data = {"point": point, "error": error}
        if tenant is not None:
            data["tenant"] = tenant
        self.record("fault_injected", **data)
        if self.dump_dir is None:
            return
        with self._lock:
            if self._auto_dumps >= _MAX_AUTO_DUMPS:
                return
            self._auto_dumps += 1
            n = self._auto_dumps
        try:
            self.dump(os.path.join(self.dump_dir,
                                   f"flight-fault-{n:03d}.json"),
                      reason=f"fault_injected:{point}")
        except OSError as e:  # pragma: no cover — disk trouble only
            log.warning("flight auto-dump failed: %s", e)

    # -- introspection -------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = [dict(ev) for ev in self._events]
        if kind is not None:
            evs = [ev for ev in evs if ev["kind"] == kind]
        return evs

    def diagnostics(self) -> List[Any]:
        """The recorded TM901 findings as typed Diagnostics."""
        from ..checkers.diagnostics import make_diagnostic

        with self._lock:
            raw = list(self._diags)
        return [make_diagnostic(d["code"], d["message"],
                                location=d["location"]) for d in raw]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- export --------------------------------------------------------------
    def to_payload(self, reason: str = "on_demand") -> Dict[str, Any]:
        """JSON-able dump payload with stable key ordering."""
        with self._lock:
            # counters snapshot under the same lock as the event ring so a
            # dump can't pair a fresh event list with stale/torn counters
            events = [dict(ev) for ev in self._events]
            diags = list(self._diags)
            dropped = self.dropped
            unexpected = self.unexpected_compiles
        return {"dropped": dropped,
                "dumped_at": round(time.time(), 3),
                "events": events,
                "reason": reason,
                "tm_diagnostics": diags,
                "unexpected_compiles": unexpected}

    def dump(self, path: Optional[str] = None,
             reason: str = "on_demand") -> str:
        if path is None:
            if self.dump_dir is None:
                raise ValueError("no path given and no dump_dir configured")
            path = os.path.join(self.dump_dir, "flight.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_payload(reason), fh, sort_keys=True,
                      default=str)
        return path


#: the one installed recorder (process-global, like the fault harness: the
#: scoring threads must reach it without contextvar propagation)
_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def on_backend_compile(seconds: float, what: str, **data) -> None:
    """Record one compile into the installed recorder under the calling
    thread's :func:`compile_context` (``perf/timers.py::note_compile``
    calls this from the site that builds, loads or allocates); disabled
    cost: one global read."""
    rec = _RECORDER
    if rec is None:
        return
    rec._on_backend_compile(current_compile_context(), seconds, what, **data)


def install_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Install ``recorder`` process-wide; raises if another is active."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is not None:
            raise RuntimeError("another FlightRecorder is already installed")
        _RECORDER = recorder
    return recorder


def uninstall_recorder(recorder: Optional[FlightRecorder] = None) -> None:
    global _RECORDER
    with _RECORDER_LOCK:
        if recorder is None or _RECORDER is recorder:
            _RECORDER = None


def active_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def record_event(kind: str, **data) -> None:
    """Record into the installed recorder; disabled cost: one global read."""
    rec = _RECORDER
    if rec is None:
        return
    rec.record(kind, **data)


def record_fault(point: str, error: BaseException,
                 tenant: Optional[str] = None) -> None:
    """Hook for the fault harness: record + (configured) auto-dump, with
    the firing fault point's tenant attribution when it has one."""
    rec = _RECORDER
    if rec is None:
        return
    rec.on_fault_injected(point, type(error).__name__, tenant=tenant)
