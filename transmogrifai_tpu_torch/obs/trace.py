"""Trace spans — Chrome-trace-event telemetry for train, serve and refit
(the port's copy of ``transmogrifai_tpu/obs/trace.py``; host code only).

- :class:`Tracer` — a bounded, thread-safe event sink.  One tracer is
  installed process-wide (:func:`install_tracer`); the batcher's flusher and
  finalizer, the shadow-mirror worker and the training thread all emit into
  it, each under its own ``tid``, so the export shows real cross-thread
  timelines.
- :func:`span` — contextvar-based nesting: each thread (and each
  ``contextvars`` context) carries its own open-span stack, so a span
  opened on the flusher thread records its parent on THAT thread without
  any cross-thread locking.  Disabled cost is one module-global read.
- Export is Chrome trace-event JSON (``"X"`` complete events with
  ``ts``/``dur`` microseconds + ``pid``/``tid``, thread-name metadata
  events) — loadable in Perfetto or chrome://tracing.

Span taxonomy: ``train.*`` (the ``perf/timers.py`` phase sites re-emit
here), ``serve.*`` (flush → encode → device → host, shadow mirror),
``continual.*`` (drift → refit → gate → swap).  A span's clock is the
host's: ``serve.device`` times the host's enqueue of the batch's prefix;
the card's own time of it (CUDA events) rides the batch's ``device`` cost
mark (``obs/reqtrace.py``).
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: default bound on buffered events — a long-running serve loop must not
#: grow memory; the newest events win (the tail of an incident matters most)
_DEFAULT_CAPACITY = 262_144

#: Chrome-trace async category of per-request events (obs/reqtrace.py):
#: the ``(cat, id)`` pair groups one request's begin/end into one async
#: track, linked to its batch via the end event's ``batch_seq`` arg
REQUEST_CAT = "serve.request"

#: per-context stack of open span names (parent attribution)
_SPAN_STACK: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "transmogrifai_tpu_torch_obs_span_stack", default=())


class Tracer:
    """Bounded thread-safe sink of Chrome trace events.

    ``detail`` selects the serve-path granularity: ``"batch"`` (default)
    emits per-batch lifecycle spans only; ``"requests"`` additionally emits
    one instant event per enqueued request (heavier — opt in for short
    replays, not sustained load).
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 detail: str = "batch"):
        if detail not in ("batch", "requests"):
            raise ValueError(f"unknown tracer detail {detail!r}")
        self.detail = detail
        # HOT PATH is lock-free: events append as raw tuples (a bounded
        # deque append is GIL-atomic) and materialize into Chrome-trace
        # dicts only at export
        self._events: "deque[tuple]" = deque(maxlen=int(capacity))
        self._tids: Dict[int, str] = {}
        #: atomic append counter (itertools.count consumes in C under the
        #: GIL): a bare `+= 1` from concurrent threads loses increments and
        #: under-reports `dropped` — the signal that the trace truncated
        self._counter = itertools.count(1)
        self._added = 0
        #: perf_counter origin: every ts is microseconds since tracer start
        self._t0 = time.perf_counter()
        #: monotonic twin of the origin, captured back-to-back: request
        #: records reuse the batcher's existing time.monotonic() stamps
        #: (zero extra clock reads on the submit hot path) and export
        #: converts through this origin onto the same timeline
        self._t0_mono = time.monotonic()
        self._pid = os.getpid()

    @property
    def dropped(self) -> int:
        return max(0, self._added - len(self._events))

    # -- emission ------------------------------------------------------------
    def add_complete(self, name: str, cat: str, t0: float, dur_s: float,
                     args: Optional[Dict[str, Any]] = None) -> None:
        """One ``"X"`` complete event: ``t0`` is a perf_counter timestamp."""
        tid = threading.get_ident()
        if tid not in self._tids:
            self._tids[tid] = threading.current_thread().name
        self._added = next(self._counter)
        self._events.append(("X", name, cat, t0, dur_s, tid, args))

    def add_instant(self, name: str, cat: str,
                    args: Optional[Dict[str, Any]] = None) -> None:
        tid = threading.get_ident()
        if tid not in self._tids:
            self._tids[tid] = threading.current_thread().name
        self._added = next(self._counter)
        self._events.append(("i", name, cat, time.perf_counter(), 0.0, tid,
                             args))

    def add_request(self, rid: int, t_enqueue_mono: float, outcome: str,
                    tenant: Optional[str], slo: Optional[str],
                    batch_seq: Optional[int] = None) -> None:
        """One request's whole async track as ONE ring slot (the off-batch
        resolution paths: shed, deadline-expired, cancelled, rejected).

        The Chrome-trace ``b``/``e`` async event pair (track keyed by
        ``(cat, id)``) materializes at export with the begin event
        back-dated to the enqueue timestamp, so a request can never leave
        an orphaned begin event.  Timestamps are ``time.monotonic()``
        values (the batcher's existing stamps) converted onto the
        perf_counter timeline through the paired origins.
        """
        tid = threading.get_ident()
        if tid not in self._tids:
            self._tids[tid] = threading.current_thread().name
        self._added = next(self._counter)
        self._events.append(("R", rid, t_enqueue_mono, time.monotonic(),
                             outcome, tenant, slo, batch_seq, tid))

    def add_request_batch(self, batch_seq: int, t_claim_mono: float,
                          rows: List[tuple]) -> None:
        """Every request track of one flushed batch as ONE ring slot.

        ``rows`` is ``[(rid, t_enqueue_mono, tenant, slo, outcome), ...]``.
        This is THE per-request hot path (it runs once per flushed batch
        inside the serve loop), so the per-request cost is one small tuple
        append — all
        dict building, b/e pairing, and queue/total timing math happen at
        export time.
        """
        tid = threading.get_ident()
        if tid not in self._tids:
            self._tids[tid] = threading.current_thread().name
        self._added = next(self._counter)
        self._events.append(("RB", batch_seq, t_claim_mono,
                             time.monotonic(), tid, rows))

    # -- export --------------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        # snapshot under retry: the hot append path is lock-free, so a
        # concurrent append can invalidate the deque iterator (CPython
        # raises RuntimeError); exports are rare — retrying is cheaper
        # than taxing every event append with a lock
        raw: List[tuple] = []
        for _ in range(16):
            try:
                raw = list(self._events)
                break
            except RuntimeError:  # mutated during iteration — retry
                continue
        tids = dict(self._tids)
        t0, pid = self._t0, self._pid
        meta = [{"name": "thread_name", "ph": "M", "pid": pid,
                 "tid": tid, "args": {"name": name}}
                for tid, name in sorted(tids.items())]
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": "transmogrifai_tpu_torch"}})
        t0_mono = self._t0_mono

        def emit_request(events, rid, t_enq, t_end, outcome, tenant, slo,
                         batch_seq, queue_ms, tid):
            # one request record -> the async b/e pair on track
            # (REQUEST_CAT, id); deferred from the hot path (add_request*)
            begin_args: Dict[str, Any] = {}
            end_args: Dict[str, Any] = {
                "outcome": outcome,
                "total_ms": round(max(t_end - t_enq, 0.0) * 1e3, 3)}
            if tenant is not None:
                begin_args["tenant"] = tenant
                end_args["tenant"] = tenant
            if slo is not None:
                begin_args["slo"] = slo
                end_args["slo"] = slo
            if batch_seq is not None:
                end_args["batch_seq"] = batch_seq
            if queue_ms is not None:
                end_args["queue_ms"] = round(max(queue_ms, 0.0), 3)
            common = {"name": "request", "cat": REQUEST_CAT, "id": rid,
                      "pid": pid, "tid": tid}
            events.append({**common, "ph": "b",
                           "ts": round((t_enq - t0_mono) * 1e6, 1),
                           "args": begin_args})
            events.append({**common, "ph": "e",
                           "ts": round((max(t_end, t_enq) - t0_mono) * 1e6,
                                       1),
                           "args": end_args})

        events: List[dict] = []
        for row in raw:
            kind = row[0]
            if kind == "R":
                (_ph, rid, t_enq, t_end, outcome, tenant, slo,
                 batch_seq, tid) = row
                emit_request(events, rid, t_enq, t_end, outcome, tenant,
                             slo, batch_seq, None, tid)
                continue
            if kind == "RB":
                _ph, batch_seq, t_claim, t_end, tid, rows = row
                for rid, t_enq, tenant, slo, outcome in rows:
                    emit_request(events, rid, t_enq, t_end, outcome,
                                 tenant, slo, batch_seq,
                                 (t_claim - t_enq) * 1e3, tid)
                continue
            ph, name, cat, t, dur_s, tid, args = row
            ev = {"name": name, "cat": cat, "ph": ph,
                  "ts": round((t - t0) * 1e6, 1), "pid": pid, "tid": tid,
                  "args": args or {}}
            if ph == "X":
                ev["dur"] = round(max(dur_s, 0.0) * 1e6, 1)
            else:
                ev["s"] = "t"
            events.append(ev)
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        return path

    def __len__(self) -> int:
        return len(self._events)


#: the one installed tracer.  Process-global (NOT a contextvar): the
#: micro-batcher flusher and shadow-mirror workers are separate threads that
#: must emit into the same sink; span NESTING stays contextvar-based above.
_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()


def install_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` process-wide; raises if another is active."""
    global _TRACER
    with _TRACER_LOCK:
        if _TRACER is not None:
            raise RuntimeError("another Tracer is already installed")
        _TRACER = tracer
    return tracer


def uninstall_tracer(tracer: Optional[Tracer] = None) -> None:
    """Remove the installed tracer (no-op when none, or when ``tracer`` is
    given and a DIFFERENT tracer is installed)."""
    global _TRACER
    with _TRACER_LOCK:
        if tracer is None or _TRACER is tracer:
            _TRACER = None


def active_tracer() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    """True when a tracer is installed — the one-read disabled-cost check
    hot paths use before building event payloads."""
    return _TRACER is not None


class _Span:
    """Slotted class-based span context manager: cheaper than a
    generator-based ``@contextmanager`` on both the enabled and disabled
    paths — this sits on the per-batch serve hot path."""

    __slots__ = ("name", "cat", "args", "tracer", "token", "stack", "t0")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        tracer = _TRACER
        self.tracer = tracer
        if tracer is None:
            return self
        stack = _SPAN_STACK.get()
        self.stack = stack
        self.token = _SPAN_STACK.set(stack + (self.name,))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        tracer = self.tracer
        if tracer is None:
            return
        dt = time.perf_counter() - self.t0
        _SPAN_STACK.reset(self.token)
        args = self.args
        if self.stack:
            args = dict(args) if args else {}
            args["parent"] = self.stack[-1]
        tracer.add_complete(self.name, self.cat, self.t0, dt, args)


def span(name: str, cat: str = "app", **args) -> _Span:
    """Time a span into the installed tracer.  Disabled cost: one global
    read.  Nesting is contextvar-based — the parent name recorded in
    ``args["parent"]`` is this thread's (this context's) innermost open
    span, never another thread's."""
    return _Span(name, cat, args)


def instant(name: str, cat: str = "app", **args) -> None:
    """Instant event (no duration); disabled cost: one global read."""
    tracer = _TRACER
    if tracer is None:
        return
    stack = _SPAN_STACK.get()
    if stack:
        args["parent"] = stack[-1]
    tracer.add_instant(name, cat, args)


def current_span_stack() -> tuple:
    """This context's open span names, outermost first (introspection)."""
    return _SPAN_STACK.get()
