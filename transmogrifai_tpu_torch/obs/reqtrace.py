"""Request-scoped causal tracing + per-tenant device-time cost accounting
(the port's copy of ``transmogrifai_tpu/obs/reqtrace.py``; host code only).

It answers "why was THIS tenant's p99 request slow?" from one
``trace.json``:

- :func:`mint_request` — a request id minted at ``MicroBatcher.submit``
  (only when a tracer with ``detail="requests"`` is installed, so the
  default serve hot path pays one global read) and carried on the queued
  request through flush → the plan → resilience → response.  At response
  time the whole flushed batch's request tracks export as ONE Chrome-trace
  ring slot (``Tracer.add_request_batch``; the per-request ``b``/``e``
  async pairs and queue/total timing math materialize at export), each end
  event linking to its batch via ``batch_seq``.
- :class:`BatchTrace` — ALWAYS minted by the batcher flusher (a slotted
  object plus a handful of phase marks per batch — the cost-accounting
  backbone works with telemetry off).  ``CompiledScoringPlan`` and the
  resilience layer record phase marks (encode/device/host, retries,
  bisection, host fallback) into the contextvar-held active batch trace;
  the batcher amortizes the batch's device seconds across its constituent
  tenants into the canonical ``tmog_serve_batcher_device_seconds_total``
  counters (obs/metrics.py) when the batch completes.  The port's
  ``device`` mark is the batch's prefix as the card's CUDA events time it
  (the host's enqueue inside them), taken when the batch finalizes; its
  ``dispatch_s`` arg is the host's clock around the dispatch.  On the CPU,
  where there are no events, both are the host's clock.
- :func:`tenant_scope` — the fleet dispatcher (serve/registry.py) wraps
  each tenant's sub-batch in it, so phase marks and the
  ``serve.encode/device/host`` spans carry exact tenant attribution: a
  shared flush's device time bills each tenant for precisely its own
  sub-batch dispatches, and the per-tenant total sums to the batch total
  by construction.
- :func:`reconstruct_request` — the export-side join: given a
  ``trace.json`` payload and a request id, rebuilds the causal chain
  submit → queue → flush → encode → device → host → response with
  per-phase durations, padding waste, and the co-batched peers' tenants.

Nothing here emits unless the respective sink is installed; contexts are
contextvar-held so the flusher thread's batch never leaks into another
thread's scoring.
"""

from __future__ import annotations

import contextvars
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import trace as obs_trace

#: request ids are process-monotonic (they key the async tracks; the trace
#: of one process must never alias two requests onto one track)
_RID = itertools.count(1)
#: flushed-batch sequence numbers — the request<->batch-span link key
_SEQ = itertools.count(1)

#: the flusher thread's active batch trace; contextvar (not a bare global)
#: so a second batcher's flusher thread gets its own slot
_BATCH: "contextvars.ContextVar[Optional[BatchTrace]]" = \
    contextvars.ContextVar("transmogrifai_tpu_torch_obs_batch_trace", default=None)

#: tenant attribution of the currently dispatching sub-batch (the fleet
#: fans a mixed flush out per tenant; serve-level single-model paths leave
#: it None)
_TENANT: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("transmogrifai_tpu_torch_obs_cost_tenant", default=None)


def mint_request() -> Optional[int]:
    """A fresh request id when per-request tracing is on (a tracer with
    ``detail="requests"`` is installed), else None.  The id is the only
    per-request state: the enqueue timestamp, tenant, and slo already live
    on the batcher's queued request, so the submit hot path pays one
    global read plus one counter tick."""
    tracer = obs_trace.active_tracer()
    if tracer is None or tracer.detail != "requests":
        return None
    return next(_RID)


def finish_request(req, outcome: str,
                   batch_seq: Optional[int] = None) -> None:
    """Emit one request's async track from a queued-request object (duck
    typed: ``.ctx``/``.t_enqueue``/``.tenant``/``.slo``) — the off-batch
    resolution paths (shed, expired, cancelled, rejected, shutdown).
    Clears ``req.ctx`` so a request resolves into the trace exactly once.
    """
    rid = req.ctx
    if rid is None:
        return
    req.ctx = None
    tracer = obs_trace.active_tracer()
    if tracer is None:
        return
    tracer.add_request(rid, req.t_enqueue, outcome, req.tenant, req.slo,
                       batch_seq)


class Mark:
    """One timed phase inside a flushed batch (cost accounting + trace)."""

    __slots__ = ("phase", "t0", "dur_s", "tenant", "args")

    def __init__(self, phase: str, t0: float, dur_s: float,
                 tenant: Optional[str], args: Dict[str, Any]):
        self.phase = phase
        self.t0 = t0
        self.dur_s = dur_s
        self.tenant = tenant
        self.args = args


class BatchTrace:
    """Per-flush accumulator of phase marks (always on — the device-time
    cost counters must accumulate with telemetry fully disabled)."""

    __slots__ = ("seq", "size", "marks")

    def __init__(self, size: int):
        self.seq = next(_SEQ)
        self.size = size
        self.marks: List[Mark] = []


def begin_batch(size: int) -> Tuple[BatchTrace, Any]:
    bt = BatchTrace(size)
    return bt, _BATCH.set(bt)


def end_batch(token: Any) -> None:
    _BATCH.reset(token)


def active_batch() -> Optional[BatchTrace]:
    return _BATCH.get()


def mark_phase(phase: str, t0: float, dur_s: float, **args) -> None:
    """Record one phase mark into the active batch trace (no-op — one
    contextvar read — outside a batcher flush)."""
    bt = _BATCH.get()
    if bt is None:
        return
    bt.marks.append(Mark(phase, t0, dur_s, _TENANT.get(), args))


class batch_scope:
    """Re-enter an existing :class:`BatchTrace` on ANOTHER thread — the
    pipelined batcher's finalizer runs batch N's host remainder off the
    flusher thread, and the host-phase marks must land on the same trace
    the flusher's encode/device marks went to.  Contextvar set/reset, so a
    nested scope (or the flusher's own begin_batch) is unaffected."""

    __slots__ = ("bt", "token")

    def __init__(self, bt: Optional["BatchTrace"]):
        self.bt = bt

    def __enter__(self) -> "batch_scope":
        self.token = _BATCH.set(self.bt)
        return self

    def __exit__(self, *exc) -> None:
        _BATCH.reset(self.token)


class tenant_scope:
    """Attribute phase marks + serve spans of the enclosed dispatch to one
    tenant (the fleet's per-tenant sub-batch fan-out)."""

    __slots__ = ("tenant", "token")

    def __init__(self, tenant: Optional[str]):
        self.tenant = tenant

    def __enter__(self) -> "tenant_scope":
        self.token = _TENANT.set(self.tenant)
        return self

    def __exit__(self, *exc) -> None:
        _TENANT.reset(self.token)


def current_tenant() -> Optional[str]:
    return _TENANT.get()


def batch_device_cost(bt: BatchTrace, tenants: Sequence[Optional[str]]
                      ) -> Tuple[float, Dict[str, float], int]:
    """``(total device seconds, {tenant: amortized seconds}, padded rows)``.

    Tenant-tagged device marks bill their tenant directly (the fleet fans
    each flush out per tenant sub-batch, so attribution is exact and the
    per-tenant total sums to the batch total by construction).  Untagged
    device time — a single-model server, or records submitted without a
    tenant — amortizes across the batch's tenanted records by record
    share; with no tenanted records it stays global-only.
    """
    total = untagged = 0.0
    padded = 0
    per_tenant: Dict[str, float] = {}
    for m in bt.marks:
        if m.phase != "device":
            continue
        total += m.dur_s
        padded += int(m.args.get("padded", 0))
        if m.tenant is not None:
            per_tenant[m.tenant] = per_tenant.get(m.tenant, 0.0) + m.dur_s
        else:
            untagged += m.dur_s
    if untagged > 0.0:
        counts: Dict[str, int] = {}
        for t in tenants:
            if t is not None:
                counts[t] = counts.get(t, 0) + 1
        n = sum(counts.values())
        if n:
            for t, c in counts.items():
                per_tenant[t] = per_tenant.get(t, 0.0) + untagged * (c / n)
    return total, per_tenant, padded


# ---------------------------------------------------------------------------
# Export-side reconstruction (tests, postmortems — never the hot path)
# ---------------------------------------------------------------------------

#: the per-batch phase spans the plan emits inside serve.flush
_PHASE_SPANS = ("serve.encode", "serve.device", "serve.host",
                "serve.host_fallback")


def request_events(trace: Dict[str, Any]) -> Dict[int, Dict[str, dict]]:
    """{request id: {"b": begin event, "e": end event}} from a Chrome-trace
    payload (only ``cat == REQUEST_CAT`` async events)."""
    out: Dict[int, Dict[str, dict]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") == obs_trace.REQUEST_CAT and ev.get("ph") in "be":
            out.setdefault(ev["id"], {})[ev["ph"]] = ev
    return out


def reconstruct_request(trace: Dict[str, Any], request_id: int
                        ) -> Dict[str, Any]:
    """Rebuild one request's causal chain from an exported ``trace.json``.

    Joins the request's async end event to its flushed batch
    (``serve.flush`` X span with the matching ``batch_seq``) and that
    batch's phase spans, filtered to the request's tenant when the spans
    carry tenant attribution — a fleet flush dispatches per tenant
    sub-batch.  Phase spans that carry a ``batch_seq`` arg (the
    pipelined batcher interleaves batch N's host phase with batch N+1's
    encode/device, across two threads) join on that key directly; legacy
    spans without one fall back to the flusher-tid + time-window
    containment join.  Raises KeyError when the request id is absent and
    ValueError when its batch span fell out of the bounded ring.
    """
    reqs = request_events(trace)
    if request_id not in reqs or "e" not in reqs[request_id]:
        raise KeyError(f"request {request_id} has no end event in the trace")
    end = reqs[request_id]["e"]
    begin = reqs[request_id].get("b")
    tenant = end["args"].get("tenant")
    batch_seq = end["args"].get("batch_seq")
    out: Dict[str, Any] = {
        "request_id": request_id,
        "tenant": tenant,
        "slo": end["args"].get("slo"),
        "outcome": end["args"].get("outcome"),
        "submit_ts_us": begin["ts"] if begin else None,
        "response_ts_us": end["ts"],
        "queue_ms": end["args"].get("queue_ms"),
        "total_ms": end["args"].get("total_ms"),
        "batch_seq": batch_seq,
        "phases": {},
        "batch": None,
        "peer_tenants": [],
    }
    if batch_seq is None:
        return out
    flush = None
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("name") == "serve.flush" \
                and ev.get("args", {}).get("batch_seq") == batch_seq:
            flush = ev
            break
    if flush is None:
        raise ValueError(f"batch {batch_seq} has no serve.flush span "
                         "(trace ring truncated?)")
    out["batch"] = {"size": flush["args"].get("batch"),
                    "ts_us": flush["ts"], "dur_us": flush["dur"],
                    "tid": flush["tid"]}
    lo, hi = flush["ts"], flush["ts"] + flush["dur"]
    phases: Dict[str, Dict[str, Any]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("name") not in _PHASE_SPANS:
            continue
        span_seq = ev.get("args", {}).get("batch_seq")
        if span_seq is not None:
            # exact join: the span knows its batch — tid and wall-clock
            # containment are meaningless under pipelining
            if span_seq != batch_seq:
                continue
        else:
            if ev.get("tid") != flush["tid"]:
                continue
            if not (lo - 1.0 <= ev["ts"]
                    and ev["ts"] + ev["dur"] <= hi + 1.0):
                continue
        span_tenant = ev.get("args", {}).get("tenant")
        if span_tenant is not None and tenant is not None \
                and span_tenant != tenant:
            continue
        key = ev["name"].split(".", 1)[1]
        ph = phases.setdefault(key, {"ms": 0.0, "spans": 0})
        ph["ms"] = round(ph["ms"] + ev["dur"] / 1e3, 3)
        ph["spans"] += 1
        if key == "device":
            ph.setdefault("bucket", ev["args"].get("bucket"))
            ph.setdefault("padded", ev["args"].get("padded"))
    out["phases"] = phases
    peers = {e["e"]["args"].get("tenant")
             for e in reqs.values()
             if "e" in e and e["e"]["args"].get("batch_seq") == batch_seq}
    out["peer_tenants"] = sorted(t for t in peers if t is not None)
    return out
