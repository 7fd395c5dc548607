"""Nestable phase timers + a process-wide compile probe (counterpart of
``transmogrifai_tpu/perf/timers.py``).

Phase timers: the selector fit, the cross-validator, and the workflow fit
loop wrap their phases in ``phase("name")``.  Spans land in every active
``PhaseRecorder`` (recorders nest — the selector records its own fit profile
while a caller's ambient recorder captures the same spans), and, when an
``obs`` tracer is installed, in the trace as ``train``-category spans.

Compile probe: the port compiles no program at run time, so its
counterparts of the reference's backend compiles are counted where they
happen, by a direct call into :func:`note_compile` (nothing polls):

- an ``nvcc`` build of a kernel library and the load of a kernel library
  (``perf/kernels/dispatch.py::build`` / ``load``); a library found built
  on disk and loaded without ``nvcc`` is a persistent-cache hit, one
  ``nvcc`` had to build a miss, and ``compile_seconds`` sums ``nvcc``'s
  seconds;
- a serving plan's first allocation for a row bucket: its staging buffers
  or a landing set (``serve/plan.py``);
- a chunked epoch's one chunk tile: the pinned staging and encode buffer
  every chunk of the epoch reuses (``workflow/plan.py::TileBuffers``).

Each also lands one ``backend_compile`` flight event under the calling
thread's ``compile_context`` (``obs/flight.py``), so one inside a warm
context raises TM901.  ``measure_compiles`` yields a live delta object:
``with measure_compiles() as c: refit(); assert c.backend_compiles == 0``.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..obs import flight as obs_flight
from ..obs import trace as obs_trace


# ---------------------------------------------------------------------------
# Phase timers
# ---------------------------------------------------------------------------

@dataclass
class Span:
    """One timed phase execution.  ``path`` is the dotted nesting path."""

    name: str
    path: str
    start: float
    seconds: float


class PhaseRecorder:
    """Collects spans; ``report()`` aggregates seconds by dotted path.

    Paths are RELATIVE to the recorder's activation point: a recorder opened
    inside ``phase("fit.modelSelector")`` records the selector's "validate"
    span as ``validate``, while an outer recorder sees the same span as
    ``fit.modelSelector.validate`` — so consumers parse stable paths
    regardless of how deep the fit ran.
    """

    def __init__(self):
        self.spans: List[Span] = []
        #: phase-stack depth when this recorder was activated
        self._base = 0

    def add(self, span: Span) -> None:
        self.spans.append(span)

    def report(self, round_to: int = 4) -> Dict[str, float]:
        """{dotted path: total seconds} over all recorded spans."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.path] = out.get(s.path, 0.0) + s.seconds
        return {k: round(v, round_to) for k, v in out.items()}

    def total(self, path: str) -> float:
        """Summed seconds of spans recorded at exactly ``path``.

        Exact-path only: a parent span's time already includes its nested
        children, so summing the subtree would double-count."""
        return sum(s.seconds for s in self.spans if s.path == path)


#: stack of active recorders (outermost first) — spans land in ALL of them
_RECORDERS: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "transmogrifai_tpu_torch_perf_recorders", default=())
#: current nesting path of open phases
_PHASE_STACK: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "transmogrifai_tpu_torch_perf_phase_stack", default=())


def current_recorder() -> Optional[PhaseRecorder]:
    """Innermost active recorder, or None."""
    stack = _RECORDERS.get()
    return stack[-1] if stack else None


@contextlib.contextmanager
def record_phases(recorder: Optional[PhaseRecorder] = None):
    """Activate a PhaseRecorder for the duration of the block.

    Nesting is additive: an inner ``record_phases`` does not hide the outer
    one — spans recorded inside land in both.
    """
    rec = recorder if recorder is not None else PhaseRecorder()
    rec._base = len(_PHASE_STACK.get())
    token = _RECORDERS.set(_RECORDERS.get() + (rec,))
    try:
        yield rec
    finally:
        _RECORDERS.reset(token)


class _Phase:
    """Slotted class-based context manager (cheaper than a generator CM on
    both the active and no-op paths — phases sit on hot per-batch loops)."""

    __slots__ = ("name", "recorders", "tracer", "token", "parts", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Phase":
        recorders = _RECORDERS.get()
        tracer = obs_trace.active_tracer()
        self.recorders = recorders
        self.tracer = tracer
        if not recorders and tracer is None:
            self.token = None
            return self
        stack = _PHASE_STACK.get()
        self.token = _PHASE_STACK.set(stack + (self.name,))
        self.parts = stack + (self.name,)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.token is None:
            return
        dt = time.perf_counter() - self.t0
        _PHASE_STACK.reset(self.token)
        for rec in self.recorders:
            rel = self.parts[rec._base:]  # path relative to recorder base
            if rel:
                rec.add(Span(name=self.name, path=".".join(rel),
                             start=self.t0, seconds=dt))
        if self.tracer is not None:
            self.tracer.add_complete(".".join(self.parts), "train",
                                     self.t0, dt, {})


def phase(name: str) -> _Phase:
    """Time a phase.  No-op (zero overhead beyond a contextvar read and a
    tracer-global read) when no recorder AND no trace sink is active.
    Phases nest: ``phase("fit")`` inside ``phase("validate")`` records as
    path ``validate.fit``.  When an ``obs`` tracer is installed
    (docs/observability.md), every phase additionally lands there as a
    ``train``-category span under its full dotted path."""
    return _Phase(name)


# ---------------------------------------------------------------------------
# Compile probe
# ---------------------------------------------------------------------------

#: the kinds :func:`note_compile` counts (``CompileStats.events`` keys)
COMPILE_KINDS = ("nvcc_build", "library_load", "staging", "landing", "chunk_tile")


@dataclass
class CompileStats:
    """Cumulative compile counters (process-wide since import):
    ``backend_compiles`` = kernel builds + library loads + bucket and
    chunk-tile allocations; ``trace_seconds`` stays 0 (nothing is traced)."""

    backend_compiles: int = 0
    compile_seconds: float = 0.0
    trace_seconds: float = 0.0
    persistent_cache_hits: int = 0
    persistent_cache_misses: int = 0
    events: Dict[str, int] = field(default_factory=dict)

    def snapshot(self) -> "CompileStats":
        return CompileStats(
            backend_compiles=self.backend_compiles,
            compile_seconds=self.compile_seconds,
            trace_seconds=self.trace_seconds,
            persistent_cache_hits=self.persistent_cache_hits,
            persistent_cache_misses=self.persistent_cache_misses,
            events=dict(self.events),
        )

    def minus(self, other: "CompileStats") -> "CompileStats":
        return CompileStats(
            backend_compiles=self.backend_compiles - other.backend_compiles,
            compile_seconds=self.compile_seconds - other.compile_seconds,
            trace_seconds=self.trace_seconds - other.trace_seconds,
            persistent_cache_hits=(self.persistent_cache_hits
                                   - other.persistent_cache_hits),
            persistent_cache_misses=(self.persistent_cache_misses
                                     - other.persistent_cache_misses),
            events={k: v - other.events.get(k, 0)
                    for k, v in self.events.items()
                    if v - other.events.get(k, 0)},
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "backend_compiles": self.backend_compiles,
            "compile_seconds": round(self.compile_seconds, 3),
            "trace_seconds": round(self.trace_seconds, 3),
            "persistent_cache_hits": self.persistent_cache_hits,
            "persistent_cache_misses": self.persistent_cache_misses,
            "events": dict(sorted(self.events.items())),
        }


_GLOBAL = CompileStats()
_LOCK = threading.Lock()


def note_compile(what: str, seconds: float = 0.0,
                 cache_hit: Optional[bool] = None, **data) -> None:
    """Count one compile of kind ``what`` (:data:`COMPILE_KINDS`) and record
    it into the installed flight recorder under the caller's
    ``compile_context``.  ``seconds`` is the time it took (``nvcc``'s for a
    build); ``cache_hit`` marks a library load that found the library built
    on disk (True) or a build (False).  Called from the site that builds,
    loads or allocates."""
    with _LOCK:
        _GLOBAL.backend_compiles += 1
        _GLOBAL.events[what] = _GLOBAL.events.get(what, 0) + 1
        if what == "nvcc_build":
            _GLOBAL.compile_seconds += seconds
        if cache_hit is True:
            _GLOBAL.persistent_cache_hits += 1
        elif cache_hit is False:
            _GLOBAL.persistent_cache_misses += 1
    obs_flight.on_backend_compile(seconds, what, **data)


def compile_snapshot() -> CompileStats:
    """A copy of the cumulative process-wide compile counters."""
    with _LOCK:
        return _GLOBAL.snapshot()


class _CompileDelta:
    """Live view over compiles since ``measure_compiles`` entered; attributes
    resolve lazily so reads after the with-block see the final delta."""

    def __init__(self, base: CompileStats):
        self._base = base

    def _delta(self) -> CompileStats:
        return compile_snapshot().minus(self._base)

    @property
    def backend_compiles(self) -> int:
        return self._delta().backend_compiles

    @property
    def compile_seconds(self) -> float:
        return self._delta().compile_seconds

    @property
    def persistent_cache_hits(self) -> int:
        return self._delta().persistent_cache_hits

    @property
    def persistent_cache_misses(self) -> int:
        return self._delta().persistent_cache_misses

    @property
    def events(self) -> Dict[str, int]:
        return self._delta().events

    def to_dict(self) -> Dict[str, Any]:
        return self._delta().to_dict()


@contextlib.contextmanager
def measure_compiles():
    """Yield a delta object tracking compiles inside (and after) the block:
    ``with measure_compiles() as c: refit(); assert c.backend_compiles == 0``."""
    yield _CompileDelta(compile_snapshot())
