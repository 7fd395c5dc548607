"""Typed serving faults and a deterministic fault-injection harness
(counterpart of ``transmogrifai_tpu/serve/faults.py``).

The error vocabulary the fault-tolerance layer speaks (``serve/resilience.py``,
``serve/batcher.py``), and a seeded, scriptable injector, so every failure
path is testable with exact schedules instead of sleeps and luck.

Fault points, at the reference's places in the scoring path
(``serve/plan.py``):

- ``encode`` — host-side record extraction and encoding;
- ``device`` — the batch's device dispatch (copies, the encode launch, the
  prefix's torch ops);
- ``host``   — the host remainder.

The server also fires ``shed`` (the batcher's backpressure reclaim), and
``shadow``, ``swap`` and ``rollback`` (``serve/swap.py``), each before its
phase mutates anything.

Training-path fault points (``workflow/resilience.py``: each retried with
bounded backoff under ``resilient_training``, a plain raise otherwise):

- ``ingest_chunk``     — one chunk of a chunked epoch, before its device
  prefix runs (``workflow/ooc.py``);
- ``prefetch``         — the background chunk loader, on its worker thread
  (``readers/prefetch.py``);
- ``stage_fit``        — each estimator fit (``workflow/fit.py``);
- ``sweep_dispatch``   — one family's fold x grid launch
  (``models/tuning.py``);
- ``device_sync``      — the blocking fetch of a sweep's scores
  (``models/base.py::gather_scores``);
- ``checkpoint_write`` — a stage checkpoint or a sweep-journal commit.

Usage in tests::

    harness = FaultHarness(seed=0)
    harness.script("device", [TransientScoringError("oom"), None])
    with harness:                       # first device call fails, rest pass
        server.score_batch(records)
    assert harness.calls["device"] == 2

The harness is process-global while active (the batcher scores on its own
threads, so a contextvar would not reach them) — one harness at a time.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from ..perf.kernels.dispatch import is_kernel_fault

__all__ = [
    "CircuitOpenError",
    "DeadlineExceededError",
    "FaultHarness",
    "LoadShedError",
    "PoisonRecordError",
    "TransientScoringError",
    "fault_point",
    "is_retryable",
]


class PoisonRecordError(RuntimeError):
    """One record is individually unscorable: its future fails, its co-batched
    peers do not.  Raised by the bisect-and-retry quarantine
    (``serve/resilience.py``) with the original failure as ``cause``."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired while it waited in the batch queue; it
    was evicted before any device work was spent on it."""


class LoadShedError(RuntimeError):
    """The request was evicted from the queue to make room for higher-tier
    traffic; carries the tenant and SLO tier it was shed at."""

    def __init__(self, message: str, tenant=None, tier=None):
        super().__init__(message)
        self.tenant = tenant
        self.tier = tier


class TransientScoringError(RuntimeError):
    """A retryable infrastructure failure (device memory exhaustion, a
    transport hiccup) — retry with backoff, never quarantine the records."""


class CircuitOpenError(RuntimeError):
    """No scoring path is available: the device plan's circuit breaker is
    open and the host path failed for this request."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


def is_retryable(exc: BaseException) -> bool:
    """Transient (retry with backoff) vs permanent.

    :class:`TransientScoringError` and ``torch.OutOfMemoryError`` (the
    port's counterpart of the XLA runtime's RESOURCE_EXHAUSTED) are
    retryable.  A kernel's or the device's own fault
    (``dispatch.is_kernel_fault``: a :class:`KernelError`, an illegal address)
    never is: retrying cannot repair it, and the resilience layer fails its
    batch instead.  Everything else — type errors, value errors, poison
    payloads — is permanent: retrying cannot fix the input.
    """
    if is_kernel_fault(exc):
        return False
    return isinstance(exc, (TransientScoringError, torch.OutOfMemoryError))


#: the one active harness (process-global: the batcher's threads would not
#: see a contextvar)
_ACTIVE: Optional["FaultHarness"] = None
_ACTIVE_LOCK = threading.Lock()


class FaultHarness:
    """Seeded, scriptable fault schedules for the serving fault points.

    - ``script(point, schedule)`` — the n-th firing of ``point`` raises the
      n-th schedule entry (None entries pass; callables get the call context
      and return an exception or None).  Entries beyond the schedule pass.
    - ``fail_when(point, predicate, make_error, times=None)`` — raise
      whenever ``predicate(ctx)`` matches, at most ``times`` times (None =
      unbounded).  Predicate rules run after (and independent of) scripts.
    - ``max_fires`` (on ``script``/``fail_when``) — a per-point cap on the
      total injected failures.
    - ``calls`` — firings per point; ``fired`` — (point, call index) log of
      every injected failure.

    ``seed`` makes randomized schedules (callables using ``harness.rng``)
    reproducible.
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.calls: Dict[str, int] = {}
        self.fired: List[tuple] = []
        self._scripts: Dict[str, List[Any]] = {}
        self._rules: List[list] = []  # [point, predicate, make_error, left]
        self._max_fires: Dict[str, int] = {}
        self._fire_counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def script(self, point: str, schedule,
               max_fires: Optional[int] = None) -> "FaultHarness":
        with self._lock:
            self._scripts.setdefault(point, []).extend(schedule)
            if max_fires is not None:
                self._max_fires[point] = int(max_fires)
        return self

    def fail_when(self, point: str, predicate: Callable[[dict], bool],
                  make_error: Callable[[], BaseException],
                  times: Optional[int] = None,
                  max_fires: Optional[int] = None) -> "FaultHarness":
        with self._lock:
            self._rules.append([point, predicate, make_error, times])
            if max_fires is not None:
                self._max_fires[point] = int(max_fires)
        return self

    def _check(self, point: str, ctx: dict) -> Optional[BaseException]:
        with self._lock:
            idx = self.calls.get(point, 0)
            self.calls[point] = idx + 1
            cap = self._max_fires.get(point)
            if cap is not None and self._fire_counts.get(point, 0) >= cap:
                return None
            entry = None
            sched = self._scripts.get(point)
            if sched and idx < len(sched):
                entry = sched[idx]
            if callable(entry):
                entry = entry(ctx)
            if entry is None:
                for rule in self._rules:
                    rpoint, pred, make_error, left = rule
                    if rpoint != point or left == 0:
                        continue
                    if pred(ctx):
                        if left is not None:
                            rule[3] = left - 1
                        entry = make_error()
                        break
            if entry is not None:
                self.fired.append((point, idx))
                self._fire_counts[point] = self._fire_counts.get(point, 0) + 1
            return entry

    def __enter__(self) -> "FaultHarness":
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("another FaultHarness is already active")
            _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with _ACTIVE_LOCK:
            _ACTIVE = None


def fault_point(point: str, **ctx) -> None:
    """Hook on the scoring path; raises the scheduled fault when a harness
    is active, otherwise costs one global read.  Every injected fault is
    also recorded by the installed flight recorder (``obs/flight.py``) —
    and auto-dumps the ring buffer when the recorder has a dump_dir — so a
    harness run leaves its own postmortem artifact."""
    harness = _ACTIVE
    if harness is None:
        return
    err = harness._check(point, ctx)
    if err is not None:
        from ..obs import flight as obs_flight

        # the per-tenant fault points (register/evict/route/shed, and any
        # serve-level point the fleet fires with a tenant in its context)
        # carry the tenant into the flight event + auto-dumped snapshot
        tenant = ctx.get("tenant")
        obs_flight.record_fault(point, err,
                                tenant=str(tenant)
                                if tenant is not None else None)
        raise err
