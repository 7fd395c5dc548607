"""Fault-tolerant training: durable sweep progress and graceful degradation
(counterpart of ``transmogrifai_tpu/workflow/resilience.py``).

Three parts, as in the reference:

1. **SweepJournal** — an ``OffsetCheckpoint``-style fsync'd journal of
   completed per-(family, fold-block) score matrices, keyed by the full
   content identity of the block (family class, grids, fold spec, metric,
   data digest, mesh token).  A run killed mid-sweep resumes past every
   committed block and replays its scores bitwise: fold weights are seeded
   and the winner's refit is deterministic given identical inputs, so the
   resumed run's model (winner, weights, CV metrics) equals an
   uninterrupted run's, and a replayed block launches NOTHING.

2. **Bounded retry with backoff and jitter** — typed retryable errors
   (:class:`RetryableTrainingError`, :class:`TransientScoringError`,
   ``torch.OutOfMemoryError``) retry ``max_retries`` times per rung with
   ``min(cap, base * 2**(attempt-1))`` backoff plus seeded jitter;
   non-retryable errors (a kernel's or the device's fault among them) FAIL
   FAST with the journal intact.

3. **The bucket ladder** — a retryable error that reads as resource
   exhaustion ("CUDA out of memory" does) retries the block on the
   next-smaller power-of-two row cap, lands a TM822 diagnostic, and the
   degraded block is not journaled under the full-fidelity key.

Every journal key carries ``parallel/mesh.py::mesh_token()`` (``None``
without a mesh), so a meshed sweep never replays an unmeshed one's scores.
The reference's mesh rung (shrink the data axis and re-dispatch, TM821) is
not ported: with one process per card a fault on one rank leaves the others
blocked in their next collective, and shrinking needs the ranks to agree on
the failure first.  Until then a fault under a mesh fails the train on every
rank (through the group timeout) and never retries on the CPU.  The context also
carries the chunked epochs' offset checkpoint (``chunk_offsets.json`` under
``Workflow.train(resume=dir)``; :func:`active_chunk_checkpoint`), and
``retry_call(..., "ingest_chunk")`` re-runs one chunk of an epoch.

Activation is ambient: ``Workflow.train(resume=dir)`` enters
:func:`resilient_training`, and the sweep loop (``models/tuning.py::
sweep_families``, also the workflow-CV fold blocks) and the stage fitter
read :func:`active` — with no active context every wrapped call is a plain
passthrough.  The context is process-global (a stack under a lock, the
``serve/faults.py`` harness idiom).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ..serve.faults import fault_point, is_retryable

__all__ = [
    "RetryPolicy",
    "RetryableTrainingError",
    "SweepJournal",
    "TrainResilience",
    "active",
    "active_chunk_checkpoint",
    "active_journal",
    "capped_views",
    "data_digest",
    "is_oom",
    "is_retryable_training",
    "last",
    "resilient_training",
    "retry_call",
    "dp_size",
    "run_sweep_block",
    "sweep_block_key",
]

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Typed training errors + classification
# ---------------------------------------------------------------------------

class RetryableTrainingError(RuntimeError):
    """A transient training-path infrastructure failure (device preemption,
    a read hiccup) — retry with backoff; the input is fine."""


#: substrings marking a retryable error as RESOURCE exhaustion — the signal
#: that retrying in place is futile and the bucket ladder should shrink the
#: dispatched row block instead ("CUDA out of memory" is torch's)
_OOM_MARKERS = ("resource_exhausted", "resource exhausted", "out of memory")


def is_oom(exc: BaseException) -> bool:
    """Resource-exhaustion flavor of a retryable error (bucket-ladder food)."""
    msg = str(exc).lower()
    return any(m in msg for m in _OOM_MARKERS)


def is_retryable_training(exc: BaseException) -> bool:
    """The serving classifier plus the training-path retryable type."""
    return isinstance(exc, RetryableTrainingError) or is_retryable(exc)


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------

@dataclass
class RetryPolicy:
    """Bounded exponential backoff + jitter (the continual-refit formula with
    a seeded jitter term so schedules are reproducible run-to-run)."""

    max_retries: int = 3           # in-place retries per ladder rung
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter: float = 0.25           # +/- fraction of the computed delay
    sleep: Callable[[float], None] = time.sleep

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.backoff_cap_s, self.backoff_base_s * (2 ** (attempt - 1)))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)


# ---------------------------------------------------------------------------
# Durable sweep journal
# ---------------------------------------------------------------------------

def data_digest(*arrays) -> str:
    """Content digest of the sweep's input block (dtype+shape+bytes per
    operand) — part of every journal key, so a journal can never replay
    scores onto different data."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        if a is None:
            h.update(b"<none>")
            continue
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def dp_size(mesh) -> int:
    """The data-axis extent of ``mesh`` (1 when no mesh is ambient)."""
    from ..parallel.mesh import DATA_AXIS

    if mesh is None:
        return 1
    return int(mesh.shape[DATA_AXIS])


def sweep_block_key(family: str, grids, fold_spec, metric: str,
                    digest: str, mesh_token, block: str = "all") -> str:
    """Stable identity of one (family, fold-block) sweep unit: the family
    class name, the grid list content, the fold spec (k, seed, stratify),
    the metric name, the input-data digest, the mesh token
    (``parallel/mesh.py::mesh_token``, ``None`` without a mesh) and ``block`` ("all" = every fold
    in one launch, the selector path; ``fold3`` = one fold of the
    workflow-CV path).  The same inputs give the reference's key."""
    payload = json.dumps({
        "family": family,
        "grids": [sorted(g.items()) for g in grids],
        "folds": list(fold_spec),
        "metric": metric,
        "data": digest,
        "mesh": repr(mesh_token),
        "block": block,
    }, sort_keys=True, default=repr)
    return hashlib.blake2b(payload.encode(), digest_size=16).hexdigest()


class SweepJournal:
    """Atomic fsync'd JSON journal of completed sweep-block score matrices.

    Same durability contract as ``readers.streaming.OffsetCheckpoint``: a
    commit writes ``path.tmp`` with flush+fsync then ``os.replace``s it over
    the store, so a kill at ANY instruction leaves either the previous
    journal or the new one — never a torn file.  Zero-byte / non-JSON /
    non-dict content reads as an empty journal, never an exception.

    Scores round-trip bitwise: Python's ``repr``-based float JSON encoding
    is shortest-round-trip, so ``load`` returns the committed matrix
    bit-for-bit."""

    def __init__(self, path: str):
        self.path = path
        self.hits = 0
        self.misses = 0
        self.commits = 0
        self._lock = threading.Lock()

    def _read(self) -> dict:
        try:
            with open(self.path) as fh:
                state = json.load(fh)
        except (OSError, ValueError):
            return {}
        return state if isinstance(state, dict) else {}

    def load(self, key: str) -> Optional[np.ndarray]:
        """The committed (g, k) score matrix for ``key``, or None.  A hit
        bumps the hit counter (the "completed fold-blocks were not
        re-executed" proof)."""
        # drop a stale .tmp: a commit that crashed before its rename never
        # became the journal (the OffsetCheckpoint.load contract)
        try:
            os.remove(self.path + ".tmp")
        except OSError:
            pass
        entry = self._read().get(key)
        with self._lock:
            if not isinstance(entry, dict):
                self.misses += 1
                return None
            try:
                scores = np.asarray(entry["scores"],
                                    dtype=np.dtype(entry.get("dtype",
                                                             "float64")))
            except (KeyError, TypeError, ValueError):
                self.misses += 1
                return None
            self.hits += 1
            return scores

    def commit(self, key: str, scores, family: Optional[str] = None) -> None:
        """Durably record one completed block (read-modify-write under the
        journal lock; tmp+fsync+replace so the store is never torn)."""
        scores = np.asarray(scores)
        fault_point("checkpoint_write", journal=self.path, key=key,
                    family=family)
        with self._lock:
            state = self._read()
            state[key] = {
                "family": family,
                "dtype": str(scores.dtype),
                "scores": [[float(v) for v in row] for row in scores],
            }
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(state, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
            self.commits += 1

    def keys(self) -> List[str]:
        return list(self._read())


# ---------------------------------------------------------------------------
# The ambient resilience context
# ---------------------------------------------------------------------------

class TrainResilience:
    """One training run's fault-tolerance state: the journal, the retry
    policy, the chunked-epoch checkpoint and the degradation record."""

    def __init__(self, journal: Optional[SweepJournal] = None,
                 policy: Optional[RetryPolicy] = None,
                 chunk_checkpoint=None, seed: int = 0,
                 bucket_ladder: bool = True):
        self.journal = journal
        self.policy = policy or RetryPolicy()
        self.chunk_checkpoint = chunk_checkpoint
        self.rng = random.Random(seed)
        self.bucket_ladder = bucket_ladder
        self.retries = 0
        self.degradations: List[dict] = []
        self.diagnostics: List[Any] = []
        self._lock = threading.Lock()

    # -- event + diagnostic plumbing ----------------------------------------
    def _diag(self, code: str, message: str) -> None:
        from ..checkers.diagnostics import make_diagnostic

        with self._lock:
            self.diagnostics.append(make_diagnostic(code, message))
        log.warning("%s: %s", code, message)

    def note_retry(self, point: str, attempt: int, delay: float,
                   exc: BaseException, **ctx) -> None:
        from ..obs import flight as obs_flight

        with self._lock:
            self.retries += 1
        obs_flight.record_event("train_retry", point=point, attempt=attempt,
                                delay_s=round(delay, 4),
                                error=f"{type(exc).__name__}: {exc}", **ctx)
        self._diag("TM820",
                   f"retryable training fault at {point!r} (attempt "
                   f"{attempt}: {type(exc).__name__}: {exc}); retrying in "
                   f"{delay:.3f}s")

    def note_degrade_bucket(self, family: str, rows_from: int, cap: int,
                            exc: BaseException) -> None:
        from ..obs import flight as obs_flight

        with self._lock:
            self.degradations.append({"kind": "bucket_shrink",
                                      "family": family,
                                      "rows_from": rows_from, "row_cap": cap})
        obs_flight.record_event("degrade_bucket_shrink", family=family,
                                rows_from=rows_from, row_cap=cap,
                                error=f"{type(exc).__name__}: {exc}")
        self._diag("TM822",
                   f"family {family}: repeated resource exhaustion at "
                   f"{rows_from} rows; retrying at the next-smaller row "
                   f"bucket ({cap} rows — metrics computed on the capped "
                   "block)")

    def note_fail_fast(self, point: str, exc: BaseException) -> None:
        # the same exception propagates through every enclosing retry
        # wrapper (device_sync -> sweep -> stage_fit); report it ONCE, at
        # the innermost point, not once per nesting level
        if getattr(exc, "_tmog_fail_fast_noted", False):
            return
        try:
            exc._tmog_fail_fast_noted = True
        except AttributeError:  # pragma: no cover — __slots__ exceptions
            pass
        self._diag("TM823",
                   f"non-retryable training error at {point!r} "
                   f"({type(exc).__name__}: {exc}); failing fast — the "
                   "sweep journal keeps every completed block for resume")


#: the active-context stack (process-global, as the fault harness is).
#: Reassigned whole under the lock; readers take one atomic snapshot.
_STACK: Tuple[TrainResilience, ...] = ()
_STACK_LOCK = threading.Lock()
#: the most recently POPPED context — its counters (journal hits/misses,
#: retries, degradations) survive the fit for tests and callers to report
_LAST: Optional[TrainResilience] = None


@contextmanager
def resilient_training(journal: Optional[SweepJournal] = None,
                       policy: Optional[RetryPolicy] = None,
                       chunk_checkpoint=None, seed: int = 0,
                       bucket_ladder: bool = True):
    """Activate a :class:`TrainResilience` for the dynamic extent of a fit.

    Nestable (a continual refit inside a resumable train pushes its own
    frame); the innermost frame wins, and frames pop in LIFO order even
    when the fit raises."""
    global _STACK
    res = TrainResilience(journal=journal, policy=policy,
                          chunk_checkpoint=chunk_checkpoint, seed=seed,
                          bucket_ladder=bucket_ladder)
    with _STACK_LOCK:
        _STACK = _STACK + (res,)
    try:
        yield res
    finally:
        global _LAST
        with _STACK_LOCK:
            _STACK = tuple(r for r in _STACK if r is not res)
            _LAST = res


def active() -> Optional[TrainResilience]:
    """The innermost active resilience context, or None (plain training)."""
    stack = _STACK
    return stack[-1] if stack else None


def last() -> Optional[TrainResilience]:
    """The most recently deactivated context (``Workflow.train(resume=...)``
    pops its frame before returning, so journal counters are read here)."""
    return _LAST


def active_journal() -> Optional[SweepJournal]:
    res = active()
    return res.journal if res is not None else None


def active_chunk_checkpoint():
    """The chunked-epoch OffsetCheckpoint of the active context (None when
    inactive): ``workflow/ooc.py``'s default when the caller passes none."""
    res = active()
    return res.chunk_checkpoint if res is not None else None


# ---------------------------------------------------------------------------
# Retry engines
# ---------------------------------------------------------------------------

def retry_call(fn: Callable[[], Any], point: str, **ctx) -> Any:
    """Bounded in-place retry (no ladder) around ``fn`` — the wrapper for
    stage fits, the device sync, chunk reads and one chunk of an epoch.  A plain passthrough with no active
    context; non-retryable errors always propagate immediately."""
    res = active()
    if res is None:
        return fn()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            if not is_retryable_training(e):
                res.note_fail_fast(point, e)
                raise
            attempt += 1
            if attempt > res.policy.max_retries:
                raise
            d = res.policy.delay(attempt, res.rng)
            res.note_retry(point, attempt, d, e, **ctx)
            res.policy.sleep(d)


def _next_row_cap(rows: int) -> Optional[int]:
    """The next-smaller power-of-two row bucket below ``rows`` (None when
    already at the 128-row floor)."""
    cap = (1 << max(int(rows) - 1, 0).bit_length()) // 2
    while cap >= rows:
        cap //= 2
    return cap if cap >= 128 else None


def run_sweep_block(attempt_fn: Callable[[Optional[int], int], Any],
                    family: str, rows: int,
                    res: Optional[TrainResilience] = None,
                    pending_error: Optional[BaseException] = None) -> Any:
    """Run one sweep block under the retry + bucket ladder.

    ``attempt_fn(row_cap, attempt)`` re-launches the block (on the first
    ``row_cap`` rows when set) and returns the gathered score matrix.
    Ladder order per failure: OOM-flavored retryable errors shrink the row
    bucket immediately (retrying the same shape cannot help); other
    retryable errors retry in place ``max_retries`` times and then raise
    (the mesh rung is not ported); non-retryable errors fail fast.
    ``pending_error`` seeds the loop with a failure the caller already
    observed (the gather-phase wrapper enters here mid-flight)."""
    res = res if res is not None else active()
    if res is None:
        return attempt_fn(None, 0)
    row_cap: Optional[int] = None
    attempt_total = 0
    rung_attempts = 0
    err: Optional[BaseException] = pending_error
    while True:
        if err is not None:
            e, err = err, None
            if not is_retryable_training(e):
                res.note_fail_fast(f"sweep:{family}", e)
                raise e
            attempt_total += 1
            rung_attempts += 1
            if res.bucket_ladder and is_oom(e):
                cur = row_cap if row_cap is not None else rows
                cap = _next_row_cap(cur)
                if cap is not None:
                    res.note_degrade_bucket(family, cur, cap, e)
                    row_cap, rung_attempts = cap, 0
                    continue
            if rung_attempts > res.policy.max_retries:
                raise e
            d = res.policy.delay(rung_attempts, res.rng)
            res.note_retry(f"sweep:{family}", rung_attempts, d, e)
            res.policy.sleep(d)
        try:
            return attempt_fn(row_cap, attempt_total)
        except Exception as e:  # noqa: BLE001 — classified at loop head
            err = e


def capped_views(row_cap: Optional[int], x, y, train_w, val_w):
    """Deterministic row-capped views for the bucket ladder: the first
    ``row_cap`` rows of the block and the matching fold-weight columns
    (no-op when uncapped)."""
    if row_cap is None or row_cap >= len(y):
        return x, y, train_w, val_w
    return (x[:row_cap], y[:row_cap],
            train_w[:, :row_cap], val_w[:, :row_cap])
