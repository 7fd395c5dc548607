"""Double-buffered chunk prefetch: overlap ingest with compute (counterpart
of ``transmogrifai_tpu/readers/prefetch.py``, copied).

A background worker reads and decodes chunk ``N+1`` (the disk read and any
host encoding the loader does) while the consumer is busy with chunk ``N``
(the device prefix of the training plan, the spill of its outputs).

One worker thread, one bounded queue whose depth is the double buffer
(``TMOG_PREFETCH_DEPTH``, default 2 slots: one chunk in flight to the
consumer, one being staged).  :class:`PrefetchStats` records, per run,

- ``load_seconds``  — total worker time spent producing chunks,
- ``wait_seconds``  — total consumer time blocked on the queue,
- ``overlap_fraction`` — the share of ingest time hidden behind compute
  (``1 - wait/load``).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

from ..obs import flight as obs_flight
from ..obs.overlap import OverlapStats

_SENTINEL = object()

#: a consumer wait on an EMPTY buffer longer than this records a
#: ``prefetch_stall`` flight event (sub-ms waits are queue-handoff noise,
#: not pipeline starvation)
_STALL_THRESHOLD_S = 0.001


def prefetch_depth() -> int:
    """Queue depth of the chunk pipeline (``TMOG_PREFETCH_DEPTH``, min 1).
    Depth 2 is the double buffer; deeper only helps with very jittery
    per-chunk load times, at proportional host-buffer cost."""
    try:
        return max(1, int(os.environ.get("TMOG_PREFETCH_DEPTH", "2")))
    except ValueError:
        return 2


class PrefetchStats(OverlapStats):
    """Counters of one prefetched iteration.

    The accumulator is :class:`~..obs.overlap.OverlapStats` (the serving
    pipeline reports the same metric through the same class): the worker
    thread adds ``load_seconds`` while the consumer adds ``wait_seconds``,
    ``stalls`` and ``chunks``, and ``to_dict`` / ``overlap_fraction`` may
    be read mid-run, so every update and report takes its lock."""


class ChunkPrefetcher:
    """Iterate ``loader(i)`` for ``i in [start, n)`` with a background
    worker staying ``depth`` chunks ahead.

    The loader runs entirely on the worker thread (disk decode + host
    encode); the consumer's ``__next__`` only blocks when the buffer is
    empty.  A loader exception is re-raised in the consumer at the failed
    chunk's position, after which the pipeline is closed.  ``close()`` stops
    the worker early (safe to call twice; the context manager calls it)."""

    def __init__(self, loader: Callable[[int], Any], n_chunks: int,
                 start: int = 0, depth: Optional[int] = None,
                 stats: Optional[PrefetchStats] = None):
        self._loader = loader
        self._n = int(n_chunks)
        self._start = int(start)
        self.stats = stats or PrefetchStats()
        self._q: "queue.Queue" = queue.Queue(maxsize=depth or prefetch_depth())
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tmog-chunk-prefetch")
        self._worker.start()

    def _run(self) -> None:
        try:
            for ci in range(self._start, self._n):
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                try:
                    item = self._loader(ci)
                except BaseException as e:  # noqa: BLE001 — ship to consumer
                    self._put((ci, _SENTINEL, e))
                    return
                self.stats.add_load(time.perf_counter() - t0)
                self._put((ci, item, None))
        finally:
            self._put((self._n, _SENTINEL, None))

    def _put(self, item) -> None:
        # bounded put that gives up when the consumer closed the pipeline
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        empty = self._q.empty()
        t0 = time.perf_counter()
        ci, item, err = self._q.get()
        wait = time.perf_counter() - t0
        # the device side outran the ingest side: record the starvation.
        # Error/end-of-stream rows are excluded — a wait for the
        # sentinel is not a stall on any real chunk.
        stalled = empty and wait > _STALL_THRESHOLD_S and err is None \
            and item is not _SENTINEL
        self.stats.add_wait(wait, stalled=stalled)
        if stalled:
            obs_flight.record_event("prefetch_stall", chunk=int(ci),
                                    wait_s=round(wait, 4))
        if err is not None:
            self.close()
            raise err
        if item is _SENTINEL:
            self.close()
            raise StopIteration
        self.stats.add_chunk()
        return ci, item

    def close(self) -> None:
        self._stop.set()
        # drain so a blocked worker put() can observe the stop promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "ChunkPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_chunks(chunked, names=None, start: int = 0,
                    stats: Optional[PrefetchStats] = None,
                    loader: Optional[Callable[[int], Any]] = None
                    ) -> ChunkPrefetcher:
    """Prefetched ``(chunk index, chunk Dataset)`` iteration over a
    :class:`~..data.chunked.ChunkedDataset` — the ingestion half of the
    chunked epoch (workflow/ooc.py).  ``loader`` overrides the per-chunk
    producer (e.g. to fold host entry-encoding into the background stage)."""
    if loader is None:
        def loader(ci, _c=chunked, _names=names):
            # lazy imports: the loader runs on the prefetch worker thread and
            # the resilience stack is process-global precisely so this wrapper
            # can reach it from here; a transient read fault retries with
            # backoff instead of killing the whole epoch
            from ..serve.faults import fault_point
            from ..workflow.resilience import retry_call

            def _read():
                fault_point("prefetch", chunk=ci)
                return _c.chunk(ci, names=_names)

            return retry_call(_read, "prefetch", chunk=ci)
    return ChunkPrefetcher(loader, chunked.n_chunks, start=start, stats=stats)
