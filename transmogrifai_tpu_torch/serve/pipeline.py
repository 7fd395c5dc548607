"""Double-buffered serving pipeline primitives, the batcher's flush path
(counterpart of ``transmogrifai_tpu/serve/pipeline.py``).

While batch N's device work and host remainder FINALIZE on a dedicated
thread, the flusher thread ENCODES batch N+1 on the host and starts its
device work (asynchronous on the card: the copies, the encode launch and the
prefix's ops queue on the plan's stream), so the host encode of one batch
overlaps the device work and host remainder of the one before.

Pieces:

- :func:`pipeline_depth` — the ``TMOG_SERVE_PIPELINE_DEPTH`` knob (default
  2 = classic double buffering; ``0`` disables pipelining entirely and the
  batcher runs the lockstep loop).
- :class:`InflightRing` — the bounded in-flight window between the
  flusher (producer: claim + encode + dispatch) and the finalizer
  (consumer: device sync + host remainder + future routing).  A batch
  counts in flight from ``put`` until the consumer's ``task_done``, so
  ``depth`` bounds staged AND finalizing batches together; a full window
  blocks the producer, which backs pressure up into the submit queue's
  existing shed/reject machinery.  One condition variable guards every
  field.

Overlap accounting rides :class:`~..obs.overlap.OverlapStats`.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Optional

#: a consumer wait on an EMPTY ring longer than this counts a pipeline
#: stall (sub-ms waits are hand-off noise, not starvation)
STALL_THRESHOLD_S = 0.001


def pipeline_depth() -> int:
    """In-flight window of the pipelined flush path
    (``TMOG_SERVE_PIPELINE_DEPTH``).  2 (default) is the double buffer:
    one batch finalizing, one staged behind it.  ``0`` = lockstep — the
    flusher scores each batch start-to-finish before taking the next,
    exactly the pre-pipeline behavior."""
    try:
        return max(0, int(os.environ.get("TMOG_SERVE_PIPELINE_DEPTH", "2")))
    except ValueError:
        return 2


class InflightRing:
    """Bounded hand-off ring between the flusher and the finalizer.

    ``put`` blocks while ``depth`` batches are in flight (queued or being
    finalized); ``get`` blocks until an item or close; ``task_done``
    retires one in-flight slot.  ``drain`` waits for the window to empty —
    the swap/rollback paths call it so a model mutation never races an
    in-flight batch's finalize.  Items leave in FIFO order, so batches
    finalize in flush order and per-request latency accounting stays
    monotone."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError("InflightRing depth must be >= 1")
        self.depth = int(depth)
        self._cv = threading.Condition()
        self._items: "deque[Any]" = deque()
        self._inflight = 0
        self._closed = False

    def put(self, item: Any) -> None:
        """Stage one batch; blocks while the window is full (backpressure
        into the submit queue).  Allowed after close — shutdown's drain
        stages its final batches before the finalizer sees the sentinel."""
        with self._cv:
            while self._inflight >= self.depth:
                self._cv.wait()
            self._items.append(item)
            self._inflight += 1
            self._cv.notify_all()

    def get(self) -> Optional[Any]:
        """Next staged batch, or None once closed and empty."""
        with self._cv:
            while not self._items and not self._closed:
                self._cv.wait()
            if not self._items:
                return None
            return self._items.popleft()

    def task_done(self) -> None:
        """Retire one in-flight slot (consumer, after finalize)."""
        with self._cv:
            self._inflight -= 1
            self._cv.notify_all()

    def close(self) -> None:
        """No more puts will come; wake the consumer to exit after the
        backlog drains."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def empty(self) -> bool:
        """Racy emptiness peek (stall detection only)."""
        with self._cv:
            return not self._items

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until no batch is in flight; False on timeout."""
        with self._cv:
            return self._cv.wait_for(lambda: self._inflight == 0,
                                     timeout=timeout)

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight
