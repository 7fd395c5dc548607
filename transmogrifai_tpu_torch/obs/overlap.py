"""Producer/consumer overlap accounting (counterpart of
``transmogrifai_tpu/obs/overlap.py``), read by the pipelined serving flush
loop (``serve/batcher.py``):

- ``load_seconds``  — total producer time spent staging work (the flusher's
  host encode and device dispatch),
- ``wait_seconds``  — total consumer time blocked on the hand-off buffer
  (the finalizer waiting for the next begun batch),
- ``overlap_fraction`` — the share of producer time hidden behind the
  consumer's own work (``1 - wait/load``).

Two threads read-modify-write these fields and the ratio reads two of them
together, so every update and every report takes the one lock.
"""

from __future__ import annotations

import threading


class OverlapStats:
    """Lock-disciplined counters of one producer/consumer pipeline run.
    ``chunks`` counts consumer hand-offs (serve: batches)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.chunks = 0
        self.load_seconds = 0.0
        self.wait_seconds = 0.0
        self.stalls = 0

    def add_load(self, seconds: float) -> None:
        """Producer side: one item's staging time."""
        with self._lock:
            self.load_seconds += seconds

    def add_wait(self, seconds: float, stalled: bool = False) -> None:
        """Consumer side: one hand-off's buffer wait (+ stall count)."""
        with self._lock:
            self.wait_seconds += seconds
            if stalled:
                self.stalls += 1

    def add_chunk(self) -> None:
        with self._lock:
            self.chunks += 1

    def _overlap_locked(self) -> float:
        if self.load_seconds <= 0.0:
            return 1.0
        return max(0.0, min(1.0, 1.0 - self.wait_seconds / self.load_seconds))

    @property
    def overlap_fraction(self) -> float:
        """1.0 = every item was already staged when asked for; 0.0 = the
        consumer waited out every load (no overlap)."""
        with self._lock:
            return self._overlap_locked()

    def to_dict(self) -> dict:
        with self._lock:
            return {"chunks": self.chunks,
                    "load_seconds": round(self.load_seconds, 4),
                    "wait_seconds": round(self.wait_seconds, 4),
                    "stalls": self.stalls,
                    "overlap_fraction": round(self._overlap_locked(), 4)}
