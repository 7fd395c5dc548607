"""Micro-batch streaming with offsets, checkpointed resume and backpressure
(counterpart of ``transmogrifai_tpu/readers/streaming.py``, host code
copied).

Reference: StreamingReaders ride Spark DStreams
(readers/src/main/scala/com/salesforce/op/readers/StreamingReaders.scala:1-67):
a micro-batch clock, source offsets checkpointed by the streaming context,
and PID-rate backpressure.  Batches stay columnar host datasets (strings
never reach the device); each one is scored by the caller, on the card
through ``WorkflowModel.score`` in the runner's ``STREAMING_SCORE`` run.

Pieces:
- ``RecordSource``: offset-addressable pull source (``seek``/``poll``).
  ``JsonlTailSource`` tails a JSON-lines file by BYTE offset (resume lands
  mid-file exactly); ``ListSource`` is the in-memory test double.
- ``OffsetCheckpoint``: atomic (tmp+rename) JSON offset store.
- ``MicroBatchStreamingReader``: the DStream role.  Yields one dataset per
  tick; ``commit()`` AFTER the consumer persists its output gives
  at-least-once delivery (an uncommitted batch is re-polled after a crash,
  exactly Spark's WAL-less receiverless semantics).  Backpressure is a
  rate estimator: the per-batch record target shrinks when processing
  time exceeds the batch interval and recovers geometrically otherwise
  (the PID-estimator role, proportional term only).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

from .base import rows_to_dataset

log = logging.getLogger(__name__)


class RecordSource:
    """Offset-addressable record source."""

    #: stable id inside a checkpoint file (override per source)
    source_id: str = "source"

    def seek(self, offset: int) -> None:
        raise NotImplementedError

    def poll(self, max_records: int) -> Tuple[List[Any], int]:
        """Up to ``max_records`` new records and the offset AFTER them."""
        raise NotImplementedError


class ListSource(RecordSource):
    """In-memory source; offset = index into the list (tests, replays)."""

    def __init__(self, records: Sequence[Any], source_id: str = "list"):
        self.records = list(records)
        self.source_id = source_id
        self._pos = 0

    def seek(self, offset: int) -> None:
        self._pos = min(int(offset), len(self.records))

    def poll(self, max_records: int):
        chunk = self.records[self._pos:self._pos + max_records]
        self._pos += len(chunk)
        return chunk, self._pos

    def append(self, records: Sequence[Any]) -> None:
        self.records.extend(records)


class JsonlTailSource(RecordSource):
    """Tails a JSON-lines file; offset = byte position of the next unread
    line, so a resume lands exactly where the last commit left off even
    mid-file.  A trailing partial line (a writer mid-append) is left for
    the next poll.

    Rotation is detected two ways, BOTH required because a rotated file may
    be longer than the committed offset (size alone would silently skip the
    new file's head): the inode changing (rename-style rotation swaps a new
    file under the path) and the head-prefix changing (copytruncate-style
    rotation rewrites in place).  Either resets the offset to 0.

    ``skip_malformed=True`` advances past (and counts) undecodable lines
    instead of raising — a long-running follow loop must not wedge forever
    on one poison line that sits exactly at the committed offset.  The
    default stays loud (one-shot replays and tests want the error).
    """

    #: bytes of the file head remembered for the rotation heuristic
    _HEAD_PROBE = 64

    def __init__(self, path: str, source_id: Optional[str] = None,
                 skip_malformed: bool = False):
        self.path = path
        self.source_id = source_id or f"jsonl:{os.path.basename(path)}"
        self.skip_malformed = bool(skip_malformed)
        #: undecodable lines skipped-and-counted (skip_malformed mode)
        self.skipped_malformed = 0
        self._offset = 0
        self._ino: Optional[int] = None
        self._head: Optional[bytes] = None

    def seek(self, offset: int) -> None:
        self._offset = int(offset)

    def _rotated(self, fh) -> bool:
        """Same path, different file: inode changed, or the first bytes of
        the file no longer match the remembered head.  The head probe only
        pins bytes the reader has actually consumed (min(head, offset)) —
        a first poll at offset 0 has consumed nothing and pins nothing."""
        ino = os.fstat(fh.fileno()).st_ino
        if self._ino is not None and ino != self._ino:
            self._ino = ino
            self._head = None
            return True
        self._ino = ino
        probe = min(self._HEAD_PROBE, self._offset)
        if probe <= 0 or self._head is None:
            return False
        fh.seek(0)
        head = fh.read(probe)
        common = min(len(head), len(self._head))
        if head[:common] != self._head[:common]:
            self._head = None
            return True
        return False

    def _remember_head(self, fh) -> None:
        """Pin the consumed head bytes for the next poll's rotation check
        (called at poll end, when the offset reflects consumed records)."""
        probe = min(self._HEAD_PROBE, self._offset)
        if probe > (0 if self._head is None else len(self._head)):
            fh.seek(0)
            self._head = fh.read(probe)

    # -- durable rotation pins (ride the offset checkpoint) ------------------
    def checkpoint_state(self) -> dict:
        """Inode + consumed-head pins, persisted BESIDE the committed offset
        by the streaming reader: a rotation that happens while the process
        is down is detected on restart (restored pins vs the live file),
        instead of silently resuming mid-file in the new file."""
        return {"ino": self._ino,
                "head": self._head.hex() if self._head is not None else None}

    def restore_state(self, meta: dict) -> None:
        ino = meta.get("ino")
        head = meta.get("head")
        self._ino = int(ino) if ino is not None else None
        self._head = bytes.fromhex(head) if head else None

    def poll(self, max_records: int):
        records: List[Any] = []
        if not os.path.exists(self.path):
            return records, self._offset
        if os.path.getsize(self.path) < self._offset:
            # truncation / rotation-to-smaller: the committed offset points
            # past the new EOF — restart from the head (tail -F behavior)
            self._offset = 0
            self._head = None
        with open(self.path, "rb") as fh:
            if self._rotated(fh):
                # rotation to a file LONGER than the committed offset: the
                # size check above cannot see it, and resuming mid-file
                # would silently skip the new file's head records
                self._offset = 0
            fh.seek(self._offset)
            for _ in range(max_records):
                line = fh.readline()
                if not line or not line.endswith(b"\n"):
                    break  # EOF or partial trailing line: retry next tick
                text = line.decode("utf-8").strip()
                if text:
                    # decode BEFORE advancing: a malformed line must not
                    # strand the records before it past the offset
                    try:
                        parsed = json.loads(text)
                    except ValueError:
                        if records:
                            break  # deliver the good prefix first
                        if self.skip_malformed:
                            # advance past the poison line so a follow loop
                            # cannot wedge at the committed offset forever
                            self.skipped_malformed += 1
                            log.warning(
                                "skipping malformed JSONL at byte %d of "
                                "%s: %r", self._offset, self.path, text[:80])
                            self._offset = fh.tell()
                            continue
                        raise ValueError(
                            f"malformed JSONL at byte {self._offset} of "
                            f"{self.path}: {text[:80]!r}")
                    records.append(parsed)
                self._offset = fh.tell()
            self._remember_head(fh)
        return records, self._offset


class OffsetCheckpoint:
    """Atomic JSON offset store (the streaming-context checkpoint role)."""

    def __init__(self, path: str):
        self.path = path

    def _read_state(self) -> dict:
        """The committed store, or {} — a zero-byte file (crash between
        create and first commit), torn/non-JSON bytes, or valid JSON that is
        not a dict all read as "no checkpoint", never an exception."""
        try:
            with open(self.path) as fh:
                state = json.load(fh)
        except (OSError, ValueError):
            return {}
        return state if isinstance(state, dict) else {}

    def load(self, source_id: str, default: int = 0) -> int:
        # a stale .tmp is a commit that crashed BEFORE its atomic rename —
        # its content never became the committed state; drop it so it can
        # neither be mistaken for the store nor accumulate
        try:
            os.remove(self.path + ".tmp")
        except OSError:
            pass
        try:
            return int(self._read_state().get(source_id, default))
        except (TypeError, ValueError):
            return default

    def load_meta(self, source_id: str) -> Optional[dict]:
        """Source-specific state committed beside the offset (e.g. the tail
        source's rotation pins); None when absent or unreadable."""
        meta = self._read_state().get(source_id + "#meta")
        return dict(meta) if isinstance(meta, dict) else None

    def commit(self, source_id: str, offset: int,
               meta: Optional[dict] = None) -> None:
        state = self._read_state()
        state[source_id] = int(offset)
        if meta is not None:
            state[source_id + "#meta"] = meta
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(state, fh)
            # fsync BEFORE the rename: os.replace makes the tmp file the
            # store atomically, but without the flush+fsync a crash right
            # after could leave the rename durable while the DATA is not —
            # an empty/torn offset file where a valid one used to be
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)  # atomic on POSIX


class MicroBatchStreamingReader:
    """DStream-role reader: micro-batch clock + offsets + backpressure.

    Drop-in for the runner's ``streaming_reader`` slot — ``stream_datasets``
    yields one Dataset per tick; the runner calls ``commit()`` after each
    batch's output is written (at-least-once).  Without a checkpoint the
    reader still rate-limits but restarts from offset 0.
    """

    def __init__(self, source: RecordSource,
                 checkpoint: Optional[OffsetCheckpoint] = None,
                 batch_interval: float = 1.0,
                 max_batch_records: int = 8192,
                 min_batch_records: int = 32,
                 max_empty_polls: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        """``max_empty_polls=None`` (default) tails FOREVER — a quiet
        producer never ends a live stream.  Bounded runs (drain-a-backlog
        jobs, tests) pass a small count to stop after that many
        consecutive empty ticks."""
        self.source = source
        self.checkpoint = checkpoint
        self.batch_interval = float(batch_interval)
        self.max_batch_records = int(max_batch_records)
        # the floor can never exceed the ceiling (otherwise the shrink
        # branch would GROW the target past max on tiny configurations)
        self.min_batch_records = min(int(min_batch_records),
                                     self.max_batch_records)
        self.max_empty_polls = (None if max_empty_polls is None
                                else int(max_empty_polls))
        self._clock = clock
        self._sleep = sleep
        self._target = self.max_batch_records
        self._pending_offset: Optional[int] = None
        #: raw records of the batch most recently yielded — the continual
        #: control loop (workflow/continual.py) mirrors them through the
        #: record-shaped serving path while the Dataset feeds drift stats
        self.last_records: List[Any] = []
        self._committed = self.checkpoint.load(source.source_id) \
            if self.checkpoint else 0
        if self.checkpoint is not None:
            # restore source-side rotation pins committed beside the offset,
            # so a file rotated while the process was down is detected on
            # the first poll instead of resumed mid-file
            meta = self.checkpoint.load_meta(source.source_id)
            restore = getattr(source, "restore_state", None)
            if meta and callable(restore):
                restore(meta)
        #: batches yielded / records seen / current rate target (metrics)
        self.progress = {"batches": 0, "records": 0,
                         "target_records": self._target}

    # -- offsets -----------------------------------------------------------
    def commit(self) -> None:
        """Persist the offset of the last yielded batch — call AFTER its
        output is durable.  Skipping it replays the batch on restart."""
        if self._pending_offset is None:
            return
        self._committed = self._pending_offset
        if self.checkpoint is not None:
            state_fn = getattr(self.source, "checkpoint_state", None)
            self.checkpoint.commit(
                self.source.source_id, self._committed,
                meta=state_fn() if callable(state_fn) else None)
        self._pending_offset = None

    # -- the micro-batch clock --------------------------------------------
    def stream_datasets(self, raw_features) -> Iterator:
        self.source.seek(self._committed)
        empty = 0
        while True:
            tick_start = self._clock()
            records, next_offset = self.source.poll(self._target)
            if not records:
                empty += 1
                if self.max_empty_polls is not None \
                        and empty > self.max_empty_polls:
                    return  # bounded run: source drained
                self._sleep(self.batch_interval)
                continue
            empty = 0
            # pending offset is staged BEFORE the yield: the generator
            # suspends there, and the consumer calls commit() while we
            # are suspended
            self._pending_offset = next_offset
            self.last_records = list(records)
            # scoring-time batches carry no label (allow_missing_response)
            yield rows_to_dataset(records, raw_features,
                                  allow_missing_response=True)
            self.progress["batches"] += 1
            self.progress["records"] += len(records)
            # backpressure: if the consumer used more than the interval,
            # shrink the next target proportionally; otherwise recover
            elapsed = self._clock() - tick_start
            if elapsed > self.batch_interval:
                ratio = self.batch_interval / max(elapsed, 1e-9)
                self._target = max(self.min_batch_records,
                                   int(self._target * ratio))
            else:
                self._target = min(self.max_batch_records,
                                   max(self._target * 2,
                                       self.min_batch_records))
                self._sleep(max(0.0, self.batch_interval - elapsed))
            self.progress["target_records"] = self._target
