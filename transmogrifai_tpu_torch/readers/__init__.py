"""Readers: records and files into columnar datasets of raw features
(counterpart of ``transmogrifai_tpu/readers/``), and the chunk prefetcher of
the out-of-core path (``readers/prefetch.py``)."""

from .prefetch import ChunkPrefetcher, PrefetchStats, prefetch_chunks
from .streaming import (JsonlTailSource, ListSource,
                        MicroBatchStreamingReader, OffsetCheckpoint,
                        RecordSource)

__all__ = ["RecordSource", "ListSource", "JsonlTailSource",
           "OffsetCheckpoint", "MicroBatchStreamingReader",
           "ChunkPrefetcher", "PrefetchStats", "prefetch_chunks"]
