"""Readers: records and files into columnar datasets of raw features
(counterpart of ``transmogrifai_tpu/readers/``; the chunk prefetcher waits
for the chunked store, ``data/chunked.py``)."""

from .streaming import (JsonlTailSource, ListSource,
                        MicroBatchStreamingReader, OffsetCheckpoint,
                        RecordSource)

__all__ = ["RecordSource", "ListSource", "JsonlTailSource",
           "OffsetCheckpoint", "MicroBatchStreamingReader"]
