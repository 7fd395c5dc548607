"""Readers: records and files into columnar datasets of raw features
(counterpart of ``transmogrifai_tpu/readers/``; the streaming and prefetch
readers are not ported yet)."""
