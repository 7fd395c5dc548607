from .chunked import (ChunkedDataset, ChunkedDatasetWriter, ChunkStore,
                      host_budget, maybe_chunk)
from .dataset import Column, Dataset

__all__ = ["Column", "Dataset", "ChunkStore", "ChunkedDataset",
           "ChunkedDatasetWriter", "host_budget", "maybe_chunk"]
