"""Hashing vectorizer of text lists (counterpart of
``transmogrifai_tpu/ops/text_lists.py``): the hashing trick over the list's
tokens (murmur3 into ``num_hashes`` buckets, ``native.hash_count_block``),
one hash space per feature or one shared, with null tracking.  Host work,
as in the reference.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..data.dataset import Column
from ..native import hash_count_block
from ..stages.base import Param, SequenceTransformer
from ..types import OPVector, TextList
from ..utils.vector_metadata import NULL_INDICATOR, VectorColumnMetadata, VectorMetadata

NUM_HASHES_DEFAULT = 512


class TextListHashingVectorizer(SequenceTransformer):
    sequence_input_type = TextList
    output_type = OPVector

    num_hashes = Param(default=NUM_HASHES_DEFAULT)
    shared_hash_space = Param(default=False)
    track_nulls = Param(default=True)

    def transform_columns(self, cols: List[Column], dataset):
        n = len(cols[0])
        width = self.num_hashes
        blocks: List[np.ndarray] = []
        meta_cols: List[VectorColumnMetadata] = []
        if self.shared_hash_space:
            block = np.zeros((n, width), dtype=np.float32)
            for col in cols:
                block += hash_count_block(col.data, width)
            blocks.append(block)
            f0 = self.inputs[0]
            meta_cols.extend(VectorColumnMetadata(
                f0.name, f0.ftype.__name__, grouping="shared",
                descriptor_value=f"hash_{b}") for b in range(width))
        else:
            for f, col in zip(self.inputs, cols):
                blocks.append(hash_count_block(col.data, width))
                meta_cols.extend(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=f.name,
                    descriptor_value=f"hash_{b}") for b in range(width))
        if self.track_nulls:
            for f, col in zip(self.inputs, cols):
                nulls = np.array([0.0 if t else 1.0 for t in col.data], dtype=np.float32)
                blocks.append(nulls[:, None])
                meta_cols.append(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=f.name,
                    indicator_value=NULL_INDICATOR))
        meta = VectorMetadata(self.output_name, meta_cols,
                              {f.name: f.history().to_dict() for f in self.inputs}).reindexed()
        return Column.vector(np.hstack(blocks), meta)
