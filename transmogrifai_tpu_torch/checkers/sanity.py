"""SanityChecker, scoring half (counterpart of ``transmogrifai_tpu/checkers/sanity.py``).

The fitted ``SanityCheckerModel`` keeps the feature slots the checker did not
drop.  Its summary and pre-drop metadata load with the model (as plain data)
but play no part in scoring.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..data.dataset import Column
from ..ops._consts import device_const
from ..stages.base import Transformer
from ..utils.vector_metadata import VectorMetadata


class SanityCheckerModel(Transformer):
    """Slices the kept feature slots (DropIndicesByTransformer equivalent)."""

    def __init__(self, kept_indices: List[int], summary=None,
                 meta: Optional[VectorMetadata] = None, **kw):
        super().__init__(**kw)
        self.kept_indices = list(kept_indices)
        self.summary = summary
        self.meta = meta

    #: scoring only reads the feature vector — the label slot is never wired
    device_input_slots = (1,)

    def device_transform(self, vec: torch.Tensor) -> torch.Tensor:
        """Kept-slot gather.  ``index_select`` returns a new C-contiguous
        block: the float64 head's BLAS sums in a layout-dependent order, so
        the block must be laid out as the reference's."""
        idx = device_const(self, "kept", self.kept_indices, np.int64, vec.device)
        return torch.index_select(vec, 1, idx)

    def transform(self, dataset):
        vec = dataset[self.inputs[1].name]
        out = self.transform_columns([None, vec], dataset)
        return dataset.with_column(self.output_name, out)

    def transform_columns(self, cols, dataset):
        vec = cols[1]
        data = np.ascontiguousarray(vec.data[:, self.kept_indices])
        meta = (vec.meta.select(self.kept_indices, self.output_name)
                if vec.meta is not None else None)
        return Column.vector(data, meta)
