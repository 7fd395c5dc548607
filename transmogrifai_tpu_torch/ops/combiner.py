"""VectorsCombiner: concatenate OPVector blocks + union of their metadata
(counterpart of ``transmogrifai_tpu/ops/combiner.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..data.dataset import Column
from ..stages.base import SequenceTransformer
from ..types import OPVector
from ..utils.vector_metadata import VectorColumnMetadata, VectorMetadata


class VectorsCombiner(SequenceTransformer):
    sequence_input_type = OPVector
    output_type = OPVector

    def device_transform(self, *blocks: torch.Tensor) -> torch.Tensor:
        """Column concat; the blocks must share one dtype, as the reference's
        strict ``lax.concatenate`` demands."""
        if len({b.dtype for b in blocks}) > 1:
            raise TypeError(f"VectorsCombiner got mixed dtypes {[b.dtype for b in blocks]}")
        return torch.cat([b if b.dim() == 2 else b.reshape(b.shape[0], 1)
                          for b in blocks], dim=1)

    def transform_columns(self, cols, dataset):
        metas = []
        for f, c in zip(self.inputs, cols):
            if c.meta is not None:
                metas.append(c.meta)
            else:
                metas.append(VectorMetadata(f.name, [
                    VectorColumnMetadata(f.name, f.ftype.__name__, index=i)
                    for i in range(c.width)]))
        meta = VectorMetadata.concat(self.output_name, metas)
        data = np.hstack([c.data for c in cols]).astype(np.float32)
        return Column.vector(data, meta)
