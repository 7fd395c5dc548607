"""Decision-tree numeric bucketizer, scoring half (counterpart of
``transmogrifai_tpu/ops/bucketizers.py``).

A fitted ``DecisionTreeNumericBucketizerModel`` one-hot encodes a value into
the right-inclusive intervals ``(s[i], s[i+1]]`` of its tree's splits, with
optional invalid and null columns.  When the tree found no split
(``should_split`` false) only the null indicator remains.  With splits the
device half is a bucketize slot of the encode kernel
(``perf/kernels/encode.py``, K5's slots); without, it stays a torch op (the
reference computes that branch outside its Pallas kernel too).  The fit
stays in the reference until the training slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Column
from ..perf.kernels import encode as KE
from ..stages.base import Transformer
from ..utils.vector_metadata import NULL_INDICATOR, VectorColumnMetadata, VectorMetadata


def bucketize_right(v: np.ndarray, present: np.ndarray, splits: np.ndarray,
                    track_nulls: bool, track_invalid: bool) -> np.ndarray:
    """Host one-hot block for right-inclusive buckets (float64 values)."""
    n = len(v)
    n_buckets = len(splits) - 1
    width = n_buckets + (1 if track_invalid else 0) + (1 if track_nulls else 0)
    block = np.zeros((n, width), dtype=np.float32)
    finite = present & np.isfinite(v)
    idx = np.clip(np.searchsorted(splits, np.nan_to_num(v), side="left") - 1,
                  0, n_buckets - 1)
    in_range = finite & (v > splits[0]) & (v <= splits[-1])
    block[np.arange(n)[in_range], idx[in_range]] = 1.0
    col_at = n_buckets
    if track_invalid:
        block[present & ~in_range, col_at] = 1.0
        col_at += 1
    if track_nulls:
        block[~present, col_at] = 1.0
    return block


class DecisionTreeNumericBucketizerModel(Transformer):

    def __init__(self, should_split: bool, splits: Sequence[float],
                 track_nulls: bool = True, track_invalid: bool = False, **kw):
        super().__init__(**kw)
        self.should_split = bool(should_split)
        self.splits = list(splits)
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    #: scoring only reads the value slot — the label is absent at serve time
    device_input_slots = (1,)

    def device_slot_specs(self) -> Optional[Tuple[KE.SlotSpec, ...]]:
        if not self.should_split:
            return None
        return (KE.bucketize_slot(self.splits, self.track_nulls, self.track_invalid),)

    def device_transform(self, x: torch.Tensor) -> torch.Tensor:
        if not self.should_split:  # the null indicator alone, or no column
            if not self.track_nulls:
                return torch.zeros((x.shape[0], 0), dtype=torch.float32,
                                   device=x.device)
            return torch.isnan(x).to(torch.float32)[:, None]
        return KE.encode_slots([x], KE.slot_table(self.device_slot_specs()))

    def transform(self, dataset):
        col = dataset[self.inputs[1].name]
        out = self.transform_columns([None, col], dataset)
        return dataset.with_column(self.output_name, out)

    def _meta_cols(self, f) -> List[VectorColumnMetadata]:
        cols: List[VectorColumnMetadata] = []
        if self.should_split:
            splits = np.asarray(self.splits)
            for i in range(len(splits) - 1):
                cols.append(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=f.name,
                    indicator_value=f"{splits[i]}-{splits[i + 1]}"))
            if self.track_invalid:
                cols.append(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=f.name,
                    indicator_value="OutOfBounds"))
        if self.track_nulls:
            cols.append(VectorColumnMetadata(
                f.name, f.ftype.__name__, grouping=f.name,
                indicator_value=NULL_INDICATOR))
        return cols

    def transform_columns(self, cols, dataset):
        f = self.inputs[1]
        col = cols[1]
        present = col.present()
        if self.should_split:
            block = bucketize_right(col.values_f64(), present, np.asarray(self.splits),
                                    self.track_nulls, self.track_invalid)
        elif self.track_nulls:
            block = (~present).astype(np.float32)[:, None]
        else:
            block = np.zeros((len(present), 0), dtype=np.float32)
        meta = VectorMetadata(self.output_name, self._meta_cols(f),
                              {f.name: f.history()}).reindexed()
        return Column.vector(block, meta)
