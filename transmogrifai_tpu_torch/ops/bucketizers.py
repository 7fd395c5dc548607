"""Decision-tree numeric bucketizer (counterpart of
``transmogrifai_tpu/ops/bucketizers.py``).

The fit (:func:`find_tree_splits`) grows a single-feature classification
tree over quantile bins of the value, on the host in float64 numpy exactly
as the reference does, so the splits come out equal.  A fitted ``DecisionTreeNumericBucketizerModel`` one-hot encodes a value into
the right-inclusive intervals ``(s[i], s[i+1]]`` of its tree's splits, with
optional invalid and null columns.  When the tree found no split
(``should_split`` false) only the null indicator remains.  With splits the
device half is a bucketize slot of the encode kernel
(``perf/kernels/encode.py``, K5's slots); without, it stays a torch op (the
reference computes that branch outside its Pallas kernel too).
``DecisionTreeNumericMapBucketizer`` grows one such tree per key of a numeric
map: a host stage, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Column
from ..perf.kernels import encode as KE
from ..stages.base import BinaryEstimator, Param, Transformer
from ..types import OPMap, OPNumeric, OPVector, RealNN
from ..utils.vector_metadata import NULL_INDICATOR, VectorColumnMetadata, VectorMetadata

IMPURITIES = ("gini", "entropy")


def _impurity(counts: np.ndarray, kind: str) -> np.ndarray:
    """Impurity of class-count vectors along the last axis."""
    n = counts.sum(axis=-1, keepdims=True)
    p = counts / np.maximum(n, 1.0)
    if kind == "entropy":
        logp = np.log2(p, where=p > 0, out=np.zeros_like(p))
        return -(p * logp).sum(axis=-1)
    return 1.0 - (p * p).sum(axis=-1)


def find_tree_splits(
    values: np.ndarray,
    labels: np.ndarray,
    impurity: str = "gini",
    max_depth: int = 5,
    max_bins: int = 32,
    min_instances_per_node: int = 1,
    min_info_gain: float = 0.01,
) -> List[float]:
    """Split thresholds of a single-feature decision tree (predicate ``v <= t``),
    from class-count histograms over quantile bins (the reference's
    DecisionTreeNumericBucketizer fit, step for step)."""
    v = np.asarray(values, dtype=np.float64)
    y = np.asarray(labels)
    keep = ~np.isnan(v) & ~np.isnan(y.astype(np.float64))
    v, y = v[keep], y[keep]
    if v.size == 0:
        return []
    classes, y_idx = np.unique(y, return_inverse=True)
    if classes.size <= 1:
        return []
    uniq = np.unique(v)
    if uniq.size <= 1:
        return []
    if uniq.size > max_bins:
        cand = np.unique(np.quantile(v, np.linspace(0.0, 1.0, max_bins + 1)[1:-1]))
        cand = cand[cand < uniq[-1]]  # a threshold at the max splits nothing
    else:
        cand = uniq[:-1]
    if cand.size == 0:
        return []

    # class counts per candidate interval: interval i holds rows with
    # cand[i-1] < v <= cand[i] (last interval: v > cand[-1])
    idx = np.searchsorted(cand, v, side="left")
    counts = np.zeros((cand.size + 1, classes.size), dtype=np.float64)
    np.add.at(counts, (idx, y_idx), 1.0)
    csum = counts.cumsum(axis=0)

    thresholds: List[float] = []
    # node = inclusive interval-index range [lo, hi]; depth-first recursion
    stack: List[Tuple[int, int, int]] = [(0, cand.size, 0)]
    while stack:
        lo, hi, depth = stack.pop()
        if depth >= max_depth or lo >= hi:
            continue
        base = csum[lo - 1] if lo > 0 else np.zeros(classes.size)
        node_counts = csum[hi] - base
        n_node = node_counts.sum()
        if n_node < 2 * min_instances_per_node:
            continue
        left = csum[lo:hi] - base  # split at cand[i], i in [lo, hi)
        right = node_counts - left
        nl, nr = left.sum(axis=-1), right.sum(axis=-1)
        parent_imp = _impurity(node_counts, impurity)
        child_imp = (nl * _impurity(left, impurity) + nr * _impurity(right, impurity)) / n_node
        gain = parent_imp - child_imp
        gain[(nl < min_instances_per_node) | (nr < min_instances_per_node)] = -np.inf
        best = int(np.argmax(gain))
        if gain[best] < min_info_gain or not np.isfinite(gain[best]):
            continue
        split_i = lo + best
        thresholds.append(float(cand[split_i]))
        stack.append((lo, split_i, depth + 1))
        stack.append((split_i + 1, hi, depth + 1))
    return sorted(thresholds)


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


def _bucket_labels(splits: np.ndarray) -> List[str]:
    return [f"{splits[i]}-{splits[i + 1]}" for i in range(len(splits) - 1)]


def _null_only_block(present: np.ndarray, track_nulls: bool) -> np.ndarray:
    """The no-split branch: a width-1 null indicator (or no column)."""
    if not track_nulls:
        return np.zeros((len(present), 0), dtype=np.float32)
    return (~present).astype(np.float32)[:, None]


class DecisionTreeNumericBucketizer(BinaryEstimator):
    """Smart numeric bucketizer driven by a label-aware single-feature tree:
    (label RealNN, value) -> the value's one-hot over the tree's intervals."""

    input_types = (RealNN, OPNumeric)
    output_type = OPVector
    allow_label_as_input = True

    impurity = Param(default="gini", validator=lambda v: v in IMPURITIES)
    max_depth = Param(default=5)
    max_bins = Param(default=32)
    min_instances_per_node = Param(default=1)
    min_info_gain = Param(default=0.01)
    track_nulls = Param(default=True)
    track_invalid = Param(default=False)

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

    def fit_columns(self, cols, dataset, device):
        y = cols[0].values_f64()
        v = cols[1].values_f64()
        splits = find_tree_splits(
            v, y, impurity=self.impurity, max_depth=self.max_depth,
            max_bins=self.max_bins, min_instances_per_node=self.min_instances_per_node,
            min_info_gain=self.min_info_gain,
        )
        should_split = len(splits) >= 1
        final = [-np.inf, *splits, np.inf] if should_split else []
        return DecisionTreeNumericBucketizerModel(
            should_split=should_split, splits=final,
            track_nulls=self.track_nulls, track_invalid=self.track_invalid,
        )


class DecisionTreeNumericBucketizerModel(Transformer):
    input_types = (RealNN, OPNumeric)
    output_type = OPVector
    allow_label_as_input = True

    def __init__(self, should_split: bool, splits: Sequence[float],
                 track_nulls: bool = True, track_invalid: bool = False, **kw):
        super().__init__(**kw)
        self.should_split = bool(should_split)
        self.splits = list(splits)
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

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
        # a bf16 ``x`` (a reduced serving class) reaches the kernel as its
        # float32 widening, as the reference's K5 widens it
        return KE.encode_slots([x.to(torch.float32)],
                               KE.slot_table(self.device_slot_specs()))

    def transform(self, dataset):
        col = dataset[self.inputs[1].name]
        out = self.transform_columns([None, col], dataset)
        return dataset.with_column(self.output_name, out)

    def _meta_cols(self, f) -> List[VectorColumnMetadata]:
        cols: List[VectorColumnMetadata] = []
        if self.should_split:
            for lab in _bucket_labels(np.asarray(self.splits)):
                cols.append(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=f.name, indicator_value=lab))
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
        else:
            block = _null_only_block(present, self.track_nulls)
        meta = VectorMetadata(self.output_name, self._meta_cols(f),
                              {f.name: f.history().to_dict()}).reindexed()
        return Column.vector(block, meta)


class DecisionTreeNumericMapBucketizer(BinaryEstimator):
    """Per-key smart bucketizer for numeric maps (DecisionTreeNumericMapBucketizer.scala)."""

    input_types = (RealNN, OPMap)
    output_type = OPVector
    allow_label_as_input = True

    impurity = Param(default="gini", validator=lambda v: v in IMPURITIES)
    max_depth = Param(default=5)
    max_bins = Param(default=32)
    min_instances_per_node = Param(default=1)
    min_info_gain = Param(default=0.01)
    track_nulls = Param(default=True)
    track_invalid = Param(default=False)

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

    def fit_columns(self, cols, dataset, device):
        y = cols[0].values_f64()
        maps = cols[1].data
        n = len(maps)
        keys = sorted({k for m in maps for k in (m or {})})
        per_key_splits: Dict[str, List[float]] = {}
        for k in keys:
            v = np.full(n, np.nan)
            for i, m in enumerate(maps):
                if m and k in m:
                    v[i] = float(m[k])
            splits = find_tree_splits(
                v, y, impurity=self.impurity, max_depth=self.max_depth,
                max_bins=self.max_bins,
                min_instances_per_node=self.min_instances_per_node,
                min_info_gain=self.min_info_gain,
            )
            per_key_splits[k] = [-np.inf, *splits, np.inf] if splits else []
        return DecisionTreeNumericMapBucketizerModel(
            keys=keys, splits=per_key_splits,
            track_nulls=self.track_nulls, track_invalid=self.track_invalid,
        )


class DecisionTreeNumericMapBucketizerModel(Transformer):
    input_types = (RealNN, OPMap)
    output_type = OPVector
    allow_label_as_input = True

    def __init__(self, keys: List[str], splits: Dict[str, List[float]],
                 track_nulls: bool = True, track_invalid: bool = False, **kw):
        super().__init__(**kw)
        self.keys = list(keys)
        self.splits = {k: list(v) for k, v in splits.items()}
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

    def transform_columns(self, cols, dataset):
        f = self.inputs[1]
        maps = cols[1].data
        n = len(maps)
        blocks: List[np.ndarray] = []
        meta_cols: List[VectorColumnMetadata] = []
        for k in self.keys:
            v = np.full(n, np.nan)
            present = np.zeros(n, dtype=np.bool_)
            for i, m in enumerate(maps):
                if m and k in m:
                    v[i] = float(m[k])
                    present[i] = True
            splits = self.splits.get(k) or []
            if splits:
                sarr = np.asarray(splits)
                blocks.append(bucketize_right(v, present, sarr,
                                              self.track_nulls, self.track_invalid))
                for lab in _bucket_labels(sarr):
                    meta_cols.append(VectorColumnMetadata(
                        f.name, f.ftype.__name__, grouping=k, indicator_value=lab))
                if self.track_invalid:
                    meta_cols.append(VectorColumnMetadata(
                        f.name, f.ftype.__name__, grouping=k,
                        indicator_value="OutOfBounds"))
            else:
                blocks.append(_null_only_block(present, self.track_nulls))
            if self.track_nulls:
                meta_cols.append(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=k,
                    indicator_value=NULL_INDICATOR))
        block = np.hstack(blocks) if blocks else np.zeros((n, 0), np.float32)
        meta = VectorMetadata(self.output_name, meta_cols,
                              {f.name: f.history().to_dict()}).reindexed()
        return Column.vector(block, meta)
