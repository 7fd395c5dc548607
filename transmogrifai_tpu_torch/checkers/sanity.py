"""SanityChecker — automatic feature validation on the device (counterpart of
``transmogrifai_tpu/checkers/sanity.py``).

(label RealNN, features OPVector) -> the feature vector without the slots the
checker drops.  The statistics run as torch ops over the feature block on the
fit's device, in float32 like the reference, with TF32 off
(``models/base.py::full_f32``): the drop decisions compare float32
statistics against their thresholds, so the port must not widen them.

- moments and the label correlation (:func:`_device_stats`), one pass of
  column reductions and one matrix-vector product;
- Spearman: Pearson over average-tie ranks (:func:`_rank_columns`, a sort per
  column and the first and last position of each run of equal values);
- the full (d, d) correlation (:func:`_device_full_corr`), one gram product;
- every categorical group's contingency with the label in one product
  (:func:`_device_contingency`), split per group on the host, where Cramér's
  V and the rule confidences are float64 numpy (``utils/stats.py``).

Under a mesh (``parallel/mesh.py``) a Pearson fit places this rank's rows
only: the moments, the label correlations, the gram product and the
contingencies are row sums over the ``data`` group (min and max its
elementwise extremes), so every rank decides alike.  Past
``max_features_for_full_corr`` columns the full matrix is instead built by
the reference's ring of column shards (``parallel/wide.py``).  Spearman's
ranks need every row and stay on one rank's whole block.

The drop decisions, the summary and the metadata bookkeeping stay on the
host, as in the reference.  The fitted ``SanityCheckerModel`` keeps the
slots the checker did not drop.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.dataset import Column
from ..ops._consts import device_const
from ..parallel import collectives as C
from ..parallel import mesh as PM
from ..stages.base import BinaryEstimator, Param, Transformer
from ..types import OPVector, RealNN
from ..utils import stats as npstats
from ..utils.vector_metadata import VectorMetadata

MAX_LABEL_CATEGORIES = 100  # reference categorical-label heuristic cap


@dataclass
class ColumnStats:
    name: str
    mean: float
    variance: float
    min: float
    max: float
    corr_label: float
    cramers_v: Optional[float] = None
    max_rule_confidence: Optional[float] = None
    support: Optional[float] = None


@dataclass
class SanityCheckerSummary:
    """Everything the checker learned (the reference's fields, so either
    package loads a model the other saved with its summary)."""

    stats: List[ColumnStats] = field(default_factory=list)
    dropped: Dict[str, str] = field(default_factory=dict)  # column name -> reason
    kept_indices: List[int] = field(default_factory=list)
    label_distinct: int = 0
    sample_size: int = 0
    correlation_type: str = "pearson"
    #: (d_corr, d_corr) float32 matrix over the slots in correlation_indices
    correlations_feature: Optional[np.ndarray] = None
    correlation_indices: Optional[List[int]] = None  # slots the matrix covers

    def to_dict(self) -> dict:
        return {
            "dropped": self.dropped,
            "keptIndices": self.kept_indices,
            "labelDistinct": self.label_distinct,
            "sampleSize": self.sample_size,
            "correlationType": self.correlation_type,
            "stats": [vars(s) for s in self.stats],
        }


def _row_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``, a sum over this rank's rows, summed over ``mesh``'s ``data``
    group; ``t`` itself when ``mesh`` is None (the block holds every row)."""
    return t if mesh is None else PM.reduce_rows(t, mesh)


def _device_stats(x: torch.Tensor, y: torch.Tensor, n=None, mesh=None):
    """Per column: mean, variance, min, max and the Pearson correlation
    with ``y``, over the rows of ``x`` (n, d) float32 (population moments).
    With a ``mesh`` ``x`` and ``y`` hold this rank's share of ``n`` rows and
    every row sum crosses its ``data`` group; without one they hold every
    row, whatever mesh is ambient."""
    tot = torch.tensor(float(x.shape[0] if n is None else n), dtype=x.dtype,
                       device=x.device)
    mean = _row_sum(x.sum(dim=0), mesh) / tot
    xc = x - mean
    var = _row_sum((xc * xc).sum(dim=0), mesh) / tot
    xmin, xmax = x.amin(dim=0), x.amax(dim=0)
    if mesh is not None and PM.sharded(mesh):
        group = mesh.group(PM.DATA_AXIS)
        xmin, xmax = C.all_reduce(xmin, group, "min"), C.all_reduce(xmax, group, "max")
    yc = y - _row_sum(y.sum(), mesh) / tot
    cov = _row_sum(xc.T @ yc, mesh) / tot
    sx = torch.sqrt(var)
    sy = torch.sqrt(_row_sum((yc * yc).sum(), mesh) / tot)
    corr = cov / (sx * sy)
    return mean, var, xmin, xmax, corr


def _device_label_corr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of every column of ``x`` with ``y`` (one
    matrix-vector product)."""
    tot = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=x.device)
    xc = x - x.sum(dim=0) / tot
    yc = y - y.sum() / tot
    cov = xc.T @ yc / tot
    sx = torch.sqrt((xc * xc).sum(dim=0) / tot)
    sy = torch.sqrt((yc * yc).sum() / tot)
    return cov / (sx * sy)


#: rows of the centred block widened to float64 at a time (the gram's sum)
_GRAM_CHUNK_ROWS = 1 << 16


def _device_full_corr(x: torch.Tensor, n=None, mesh=None) -> torch.Tensor:
    """(d, d) Pearson correlation of the columns of ``x``: one gram product
    of the centred block, normalised by the outer product of its diagonal's
    square roots, floored at 1e-12.  The reference computes this in one
    product up to ``max_features_for_full_corr`` columns and by a ring of
    column shards across devices past it; both normalise the same way.
    With a ``mesh`` ``x`` holds this rank's share of ``n`` rows and the
    column sums and the gram cross its ``data`` group.  The gram of the float32
    centred block accumulates in float64 and rounds to float32 once: a
    float32 sum over the rows carries its order's rounding (~1e-4 of a
    correlation at 65 536 rows), so this product and the ring's
    (``parallel/wide.py``), whose blocks sum in other orders, agree to that
    one rounding.  The float64 copies are of ``_GRAM_CHUNK_ROWS`` rows at a
    time, so the block's device memory does not triple."""
    rows = float(x.shape[0] if n is None else n)
    tot = torch.tensor(rows, dtype=x.dtype, device=x.device)
    xc = x - _row_sum(x.sum(dim=0), mesh) / tot
    g = torch.zeros((x.shape[1], x.shape[1]), dtype=torch.float64, device=x.device)
    for lo in range(0, xc.shape[0], _GRAM_CHUNK_ROWS):
        blk = xc[lo:lo + _GRAM_CHUNK_ROWS].to(torch.float64)
        g += blk.T @ blk
    c = (_row_sum(g, mesh) / rows).to(x.dtype)
    sd = torch.sqrt(torch.diagonal(c))
    return c / torch.clamp(sd[:, None] * sd[None, :], min=1e-12)


def _rank_columns(x: torch.Tensor) -> torch.Tensor:
    """Average-tie (fractional) ranks of each column, 1-based, float32.

    Sort each column; every run of equal values in sorted order shares the
    mean of its first and last 0-based position, plus 1; the ranks go back
    through the sort's permutation.  Pearson on these ranks is Spearman with
    tie correction (the reference's ``_rank_columns``)."""
    n, d = x.shape
    s, order = torch.sort(x, dim=0)
    pos = torch.arange(n, device=x.device, dtype=torch.int64)[:, None].expand(n, d)
    change = s[1:] != s[:-1]
    ones = torch.ones((1, d), dtype=torch.bool, device=x.device)
    is_first = torch.cat([ones, change], dim=0)
    is_last = torch.cat([change, ones], dim=0)
    start = torch.cummax(torch.where(is_first, pos, 0), dim=0).values
    end = torch.flip(torch.cummin(torch.flip(torch.where(is_last, pos, n), [0]),
                                  dim=0).values, [0])
    avg = (start.to(torch.float32) + end.to(torch.float32)) * 0.5 + 1.0
    return torch.empty_like(avg).scatter_(0, order, avg)


def _device_contingency(g: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """Indicator columns g (n, L) by the label's one-hot (n, C) -> (L, C)
    counts (exact in float32 below 2**24 rows)."""
    return g.T @ y_onehot


#: FeatureType names whose hashing-trick slots (descriptor ``hash_<b>``, no
#: indicator level) are excluded from correlation when requested (reference
#: CorrelationExclusion.HashedText)
_HASHED_TEXT_PARENT_TYPES = frozenset(
    {"Text", "TextArea", "TextList", "TextMap", "TextAreaMap"})


class SanityChecker(BinaryEstimator):
    """Drop low-signal and leaky slots from the feature vector."""

    input_types = (RealNN, OPVector)
    output_type = OPVector
    allow_label_as_input = True

    check_sample = Param(default=1.0, doc="row fraction to sample for stats")
    sample_seed = Param(default=42)
    max_correlation = Param(default=0.95, doc="drop |corr with label| above (leakage)")
    min_correlation = Param(default=0.0, doc="drop |corr with label| below")
    min_variance = Param(default=1e-5, doc="drop variance below")
    max_cramers_v = Param(default=0.95, doc="drop categorical groups with V above")
    max_rule_confidence = Param(default=1.0)
    min_required_rule_support = Param(default=1.0)
    correlation_type = Param(default="pearson",
                             validator=lambda v: v in ("pearson", "spearman"))
    correlation_exclusion = Param(
        default="none", validator=lambda v: v in ("none", "hashed_text"),
        doc="exclude hashed-text slots from correlations "
            "(reference CorrelationExclusion)")
    feature_label_corr_only = Param(
        default=False,
        doc="skip the full (d, d) matrix; label correlations only "
            "(reference featureLabelCorrOnly)")
    remove_bad_features = Param(default=True)
    categorical_label = Param(default=None, doc="None = auto-detect")
    max_features_for_full_corr = Param(
        default=512,
        doc="the width past which, under a mesh, the full matrix is built by "
            "a ring of column shards across the ranks (parallel/wide.py); "
            "without one every width is one gram product")

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

    def fit_columns(self, cols, dataset, device):
        from ..models.base import full_f32

        label_col, vec_col = cols
        if vec_col.meta is None:
            raise ValueError("SanityChecker requires vector metadata on its feature input")
        y = label_col.data.astype(np.float64)
        x = np.asarray(vec_col.data, np.float32)
        n, d = x.shape

        if self.check_sample < 1.0:
            rng = np.random.default_rng(self.sample_seed)
            idx = rng.random(n) < self.check_sample
            x, y = x[idx], y[idx]
            n = x.shape[0]

        meta = vec_col.meta
        names = meta.column_names()
        dev = torch.device(device)
        on_card = dev.type == "cuda"
        spearman = self.correlation_type == "spearman"
        # under a mesh a Pearson fit reads this rank's rows and its sums
        # cross the ranks (``mesh``); Spearman's ranks need every row, so
        # each rank holds the whole block and nothing crosses (``mesh`` None)
        mesh = PM.current_mesh() if PM.sharded() and not spearman else None
        rows = PM.row_span(n, mesh) if mesh is not None else slice(0, n)
        t0 = time.perf_counter()
        # the feature block crosses to the device once; every statistic
        # below reads this one copy
        x_dev = torch.from_numpy(np.ascontiguousarray(x[rows])).to(dev)
        y_dev = torch.from_numpy(y[rows].astype(np.float32)).to(dev)
        if on_card:
            torch.cuda.synchronize(dev)  # opcheck: allow(TM301) the fit's one wait for the card before its stats come back
        t1 = time.perf_counter()

        corr_idx = list(range(d))
        if self.correlation_exclusion == "hashed_text":
            hashed = {
                c.index for c in meta.columns
                if c.indicator_value is None
                and c.parent_type in _HASHED_TEXT_PARENT_TYPES
                and (c.descriptor_value or "").startswith("hash_")
            }
            corr_idx = [j for j in range(d) if j not in hashed]
        excluded = len(corr_idx) < d

        label_levels = np.unique(y)
        if self.categorical_label is None:
            label_is_cat = len(label_levels) <= min(MAX_LABEL_CATEGORIES, np.sqrt(n))
        else:
            label_is_cat = bool(self.categorical_label)
        groups = meta.grouping_keys()

        with full_f32():
            mean_, var_, min_, max_, pearson_corr = (
                t.cpu().numpy() for t in _device_stats(x_dev, y_dev, n, mesh))

            # the correlation block: rank-transformed and/or column-subset x,
            # derived on the device from the one placed block
            xc_dev = _rank_columns(x_dev) if spearman else x_dev
            if excluded:
                xc_dev = xc_dev[:, torch.as_tensor(corr_idx, device=dev)]
            if spearman:
                y_rank = _rank_columns(y_dev[:, None])[:, 0]
                corr_sub = _device_label_corr(xc_dev, y_rank).cpu().numpy()  # opcheck: allow(TM301) end-of-fit fetch of the label correlations, once a fit
            else:
                corr_sub = pearson_corr[corr_idx]
            if excluded:
                corr = np.full(d, np.nan)
                corr[corr_idx] = corr_sub
            else:
                corr = corr_sub

            full = None
            if not self.feature_label_corr_only and corr_idx:
                if mesh is not None and \
                        len(corr_idx) > int(self.max_features_for_full_corr):
                    # the reference's wide path: a ring of column shards
                    # over every row
                    from ..parallel.wide import shard_cols, wide_full_corr

                    xs, d_c = shard_cols(x[:, corr_idx] if excluded else x,
                                         mesh, device=dev)
                    full = wide_full_corr(xs, mesh, d_c).cpu().numpy()
                    del xs
                else:
                    full = _device_full_corr(xc_dev, n, mesh).cpu().numpy()  # opcheck: allow(TM301) end-of-fit fetch of the correlation matrix, once a fit
            del xc_dev

            # every categorical group's contingency with the label in one
            # (L_total, C) product, split back per group on the host
            group_v: Dict[str, float] = {}
            group_conf: Dict[str, np.ndarray] = {}
            group_support: Dict[str, np.ndarray] = {}
            if label_is_cat and groups:
                y_onehot = torch.from_numpy(
                    (y[rows, None] == label_levels[None, :]).astype(np.float32)).to(dev)
                all_idx = [j for idxs in groups.values() for j in idxs]
                g_all = x_dev[:, torch.as_tensor(all_idx, device=dev)]
                cont = _row_sum(_device_contingency(g_all, y_onehot), mesh)
                cont_all = cont.cpu().numpy()  # opcheck: allow(TM301) end-of-fit fetch of the contingency tables, once a fit
                del g_all
                off = 0
                for gkey, indices in groups.items():
                    cont = cont_all[off:off + len(indices)]
                    off += len(indices)
                    group_v[gkey] = npstats.cramers_v(cont)
                    conf, support = npstats.max_rule_confidences(cont)
                    group_conf[gkey] = conf
                    group_support[gkey] = support
        del x_dev
        t2 = time.perf_counter()

        # drop decisions (reference getFeaturesToDrop)
        dropped: Dict[str, str] = {}
        if self.remove_bad_features:
            for j in range(d):
                name = names[j]
                if var_[j] < self.min_variance:
                    dropped[name] = f"variance {var_[j]:.3g} < min {self.min_variance}"
                    continue
                cj = corr[j]
                if np.isfinite(cj):
                    if abs(cj) > self.max_correlation:
                        dropped[name] = (
                            f"|corr(label)| {abs(cj):.3f} > max {self.max_correlation}"
                        )
                        continue
                    if abs(cj) < self.min_correlation:
                        dropped[name] = (
                            f"|corr(label)| {abs(cj):.3f} < min {self.min_correlation}"
                        )
                        continue
            for gkey, indices in groups.items():
                v = group_v.get(gkey)
                if v is not None and np.isfinite(v) and v > self.max_cramers_v:
                    for j in indices:
                        dropped.setdefault(
                            names[j], f"Cramér's V {v:.3f} > max {self.max_cramers_v}"
                        )
                conf = group_conf.get(gkey)
                if conf is not None:
                    support = group_support[gkey]
                    for pos, j in enumerate(indices):
                        if (conf[pos] >= self.max_rule_confidence
                                and support[pos] >= self.min_required_rule_support):
                            dropped.setdefault(
                                names[j],
                                f"rule confidence {conf[pos]:.3f} with support "
                                f"{support[pos]:.3f}",
                            )

        kept = [j for j in range(d) if names[j] not in dropped]
        if not kept:
            raise ValueError(
                "SanityChecker dropped every feature slot — check label quality or relax "
                "thresholds"
            )

        summary = SanityCheckerSummary(
            stats=[
                ColumnStats(
                    name=names[j], mean=float(mean_[j]), variance=float(var_[j]),
                    min=float(min_[j]), max=float(max_[j]),
                    corr_label=float(corr[j]) if np.isfinite(corr[j]) else float("nan"),
                    cramers_v=_group_value(meta, j, group_v),
                    max_rule_confidence=_group_pos_value(meta, j, groups, group_conf),
                    support=_group_pos_value(meta, j, groups, group_support),
                )
                for j in range(d)
            ],
            dropped=dropped,
            kept_indices=kept,
            label_distinct=len(label_levels),
            sample_size=n,
            correlation_type=self.correlation_type,
            correlations_feature=full,
            correlation_indices=corr_idx,
        )
        #: seconds of the last fit: the block's copy to the device, the
        #: device statistics (ending in their copies back), the host rest
        self.last_fit_profile = {"h2d": t1 - t0, "device": t2 - t1,
                                 "host": time.perf_counter() - t2}
        return SanityCheckerModel(kept_indices=kept, summary=summary, meta=meta)


def _group_value(meta: VectorMetadata, j: int, group_v: Dict[str, float]):
    c = meta.columns[j]
    if not c.is_indicator:
        return None
    return group_v.get(c.grouping_key())


def _group_pos_value(meta, j, groups, values):
    c = meta.columns[j]
    if not c.is_indicator:
        return None
    gkey = c.grouping_key()
    if gkey not in values:
        return None
    pos = groups[gkey].index(j)
    return float(values[gkey][pos])


class SanityCheckerModel(Transformer):
    """Slices the kept feature slots (DropIndicesByTransformer equivalent)."""

    input_types = (RealNN, OPVector)
    output_type = OPVector
    allow_label_as_input = True

    def __init__(self, kept_indices: List[int],
                 summary: Optional[SanityCheckerSummary] = None,
                 meta: Optional[VectorMetadata] = None, **kw):
        super().__init__(**kw)
        self.kept_indices = list(kept_indices)
        self.summary = summary
        #: VectorMetadata of the pre-drop input vector (slot provenance)
        self.meta = meta

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

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
