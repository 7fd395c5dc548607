"""Per-feature summaries and binned distributions for the RawFeatureFilter
(counterpart of ``transmogrifai_tpu/filters/distribution.py``).

Every numeric column (and every numeric map key, and a geolocation's
distance from the origin) joins one (n, d) block, and its histograms come
from one scatter-add on the device (:func:`numeric_histograms`); text, list,
set and text-map values hash on the host (murmur3), where they live.  The
summaries (min, max, sum, count) are float64 numpy on the host, as in the
reference.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Dataset, _is_empty_obj
from ..features.feature import Feature
from ..types import ColumnKind
from ..utils.hashing import hash_to_bucket

#: counters of the histogram launches (one per distributions pass with a
#: numeric column), read by chip_smoke
launches = 0


def reset_launch_counts() -> None:
    global launches
    launches = 0


@dataclass(frozen=True)
class Summary:
    """Min/max/sum/count of a feature's non-null values."""

    min: float
    max: float
    sum: float
    count: float

    @staticmethod
    def empty() -> "Summary":
        return Summary(np.inf, -np.inf, 0.0, 0.0)

    def to_dict(self) -> dict:
        return {"min": self.min, "max": self.max, "sum": self.sum, "count": self.count}


@dataclass
class FeatureDistribution:
    """Binned distribution of one raw feature (or one map key):
    equi-width bins over [summary.min, summary.max] for numerics,
    hashed-token buckets for text-like values."""

    name: str
    key: Optional[str]          # map key, None for scalar features
    count: int                  # total rows
    nulls: int                  # rows where the feature is empty
    distribution: np.ndarray    # (bins,) float64 counts
    summary_info: Summary

    @property
    def fill_rate(self) -> float:
        return (self.count - self.nulls) / self.count if self.count else 0.0

    def relative_fill_delta(self, other: "FeatureDistribution") -> float:
        return abs(self.fill_rate - other.fill_rate)

    def relative_fill_ratio(self, other: "FeatureDistribution") -> float:
        a, b = self.fill_rate, other.fill_rate
        lo, hi = min(a, b), max(a, b)
        return np.inf if lo == 0.0 else hi / lo

    def js_divergence(self, other: "FeatureDistribution") -> float:
        return js_divergence(self.distribution, other.distribution)

    @property
    def full_name(self) -> str:
        return self.name if self.key is None else f"{self.name}[{self.key}]"

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "key": self.key,
            "count": self.count,
            "nulls": self.nulls,
            "distribution": self.distribution.tolist(),
            "summaryInfo": self.summary_info.to_dict(),
        }


def js_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """Jensen-Shannon divergence between two (unnormalized) histograms, in
    [0, 1]: base-2 logs, zero-count bins contribute nothing."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    ps, qs = p.sum(), q.sum()
    if ps == 0.0 or qs == 0.0:
        return 0.0
    p = p / ps
    q = q / qs
    m = 0.5 * (p + q)
    with np.errstate(divide="ignore", invalid="ignore"):
        kl_pm = np.where(p > 0, p * np.log2(p / m), 0.0).sum()
        kl_qm = np.where(q > 0, q * np.log2(q / m), 0.0).sum()
    return float(0.5 * kl_pm + 0.5 * kl_qm)


# ---------------------------------------------------------------------------
# Numeric histograms on the device
# ---------------------------------------------------------------------------

def numeric_histograms(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                       bins: int) -> torch.Tensor:
    """(d, bins) float32 counts of every column of the (n, d) float32 block
    ``values`` (NaN = missing) over [lo, hi) per column, in one scatter-add
    into a flat (d * bins,) accumulator.

    The reference's arithmetic, in float32: ``(v - lo) / width * bins``
    (a true division: ``width`` is data), truncated to an integer and
    clipped to [0, bins - 1].  XLA's float-to-int conversion saturates
    (+inf and values past 2^31 land in the last bin, NaN in the first), so
    the clip runs before the cast here, which gives the same bin for every
    value.  The counts are integers below 2^24, exact in any order."""
    n, d = values.shape
    width = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    scaled = (values - lo[None, :]) / width[None, :] * bins
    idx = torch.nan_to_num(scaled, nan=0.0).clamp(0, bins - 1).to(torch.int64)
    flat = idx + torch.arange(d, device=values.device)[None, :] * bins
    counts = torch.zeros(d * bins, dtype=torch.float32, device=values.device)
    counts.index_add_(0, flat.reshape(-1), (~torch.isnan(values)).reshape(-1).to(torch.float32))
    return counts.reshape(d, bins)


def _numeric_block_distributions(
    named_cols: List[Tuple[str, Optional[str], np.ndarray]], bins: int,
    ref_summaries: Optional[Dict[Tuple[str, Optional[str]], Summary]], device,
) -> List[FeatureDistribution]:
    """named_cols: (feature name, map key, float64 values, NaN missing).

    With ``ref_summaries`` (the scoring pass) the bin edges are the
    training summaries' min and max, so the two passes' histograms compare
    bin for bin; the summaries always describe this dataset."""
    global launches
    if not named_cols:
        return []
    block = np.stack([v for _, _, v in named_cols], axis=1)  # (n, d)
    n = block.shape[0]
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN columns are legal
        lo = np.nanmin(block, axis=0)
        hi = np.nanmax(block, axis=0)
        sums = np.nansum(block, axis=0)
        counts = (~np.isnan(block)).sum(axis=0)
    lo = np.where(np.isfinite(lo), lo, 0.0)
    hi = np.where(np.isfinite(hi), hi, 0.0)
    edge_lo, edge_hi = lo.copy(), hi.copy()
    if ref_summaries is not None:
        for j, (name, key, _) in enumerate(named_cols):
            ref = ref_summaries.get((name, key))
            if ref is not None and ref.count > 0:
                edge_lo[j], edge_hi[j] = ref.min, ref.max
    # float32 before any arithmetic, as the reference's device copy rounds
    values = torch.from_numpy(block.astype(np.float32)).to(device)
    hists = numeric_histograms(values, torch.from_numpy(edge_lo.astype(np.float32)).to(device),
                               torch.from_numpy(edge_hi.astype(np.float32)).to(device),
                               bins).cpu().numpy()
    launches += 1
    out = []
    for j, (name, key, _) in enumerate(named_cols):
        summ = (Summary(float(lo[j]), float(hi[j]), float(sums[j]), float(counts[j]))
                if counts[j] else Summary.empty())
        out.append(FeatureDistribution(
            name=name, key=key, count=n, nulls=int(n - counts[j]),
            distribution=hists[j].astype(np.float64), summary_info=summ))
    return out


# ---------------------------------------------------------------------------
# Text, set and list values: hashed on the host
# ---------------------------------------------------------------------------

def _hashed_distribution(name: str, key: Optional[str], values: Sequence[Any],
                         text_bins: int) -> FeatureDistribution:
    """Hash string-ish values (a list's or set's elements one by one, any
    other value as ``str``) into ``text_bins`` buckets."""
    buckets: List[int] = []
    nulls = 0
    for v in values:
        if _is_empty_obj(v):
            nulls += 1
            continue
        for t in (v if isinstance(v, (list, set, tuple)) else [v]):
            buckets.append(hash_to_bucket(str(t), text_bins))
    counts = np.bincount(np.asarray(buckets, dtype=np.int64),
                         minlength=text_bins).astype(np.float64)
    summ = Summary(0.0, float(text_bins), float(len(buckets)), float(len(values) - nulls))
    return FeatureDistribution(name=name, key=key, count=len(values), nulls=nulls,
                               distribution=counts, summary_info=summ)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

_NUMERIC_KINDS = (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL)


def compute_distributions(
    dataset: Dataset,
    raw_features: Sequence[Feature],
    bins: int = 100,
    text_bins: int = 100,
    ref_summaries: Optional[Dict[Tuple[str, Optional[str]], Summary]] = None,
    *, device=None,
) -> List[FeatureDistribution]:
    """One FeatureDistribution per raw predictor feature (one per key of a
    map feature), the numeric ones histogrammed on ``device`` (the CUDA card
    unless the caller names another).  Response features are skipped: they
    are never filtered."""
    from ..perf.kernels.dispatch import resolve_device

    dev = resolve_device(device)
    numeric_cols: List[Tuple[str, Optional[str], np.ndarray]] = []
    out: List[FeatureDistribution] = []
    for f in raw_features:
        if f.is_response or f.name not in dataset:
            continue
        col = dataset[f.name]
        kind = col.kind
        if kind in _NUMERIC_KINDS:
            numeric_cols.append((f.name, None, col.values_f64()))
        elif kind is ColumnKind.GEO:
            present = col.present()
            # a distribution over the distance from the origin
            vals = np.where(present, np.linalg.norm(col.data[:, :2], axis=1), np.nan)
            numeric_cols.append((f.name, None, vals))
        elif kind is ColumnKind.MAP:
            keys = sorted({k for m in col.data if m for k in m})
            for k in keys:
                sub = [m.get(k) if m else None for m in col.data]
                # the first non-null value decides numeric or hashed
                first = next((v for v in sub if v is not None), None)
                if isinstance(first, (bool, int, float)):
                    arr = np.array([float(v) if v is not None else np.nan for v in sub],
                                   dtype=np.float64)
                    numeric_cols.append((f.name, k, arr))
                else:
                    out.append(_hashed_distribution(f.name, k, sub, text_bins))
        elif kind is ColumnKind.VECTOR:
            continue  # vectors are derived, never raw-filtered
        else:  # TEXT, TEXT_LIST, TEXT_SET, INT_LIST
            out.append(_hashed_distribution(f.name, None, list(col.data), text_bins))
    out.extend(_numeric_block_distributions(numeric_cols, bins, ref_summaries, dev))
    return out
