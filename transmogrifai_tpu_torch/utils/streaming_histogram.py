"""Mergeable streaming histogram (Ben-Haim & Tom-Tov, JMLR 2010); a host
copy of ``transmogrifai_tpu/utils/streaming_histogram.py``, numpy only.

Reference capability: StreamingHistogram
(utils/src/main/java/com/salesforce/op/utils/stats/StreamingHistogram.java, plus
RichStreamingHistogram) — the reference's only first-party Java class, used to sketch
feature distributions in one pass with a fixed memory bound.

The sketch holds at most ``max_bins`` (centroid, count) pairs; inserting a point adds
a unit bin then merges the two closest centroids.  Two sketches merge by concatenating
bins and re-compacting — an associative, commutative reduction, so sketches combine
across row shards exactly like the monoid aggregators (SURVEY §2.4) and across hosts
over DCN.  Vectorized numpy throughout: ``update`` ingests whole blocks, not scalars.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class StreamingHistogram:
    """Fixed-size mergeable histogram sketch over a stream of doubles."""

    __slots__ = ("max_bins", "_centers", "_counts")

    def __init__(self, max_bins: int = 64):
        if max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        self.max_bins = int(max_bins)
        self._centers = np.zeros(0, np.float64)
        self._counts = np.zeros(0, np.float64)

    # -- construction -------------------------------------------------------

    @property
    def bins(self) -> List[Tuple[float, float]]:
        return [(float(c), float(n)) for c, n in zip(self._centers, self._counts)]

    @property
    def total(self) -> float:
        return float(self._counts.sum())

    def update(self, values: Sequence[float]) -> "StreamingHistogram":
        """Ingest a block of values (NaNs ignored); returns self."""
        v = np.asarray(values, np.float64).ravel()
        v = v[~np.isnan(v)]
        if v.size == 0:
            return self
        uniq, cnt = np.unique(v, return_counts=True)
        self._centers = np.concatenate([self._centers, uniq])
        self._counts = np.concatenate([self._counts, cnt.astype(np.float64)])
        self._compact()
        return self

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Merged sketch (associative/commutative; capacity = max of the two)."""
        out = StreamingHistogram(max(self.max_bins, other.max_bins))
        out._centers = np.concatenate([self._centers, other._centers])
        out._counts = np.concatenate([self._counts, other._counts])
        out._compact()
        return out

    def _compact(self) -> None:
        order = np.argsort(self._centers, kind="stable")
        centers, counts = self._centers[order], self._counts[order]
        # collapse exact duplicates first (centers equal after sort)
        if centers.size > 1:
            same = np.diff(centers) == 0.0
            if same.any():
                keep = np.concatenate([[True], ~same])
                group = np.cumsum(keep) - 1
                merged_counts = np.zeros(group[-1] + 1, np.float64)
                np.add.at(merged_counts, group, counts)
                centers = centers[keep]
                counts = merged_counts
        while centers.size > self.max_bins:
            gaps = np.diff(centers)
            i = int(np.argmin(gaps))
            n = counts[i] + counts[i + 1]
            c = (centers[i] * counts[i] + centers[i + 1] * counts[i + 1]) / n
            centers = np.concatenate([centers[:i], [c], centers[i + 2:]])
            counts = np.concatenate([counts[:i], [n], counts[i + 2:]])
        self._centers, self._counts = centers, counts

    # -- queries (RichStreamingHistogram role) ------------------------------

    def sum_until(self, b: float) -> float:
        """Estimated count of points <= b (the paper's `sum` procedure)."""
        if self._centers.size == 0:
            return 0.0
        c, n = self._centers, self._counts
        if b < c[0]:
            return 0.0
        if b >= c[-1]:
            return self.total
        i = int(np.searchsorted(c, b, side="right")) - 1
        # full bins strictly before i, half of bin i, plus trapezoid interpolation
        s = float(n[:i].sum()) + n[i] / 2.0
        gap = c[i + 1] - c[i]
        if gap <= 0:
            return s
        frac = (b - c[i]) / gap
        nb = n[i] + (n[i + 1] - n[i]) * frac
        s += (n[i] + nb) / 2.0 * frac
        return float(s)

    def quantile(self, q: float) -> float:
        """Approximate q-quantile via inverse interpolation of sum_until."""
        if self._centers.size == 0:
            return float("nan")
        if self._centers.size == 1:
            return float(self._centers[0])
        q = min(max(q, 0.0), 1.0)
        target = q * self.total
        lo, hi = float(self._centers[0]), float(self._centers[-1])
        for _ in range(60):
            mid = (lo + hi) / 2.0
            if self.sum_until(mid) < target:
                lo = mid
            else:
                hi = mid
        return (lo + hi) / 2.0

    def density(self, bounds: Sequence[float]) -> np.ndarray:
        """Estimated counts per (bounds[i], bounds[i+1]] interval."""
        b = np.asarray(bounds, np.float64)
        cum = np.array([self.sum_until(x) for x in b])
        return np.maximum(np.diff(cum), 0.0)

    def to_dict(self) -> dict:
        return {"maxBins": self.max_bins,
                "centers": self._centers.tolist(),
                "counts": self._counts.tolist()}

    @staticmethod
    def from_dict(d: dict) -> "StreamingHistogram":
        h = StreamingHistogram(d["maxBins"])
        h._centers = np.asarray(d["centers"], np.float64)
        h._counts = np.asarray(d["counts"], np.float64)
        return h

    def __repr__(self) -> str:
        return f"StreamingHistogram(bins={len(self._centers)}, total={self.total})"
