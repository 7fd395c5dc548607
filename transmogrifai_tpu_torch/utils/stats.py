"""Contingency-matrix statistics the SanityChecker reads (host copy of
``transmogrifai_tpu/utils/stats.py``): chi-squared -> Cramér's V, pointwise
mutual information, max rule confidence and support, and the Pearson and
Spearman correlations with a label (the RawFeatureFilter reads Pearson's).
Float64 numpy, as in the reference, so the checker's group statistics come
out bitwise equal."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def chi_squared(contingency: np.ndarray) -> float:
    """Pearson chi-squared statistic of an (r, c) contingency matrix."""
    c = np.asarray(contingency, dtype=np.float64)
    total = c.sum()
    if total == 0:
        return 0.0
    row = c.sum(axis=1, keepdims=True)
    col = c.sum(axis=0, keepdims=True)
    expected = row @ col / total
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(expected > 0, (c - expected) ** 2 / expected, 0.0)
    return float(terms.sum())


def cramers_v(contingency: np.ndarray) -> float:
    """Cramér's V in [0, 1] from a contingency matrix (label association strength)."""
    c = np.asarray(contingency, dtype=np.float64)
    total = c.sum()
    # degenerate matrices (single row/col) carry no association signal
    r = int((c.sum(axis=1) > 0).sum())
    k = int((c.sum(axis=0) > 0).sum())
    denom_dim = min(r, k) - 1
    if total == 0 or denom_dim <= 0:
        return float("nan")
    chi2 = chi_squared(c)
    return float(np.sqrt(chi2 / (total * denom_dim)))


def pointwise_mutual_information(contingency: np.ndarray) -> np.ndarray:
    """PMI per cell (log2 p(x,y) / (p(x)p(y))); zeros where undefined."""
    c = np.asarray(contingency, dtype=np.float64)
    total = c.sum()
    if total == 0:
        return np.zeros_like(c)
    p = c / total
    px = p.sum(axis=1, keepdims=True)
    py = p.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.log2(p / (px @ py))
    pmi[~np.isfinite(pmi)] = 0.0
    return pmi


def max_rule_confidences(contingency: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per feature-level (row): (max confidence over labels, support).

    Association-rule stats: confidence = P(label | level), support = P(level).
    """
    c = np.asarray(contingency, dtype=np.float64)
    total = c.sum()
    row_totals = c.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        conf = np.where(row_totals[:, None] > 0, c / row_totals[:, None], 0.0)
    support = row_totals / total if total > 0 else np.zeros_like(row_totals)
    return conf.max(axis=1), support


def pearson_with_label(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Pearson correlation of each column of x (n, d) with y (n,). NaN for zero variance."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    xm = x - x.mean(axis=0)
    ym = y - y.mean()
    cov = xm.T @ ym / n
    sx = np.sqrt((xm ** 2).mean(axis=0))
    sy = np.sqrt((ym ** 2).mean())
    with np.errstate(divide="ignore", invalid="ignore"):
        out = cov / (sx * sy)
    return out


def spearman_with_label(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Spearman rank correlation of each column of x with y."""
    def ranks(v: np.ndarray) -> np.ndarray:
        order = np.argsort(v, axis=0, kind="stable")
        r = np.empty_like(order, dtype=np.float64)
        if v.ndim == 1:
            r[order] = np.arange(v.shape[0])
        else:
            for j in range(v.shape[1]):  # opcheck: allow(TM302) a loop over the columns of a host numpy rank matrix
                r[order[:, j], j] = np.arange(v.shape[0])
        return r

    return pearson_with_label(ranks(x), ranks(y))
