"""Metric functions on torch tensors (counterpart of
``transmogrifai_tpu/evaluators/metrics.py``): binary, regression and
multiclass.

Every function takes (scores, labels, weights) tensors on one device;
weight-0 rows are inert.  AuROC / AuPR follow Spark's
BinaryClassificationMetrics (trapezoid rule, the PR curve starting at
(recall 0, precision 1)); ties are per row, as in the reference.  Sums run
in the reference's order (:func:`~..utils.reduce.window_sum`).
"""

from __future__ import annotations

import torch

from ..utils.reduce import window_sum

EPS = 1e-12


def _sorted_cums(scores: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Weighted positive / negative cumulative counts in order of falling
    score; a stable sort of -scores, so tied rows keep their order."""
    order = torch.sort(-scores, stable=True).indices
    tp = torch.cumsum((w * y)[order], dim=0)
    fp = torch.cumsum((w * (1.0 - y))[order], dim=0)
    return tp, fp


def _trapezoid(yv: torch.Tensor, xv: torch.Tensor, y0: float) -> torch.Tensor:
    yv = torch.cat([torch.full((1,), y0, dtype=yv.dtype, device=yv.device), yv])
    xv = torch.cat([torch.zeros(1, dtype=xv.dtype, device=xv.device), xv])
    return window_sum(0.5 * (yv[1:] + yv[:-1]) * (xv[1:] - xv[:-1]))


def au_roc(scores, y, w) -> torch.Tensor:
    """Weighted area under the ROC curve."""
    tp, fp = _sorted_cums(scores, y, w)
    tpr = tp / torch.clamp_min(tp[-1], EPS)
    fpr = fp / torch.clamp_min(fp[-1], EPS)
    return _trapezoid(tpr, fpr, 0.0)


def au_pr(scores, y, w) -> torch.Tensor:
    """Weighted area under the precision-recall curve."""
    tp, fp = _sorted_cums(scores, y, w)
    recall = tp / torch.clamp_min(tp[-1], EPS)
    precision = tp / torch.clamp_min(tp + fp, EPS)
    return _trapezoid(precision, recall, 1.0)


def binary_counts(scores, y, w, threshold: float = 0.5):
    pred = (scores >= threshold).to(scores.dtype)
    tp = window_sum(w * pred * y)
    fp = window_sum(w * pred * (1 - y))
    tn = window_sum(w * (1 - pred) * (1 - y))
    fn = window_sum(w * (1 - pred) * y)
    return tp, fp, tn, fn


def precision_recall_f1(scores, y, w, threshold: float = 0.5):
    tp, fp, tn, fn = binary_counts(scores, y, w, threshold)
    precision = tp / torch.clamp_min(tp + fp, EPS)
    recall = tp / torch.clamp_min(tp + fn, EPS)
    f1 = 2 * precision * recall / torch.clamp_min(precision + recall, EPS)
    error = (fp + fn) / torch.clamp_min(tp + fp + tn + fn, EPS)
    return precision, recall, f1, error


def log_loss(scores, y, w) -> torch.Tensor:
    p = torch.clamp(scores, EPS, 1 - EPS)
    ll = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    return window_sum(w * ll) / torch.clamp_min(window_sum(w), EPS)


def threshold_curves(scores, y, w, num_thresholds: int = 100):
    """(thresholds, precision, recall, fpr) at ``num_thresholds`` evenly
    spaced rank positions of the falling scores.  Tied scores collapse: the
    counts at a threshold are those of the last row with that score (the
    reference's ``searchsorted``), so every point is one a threshold gives."""
    order = torch.sort(-scores, stable=True).indices
    ss, ys, ws = scores[order], y[order], w[order]
    tp = torch.cumsum(ws * ys, dim=0)
    fp = torch.cumsum(ws * (1.0 - ys), dim=0)
    pos = torch.clamp_min(tp[-1], EPS)
    neg = torch.clamp_min(fp[-1], EPS)
    n = scores.shape[0]
    idx = torch.clamp((torch.arange(num_thresholds, device=scores.device) * n)
                      // num_thresholds, 0, n - 1)
    th = ss[idx]
    last = torch.searchsorted(-ss, -th, right=True) - 1
    return (th, tp[last] / torch.clamp_min(tp[last] + fp[last], EPS),
            tp[last] / pos, fp[last] / neg)


# --- regression --------------------------------------------------------------

def _wmean(v, w):
    return window_sum(w * v) / torch.clamp_min(window_sum(w), EPS)


def mse(pred, y, w):
    return _wmean((pred - y) ** 2, w)


def rmse(pred, y, w):
    return torch.sqrt(mse(pred, y, w))


def mae(pred, y, w):
    return _wmean((pred - y).abs(), w)


def r2(pred, y, w):
    sw = torch.clamp_min(window_sum(w), EPS)
    ybar = window_sum(w * y) / sw
    ss_res = window_sum(w * (y - pred) ** 2)
    ss_tot = torch.clamp_min(window_sum(w * (y - ybar) ** 2), EPS)
    return 1.0 - ss_res / ss_tot


def smape(pred, y, w):
    denom = torch.clamp_min(pred.abs() + y.abs(), EPS)
    return 2.0 * window_sum(w * (pred - y).abs() / denom) \
        / torch.clamp_min(window_sum(w), EPS)


# --- multiclass --------------------------------------------------------------

def multiclass_error(prob, y, w):
    """Weighted error of the argmax class; prob (n, C), or a 1-D positive
    class score where a model took its binary path (only two classes
    seen), read at 0.5.  y (n,) integer-valued labels."""
    if prob.dim() == 1:
        pred = (prob > 0.5).to(y.dtype)
    else:
        pred = torch.argmax(prob, dim=1).to(y.dtype)
    wrong = (pred != y).to(torch.float32)
    return window_sum(w * wrong) / torch.clamp_min(window_sum(w), EPS)


METRICS_BINARY = {
    "auPR": au_pr,
    "auROC": au_roc,
    "logLoss": log_loss,
}
METRICS_REGRESSION = {
    "rmse": rmse,
    "mse": mse,
    "mae": mae,
    "r2": r2,
    "smape": smape,
}
#: metrics where larger is better
LARGER_IS_BETTER = {"auPR", "auROC", "r2", "f1", "precision", "recall"}

BINARY_SUMMARY_KEYS = ("auROC", "auPR", "precision", "recall", "f1", "error",
                       "tp", "fp", "tn", "fn")


def binary_summary(scores, preds, y, w) -> torch.Tensor:
    """All binary point metrics as one (10,) tensor (one host copy), in the
    order of ``BINARY_SUMMARY_KEYS``."""
    tp, fp, tn, fn = binary_counts(preds, y, w)
    prec, rec, f1, err = precision_recall_f1(preds, y, w)
    return torch.stack([au_roc(scores, y, w), au_pr(scores, y, w),
                        prec, rec, f1, err, tp, fp, tn, fn])


REGRESSION_SUMMARY_KEYS = ("rmse", "mse", "mae", "r2", "smape")


def regression_summary(pred, y, w) -> torch.Tensor:
    """rmse, mse, mae, r2 and smape as one (5,) tensor (one host copy)."""
    return torch.stack([rmse(pred, y, w), mse(pred, y, w), mae(pred, y, w),
                        r2(pred, y, w), smape(pred, y, w)])
