"""Multinomial naive Bayes on torch tensors (counterpart of
``transmogrifai_tpu/models/naive_bayes.py``).

A fit is one product: the per-class weighted feature sums
``onehot(y)^T @ (w * x)`` (C, d), smoothed into log class-conditional
probabilities, and the log class priors.  Negative features (z-scored
slots) are shifted to non-negative per fit by the minimum over the rows
that train (weight > 0).  A CV sweep shifts each fold's block once and
shares its product among the grid's smoothings.  Labels that are not the
classes 0..C-1, or grids that set another parameter, take the generic
sweep (one fit per (grid, fold)), as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..data.dataset import Column
from ..stages.base import Param
from .base import (
    PredictionEstimatorBase,
    PredictionModelBase,
    full_f32,
    softmax_probs,
    sweep_placements,
)
from .prediction import PredictionColumn


def _class_sums(xs: torch.Tensor, y_onehot: torch.Tensor, w: torch.Tensor):
    """(class weights (C,), per-class feature sums (C, d))."""
    wts = y_onehot * w[:, None]
    return wts.sum(dim=0), wts.T @ xs


def _nb_params(class_w: torch.Tensor, feat: torch.Tensor, smoothing: float, d: int):
    """(log_prior (C,), log_theta (C, d)) from a fit's class sums."""
    theta = (feat + smoothing) / (feat.sum(dim=1, keepdim=True) + smoothing * d)
    log_prior = torch.log(class_w / torch.clamp_min(class_w.sum(), 1e-12))
    return log_prior, torch.log(theta)


def _train_shift(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """min(0, the column minima over the rows with w > 0)."""
    inf = torch.full_like(x, float("inf"))
    return torch.clamp_max(torch.where((w > 0)[:, None], x, inf).amin(dim=0), 0.0)


class NaiveBayes(PredictionEstimatorBase):
    """OpNaiveBayes capability (multinomial, smoothing 1.0)."""

    smoothing = Param(default=1.0)

    def _fit_arrays(self, x, y, w, device):
        x = np.asarray(x, dtype=np.float32)
        active = np.asarray(w) > 0
        xa = x[active] if active.any() else x
        shift = np.minimum(xa.min(axis=0), 0.0)
        classes = np.unique(y)
        y_onehot = (y[:, None] == classes[None, :]).astype(np.float32)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        with full_f32():
            class_w, feat = _class_sums(t(x - shift), t(y_onehot), t(w))
            log_prior, log_theta = _nb_params(class_w, feat, float(np.float32(
                self.smoothing)), x.shape[1])
        return NaiveBayesModel(
            classes=classes.astype(np.float64),
            log_prior=log_prior.cpu().numpy().astype(np.float64),
            log_theta=log_theta.cpu().numpy().astype(np.float64),
            shift=shift.astype(np.float64))

    def _cv_sweep_device(self, x, y, train_w, val_w,
                         grids: List[Dict[str, Any]], metric_fn, device):
        classes = np.unique(y)
        if (any(set(g) - {"smoothing"} for g in grids)
                or not np.array_equal(classes, np.arange(len(classes)))):
            return None
        smoothings = [float(np.float32(g.get("smoothing", self.smoothing)))
                      for g in grids]
        multiclass = len(classes) > 2
        with full_f32():
            sp = sweep_placements(x, y, train_w, val_w, device, shard=False)
            xd, yd, tw, vw = sp.x, sp.y, sp.train_w, sp.val_w
            y_onehot = (yd[:, None] == torch.arange(
                len(classes), device=device, dtype=torch.float32)[None, :]).to(
                    torch.float32)
            per_fold = []
            for f in range(tw.shape[0]):  # opcheck: allow(TM302) a loop over the CV folds, each a whole-table op
                xs = xd - _train_shift(xd, tw[f])
                class_w, feat = _class_sums(xs, y_onehot, tw[f])
                row = []
                for s in smoothings:
                    log_prior, log_theta = _nb_params(class_w, feat, s, xd.shape[1])
                    prob = torch.softmax(xs @ log_theta.T + log_prior, dim=-1)
                    row.append(metric_fn(prob if multiclass else prob[:, 1].contiguous(),
                                         yd, vw[f]))
                per_fold.append(row)
        return [torch.stack([per_fold[f][gi] for f in range(len(per_fold))])
                for gi in range(len(grids))]


class NaiveBayesModel(PredictionModelBase):
    def __init__(self, classes: np.ndarray, log_prior: np.ndarray,
                 log_theta: np.ndarray, shift: np.ndarray, **kw):
        super().__init__(**kw)
        self.classes = np.asarray(classes, dtype=np.float64)
        self.log_prior = np.asarray(log_prior, dtype=np.float64)
        self.log_theta = np.asarray(log_theta, dtype=np.float64)
        self.shift = np.asarray(shift, dtype=np.float64)

    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        x = np.maximum(vec.data.astype(np.float64) - self.shift, 0.0)
        raw = x @ self.log_theta.T + self.log_prior
        prob = softmax_probs(raw)
        return PredictionColumn(self.classes[np.argmax(raw, axis=1)], raw, prob)

    def insight_payload(self, x):
        shift = torch.from_numpy(self.shift).to(x.device)
        xs = torch.clamp(x.to(torch.float64) - shift, min=0.0)
        return torch.softmax(linear_margin64(xs, self.log_theta.T, self.log_prior), dim=1)
