"""Multinomial logistic regression (softmax) by full-batch Adam on torch
tensors (counterpart of ``transmogrifai_tpu/models/softmax.py``).

The reference's optimizer: ``max_iter`` (200) Adam steps from zero at
learning rate 0.3 (beta1 0.9, beta2 0.999, eps 1e-8) on the weighted mean
cross-entropy plus reg/2 ||B||^2, the intercept row of B left out.  The
features are not standardized; a ones column carries the intercept.  Every
(grid, fold) fit of a CV sweep advances together: the weight matrices of
all fits side by side make the logits one product a step, and the gradients
another.  Products run in full float32 (TF32 off).
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
    eval_softmax_sweep,
    full_f32,
    softmax_probs,
    sweep_tensors,
)
from .logistic import _fit_tensors, _with_ones
from .prediction import PredictionColumn

MAX_ITER_DEFAULT = 200
LR_DEFAULT = 0.3
_BETA1, _BETA2, _EPS = 0.9, 0.999, 1e-8


def _bias_corrections(steps: int):
    """Adam's 1 - beta^(i+1), computed in float32 as the reference does."""
    i = np.arange(1, steps + 1, dtype=np.float32)
    return (np.float32(1.0) - np.float32(_BETA1) ** i,
            np.float32(1.0) - np.float32(_BETA2) ** i)


def _softmax_fits(x: torch.Tensor, y_onehot: torch.Tensor, w: torch.Tensor,
                  regs: torch.Tensor, max_iter: int,
                  has_intercept: bool) -> torch.Tensor:
    """F fits: x (n, d1), y_onehot (n, C), w (F, n) row weights, regs (F,).
    Returns B (F, d1, C)."""
    n, d1 = x.shape
    F, C = w.shape[0], y_onehot.shape[1]
    dev = x.device
    sw = torch.clamp_min(w.sum(dim=1), 1e-12)[:, None, None]
    pen = torch.ones((d1, 1), dtype=torch.float32, device=dev)
    if has_intercept:
        pen[-1, 0] = 0.0
    reg_pen = regs[:, None, None] * pen[None]                  # (F, d1, 1)
    wT = w.T[:, :, None]                                       # (n, F, 1)
    b = torch.zeros((F, d1, C), dtype=torch.float32, device=dev)
    m = torch.zeros_like(b)
    v = torch.zeros_like(b)
    c1, c2 = _bias_corrections(max_iter)
    for i in range(max_iter):
        logits = (x @ b.permute(1, 0, 2).reshape(d1, F * C)).reshape(n, F, C)
        p = torch.exp(torch.log_softmax(logits, dim=-1))
        r = (wT * (p - y_onehot[:, None, :])).reshape(n, F * C)
        g = (x.T @ r).reshape(d1, F, C).permute(1, 0, 2) / sw + reg_pen * b
        m = _BETA1 * m + (1 - _BETA1) * g
        v = _BETA2 * v + (1 - _BETA2) * g * g
        b = b - LR_DEFAULT * (m / float(c1[i])) / (torch.sqrt(v / float(c2[i])) + _EPS)
    return b


class MultinomialLogisticRegression(PredictionEstimatorBase):
    """Multiclass OpLogisticRegression capability (Spark's multinomial
    family)."""

    reg_param = Param(default=0.0)
    elastic_net = Param(default=0.0)
    max_iter = Param(default=MAX_ITER_DEFAULT)
    fit_intercept = Param(default=True)
    n_classes = Param(default=None, doc="None = infer from labels")

    def _n_classes(self, y: np.ndarray) -> int:
        return int(self.n_classes) if self.n_classes else int(y.max()) + 1

    def _l2(self, grid: Dict[str, Any]) -> float:
        return float(grid.get("reg_param", self.reg_param)) \
            * (1.0 - float(grid.get("elastic_net", self.elastic_net)))

    def _fit_arrays(self, x, y, w, device):
        icpt = bool(self.fit_intercept)
        c = self._n_classes(y)
        with full_f32():
            xd, yd, wd = _fit_tensors(x, y, w, device)
            y_onehot = torch.nn.functional.one_hot(yd.long(), c).to(torch.float32)
            regs = torch.tensor([self._l2({})], dtype=torch.float32, device=device)
            b = _softmax_fits(_with_ones(xd, icpt), y_onehot,
                              wd[None], regs, int(self.max_iter), icpt)[0].cpu().numpy()
        if icpt:
            coef, intercept = b[:-1], b[-1]
        else:
            coef, intercept = b, np.zeros(c)
        return MultinomialLogisticRegressionModel(coef=coef, intercept=intercept)

    def _cv_sweep_device(self, x, y, train_w, val_w,
                         grids: List[Dict[str, Any]], metric_fn, device):
        icpt = bool(self.fit_intercept)
        c = self._n_classes(y)
        g, k = len(grids), train_w.shape[0]
        with full_f32():
            xd, yd, tw, vw = sweep_tensors(x, y, train_w, val_w, device)
            xd = _with_ones(xd, icpt)
            y_onehot = torch.nn.functional.one_hot(yd.long(), c).to(torch.float32)
            regs = torch.tensor([self._l2(gr) for gr in grids for _ in range(k)],
                                dtype=torch.float32, device=device)
            bs = _softmax_fits(xd, y_onehot, tw.repeat(g, 1), regs,
                               int(self.max_iter), icpt)
            return eval_softmax_sweep(xd, yd, bs.reshape(g, k, *bs.shape[1:]), vw,
                                      metric_fn)


class MultinomialLogisticRegressionModel(PredictionModelBase):
    def __init__(self, coef: np.ndarray, intercept: np.ndarray, **kw):
        super().__init__(**kw)
        self.coef = np.asarray(coef, dtype=np.float64)
        self.intercept = np.asarray(intercept, dtype=np.float64)

    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        logits = vec.data.astype(np.float64) @ self.coef + self.intercept
        return PredictionColumn.classification(logits, softmax_probs(logits))
