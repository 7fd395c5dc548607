"""Linear SVC: squared-hinge loss, full-batch momentum descent on torch
tensors (counterpart of ``transmogrifai_tpu/models/svm.py``).

As the reference: a fixed ``max_iter`` loop of momentum 0.9 steps whose size
comes from a Lipschitz bound, the intercept's ones column exempt from L2,
and a model that emits margins only (no probabilities; the binary evaluator
ranks by the margin).  A CV sweep standardizes each fold with that fold's
train weights (``std = sqrt(var)`` where ``var > 0``, else 1 -- not the
logistic rule) and fits the fold's grid points together, one product a
step; each metric is taken on the fold's standardized margins.  Products run
in full float32 (TF32 off).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..data.dataset import Column
from ..perf.programs import run_cached
from ..stages.base import Param
from .base import (
    PredictionEstimatorBase,
    PredictionModelBase,
    full_f32,
    linear_eval_payload,
    linear_margin64,
    ModelParts,
    place_fit_arrays,
    place_rows,
    sweep_placements,
)
from ..parallel.mesh import gather_rows, model_share, reduce_rows
from .logistic import (
    _device_prepare_fit,
    _finalize_beta,
    _pen_mask,
    _with_ones,
)
from .prediction import PredictionColumn


def _svc_body(x: torch.Tensor, y_pm: torch.Tensor, w: torch.Tensor,
              reg: torch.Tensor, max_iter: int,
              has_intercept: bool = True) -> torch.Tensor:
    """Squared-hinge descent of B fits sharing ``x``: y_pm in {-1, +1}; w
    (B, n) row weights; reg (B,).  Step 1 / max(2 sum(w x^2)/sw + reg, 1e-6),
    the sum over every entry of ``x`` (the ones column too).  Returns betas
    (B, d1)."""
    n, d1 = x.shape
    B = w.shape[0]
    dev = x.device
    sw = torch.clamp_min(reduce_rows(w.sum(dim=1)), 1e-12)
    mask = _pen_mask(d1, has_intercept, dev)
    lip = 2.0 * reduce_rows(w @ (x * x).sum(dim=1)) / sw + reg
    lr = (1.0 / torch.clamp_min(lip, 1e-6))[:, None]
    wT = w.T
    yc = y_pm[:, None]
    regm = reg[:, None] * mask
    beta = torch.zeros((B, d1), dtype=torch.float32, device=dev)
    vel = beta
    for _ in range(max_iter):
        active = torch.clamp_min(1.0 - yc * (x @ beta.T), 0.0)     # (n, B)
        g = reduce_rows((x.T @ (wT * (-2.0 * yc * active))).T) / sw[:, None] \
            + regm * beta
        vel = 0.9 * vel - lr * g
        beta = beta + vel
    return beta


def _svc_cv_program(x: torch.Tensor, y: torch.Tensor, y_pm: torch.Tensor,
                    train_w: torch.Tensor, val_w: torch.Tensor,
                    regs: torch.Tensor, max_iter: int, has_intercept: bool,
                    metric_fn) -> List[torch.Tensor]:
    """The (grid x fold) sweep: per fold, weighted standardization with the
    fold's train weights, the grid's fits in one batch, and the metric of
    each fit's margins.  Under a mesh ``x``, ``y_pm`` and ``train_w`` hold
    this rank's rows and ``y`` / ``val_w`` every row: the margins are
    gathered before the metric.  Returns per-grid (k,) metric tensors."""
    k, g = train_w.shape[0], regs.shape[0]
    per_fold = []
    for f in range(k):
        w = train_w[f]
        sw = torch.clamp_min(reduce_rows(w.sum()), 1e-12)
        mean = reduce_rows(w @ x) / sw
        var = reduce_rows(w @ (x - mean) ** 2) / sw
        std = torch.where(var > 0, torch.sqrt(var), torch.ones_like(var))
        xs = _with_ones((x - mean) / std, has_intercept)
        betas = _svc_body(xs, y_pm, w.expand(g, -1), regs, max_iter, has_intercept)
        margins = gather_rows(xs @ betas.T, y.shape[0])
        per_fold.append(torch.stack([metric_fn(margins[:, gi].contiguous(), y,
                                               val_w[f]) for gi in range(g)]))
        del xs
    return list(torch.stack(per_fold, dim=1))


class LinearSVC(PredictionEstimatorBase):
    """Binary linear SVM (OpLinearSVC capability)."""

    reg_param = Param(default=0.0)
    max_iter = Param(default=100)
    fit_intercept = Param(default=True)
    standardize = Param(default=True)

    def _fit_arrays(self, x, y, w, device):
        icpt = bool(self.fit_intercept)
        with full_f32():
            xd, yd, wd = place_fit_arrays(x, y, w, device)
            xs, mean, std = _device_prepare_fit(xd, wd, icpt, bool(self.standardize))
            y_pm = torch.where(yd > 0.5, 1.0, -1.0)
            reg = torch.tensor([float(self.reg_param)], dtype=torch.float32,
                               device=xd.device)
            beta = _svc_body(xs, y_pm, wd[None], reg, int(self.max_iter), icpt)
        coef, intercept = _finalize_beta(beta[0], mean, std, icpt)
        return LinearSVCModel(coef=coef, intercept=intercept)

    def _cv_sweep_device(self, x, y, train_w, val_w,
                         grids: List[Dict[str, Any]], metric_fn, device):
        """The whole sweep on ``device``, or None (the generic per-grid
        sweep) when standardization is off or a grid sets anything besides
        ``reg_param``."""
        if not self.standardize or any(set(g) - {"reg_param"} for g in grids):
            return None
        mine = model_share(len(grids))  # grid points over the model axis
        with full_f32():
            sp = sweep_placements(x, y, train_w, val_w, device)
            regs = torch.tensor([float(grids[i].get("reg_param", self.reg_param))
                                 for i in mine], dtype=torch.float32, device=device)
            scores = run_cached(
                _svc_cv_program, sp.x, sp.y,
                torch.where(sp.y_rows > 0.5, 1.0, -1.0), sp.train_w,
                sp.val_w, regs, statics=dict(max_iter=int(self.max_iter),
                                             has_intercept=bool(self.fit_intercept),
                                             metric_fn=metric_fn),
                label="LinearSVC/cv_program")
        if len(mine) == len(grids):
            return scores
        k = int(np.asarray(train_w).shape[0])
        return ModelParts(scores, mine, list(range(k)), (len(grids), k))


class LinearSVCModel(PredictionModelBase):
    def __init__(self, coef: np.ndarray, intercept: float, **kw):
        super().__init__(**kw)
        self.coef = np.asarray(coef, dtype=np.float64)
        self.intercept = float(intercept)

    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        z = vec.data.astype(np.float64) @ self.coef + self.intercept
        # Spark's LinearSVC: a raw prediction only, no probability column
        return PredictionColumn((z > 0.0).astype(np.float64),
                                raw=np.column_stack([-z, z]), prob=None)

    def eval_payload_device(self, x32, device):
        with full_f32():
            return linear_eval_payload(place_rows(np.asarray(x32, np.float32), device),
                                       self.coef, self.intercept, link="identity")

    def insight_payload(self, x):
        z = linear_margin64(x, self.coef, self.intercept)
        return (z > 0.0).to(torch.float64)[:, None]
