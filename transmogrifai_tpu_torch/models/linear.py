"""Linear regression: weighted ridge by its normal equations on torch tensors
(counterpart of ``transmogrifai_tpu/models/linear.py``).

The features are not standardized; a ones column carries the intercept,
which the L2 term leaves out.  A fit solves

    (X^T W X / sw + diag(reg * mask + 1e-9)) beta = X^T W y / sw

A CV sweep forms one weighted Gram matrix per fold (the grid changes only
the diagonal) and solves every (grid, fold) system in one batched solve.
Products run in full float32 (TF32 off), as the reference's float32 CPU
path does.
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
    eval_linear_sweep,
    full_f32,
    linear_margin64,
    ModelParts,
    place_fit_arrays,
    sweep_placements,
)
from ..parallel.mesh import model_share, reduce_rows
from .logistic import _pen_mask, _with_ones
from .prediction import PredictionColumn


def weighted_grams(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, d1, d1) products X^T diag(w_b) X, one per row of w (B, n)."""
    return torch.stack([(x.T * wb) @ x for wb in w])


def _ridge_sweep(x: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor,
                 regs: torch.Tensor, has_intercept: bool) -> torch.Tensor:
    """Ridge betas of every (grid, fold): train_w (k, n), regs (g,) ->
    (g, k, d1).  Under a mesh the rows are this rank's and the normal
    equations' sums cross the ``data`` group."""
    g, (k, d1) = regs.shape[0], (train_w.shape[0], x.shape[1])
    sw = torch.clamp_min(reduce_rows(train_w.sum(dim=1)), 1e-12)
    grams = reduce_rows(weighted_grams(x, train_w)) / sw[:, None, None]
    rhs = reduce_rows((x.T @ (train_w * y[None, :]).T).T) / sw[:, None]
    diag = regs[:, None] * _pen_mask(d1, has_intercept, x.device)[None, :] + 1e-9
    h = grams[None] + torch.diag_embed(diag)[:, None]
    return torch.linalg.solve_ex(h, rhs[None].expand(g, k, d1)[..., None])[0][..., 0]


class LinearRegression(PredictionEstimatorBase):
    """OpLinearRegression capability: weighted ridge (``elastic_net`` only
    scales the L2 part, as in the reference)."""

    reg_param = Param(default=0.0)
    elastic_net = Param(default=0.0)
    fit_intercept = Param(default=True)

    def _l2(self, grid: Dict[str, Any]) -> float:
        return float(grid.get("reg_param", self.reg_param)) \
            * (1.0 - float(grid.get("elastic_net", self.elastic_net)))

    def _fit_arrays(self, x, y, w, device):
        icpt = bool(self.fit_intercept)
        with full_f32():
            xd, yd, wd = place_fit_arrays(x, y, w, device)
            regs = torch.tensor([self._l2({})], dtype=torch.float32, device=device)
            beta = _ridge_sweep(_with_ones(xd, icpt), yd, wd[None], regs,  # opcheck: allow(TM301) the fit's one fetch of its coefficients
                                icpt)[0, 0].cpu().numpy()
        if icpt:
            return LinearRegressionModel(coef=beta[:-1].astype(np.float64),
                                         intercept=float(beta[-1]))
        return LinearRegressionModel(coef=beta.astype(np.float64), intercept=0.0)

    def _cv_sweep_device(self, x, y, train_w, val_w,
                         grids: List[Dict[str, Any]], metric_fn, device):
        icpt = bool(self.fit_intercept)
        mine = model_share(len(grids))  # grid points over the model axis
        with full_f32():
            sp = sweep_placements(x, y, train_w, val_w, device)
            xd = _with_ones(sp.x, icpt)
            regs = torch.tensor([self._l2(grids[i]) for i in mine],
                                dtype=torch.float32, device=device)
            betas = run_cached(_ridge_sweep, xd, sp.y_rows, sp.train_w, regs,
                               statics=dict(has_intercept=icpt),
                               label="LinearRegression/ridge_sweep")
            scores = run_cached(eval_linear_sweep, xd, sp.y, betas, sp.val_w,
                                statics=dict(metric_fn=metric_fn, link="identity"),
                                label="LinearRegression/eval_sweep")
        if len(mine) == len(grids):
            return scores
        k = int(np.asarray(train_w).shape[0])
        return ModelParts(scores, mine, list(range(k)), (len(grids), k))


class LinearRegressionModel(PredictionModelBase):
    def __init__(self, coef: np.ndarray, intercept: float, **kw):
        super().__init__(**kw)
        self.coef = np.asarray(coef, dtype=np.float64)
        self.intercept = float(intercept)

    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        return PredictionColumn.regression(
            vec.data.astype(np.float64) @ self.coef + self.intercept)

    def insight_payload(self, x):
        return linear_margin64(x, self.coef, self.intercept)[:, None]
