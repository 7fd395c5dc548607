"""Binary logistic regression: full-batch IRLS and elastic-net FISTA on
torch tensors (counterpart of ``transmogrifai_tpu/models/logistic.py``).

The reference's design, on an explicit device:

- features are standardized on the device (a final fit with the fit's
  weights, a CV sweep with unit weights over all rows -- the reference's
  asymmetry, kept) and a ones column carries the intercept, which is never
  penalized;
- pure-L2 grid points fit by weighted IRLS, a fixed ``max_iter`` Newton
  loop with no convergence check; grid points with an L1 part by FISTA on
  the exact elastic-net objective, ``max(10 * max_iter, 300)`` steps;
- a CV sweep fits every (grid, fold) pair at once.  The reference vmaps the
  fit; here the pairs are the columns of one product a step: the margins of
  all fits are ``X @ B`` and their gradients ``X^T @ R``, so a step reads
  the row block twice whatever the number of fits.  Only IRLS's Hessians,
  one (d, d) product per fit, go one fit at a time, which keeps the
  temporary at one (n, d) block.  Newton solves are batched
  (``torch.linalg.solve_ex``, which does not wait for the device).

Products run in full float32 (TF32 off, :func:`~.base.full_f32`): the
reference's parity record is its float32 CPU path.
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
    eval_linear_sweep,
    full_f32,
    linear_eval_payload,
    place_rows,
)
from .prediction import PredictionColumn

MAX_ITER_DEFAULT = 30
#: power-iteration steps of FISTA's Lipschitz bound
POWER_STEPS = 30


def _pen_mask(d1: int, has_intercept: bool, device) -> torch.Tensor:
    """1 for a penalized column, 0 for the intercept's ones column."""
    mask = torch.ones(d1, dtype=torch.float32, device=device)
    if has_intercept:
        mask[-1] = 0.0
    return mask


def _irls_core(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               reg: torch.Tensor, max_iter: int,
               has_intercept: bool = True) -> torch.Tensor:
    """Weighted L2-regularized IRLS of B fits on pre-standardized features.

    x (n, d1), a trailing ones column when ``has_intercept``; y (n,); w (B, n)
    each fit's row weights; reg (B,).  Objective of a fit:
    (1/sum w) sum w_i logloss_i + reg/2 ||beta_penalized||^2.  The Hessian is
    the reference's bordered system

        H = [[X^T S X, X^T S 1], [1^T S X, sum S]] / sw + diag(reg*mask + 1e-8)

    with S = max(w p (1-p), 1e-10).  Returns betas (B, d1)."""
    n, d1 = x.shape
    B = w.shape[0]
    dev = x.device
    sw = torch.clamp_min(w.sum(dim=1), 1e-12)
    mask = _pen_mask(d1, has_intercept, dev)
    xf = x[:, :-1] if has_intercept else x
    d = xf.shape[1]
    wT = w.T
    ridge = torch.diag_embed(reg[:, None] * mask[None, :] + 1e-8)
    beta = torch.zeros((B, d1), dtype=torch.float32, device=dev)
    for _ in range(max_iter):
        p = torch.sigmoid(x @ beta.T)                          # (n, B)
        g = (x.T @ (wT * (p - y[:, None]))).T / sw[:, None] \
            + reg[:, None] * mask * beta
        s = torch.clamp_min(wT * p * (1.0 - p), 1e-10)
        h = torch.empty((B, d1, d1), dtype=torch.float32, device=dev)
        for b in range(B):
            h[b, :d, :d] = xf.T @ (xf * s[:, b:b + 1])
        if has_intercept:
            hxb = (xf.T @ s).T                                 # (B, d)
            h[:, :d, d] = hxb
            h[:, d, :d] = hxb
            h[:, d, d] = s.sum(dim=0)
        h = h / sw[:, None, None] + ridge
        beta = beta - torch.linalg.solve_ex(h, g)[0]
    return beta


def _fista_momentum(steps: int) -> List[float]:
    """FISTA's (t_k - 1) / t_{k+1}, with t updated in float32 from 1."""
    out, t = [], np.float32(1.0)
    for _ in range(steps):
        t_new = np.float32(0.5) * (np.float32(1.0)
                                   + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return out


def _fista_elastic(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   l1: torch.Tensor, l2: torch.Tensor, max_iter: int,
                   has_intercept: bool = True) -> torch.Tensor:
    """Exact elastic-net logistic fits of B problems: FISTA with a
    soft-threshold prox.  Objective: (1/sw) sum w_i logloss_i
    + l1 ||beta_1||_1 + l2/2 ||beta_1||^2, the intercept never penalized.
    Step 1 / (lambda_max(X^T W X / sw)/4 + l2), lambda_max by power
    iteration from ones/sqrt(d1).  x (n, d1); w (B, n); l1, l2 (B,).
    Returns betas (B, d1)."""
    n, d1 = x.shape
    B = w.shape[0]
    dev = x.device
    sw = torch.clamp_min(w.sum(dim=1), 1e-12)
    pen = _pen_mask(d1, has_intercept, dev)
    wT = w.T

    def quad(v):                                               # (B, d1)
        return (x.T @ (wT * (x @ v.T))).T / sw[:, None]

    v = torch.ones((B, d1), dtype=torch.float32, device=dev) \
        / torch.sqrt(torch.tensor(float(d1), dtype=torch.float32))
    for _ in range(POWER_STEPS):
        u = quad(v)
        v = u / (torch.linalg.vector_norm(u, dim=1, keepdim=True) + 1e-12)
    lmax = (v * quad(v)).sum(dim=1)
    step = (1.0 / (0.25 * lmax + l2 + 1e-12))[:, None]
    thr = step * l1[:, None] * pen
    l2p = l2[:, None] * pen
    b = torch.zeros((B, d1), dtype=torch.float32, device=dev)
    z = b
    for mom in _fista_momentum(max_iter):
        p = torch.sigmoid(x @ z.T)
        g = (x.T @ (wT * (p - y[:, None]))).T / sw[:, None] + l2p * z
        u = z - step * g
        b_new = torch.sign(u) * torch.clamp_min(u.abs() - thr, 0.0)
        z = b_new + mom * (b_new - b)
        b = b_new
    return b


def _irls_sweep(x, y, train_w, regs, max_iter, has_intercept=True):
    """IRLS over the (grid x fold) pairs: train_w (k, n), regs (g,) ->
    betas (g, k, d1)."""
    g, k = regs.shape[0], train_w.shape[0]
    betas = _irls_core(x, y, train_w.repeat(g, 1), regs.repeat_interleave(k),
                       max_iter, has_intercept)
    return betas.reshape(g, k, -1)


def _fista_sweep(x, y, train_w, l1s, l2s, max_iter, has_intercept=True):
    """FISTA over the (grid x fold) pairs: train_w (k, n), l1s, l2s (g,) ->
    betas (g, k, d1)."""
    g, k = l1s.shape[0], train_w.shape[0]
    betas = _fista_elastic(x, y, train_w.repeat(g, 1), l1s.repeat_interleave(k),
                           l2s.repeat_interleave(k), max_iter, has_intercept)
    return betas.reshape(g, k, -1)


def _with_ones(xs: torch.Tensor, has_intercept: bool) -> torch.Tensor:
    if not has_intercept:
        return xs.contiguous()
    return torch.cat([xs, torch.ones((xs.shape[0], 1), dtype=xs.dtype,
                                     device=xs.device)], dim=1)


def _device_prepare_fit(x: torch.Tensor, w: torch.Tensor, has_intercept: bool,
                        standardize: bool):
    """Weighted standardization for a final fit (a std under 1e-12 counts
    as 1), then the ones column.  Returns (xs, mean, std)."""
    d = x.shape[1]
    if standardize:
        sw = torch.clamp_min(w.sum(), 1e-12)
        mean = (w @ x) / sw
        var = (w @ (x - mean) ** 2) / sw
        std = torch.sqrt(var)
        std = torch.where(std < 1e-12, torch.ones_like(std), std)
    else:
        mean = torch.zeros(d, dtype=x.dtype, device=x.device)
        std = torch.ones(d, dtype=x.dtype, device=x.device)
    return _with_ones((x - mean) / std, has_intercept), mean, std


def _device_prepare(x: torch.Tensor, has_intercept: bool,
                    standardize: bool) -> torch.Tensor:
    """Unit-weight standardization over every row for a CV sweep (a std
    under 1e-12 counts as 1), then the ones column."""
    if standardize:
        n = x.shape[0]
        mean = x.sum(dim=0) / n
        var = ((x - mean) ** 2).sum(dim=0) / n
        std = torch.sqrt(var)
        std = torch.where(std < 1e-12, torch.ones_like(std), std)
        x = (x - mean) / std
    return _with_ones(x, has_intercept)


def _fit_tensors(x, y, w, device):
    """(x, y, w) of a final fit on ``device``: the feature block through the
    shared placement (a refit reuses the block its sweep placed)."""
    xd = place_rows(np.asarray(x, np.float32), device)
    yd = torch.from_numpy(np.asarray(y, np.float32)).to(device)
    wd = torch.from_numpy(np.asarray(w, np.float32)).to(device)
    return xd, yd, wd


def _finalize_beta(beta: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                   fit_intercept: bool):
    """Standardized beta back to raw-space coefficients and intercept:
    float32 on the host, then float64."""
    beta, mean, std = (t.cpu().numpy() for t in (beta, mean, std))
    coef_s, b0 = (beta[:-1], beta[-1]) if fit_intercept else (beta, 0.0)
    coef = coef_s / std
    intercept = float(b0 - (coef * mean).sum())
    return coef.astype(np.float64), intercept


class LogisticRegression(PredictionEstimatorBase):
    """Binary logistic regression estimator (OpLogisticRegression capability)."""

    reg_param = Param(default=0.0)
    elastic_net = Param(default=0.0)
    max_iter = Param(default=MAX_ITER_DEFAULT)
    fit_intercept = Param(default=True)
    standardize = Param(default=True)

    def _effective_reg(self) -> float:
        return float(self.reg_param) * (1.0 - float(self.elastic_net))

    def _fit_arrays(self, x, y, w, device):
        icpt = bool(self.fit_intercept)
        with full_f32():
            xd, yd, wd = _fit_tensors(x, y, w, device)
            xs, mean, std = _device_prepare_fit(xd, wd, icpt, bool(self.standardize))
            l1 = float(self.reg_param) * float(self.elastic_net)
            one = lambda v: torch.tensor([v], dtype=torch.float32, device=xd.device)  # noqa: E731
            if l1 > 0.0:
                beta = _fista_elastic(xs, yd, wd[None], one(l1),
                                      one(self._effective_reg()),
                                      max(10 * int(self.max_iter), 300), icpt)
            else:
                beta = _irls_core(xs, yd, wd[None], one(self._effective_reg()),
                                  int(self.max_iter), icpt)
        coef, intercept = _finalize_beta(beta[0], mean, std, icpt)
        return LogisticRegressionModel(coef=coef, intercept=intercept)

    def _cv_sweep_device(self, x, y, train_w, val_w,
                         grids: List[Dict[str, Any]], metric_fn, device):
        """The (grid x fold) sweep on ``device``: pure-L2 grid points by IRLS,
        the rest (l1 > 0) by FISTA, every pair of a solver in one batched
        fit, then the linear eval sweep.  Returns per-grid (k,) metric
        tensors, not waited for."""
        l1l2 = []
        for g in grids:
            rp = float(g.get("reg_param", self.reg_param))
            en = float(g.get("elastic_net", self.elastic_net))
            l1l2.append((rp * en, rp * (1.0 - en)))
        # every grid point goes to a solver: a non-positive l1 (a typo'd
        # negative included) takes the smooth IRLS path
        l2_idx = [i for i, (l1, _) in enumerate(l1l2) if l1 <= 0.0]
        en_idx = [i for i, (l1, _) in enumerate(l1l2) if l1 > 0.0]
        icpt = bool(self.fit_intercept)

        def vec(vals):
            return torch.tensor(vals, dtype=torch.float32, device=device)

        with full_f32():
            xd = _device_prepare(place_rows(np.asarray(x, np.float32), device),
                                 icpt, bool(self.standardize))
            yd = torch.from_numpy(np.asarray(y, np.float32)).to(device)
            tw = torch.from_numpy(np.asarray(train_w, np.float32)).to(device)
            vw = torch.from_numpy(np.asarray(val_w, np.float32)).to(device)
            betas = torch.zeros((len(grids), tw.shape[0], xd.shape[1]),
                                dtype=torch.float32, device=device)
            if l2_idx:
                betas[l2_idx] = _irls_sweep(
                    xd, yd, tw, vec([l1l2[i][1] for i in l2_idx]),
                    int(self.max_iter), icpt)
            if en_idx:
                betas[en_idx] = _fista_sweep(
                    xd, yd, tw, vec([l1l2[i][0] for i in en_idx]),
                    vec([l1l2[i][1] for i in en_idx]),
                    max(10 * int(self.max_iter), 300), icpt)
            return eval_linear_sweep(xd, yd, betas, vw, metric_fn, link="sigmoid")


class LogisticRegressionModel(PredictionModelBase):
    def __init__(self, coef: np.ndarray, intercept: float, **kw):
        super().__init__(**kw)
        self.coef = np.asarray(coef, dtype=np.float64)
        self.intercept = float(intercept)

    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        z = vec.data.astype(np.float64) @ self.coef + self.intercept
        p1 = 1.0 / (1.0 + np.exp(-z))
        prob = np.column_stack([1.0 - p1, p1])
        raw = np.column_stack([-z, z])
        return PredictionColumn.classification(raw, prob)

    def eval_payload_device(self, x32, device):
        with full_f32():
            return linear_eval_payload(place_rows(np.asarray(x32, np.float32), device),
                                       self.coef, self.intercept, link="sigmoid")

