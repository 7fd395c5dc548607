"""Generalized linear regression by IRLS on torch tensors (counterpart of
``transmogrifai_tpu/models/glm.py``).

Families and links are the reference's: gaussian (identity: one solve),
binomial (logit) and poisson (log), canonical, and gamma with the
non-canonical log link, whose working weights are the row weights and whose
working response is eta + (y - mu) / mu.  A step solves

    (X^T S X + diag(reg * mask + 1e-8) * sum S) beta = X^T S z

for working weights S and response z, the intercept's ones column left out
of the L2 term; ``max_iter`` steps from zero, no convergence test.  A CV
sweep advances every (grid, fold) fit of a family together: one product for
all margins, one for all right-hand sides and one batched solve a step; the
Hessians are one (d, d) product a fit (a fold, where S does not depend on
the fit).  Products run in full float32 (TF32 off).
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
    linear_margin64,
    place_fit_arrays,
    sweep_placements,
)
from .linear import weighted_grams
from .logistic import _pen_mask, _with_ones
from .prediction import PredictionColumn

FAMILIES = ("gaussian", "binomial", "poisson", "gamma")


def inv_link(family: str, eta: torch.Tensor) -> torch.Tensor:
    """The mean of ``family`` at linear predictor ``eta``."""
    if family == "gaussian":
        return eta
    if family == "binomial":
        return torch.sigmoid(eta)
    if family in ("poisson", "gamma"):
        return torch.exp(eta)
    raise ValueError(f"Unknown family {family!r}; expected one of {FAMILIES}")


def _glm_irls(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              fold: List[int], regs: torch.Tensor, family: str, max_iter: int,
              has_intercept: bool) -> torch.Tensor:
    """IRLS of B fits: x (n, d1), y (n,), w (k, n) the folds' row weights,
    ``fold[b]`` fit b's fold, regs (B,).  Returns betas (B, d1)."""
    n, d1 = x.shape
    B = len(fold)
    wf = w[fold]                                             # (B, n)
    diag = regs[:, None] * _pen_mask(d1, has_intercept, x.device)[None, :] + 1e-8
    beta = torch.zeros((B, d1), dtype=torch.float32, device=x.device)
    fixed = None
    for _ in range(max_iter):
        eta = (x @ beta.T).T                                 # (B, n)
        mu = inv_link(family, eta)
        if family == "gaussian":
            z, s = y[None, :].expand(B, n), wf
        elif family == "gamma":
            z, s = eta + (y[None, :] - mu) / torch.clamp_min(mu, 1e-8), wf
        else:
            v = torch.clamp_min(mu * (1.0 - mu) if family == "binomial" else mu, 1e-8)
            z, s = eta + (y[None, :] - mu) / v, wf * v
        if family in ("gaussian", "gamma"):
            if fixed is None:                                # S = the fold's weights
                fixed = weighted_grams(x, w)[fold]
            grams = fixed
        else:
            grams = weighted_grams(x, s)
        a = grams + torch.diag_embed(diag) * s.sum(dim=1)[:, None, None]
        rhs = (x.T @ (s * z).T).T
        beta = torch.linalg.solve_ex(a, rhs[..., None])[0][..., 0]
    return beta


def _iters(family: str, max_iter) -> int:
    """gaussian's IRLS converges in one solve."""
    return 1 if family == "gaussian" else int(max_iter)


def _support(family: str, y: torch.Tensor) -> torch.Tensor:
    """poisson and gamma fit (and the sweep scores against) y >= 1e-8."""
    return torch.clamp_min(y, 1e-8) if family in ("poisson", "gamma") else y


class GeneralizedLinearRegression(PredictionEstimatorBase):
    """OpGeneralizedLinearRegression capability."""

    family = Param(default="gaussian", validator=lambda v: v in FAMILIES)
    reg_param = Param(default=0.0)
    max_iter = Param(default=25)
    fit_intercept = Param(default=True)

    def _fit_arrays(self, x, y, w, device):
        icpt = bool(self.fit_intercept)
        family = str(self.family)
        with full_f32():
            xd, yd, wd = place_fit_arrays(x, y, w, device, shard=False)
            xd = _with_ones(xd, icpt)
            regs = torch.tensor([float(self.reg_param)], dtype=torch.float32,
                                device=device)
            beta = _glm_irls(xd, _support(family, yd), wd[None], [0], regs, family,  # opcheck: allow(TM301) the fit's one fetch of its coefficients
                             _iters(family, self.max_iter), icpt)[0].cpu().numpy()
        if icpt:
            coef, intercept = beta[:-1], float(beta[-1])
        else:
            coef, intercept = beta, 0.0
        return GLMModel(coef=coef.astype(np.float64), intercept=intercept,
                        family=family)

    def _cv_sweep_device(self, x, y, train_w, val_w,
                         grids: List[Dict[str, Any]], metric_fn, device):
        """Every (grid, fold) fit of each family in the grid advanced
        together; per-grid (k,) metric tensors, not waited for.  A grid
        setting another parameter takes the generic sweep."""
        if any(set(g) - {"reg_param", "family"} for g in grids):
            return None
        icpt = bool(self.fit_intercept)
        k = train_w.shape[0]
        by_family: Dict[str, List[int]] = {}
        for i, g in enumerate(grids):
            by_family.setdefault(str(g.get("family", self.family)), []).append(i)
        out: List[torch.Tensor] = [None] * len(grids)
        with full_f32():
            sp = sweep_placements(x, y, train_w, val_w, device, shard=False)
            xd, yd, tw, vw = sp.x, sp.y, sp.train_w, sp.val_w
            xd = _with_ones(xd, icpt)
            for family, idxs in by_family.items():
                y_fam = _support(family, yd)
                regs = torch.tensor([float(grids[i].get("reg_param", self.reg_param))
                                     for i in idxs for _ in range(k)],
                                    dtype=torch.float32, device=device)
                betas = _glm_irls(xd, y_fam, tw, list(range(k)) * len(idxs), regs,
                                  family, _iters(family, self.max_iter), icpt)
                mu = inv_link(family, xd @ betas.T)          # (n, len(idxs) * k)
                for j, i in enumerate(idxs):
                    out[i] = torch.stack([metric_fn(mu[:, j * k + f].contiguous(),
                                                    y_fam, vw[f]) for f in range(k)])
        return out


class GLMModel(PredictionModelBase):
    def __init__(self, coef: np.ndarray, intercept: float, family: str = "gaussian",
                 **kw):
        super().__init__(**kw)
        self.coef = np.asarray(coef, dtype=np.float64)
        self.intercept = float(intercept)
        self.family = family

    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        eta = vec.data.astype(np.float64) @ self.coef + self.intercept
        if self.family == "binomial":
            mu = 1.0 / (1.0 + np.exp(-eta))
        elif self.family in ("poisson", "gamma"):
            mu = np.exp(np.clip(eta, -30, 30))
        else:
            mu = eta
        return PredictionColumn.regression(mu)

    def insight_payload(self, x):
        eta = linear_margin64(x, self.coef, self.intercept)
        if self.family == "binomial":
            mu = 1.0 / (1.0 + torch.exp(-eta))
        elif self.family in ("poisson", "gamma"):
            mu = torch.exp(torch.clamp(eta, -30, 30))
        else:
            mu = eta
        return mu[:, None]
