"""Model stage bases: (label RealNN, features OPVector) -> Prediction.

Counterpart of ``transmogrifai_tpu/models/base.py``.  A fitted model's
``predict_column`` scores on the host in float64 numpy (the serving head), or
on a device for large batches where the model has a device path.  Estimators
fit on the device their ``fit`` was given; families that implement
``_cv_sweep_device`` run a whole (grid x fold) sweep there and hand back the
per-fold metrics as device tensors, so the validator can launch every family
before it reads any result.  A family (or a grid) without one takes the
generic sweep, one fit per (grid, fold), as in the reference.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import numpy as np
import torch

from ..data.dataset import Column, Dataset
from ..stages.base import Estimator, Transformer
from ..types import OPVector, Prediction, RealNN
from .prediction import PredictionColumn

#: (stamp of a host block, device) -> (block, device tensor): the selector's
#: families and its refit share one copy of the feature block per device
_PLACED: Dict[tuple, tuple] = {}
_PLACED_MAX = 2


def _stamp(x: np.ndarray) -> tuple:
    step = max(1, x.shape[0] // 64)
    return (id(x), x.shape, str(x.dtype), hash(x[::step].tobytes()))


def place_rows(x32: np.ndarray, device) -> torch.Tensor:
    """``x32`` on ``device``, copied once per (block, device) and reused."""
    key = (_stamp(x32), str(torch.device(device)))
    hit = _PLACED.get(key)
    if hit is not None and hit[0] is x32:
        return hit[1]
    t = torch.from_numpy(np.ascontiguousarray(x32)).to(device)
    _PLACED[key] = (x32, t)
    while len(_PLACED) > _PLACED_MAX:
        _PLACED.pop(next(iter(_PLACED)))
    return t


def sweep_tensors(x, y, train_w, val_w, device):
    """(x, y, train_w, val_w) of a CV sweep as float32 tensors on ``device``,
    the feature block through the shared placement."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return place_rows(np.asarray(x, np.float32), device), t(y), t(train_w), t(val_w)


def gather_scores(pending) -> np.ndarray:
    """Host copy of a pending sweep result: a list of per-grid (k,) device
    tensors (this is where the host waits for the sweep)."""
    return np.stack([p.detach().cpu().numpy().astype(np.float64)
                     for p in pending])


@contextlib.contextmanager
def full_f32():
    """float32 matrix products in full precision (TF32 off) inside the
    block: the linear fits are held to the reference's float32 CPU path."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def softmax_probs(raw: np.ndarray) -> np.ndarray:
    """Row softmax of host logits or log-likelihoods, shifted by the row
    maximum (the multiclass heads' probabilities)."""
    m = raw.max(axis=1, keepdims=True)
    e = np.exp(raw - m)
    return e / e.sum(axis=1, keepdims=True)


def _link(z: torch.Tensor, link: str) -> torch.Tensor:
    return torch.sigmoid(z) if link == "sigmoid" else z


def eval_linear_sweep(xd: torch.Tensor, yd: torch.Tensor, betas: torch.Tensor,
                      vw: torch.Tensor, metric_fn, link: str = "identity"):
    """Metric per (grid, fold) of a linear family's sweep: margins of every
    (grid, fold) beta in one product, mapped by ``link`` ("sigmoid" for
    logistic probabilities, "identity" for margins), each scored with its
    fold's validation weights.  betas (g, k, d); vw (k, n).  Returns a list
    of per-grid (k,) tensors."""
    g, k, d1 = betas.shape
    scores = _link(xd @ betas.reshape(g * k, d1).T, link)
    return [torch.stack([metric_fn(scores[:, gi * k + f].contiguous(), yd, vw[f])
                         for f in range(k)]) for gi in range(g)]


def eval_softmax_sweep(xd: torch.Tensor, yd: torch.Tensor, bs: torch.Tensor,
                       vw: torch.Tensor, metric_fn):
    """Metric per (grid, fold) of a multiclass linear sweep: the logits of
    every (grid, fold) weight matrix in one product, a softmax per fit, each
    (n, C) probability matrix scored with its fold's validation weights.
    bs (g, k, d, C); vw (k, n).  Returns a list of per-grid (k,) tensors."""
    g, k, d1, c = bs.shape
    logits = xd @ bs.permute(2, 0, 1, 3).reshape(d1, g * k * c)
    probs = torch.softmax(logits.reshape(-1, g * k, c), dim=-1)
    return [torch.stack([metric_fn(probs[:, gi * k + f], yd, vw[f])
                         for f in range(k)]) for gi in range(g)]


def linear_margin64(x: torch.Tensor, coef: np.ndarray, intercept) -> torch.Tensor:
    """float64 ``x @ coef + intercept`` on ``x``'s device (the linear heads'
    host formula)."""
    c = torch.from_numpy(np.asarray(coef, np.float64)).to(x.device)
    b = torch.from_numpy(np.asarray(intercept, np.float64)).to(x.device)
    return x.to(torch.float64) @ c + b


def linear_eval_payload(xd: torch.Tensor, coef: np.ndarray, intercept: float,
                        link: str):
    """(score, prediction) float32 tensors of a linear head over ``xd``."""
    z = xd @ torch.from_numpy(np.asarray(coef, np.float32)).to(xd.device) \
        + float(np.float32(intercept))
    return _link(z, link), (z > 0).to(torch.float32)


class PredictionModelBase(Transformer):
    """Fitted model transformer: scores the feature vector; the label input
    may be absent."""

    input_types = (RealNN, OPVector)
    output_type = Prediction
    allow_label_as_input = True
    #: ``transform`` takes the device large batches may score on
    scores_on_device = True

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        raise NotImplementedError

    def eval_payload_device(self, x32: np.ndarray, device):
        """(score, prediction) 1-D float32 tensors on ``device`` for the
        selector's train evaluation, or None when the model has no device
        scoring path."""
        return None

    def insight_payload(self, x: torch.Tensor) -> torch.Tensor:
        """The record insights' payload of the rows ``x`` (a tensor on any
        device), on that device: the class probabilities, else the
        prediction as one column, in float64 -- the function
        ``predict_column`` computes on the host (``insights/loco.py``)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no device scorer for record insights")

    def transform(self, dataset: Dataset, device=None) -> Dataset:
        vec = dataset[self.inputs[1].name]
        return dataset.with_column(self.output_name,
                                   self.predict_column(vec, device))

    def transform_columns(self, cols, dataset):
        return self.predict_column(cols[-1])


class PredictionEstimatorBase(Estimator):
    input_types = (RealNN, OPVector)
    output_type = Prediction
    allow_label_as_input = True

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

    def fit_columns(self, cols, dataset, device):
        label, vec = cols
        x = np.asarray(vec.data, np.float32)
        y = np.asarray(label.data, np.float32)
        w = np.asarray(dataset["__sample_weight__"].data, np.float32) \
            if "__sample_weight__" in dataset else np.ones_like(y)
        return self._fit_arrays(x, y, w, device)

    def _fit_arrays(self, x: np.ndarray, y: np.ndarray, w: np.ndarray,
                    device) -> PredictionModelBase:
        raise NotImplementedError

    # --- sweep protocol ------------------------------------------------------
    def _cv_sweep_device(self, x, y, train_w, val_w,
                         grids: List[Dict[str, Any]], metric_fn, device):
        """Launch this family's whole (grid x fold) sweep without waiting;
        returns a list of per-grid (k,) metric tensors, or None when the
        family has no sweep."""
        return None

    def cv_sweep(self, x, y, train_w, val_w, grids, metric_fn,
                 device) -> np.ndarray:
        """Metric per (grid, fold), blocking."""
        return self.cv_sweep_async(x, y, train_w, val_w, grids, metric_fn,
                                   device)()

    def cv_sweep_async(self, x, y, train_w, val_w, grids, metric_fn, device):
        """Launch the sweep and return a zero-argument gather -> (g, k); a
        family without a device sweep computes the generic one now (its
        gather only returns it)."""
        pending = self._cv_sweep_device(x, y, train_w, val_w, grids,
                                        metric_fn, device)
        if pending is not None:
            return lambda: gather_scores(pending)
        scores = self._cv_sweep_generic(x, y, train_w, val_w, grids,
                                        metric_fn, device)
        return lambda: scores

    def _cv_sweep_generic(self, x, y, train_w, val_w,
                          grids: List[Dict[str, Any]], metric_fn,
                          device) -> np.ndarray:
        """One fit per (grid, fold) on the fold's train weights, scored on
        every row and evaluated with the fold's validation weights."""
        k = train_w.shape[0]
        out = np.zeros((len(grids), k))
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(device)
        vec = Column.vector(np.asarray(x, np.float32))
        for gi, grid in enumerate(grids):
            est = self.copy().set_params(**grid)
            for f in range(k):
                col = est._fit_arrays(x, y, train_w[f], device) \
                    .predict_column(vec, device)
                payload = col.prob if col.prob is not None \
                    and col.prob.shape[1] > 2 else col.score
                out[gi, f] = float(metric_fn(
                    torch.from_numpy(np.asarray(payload, np.float32)).to(device),
                    yd, torch.from_numpy(np.asarray(val_w[f], np.float32)).to(device)))
        return out
