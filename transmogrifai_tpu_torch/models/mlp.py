"""Multilayer perceptron classifier: full-batch Adam on the device
(counterpart of ``transmogrifai_tpu/models/mlp.py``).

The network is tanh hidden layers and a softmax head over dense products;
a fit runs a fixed number of full-batch Adam steps (200, learning rate 0.05
by default) on the weighted cross-entropy, the gradients by torch autograd,
with TF32 off (:func:`~.base.full_f32`).  Every fit is fold-batched: the
parameters carry a leading fold axis, the first layer's weights of all
folds are one ``(d, k * h)`` product over the shared feature block, the
later layers ``torch.bmm`` over folds, and the folds' losses are summed
(each fold's gradient is its own), so the CV sweep trains all folds of one
grid point as one fit, not a fit per (grid, fold).  A refit is the same
code with one fold.

The initial weights come from :func:`draw_mlp_init`, the one seam for the
draws (the reference draws them from ``jax.random``; parity runs feed its
draws there).  A fitted model scores on the host in float64 as the
reference does; :meth:`MLPClassifierModel.insight_payload` is the same
function in float64 on the device (record insights), and
:meth:`~MLPClassifierModel.eval_payload_device` the selector's train
evaluation there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Column
from ..stages.base import Param
from .base import (
    PredictionEstimatorBase,
    PredictionModelBase,
    full_f32,
    place_rows,
    softmax_probs,
)
from .prediction import PredictionColumn


def draw_mlp_init(sizes: Sequence[int], seed: int, device
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Initial (weight (sizes[i], sizes[i+1]), bias) float32 pairs of a
    network with layer ``sizes`` on ``device``: weights standard normal
    times sqrt(2 / fan-in) from a CPU generator seeded ``seed`` (the same
    draws on every device), biases zero.  The one seam for the initial
    draws: parity runs replace it with the reference's."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    out = []
    for i in range(len(sizes) - 1):
        scale = np.float32(np.sqrt(np.float32(2.0 / sizes[i])))
        w = torch.randn((sizes[i], sizes[i + 1]), generator=g,
                        dtype=torch.float32) * float(scale)
        out.append((w.to(device), torch.zeros(sizes[i + 1], dtype=torch.float32,
                                              device=device)))
    return out


def _forward_folds(params: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(k, n, C) logits of k folds' networks over the shared rows ``x``
    (n, d); ``params`` alternate (k, d_in, d_out) weights and (k, d_out)
    biases."""
    w0, b0 = params[0], params[1]
    k, d, h = w0.shape
    z = (x @ w0.permute(1, 0, 2).reshape(d, k * h)).reshape(-1, k, h) \
        .permute(1, 0, 2) + b0[:, None, :]
    for i in range(2, len(params), 2):
        z = torch.bmm(torch.tanh(z), params[i]) + params[i + 1][:, None, :]
    return z


def adam_fit(x: torch.Tensor, y_onehot: torch.Tensor, w: torch.Tensor,
             init: List[Tuple[torch.Tensor, torch.Tensor]], max_iter: int,
             lr: float) -> List[torch.Tensor]:
    """k fold fits at once: ``max_iter`` full-batch Adam steps (beta 0.9 /
    0.999, eps 1e-8) on each fold's weighted mean cross-entropy, fold f
    weighted by ``w[f]`` (w (k, n)), every fold from the same ``init``.
    Returns the parameters, (k, ...) each, detached."""
    k = w.shape[0]
    params = [p.detach().unsqueeze(0).expand(k, *p.shape).clone().requires_grad_()
              for pair in init for p in pair]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    sw = torch.clamp(w.sum(dim=1), min=1e-12)
    lr32 = float(np.float32(lr))
    for i in range(int(max_iter)):
        logp = torch.log_softmax(_forward_folds(params, x), dim=-1)
        loss = -(w * (y_onehot[None] * logp).sum(dim=-1)).sum(dim=1) / sw
        grads = torch.autograd.grad(loss.sum(), params)
        t = i + 1
        c1, c2 = float(np.float32(1 - 0.9 ** t)), float(np.float32(1 - 0.999 ** t))
        with torch.no_grad():
            for p, g, mj, vj in zip(params, grads, m, v):
                mj.mul_(0.9).add_(0.1 * g)
                vj.mul_(0.999).add_(0.001 * g * g)
                p.sub_(lr32 * (mj / c1) / (torch.sqrt(vj / c2) + 1e-8))
    return [p.detach() for p in params]


def _classes_onehot(y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    classes = np.unique(y)
    return classes, (y[:, None] == classes[None, :]).astype(np.float32)


class MultilayerPerceptronClassifier(PredictionEstimatorBase):
    """MLP classifier (OpMultilayerPerceptronClassifier capability)."""

    hidden_layers = Param(default=(10,), doc="hidden layer sizes")
    max_iter = Param(default=200)
    learning_rate = Param(default=0.05)
    seed = Param(default=42)

    def _sizes(self, d: int, n_classes: int) -> Tuple[int, ...]:
        return (int(d), *tuple(int(h) for h in self.hidden_layers), int(n_classes))

    def _fit_arrays(self, x, y, w, device):
        x32 = np.asarray(x, dtype=np.float32)
        classes, y_onehot = _classes_onehot(np.asarray(y))
        sizes = self._sizes(x32.shape[1], len(classes))
        with full_f32():
            params = adam_fit(
                place_rows(x32, device), torch.from_numpy(y_onehot).to(device),
                torch.from_numpy(np.asarray(w, np.float32))[None].to(device),
                draw_mlp_init(sizes, int(self.seed), device),
                int(self.max_iter), float(self.learning_rate))
        weights = [(params[i][0].cpu().numpy().astype(np.float64),
                    params[i + 1][0].cpu().numpy().astype(np.float64))
                   for i in range(0, len(params), 2)]
        return MLPClassifierModel(classes=classes.astype(np.float64), weights=weights)

    def _cv_sweep_device(self, x, y, train_w, val_w,
                         grids: List[Dict[str, Any]], metric_fn, device):
        """One fold-batched fit per grid point (hidden_layers change the
        network's shape); returns per-grid (k,) metric tensors."""
        allowed = {"hidden_layers", "learning_rate", "max_iter", "seed"}
        y = np.asarray(y)
        classes, y_onehot = _classes_onehot(y)
        if (any(set(g) - allowed for g in grids)
                or not np.array_equal(classes, np.arange(len(classes)))):
            return None
        x32 = np.asarray(x, np.float32)
        pending = []
        with full_f32():
            xd = place_rows(x32, device)
            yd = torch.from_numpy(y.astype(np.float32)).to(device)
            yoh = torch.from_numpy(y_onehot).to(device)
            tw = torch.from_numpy(np.asarray(train_w, np.float32)).to(device)
            vw = torch.from_numpy(np.asarray(val_w, np.float32)).to(device)
            for g in grids:
                est = self.copy().set_params(**g)
                params = adam_fit(xd, yoh, tw,
                                  draw_mlp_init(est._sizes(x32.shape[1], len(classes)),
                                                int(est.seed), device),
                                  int(est.max_iter), float(est.learning_rate))
                probs = torch.softmax(_forward_folds(params, xd), dim=-1)
                payload = probs if len(classes) > 2 else probs[..., 1]
                pending.append(torch.stack([
                    metric_fn(payload[f].contiguous(), yd, vw[f])
                    for f in range(tw.shape[0])]))
        return pending


class MLPClassifierModel(PredictionModelBase):
    def __init__(self, classes: np.ndarray, weights, **kw):
        super().__init__(**kw)
        self.classes = np.asarray(classes, dtype=np.float64)
        self.weights = [(np.asarray(wm, dtype=np.float64),
                         np.asarray(b, dtype=np.float64)) for wm, b in weights]

    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        h = vec.data.astype(np.float64)
        for wm, b in self.weights[:-1]:
            h = np.tanh(h @ wm + b)
        wm, b = self.weights[-1]
        raw = h @ wm + b
        prob = softmax_probs(raw)
        return PredictionColumn(self.classes[np.argmax(raw, axis=1)], raw, prob)

    def _logits_device(self, x: torch.Tensor) -> torch.Tensor:
        """float64 logits of rows ``x`` on their device."""
        h = x.to(torch.float64)
        for i, (wm, b) in enumerate(self.weights):
            h = h @ torch.from_numpy(wm).to(x.device) + torch.from_numpy(b).to(x.device)
            if i < len(self.weights) - 1:
                h = torch.tanh(h)
        return h

    def insight_payload(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self._logits_device(x), dim=1)

    def eval_payload_device(self, x32, device):
        if len(self.classes) != 2:
            return None
        raw = self._logits_device(place_rows(np.asarray(x32, np.float32), device))
        p1 = torch.softmax(raw, dim=1)[:, 1]
        pred = torch.from_numpy(self.classes).to(device)[torch.argmax(raw, dim=1)]
        return p1.to(torch.float32), pred.to(torch.float32)
