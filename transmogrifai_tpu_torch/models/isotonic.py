"""Isotonic regression calibrator: pool-adjacent-violators over model
scores (counterpart of ``transmogrifai_tpu/models/isotonic.py``, whose
numpy code this copies).

A score feature is calibrated against the label with a monotone step
function; scoring interpolates between the knots.  PAV is sequential, so
the fit runs on the host in float64 (O(n) after the sort), and the model
scores by ``np.interp``, as in the reference.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..data.dataset import Column, Dataset
from ..stages.base import BinaryEstimator, Param, Transformer
from ..types import RealNN


def pav_fit(scores: np.ndarray, y: np.ndarray, w: np.ndarray, increasing: bool = True):
    """Weighted PAV: returns (x knots, fitted y values), both ascending in x."""
    order = np.argsort(scores, kind="stable")
    xs, ys, ws = scores[order], y[order].astype(np.float64), w[order].astype(np.float64)
    # pool tied x first (Spark averages ties before PAV) so duplicate scores with
    # different labels calibrate to their weighted mean
    ux, inv = np.unique(xs, return_inverse=True)
    if len(ux) < len(xs):
        wsum = np.bincount(inv, weights=ws)
        ysum = np.bincount(inv, weights=ys * ws)
        xs, ws = ux, wsum
        ys = ysum / np.maximum(wsum, 1e-300)
    if not increasing:
        ys = -ys
    # blocks as (sum_y*w, sum_w, x_first, x_last); merge while decreasing
    vals: List[float] = []
    wts: List[float] = []
    xfs: List[float] = []
    xls: List[float] = []
    for xi, yi, wi in zip(xs, ys, ws):
        vals.append(yi * wi)
        wts.append(wi)
        xfs.append(xi)
        xls.append(xi)
        while len(vals) > 1 and vals[-2] / wts[-2] >= vals[-1] / wts[-1]:
            v, wt, xl = vals.pop(), wts.pop(), xls.pop()
            xfs.pop()
            vals[-1] += v
            wts[-1] += wt
            xls[-1] = xl
    # each block contributes BOTH boundaries (Spark keeps block edges): every
    # training point then interpolates to its block mean exactly
    kx: List[float] = []
    ky: List[float] = []
    for v, wt, xf, xl in zip(vals, wts, xfs, xls):
        mean = v / wt
        kx.append(xf)
        ky.append(mean)
        if xl > xf:
            kx.append(xl)
            ky.append(mean)
    knots_x = np.array(kx)
    knots_y = np.array(ky)
    # np.interp needs strictly usable ascending x; nudge duplicate boundaries apart
    for i in range(1, len(knots_x)):
        if knots_x[i] <= knots_x[i - 1]:
            knots_x[i] = np.nextafter(knots_x[i - 1], np.inf)
    if not increasing:
        knots_y = -knots_y
    return knots_x, knots_y


class IsotonicRegressionCalibrator(BinaryEstimator):
    """(label RealNN, score RealNN) -> calibrated RealNN (IsotonicRegressionCalibrator)."""

    input_types = (RealNN, RealNN)
    output_type = RealNN
    allow_label_as_input = True

    increasing = Param(default=True)

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

    def fit_columns(self, cols, dataset: Dataset, device) -> Transformer:
        label_col, score_col = cols
        y = label_col.data.astype(np.float64)
        s = score_col.data.astype(np.float64)
        w = (dataset["__sample_weight__"].data.astype(np.float64)
             if "__sample_weight__" in dataset else np.ones_like(y))
        knots_x, knots_y = pav_fit(s, y, w, increasing=bool(self.increasing))
        return IsotonicCalibratorModel(knots_x=knots_x, knots_y=knots_y)


class IsotonicCalibratorModel(Transformer):
    input_types = (RealNN, RealNN)
    output_type = RealNN
    allow_label_as_input = True

    def __init__(self, knots_x: np.ndarray, knots_y: np.ndarray, **kw):
        super().__init__(**kw)
        self.knots_x = np.asarray(knots_x, dtype=np.float64)
        self.knots_y = np.asarray(knots_y, dtype=np.float64)

    def _is_label_slot(self, feature, features) -> bool:
        return feature is features[0]

    def transform(self, dataset: Dataset) -> Dataset:
        # label is absent at scoring time
        score = dataset[self.inputs[1].name]
        out = self.transform_columns([None, score], dataset)
        return dataset.with_column(self.output_name, out)

    def transform_columns(self, cols, dataset) -> Column:
        s = cols[1].data.astype(np.float64)
        cal = np.interp(s, self.knots_x, self.knots_y)
        return Column.from_values(RealNN, cal.tolist())
