"""The port's regression, multiclass, forecast and bin-score evaluators and
the binary threshold curves against the JAX package's, on the CPU.

Same seeded numpy inputs through both packages' metric functions and
evaluator classes, with weights (zeros among them), tied scores and a 1-D
multiclass payload (a model's binary path).  Tolerances: the float32 device
metrics within 1e-6 relative (the sums run in the reference's windows of 32
over other padding: the reference pads its rows to a bucket), the host
float64 suites (multiclass, forecast, bin score) equal to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.evaluators import base as JB
from transmogrifai_tpu.evaluators import metrics as JM
from transmogrifai_tpu.models.prediction import PredictionColumn as JPred
from transmogrifai_tpu_torch.evaluators import base as TB
from transmogrifai_tpu_torch.evaluators import metrics as TM
from transmogrifai_tpu_torch.models.prediction import PredictionColumn as TPred


def _weights(n, rng, zeros=True):
    w = rng.uniform(0.2, 2.0, n).astype(np.float32)
    if zeros:
        w[::7] = 0.0
    return w


def _regression(n=777, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=n).astype(np.float32) * 3
    pred = (y + rng.normal(size=n) * 0.7).astype(np.float32)
    pred[::11] = y[::11]                             # exact hits
    return pred, y, _weights(n, rng)


def _multiclass(n=900, c=5, seed=1):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, c))
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    prob[::9] = 1.0 / c                              # ties: argmax takes the first
    y = rng.integers(0, c, n).astype(np.float64)
    return prob, y


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


class TestRegressionMetrics:
    @pytest.mark.parametrize("name", ["rmse", "mse", "mae", "r2", "smape"])
    @pytest.mark.parametrize("n", [1, 31, 777, 4099])
    def test_metric_equals_reference(self, name, n):
        pred, y, w = _regression(n, seed=n)
        want = float(JM.METRICS_REGRESSION[name](jnp.asarray(pred), jnp.asarray(y),
                                                 jnp.asarray(w)))
        got = float(TM.METRICS_REGRESSION[name](*(torch.from_numpy(a) for a in (pred, y, w))))
        _close(got, want)

    def test_summary_and_evaluator_equal_reference(self):
        pred, y, w = _regression()
        ref = JB.RegressionEvaluator().evaluate_arrays(
            y.astype(np.float64), JPred.regression(pred), w.astype(np.float64))
        got = TB.RegressionEvaluator().evaluate_arrays(
            y.astype(np.float64), TPred.regression(pred), w.astype(np.float64))
        assert list(got) == list(ref)
        for k in ref:
            _close(got[k], ref[k])

    @pytest.mark.parametrize("period", [1, 4])
    def test_forecast_evaluator_equals_reference(self, period):
        pred, y, _ = _regression(300, seed=period)
        ref = JB.Evaluators.forecast("smape", period).evaluate_arrays(
            y.astype(np.float64), JPred.regression(pred))
        got = TB.Evaluators.forecast("smape", period).evaluate_arrays(
            y.astype(np.float64), TPred.regression(pred))
        assert set(got) == set(ref) >= {"mase", "seasonalError"}
        for k in ref:
            _close(got[k], ref[k])


class TestMulticlass:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_error_on_probabilities_equals_reference(self, weighted):
        prob, y = _multiclass()
        w = _weights(len(y), np.random.default_rng(2)) if weighted \
            else np.ones(len(y), np.float32)
        want = float(JM.multiclass_error(jnp.asarray(prob, jnp.float32),
                                         jnp.asarray(y, jnp.float32), jnp.asarray(w)))
        got = float(TM.multiclass_error(torch.from_numpy(prob.astype(np.float32)),
                                        torch.from_numpy(y.astype(np.float32)),
                                        torch.from_numpy(w)))
        _close(got, want)

    def test_error_on_a_binary_payload_equals_reference(self):
        rng = np.random.default_rng(3)
        p1 = rng.random(500).astype(np.float32)
        p1[::10] = 0.5                               # exactly at the cut: class 0
        y = rng.integers(0, 2, 500).astype(np.float32)
        w = _weights(500, rng)
        want = float(JM.multiclass_error(jnp.asarray(p1), jnp.asarray(y), jnp.asarray(w)))
        got = float(TM.multiclass_error(*(torch.from_numpy(a) for a in (p1, y, w))))
        _close(got, want)

    @pytest.mark.parametrize("thresholds", [(), (0.2, 0.5, 0.9)])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_evaluator_equals_reference(self, thresholds, weighted):
        prob, y = _multiclass(c=6)
        w = _weights(len(y), np.random.default_rng(4)).astype(np.float64) \
            if weighted else None
        raw = np.log(prob)
        ref = JB.MultiClassificationEvaluator(thresholds=thresholds).evaluate_arrays(
            y, JPred.classification(raw, prob), w)
        got = TB.MultiClassificationEvaluator(thresholds=thresholds).evaluate_arrays(
            y, TPred.classification(raw, prob), w)
        assert got == ref

    def test_factories_match_reference(self):
        for name in ("binary_classification", "multi_classification", "regression",
                     "forecast", "bin_score"):
            j, t = getattr(JB.Evaluators, name)(), getattr(TB.Evaluators, name)()
            assert type(t).__name__ == type(j).__name__
            assert (t.default_metric, t.problem, t.larger_is_better) == \
                (j.default_metric, j.problem, j.larger_is_better)


class TestThresholdCurves:
    @pytest.mark.parametrize("ties", [False, True])
    @pytest.mark.parametrize("num_thresholds", [1, 7, 100])
    def test_curves_equal_reference(self, ties, num_thresholds):
        rng = np.random.default_rng(num_thresholds)
        n = 613
        s = rng.random(n).astype(np.float32)
        if ties:
            s = np.round(s * 8) / 8                  # eight distinct scores
        y = (rng.random(n) < s).astype(np.float32)
        w = _weights(n, rng)
        ref = JM.threshold_curves(jnp.asarray(s), jnp.asarray(y), jnp.asarray(w),
                                  num_thresholds)
        got = TM.threshold_curves(*(torch.from_numpy(a) for a in (s, y, w)),
                                  num_thresholds)
        for g, r in zip(got, ref):
            _close(g.numpy(), np.asarray(r))

    def test_binary_evaluator_with_thresholds_equals_reference(self):
        rng = np.random.default_rng(5)
        n = 400
        p1 = np.round(rng.random(n) * 20) / 20
        y = (rng.random(n) < p1).astype(np.float64)
        prob = np.column_stack([1 - p1, p1])
        ref = JB.BinaryClassificationEvaluator(num_thresholds=25).evaluate_arrays(
            y, JPred.classification(np.log(prob + 1e-9), prob))
        got = TB.BinaryClassificationEvaluator(num_thresholds=25).evaluate_arrays(
            y, TPred.classification(np.log(prob + 1e-9), prob))
        assert set(got) == set(ref)
        for k in ref:
            _close(got[k], ref[k], rtol=1e-6, atol=1e-6)
        assert len(got["thresholds"]) == 25


class TestBinScore:
    def test_bin_score_equals_reference(self):
        rng = np.random.default_rng(6)
        p1 = rng.random(500)
        y = (rng.random(500) < p1).astype(np.float64)
        prob = np.column_stack([1 - p1, p1])
        w = rng.uniform(0.5, 2, 500)
        ref = JB.BinScoreEvaluator(num_bins=10).evaluate_arrays(
            y, JPred.classification(prob, prob), w)
        got = TB.BinScoreEvaluator(num_bins=10).evaluate_arrays(
            y, TPred.classification(prob, prob), w)
        assert got == ref

    def test_margins_only_raise(self):
        with pytest.raises(ValueError, match="probability"):
            TB.BinScoreEvaluator().evaluate_arrays(
                np.zeros(3), TPred(np.zeros(3), np.zeros((3, 2))))
