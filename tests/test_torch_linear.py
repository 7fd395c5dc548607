"""The port's LogisticRegression and LinearSVC fits against the JAX package.

Same seeded inputs (numpy) through the JAX function and the port's, on the
CPU, at small shapes:

- the solvers: IRLS (``_irls_core``), elastic-net FISTA (``_fista_elastic``)
  and the squared-hinge descent (``_svc_body``); a batch of fits equals each
  fit alone;
- the CV sweeps (``cv_sweep``: LR's batched IRLS + FISTA + linear eval
  sweep, SVC's per-fold program, and the generic per-(grid, fold) path) on
  the same fold weights;
- ``_fit_arrays``' coefficients and intercept, the models' host heads
  (LinearSVC: margins only, ``prob`` None) and their device eval payloads,
  and the binary evaluator on a margin-only prediction;
- the default binary selector through ``Workflow.train`` at n = 2000,
  d = 16: the same winner as the reference, every CV metric within its
  family's tolerance (the forest fed the reference's bootstrap draws).

Tolerances: IRLS coefficients rtol 1e-4, atol 1e-5 (a converged Newton);
FISTA and SVC coefficients atol 1e-4; CV and train metrics atol 1e-4 (GBT
1e-3: its float histograms sum in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.data.dataset import Column as JCol
from transmogrifai_tpu.data.dataset import Dataset as JDs
from transmogrifai_tpu.evaluators import metrics as JM
from transmogrifai_tpu.evaluators.base import BinaryClassificationEvaluator as JBin
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import logistic as JL
from transmogrifai_tpu.models import svm as JS
from transmogrifai_tpu.models.selector import BinaryClassificationModelSelector as JSel
from transmogrifai_tpu.types import RealNN as JRealNN
from transmogrifai_tpu.workflow.workflow import Workflow as JWorkflow
from transmogrifai_tpu_torch import BinaryClassificationModelSelector as TSel
from transmogrifai_tpu_torch import FeatureBuilder as TFB
from transmogrifai_tpu_torch import Workflow as TWorkflow
from transmogrifai_tpu_torch.data.dataset import Column as TCol
from transmogrifai_tpu_torch.data.dataset import Dataset as TDs
from transmogrifai_tpu_torch.evaluators import metrics as TM
from transmogrifai_tpu_torch.evaluators.base import BinaryClassificationEvaluator as TBin
from transmogrifai_tpu_torch.models import logistic as TL
from transmogrifai_tpu_torch.models import svm as TS
from transmogrifai_tpu_torch.models import trees as TT
from transmogrifai_tpu_torch.types import RealNN as TRealNN

CPU = torch.device("cpu")
LR_GRIDS = [{"reg_param": r, "elastic_net": e} for r in (0.001, 0.01, 0.1)
            for e in (0.0, 0.5)]
SVC_GRIDS = [{"reg_param": r} for r in (0.01, 0.1)]
#: CV and train metrics of a family against the reference's
METRIC_TOL = {"LogisticRegression": 1e-4, "LinearSVC": 1e-4,
              "RandomForestClassifier": 1e-4, "GradientBoostedTreesClassifier": 1e-3}


def _data(n=1500, d=12, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    beta = rng.normal(size=d) / np.sqrt(d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x / scale) @ beta * 3))).astype(np.float32)
    return x, y


def _standardized(x, has_intercept=True):
    xs = ((x - x.mean(0)) / x.std(0)).astype(np.float32)
    if has_intercept:
        xs = np.concatenate([xs, np.ones((len(x), 1), np.float32)], axis=1)
    return xs


def _folds(y, k=3, seed=5):
    fold = np.random.default_rng(seed).permutation(len(y)) % k
    tw = np.stack([(fold != f).astype(np.float32) for f in range(k)])
    return tw, 1.0 - tw


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


class TestSolvers:
    @pytest.mark.parametrize("reg", [0.0, 0.01, 0.5])
    @pytest.mark.parametrize("has_intercept", [True, False])
    def test_irls_core_equals_reference(self, reg, has_intercept):
        x, y = _data(seed=1)
        w = np.random.default_rng(2).uniform(0, 2, len(y)).astype(np.float32)
        xs = _standardized(x, has_intercept)
        ref = np.asarray(JL._irls_core(jnp.asarray(xs), jnp.asarray(y), jnp.asarray(w),
                                       jnp.float32(reg), 30, has_intercept=has_intercept))
        xt, yt, wt = _t(xs, y, w)
        got = TL._irls_core(xt, yt, wt[None], torch.tensor([reg]), 30,
                            has_intercept)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("l1, l2", [(0.005, 0.005), (0.05, 0.0), (0.0005, 0.05)])
    @pytest.mark.parametrize("has_intercept", [True, False])
    def test_fista_elastic_equals_reference(self, l1, l2, has_intercept):
        x, y = _data(seed=3)
        w = (np.random.default_rng(4).random(len(y)) < 0.7).astype(np.float32)
        xs = _standardized(x, has_intercept)
        ref = np.asarray(JL._fista_elastic(
            jnp.asarray(xs), jnp.asarray(y), jnp.asarray(w), jnp.float32(l1),
            jnp.float32(l2), 300, has_intercept=has_intercept))
        xt, yt, wt = _t(xs, y, w)
        got = TL._fista_elastic(xt, yt, wt[None], torch.tensor([l1]), torch.tensor([l2]),
                                300, has_intercept)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        assert np.array_equal(got == 0.0, ref == 0.0)      # the same sparsity

    @pytest.mark.parametrize("reg", [0.0, 0.01, 0.1])
    @pytest.mark.parametrize("has_intercept", [True, False])
    def test_svc_body_equals_reference(self, reg, has_intercept):
        x, y = _data(seed=5)
        w = (np.random.default_rng(6).random(len(y)) < 0.6).astype(np.float32)
        xs = _standardized(x, has_intercept)
        ypm = np.where(y > 0.5, 1.0, -1.0).astype(np.float32)
        ref = np.asarray(JS._svc_core(jnp.asarray(xs), jnp.asarray(ypm), jnp.asarray(w),
                                      jnp.float32(reg), 100, has_intercept=has_intercept))
        xt, yt, wt = _t(xs, ypm, w)
        got = TS._svc_body(xt, yt, wt[None], torch.tensor([reg]), 100,
                           has_intercept)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)

    def test_a_batch_of_fits_equals_each_fit_alone(self):
        """The (grid x fold) pairs share each product; each column stays
        its own fit."""
        x, y = _data(n=700, d=6, seed=7)
        xt, yt = _t(_standardized(x), y)
        tw, _ = _folds(y)
        w = torch.from_numpy(np.concatenate([tw, tw[:1] * 0.5]))
        regs, l1s = torch.tensor([0.0, 0.01, 0.1, 0.02]), torch.tensor([0.01, 0.0, 0.02, 0.005])
        for batch, alone in (
                (TL._irls_core(xt, yt, w, regs, 30),
                 lambda b: TL._irls_core(xt, yt, w[b:b + 1], regs[b:b + 1], 30)),
                (TL._fista_elastic(xt, yt, w, l1s, regs, 300),
                 lambda b: TL._fista_elastic(xt, yt, w[b:b + 1], l1s[b:b + 1],
                                             regs[b:b + 1], 300)),
                (TS._svc_body(xt, yt * 2 - 1, w, regs, 100),
                 lambda b: TS._svc_body(xt, yt * 2 - 1, w[b:b + 1], regs[b:b + 1], 100))):
            for b in range(4):
                torch.testing.assert_close(batch[b:b + 1], alone(b), rtol=0, atol=1e-5)

    def test_fista_momentum_is_float32(self):
        moms = TL._fista_momentum(5)
        t, want = np.float32(1.0), []
        for _ in range(5):
            t_new = np.float32(0.5) * (1 + np.sqrt(np.float32(1) + 4 * t * t,
                                                   dtype=np.float32))
            want.append(float((t - np.float32(1.0)) / t_new))
            t = t_new
        assert moms == want and moms[0] == 0.0


class TestSweeps:
    @pytest.mark.parametrize("n, d, scale", [(1500, 12, 1.0), (600, 5, 30.0)])
    def test_lr_sweep_equals_reference(self, n, d, scale):
        x, y = _data(n, d, seed=n, scale=scale)
        tw, vw = _folds(y)
        for metric in ("auPR", "auROC"):
            ref = JL.LogisticRegression().cv_sweep(x, y, tw, vw, LR_GRIDS,
                                                   JM.METRICS_BINARY[metric])
            got = TL.LogisticRegression().cv_sweep(x, y, tw, vw, LR_GRIDS,
                                                   TM.METRICS_BINARY[metric], CPU)
            assert got.shape == (len(LR_GRIDS), 3)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)

    @pytest.mark.parametrize("params", [{}, {"fit_intercept": False},
                                        {"standardize": False, "max_iter": 10}])
    def test_lr_sweep_params_equal_reference(self, params):
        x, y = _data(800, 7, seed=9)
        tw, vw = _folds(y, k=2)
        grids = [{"reg_param": 0.01}, {"reg_param": 0.02, "elastic_net": 0.3},
                 {"reg_param": -0.1}]
        ref = JL.LogisticRegression(**params).cv_sweep(x, y, tw, vw, grids,
                                                       JM.METRICS_BINARY["auPR"])
        got = TL.LogisticRegression(**params).cv_sweep(x, y, tw, vw, grids,
                                                       TM.METRICS_BINARY["auPR"], CPU)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)

    @pytest.mark.parametrize("n, d", [(1500, 12), (333, 16)])
    def test_svc_sweep_equals_reference(self, n, d):
        x, y = _data(n, d, seed=n + 1)
        x[:, 3] = 2.0                                    # a constant column: std 1
        tw, vw = _folds(y)
        ref = JS.LinearSVC().cv_sweep(x, y, tw, vw, SVC_GRIDS, JM.METRICS_BINARY["auPR"])
        got = TS.LinearSVC().cv_sweep(x, y, tw, vw, SVC_GRIDS,
                                      TM.METRICS_BINARY["auPR"], CPU)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)

    @pytest.mark.parametrize("case", ["max_iter_grid", "no_standardize"])
    def test_generic_sweep_equals_reference(self, case):
        """A grid touching a param the vectorized program does not vary,
        or standardization off, takes one fit per (grid, fold)."""
        x, y = _data(500, 6, seed=11)
        tw, vw = _folds(y, k=2)
        if case == "max_iter_grid":
            est_j, est_t = JS.LinearSVC(), TS.LinearSVC()
            grids = [{"reg_param": 0.01, "max_iter": 40}, {"reg_param": 0.1}]
        else:
            est_j, est_t = JS.LinearSVC(standardize=False), TS.LinearSVC(standardize=False)
            grids = SVC_GRIDS
        assert est_t._cv_sweep_device(x, y, tw, vw, grids, TM.au_pr, CPU) is None
        ref = est_j.cv_sweep(x, y, tw, vw, grids, JM.METRICS_BINARY["auPR"])
        got = est_t.cv_sweep(x, y, tw, vw, grids, TM.METRICS_BINARY["auPR"], CPU)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)

    def test_generic_sweep_is_gathered_later(self):
        x, y = _data(300, 4, seed=12)
        tw, vw = _folds(y, k=2)
        gather = TS.LinearSVC().cv_sweep_async(
            x, y, tw, vw, [{"reg_param": 0.1, "max_iter": 20}], TM.au_pr, CPU)
        assert gather().shape == (1, 2)


class TestFitsAndHeads:
    @pytest.mark.parametrize("params", [
        {"reg_param": 0.01}, {"reg_param": 0.0}, {"reg_param": 0.05, "elastic_net": 0.5},
        {"reg_param": 0.01, "fit_intercept": False},
        {"reg_param": 0.01, "elastic_net": 0.2, "standardize": False}])
    def test_lr_fit_arrays_equal_reference(self, params):
        x, y = _data(seed=13)
        w = np.random.default_rng(1).uniform(0.2, 1.5, len(y)).astype(np.float32)
        ref = JL.LogisticRegression(**params)._fit_arrays(x, y, w)
        got = TL.LogisticRegression(**params)._fit_arrays(x, y, w, CPU)
        fista = params.get("elastic_net", 0.0) > 0
        rtol, atol = (0.0, 1e-4) if fista else (1e-4, 1e-5)
        np.testing.assert_allclose(got.coef, ref.coef, rtol=rtol, atol=atol)
        np.testing.assert_allclose(got.intercept, ref.intercept, rtol=rtol, atol=atol)
        assert got.coef.dtype == np.float64

    @pytest.mark.parametrize("params", [{"reg_param": 0.01}, {"reg_param": 0.0},
                                        {"reg_param": 0.1, "fit_intercept": False}])
    def test_svc_fit_arrays_and_head_equal_reference(self, params):
        x, y = _data(seed=14)
        w = (np.random.default_rng(3).random(len(y)) < 0.8).astype(np.float32)
        ref = JS.LinearSVC(**params)._fit_arrays(x, y, w)
        got = TS.LinearSVC(**params)._fit_arrays(x, y, w, CPU)
        np.testing.assert_allclose(got.coef, ref.coef, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.intercept, ref.intercept, rtol=0, atol=1e-4)
        # the host head on the reference's own coefficients: bitwise
        got.coef, got.intercept = ref.coef, ref.intercept
        tcol = got.predict_column(TCol.vector(x))
        jcol = ref.predict_column(JCol.vector(x))
        assert tcol.prob is None and jcol.prob is None
        np.testing.assert_array_equal(tcol.pred, jcol.pred)
        np.testing.assert_array_equal(tcol.raw, jcol.raw)
        np.testing.assert_array_equal(tcol.score, tcol.raw[:, 1])
        assert set(tcol.to_values()[0]) == {"prediction", "rawPrediction_0",
                                            "rawPrediction_1"}

    @pytest.mark.parametrize("fam", ["lr", "svc"])
    def test_eval_payload_equals_reference(self, fam):
        x, y = _data(n=900, seed=15)
        ones = np.ones_like(y)
        ref = (JL.LogisticRegression(reg_param=0.01) if fam == "lr"
               else JS.LinearSVC(reg_param=0.01))._fit_arrays(x, y, ones)
        got = (TL.LogisticRegressionModel if fam == "lr" else TS.LinearSVCModel)(
            coef=ref.coef, intercept=ref.intercept)
        js, jp = (np.asarray(a)[:len(y)] for a in ref.eval_payload_device(x))
        ts, tp = (a.numpy() for a in got.eval_payload_device(x, CPU))
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tp, jp)

    def test_evaluator_on_margins_only_equals_reference(self):
        x, y = _data(n=800, seed=16)
        ref = JS.LinearSVC(reg_param=0.01)._fit_arrays(x, y, np.ones_like(y))
        got = TS.LinearSVCModel(coef=ref.coef, intercept=ref.intercept)
        jm = JBin().evaluate_arrays(y.astype(np.float64), ref.predict_column(JCol.vector(x)))
        tm = TBin().evaluate_arrays(y.astype(np.float64), got.predict_column(TCol.vector(x)))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=0, atol=1e-6, err_msg=k)


def _reference_bootstrap(seed, rate, n_trees, n, device):
    draws = jax.random.poisson(jax.random.PRNGKey(int(seed)), float(rate),
                               (int(n_trees), int(n)))
    return torch.from_numpy(np.asarray(draws).astype(np.float32)).to(device)


@pytest.fixture(scope="module")
def default_selector_runs():
    """The default selector (no ``models=``) at n = 2000, d = 16 through
    ``Workflow.train`` in both packages, the forest on the reference's
    bootstrap draws."""
    rng = np.random.default_rng(0)
    n, d = 2000, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d) / np.sqrt(d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ beta)))).astype(np.float64)
    label = JFB.RealNN("label").extract_field().as_response()
    vec = JFB.OPVector("d").extract_field().as_predictor()
    jsel = JSel.with_cross_validation(num_folds=3, seed=7)
    pred = label.transform_with(jsel, vec)
    jds = JDs({"label": JCol.from_values(JRealNN, y.tolist()), "d": JCol.vector(x)})
    jmodel = JWorkflow().set_input_dataset(jds).set_result_features(label, pred).train()

    port_draws = TT.draw_bootstrap
    TT.draw_bootstrap = _reference_bootstrap
    try:
        tlabel = TFB.RealNN("label").extract_field().as_response()
        tvec = TFB.OPVector("d").extract_field().as_predictor()
        tsel = TSel.with_cross_validation(num_folds=3, seed=7)
        tpred = tlabel.transform_with(tsel, tvec)
        tds = TDs({"label": TCol.from_values(TRealNN, y.tolist()), "d": TCol.vector(x)})
        tmodel = TWorkflow().set_input_dataset(tds).set_result_features(
            tlabel, tpred).train(device="cpu")
    finally:
        TT.draw_bootstrap = port_draws
    return jmodel.fitted[jsel.uid].summary, tmodel.fitted[tsel.uid], tsel


class TestDefaultSelector:
    def test_same_winner_and_cv_metrics(self, default_selector_runs):
        jsum, tfit, _ = default_selector_runs
        tsum = tfit.summary
        assert (tsum.best_model_name, tsum.best_grid) == (jsum.best_model_name,
                                                          jsum.best_grid)
        assert [(e.model_name, e.grid) for e in tsum.validation_results] == \
            [(e.model_name, e.grid) for e in jsum.validation_results]
        assert len(tsum.validation_results) == 11
        for te, je in zip(tsum.validation_results, jsum.validation_results):
            np.testing.assert_allclose(te.metric_values, je.metric_values, rtol=0,
                                       atol=METRIC_TOL[je.model_name],
                                       err_msg=f"{je.model_name} {je.grid}")

    def test_same_refit_and_train_metrics(self, default_selector_runs):
        jsum, tfit, tsel = default_selector_runs
        assert type(tfit.model).__name__ == "LogisticRegressionModel"
        for k, v in jsum.train_evaluation.items():
            np.testing.assert_allclose(tfit.summary.train_evaluation[k], v, rtol=0,
                                       atol=1e-4, err_msg=k)
        assert {f"cv.{n}" for n in ("LogisticRegression", "RandomForestClassifier",
                                    "GradientBoostedTreesClassifier", "LinearSVC")} \
            <= set(tsel.last_fit_profile)
