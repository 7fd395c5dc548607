"""Regression and multiclass model selection in the port against the JAX
package, on the CPU.

Same seeded numpy inputs (about 2048 rows x 12 features) through both
packages:

- each new family's fit and CV sweep: LinearRegression (ridge) and
  NaiveBayes within 1e-5; GeneralizedLinearRegression (all four families)
  and MultinomialLogisticRegression CV within 1e-4, coefficients rtol 1e-4 /
  atol 1e-5; NaiveBayes on labels that are not 0..C-1 through the generic
  sweep;
- ``DataCutter`` and ``TrainValidationSplit`` weights bitwise, and
  ``Dataset.split``'s rows;
- the trees' regression and multiclass paths (the forest fed the
  reference's bootstrap draws through ``draw_bootstrap``): forest and GBT
  regression and GBT ``multi:softmax`` CV within 1e-3 (float histograms sum
  in another order), multiclass forest and decision tree refits bitwise;
- both selectors (and the binary selector's train/validation split) through
  ``Workflow.train(device="cpu")``: the same winner and every CV metric
  within its family's tolerance; ``train(test_fraction=)``'s holdout
  metrics equal;
- every new model class saved by each package, loaded and scored by the
  other.
"""

import numpy as np
import pytest
import torch

import jax

from transmogrifai_tpu.data.dataset import Column as JCol
from transmogrifai_tpu.data.dataset import Dataset as JDs
from transmogrifai_tpu.evaluators.base import MultiClassificationEvaluator as JMulti
from transmogrifai_tpu.evaluators.base import RegressionEvaluator as JReg
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import glm as JG
from transmogrifai_tpu.models import linear as JL
from transmogrifai_tpu.models import naive_bayes as JNB
from transmogrifai_tpu.models import selector as JSel
from transmogrifai_tpu.models import softmax as JSM
from transmogrifai_tpu.models import trees as JT
from transmogrifai_tpu.models import tuning as JTu
from transmogrifai_tpu.types import RealNN as JRealNN
from transmogrifai_tpu.workflow.workflow import Workflow as JWorkflow
from transmogrifai_tpu.workflow.workflow import WorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import FeatureBuilder as TFB
from transmogrifai_tpu_torch import Workflow as TWorkflow
from transmogrifai_tpu_torch import WorkflowModel as TWorkflowModel
from transmogrifai_tpu_torch.data.dataset import Column as TCol
from transmogrifai_tpu_torch.data.dataset import Dataset as TDs
from transmogrifai_tpu_torch.evaluators.base import MultiClassificationEvaluator as TMulti
from transmogrifai_tpu_torch.evaluators.base import RegressionEvaluator as TReg
from transmogrifai_tpu_torch.models import glm as TG
from transmogrifai_tpu_torch.models import linear as TL
from transmogrifai_tpu_torch.models import naive_bayes as TNB
from transmogrifai_tpu_torch.models import selector as TSel
from transmogrifai_tpu_torch.models import softmax as TSM
from transmogrifai_tpu_torch.models import trees as TT
from transmogrifai_tpu_torch.models import tuning as TTu
from transmogrifai_tpu_torch.types import RealNN as TRealNN

CPU = torch.device("cpu")
N, D = 2048, 12
#: (rtol, atol) of a family's CV metrics against the reference's in a
#: default selector's run: the trees' float histograms sum in another order,
#: so a near-tie split may go the other way in one tree, and what follows it
#: differs.  Their regression metrics (rmse, in the label's units) hold to
#: 2e-3 of their value: 50 rounds of GBT regression on this data agree
#: exactly through round 20 and differ by 1.2e-3 of the rmse after round 50
#: in one fold (the sweeps of TestTrees, at fewer rounds, hold to 1e-3)
FAMILY_TOL = {"LinearRegression": (0, 1e-5), "GeneralizedLinearRegression": (0, 1e-4),
              "RandomForestRegressor": (2e-3, 0), "GradientBoostedTreesRegressor": (2e-3, 0),
              "MultinomialLogisticRegression": (0, 1e-4),
              "RandomForestClassifier": (0, 1e-3), "DecisionTreeClassifier": (0, 1e-3),
              "NaiveBayes": (0, 1e-5), "LogisticRegression": (0, 1e-4),
              "GradientBoostedTreesClassifier": (0, 1e-3), "LinearSVC": (0, 1e-4)}


def reference_bootstrap(seed, rate, n_trees, n, device):
    """The JAX package's forest draws, for the port's ``draw_bootstrap``."""
    draws = jax.random.poisson(jax.random.PRNGKey(int(seed)), float(rate),
                               (int(n_trees), int(n)))
    return torch.from_numpy(np.asarray(draws).astype(np.float32)).to(device)


@pytest.fixture
def ref_draws(monkeypatch):
    monkeypatch.setattr(TT, "draw_bootstrap", reference_bootstrap)


def regression_data(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    y = x @ w + 0.5 * np.sin(x[:, 0] * 2) + rng.normal(size=n) * 0.5
    return x, y.astype(np.float64)


def multiclass_data(n=N, d=D, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, classes)) * 1.5
    y = np.argmax(x @ w + rng.gumbel(size=(n, classes)), axis=1)
    return x, y.astype(np.float64)


def glm_label(family, x, seed=0):
    rng = np.random.default_rng(seed)
    eta = x[:, :4] @ np.array([0.4, -0.3, 0.2, 0.1]) + 0.2
    if family == "gaussian":
        return eta + rng.normal(size=len(x)) * 0.5
    if family == "binomial":
        return (rng.random(len(x)) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    if family == "poisson":
        return rng.poisson(np.exp(eta)).astype(np.float64)
    return rng.gamma(2.0, np.exp(eta) / 2.0)


def folds(y, k=3, seed=5):
    tw, vw = JTu.CrossValidator(JReg(), num_folds=k, seed=seed).fold_weights(
        y, np.ones(len(y), np.float32))
    return tw, vw


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


# -- the linear families ---------------------------------------------------------

class TestLinearRegression:
    @pytest.mark.parametrize("params", [{}, {"reg_param": 0.1, "elastic_net": 0.5},
                                        {"reg_param": 0.01, "fit_intercept": False}])
    def test_fit_equals_reference(self, params):
        x, y = regression_data()
        w = np.random.default_rng(1).uniform(0, 2, N).astype(np.float32)
        ref = JL.LinearRegression(**params)._fit_arrays(x, y.astype(np.float32), w)
        got = TL.LinearRegression(**params)._fit_arrays(x, y.astype(np.float32), w, CPU)
        _close(got.coef, ref.coef, 1e-5, 1e-5)
        _close(got.intercept, ref.intercept, 1e-5, 1e-5)
        vec = TCol.vector(x[:50])
        _close(got.predict_column(vec).pred,
               ref.predict_column(JCol.vector(x[:50])).pred, 1e-5, 1e-5)

    @pytest.mark.parametrize("metric", ["rmse", "r2", "mae"])
    def test_cv_sweep_equals_reference(self, metric):
        x, y = regression_data(seed=2)
        tw, vw = folds(y)
        grids = TSel.RegressionModelSelector.default_models()[0][1]
        ref = JL.LinearRegression().cv_sweep(x, y, tw, vw, grids, JReg(metric).metric_fn())
        got = TL.LinearRegression().cv_sweep(x, y, tw, vw, grids,
                                             TReg(metric).metric_fn(), CPU)
        assert got.shape == (6, 3)
        _close(got, ref, 1e-5, 1e-5)


class TestGLM:
    @pytest.mark.parametrize("family", ["gaussian", "binomial", "poisson", "gamma"])
    @pytest.mark.parametrize("reg", [0.0, 0.05])
    def test_fit_equals_reference(self, family, reg):
        x, _ = regression_data(seed=3)
        y = glm_label(family, x, seed=4).astype(np.float32)
        w = (np.random.default_rng(5).random(N) < 0.8).astype(np.float32)
        ref = JG.GeneralizedLinearRegression(family=family, reg_param=reg)._fit_arrays(
            x, y, w)
        got = TG.GeneralizedLinearRegression(family=family, reg_param=reg)._fit_arrays(
            x, y, w, CPU)
        _close(got.coef, ref.coef, 1e-4, 1e-5, family)
        _close(got.intercept, ref.intercept, 1e-4, 1e-5, family)
        assert got.family == ref.family
        _close(got.predict_column(TCol.vector(x[:40])).pred,
               ref.predict_column(JCol.vector(x[:40])).pred, 1e-4, 1e-5)

    @pytest.mark.parametrize("family", ["gaussian", "binomial", "poisson", "gamma"])
    def test_cv_sweep_equals_reference(self, family):
        x, _ = regression_data(seed=6)
        y = glm_label(family, x, seed=7)
        tw, vw = folds(y)
        grids = [{"family": family, "reg_param": r} for r in (0.0, 0.01)]
        ref = JG.GeneralizedLinearRegression().cv_sweep(x, y, tw, vw, grids,
                                                        JReg().metric_fn())
        got = TG.GeneralizedLinearRegression().cv_sweep(x, y, tw, vw, grids,
                                                        TReg().metric_fn(), CPU)
        _close(got, ref, 0, 1e-4)

    def test_mixed_families_keep_grid_order(self):
        x, _ = regression_data(seed=8)
        y = glm_label("poisson", x, seed=9)
        tw, vw = folds(y)
        grids = [{"family": "poisson", "reg_param": 0.0},
                 {"family": "gaussian", "reg_param": 0.0},
                 {"family": "poisson", "reg_param": 0.1}]
        ref = JG.GeneralizedLinearRegression().cv_sweep(x, y, tw, vw, grids,
                                                        JReg().metric_fn())
        got = TG.GeneralizedLinearRegression().cv_sweep(x, y, tw, vw, grids,
                                                        TReg().metric_fn(), CPU)
        _close(got, ref, 0, 1e-4)


class TestMultinomialLR:
    @pytest.mark.parametrize("classes, reg", [(3, 0.0), (3, 0.1), (5, 0.01)])
    def test_fit_equals_reference(self, classes, reg):
        x, y = multiclass_data(classes=classes, seed=classes)
        w = np.random.default_rng(2).uniform(0, 2, N).astype(np.float32)
        ref = JSM.MultinomialLogisticRegression(reg_param=reg)._fit_arrays(
            x, y.astype(np.float32), w)
        got = TSM.MultinomialLogisticRegression(reg_param=reg)._fit_arrays(
            x, y.astype(np.float32), w, CPU)
        _close(got.coef, ref.coef, 1e-4, 1e-5)
        _close(got.intercept, ref.intercept, 1e-4, 1e-5)
        _close(got.predict_column(TCol.vector(x[:40])).prob,
               ref.predict_column(JCol.vector(x[:40])).prob, 1e-4, 1e-5)

    @pytest.mark.parametrize("classes", [3, 6])
    def test_cv_sweep_equals_reference(self, classes):
        x, y = multiclass_data(classes=classes, seed=10 + classes)
        tw, vw = folds(y)
        grids = [{"reg_param": r} for r in (0.001, 0.01, 0.1)]
        ref = JSM.MultinomialLogisticRegression().cv_sweep(
            x, y, tw, vw, grids, JMulti().metric_fn())
        got = TSM.MultinomialLogisticRegression().cv_sweep(
            x, y, tw, vw, grids, TMulti().metric_fn(), CPU)
        _close(got, ref, 0, 1e-4)


class TestNaiveBayes:
    @pytest.mark.parametrize("smoothing", [1.0, 0.3])
    def test_fit_equals_reference(self, smoothing):
        x, y = multiclass_data(classes=4, seed=11)
        w = (np.random.default_rng(3).random(N) < 0.7).astype(np.float32)
        ref = JNB.NaiveBayes(smoothing=smoothing)._fit_arrays(x, y.astype(np.float32), w)
        got = TNB.NaiveBayes(smoothing=smoothing)._fit_arrays(
            x, y.astype(np.float32), w, CPU)
        for k in ("classes", "log_prior", "log_theta", "shift"):
            _close(getattr(got, k), getattr(ref, k), 1e-5, 1e-6, k)
        _close(got.predict_column(TCol.vector(x[:40])).prob,
               ref.predict_column(JCol.vector(x[:40])).prob, 1e-5, 1e-6)

    @pytest.mark.parametrize("classes", [2, 3, 7])
    def test_cv_sweep_equals_reference(self, classes):
        x, y = multiclass_data(classes=classes, seed=12)
        tw, vw = folds(y)
        grids = [{"smoothing": 1.0}, {"smoothing": 0.5}]
        ref = JNB.NaiveBayes().cv_sweep(x, y, tw, vw, grids, JMulti().metric_fn())
        got = TNB.NaiveBayes().cv_sweep(x, y, tw, vw, grids, TMulti().metric_fn(), CPU)
        _close(got, ref, 0, 1e-5)

    def test_other_labels_take_the_generic_sweep(self):
        x, y = multiclass_data(classes=3, seed=13)
        y = np.array([0.0, 2.0, 5.0])[y.astype(int)]
        tw, vw = folds(y)
        grids = [{"smoothing": 1.0}]
        assert TNB.NaiveBayes()._cv_sweep_device(x, y, tw, vw, grids,
                                                 TMulti().metric_fn(), CPU) is None
        ref = JNB.NaiveBayes().cv_sweep(x, y, tw, vw, grids, JMulti().metric_fn())
        got = TNB.NaiveBayes().cv_sweep(x, y, tw, vw, grids, TMulti().metric_fn(), CPU)
        _close(got, ref, 0, 1e-5)


# -- splitters and validators -----------------------------------------------------

class TestSplitters:
    @pytest.mark.parametrize("kw", [{}, {"min_label_fraction": 0.05},
                                    {"max_label_categories": 3},
                                    {"reserve_test_fraction": 0.2, "seed": 9}])
    def test_data_cutter_equals_reference(self, kw):
        rng = np.random.default_rng(0)
        y = rng.choice(8, 3000, p=[0.3, 0.25, 0.2, 0.1, 0.08, 0.04, 0.02, 0.01]) \
            .astype(np.float32)
        jw, js = JTu.DataCutter(**kw).prepare(y)
        tw, ts = TTu.DataCutter(**kw).prepare(y)
        assert tw.dtype == jw.dtype and tw.tobytes() == jw.tobytes()
        assert (ts.kind, ts.details) == (js.kind, js.details)

    @pytest.mark.parametrize("ratio, seed", [(0.75, 42), (0.5, 3)])
    def test_train_validation_split_equals_reference(self, ratio, seed):
        y = (np.random.default_rng(1).random(1000) < 0.3).astype(np.float32)
        base = np.random.default_rng(2).uniform(0, 1, 1000).astype(np.float32)
        j = JTu.TrainValidationSplit(JReg(), train_ratio=ratio, seed=seed) \
            .fold_weights(y, base)
        t = TTu.TrainValidationSplit(TReg(), train_ratio=ratio, seed=seed) \
            .fold_weights(y, base)
        for a, b in zip(t, j):
            assert a.shape == b.shape == (1, 1000) and a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("fraction, seed", [(0.2, 42), (0.33, 7)])
    def test_dataset_split_equals_reference(self, fraction, seed):
        x, y = regression_data(n=301)
        jtr, jte = JDs({"y": JCol.from_values(JRealNN, y.tolist()),
                        "x": JCol.vector(x)}).split(fraction, seed)
        ttr, tte = TDs({"y": TCol.from_values(TRealNN, y.tolist()),
                        "x": TCol.vector(x)}).split(fraction, seed)
        for j, t in ((jtr, ttr), (jte, tte)):
            assert t.n_rows == j.n_rows
            assert t["y"].data.tobytes() == j["y"].data.tobytes()
            assert t["x"].data.tobytes() == j["x"].data.tobytes()


# -- trees: regression and multiclass paths ---------------------------------------

def _tree_case(kind):
    if kind == "regression":
        x, y = regression_data(n=1500, d=8, seed=14)
        return x, y, JReg("rmse"), TReg("rmse")
    x, y = multiclass_data(n=1500, d=8, classes=4, seed=15)
    return x, y, JMulti(), TMulti()


class TestTrees:
    @pytest.mark.parametrize("name, kind, grids", [
        ("RandomForestRegressor", "regression",
         [{"num_trees": 6, "max_depth": 2}, {"num_trees": 6, "max_depth": 4}]),
        ("GradientBoostedTreesRegressor", "regression",
         [{"num_rounds": 5, "max_depth": 3}]),
        ("DecisionTreeRegressor", "regression", [{"max_depth": 3}]),
        ("XGBoostRegressor", "regression", [{"num_rounds": 3, "max_depth": 2}]),
        ("GradientBoostedTreesClassifier", "multiclass",
         [{"num_rounds": 4, "max_depth": 2}]),
        ("RandomForestClassifier", "multiclass",
         [{"num_trees": 6, "max_depth": 3}]),
        ("DecisionTreeClassifier", "multiclass", [{"max_depth": 3}, {"max_depth": 5}]),
        ("XGBoostClassifier", "multiclass", [{"num_rounds": 3, "max_depth": 2}])])
    def test_cv_sweep_equals_reference(self, name, kind, grids, ref_draws):
        x, y, jev, tev = _tree_case(kind)
        tw, vw = folds(y)
        ref = getattr(JT, name)().cv_sweep(x, y, tw, vw, grids, jev.metric_fn())
        got = getattr(TT, name)().cv_sweep(x, y, tw, vw, grids, tev.metric_fn(), CPU)
        assert got.shape == (len(grids), 3)
        _close(got, ref, 0, 1e-3)

    @pytest.mark.parametrize("name, kw", [
        ("RandomForestClassifier", {"num_trees": 5, "max_depth": 4}),
        ("DecisionTreeClassifier", {"max_depth": 5})])
    def test_multiclass_refit_trees_bitwise(self, name, kw, ref_draws):
        x, y, _, _ = _tree_case("multiclass")
        w = np.ones(len(y), np.float32)
        jm = getattr(JT, name)(**kw)._fit_arrays(x, y.astype(np.float32), w)
        tm = getattr(TT, name)(**kw)._fit_arrays(x, y.astype(np.float32), w, CPU)
        assert tm.n_outputs == 4
        for k in jm.trees:
            np.testing.assert_array_equal(tm.trees[k], jm.trees[k], err_msg=k)
        np.testing.assert_array_equal(tm.predict_column(TCol.vector(x), CPU).prob,
                                      jm.predict_column(JCol.vector(x)).prob)

    @pytest.mark.parametrize("name", ["RandomForestRegressor", "DecisionTreeRegressor",
                                      "GradientBoostedTreesRegressor"])
    def test_regression_refit_close(self, name, ref_draws):
        x, y, _, _ = _tree_case("regression")
        kw = {"max_depth": 3} | ({"num_rounds": 5} if "GBT" in name
                                 or "Gradient" in name else {})
        w = np.ones(len(y), np.float32)
        jm = getattr(JT, name)(**kw)._fit_arrays(x, y.astype(np.float32), w)
        tm = getattr(TT, name)(**kw)._fit_arrays(x, y.astype(np.float32), w, CPU)
        assert type(tm).__name__ == type(jm).__name__
        _close(tm.predict_column(TCol.vector(x), CPU).pred,
               jm.predict_column(JCol.vector(x)).pred, 1e-4, 1e-3)

    def test_gbt_multiclass_refit_close(self):
        x, y, _, _ = _tree_case("multiclass")
        w = np.ones(len(y), np.float32)
        jm = JT.GradientBoostedTreesClassifier(num_rounds=4, max_depth=2)._fit_arrays(
            x, y.astype(np.float32), w)
        tm = TT.GradientBoostedTreesClassifier(num_rounds=4, max_depth=2)._fit_arrays(
            x, y.astype(np.float32), w, CPU)
        np.testing.assert_array_equal(tm.base_score, jm.base_score)
        for k in ("feat", "thr_bin", "miss_left", "is_leaf"):
            np.testing.assert_array_equal(tm.trees[k], jm.trees[k], err_msg=k)
        _close(tm.trees["value"], jm.trees["value"], 0, 1e-5)

    def test_int8_path_only_where_exact(self, monkeypatch):
        """Forest classification with 0/1 fold weights takes the int8
        histograms; regression and fractional weights the float path."""
        seen = []
        real = TT._khist.hist_level

        def spy(*a, **kw):
            seen.append(kw.get("int_exact", False))
            return real(*a, **kw)

        monkeypatch.setattr(TT._khist, "hist_level", spy)
        x, y, _, tev = _tree_case("multiclass")
        tw, vw = folds(y)
        TT.RandomForestClassifier(num_trees=2, max_depth=2).cv_sweep(
            x, y, tw, vw, [{}], tev.metric_fn(), CPU)
        assert seen and all(seen)
        seen.clear()
        TT.RandomForestClassifier(num_trees=2, max_depth=2).cv_sweep(
            x, y, tw * 0.5, vw, [{}], tev.metric_fn(), CPU)
        assert seen and not any(seen)
        seen.clear()
        xr, yr, _, rev = _tree_case("regression")
        TT.RandomForestRegressor(num_trees=2, max_depth=2).cv_sweep(
            xr, yr, tw, vw, [{}], rev.metric_fn(), CPU)
        assert seen and not any(seen)


# -- the selectors through Workflow.train ------------------------------------------

def _train_both(x, y, jsel, tsel, test_fraction=0.0):
    label = JFB.RealNN("label").extract_field().as_response()
    vec = JFB.OPVector("d").extract_field().as_predictor()
    pred = label.transform_with(jsel, vec)
    jds = JDs({"label": JCol.from_values(JRealNN, y.tolist()), "d": JCol.vector(x)})
    jmodel = JWorkflow().set_input_dataset(jds).set_result_features(label, pred) \
        .train(test_fraction=test_fraction)
    port_draws = TT.draw_bootstrap
    TT.draw_bootstrap = reference_bootstrap
    try:
        tlabel = TFB.RealNN("label").extract_field().as_response()
        tvec = TFB.OPVector("d").extract_field().as_predictor()
        tpred = tlabel.transform_with(tsel, tvec)
        tds = TDs({"label": TCol.from_values(TRealNN, y.tolist()), "d": TCol.vector(x)})
        tmodel = TWorkflow().set_input_dataset(tds).set_result_features(
            tlabel, tpred).train(test_fraction=test_fraction, device="cpu")
    finally:
        TT.draw_bootstrap = port_draws
    return jmodel, jmodel.fitted[jsel.uid].summary, tmodel, tmodel.fitted[tsel.uid].summary


def _same_selection(jsum, tsum, n_evaluations):
    assert (tsum.best_model_name, tsum.best_grid) == (jsum.best_model_name,
                                                      jsum.best_grid)
    assert [(e.model_name, e.grid) for e in tsum.validation_results] == \
        [(e.model_name, e.grid) for e in jsum.validation_results]
    assert len(tsum.validation_results) == n_evaluations
    for te, je in zip(tsum.validation_results, jsum.validation_results):
        _close(te.metric_values, je.metric_values, *FAMILY_TOL[je.model_name],
               f"{je.model_name} {je.grid}")
    assert tsum.data_prep.kind == jsum.data_prep.kind
    assert tsum.data_prep.details == jsum.data_prep.details


@pytest.fixture(scope="module")
def regression_runs():
    x, y = regression_data(seed=20)
    return _train_both(x, y, JSel.RegressionModelSelector.with_cross_validation(seed=7),
                       TSel.RegressionModelSelector.with_cross_validation(seed=7))


@pytest.fixture(scope="module")
def multiclass_runs():
    x, y = multiclass_data(classes=3, seed=21)
    return _train_both(
        x, y, JSel.MultiClassificationModelSelector.with_cross_validation(seed=7),
        TSel.MultiClassificationModelSelector.with_cross_validation(seed=7))


class TestSelectors:
    def test_regression_selector_equals_reference(self, regression_runs):
        _, jsum, tmodel, tsum = regression_runs
        _same_selection(jsum, tsum, 11)
        for k, v in jsum.train_evaluation.items():
            _close(tsum.train_evaluation[k], v, 1e-4, 1e-4, k)
        assert type(tmodel.fitted[next(iter(
            u for u, t in tmodel.fitted.items()
            if type(t).__name__ == "SelectedModel"))].model).__name__.endswith("Model")

    def test_multiclass_selector_equals_reference(self, multiclass_runs):
        _, jsum, _, tsum = multiclass_runs
        _same_selection(jsum, tsum, 8)
        for k in ("error", "precision", "recall", "f1", "top1_accuracy"):
            _close(tsum.train_evaluation[k], jsum.train_evaluation[k], 0, 1e-4, k)

    def test_default_models_equal_the_references(self):
        for jf, tf in ((JSel.RegressionModelSelector, TSel.RegressionModelSelector),
                       (JSel.MultiClassificationModelSelector,
                        TSel.MultiClassificationModelSelector)):
            jm, tm = jf.default_models(), tf.default_models()
            assert [(type(e).__name__, g) for e, g in tm] == \
                [(type(e).__name__, g) for e, g in jm]
            for (je, _), (te, _) in zip(jm, tm):
                assert te.get_params() == {k: v for k, v in je.get_params().items()
                                           if k in te.get_params()}
            js, ts = jf.with_cross_validation(), tf.with_cross_validation()
            assert type(ts.splitter).__name__ == type(js.splitter).__name__
            assert ts.validator.evaluator.default_metric == \
                js.validator.evaluator.default_metric

    def test_train_validation_split_selector_equals_reference(self):
        rng = np.random.default_rng(22)
        x = rng.normal(size=(N, D)).astype(np.float32)
        y = (rng.random(N) < 1 / (1 + np.exp(-x[:, :3].sum(1)))).astype(np.float64)
        models = lambda M: [(M.LogisticRegression(), [{"reg_param": 0.01}]),  # noqa: E731
                            (M.RandomForestClassifier(), [{"num_trees": 5, "max_depth": 3}])]
        from transmogrifai_tpu.models import logistic as JLo
        from transmogrifai_tpu_torch.models import logistic as TLo

        class JM_:
            LogisticRegression = JLo.LogisticRegression
            RandomForestClassifier = JT.RandomForestClassifier

        class TM_:
            LogisticRegression = TLo.LogisticRegression
            RandomForestClassifier = TT.RandomForestClassifier

        _, jsum, _, tsum = _train_both(
            x, y, JSel.BinaryClassificationModelSelector.with_train_validation_split(
                models=models(JM_)),
            TSel.BinaryClassificationModelSelector.with_train_validation_split(
                models=models(TM_)))
        assert tsum.validation_type == jsum.validation_type == "TrainValidationSplit"
        _same_selection(jsum, tsum, 2)
        assert all(len(e.metric_values) == 1 for e in tsum.validation_results)

    @pytest.mark.parametrize("kind", ["regression", "multiclass"])
    def test_holdout_metrics_equal_reference(self, kind):
        models = {"regression": lambda M: [(M.LinearRegression(), [{"reg_param": 0.01}])],
                  "multiclass": lambda M: [(M.NaiveBayes(), [{"smoothing": 1.0}])]}[kind]
        if kind == "regression":
            x, y = regression_data(seed=23)
            jsel = JSel.RegressionModelSelector.with_cross_validation(models=models(JL))
            tsel = TSel.RegressionModelSelector.with_cross_validation(models=models(TL))
        else:
            x, y = multiclass_data(classes=4, seed=24)
            jsel = JSel.MultiClassificationModelSelector.with_cross_validation(
                models=models(JNB))
            tsel = TSel.MultiClassificationModelSelector.with_cross_validation(
                models=models(TNB))
        _, jsum, _, tsum = _train_both(x, y, jsel, tsel, test_fraction=0.25)
        assert tsum.holdout_evaluation and set(tsum.holdout_evaluation) == \
            set(jsum.holdout_evaluation)
        for k, v in jsum.holdout_evaluation.items():
            if k == "confusion":
                assert tsum.holdout_evaluation[k] == v
            else:
                _close(tsum.holdout_evaluation[k], v, 1e-5, 1e-5, k)


# -- save in one package, load and score in the other --------------------------------

def _fitted_models():
    """(reference class name, JAX model, port model) of every new class,
    each fitted by its package on the same data."""
    xr, yr = regression_data(n=600, d=6, seed=30)
    xm, ym = multiclass_data(n=600, d=6, classes=3, seed=31)
    w = np.ones(600, np.float32)
    out = []
    for jcls, tcls, x, y, kw in (
            (JL.LinearRegression, TL.LinearRegression, xr, yr, {"reg_param": 0.01}),
            (JG.GeneralizedLinearRegression, TG.GeneralizedLinearRegression, xr,
             np.abs(yr) + 0.1, {"family": "gamma"}),
            (JSM.MultinomialLogisticRegression, TSM.MultinomialLogisticRegression,
             xm, ym, {"reg_param": 0.01}),
            (JNB.NaiveBayes, TNB.NaiveBayes, xm, ym, {}),
            (JT.RandomForestRegressor, TT.RandomForestRegressor, xr, yr,
             {"num_trees": 3, "max_depth": 2}),
            (JT.GradientBoostedTreesRegressor, TT.GradientBoostedTreesRegressor, xr, yr,
             {"num_rounds": 3, "max_depth": 2}),
            (JT.DecisionTreeRegressor, TT.DecisionTreeRegressor, xr, yr, {"max_depth": 3}),
            (JT.GradientBoostedTreesClassifier, TT.GradientBoostedTreesClassifier,
             xm, ym, {"num_rounds": 3, "max_depth": 2}),
            (JT.RandomForestClassifier, TT.RandomForestClassifier, xm, ym,
             {"num_trees": 3, "max_depth": 3})):
        out.append((jcls.__name__, x, y, jcls(**kw), tcls(**kw), w))
    return out


def _wired(FB, est):
    label = FB.RealNN("label").extract_field().as_response()
    vec = FB.OPVector("d").extract_field().as_predictor()
    return label, label.transform_with(est, vec)


@pytest.mark.parametrize("case", range(9), ids=[c[0] for c in _fitted_models()])
def test_each_model_class_crosses_between_packages(case, tmp_path):
    _, x, y, jest, test_, _ = _fitted_models()[case]
    jlabel, jpred = _wired(JFB, jest)
    tlabel, tpred = _wired(TFB, test_)
    jds = JDs({"label": JCol.from_values(JRealNN, y.tolist()), "d": JCol.vector(x)})
    tds = TDs({"label": TCol.from_values(TRealNN, y.tolist()), "d": TCol.vector(x)})
    jmodel = JWorkflow().set_input_dataset(jds).set_result_features(jlabel, jpred).train()
    tmodel = TWorkflow().set_input_dataset(tds).set_result_features(
        tlabel, tpred).train(device="cpu")
    jmodel.save(str(tmp_path / "jax"))
    tmodel.save(str(tmp_path / "port"))
    feats_t = TDs({"d": TCol.vector(x[:64])})
    feats_j = JDs({"d": JCol.vector(x[:64])})
    # the port loads the JAX package's model and scores as the JAX model does
    t_of_j = TWorkflowModel.load(str(tmp_path / "jax")).score(feats_t, device="cpu")
    want = jmodel.score(feats_j)[jpred.name]
    got = t_of_j[jpred.name]
    assert type(got).__name__ == "PredictionColumn"
    _close(got.data, want.data, 1e-9, 1e-9)
    # the JAX package loads the port's model and scores as the port does
    j_of_t = JWorkflowModel.load(str(tmp_path / "port")).score(feats_j)
    _close(j_of_t[tpred.name].data, tmodel.score(feats_t, device="cpu")[tpred.name].data,
           1e-9, 1e-9)
    loaded = TWorkflowModel.load(str(tmp_path / "port")).fitted[tpred.origin_stage.uid]
    assert type(loaded).__name__ == type(jmodel.fitted[jpred.origin_stage.uid]).__name__
