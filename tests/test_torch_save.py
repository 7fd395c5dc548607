"""The port's own save, evaluate and score_and_evaluate against the JAX package.

A model the port trains is saved by the port (FORMAT_VERSION 1:
``model.json.gz`` + ``arrays.npz``); then:

- the port and the JAX package both load it, and both score the same rows to
  the in-memory model's scores (the JAX package's host heads in float64);
- the selector's summary comes back as a ``ModelSelectorSummary`` in both,
  with the winner, the CV table and the train metrics the fit recorded;
- ``evaluate`` on the saved model gives the JAX package's ``evaluate`` on the
  same model and rows, and ``score_and_evaluate`` the same pair;
- a model the JAX package saved, loaded and saved again by the port, still
  loads in both and serves equal records;
- the wide pipeline the port trains from raw columns saves its
  ``SanityCheckerSummary`` (and ``ColumnStats``) under the reference's names:
  the JAX package restores them and scores the model as the port does, and
  the port restores the committed fixture's summary as its own dataclasses.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu.data.dataset import Column as JCol
from transmogrifai_tpu.data.dataset import Dataset as JDs
from transmogrifai_tpu.evaluators.base import Evaluators as JEv
from transmogrifai_tpu.models import logistic, svm, trees  # noqa: F401  (the JAX
# package's loader finds a stage class once its module is imported)
from transmogrifai_tpu.models.selector import ModelSelectorSummary as JSummary
from transmogrifai_tpu.types import RealNN as JRealNN
from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel
from transmogrifai_tpu_torch import BinaryClassificationModelSelector as TSel
from transmogrifai_tpu_torch import Evaluators as TEv
from transmogrifai_tpu_torch import FeatureBuilder as TFB
from transmogrifai_tpu_torch import LinearSVC, LogisticRegression
from transmogrifai_tpu_torch import Workflow as TWorkflow
from transmogrifai_tpu_torch import WorkflowModel as TModel
from transmogrifai_tpu_torch.data.dataset import Column as TCol
from transmogrifai_tpu_torch.data.dataset import Dataset as TDs
from transmogrifai_tpu_torch.models import trees as TT
from transmogrifai_tpu_torch.models.selector import ModelSelectorSummary as TSummary
from transmogrifai_tpu_torch.types import RealNN as TRealNN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "serving_wide")

FAMILIES = {
    "lr": lambda: [(LogisticRegression(), [{"reg_param": 0.01},
                                           {"reg_param": 0.01, "elastic_net": 0.5}])],
    "svc": lambda: [(LinearSVC(), [{"reg_param": 0.01}, {"reg_param": 0.1}])],
    "rf": lambda: [(TT.RandomForestClassifier(num_trees=5, max_depth=3), [{}])],
    "gbt": lambda: [(TT.GradientBoostedTreesClassifier(num_rounds=5, max_depth=2), [{}])],
}
WINNER_MODEL = {"lr": "LogisticRegressionModel", "svc": "LinearSVCModel",
                "rf": "ForestClassifierModel", "gbt": "GBTClassifierModel"}


def _data(n=700, d=8, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d) / np.sqrt(d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ beta) * 2))).astype(np.float64)
    return x, y


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def saved(request, tmp_path_factory):
    """(family, in-memory model, saved path, prediction name, x, y)."""
    x, y = _data()
    label = TFB.RealNN("label").extract_field().as_response()
    vec = TFB.OPVector("d").extract_field().as_predictor()
    sel = TSel.with_cross_validation(num_folds=2, seed=3,
                                     models=FAMILIES[request.param]())
    pred = label.transform_with(sel, vec)
    ds = TDs({"label": TCol.from_values(TRealNN, y.tolist()), "d": TCol.vector(x)})
    model = TWorkflow().set_input_dataset(ds).set_result_features(label, pred) \
        .train(device="cpu")
    path = str(tmp_path_factory.mktemp(f"saved_{request.param}") / "model")
    model.save(path)
    return request.param, model, path, pred.name, sel.uid, x, y


def _tds(x, y=None):
    cols = {"d": TCol.vector(x)}
    if y is not None:
        cols["label"] = TCol.from_values(TRealNN, y.tolist())
    return TDs(cols)


def _jds(x, y=None):
    cols = {"d": JCol.vector(x)}
    if y is not None:
        cols["label"] = JCol.from_values(JRealNN, y.tolist())
    return JDs(cols)


class TestRoundTrip:
    def test_files_and_format(self, saved):
        _, _, path, _, _, _, _ = saved
        assert sorted(os.listdir(path)) == ["arrays.npz", "model.json.gz"]
        with gzip.open(os.path.join(path, "model.json.gz"), "rt") as fh:
            manifest = json.load(fh)
        assert manifest["formatVersion"] == 1

    @pytest.mark.parametrize("n", [300, 700])
    def test_both_packages_load_and_score_equal(self, saved, n):
        fam, model, path, pred, uid, x, _ = saved
        assert type(model.fitted[uid].model).__name__ == WINNER_MODEL[fam]
        mem = model.score(_tds(x[:n]), device="cpu")[pred]
        port = TModel.load(path).score(_tds(x[:n]), device="cpu")[pred]
        ref = JModel.load(path).score(_jds(x[:n]))[pred]
        assert port.data.tobytes() == mem.data.tobytes()
        np.testing.assert_array_equal(np.asarray(ref.pred), port.pred)
        np.testing.assert_allclose(np.asarray(ref.raw), port.raw, rtol=0, atol=1e-6)
        if fam == "svc":
            assert port.prob is None and ref.prob is None
        else:
            np.testing.assert_allclose(np.asarray(ref.prob), port.prob, rtol=0, atol=1e-6)

    def test_summary_restores_in_both(self, saved):
        _, model, path, _, uid, _, _ = saved
        want = model.fitted[uid].summary
        for pkg, cls in ((TModel, TSummary), (JModel, JSummary)):
            got = pkg.load(path).fitted[uid].summary
            assert isinstance(got, cls)
            assert (got.best_model_name, got.best_grid) == (want.best_model_name,
                                                            want.best_grid)
            assert got.train_evaluation == want.train_evaluation
            assert [(e.model_name, e.grid, e.metric_values)
                    for e in got.validation_results] == \
                [(e.model_name, e.grid, e.metric_values) for e in want.validation_results]
            assert got.data_prep.kind == "DataBalancer"


class TestEvaluate:
    def test_evaluate_equals_reference_on_the_saved_model(self, saved):
        fam, model, path, _, uid, x, y = saved
        got = TModel.load(path).evaluate(TEv.binary_classification(), _tds(x, y),
                                         device="cpu")
        ref = JModel.load(path).evaluate(JEv.binary_classification(), _jds(x, y))
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
        # on the rows it was trained on: the train metrics the selector
        # recorded.  Linear heads only: a small tree ensemble's scores tie
        # by the hundred, and its float32 train payload and float64 head
        # break those ties differently (in the JAX package as well)
        if fam not in ("lr", "svc"):
            return
        train = model.fitted[uid].summary.train_evaluation
        for k in train:
            np.testing.assert_allclose(got[k], train[k], rtol=0, atol=1e-6, err_msg=k)

    def test_score_and_evaluate(self, saved):
        _, _, path, pred, _, x, y = saved
        tm = TModel.load(path)
        scored, metrics = tm.score_and_evaluate(TEv.binary_classification(),
                                                _tds(x, y), device="cpu")
        assert metrics == tm.evaluate(TEv.binary_classification(), _tds(x, y),
                                      device="cpu")
        assert pred in scored.names and scored.n_rows == len(y)
        # the dataset first, as the reference forgives
        swapped = tm.evaluate(_tds(x, y), TEv.binary_classification(), device="cpu")
        assert swapped == metrics
        with pytest.raises(TypeError):
            tm.evaluate("auPR", _tds(x, y), device="cpu")

    def test_evaluate_without_a_card_raises(self, saved, monkeypatch):
        _, _, path, _, _, x, y = saved
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TModel.load(path).evaluate(TEv.binary_classification(), _tds(x, y))


def test_jax_saved_model_resaved_by_the_port_loads_in_both(tmp_path):
    import sys

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_serving import _records

    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    path = str(tmp_path / "resaved")
    TModel.load(FIXTURE).save(path)
    recs = _records(schema["features"], 60, 4)
    ref = JModel.load(FIXTURE).serving_plan().score(recs)
    assert JModel.load(path).serving_plan().score(recs) == ref
    assert TModel.load(path).serving_plan(device="cpu").score(recs) == ref


class TestRawPipeline:
    """The wide pipeline trained by the port from raw columns, through
    ``sanity_check``: its ``SanityCheckerSummary`` saves under the
    reference's dataclass names, and either package restores it."""

    @pytest.fixture(scope="class")
    def raw_saved(self, tmp_path_factory):
        import sys

        sys.path.insert(0, os.path.join(REPO, "tests"))
        import transmogrifai_tpu_torch as T
        from torch_wide_data import make_data, wide_pipeline
        from transmogrifai_tpu_torch.types import feature_type_by_name

        cols, schema = make_data(1500, seed=2, n_real=5, n_bucketized=2, n_pick=3,
                                 n_levels=30, n_binary=2)
        ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
        label, _, chk, pred = wide_pipeline(T, ftypes, schema)
        model = T.Workflow().set_input_dataset(T.Dataset.from_features(cols, ftypes)) \
            .set_result_features(label, pred).train(device="cpu")
        path = str(tmp_path_factory.mktemp("raw") / "model")
        model.save(path)
        return model, path, chk.uid, pred.name, cols, schema

    def test_jax_restores_the_summary(self, raw_saved):
        from transmogrifai_tpu.checkers.sanity import ColumnStats as JStats
        from transmogrifai_tpu.checkers.sanity import SanityCheckerSummary as JSan

        model, path, uid, _, _, _ = raw_saved
        want = model.fitted[uid].summary
        got = JModel.load(path).fitted[uid]
        assert isinstance(got.summary, JSan)
        assert all(isinstance(s, JStats) for s in got.summary.stats)
        assert got.kept_indices == model.fitted[uid].kept_indices
        assert got.summary.kept_indices == want.kept_indices
        assert got.summary.dropped == want.dropped
        assert len(got.summary.stats) == len(want.stats)
        for a, b in zip(got.summary.stats, want.stats):
            for k, v in vars(b).items():
                w = getattr(a, k)
                assert w == v or (w != w and v != v), (b.name, k)   # NaN == NaN
        np.testing.assert_array_equal(got.summary.correlations_feature,
                                      want.correlations_feature)

    def test_both_packages_score_equal(self, raw_saved):
        import transmogrifai_tpu as J
        from transmogrifai_tpu.types import feature_type_by_name as jft
        from transmogrifai_tpu_torch.types import feature_type_by_name as tft

        model, path, _, pred, cols, schema = raw_saved
        tds = TDs.from_features(cols, {s["name"]: tft(s["type"]) for s in schema})
        jds = J.Dataset.from_features(cols, {s["name"]: jft(s["type"]) for s in schema})
        mem = model.score(tds, device="cpu")[pred]
        port = TModel.load(path).score(tds, device="cpu")[pred]
        ref = JModel.load(path).score(jds)[pred]
        assert port.prob.tobytes() == mem.prob.tobytes()
        np.testing.assert_array_equal(np.asarray(ref.pred), port.pred)
        np.testing.assert_allclose(np.asarray(ref.prob), port.prob, rtol=0, atol=1e-6)

    def test_port_restores_the_fixture_summary(self):
        from transmogrifai_tpu_torch.checkers.sanity import ColumnStats, SanityCheckerSummary

        [chk] = [t for t in TModel.load(FIXTURE).fitted.values()
                 if type(t).__name__ == "SanityCheckerModel"]
        assert isinstance(chk.summary, SanityCheckerSummary)
        assert all(isinstance(s, ColumnStats) for s in chk.summary.stats)
        assert chk.summary.kept_indices == chk.kept_indices
        assert chk.summary.correlations_feature.shape == (866, 866)
        assert chk.summary.to_dict()["sampleSize"] == 20000
