"""ModelInsights, RecordInsightsLOCO and RecordInsightsCorr: the port
against the JAX package.

- ``model_insights().to_dict()``: the same keys, feature and slot names,
  dropped reasons, label summary and selected-model info; floats within
  1e-6 relative to max(1, |v|).  Port-trained against JAX-trained on the
  reference's insights pipeline (uids aside: each package counts its own);
  the JAX-saved wide workflow-CV model (``fixtures/workflow_cv``) loaded by
  the port against the record, uids included; save -> load both ways.
- LOCO: parsed diffs within 1e-9 for linear and MLP models (float64
  re-scoring), within 1e-6 for tree ensembles (float32 leaf sums); top-K
  names equal wherever the ranked values differ by more than 1e-9.  Every
  strategy, ``top_k``, group aggregation, inactive slots, the ``slot_j``
  names, and the record's LOCO of the JAX-saved wide model over 256 rows.
- Corr: equal to the reference's (host numpy in both packages).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.insights import RecordInsightsCorr as JCorr
from transmogrifai_tpu.insights import RecordInsightsLOCO as JLOCO
from transmogrifai_tpu.models import mlp as JM
from transmogrifai_tpu.models import trees as JT
from transmogrifai_tpu.models.logistic import LogisticRegression as JLR
from transmogrifai_tpu.models.logistic import LogisticRegressionModel as JLRM
from transmogrifai_tpu.perf.kernels import dispatch as KD
from transmogrifai_tpu.utils import vector_metadata as JVM
from transmogrifai_tpu.workflow.workflow import WorkflowModel as JWM
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.data.dataset import Column
from transmogrifai_tpu_torch.insights import (
    ModelInsights,
    RecordInsightsCorr,
    RecordInsightsLOCO,
    extract_model_insights,
)
from transmogrifai_tpu_torch.insights.model_insights import _model_contributions
from transmogrifai_tpu_torch.models import mlp as TM
from transmogrifai_tpu_torch.models import trees as TT
from transmogrifai_tpu_torch.models.logistic import LogisticRegression as TLR
from transmogrifai_tpu_torch.models.logistic import LogisticRegressionModel as TLRM
from transmogrifai_tpu_torch.utils import vector_metadata as TVM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_wide_data import insights_deviation, loco_deviation, make_data  # noqa: E402

RECORD = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "workflow_cv")
UID_KEYS = {"bestModelUID"}


def _close(a, b, uids=True):
    """Floats within 1e-6 relative to max(1, |v|), everything else ``==``
    (``bestModelUID`` skipped unless ``uids``)."""
    assert insights_deviation(a, b, frozenset() if uids else UID_KEYS) <= 1e-6


def _plain(d):
    """JSON round trip (tuples -> lists, numpy scalars -> floats)."""
    from transmogrifai_tpu_torch.insights.model_insights import _json_default

    return json.loads(json.dumps(d, default=_json_default))


def _insights_pipeline(pkg):
    lr = JLR if pkg is J else TLR
    rng = np.random.default_rng(11)
    n = 600
    strong, weak, noise = (rng.normal(0, 1, n) for _ in range(3))
    color = rng.choice(["red", "blue"], n)
    logit = 2.5 * strong + 0.3 * weak + 0.8 * (color == "red")
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(float)
    ds = pkg.Dataset.from_features(
        {"label": y.tolist(), "strong": strong.tolist(), "weak": weak.tolist(),
         "noise": noise.tolist(), "color": color.tolist()},
        {"label": pkg.types.RealNN, "strong": pkg.types.Real, "weak": pkg.types.Real,
         "noise": pkg.types.Real, "color": pkg.types.PickList})
    label = pkg.FeatureBuilder.RealNN("label").extract_field().as_response()
    feats = [pkg.FeatureBuilder.Real(c).extract_field().as_predictor()
             for c in ("strong", "weak", "noise")]
    feats.append(pkg.FeatureBuilder.PickList("color").extract_field().as_predictor())
    checked = label.sanity_check(pkg.transmogrify(feats))
    sel = pkg.BinaryClassificationModelSelector.with_train_validation_split(
        models=[(lr(), [{"reg_param": 0.01}])])
    pred = label.transform_with(sel, checked)
    wf = pkg.Workflow().set_result_features(label, pred).set_input_dataset(ds)
    if pkg is J:
        with KD.force_kernel_mode("interpret"):
            return wf.train(), ds, pred
    return wf.train(device="cpu"), ds, pred


@pytest.fixture(scope="module")
def fitted():
    return {"j": _insights_pipeline(J), "t": _insights_pipeline(T)}


def _no_uid_stage_info(d):
    d = dict(d)
    d["stageInfo"] = sorted((v["class"], json.dumps(v["params"], sort_keys=True))
                            for v in d["stageInfo"].values())
    return d


class TestModelInsights:
    def test_equals_the_reference(self, fitted):
        jd = _plain(fitted["j"][0].model_insights().to_dict())
        td = _plain(fitted["t"][0].model_insights().to_dict())
        _close(_no_uid_stage_info(jd), _no_uid_stage_info(td), uids=False)

    def test_structure(self, fitted):
        model = fitted["t"][0]
        ins = model.model_insights()
        assert isinstance(ins, ModelInsights)
        assert ins.label.name == "label" and ins.label.distinct_count == 2
        assert {"strong", "weak", "noise", "color"} <= {f.feature_name for f in ins.features}
        assert ins.selected_model_info["bestModelName"] == "LogisticRegression"
        by_name = {f.feature_name: f for f in ins.features}
        assert by_name["strong"].max_contribution > by_name["noise"].max_contribution
        slots = [d for f in ins.features for d in f.derived]
        assert any(d.corr_label is not None for d in slots)
        assert any(d.variance is not None for d in slots)
        d = json.loads(ins.to_json())
        assert d["label"]["name"] == "label" and len(d["features"]) >= 4 and d["stageInfo"]
        text = ins.pretty()
        assert "Top contributing slots" in text and "strong" in text

    def test_after_save_and_load_both_ways(self, fitted, tmp_path):
        import transmogrifai_tpu.models.logistic  # noqa: F401

        for src, load in (("t", JWM.load), ("j", T.WorkflowModel.load)):
            path = str(tmp_path / src)
            fitted[src][0].save(path)
            before = _plain(fitted[src][0].model_insights().to_dict())
            after = _plain(load(path).model_insights().to_dict())
            _close(before, after)
        loaded = T.WorkflowModel.load(str(tmp_path / "t"))
        by_name = {f.feature_name: f for f in loaded.model_insights().features}
        assert by_name["strong"].max_contribution > by_name["noise"].max_contribution

    def test_jax_saved_workflow_cv_model_equals_the_record(self):
        with open(os.path.join(RECORD, "insights.json")) as fh:
            want = json.load(fh)
        got = _plain(T.WorkflowModel.load(RECORD).model_insights().to_dict())
        _close(want, got)
        assert extract_model_insights(T.WorkflowModel.load(RECORD)).label.sample_size == \
            want["label"]["sampleSize"]


class TestContributions:
    def test_multiclass_coef_axis(self):
        class Fake:
            coef = np.arange(12.0).reshape(4, 3)

        out = _model_contributions(Fake(), 4)
        assert len(out) == 4 and out[1] == [3.0, 4.0, 5.0]

    def test_binary_coef_shorter_than_d(self):
        class Fake:
            coef = np.array([1.0, 2.0])

        assert _model_contributions(Fake(), 4) == [[1.0], [2.0], [], []]

    def test_tree_importances(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(300, 4)).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.float64)
        jm = JT.GradientBoostedTreesClassifier(num_rounds=5, max_depth=2)._fit_arrays(
            x, y, np.ones_like(y, dtype=np.float32))
        tm = _tree_twin(jm, TT.GBTClassifierModel)
        assert _model_contributions(tm, 4) == \
            [[float(v)] for v in jm.feature_importances(4)]


# -- LOCO ------------------------------------------------------------------------

def _metas(columns):
    """The same vector metadata in both packages: columns are
    (parent, type, grouping) triples."""
    out = []
    for mod in (JVM, TVM):
        out.append(mod.VectorMetadata("vec", [
            mod.VectorColumnMetadata(p, t, grouping=g, index=i)
            for i, (p, t, g) in enumerate(columns)]))
    return out


def assert_same_insights(want_rows, got_rows, strategy, atol):
    """Row by row: parsed diffs within ``atol``; the ordered names equal
    wherever the ranked values differ by more than max(1e-9, atol)."""
    assert loco_deviation(want_rows, got_rows, strategy, max(1e-9, atol)) <= atol


def _both_loco(jmodel, tmodel, x, columns=None, atol=1e-9, **kw):
    jmeta, tmeta = _metas(columns) if columns else (None, None)
    want = JLOCO(jmodel, meta=jmeta, **kw).transform_columns(
        [J.Column.vector(x, jmeta)], None)
    t = RecordInsightsLOCO(tmodel, meta=tmeta, device="cpu", **kw)
    got = t.transform_columns([Column.vector(x, tmeta)], None)
    assert_same_insights(list(want.data), list(got.data), kw.get("strategy", "abs"), atol)
    return list(got.data), t


TOY = [("a", "Real", None), ("b", "Real", None), ("c", "Real", None)]


def _toy():
    coef = np.array([3.0, 0.0, -1.0])
    return JLRM(coef=coef, intercept=0.0), TLRM(coef=coef, intercept=0.0)


def _tree_twin(jm, cls):
    """The port's tree model over the reference model's arrays."""
    trees = jm.trees._asdict() if hasattr(jm.trees, "_asdict") else jm.trees
    return cls(trees={k: np.asarray(v) for k, v in trees.items()},
               edges=np.asarray(jm.edges), max_depth=jm.max_depth, n_bins=jm.n_bins,
               base_score=np.asarray(jm.base_score))


class TestLOCO:
    def test_finds_influential_slot(self):
        got, _ = _both_loco(*_toy(), np.array([[1.0, 1.0, 1.0], [0.5, 2.0, 0.0]]), TOY,
                            top_k=3)
        first = RecordInsightsLOCO.parse(got[0])
        assert list(first)[0].startswith("a") and first[list(first)[0]][-1] > 0

    def test_inactive_slots_skipped(self):
        got, t = _both_loco(*_toy(), np.array([[0.0, 1.0, 0.0]]), TOY)
        assert all(n.startswith("b") for n in RecordInsightsLOCO.parse(got[0]))
        assert t.last_profile["pairs"] == 1

    @pytest.mark.parametrize("strategy", ["abs", "positive", "negative"])
    @pytest.mark.parametrize("top_k", [1, 2, 20])
    def test_strategies_and_top_k(self, strategy, top_k):
        rng = np.random.default_rng(13)
        x = rng.normal(size=(40, 12))
        x[rng.random(x.shape) < 0.4] = 0.0
        coef = rng.normal(size=12)
        got, _ = _both_loco(JLRM(coef=coef, intercept=0.3), TLRM(coef=coef, intercept=0.3),
                            x, None, strategy=strategy, top_k=top_k)
        assert all(len(r) <= top_k for r in got)
        assert all(k.startswith("slot_") for r in got for k in r)

    def test_group_aggregation(self):
        cols = [("txt", "Text", "hash"), ("txt", "Text", "hash"), ("num", "Real", None)]
        coef = np.array([1.0, 1.0, 2.0])
        got, _ = _both_loco(JLRM(coef=coef, intercept=0.0), TLRM(coef=coef, intercept=0.0),
                            np.array([[1.0, 1.0, 1.0], [0.0, 2.0, -1.0]]), cols)
        parsed = RecordInsightsLOCO.parse(got[0])
        assert "txt_hash" in parsed and len(parsed) == 2

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_group_sums_add_in_slot_order(self, seed):
        """Each key's rows are added one after another in their order, from
        0 -- the reference's ``diffs[i, active].sum(axis=0)`` -- bitwise,
        with magnitudes spread so that another order gives other bits."""
        from transmogrifai_tpu_torch.insights.loco import group_sums

        rng = np.random.default_rng(seed)
        key = rng.integers(0, 50, size=2000)
        diffs = rng.normal(size=(2000, 2)) * 10.0 ** rng.integers(-8, 8, size=(2000, 1))
        want = np.zeros((60, 2))
        for kk, v in zip(key, diffs):
            want[kk] = want[kk] + v
        got = group_sums(torch.from_numpy(key), torch.from_numpy(diffs), 60).numpy()
        assert got.tobytes() == want.tobytes()

    def test_meta_of_another_width_names_slots(self):
        jm, tm = _toy()
        jmeta, tmeta = _metas(TOY[:2])
        x = np.ones((2, 3))
        want = JLOCO(jm, meta=jmeta).transform_columns([J.Column.vector(x)], None)
        got = RecordInsightsLOCO(tm, meta=tmeta, device="cpu").transform_columns(
            [Column.vector(x)], None)
        assert_same_insights(list(want.data), list(got.data), "abs", 1e-9)
        assert set(got.data[0]) == {"slot_0", "slot_1", "slot_2"}

    def test_mlp_model(self):
        rng = np.random.default_rng(3)
        weights = [(rng.normal(size=(6, 5)), rng.normal(size=5)),
                   (rng.normal(size=(5, 3)), rng.normal(size=3))]
        classes = np.arange(3.0)
        x = rng.normal(size=(30, 6))
        x[rng.random(x.shape) < 0.3] = 0.0
        _both_loco(JM.MLPClassifierModel(classes=classes, weights=weights),
                   TM.MLPClassifierModel(classes=classes, weights=weights), x, None,
                   top_k=4)

    @pytest.mark.parametrize("family", ["gbt", "forest"])
    def test_tree_models(self, family):
        rng = np.random.default_rng(21)
        x = rng.normal(size=(400, 6)).astype(np.float32)
        y = ((x[:, 0] + 0.5 * x[:, 1]) > 0).astype(np.float64)
        w = np.ones_like(y, dtype=np.float32)
        if family == "gbt":
            jm = JT.GradientBoostedTreesClassifier(num_rounds=10, max_depth=3) \
                ._fit_arrays(x, y, w)
            tm = _tree_twin(jm, TT.GBTClassifierModel)
        else:
            jm = JT.RandomForestClassifier(num_trees=8, max_depth=3)._fit_arrays(x, y, w)
            tm = _tree_twin(jm, TT.ForestClassifierModel)
        xs = x[:120].astype(np.float64)
        xs[rng.random(xs.shape) < 0.3] = 0.0
        _both_loco(jm, tm, xs, None, atol=1e-6, top_k=3)

    def test_jax_saved_wide_model_equals_the_record(self):
        """The JAX-saved workflow-CV model, loaded by the port, scores the
        record's 256 rows; LOCO of its selected model equals the record."""
        with open(os.path.join(RECORD, "states.json")) as fh:
            states = json.load(fh)
        with open(os.path.join(RECORD, "loco.json")) as fh:
            rec = json.load(fh)
        model = T.WorkflowModel.load(RECORD)
        cols, schema = make_data(states["rows"], seed=states["seed"], **states["shape"])
        ftypes = {s["name"]: T.types.feature_type_by_name(s["type"]) for s in schema}
        ds = T.Dataset.from_features(cols, ftypes).take(np.arange(rec["rows"]))
        vec = model.score(ds, keep_intermediate=True, device="cpu")[rec["vector"]]
        for strategy in ("abs", "positive"):
            t = RecordInsightsLOCO(model.selector_model(), top_k=rec[strategy]["top_k"],
                                   strategy=strategy, device="cpu")
            got = t.transform_columns([vec], None)
            assert_same_insights(rec[strategy]["rows"], list(got.data), strategy, 1e-9)
        assert 50 * rec["rows"] < t.last_profile["pairs"] < 866 * rec["rows"]

    def test_e2e_on_fitted_workflow(self, fitted):
        model, ds, pred = fitted["t"]
        sel = model.selector_model()
        vec_col = model.score(ds, keep_intermediate=True, device="cpu")[sel.inputs[1].name]
        out = RecordInsightsLOCO(sel, top_k=5, device="cpu").transform_columns(
            [vec_col.take(np.arange(20))], None)
        assert len(out) == 20
        assert 0 < len(RecordInsightsLOCO.parse(out.data[0])) <= 5
        hits = sum(any(k.startswith("strong") for k in RecordInsightsLOCO.parse(out.data[i]))
                   for i in range(20))
        assert hits >= 15


class TestCorr:
    def test_equals_the_reference(self):
        jm, tm = _toy()
        jmeta, tmeta = _metas(TOY)
        x = np.random.default_rng(5).normal(0, 1, (200, 3))
        want = JCorr(jm, meta=jmeta, top_k=2).transform_columns(
            [J.Column.vector(x, jmeta)], None)
        got = RecordInsightsCorr(tm, meta=tmeta, top_k=2).transform_columns(
            [Column.vector(x, tmeta)], None)
        assert len(got) == 200
        assert list(got.data) == list(want.data)
        assert all(len(r) <= 2 for r in got.data)
