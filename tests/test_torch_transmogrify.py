"""Training the wide pipeline from raw columns: the port against the JAX package.

The pipeline is the committed ``serving_wide`` fixture's (``Real`` with 10 %
missing, the first few also ``auto_bucketize(label)``d, Zipf ``PickList``s,
``Binary``; ``label.sanity_check(transmogrify(...))``; a 2-fold CV
LogisticRegression selector), written the same way against either package
(``tests/torch_wide_data.py``).  At a cut of 3000 rows (6 Real, 3
bucketized, 4 PickLists, 2 Binary) the JAX package's ``Workflow.train`` (its
encode kernels in interpret mode, as its own tests run them) and the port's
``Workflow.train(device="cpu")`` fit the same columns:

- the fitted fills, vocabularies, bucketizer splits and kept indices are
  equal (``==``);
- the training vector is bitwise the reference's fused transform;
- the LR CV metrics lie within 1e-4 and the refit coefficients within
  rtol 1e-4 / atol 1e-5.

The port's pre-selector stages, trained on the fixture's own 20 000 rows at
full width, equal the committed fixture the JAX package trained.  A flush encodes every
one-hot and bucketize slot in one call, a failure in it raises, and the
``map`` family, which the port lacks, raises by name.
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.models.logistic import LogisticRegression as JLR
from transmogrifai_tpu.perf.kernels import dispatch as KD
from transmogrifai_tpu.types import feature_type_by_name as jft
from transmogrifai_tpu.workflow import fit as JFit
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.ops import numeric as TN
from transmogrifai_tpu_torch.ops.transmogrifier import UNPORTED_FAMILIES
from transmogrifai_tpu_torch.perf.kernels import encode as TKE
from transmogrifai_tpu_torch.types import FeatureType
from transmogrifai_tpu_torch.types import feature_type_by_name as tft
from transmogrifai_tpu_torch.workflow import fit as TFit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_wide_data import FIXTURE_SHAPE, make_data, wide_pipeline  # noqa: E402

FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "serving_wide")
CUT = dict(n_real=6, n_bucketized=3, n_pick=4, n_levels=30, n_binary=2)
CUT_ROWS = 3000
J_NS = types.SimpleNamespace(
    FeatureBuilder=J.FeatureBuilder, transmogrify=J.transmogrify,
    BinaryClassificationModelSelector=J.BinaryClassificationModelSelector,
    LogisticRegression=JLR)


def train_both(n=CUT_ROWS, shape=CUT, seed=0):
    """The pipeline trained by both packages on the same columns: a dict
    with, for each package ("j", "t"), its model, dataset and pipeline
    handles (label, selector, checker, prediction)."""
    cols, schema = make_data(n, seed=seed, **shape)
    out = {}
    jf = {s["name"]: jft(s["type"]) for s in schema}
    jl, jsel, jchk, jpred = wide_pipeline(J_NS, jf, schema)
    jds = J.Dataset.from_features(cols, jf)
    with KD.force_kernel_mode("interpret"):
        jm = J.Workflow().set_input_dataset(jds).set_result_features(jl, jpred).train()
    out["j"] = dict(model=jm, ds=jds, label=jl, sel=jsel, chk=jchk, pred=jpred)
    tf = {s["name"]: tft(s["type"]) for s in schema}
    tl, tsel, tchk, tpred = wide_pipeline(T, tf, schema)
    tds = T.Dataset.from_features(cols, tf)
    wf = T.Workflow().set_input_dataset(tds).set_result_features(tl, tpred)
    tm = wf.train(device="cpu")
    out["t"] = dict(model=tm, ds=tds, label=tl, sel=tsel, chk=tchk, pred=tpred,
                    profile=wf.last_train_profile)
    out["cols"], out["schema"] = cols, schema
    return out


@pytest.fixture(scope="module")
def both():
    return train_both()


def fitted_by(model, cls: str) -> dict:
    """The fitted stages of class ``cls``, keyed by their input feature names
    (uids differ between the packages; the raw names do not)."""
    return {tuple(f.name for f in t.inputs): t for t in model.fitted.values()
            if type(t).__name__ == cls}


def _vector(side: dict, pkg: str):
    """The combined training vector, through each package's whole-table
    transform of the fitted stages (the plan a training flush runs)."""
    vec = side["chk"].inputs[1]
    if pkg == "j":
        with KD.force_kernel_mode("interpret"):
            return JFit.transform_dag(side["ds"], [vec], side["model"].fitted)[vec.name]
    return TFit.transform_dag(side["ds"], [vec], side["model"].fitted, "cpu")[vec.name]


def _meta(meta) -> dict:
    """Vector metadata without its name (the vector feature's name carries
    a stage uid, which each package counts on its own)."""
    d = meta.to_dict()
    d.pop("name")
    return d


def test_make_data_copy_equals_the_fixture_maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_serving_fixture",
        os.path.join(REPO, "tools", "make_torch_serving_fixture.py"))
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    for seed in (0, 5):
        assert make_data(500, seed=seed, **CUT) == maker.make_data(500, seed=seed, **CUT)
    assert make_data(200, **FIXTURE_SHAPE) == maker.make_data(200, **FIXTURE_SHAPE)


class TestFittedStates:
    @pytest.mark.parametrize("cls, attr", [
        ("NumericVectorizerModel", "fills"),
        ("OneHotVectorizerModel", "vocabs"),
        ("DecisionTreeNumericBucketizerModel", "splits"),
        ("DecisionTreeNumericBucketizerModel", "should_split"),
    ])
    def test_equal(self, both, cls, attr):
        js, ts = fitted_by(both["j"]["model"], cls), fitted_by(both["t"]["model"], cls)
        assert js.keys() == ts.keys() and len(js) > 0
        for k in js:
            a, b = getattr(js[k], attr), getattr(ts[k], attr)
            if attr == "fills":
                assert b.dtype == np.float64 and np.array_equal(a, b), k
            else:
                assert a == b, k
        if attr == "splits":
            assert any(t.should_split for t in ts.values())

    def test_kept_indices_and_dropped(self, both):
        jm = both["j"]["model"].fitted[both["j"]["chk"].uid]
        tm = both["t"]["model"].fitted[both["t"]["chk"].uid]
        assert tm.kept_indices == jm.kept_indices
        assert tm.summary.dropped == jm.summary.dropped
        assert tm.summary.kept_indices == jm.summary.kept_indices
        assert _meta(tm.meta) == _meta(jm.meta)


def test_training_vector_bitwise(both):
    jv, tv = _vector(both["j"], "j"), _vector(both["t"], "t")
    a, b = np.asarray(jv.data), tv.data
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()
    assert _meta(tv.meta) == _meta(jv.meta)
    # 2 x 6 numeric + 4 x 22 one-hot + 2 x 2 binary + the bucketizers'
    assert b.shape[1] > 2 * 6 + 4 * 22 + 2 * 2


def test_sanity_stats_within_tolerance(both):
    js = both["j"]["model"].fitted[both["j"]["chk"].uid].summary
    ts = both["t"]["model"].fitted[both["t"]["chk"].uid].summary
    assert (ts.sample_size, ts.label_distinct, ts.correlation_type) == \
        (js.sample_size, js.label_distinct, js.correlation_type)
    assert len(ts.stats) == len(js.stats)
    for a, b in zip(js.stats, ts.stats):
        assert a.name == b.name
        for k in ("mean", "variance", "min", "max", "corr_label", "cramers_v",
                  "max_rule_confidence", "support"):
            x, y = getattr(a, k), getattr(b, k)
            if x is None or y is None:
                assert x is None and y is None, (a.name, k)
            else:
                np.testing.assert_allclose(y, x, rtol=0, atol=1e-5, err_msg=f"{a.name} {k}")
    np.testing.assert_allclose(ts.correlations_feature,
                               np.asarray(js.correlations_feature), rtol=0, atol=1e-5)
    assert ts.correlation_indices == list(js.correlation_indices)


def test_lr_cv_metrics_and_refit(both):
    js = both["j"]["model"].fitted[both["j"]["sel"].uid]
    ts = both["t"]["model"].fitted[both["t"]["sel"].uid]
    assert (ts.summary.best_model_name, ts.summary.best_grid) == \
        (js.summary.best_model_name, js.summary.best_grid)
    for a, b in zip(js.summary.validation_results, ts.summary.validation_results):
        assert a.grid == b.grid
        np.testing.assert_allclose(b.metric_values, a.metric_values, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.model.coef, np.asarray(js.model.coef),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.model.intercept, js.model.intercept,
                               rtol=1e-4, atol=1e-5)


def test_scores_equal_the_reference(both):
    """``model.score`` of the raw table (one whole-table plan in the port)."""
    jp = both["j"]["model"].score(both["j"]["ds"])[both["j"]["pred"].name]
    tp = both["t"]["model"].score(both["t"]["ds"], device="cpu")[both["t"]["pred"].name]
    np.testing.assert_allclose(tp.prob, np.asarray(jp.prob), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tp.pred, np.asarray(jp.pred))


class TestFlush:
    def test_every_slot_of_a_flush_in_one_encode_call(self, both, monkeypatch):
        """The stages the checker needs flush together: the 4 one-hot and
        every split bucketizer's slot through one ``encode_slots`` call over
        all rows."""
        calls = []
        real = TKE.encode_slots_torch

        def counted(inputs, table, out=None):
            calls.append((len(table), int(inputs[0].shape[0])))
            return real(inputs, table, out)

        monkeypatch.setattr(TKE, "encode_slots_torch", counted)
        t = both["t"]
        split = sum(m.should_split for m in fitted_by(t["model"],
                    "DecisionTreeNumericBucketizerModel").values())
        TFit.transform_dag(t["ds"], [t["chk"].inputs[1]], t["model"].fitted, "cpu")
        assert calls == [(4 + split, CUT_ROWS)]
        flushes = [r for r in t["profile"] if r["kind"] == "flush"]
        assert flushes[0]["encode_slots"] == 4 + split
        assert flushes[0]["rows"] == CUT_ROWS
        fits = [r["stage"] for r in t["profile"] if r["kind"] == "fit"]
        assert fits[-2:] == ["SanityChecker", "ModelSelector"]

    def test_a_failure_in_the_plan_raises(self, monkeypatch):
        def boom(self, *xs):
            raise RuntimeError("device half failed")

        monkeypatch.setattr(TN.NumericVectorizerModel, "device_transform", boom)
        cols, schema = make_data(400, **CUT)
        tf = {s["name"]: tft(s["type"]) for s in schema}
        label, _, _, pred = wide_pipeline(T, tf, schema)
        wf = T.Workflow().set_input_dataset(T.Dataset.from_features(cols, tf)) \
            .set_result_features(label, pred)
        with pytest.raises(RuntimeError, match="device half failed"):
            wf.train(device="cpu")


class TestTransmogrify:
    def test_families_in_the_reference_order(self):
        names = ["y", "r", "i", "b", "p", "c", "v"]
        jtypes = ["RealNN", "Real", "Integral", "Binary", "PickList", "City", "OPVector"]

        def stages(pkg, ftype_of):
            fs = [pkg.FeatureBuilder.of(n, ftype_of(t)).extract_field().as_predictor()
                  for n, t in zip(names, jtypes)]
            vec = pkg.transmogrify(fs)
            return [(type(p.origin_stage).__name__ if p.origin_stage.inputs else p.name,
                     getattr(p.origin_stage, "fill_strategy", None),
                     [f.name for f in p.origin_stage.inputs])
                    for p in vec.parents]

        assert stages(T, tft) == stages(J, jft)

    @pytest.mark.parametrize("family", sorted(UNPORTED_FAMILIES))
    def test_unported_family_raises_by_name(self, family):
        # only the typed maps are left: a subclass of the port's OPMap under
        # the reference's type name stands for one
        assert family == "map"
        from transmogrifai_tpu_torch.types import OPMap

        ftype = type("RealMap", (OPMap,), {"__slots__": ()})
        f = T.FeatureBuilder.of("x", ftype).extract_field().as_predictor()
        r = T.FeatureBuilder.Real("r").extract_field().as_predictor()
        with pytest.raises(NotImplementedError,
                           match=f"'{family}' family.*{UNPORTED_FAMILIES[family]}"):
            T.transmogrify([r, f])

    def test_text_and_an_unknown_type(self):
        # free text vectorizes now (tests/test_torch_families.py); a type
        # outside every family still raises
        odd = type("Odd", (FeatureType,), {"__slots__": ()})
        f = T.FeatureBuilder.of("o", odd).extract_field().as_predictor()
        with pytest.raises(NotImplementedError, match="no default vectorizer for Odd"):
            T.transmogrify([f])

    def test_sequence_inputs_are_checked(self):
        r = T.FeatureBuilder.Real("r").extract_field().as_predictor()
        p = T.FeatureBuilder.PickList("p").extract_field().as_predictor()
        with pytest.raises(TypeError, match="expected OPNumeric"):
            r.transform_with(T.NumericVectorizer(), p)
        with pytest.raises(ValueError, match="Invalid value for param"):
            T.NumericVectorizer(fill_strategy="median")


@pytest.mark.parametrize("strategy", ["mode", "constant", "mean"])
def test_numeric_fill_strategies_equal(strategy):
    rng = np.random.default_rng(11)
    vals = [[None if rng.random() < 0.2 else int(v) for v in rng.integers(0, 5, 300)]
            for _ in range(3)]
    vals.append([None] * 300)   # all missing: the fill falls back
    from transmogrifai_tpu.ops.numeric import NumericVectorizer as JNV

    fills = []
    for pkg, ft, est in ((J, jft, JNV(fill_strategy=strategy, fill_constant=2.5)),
                         (T, tft, TN.NumericVectorizer(fill_strategy=strategy,
                                                       fill_constant=2.5))):
        fs = [pkg.FeatureBuilder.of(f"i{j}", ft("Integral")).extract_field().as_predictor()
              for j in range(4)]
        fs[0].transform_with(est, *fs[1:])
        ds = pkg.Dataset.from_features({f"i{j}": v for j, v in enumerate(vals)},
                                       {f"i{j}": ft("Integral") for j in range(4)})
        m = est.fit(ds, device="cpu") if pkg is T else est.fit(ds)
        fills.append(np.asarray(m.fills))
    assert fills[0].dtype == fills[1].dtype and np.array_equal(fills[0], fills[1])


def test_fill_missing_with_mean_and_z_normalize_through_the_plan():
    """The DSL's mean fill and z-normalization: fitted constants equal, and
    the whole-table plan's columns bitwise the reference's fused ones."""
    rng = np.random.default_rng(4)
    x = [None if rng.random() < 0.15 else float(v) for v in rng.normal(2, 3, 500)]
    outs = []
    for pkg, ft in ((J, jft), (T, tft)):
        r = pkg.FeatureBuilder.of("x", ft("Real")).extract_field().as_predictor()
        z = r.fill_missing_with_mean().z_normalize()
        ds = pkg.Dataset.from_features({"x": x}, {"x": ft("Real")})
        wf = pkg.Workflow().set_input_dataset(ds).set_result_features(z)
        m = wf.train(device="cpu") if pkg is T else wf.train()
        fit = sorted((type(t).__name__, t.mean, getattr(t, "std", None))
                     for t in m.fitted.values())
        scored = m.score(ds, device="cpu") if pkg is T else m.score(ds)
        outs.append((fit, np.asarray(scored[z.name].data)))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1].tobytes() == outs[1][1].tobytes()


class TestCommittedFixture:
    """The port trains the fixture's pre-selector stages on its 20 000 rows
    (seed 0) at full width; the JAX package trained the committed model the
    same way.  (The LR fit at this size is held to the fixture on the card,
    by ``chip_smoke.py``'s ``training_raw`` phase: on a CPU the 866-wide LR
    sweep takes longer than this whole file.)"""

    @pytest.fixture(scope="class")
    def trained(self):
        cols, schema = make_data(20000, **FIXTURE_SHAPE)
        tf = {s["name"]: tft(s["type"]) for s in schema}
        label, _, chk, _ = wide_pipeline(T, tf, schema)
        model = T.Workflow().set_input_dataset(T.Dataset.from_features(cols, tf)) \
            .set_result_features(label, chk.get_output()).train(device="cpu")
        return model, chk, T.WorkflowModel.load(FIXTURE)

    @pytest.mark.parametrize("cls, attr", [
        ("NumericVectorizerModel", "fills"),
        ("OneHotVectorizerModel", "vocabs"),
        ("DecisionTreeNumericBucketizerModel", "splits"),
    ])
    def test_stages_equal(self, trained, cls, attr):
        model, _, fixture = trained
        got, want = fitted_by(model, cls), fitted_by(fixture, cls)
        assert got.keys() == want.keys() and len(got) >= 1
        for k in got:
            a, b = getattr(got[k], attr), getattr(want[k], attr)
            assert (np.array_equal(a, b) if attr == "fills" else a == b), k

    def test_kept_indices_and_stats(self, trained):
        """866 columns: past the reference's ``max_features_for_full_corr``
        (512), where it built the matrix by its ring of column shards; the
        port's one gram product agrees."""
        model, chk, fixture = trained
        [want] = fitted_by(fixture, "SanityCheckerModel").values()
        got = model.fitted[chk.uid]
        assert got.kept_indices == want.kept_indices
        assert got.meta.to_dict()["columns"] == want.meta.to_dict()["columns"]
        gs, ws = got.summary, want.summary
        assert len(gs.stats) == len(ws.stats) == 866
        for a, b in zip(ws.stats, gs.stats):
            assert a.name == b.name
            for k in ("mean", "variance", "corr_label", "cramers_v", "support"):
                x, y = getattr(a, k), getattr(b, k)
                if x is None:
                    assert y is None
                else:
                    np.testing.assert_allclose(y, x, rtol=0, atol=1e-5, err_msg=f"{a.name} {k}")
        np.testing.assert_allclose(gs.correlations_feature, ws.correlations_feature,
                                   rtol=0, atol=1e-5)


def test_training_runs_with_no_card_only_on_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols, schema = make_data(50, **CUT)
    tf = {s["name"]: tft(s["type"]) for s in schema}
    label, _, _, pred = wide_pipeline(T, tf, schema)
    wf = T.Workflow().set_input_dataset(T.Dataset.from_features(cols, tf)) \
        .set_result_features(label, pred)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.train()
