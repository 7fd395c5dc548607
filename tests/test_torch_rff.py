"""The RawFeatureFilter: the port against the JAX package.

The numeric histograms (the port's one scatter-add in torch, the
reference's jitted XLA program) are held **bitwise**, edge cases included:
a constant column (width 1), an all-missing column, +-inf, values far past
the training edges of a scoring pass, values on the edges.  The hashed
distributions of text, lists, sets and map keys, the summaries and the
Jensen-Shannon divergences are held ``==``.  ``filter_raw`` under several
settings gives equal metrics, blacklists, stripped map keys, filtered
columns and rewired DAGs; a blacklisted result feature raises in both;
``Workflow.with_raw_feature_filter(...).train()`` gives equal models whose
blacklist survives a save in either package and a load in the other.
"""

import importlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import transmogrifai_tpu as J
from transmogrifai_tpu.filters import distribution as JD
from transmogrifai_tpu.filters import raw_feature_filter as JR
from transmogrifai_tpu.models.logistic import LogisticRegression as JLR
from transmogrifai_tpu.types import feature_type_by_name as jft
from transmogrifai_tpu.workflow.dag import compute_dag as jdag
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.filters import distribution as TD
from transmogrifai_tpu_torch.filters import raw_feature_filter as TR
from transmogrifai_tpu_torch.types import feature_type_by_name as tft
from transmogrifai_tpu_torch.workflow.dag import compute_dag as tdag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_families_data import make_families  # noqa: E402
from torch_maps_data import (  # noqa: E402
    PROTECTED,
    fitted_states,
    make_maps,
    make_scoring,
    maps_pipeline,
)

J_NS = types.SimpleNamespace(
    FeatureBuilder=J.FeatureBuilder, transmogrify=J.transmogrify,
    SanityChecker=J.SanityChecker,
    BinaryClassificationModelSelector=J.BinaryClassificationModelSelector,
    LogisticRegression=JLR)


def _pkg(which):
    return (J, jft) if which == "j" else (T, tft)


# -- the numeric histograms -----------------------------------------------------

def _block(case: str, rng):
    """(values (n, d) float64 with NaN missing, lo, hi) of one edge case."""
    n = 997
    v = rng.normal(size=(n, 6)) * np.array([1.0, 1e3, 1e-3, 50.0, 1.0, 1.0])
    v[rng.random((n, 6)) < 0.1] = np.nan
    v[:, 4] = 2.5                      # a constant column: width 1
    v[:, 5] = np.nan                   # every value missing
    lo = np.nanmin(np.where(np.isnan(v), np.inf, v), axis=0)
    hi = np.nanmax(np.where(np.isnan(v), -np.inf, v), axis=0)
    lo, hi = np.where(np.isfinite(lo), lo, 0.0), np.where(np.isfinite(hi), hi, 0.0)
    if case == "edges":                # values on the edges, and between two floats
        v[:20, 0], v[20:40, 0] = lo[0], hi[0]
        v[40:60, 0] = np.nextafter(hi[0], -np.inf)
    if case == "infinities":
        v[:7, 1], v[7:14, 1] = np.inf, -np.inf
    if case == "scoring":              # training edges, values far past them
        lo, hi = lo * 0.5 + 0.1, hi * 0.5
        v[:50, 3] = 1e12
        v[50:100, 3] = -1e12
        v[100:150, 2] = 3e9
    return v, lo, hi


@pytest.mark.parametrize("case", ["plain", "edges", "infinities", "scoring"])
@pytest.mark.parametrize("bins", [100, 7])
def test_numeric_histograms_bitwise(case, bins):
    v, lo, hi = _block(case, np.random.default_rng(len(case) * bins))
    want = np.asarray(JD._numeric_histograms(jnp.asarray(v), jnp.asarray(lo),
                                             jnp.asarray(hi), bins))
    got = TD.numeric_histograms(torch.from_numpy(v.astype(np.float32)),
                                torch.from_numpy(lo.astype(np.float32)),
                                torch.from_numpy(hi.astype(np.float32)), bins).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert got[5].sum() == 0 and got[4].sum() == (~np.isnan(v[:, 4])).sum()


def test_js_divergence_equal():
    rng = np.random.default_rng(1)
    pairs = [(rng.random(100), rng.random(100)), (np.zeros(10), rng.random(10)),
             (np.eye(1, 20, 3)[0], np.eye(1, 20, 17)[0]), (np.ones(5), np.ones(5))]
    for p, q in pairs:
        assert TD.js_divergence(p, q) == JD.js_divergence(p, q)


# -- compute_distributions --------------------------------------------------------

def _dists(which, cols, names, ref=None, **kw):
    P, ft = _pkg(which)
    ftypes = {k: ft(names[k]) for k in cols}
    ds = P.Dataset.from_features(cols, ftypes)
    feats = [P.FeatureBuilder.of(k, ftypes[k]).extract_field().as_predictor() for k in cols]
    mod = JD if which == "j" else TD
    if which == "t":
        kw["device"] = "cpu"
    if ref is not None:
        ref = {k: mod.Summary(**v) for k, v in ref.items()}
    return mod.compute_distributions(ds, feats, ref_summaries=ref, **kw)


def _same_dists(cols, names, ref=None, **kw):
    want = [d.to_dict() for d in _dists("j", cols, names, ref, **kw)]
    got = [d.to_dict() for d in _dists("t", cols, names, ref, **kw)]
    assert json.dumps(got) == json.dumps(want)
    return got


class TestDistributions:
    @pytest.mark.parametrize("bins", [{}, {"bins": 13, "text_bins": 29}])
    def test_maps_table_bitwise(self, bins):
        cols, schema = make_maps(400, seed=2)
        names = {s["name"]: s["type"] for s in schema if not s.get("response")}
        cols = {k: cols[k] for k in names}
        cols["empty_map"] = [{} for _ in range(400)]
        names["empty_map"] = "RealMap"
        got = _same_dists(cols, names, **bins)
        keys = {(d["name"], d["key"]) for d in got}
        assert ("amounts", "Deal_Size__c") in keys and ("places", "HQ__c") in keys
        assert not [k for k in keys if k[0] == "empty_map"]

    def test_every_scalar_family_bitwise(self):
        cols, schema = make_families(300, seed=3)
        names = {s["name"]: s["type"] for s in schema if not s.get("response")}
        cols = {k: cols[k] for k in names}
        cols["all_missing"] = [None] * 300
        names["all_missing"] = "Real"
        got = _same_dists(cols, names)
        missing = next(d for d in got if d["name"] == "all_missing")
        assert missing["nulls"] == 300 and missing["summaryInfo"]["count"] == 0.0

    def test_scoring_pass_on_training_edges_bitwise(self):
        cols, schema = make_maps(300, seed=4)
        scols, _ = make_scoring(200, seed=5)
        names = {s["name"]: s["type"] for s in schema if not s.get("response")}
        train = _dists("t", {k: cols[k] for k in names}, names)
        ref = {(d.name, d.key): d.summary_info.to_dict() for d in train}
        got = _same_dists({k: scols[k] for k in names}, names, ref=ref)
        shifted = next(d for d in got if d["key"] == "Shifted__c")
        assert shifted["distribution"][-1] == 200 - shifted["nulls"]  # past the edge

    def test_histograms_ran_through_the_device_entry(self):
        cols, schema = make_maps(64, seed=6)
        names = {s["name"]: s["type"] for s in schema if not s.get("response")}
        TD.reset_launch_counts()
        _dists("t", {k: cols[k] for k in names}, names)
        assert TD.launches == 1


# -- filter_raw -----------------------------------------------------------------

def _filter_run(which, rff_kw, n=600, scoring_rows=520, result=True):
    """(filtered dataset, blacklist, results, DAG layers) of one filter run
    over the maps table and its scoring table in package ``which``."""
    P, ft = _pkg(which)
    cols, schema = make_maps(n, seed=7)
    scols, sschema = make_scoring(scoring_rows, seed=8)
    ftypes = {s["name"]: ft(s["type"]) for s in schema}
    ds = P.Dataset.from_features(cols, ftypes)
    sds = P.Dataset.from_features(scols, {s["name"]: ftypes[s["name"]] for s in sschema})
    ns = J_NS if which == "j" else T
    label, _, _, pred = maps_pipeline(ns, ftypes, schema)
    raws = {}
    for f in (label, pred):
        for r in f.raw_features():
            raws.setdefault(r.uid, r)
    mod = JR if which == "j" else TR
    rff = mod.RawFeatureFilter(scoring_dataset=sds, **rff_kw)
    kw = {} if which == "j" else {"device": "cpu"}
    filtered, blacklist, results = rff.filter_raw(
        ds, list(raws.values()), [label, pred] if result else None, **kw)
    dag = jdag if which == "j" else tdag
    def name(f):  # a derived feature's name carries a stage uid
        return f.name if not f.origin_stage.inputs else type(f.origin_stage).__name__

    layers = [sorted((type(s).__name__, tuple(name(f) for f in s.inputs)) for s in layer)
              for layer in dag([label, pred])]
    return filtered, blacklist, results, layers


@pytest.mark.parametrize("rff_kw", [
    {}, {"protected_features": PROTECTED},
    {"js_divergence_protected_features": ("amounts",), "max_correlation": 0.5},
    {"min_fill": 0.3, "max_fill_ratio_diff": 2.0},
    {"min_scoring_rows": 1000}])  # too few scoring rows: the scoring checks skip
def test_filter_raw_equal(rff_kw):
    jf, jb, jres, jl = _filter_run("j", rff_kw)
    tf, tb, tres, tl = _filter_run("t", rff_kw)
    assert tb == jb
    assert json.dumps(tres.to_dict()) == json.dumps(jres.to_dict())
    assert tf.names == jf.names
    for name in tf.names:
        assert tf[name].to_values() == jf[name].to_values(), name
    assert tl == jl
    if not rff_kw:
        assert "memo" in tb and "legacy_score" in tb
        assert all("Refund__c" not in m for m in tf["fees"].data)


def test_protected_feature_stays():
    _, blacklist, results, _ = _filter_run("t", {"protected_features": PROTECTED})
    assert "legacy_score" not in blacklist
    legacy = next(m for m in results.metrics if m.name == "legacy_score")
    assert legacy.js_divergence > 0.9 and legacy.reasons == []


def test_rewired_dag_drops_the_blacklisted_map():
    *_, before = _filter_run("t", {}, result=False)
    *_, after = _filter_run("t", {})
    smart = [s for layer in after for s in layer if s[0] == "SmartTextMapVectorizer"]
    assert smart == [("SmartTextMapVectorizer", ("notes",))]
    assert [s for layer in before for s in layer if s[0] == "SmartTextMapVectorizer"] == \
        [("SmartTextMapVectorizer", ("notes", "memo"))]


def test_blacklisted_result_feature_raises_in_both():
    for which in ("j", "t"):
        P, ft = _pkg(which)
        rng = np.random.default_rng(9)
        cols = {"label": (rng.random(300) < 0.5).astype(float).tolist(),
                "sparse": [None] * 300}
        ftypes = {"label": ft("RealNN"), "sparse": ft("Real")}
        ds = P.Dataset.from_features(cols, ftypes)
        label = P.FeatureBuilder.of("label", ftypes["label"]).extract_field().as_response()
        sparse = P.FeatureBuilder.of("sparse", ftypes["sparse"]).extract_field().as_predictor()
        vec = P.transmogrify([sparse])
        mod = JR if which == "j" else TR
        rff = mod.RawFeatureFilter(min_fill=0.01)
        kw = {} if which == "j" else {"device": "cpu"}
        with pytest.raises(ValueError, match="depends only on blacklisted features"):
            rff.filter_raw(ds, [label, sparse], [label, vec], **kw)
        # the plan runs before any change: the DAG is intact
        assert vec.origin_stage.inputs == (sparse,)


# -- the workflow ------------------------------------------------------------------

def _trained(which, n=512):
    P, ft = _pkg(which)
    cols, schema = make_maps(n, seed=10)
    scols, sschema = make_scoring(n // 2, seed=11)
    ftypes = {s["name"]: ft(s["type"]) for s in schema}
    ds = P.Dataset.from_features(cols, ftypes)
    sds = P.Dataset.from_features(scols, {s["name"]: ftypes[s["name"]] for s in sschema})
    ns = J_NS if which == "j" else T
    label, sel, chk, pred = maps_pipeline(ns, ftypes, schema, num_folds=2)
    rff_cls = (JR if which == "j" else TR).RawFeatureFilter
    wf = P.Workflow().set_input_dataset(ds).set_result_features(label, pred) \
        .with_raw_feature_filter(rff_cls(scoring_dataset=sds, protected_features=PROTECTED,
                                         min_scoring_rows=100))
    kw = {} if which == "j" else {"device": "cpu"}
    return wf.train(**kw), sel


@pytest.fixture(scope="module")
def trained_pair():
    from transmogrifai_tpu.perf.kernels import dispatch as KD

    with KD.force_kernel_mode("interpret"):
        jm, jsel = _trained("j")
    tm, tsel = _trained("t")
    return jm, jsel, tm, tsel


def test_train_with_the_filter_equals_jax(trained_pair):
    jm, jsel, tm, tsel = trained_pair
    assert tm.blacklist == jm.blacklist == ["memo"]
    assert json.dumps(tm.rff_summary.to_dict()) == json.dumps(jm.rff_summary.to_dict())
    assert json.loads(json.dumps(fitted_states(tm))) == json.loads(json.dumps(fitted_states(jm)))
    ts, js = tm.fitted[tsel.uid].summary, jm.fitted[jsel.uid].summary
    for a, b in zip(ts.validation_results, js.validation_results):
        np.testing.assert_allclose(a.metric_values, b.metric_values, rtol=0, atol=1e-4)


@pytest.mark.parametrize("saver", ["t", "j"])
def test_blacklist_survives_save_and_load(trained_pair, saver, tmp_path):
    importlib.import_module("transmogrifai_tpu.ops.maps")  # the JAX loader's classes
    importlib.import_module("transmogrifai_tpu.ops.text_smart")
    importlib.import_module("transmogrifai_tpu.ops.collections_lift")
    jm, _, tm, _ = trained_pair
    model = tm if saver == "t" else jm
    path = str(tmp_path / "m")
    model.save(path)
    for P in (T, J):
        loaded = P.WorkflowModel.load(path)
        assert loaded.blacklist == ["memo"]
        [smart] = [t for t in loaded.fitted.values()
                   if type(t).__name__ == "SmartTextMapVectorizerModel"]
        assert len(smart.key_plans) == 1  # fitted on notes alone
