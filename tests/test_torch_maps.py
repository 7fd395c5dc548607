"""The typed maps: the port against the JAX package.

Module tests hand the same inputs (made from numpy seeds, at most 512 rows)
to each package and hold the outputs **bitwise** (``==`` on values, bytes
on blocks, metadata equal): the 23 map types and their conversions, map
columns and the map monoids, each map stage (NumericMapVectorizer with
keys that clean to one, TextMapPivotVectorizer, GeolocationMapVectorizer,
SmartTextMapVectorizer, DateMapToUnitCircleVectorizer,
DecisionTreeNumericMapBucketizer), FilterMap and the lifts,
transmogrify_maps and the DSL's type-dispatched ``vectorize``,
``filter_keys``, ``to_unit_circle``, ``smart_vectorize`` and
``is_substring``; every new stage class saved by one package and loaded by
the other.

The slice test trains the maps table (``tests/torch_maps_data.py``) with
its raw feature filter at the committed record's 4096 rows on the CPU and
holds the port to the record the JAX package made
(``tools/make_torch_maps_fixture.py``): the filter's record, the blacklist,
the fitted states ``==``, the training vector's sha256, LR CV within 1e-4
and coefficients within 1e-6, and the served records (missing maps, empty
maps, missing keys) ``==``.
"""

import importlib
import json
import os
import re
import sys

import numpy as np
import pytest

import transmogrifai_tpu as J
import transmogrifai_tpu.ops.maps  # noqa: F401  (the loader's classes)
import transmogrifai_tpu.ops.text_smart  # noqa: F401
from transmogrifai_tpu.perf.kernels import dispatch as KD
from transmogrifai_tpu.types import feature_type_by_name as jft
from transmogrifai_tpu.workflow import fit as JFit
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.types import feature_type_by_name as tft
from transmogrifai_tpu_torch.workflow import fit as TFit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_maps_data import (  # noqa: E402
    STATE_ATTRS,
    fitted_states,
    make_maps,
    make_records,
    make_scoring,
    maps_filter,
    maps_pipeline,
    vector_digest,
)

RECORD = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "training_maps")

MAP_TYPES = ["TextMap", "TextAreaMap", "EmailMap", "URLMap", "PhoneMap", "IDMap",
             "PickListMap", "ComboBoxMap", "Base64Map", "CountryMap", "StateMap",
             "CityMap", "PostalCodeMap", "StreetMap", "RealMap", "CurrencyMap",
             "PercentMap", "IntegralMap", "DateMap", "DateTimeMap", "BinaryMap",
             "MultiPickListMap", "GeolocationMap"]


def _pkg(which):
    return (J, jft, "transmogrifai_tpu") if which == "j" else \
        (T, tft, "transmogrifai_tpu_torch")


def run_stage(which, module, cls_name, cols, type_names, params, label=None):
    """(fitted runner, output column) of ``module.cls_name(**params)`` over
    ``cols`` in package ``which`` ("j" or "t"); with ``label`` (a column
    name) that column comes first as the stage's label input."""
    P, ft, root = _pkg(which)
    mod = importlib.import_module(f"{root}.ops.{module}")
    ftypes = {k: ft(type_names[k]) for k in cols}
    feats = {k: P.FeatureBuilder.of(k, ftypes[k]).extract_field().as_predictor()
             for k in cols}
    order = ([label] if label else []) + [k for k in cols if k != label]
    stage = getattr(mod, cls_name)(**params)
    out = feats[order[0]].transform_with(stage, *[feats[k] for k in order[1:]])
    ds = P.Dataset.from_features(cols, ftypes)
    runner = stage
    if hasattr(stage, "fit"):
        runner = stage.fit(ds) if which == "j" else stage.fit(ds, device="cpu")
    return runner, runner.transform(ds)[out.name]


def _meta(meta) -> dict:
    """A block's metadata without the stage uids derived features' names
    carry (each package counts its own)."""
    d = meta.to_dict()
    d.pop("name")
    return json.loads(re.sub(r"_[0-9a-f]{12}\b", "_<uid>", json.dumps(d)))


def both(module, cls_name, cols, type_names, label=None, **params):
    jr, jc = run_stage("j", module, cls_name, cols, type_names, params, label)
    tr, tc = run_stage("t", module, cls_name, cols, type_names, params, label)
    if jc.ftype.__name__ == "OPVector":
        assert tc.data.dtype == jc.data.dtype == np.float32
        assert tc.data.shape == jc.data.shape
        assert tc.data.tobytes() == jc.data.tobytes()
        assert _meta(tc.meta) == _meta(jc.meta)
    else:
        assert tc.ftype.__name__ == jc.ftype.__name__
        assert tc.to_values() == jc.to_values()
    return jr, tr


def _maps(n=400, seed=3):
    cols, schema = make_maps(n, seed=seed)
    return cols, {s["name"]: s["type"] for s in schema}


# -- types, columns, monoids ---------------------------------------------------

class TestTypes:
    @pytest.mark.parametrize("name", MAP_TYPES + ["Prediction"])
    def test_hierarchy_matches_the_reference(self, name):
        t, j = tft(name), jft(name)
        assert [k.__name__ for k in t.__mro__ if k.__name__ != "object"] == \
            [k.__name__ for k in j.__mro__ if k.__name__ != "object"]
        assert t.kind.value == j.kind.value
        for flag in ("is_categorical", "is_nullable", "is_location"):
            assert getattr(t, flag) == getattr(j, flag)

    @pytest.mark.parametrize("name,value", [
        ("RealMap", {"a": 1, "b": 2.5}), ("IntegralMap", {"a": 3}), ("BinaryMap", {"x": True}),
        ("TextMap", {"k": "v"}), ("MultiPickListMap", {"k": ["b", "a", "b"]}),
        ("MultiPickListMap", {"k": set()}), ("GeolocationMap", {"h": [1.5, 2.5, 3]}),
        ("GeolocationMap", {"h": []}), ("DateTimeMap", {"t": 1700000000000}),
        ("PickListMap", None), ("Prediction", {"prediction": 1.0, "probability_0": 0.2})])
    def test_conversions_equal(self, name, value):
        assert tft(name)._convert(value) == jft(name)._convert(value)

    @pytest.mark.parametrize("name,value", [
        ("RealMap", {"a": "1"}), ("RealMap", {"a": True}), ("IntegralMap", {"a": 1.5}),
        ("BinaryMap", {"a": 1}), ("TextMap", {"a": 3}), ("TextMap", {1: "a"}),
        ("TextMap", ["a"]), ("MultiPickListMap", {"k": "ab"}), ("MultiPickListMap", {"k": [1]}),
        ("GeolocationMap", {"h": [100.0, 0.0, 1.0]}), ("Prediction", {"x": 1.0})])
    def test_conversions_refuse_alike(self, name, value):
        from transmogrifai_tpu.types import FeatureTypeError as JErr
        from transmogrifai_tpu_torch.types import FeatureTypeError as TErr

        with pytest.raises(JErr):
            jft(name)._convert(value)
        with pytest.raises(TErr):
            tft(name)._convert(value)

    def test_map_columns_equal(self):
        cols, names = _maps(60, seed=4)
        cols["picks"][3] = None
        for name, tname in names.items():
            jc = J.Dataset.from_features({name: cols[name]}, {name: jft(tname)})[name]
            tc = T.Dataset.from_features({name: cols[name]}, {name: tft(tname)})[name]
            assert tc.to_values() == jc.to_values(), name
            assert tc.present().tolist() == jc.present().tolist(), name
            assert tc.take(np.array([5, 1])).to_values() == \
                jc.take(np.array([5, 1])).to_values()
            if tc.kind.value == "map":
                for c in (tc, jc):
                    with pytest.raises(TypeError):
                        c.values_f64()

    @pytest.mark.parametrize("name", ["RealMap", "IntegralMap", "BinaryMap", "PickListMap",
                                      "MultiPickListMap", "GeolocationMap", "DateMap",
                                      "Prediction"])
    def test_default_monoids_equal(self, name):
        from transmogrifai_tpu.aggregators.monoid import default_aggregator as jagg
        from transmogrifai_tpu_torch.aggregators.monoid import default_aggregator as tagg

        values = {
            "RealMap": [{"a": 1.0}, {"a": 2.0, "b": 3.0}, {}],
            "IntegralMap": [{"a": 1}, {"a": 2}, {"c": 5}],
            "BinaryMap": [{"a": False}, {"a": True}, {"b": False}],
            "PickListMap": [{"a": "x"}, {"a": "y"}, {"b": "z"}],
            "MultiPickListMap": [{"a": {"x"}}, {"a": {"y"}}, {"b": set()}],
            "GeolocationMap": [{"h": [1.0, 2.0, 3.0]}, {"h": [4.0, 5.0, 1.0]}],
            "DateMap": [{"t": 5}, {"t": 7}],
            "Prediction": [{"prediction": 0.0}, {"prediction": 1.0}],
        }[name]
        ja, ta = jagg(jft(name)), tagg(tft(name))
        jacc, tacc = ja.zero, ta.zero
        for v in values:
            jacc, tacc = ja.plus(jacc, v), ta.plus(tacc, v)
        assert ta.present(tacc) == ja.present(jacc)


# -- the map stages ------------------------------------------------------------

class TestMapStages:
    @pytest.mark.parametrize("params", [{}, {"track_nulls": False}, {"clean_keys": False}])
    def test_numeric_map_vectorizer_bitwise(self, params):
        cols, names = _maps(400, seed=5)
        sub = {k: cols[k] for k in ("amounts", "fees", "counts", "flags")}
        # "Deal_Size__c" / "DealSize__c" clean to one key: merged in the fit,
        # the later one wins in the transform
        assert any({"Deal_Size__c", "DealSize__c"} <= set(m) for m in sub["amounts"])
        jr, tr = both("maps", "NumericMapVectorizer", sub, names, **params)
        assert tr.keys == jr.keys and tr.fills == jr.fills
        assert ("DealSizec" in tr.keys[0]) == (not params.get("clean_keys") is False)

    @pytest.mark.parametrize("params", [{}, {"top_k": 3, "min_support": 2},
                                        {"clean_text": False, "track_nulls": False}])
    def test_text_map_pivot_bitwise(self, params):
        cols, names = _maps(400, seed=6)
        messy = [{("Stage__c!" if i % 4 == 0 else "Stage__c"): ("Won!" if i % 3 else " won"),
                  "Empty__c": ""} for i in range(400)]
        sub = {"picks": cols["picks"], "tags": cols["tags"], "messy": messy}
        jr, tr = both("maps", "TextMapPivotVectorizer", sub,
                      {**names, "messy": "PickListMap"}, **params)
        assert tr.vocabs == jr.vocabs

    @pytest.mark.parametrize("params", [{}, {"track_nulls": False}])
    def test_geolocation_map_bitwise(self, params):
        cols, names = _maps(400, seed=7)
        jr, tr = both("maps", "GeolocationMapVectorizer",
                      {"places": cols["places"], "none": [{}] * 400},
                      {**names, "none": "GeolocationMap"}, **params)
        assert tr.keys == jr.keys
        assert {k: v.tolist() for k, v in tr.fills[0].items()} == \
            {k: v.tolist() for k, v in jr.fills[0].items()}

    @pytest.mark.parametrize("params", [{}, {"max_cardinality": 5, "top_k": 3,
                                             "min_support": 2, "clean_text": False},
                                        {"num_hashes": 16, "track_nulls": False}])
    def test_smart_text_map_bitwise(self, params):
        cols, names = _maps(400, seed=8)
        jr, tr = both("text_smart", "SmartTextMapVectorizer",
                      {"notes": cols["notes"], "memo": cols["memo"]}, names, **params)
        assert tr.key_plans == jr.key_plans
        if not params:
            kinds = {spec["categorical"] for spec in tr.key_plans[0].values()}
            assert kinds == {True, False}

    @pytest.mark.parametrize("params", [{}, {"time_periods": ("DayOfYear", "HourOfDay")}])
    def test_date_map_unit_circle_bitwise(self, params):
        cols, names = _maps(400, seed=9)
        other = [{k: v for k, v in m.items() if k < "L"} for m in cols["dates"]]
        jr, tr = both("collections_lift", "DateMapToUnitCircleVectorizer",
                      {"dates": cols["dates"], "other": other},
                      {**names, "other": "DateTimeMap"}, **params)
        assert tr.key_sets == jr.key_sets and tr.time_periods == jr.time_periods

    def test_date_map_unknown_period_refused_alike(self):
        cols, names = _maps(50, seed=9)
        for which in ("j", "t"):
            with pytest.raises(ValueError, match="Unknown time periods"):
                run_stage(which, "collections_lift", "DateMapToUnitCircleVectorizer",
                          {"dates": cols["dates"]}, names, {"time_periods": ("Fortnight",)})

    @pytest.mark.parametrize("params", [{}, {"track_invalid": True, "track_nulls": False},
                                        {"min_info_gain": 0.5}])
    def test_numeric_map_bucketizer_bitwise(self, params):
        cols, names = _maps(500, seed=10)
        sub = {"label": cols["label"], "amounts": cols["amounts"]}
        jr, tr = both("bucketizers", "DecisionTreeNumericMapBucketizer", sub,
                      {**names, "label": "RealNN"}, label="label", **params)
        assert tr.keys == jr.keys and tr.splits == jr.splits
        if not params:
            assert any(tr.splits.values()) and not all(tr.splits.values())


class TestFilterAndLifts:
    @pytest.mark.parametrize("params", [
        {}, {"white_list_keys": ("Stage__c", "Tier__c")},
        {"black_list_keys": ("Stage__c",)}, {"filter_empty": False},
        {"white_list_keys": ("Legacy__c",), "filter_empty": False}])
    def test_filter_map_equal(self, params):
        cols, names = _maps(300, seed=11)
        both("collections_lift", "FilterMap", {"picks": cols["picks"]}, names, **params)

    def test_filter_map_keeps_the_map_type(self):
        for P, ft, root in (_pkg("j"), _pkg("t")):
            mod = importlib.import_module(f"{root}.ops.collections_lift")
            f = P.FeatureBuilder.of("m", ft("CurrencyMap")).extract_field().as_predictor()
            assert f.transform_with(mod.FilterMap()).ftype.__name__ == "CurrencyMap"

    def _lifted(self, which, lift, col, tname, inner_of):
        P, ft, root = _pkg(which)
        lift_mod = importlib.import_module(f"{root}.ops.collections_lift")
        f = P.FeatureBuilder.of("c", ft(tname)).extract_field().as_predictor()
        inner, value_type = inner_of(root, ft)
        stage = getattr(lift_mod, lift)(inner=inner, value_type=value_type)
        out = f.transform_with(stage)
        ds = P.Dataset.from_features({"c": col}, {"c": ft(tname)})
        return stage.transform(ds)[out.name].to_values()

    @pytest.mark.parametrize("lift,col_name,tname", [
        ("LiftToMap", "notes", "TextMap"), ("LiftToMap", "amounts", "RealMap"),
        ("LiftToList", None, "TextList")])
    def test_lifts_equal(self, lift, col_name, tname):
        cols, _ = _maps(200, seed=12)
        col = cols[col_name] if col_name else \
            [list(m.values()) for m in cols["notes"]]

        def inner_of(root, ft):
            if tname == "RealMap":  # the inner stage's input type is abstract
                m = importlib.import_module(f"{root}.ops.math")
                return m.ScalarMathTransformer(op="multiply", scalar=3.0), ft("Real")
            m = importlib.import_module(f"{root}.ops.misc")
            return m.ReplaceTransformer(input_type=ft("Text"), old_value="Prio level 0",
                                        new_value="P0"), None

        got = self._lifted("t", lift, col, tname, inner_of)
        assert got == self._lifted("j", lift, col, tname, inner_of)
        assert any(got)

    def test_transmogrify_maps_blocks_bitwise(self):
        cols, names = _maps(300, seed=13)
        sub = {k: cols[k] for k in ("amounts", "counts", "flags", "picks", "tags", "notes",
                                    "dates", "places")}

        def block(which):
            P, ft, _ = _pkg(which)
            ftypes = {k: ft(names[k]) for k in sub}
            fs = [P.FeatureBuilder.of(k, ftypes[k]).extract_field().as_predictor()
                  for k in sub]
            vec = P.transmogrify(fs)
            ds = P.Dataset.from_features(sub, ftypes)
            if which == "j":
                with KD.force_kernel_mode("interpret"):
                    model = J.Workflow().set_input_dataset(ds).set_result_features(vec).train()
                return JFit.transform_dag(ds, [vec], model.fitted)[vec.name]
            model = T.Workflow().set_input_dataset(ds).set_result_features(vec) \
                .train(device="cpu")
            return TFit.transform_dag(ds, [vec], model.fitted, "cpu")[vec.name]

        jc, tc = block("j"), block("t")
        assert tc.data.tobytes() == jc.data.tobytes() and tc.data.shape == jc.data.shape
        assert _meta(tc.meta) == _meta(jc.meta)
        groupings = {c["grouping"] for c in _meta(tc.meta)["columns"]}
        # the pivot and the numeric maps clean their keys; SmartText, the
        # dates and the geolocations keep them as they come
        assert {"Stagec", "Budgetc", "notes_Priority__c", "dates_Close__c",
                "Billing__c"} <= groupings


# -- the DSL ------------------------------------------------------------------------

def _dsl_graph(which, build):
    P, ft, _ = _pkg(which)
    fb = {}

    def raw(name, tname):
        if name not in fb:
            fb[name] = P.FeatureBuilder.of(name, ft(tname)).extract_field().as_predictor()
        return fb[name]

    out = build(raw)
    graph, stack, seen = [], [out], set()
    while stack:
        f = stack.pop()
        st = f.origin_stage
        if st is None or id(st) in seen or not st.inputs:
            continue
        seen.add(id(st))
        graph.append((type(st).__name__,
                      {k: v for k, v in st.get_params().items() if k != "reference_date_ms"},
                      [p.name if p.origin_stage is None or not p.origin_stage.inputs
                       else type(p.origin_stage).__name__ for p in st.inputs]))
        stack.extend(f.parents)
    return out.ftype.__name__, graph


class TestDsl:
    @pytest.mark.parametrize("tname,stage", [
        ("RealMap", "NumericMapVectorizer"), ("BinaryMap", "NumericMapVectorizer"),
        ("PickListMap", "TextMapPivotVectorizer"), ("MultiPickListMap", "TextMapPivotVectorizer"),
        ("TextMap", "SmartTextMapVectorizer"), ("TextAreaMap", "SmartTextMapVectorizer"),
        ("DateMap", "DateMapToUnitCircleVectorizer"),
        ("GeolocationMap", "GeolocationMapVectorizer"), ("Date", "DateToUnitCircleVectorizer"),
        ("DateList", "DateListVectorizer"), ("MultiPickList", "MultiPickListVectorizer"),
        ("Geolocation", "GeolocationVectorizer"), ("Real", "NumericVectorizer")])
    def test_vectorize_dispatch_equal(self, tname, stage):
        def build(raw):
            return raw("a", tname).vectorize(others=[raw("b", tname)])

        got = _dsl_graph("t", build)
        assert got == _dsl_graph("j", build)
        assert got[1][0][0] == stage

    @pytest.mark.parametrize("keys", [{"white_list_keys": ["Stage__c"]},
                                      {"black_list_keys": ["Tier__c", "Rating__c"]}])
    def test_vectorize_key_lists_go_through_filter_keys(self, keys):
        def build(raw):
            return raw("m", "PickListMap").vectorize(top_k=5, **keys)

        got = _dsl_graph("t", build)
        assert got == _dsl_graph("j", build)
        assert [g[0] for g in got[1]] == ["TextMapPivotVectorizer", "FilterMap"]

    def test_vectorize_refusals_alike(self):
        for which in ("j", "t"):
            P, ft, _ = _pkg(which)
            r = P.FeatureBuilder.of("r", ft("Real")).extract_field().as_predictor()
            with pytest.raises(TypeError, match="only apply to map features"):
                r.vectorize(white_list_keys=["a"])
            with pytest.raises(TypeError, match="unsupported for Real"):
                r.vectorize(top_k=3)

    @pytest.mark.parametrize("shortcut", ["filter_keys", "to_unit_circle", "smart_vectorize",
                                          "is_substring"])
    def test_shortcuts_equal(self, shortcut):
        def build(raw):
            if shortcut == "filter_keys":
                return raw("m", "TextMap").filter_keys(white_list=["a"], black_list=["b"],
                                                       filter_empty=False)
            if shortcut == "to_unit_circle":
                raw("d", "Date").to_unit_circle("DayOfWeek")
                return raw("m", "DateMap").to_unit_circle("HourOfDay", "DayOfYear",
                                                          others=[raw("n", "DateMap")])
            if shortcut == "smart_vectorize":
                return raw("t", "Text").smart_vectorize(others=[raw("u", "Email")],
                                                        max_cardinality=5)
            return raw("t", "Text").is_substring(raw("u", "Text"))

        got = _dsl_graph("t", build)
        assert got == _dsl_graph("j", build) and got[1]

    def test_dsl_vectors_bitwise(self):
        cols, names = _maps(300, seed=14)

        def block(which):
            P, ft, _ = _pkg(which)
            ftypes = {k: ft(names[k]) for k in ("picks", "dates", "amounts")}
            fs = {k: P.FeatureBuilder.of(k, ftypes[k]).extract_field().as_predictor()
                  for k in ftypes}
            vecs = [fs["picks"].vectorize(black_list_keys=["Stage__c"], top_k=4),
                    fs["dates"].to_unit_circle("DayOfWeek"),
                    fs["amounts"].vectorize(white_list_keys=["Budget__c", "Risk__c"])]
            ds = P.Dataset.from_features({k: cols[k] for k in ftypes}, ftypes)
            kw = {} if which == "j" else {"device": "cpu"}
            model = P.Workflow().set_input_dataset(ds).set_result_features(*vecs).train(**kw)
            fit = JFit if which == "j" else TFit
            args = () if which == "j" else ("cpu",)
            out = fit.transform_dag(ds, vecs, model.fitted, *args)
            return [out[v.name] for v in vecs]

        for jc, tc in zip(block("j"), block("t")):
            assert tc.data.tobytes() == jc.data.tobytes() and tc.data.shape == jc.data.shape
            assert _meta(tc.meta) == _meta(jc.meta)


# -- serde both ways -----------------------------------------------------------------

def _serde_dag(which):
    """(result features, dataset) over every new stage class that saves."""
    P, ft, root = _pkg(which)
    mods = {m: importlib.import_module(f"{root}.ops.{m}")
            for m in ("maps", "collections_lift", "text_smart", "bucketizers", "misc")}
    cols, names = _maps(300, seed=15)
    use = ("label", "amounts", "counts", "picks", "tags", "notes", "dates", "places")
    ftypes = {k: ft(names[k]) for k in use}
    fs = {k: P.FeatureBuilder.of(k, ftypes[k]).extract_field().as_predictor() for k in use}
    fs["label"] = P.FeatureBuilder.of("label", ftypes["label"]).extract_field().as_response()
    kept = fs["picks"].transform_with(mods["collections_lift"].FilterMap(
        black_list_keys=("Legacy__c",)))
    lifted = fs["notes"].transform_with(mods["collections_lift"].LiftToMap(
        inner=mods["misc"].ReplaceTransformer(input_type=ft("Text"),
                                              old_value="Prio level 0", new_value="P0")))
    outs = [fs["amounts"].transform_with(mods["maps"].NumericMapVectorizer(), fs["counts"]),
            kept.transform_with(mods["maps"].TextMapPivotVectorizer(), fs["tags"]),
            fs["places"].transform_with(mods["maps"].GeolocationMapVectorizer()),
            lifted.transform_with(mods["text_smart"].SmartTextMapVectorizer()),
            fs["dates"].transform_with(mods["collections_lift"].DateMapToUnitCircleVectorizer()),
            fs["label"].transform_with(mods["bucketizers"].DecisionTreeNumericMapBucketizer(),
                                       fs["amounts"])]
    return outs, P.Dataset.from_features({k: cols[k] for k in use}, ftypes)


@pytest.mark.parametrize("saver", ["t", "j"])
def test_every_new_class_crosses_serde(saver, tmp_path):
    loader = "j" if saver == "t" else "t"
    outs, ds = _serde_dag(saver)
    P = _pkg(saver)[0]
    kw = {"device": "cpu"} if saver == "t" else {}
    model = P.Workflow().set_input_dataset(ds).set_result_features(*outs).train(**kw)
    model.blacklist = ["memo"]
    path = str(tmp_path / "m")
    model.save(path)
    L = _pkg(loader)[0]
    loaded = L.WorkflowModel.load(path)
    assert loaded.blacklist == ["memo"]
    classes = {type(t).__name__ for t in loaded.fitted.values()}
    assert {"NumericMapVectorizerModel", "TextMapPivotVectorizerModel",
            "GeolocationMapVectorizerModel", "SmartTextMapVectorizerModel",
            "DateMapToUnitCircleVectorizerModel",
            "DecisionTreeNumericMapBucketizerModel"} <= classes
    _, lds = _serde_dag(loader)
    fit_s, fit_l = (TFit, JFit) if saver == "t" else (JFit, TFit)
    args_s = ("cpu",) if saver == "t" else ()
    args_l = ("cpu",) if loader == "t" else ()
    want = fit_s.transform_dag(ds, outs, model.fitted, *args_s)
    got = fit_l.transform_dag(lds, loaded.result_features, loaded.fitted, *args_l)
    for a, b in zip(outs, loaded.result_features):
        assert got[b.name].data.tobytes() == want[a.name].data.tobytes(), a.name


# -- the slice at the record's size ----------------------------------------------

@pytest.fixture(scope="module")
def record():
    with open(os.path.join(RECORD, "states.json")) as fh:
        states = json.load(fh)
    with open(os.path.join(RECORD, "records.json")) as fh:
        recs = json.load(fh)
    with open(os.path.join(RECORD, "rff.json")) as fh:
        rff = json.load(fh)
    return states, recs, rff


@pytest.fixture(scope="module")
def trained(record):
    """The port's Workflow.train(device="cpu") of the maps table, its raw
    feature filter first, at the record's rows and seeds."""
    states, _, _ = record
    cols, schema = make_maps(states["rows"], seed=states["seed"])
    scols, sschema = make_scoring(states["scoring_rows"], seed=states["scoring_seed"])
    tf = {s["name"]: tft(s["type"]) for s in schema}
    label, sel, chk, pred = maps_pipeline(T, tf, schema)
    ds = T.Dataset.from_features(cols, tf)
    sds = T.Dataset.from_features(scols, {s["name"]: tf[s["name"]] for s in sschema})
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred) \
        .with_raw_feature_filter(maps_filter(T, sds))
    model = wf.train(device="cpu")
    return dict(model=model, ds=ds, cols=cols, sel=sel, chk=chk, pred=pred,
                profile=wf.last_train_profile)


class TestMapsSlice:
    def test_filter_record_equal(self, trained, record):
        _, _, rff = record
        model = trained["model"]
        assert json.loads(json.dumps(model.rff_summary.to_dict())) == rff["results"]
        assert model.blacklist == rff["blacklist"] == ["memo"]
        # the shifted key, the leaky key and the empty key leave their maps
        assert rff["stripped_keys"] == {"amounts": ["Shifted__c"], "fees": ["Refund__c"],
                                        "picks": ["Legacy__c"]}
        assert not [m for m in model.rff_summary.metrics
                    if m.name == "legacy_score" and m.reasons]

    def test_fitted_states_equal_the_jax_record(self, trained, record):
        states, _, _ = record
        got = json.loads(json.dumps(fitted_states(trained["model"])))
        assert got == states["fitted"]
        assert set(got) == set(STATE_ATTRS)

    def test_training_vector_bitwise(self, trained, record):
        states, _, _ = record
        vec = trained["chk"].inputs[1]
        got = TFit.transform_dag(trained["ds"], [vec], trained["model"].fitted, "cpu")
        assert vector_digest(got[vec.name].data) == states["vector"]

    def test_cv_metrics_and_coefficients(self, trained, record):
        """LR CV within 1e-4, the port's LR gate (tests/test_torch_families.py
        states why); the refit's coefficients within 1e-5 of their value
        + 1e-6 and its intercept within 1e-6: the vector carries raw
        currency amounts (1e2-1e6) beside indicators, and the packages'
        float32 IRLS sums, ~1e-7 apart on the families' vector, move a few
        coefficients here by up to ~8e-6 of their value."""
        states, _, _ = record
        summary = trained["model"].fitted[trained["sel"].uid].summary
        assert [e.grid for e in summary.validation_results] == [c["grid"] for c in states["cv"]]
        for e, c in zip(summary.validation_results, states["cv"]):
            np.testing.assert_allclose(e.metric_values, c["values"], rtol=0, atol=1e-4)
        assert (summary.best_model_name, summary.best_grid) == \
            (states["winner"]["name"], states["winner"]["grid"])
        win = trained["model"].fitted[trained["sel"].uid].model
        np.testing.assert_allclose(np.asarray(win.coef), states["winner"]["coef"], rtol=1e-5,
                                   atol=1e-6)
        want = states["winner"]["intercept"]
        assert abs(float(win.intercept) - want) <= 1e-6 + 1e-5 * abs(want)

    def test_one_encode_flush(self, trained):
        flushes = [r for r in trained["profile"] if r["kind"] == "flush"
                   and r.get("encode_slots")]
        # the two pick lists' one-hot slots and the auto-bucketized Real
        assert len(flushes) == 1 and flushes[0]["encode_slots"] == 3

    def test_serving_records_equal_the_jax_record(self, record):
        _, recs, _ = record
        model = T.WorkflowModel.load(RECORD)
        assert model.blacklist == ["memo"]
        plan = model.serving_plan(device="cpu")
        for b in recs["batches"]:
            assert plan.score(b["records"]) == b["scored"]
        kinds = [r for b in recs["batches"] for r in b["records"]]
        assert any("tags" not in r for r in kinds) and any(r["notes"] == {} for r in kinds)
        assert any(len(r["amounts"]) == 1 for r in kinds)

    def test_port_saved_model_scores_alike_in_both(self, trained, record, tmp_path):
        _, recs, _ = record
        path = str(tmp_path / "m")
        trained["model"].save(path)
        tm, jm = T.WorkflowModel.load(path), J.WorkflowModel.load(path)
        assert tm.blacklist == jm.blacklist == ["memo"]
        batch = recs["batches"][0]["records"]
        got = trained["model"].serving_plan(device="cpu").score(batch)
        gname, wname = trained["pred"].name, recs["prediction"]
        dev = max(abs(g[gname]["probability_1"] - w[wname]["probability_1"])
                  for g, w in zip(got, recs["batches"][0]["scored"]))
        assert dev <= 1e-6  # the refit ~1e-6 apart (above): 1.3e-7 here
        assert tm.serving_plan(device="cpu").score(batch) == got
        assert jm.serving_plan().score(batch) == got


def test_records_carry_sets_as_sorted_lists():
    cols, _ = make_maps(30, seed=16)
    recs = make_records(cols, range(30))
    for i, r in enumerate(recs):
        if "tags" in r:
            assert r["tags"] == {k: sorted(v) for k, v in cols["tags"][i].items()}
    assert json.loads(json.dumps(recs)) == recs
