"""transmogrify's text, date, multi-pick-list, list and geolocation families:
the port against the JAX package.

Module tests hand the same inputs (made from numpy seeds) to each package's
function and hold the outputs **bitwise** (``==`` on values, bytes on
arrays): murmur3 and its buckets over UTF-8 and CJK tokens; ``tokenize``,
``analyze`` and language detection over the reference's language samples;
the hashing fills on the port's native path, its Python path and the
reference; SmartText's decisions (vocabularies, the categorical branch,
analyzer languages) and blocks; the multi-pick, text-list, date, date-list
and geolocation vectorizers; and transmogrify's stage graph.

The slice tests train the families table (``tests/torch_families_data.py``)
at the committed record's 4096 rows on the CPU and hold the port to the
record the JAX package made (``tools/make_torch_families_fixture.py``):
fitted states and kept indices ``==``, the training vector's sha256 equal,
LR CV metrics and coefficients within the tolerances stated below, serving
records ``==``, and saved models crossing between the packages.
"""

import importlib
import json
import os
import sys
import types

import numpy as np
import pytest

import transmogrifai_tpu as J
from transmogrifai_tpu import native as JN
from transmogrifai_tpu.models.logistic import LogisticRegression as JLR
from transmogrifai_tpu.perf.kernels import dispatch as KD
from transmogrifai_tpu.types import feature_type_by_name as jft
from transmogrifai_tpu.utils import hashing as JH
from transmogrifai_tpu.utils import lang as JL
from transmogrifai_tpu.utils import text as JT
from transmogrifai_tpu.workflow import fit as JFit
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch import native as TN
from transmogrifai_tpu_torch.types import feature_type_by_name as tft
from transmogrifai_tpu_torch.utils import hashing as TH
from transmogrifai_tpu_torch.utils import lang as TL
from transmogrifai_tpu_torch.utils import text as TT
from transmogrifai_tpu_torch.workflow import fit as TFit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from langid_real_fixture import REAL_STRINGS  # noqa: E402
from torch_families_data import (  # noqa: E402
    REFERENCE_DATE_MS,
    STATE_ATTRS,
    families_pipeline,
    fitted_states,
    make_families,
    make_records,
    vector_digest,
)

RECORD = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "training_families")
J_NS = types.SimpleNamespace(
    FeatureBuilder=J.FeatureBuilder, transmogrify=J.transmogrify,
    SanityChecker=J.SanityChecker,
    BinaryClassificationModelSelector=J.BinaryClassificationModelSelector,
    LogisticRegression=JLR)

TOKENS = ["hello", "wörld", "", "a", "ab", "abc", "abcd", "abcde", "日本語", "x" * 257,
          "café", "naïve", "東京", "美味しい", "ありがとう", "emoji😀", "Straße", "ǅ",
          "kw007", "12345", "mobile app", " nbsp", "ñandú", "Ελληνικά", "русский"]


def _need_native():
    if not TN.warmup():
        pytest.skip(f"g++ did not build the native library here: {TN.BUILD_ERROR}")


@pytest.fixture(params=["native", "python"])
def port_path(request, monkeypatch):
    """The port's hashing path under test: the g++-built library or the
    Python path beside it (forced by hiding the library)."""
    if request.param == "native":
        _need_native()
    else:
        monkeypatch.setattr(TN, "_lib", lambda force=False: None)
    return request.param


# -- hashing ----------------------------------------------------------------------

class TestHashing:
    @pytest.mark.parametrize("seed", [42, 0, 7])
    def test_murmur3_and_buckets_bitwise(self, seed):
        for t in TOKENS:
            assert TH.murmur3_32(t, seed) == JH.murmur3_32(t, seed), t
            for width in (512, 13, 1 << 20):
                assert TH.hash_to_bucket(t, width, seed) == JH.hash_to_bucket(t, width, seed)

    def test_murmur3_batch_bitwise(self, port_path):
        TN.reset_path_counts()
        many = TOKENS * 100  # past the build threshold
        got = TN.murmur3_batch(many, seed=11)
        want = np.array([JH.murmur3_32(t, 11) for t in many], np.uint32)
        assert got.dtype == np.uint32 and got.tobytes() == want.tobytes()
        assert TN.path_counts() == {f"murmur3_batch.{port_path}": 1}

    @pytest.mark.parametrize("binary", [False, True])
    @pytest.mark.parametrize("width", [512, 13])
    def test_hash_count_block_bitwise(self, port_path, binary, width):
        rng = np.random.default_rng(3)
        docs = [None if rng.random() < 0.1 else
                [TOKENS[j] for j in rng.integers(0, len(TOKENS), rng.integers(0, 12))]
                for _ in range(300)]
        TN.reset_path_counts()
        got = TN.hash_count_block(docs, width, binary=binary)
        want = JN.hash_count_block(docs, width, binary=binary)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
        assert TN.path_counts() == {f"hash_count_block.{port_path}": 1}

    @pytest.mark.parametrize("lowercase,min_len", [(True, 1), (False, 3)])
    def test_tokenize_hash_count_bitwise(self, port_path, lowercase, min_len):
        cols, _ = make_families(400, seed=5)
        texts = cols["review"] + cols["review_de"] + ["", None, "A" * 5000 + " b", "x" * 4097]
        TN.reset_path_counts()
        got, got_n = TN.tokenize_hash_count(texts, 512, lowercase=lowercase,
                                            min_token_length=min_len)
        want, want_n = JN.tokenize_hash_count(texts, 512, lowercase=lowercase,
                                              min_token_length=min_len)
        assert got.tobytes() == want.tobytes() and got_n.tobytes() == want_n.tobytes()
        counts = TN.path_counts()
        assert counts[f"tokenize_hash_count.{port_path}"] == 1
        if port_path == "native":
            # every non-ASCII row, and the row with a token over 4 KB, went
            # through the exact Unicode tokenizer
            redo = sum(1 for t in texts if t and (
                not t.isascii() or max(len(w) for w in t.split()) > 4096))
            assert counts["tokenize_hash_count.unicode_rows"] == redo > 0

    def test_fallback_matches_native(self):
        """The reference's ``test_native.py`` case: where ``available()``
        (the library builds and loads), the Python path fills the same
        block as the native one."""
        if not TN.available():
            pytest.skip("no native toolchain")
        docs = [["a", "b", "a"], [], None, ["c", "a"], ["b"] * 5]
        got_native = TN.hash_count_block(docs, 16)
        saved = TN._LIB
        try:
            TN._LIB = None
            got_py = TN.hash_count_block(docs, 16)
        finally:
            TN._LIB = saved
        np.testing.assert_array_equal(got_native, got_py)
        assert TN.available() == JN.available()

    def test_native_library_builds_under_build(self):
        _need_native()
        path = TN.library_path()
        assert os.path.exists(path) and path.startswith(TN.build_dir())
        assert TN.BUILD_ERROR is None


# -- text analysis ---------------------------------------------------------------

def _samples():
    out = [s for strings in REAL_STRINGS.values() for s in strings]
    out += [v for v in make_families(60, seed=2)[0]["review"] if v]
    out += ["東京の美味しいラーメン屋さん", "我们很喜欢这家咖啡店的服务", "Mixed 東京tokyo 2024!",
            "", "   ", "e-mail: anna.smith@example.com", "Ünïcödé ÀÉÎÕÜ ǅungla", None]
    return out


class TestText:
    @pytest.mark.parametrize("opts", [{}, {"to_lowercase": False},
                                      {"min_token_length": 3},
                                      {"remove_stop_words": True}])
    def test_tokenize_bitwise(self, opts):
        for s in _samples():
            assert TT.tokenize(s, **opts) == JT.tokenize(s, **opts), s

    @pytest.mark.parametrize("opts", [{}, {"stemming": "always"}, {"stemming": "never"},
                                      {"remove_stop_words": True},
                                      {"language": "de"}, {"language": "fr", "stemming": "always"}])
    def test_analyze_bitwise(self, opts):
        for s in _samples():
            assert TT.analyze(s, **opts) == JT.analyze(s, **opts), (s, opts)

    def test_detect_language_bitwise(self):
        assert TL.analyzer_languages() == JL.analyzer_languages()
        assert TL.LANGUAGES == JL.LANGUAGES
        for s in _samples():
            assert TL.detect_language(s) == JL.detect_language(s), s
            assert TL.detect_language_scores(s) == JL.detect_language_scores(s), s

    def test_stemmers_and_stop_words_bitwise(self):
        words = sorted({w for s in _samples() if s for w in JT.tokenize(s)})
        for lang in JL.analyzer_languages():
            assert TL.stem_tokens(words, lang) == JL.stem_tokens(words, lang), lang
            assert TL.stop_words_for(lang) == JL.stop_words_for(lang), lang


# -- one stage through both packages ----------------------------------------------

def run_stage(pkg, module, cls_name, cols, type_names, fit=True, **params):
    """(fitted runner, output column) of ``module.cls_name(**params)`` over
    ``cols`` in package ``pkg`` ("j" or "t"), its inputs typed by name."""
    P, ft, root = (J, jft, "transmogrifai_tpu") if pkg == "j" else \
        (T, tft, "transmogrifai_tpu_torch")
    mod = importlib.import_module(f"{root}.ops.{module}")
    ftypes = {k: ft(type_names[k]) for k in cols}
    feats = [P.FeatureBuilder.of(k, ftypes[k]).extract_field().as_predictor() for k in cols]
    stage = getattr(mod, cls_name)(**params)
    out = feats[0].transform_with(stage, *feats[1:])
    ds = P.Dataset.from_features(cols, ftypes)
    runner = stage
    if fit and hasattr(stage, "fit"):
        runner = stage.fit(ds) if pkg == "j" else stage.fit(ds, device="cpu")
    return runner, runner.transform(ds)[out.name]


def _meta(meta) -> dict:
    d = meta.to_dict()
    d.pop("name")  # the output feature's name carries a stage uid
    return d


def assert_same_block(jcol, tcol):
    assert tcol.data.dtype == jcol.data.dtype == np.float32
    assert tcol.data.shape == jcol.data.shape
    assert tcol.data.tobytes() == jcol.data.tobytes()
    assert _meta(tcol.meta) == _meta(jcol.meta)


def both(module, cls_name, cols, type_names, **params):
    jr, jc = run_stage("j", module, cls_name, cols, type_names, **params)
    tr, tc = run_stage("t", module, cls_name, cols, type_names, **params)
    assert_same_block(jc, tc)
    return jr, tr


def _smart_columns(n=300, seed=4):
    cols, _ = make_families(n, seed=seed)
    rng = np.random.default_rng(seed)
    out = {k: cols[k] for k in ("review", "review_de", "channel", "email")}
    messy = ["Web!", " web", "WEB", "Mobile-App", "mobile app", "phone ", "", None, "e-mail"]
    out["messy"] = [messy[i] for i in rng.integers(0, len(messy), n)]
    # over 1000 distinct values: the stats stop counting new ones at the cap
    out["ids"] = [f"id {i} {j}" for i, j in zip(range(n), rng.integers(0, 9, n))] * 4
    out["ids"] = out["ids"][:n]
    out["cjk"] = [["東京の美味しいラーメン屋さん", "我们很喜欢这家咖啡店的服务",
                   "ありがとうございます 東京"][i % 3] + f" {i}" for i in range(n)]
    # 32 German and 32 French distinct values first: the language vote ties
    de = [s for s in REAL_STRINGS["de"] if JL.detect_language(s) == "de"]
    fr = [s for s in REAL_STRINGS["fr"] if JL.detect_language(s) == "fr"]
    out["tie"] = [f"{(de if i % 2 else fr)[i // 2 % 7]} {i}" for i in range(n)]
    return out


class TestSmartText:
    @pytest.mark.parametrize("params", [{}, {"track_text_len": True, "track_nulls": False},
                                        {"max_cardinality": 5, "top_k": 3, "min_support": 2,
                                         "clean_text": False},
                                        {"language": "de"}])
    def test_decisions_and_blocks_bitwise(self, params):
        cols = _smart_columns()
        jr, tr = both("text_smart", "SmartTextVectorizer", cols,
                      {k: ("Email" if k == "email" else "Text") for k in cols}, **params)
        assert tr.is_categorical == jr.is_categorical
        assert tr.vocabs == jr.vocabs
        assert tr.languages == jr.languages
        if not params:
            # both branches and every analyzer route are exercised
            assert True in tr.is_categorical and False in tr.is_categorical
            langs = dict(zip(cols, tr.languages))
            assert langs["review"] == "en" and langs["review_de"] == "de"
            assert langs["tie"] == "de"  # a 32/32 vote goes to the first sorted
            assert langs["cjk"] not in TL.analyzer_languages()

    def test_text_stats_cap_and_column_language(self):
        from transmogrifai_tpu.ops import text_smart as JS
        from transmogrifai_tpu_torch.ops import text_smart as TS

        vals = [f"v{i % 1500}" for i in range(4000)]
        js, ts = JS.TextStats(), TS.TextStats()
        for v in vals:
            js.update(v)
            ts.update(v)
        assert ts.cardinality == js.cardinality == 1000
        assert list(ts.value_counts.items()) == list(js.value_counts.items())
        for col in _smart_columns().values():
            assert TS._column_language(col) == JS._column_language(col)
            assert TS._decide_plan(ts, 1000, 2, 20) == JS._decide_plan(js, 1000, 2, 20)


class TestOtherFamilies:
    @pytest.mark.parametrize("params", [{}, {"top_k": 3, "min_support": 2},
                                        {"clean_text": False, "track_nulls": False}])
    def test_multipicklist_bitwise(self, params):
        cols, _ = make_families(400, seed=6)
        tags = [({t.upper() + "!" for t in s} if i % 7 == 0 else s)
                for i, s in enumerate(cols["tags"])]
        jr, tr = both("onehot", "MultiPickListVectorizer",
                      {"tags": cols["tags"], "tags2": tags},
                      {"tags": "MultiPickList", "tags2": "MultiPickList"}, **params)
        assert tr.vocabs == jr.vocabs and len(tr.vocabs[0]) > 0

    @pytest.mark.parametrize("params", [{}, {"shared_hash_space": True},
                                        {"num_hashes": 16, "track_nulls": False}])
    def test_text_list_hashing_bitwise(self, params):
        cols, _ = make_families(400, seed=7)
        words = [[w.upper() for w in ws] + (["東京"] if i % 5 == 0 else [])
                 for i, ws in enumerate(cols["keywords"])]
        both("text_lists", "TextListHashingVectorizer",
             {"keywords": cols["keywords"], "words": words},
             {"keywords": "TextList", "words": "TextList"}, **params)

    @pytest.mark.parametrize("period", ["DayOfMonth", "DayOfWeek", "DayOfYear", "HourOfDay",
                                        "MonthOfYear", "WeekOfMonth", "WeekOfYear"])
    def test_extract_time_period_bitwise(self, period):
        from transmogrifai_tpu.ops.dates import extract_time_period as jx
        from transmogrifai_tpu_torch.ops.dates import extract_time_period as tx

        rng = np.random.default_rng(8)
        ms = np.concatenate([
            rng.integers(-2_000_000_000_000, 4_000_000_000_000, 5000),
            np.array([0, -1, 1582934400000, 1583020799999, 1483228799999,
                      1483228800000, 951782400000, 4102444800000], np.int64)])
        got, want = tx(ms, period), jx(ms, period)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()

    @pytest.mark.parametrize("periods", [None, ("DayOfYear", "HourOfDay")])
    def test_date_to_unit_circle_bitwise(self, periods):
        cols, _ = make_families(500, seed=9)
        params = {} if periods is None else {"time_periods": periods}
        both("dates", "DateToUnitCircleVectorizer",
             {"opened": cols["opened"], "last_seen": cols["last_seen"]},
             {"opened": "Date", "last_seen": "DateTime"}, **params)

    @pytest.mark.parametrize("pivot", ["SinceFirst", "SinceLast", "ModeDay", "ModeMonth",
                                       "ModeHour"])
    @pytest.mark.parametrize("extra", [{}, {"fill_value": -1.0, "track_nulls": False}])
    def test_date_list_bitwise(self, pivot, extra):
        cols, _ = make_families(500, seed=10)
        other = [v[:2] for v in cols["visits"]]
        jr, tr = both("dates", "DateListVectorizer",
                      {"visits": cols["visits"], "other": other},
                      {"visits": "DateList", "other": "DateTimeList"},
                      pivot=pivot, reference_date_ms=REFERENCE_DATE_MS, **extra)
        assert tr.reference_date_ms == jr.reference_date_ms == REFERENCE_DATE_MS

    def test_geolocation_bitwise(self):
        cols, _ = make_families(500, seed=11)
        jr, tr = both("geo", "GeolocationVectorizer",
                      {"home": cols["home"], "nowhere": [[]] * 500},
                      {"home": "Geolocation", "nowhere": "Geolocation"})
        assert tr.fills.tobytes() == jr.fills.tobytes()
        assert not tr.fills[1].any()


# -- transmogrify's stage graph -------------------------------------------------

FAMILY_TYPES = ["RealNN", "Real", "Currency", "Integral", "Binary", "Date", "DateTime",
                "PickList", "City", "Country", "Text", "TextArea", "Email", "URL", "Phone",
                "ID", "Base64", "MultiPickList", "Geolocation", "DateList",
                "DateTimeList", "TextList", "OPVector"]


class TestTransmogrify:
    def test_stage_graph_equal_for_every_ported_family(self):
        def graph(P, ft):
            fs = [P.FeatureBuilder.of(f"f{i}_{t}", ft(t)).extract_field().as_predictor()
                  for i, t in enumerate(FAMILY_TYPES)]
            vec = P.transmogrify(fs)
            out = []
            for p in vec.parents:
                st = p.origin_stage
                if not st.inputs:
                    out.append(p.name)
                    continue
                params = {k: v for k, v in st.get_params().items() if k != "reference_date_ms"}
                out.append((type(st).__name__, params, [f.name for f in st.inputs]))
            return out, type(vec.origin_stage).__name__

        t, j = graph(T, tft), graph(J, jft)
        assert t == j
        classes = {g[0] for g in t[0] if isinstance(g, tuple)}
        assert {"SmartTextVectorizer", "DateToUnitCircleVectorizer", "DateListVectorizer",
                "MultiPickListVectorizer", "GeolocationVectorizer",
                "TextListHashingVectorizer"} <= classes

    def test_type_hierarchy_matches_the_reference(self):
        for name in FAMILY_TYPES + ["Street", "PostalCode", "State", "ComboBox", "Percent"]:
            t, j = tft(name), jft(name)
            assert [k.__name__ for k in t.__mro__ if k.__name__ != "object"] == \
                [k.__name__ for k in j.__mro__ if k.__name__ != "object"], name
            assert t.kind.value == j.kind.value
            for flag in ("is_categorical", "is_single_response", "is_multi_response",
                         "is_location", "is_nullable"):
                assert getattr(t, flag) == getattr(j, flag), (name, flag)

    @pytest.mark.parametrize("name,value", [
        ("Geolocation", [10.5, -20.25, 3]), ("Geolocation", []), ("Geolocation", None),
        ("MultiPickList", ["a", "b", "a"]), ("TextList", ("x", "y")), ("DateList", [1, 2]),
        ("Date", 1700000000000), ("Email", "a@b.c")])
    def test_conversions_equal(self, name, value):
        assert tft(name)._convert(value) == jft(name)._convert(value)

    @pytest.mark.parametrize("name,value", [
        ("Geolocation", [91.0, 0.0, 1.0]), ("Geolocation", [1.0, 2.0]),
        ("MultiPickList", "ab"), ("TextList", [1]), ("DateList", [True])])
    def test_conversions_refuse_alike(self, name, value):
        from transmogrifai_tpu.types import FeatureTypeError as JErr
        from transmogrifai_tpu_torch.types import FeatureTypeError as TErr

        with pytest.raises(JErr):
            jft(name)._convert(value)
        with pytest.raises(TErr):
            tft(name)._convert(value)

    def test_dataset_lift_of_a_geolocation_bitwise(self):
        from transmogrifai_tpu.workflow.plan import _lift_column as jlift
        from transmogrifai_tpu_torch.workflow.plan import DEVICE_LIFT_KINDS
        from transmogrifai_tpu_torch.workflow.plan import _lift_column as tlift

        cols, _ = make_families(200, seed=14)
        jc = J.Dataset.from_features({"home": cols["home"]}, {"home": jft("Geolocation")})
        tc = T.Dataset.from_features({"home": cols["home"]}, {"home": tft("Geolocation")})
        got, want = tlift(tc["home"]), jlift(jc["home"])
        assert got.shape == (200, 3) and got.tobytes() == want.tobytes()
        assert tft("Geolocation").kind in DEVICE_LIFT_KINDS

    def test_columns_of_the_new_kinds_equal(self):
        cols, schema = make_families(50, seed=12)
        for s in schema:
            jc = J.Dataset.from_features({s["name"]: cols[s["name"]]},
                                         {s["name"]: jft(s["type"])})[s["name"]]
            tc = T.Dataset.from_features({s["name"]: cols[s["name"]]},
                                         {s["name"]: tft(s["type"])})[s["name"]]
            assert tc.to_values() == jc.to_values(), s["name"]
            assert tc.present().tolist() == jc.present().tolist()
            if tc.data.dtype != object:
                assert tc.data.tobytes() == jc.data.tobytes()
            taken = tc.take(np.array([3, 1]))
            assert taken.to_values() == jc.take(np.array([3, 1])).to_values()


# -- the slice at the record's size ---------------------------------------------

@pytest.fixture(scope="module")
def record():
    with open(os.path.join(RECORD, "states.json")) as fh:
        states = json.load(fh)
    with open(os.path.join(RECORD, "records.json")) as fh:
        recs = json.load(fh)
    return states, recs


@pytest.fixture(scope="module")
def trained(record):
    """The port's Workflow.train(device="cpu") of the families table at the
    record's rows and seed."""
    states, _ = record
    cols, schema = make_families(states["rows"], seed=states["seed"])
    tf = {s["name"]: tft(s["type"]) for s in schema}
    label, sel, chk, pred = families_pipeline(T, tf, schema)
    ds = T.Dataset.from_features(cols, tf)
    TN.reset_path_counts()
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    # keep the LR sweep's eval operands (its validation scores' inputs)
    import transmogrifai_tpu_torch.models.logistic as TLRmod

    sweeps, eval_sweep = [], TLRmod.eval_linear_sweep

    def capture(xd, yd, betas, vw, metric_fn, link):
        sweeps.append((xd, betas, vw))
        return eval_sweep(xd, yd, betas, vw, metric_fn, link)

    TLRmod.eval_linear_sweep = capture
    try:
        model = wf.train(device="cpu")
    finally:
        TLRmod.eval_linear_sweep = eval_sweep
    return dict(model=model, ds=ds, cols=cols, schema=schema, label=label, sel=sel,
                chk=chk, pred=pred, profile=wf.last_train_profile,
                paths=TN.path_counts(), lr_sweep=sweeps[0])


class TestFamiliesSlice:
    def test_fitted_states_equal_the_jax_record(self, trained, record):
        states, _ = record
        got = json.loads(json.dumps(fitted_states(trained["model"])))
        assert got == states["fitted"]
        assert set(got) == set(STATE_ATTRS)

    def test_training_vector_bitwise(self, trained, record):
        states, _ = record
        vec = trained["chk"].inputs[1]
        got = TFit.transform_dag(trained["ds"], [vec], trained["model"].fitted, "cpu")
        assert vector_digest(got[vec.name].data) == states["vector"]

    def test_the_jax_package_still_makes_the_record(self, record):
        """The record is the JAX package's: its loaded model transforms the
        same table to the recorded vector (its kernels in interpret mode)."""
        states, _ = record
        jm = J.WorkflowModel.load(RECORD)
        cols, schema = make_families(states["rows"], seed=states["seed"])
        ds = J.Dataset.from_features(cols, {s["name"]: jft(s["type"]) for s in schema})
        [chk] = [t for t in jm.fitted.values() if type(t).__name__ == "SanityCheckerModel"]
        vec = chk.inputs[1]
        with KD.force_kernel_mode("interpret"):
            out = JFit.transform_dag(ds, [vec], jm.fitted)[vec.name].data
        assert vector_digest(out) == states["vector"]

    def test_cv_metrics_and_coefficients(self, trained, record):
        """LR CV metrics (auPR per fold) within 1e-4, the tolerance every LR
        parity gate of the port holds against the JAX package: the two
        packages' float32 fits agree to ~1e-7, which orders near-tied
        validation scores either way (each swap moves auPR by ~1e-6; 5.2e-6
        at this seed).  The refit coefficients and intercept within 1e-6."""
        states, _ = record
        summary = trained["model"].fitted[trained["sel"].uid].summary
        assert [e.grid for e in summary.validation_results] == [c["grid"] for c in states["cv"]]
        for e, c in zip(summary.validation_results, states["cv"]):
            np.testing.assert_allclose(e.metric_values, c["values"], rtol=0, atol=1e-4)
        assert (summary.best_model_name, summary.best_grid) == \
            (states["winner"]["name"], states["winner"]["grid"])
        win = trained["model"].fitted[trained["sel"].uid].model
        np.testing.assert_allclose(np.asarray(win.coef), states["winner"]["coef"], rtol=0,
                                   atol=1e-6)
        assert abs(float(win.intercept) - states["winner"]["intercept"]) <= 1e-6

    def test_lr_cv_gaps_are_near_tied_pairs_swapping_order(self, trained, record):
        """The port's LR CV sweep (its validation scores, from the train's
        own sweep) against the JAX package's over the same vector and folds
        (``cv_scores.npz``, ``tools/make_torch_families_cv_scores.py``):
        every (grid, fold) validation auPR that differs comes with pairs of
        validation scores whose order differs between the packages, every
        such pair is near-tied (within 1e-5 in both), and where the orders
        agree the auPRs agree within 1e-7."""
        import torch

        from transmogrifai_tpu.evaluators.base import BinaryClassificationEvaluator as JBE
        from transmogrifai_tpu.models.tuning import CrossValidator as JCV
        from transmogrifai_tpu_torch.evaluators.base import (
            BinaryClassificationEvaluator as TBE,
        )
        from transmogrifai_tpu_torch.models.tuning import CrossValidator as TCV

        states, _ = record
        rec = np.load(os.path.join(RECORD, "cv_scores.npz"))
        sj, jm = rec["scores"], rec["metrics"]
        for gi, c in enumerate(states["cv"]):
            np.testing.assert_array_equal(jm[gi], c["values"])
        summary = trained["model"].fitted[trained["sel"].uid].summary
        tm = np.asarray([e.metric_values for e in summary.validation_results])
        xd, betas, vw = trained["lr_sweep"]
        g, k, d1 = betas.shape
        n = sj.shape[2]
        st = torch.sigmoid(xd @ betas.reshape(g * k, d1).T).numpy().T.reshape(g, k, n)
        vw = vw.numpy()
        y = np.ones(n, np.float32)
        jvw = np.asarray(JCV(JBE(), num_folds=k).fold_weights(y, y)[1])
        np.testing.assert_array_equal(jvw, TCV(TBE(), num_folds=k).fold_weights(y, y)[1])
        np.testing.assert_array_equal(vw, jvw)
        gaps = []
        for gi in range(g):
            for f in range(k):
                rows = vw[f] > 0
                a, b = sj[gi, f, rows].astype(np.float64), st[gi, f, rows].astype(np.float64)
                da, db = a[:, None] - a[None, :], b[:, None] - b[None, :]
                swapped = np.sign(da) != np.sign(db)
                gap = abs(float(tm[gi, f]) - float(jm[gi, f]))
                gaps.append(gap)
                assert np.abs(da[swapped]).max(initial=0.0) <= 1e-5
                assert np.abs(db[swapped]).max(initial=0.0) <= 1e-5
                if not swapped.any():
                    assert gap <= 1e-7, (gi, f, gap)
                if gap > 1e-7:
                    assert swapped.any(), (gi, f, gap)
        assert max(gaps) <= 1e-4

    def test_hashing_took_the_native_path(self, trained):
        _need_native()
        paths = trained["paths"]
        # the review (en) takes the fused kernel; review_de (de) and the
        # email (detected as pt) the analyzer, then the native fill
        assert paths["tokenize_hash_count.native"] >= 1
        assert paths["hash_count_block.native"] >= 1
        assert not [k for k in paths if k.endswith(".python")], paths
        assert paths["tokenize_hash_count.unicode_rows"] > 0

    def test_one_encode_flush_for_the_pick_lists(self, trained):
        flushes = [r for r in trained["profile"] if r["kind"] == "flush"
                   and r.get("encode_slots")]
        assert len(flushes) == 1 and flushes[0]["encode_slots"] == 2

    def test_serving_records_equal_the_jax_record(self, record):
        _, recs = record
        model = T.WorkflowModel.load(RECORD)
        plan = model.serving_plan(device="cpu")
        for b in recs["batches"]:
            assert plan.score(b["records"]) == b["scored"]

    def test_serving_partition_equals_the_jax_plans(self):
        jm, tm = J.WorkflowModel.load(RECORD), T.WorkflowModel.load(RECORD)
        jp, tp = jm.serving_plan(), tm.serving_plan(device="cpu")

        def classes(model, uids):
            by = {f.origin_stage.uid: f.origin_stage
                  for f in _all_features(model.result_features)}
            by.update({s.uid: s for s in model.fitted.values()})
            return sorted(type(by[u]).__name__ for u in uids)

        assert tp.device_stage_uids == jp.device_stage_uids
        assert tp.host_stage_uids == jp.host_stage_uids
        host = classes(tm, tp.host_stage_uids)
        # the SmartText output feeds the combiner: the combiner, the checker
        # and the head stay on the host; the prefix keeps the encode blocks
        assert {"VectorsCombiner", "SanityCheckerModel", "SmartTextVectorizerModel"} <= set(host)
        assert "OneHotVectorizerModel" in classes(tm, tp.device_stage_uids)

    def test_port_saved_model_scores_alike_in_both(self, trained, record, tmp_path):
        import transmogrifai_tpu.models.logistic  # noqa: F401  (the loader's classes)

        _, recs = record
        path = str(tmp_path / "m")
        trained["model"].save(path)
        tm, jm = T.WorkflowModel.load(path), J.WorkflowModel.load(path)
        batch = recs["batches"][0]["records"]
        got = trained["model"].serving_plan(device="cpu").score(batch)
        assert tm.serving_plan(device="cpu").score(batch) == got
        assert jm.serving_plan().score(batch) == got

    def test_jax_saved_model_scores_alike_after_a_port_save(self, record, tmp_path):
        _, recs = record
        tm = T.WorkflowModel.load(RECORD)
        tm.save(str(tmp_path / "again"))
        back = J.WorkflowModel.load(str(tmp_path / "again"))
        for b in recs["batches"]:
            assert back.serving_plan().score(b["records"]) == b["scored"]

    def test_date_list_reference_date_survives_save(self, trained, tmp_path):
        path = str(tmp_path / "d")
        trained["model"].save(path)
        for P in (T, J):
            m = P.WorkflowModel.load(path)
            stages = {f.origin_stage for f in _all_features(m.result_features)}
            [dl] = [s for s in stages if type(s).__name__ == "DateListVectorizer"]
            assert dl.reference_date_ms == REFERENCE_DATE_MS


def _all_features(result_features):
    seen, stack = {}, list(result_features)
    while stack:
        f = stack.pop()
        if f.uid not in seen:
            seen[f.uid] = f
            stack.extend(f.parents)
    return [f for f in seen.values() if f.origin_stage is not None]


def test_records_carry_sets_as_sorted_lists():
    cols, _ = make_families(20, seed=13)
    recs = make_records(cols, range(20))
    assert [r["tags"] for r in recs] == [sorted(s) for s in cols["tags"][:20]]
    assert json.loads(json.dumps(recs)) == recs
