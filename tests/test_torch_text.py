"""The text stack: the port against the JAX package.

Module tests hand the same inputs (the text table of
``tests/torch_text_data.py`` from a numpy seed, at most 300 rows, and the
reference's own cases) to each package and hold the outputs **exactly**
(``==`` on values, bytes on blocks, metadata equal): the n-gram helpers and
the sentence splitter (CJK, abbreviations, initials), every stage of
``ops/text.py`` (HashingTF and CountVectorizer bitwise), the time-period
stages of a date, a date list and a date map, and the phone, e-mail, URL and
MIME helpers and stages over the cases of ``tests/test_phone.py`` and
``tests/test_mime.py``; every new stage class saved by one package and
loaded by the other.

The record tests hold the port to ``fixtures/text_stack``, which
``tools/make_torch_text_fixture.py`` made by running the JAX package: the
stage blocks' sha256 at 2000 rows (no Python hashing path taken), and the
small text pipeline at 1024 rows with the reference's Word2Vec and LDA draws
fed to the port's seams (fitted vocabularies ``==``, LR CV within 1e-4,
the winner's coefficients within 1e-4), and the JAX-saved model loaded and
scored by the port's CPU plan (records within 1e-5).
"""

import importlib
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.ops.domains  # noqa: F401  (the loader's classes)
import transmogrifai_tpu.ops.phone  # noqa: F401
import transmogrifai_tpu.ops.text  # noqa: F401
from transmogrifai_tpu.types import feature_type_by_name as jft
from transmogrifai_tpu.workflow import fit as JFit
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch import native
from transmogrifai_tpu_torch.models.logistic import LogisticRegression as TLR
from transmogrifai_tpu_torch.ops import embeddings as TE
from transmogrifai_tpu_torch.types import feature_type_by_name as tft
from transmogrifai_tpu_torch.utils import text as TU
from transmogrifai_tpu.utils import text as JU
from transmogrifai_tpu_torch.workflow import fit as TFit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_families_data as F  # noqa: E402
import torch_text_data as D  # noqa: E402
from test_mime import FIXTURE as MIME_CASES  # noqa: E402
from test_phone import PARITY_FIXTURE as PHONE_CASES  # noqa: E402

FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "text_stack")
with open(os.path.join(FIXTURE, "record.json")) as _fh:
    RECORD = json.load(_fh)
EMBED = np.load(os.path.join(FIXTURE, "embeddings.npz"))


def _pkg(which):
    return (J, jft, "transmogrifai_tpu") if which == "j" else \
        (T, tft, "transmogrifai_tpu_torch")


def _table(n=300, seed=3):
    cols, schema = D.make_text(n, seed=seed)
    return cols, {s["name"]: s["type"] for s in schema}


def run_stage(which, module, cls_name, cols, type_names, params):
    """(fitted runner, output column) of ``module.cls_name(**params)`` over
    ``cols`` (in order: the stage's inputs) in package ``which``."""
    P, ft, root = _pkg(which)
    mod = importlib.import_module(f"{root}.ops.{module}")
    ftypes = {k: ft(type_names[k]) for k in cols}
    feats = [P.FeatureBuilder.of(k, ftypes[k]).extract_field().as_predictor() for k in cols]
    stage = getattr(mod, cls_name)(**params)
    out = feats[0].transform_with(stage, *feats[1:])
    ds = P.Dataset.from_features(cols, ftypes)
    runner = stage
    if hasattr(stage, "fit"):
        runner = stage.fit(ds) if which == "j" else stage.fit(ds, device="cpu")
    return runner, runner.transform(ds)[out.name]


def _meta(meta) -> dict:
    d = meta.to_dict()
    d.pop("name")
    return json.loads(re.sub(r"_[0-9a-f]{12}\b", "_<uid>", json.dumps(d)))


def both(module, cls_name, cols, type_names, **params):
    jr, jc = run_stage("j", module, cls_name, cols, type_names, params)
    tr, tc = run_stage("t", module, cls_name, cols, type_names, params)
    assert tc.ftype.__name__ == jc.ftype.__name__
    if jc.ftype.__name__ == "OPVector":
        assert tc.data.dtype == jc.data.dtype == np.float32
        assert tc.data.shape == jc.data.shape
        assert tc.data.tobytes() == jc.data.tobytes()
        assert _meta(tc.meta) == _meta(jc.meta)
    else:
        assert tc.to_values() == jc.to_values()
        assert tc.present().tolist() == jc.present().tolist()
    return jr, tr, tc


def _tokens(cols, names, which="t"):
    """The reviews' cleaned token lists (tokenizer -> stop words)."""
    _, tok = run_stage(which, "text", "TextTokenizer", {"review": cols["review"]}, names, {})
    return tok.to_values()


MIXED = ["The Quick brown fox jumps over the lazy dog.", "", None,
         "Der schnelle braune Fuchs springt über den faulen Hund und läuft weiter",
         "東京タワーに行きました 2024年", "El rápido zorro marrón salta sobre el perro perezoso",
         "café naïve résumé 42 x", "ÄÖÜ ß Straße", "一", "a b c d e f g h"]


# -- the helpers of utils/text.py ------------------------------------------------------

class TestTextUtils:
    @pytest.mark.parametrize("tokens,n", [
        ([], 2), (["a"], 2), (["a", "b", "c"], 1), (["a", "b", "c"], 2), (["a", "b", "c"], 3),
        (["a", "b", "c"], 4), (["東京", "タワ"], 2), (["x", "y", "z", "w"], 0)])
    def test_ngrams(self, tokens, n):
        assert TU.ngrams(tokens, n) == JU.ngrams(tokens, n)

    @pytest.mark.parametrize("text,n", [
        ("", 3), ("ab", 3), ("abc", 3), ("hello world", 3), ("hello", 2), ("东京塔很高", 2),
        ("naïve", 1), ("x", 1)])
    def test_char_ngrams(self, text, n):
        assert TU.char_ngrams(text, n) == JU.char_ngrams(text, n)

    @pytest.mark.parametrize("text,lang", [
        ("Mr. Smith went to Washington. He arrived at 5 p.m. on Friday!", "en"),
        ("J. Doe met Dr. Who. I left. Then U.S. officials spoke.", "en"),
        ("Is it? Yes!! It is... Done", "en"),
        ("La Sra. García llegó. El Dr. Pérez no. Núm. 5 está aquí.", "es"),
        ("Dhr. Jansen woont in Utrecht. Mevr. de Vries niet. Nr. 12 klopt.", "nl"),
        ("Dhr. Jansen woont in Utrecht. Mevr. de Vries niet.", "en"),
        ("今日は晴れです。明日は雨です。 Tomorrow. Rain.", "en"),
        ("No terminal punctuation here", "en"), ("", "en"), (None, "en"), ("   ", "en"),
        ("e.g. this. i.e. that. Fig. 3 shows it.", "en")])
    def test_split_sentences(self, text, lang):
        assert TU.split_sentences(text, language=lang) == JU.split_sentences(text, language=lang)

    @pytest.mark.parametrize("text", MIXED)
    def test_tokenize_and_analyze(self, text):
        assert TU.tokenize(text) == JU.tokenize(text)
        for kw in ({}, {"remove_stop_words": True}, {"stemming": "always"},
                   {"language": "de", "min_token_length": 3}):
            assert TU.analyze(text, **kw) == JU.analyze(text, **kw)


# -- the stages of ops/text.py ---------------------------------------------------------

class TestTextStages:
    @pytest.mark.parametrize("params", [
        {}, {"language": "en"}, {"remove_stop_words": True}, {"stemming": "never"},
        {"stemming": "always", "to_lowercase": False}, {"min_token_length": 4}])
    def test_tokenizer(self, params):
        cols, names = _table(200, seed=1)
        cols = {"review": cols["review"][:190] + MIXED}
        both("text", "TextTokenizer", cols, names, **params)

    @pytest.mark.parametrize("language", ["en", "de", "es"])
    def test_stop_words_remover(self, language):
        cols, names = _table(200, seed=2)
        toks = _tokens(cols, names) + [None, [], ["Der", "und", "THE", "y", "el"]]
        both("text", "StopWordsRemover", {"toks": toks}, {"toks": "TextList"},
             language=language)

    @pytest.mark.parametrize("n", [1, 2, 3])
    def test_ngram_transformer(self, n):
        cols, names = _table(200, seed=4)
        toks = _tokens(cols, names) + [None, [], ["one"]]
        both("text", "NGramTransformer", {"toks": toks}, {"toks": "TextList"}, n=n)

    def test_text_len_and_languages(self):
        cols, names = _table(150, seed=5)
        text = {"review": cols["review"][:140] + MIXED}
        both("text", "TextLenTransformer", text, names)
        _, tr, _ = both("text", "LanguageDetector", text, names)
        from transmogrifai_tpu.ops.text import LanguageDetector as JLD

        for v in MIXED:
            assert tr.transform_values([v]) == JLD().transform_values([v])

    @pytest.mark.parametrize("params", [{}, {"num_features": 64}, {"binary": True},
                                        {"num_features": 7, "binary": True}])
    def test_hashing_tf_bitwise(self, params):
        cols, names = _table(300, seed=6)
        toks = _tokens(cols, names) + [None, [], ["ß", "東京", "a b"]]
        both("text", "HashingTF", {"toks": toks}, {"toks": "TextList"}, **params)

    @pytest.mark.parametrize("params", [{}, {"vocab_size": 16}, {"min_count": 3},
                                        {"binary": True, "vocab_size": 40}])
    def test_count_vectorizer_bitwise(self, params):
        cols, names = _table(300, seed=7)
        toks = _tokens(cols, names) + [None, []]
        jr, tr, _ = both("text", "CountVectorizer", {"toks": toks}, {"toks": "TextList"},
                         **params)
        assert tr.vocab == jr.vocab and tr.binary == jr.binary

    def test_count_vectorizer_order_is_count_then_token(self):
        toks = [["b", "a", "c"], ["c", "b"], ["c", "d", "a"]]
        _, tr, _ = both("text", "CountVectorizer", {"toks": toks}, {"toks": "TextList"})
        assert tr.vocab == ["c", "a", "b", "d"]

    @pytest.mark.parametrize("n", [2, 3, 5])
    def test_ngram_similarity(self, n):
        cols, names = _table(200, seed=8)
        a = cols["title"][:195] + [None, "", "abc", "Same", "x"]
        b = cols["review"][:195] + ["abc", "abc", None, "same", "xyz"]
        both("text", "NGramSimilarity", {"title": a, "review": b}, names, n=n)

    def test_jaccard_similarity(self):
        rng = np.random.default_rng(9)
        levels = list("abcdefgh")
        a = [set(rng.choice(levels, int(rng.integers(0, 4)))) for _ in range(100)]
        b = [set(rng.choice(levels, int(rng.integers(0, 4)))) for _ in range(100)]
        a += [None, set(), {"x"}]
        b += [None, {"x"}, set()]
        both("text", "JaccardSimilarity", {"a": a, "b": b},
             {"a": "MultiPickList", "b": "MultiPickList"})

    def test_blocks_equal_the_record_with_no_python_hashing(self):
        rec = RECORD["blocks"]
        cols, schema = D.make_text(rec["rows"], seed=0)
        ftypes = {s["name"]: tft(s["type"]) for s in schema}
        review = T.FeatureBuilder.of("review", ftypes["review"]).extract_field().as_predictor()
        from transmogrifai_tpu_torch.ops import text

        tokens = review.tokenize()
        clean = tokens.transform_with(text.StopWordsRemover())
        bigrams = clean.transform_with(text.NGramTransformer(n=2))
        counts = bigrams.transform_with(text.CountVectorizer(vocab_size=512))
        hashed = clean.transform_with(text.HashingTF(num_features=512))
        ds = T.Dataset.from_features({"review": cols["review"]}, {"review": ftypes["review"]})
        feats = [tokens, clean, bigrams, counts, hashed]
        assert native.warmup()
        native.reset_path_counts()
        model = T.Workflow().set_input_dataset(ds).set_result_features(*feats) \
            .train(device="cpu")
        out = TFit.transform_dag(ds, feats, model.fitted, "cpu")
        counts_by_path = native.path_counts()
        assert counts_by_path.get("hash_count_block.native", 0) >= 1, counts_by_path
        assert not any(k.endswith(".python") for k in counts_by_path), counts_by_path
        for k, f in (("tokens", tokens), ("clean", clean), ("bigrams", bigrams)):
            assert D.token_digest(out[f.name].data) == rec[k], k
        assert D.block_digest(out[counts.name].data) == rec["counts"]
        assert D.block_digest(out[hashed.name].data) == rec["hashed"]
        cvm = model.fitted[counts.origin_stage.uid]
        assert cvm.vocab == rec["count_vocab"]


# -- time periods ------------------------------------------------------------------------

PERIODS = ("DayOfMonth", "DayOfWeek", "DayOfYear", "HourOfDay", "MonthOfYear",
           "WeekOfMonth", "WeekOfYear")


class TestTimePeriods:
    def _dates(self, n=120, seed=10):
        rng = np.random.default_rng(seed)
        ms = [int(v) for v in rng.integers(0, 1_900_000_000_000, n)]
        ms[:4] = [0, 951782400000, 1704067199999, 1704067200000]  # leap day, year ends
        return ms

    @pytest.mark.parametrize("period", PERIODS)
    def test_date(self, period):
        d = self._dates()
        d[5] = None
        both("dates", "TimePeriodTransformer", {"d": d}, {"d": "Date"}, period=period)

    @pytest.mark.parametrize("period", PERIODS)
    def test_date_list(self, period):
        d = self._dates(200, seed=11)
        lists = [d[i:i + (i % 20)] for i in range(0, 180, 3)] + [None, []]
        with pytest.warns(UserWarning):
            both("dates", "TimePeriodListTransformer", {"d": lists}, {"d": "DateList"},
                 period=period)
        both("dates", "TimePeriodListTransformer", {"d": lists}, {"d": "DateList"},
             period=period, max_elements=24, pad_value=-7.0)

    @pytest.mark.parametrize("period", PERIODS)
    def test_date_map(self, period):
        d = self._dates(90, seed=12)
        maps = [{f"k{j}": d[i + j] for j in range(i % 4)} for i in range(80)] + [None, {}]
        both("dates", "TimePeriodMapTransformer", {"d": maps}, {"d": "DateMap"},
             period=period)

    def test_unknown_period_refused(self):
        from transmogrifai_tpu_torch.ops.dates import TimePeriodTransformer

        with pytest.raises(ValueError):
            TimePeriodTransformer(period="Fortnight")


# -- phone, e-mail, URL, MIME -----------------------------------------------------------

class TestPhoneAndDomains:
    def test_parse_phone_on_the_reference_cases(self):
        from transmogrifai_tpu.ops import phone as jp
        from transmogrifai_tpu_torch.ops import phone as tp

        assert tp.supported_regions() == jp.supported_regions()
        for raw, region, expected in PHONE_CASES:
            assert tp.parse_phone(raw, region) == jp.parse_phone(raw, region) == expected
            for strict in (False, True):
                assert tp.validate_phone(raw, region, strict) == \
                    jp.validate_phone(raw, region, strict)
            assert tp.clean_number(raw) == jp.clean_number(raw)

    @pytest.mark.parametrize("phone,region", [
        ("4155552671", "US"), ("020 7183 8750", "United Kingdom"), ("020 7183 8750", "Untied Kingdom"),
        ("01 42 68 53 00", "france"), ("01 42 68 53 00", None), (None, "US"), ("+44 20", "GB"),
        ("4155552671", "ZZ")])
    def test_resolve_region(self, phone, region):
        from transmogrifai_tpu.ops import phone as jp
        from transmogrifai_tpu_torch.ops import phone as tp

        assert tp.resolve_region(phone, region, "US") == jp.resolve_region(phone, region, "US")

    @pytest.mark.parametrize("cls,params", [
        ("ParsePhoneDefaultCountry", {}), ("ParsePhoneDefaultCountry", {"default_region": "GB"}),
        ("IsValidPhoneDefaultCountry", {}),
        ("IsValidPhoneDefaultCountry", {"strict_validation": True})])
    def test_phone_stages(self, cls, params):
        phones = [raw for raw, _, _ in PHONE_CASES] + [None, "", "(415) 555-2671 x12"]
        both("phone", cls, {"p": phones}, {"p": "Phone"}, **params)

    @pytest.mark.parametrize("cls", ["ParsePhoneNumber", "IsValidPhoneNumber"])
    def test_phone_country_stages(self, cls):
        phones = [raw for raw, _, _ in PHONE_CASES] + [None, "4155552671"]
        regions = [region for _, region, _ in PHONE_CASES] + ["US", "united states"]
        both("phone", cls, {"p": phones, "r": regions}, {"p": "Phone", "r": "Text"})

    def test_phone_map_stage(self):
        phones = [raw for raw, _, _ in PHONE_CASES]
        maps = [{"home": phones[i], "work": phones[-1 - i]} for i in range(len(phones))]
        maps += [None, {}]
        both("phone", "IsValidPhoneMapDefaultCountry", {"m": maps}, {"m": "PhoneMap"})

    def test_mime_on_the_reference_cases(self):
        import base64

        from transmogrifai_tpu.ops.domains import detect_mime_type as jd
        from transmogrifai_tpu_torch.ops.domains import detect_mime_type as td

        for label, raw, expected in MIME_CASES:
            b64 = base64.b64encode(raw).decode("ascii")
            assert td(b64) == jd(b64) == expected, label
        for odd in (None, "", "!!notbase64!!", "QQ=="):
            assert td(odd) == jd(odd)

    EMAILS = ["a@b.com", "first.last+tag@sub.example.co.uk", "bad@", "@bad.com", "no at",
              "x@y", "UPPER@CASE.ORG", None, "", "a@b@c.com", " spaced@x.com "]
    URLS = ["https://www.example.com/a?b=1", "http://localhost:8080", "ftp://files.org/x",
            "www.example.com", "not a url", None, "", "https://", "HTTP://EXAMPLE.COM",
            "mailto:a@b.com", "https://sub.domain.co.uk:443/path#frag"]

    def test_email_and_url_helpers(self):
        from transmogrifai_tpu.ops import domains as jd
        from transmogrifai_tpu_torch.ops import domains as td

        for fn in ("is_valid_email", "email_prefix", "email_domain"):
            for v in self.EMAILS:
                assert getattr(td, fn)(v) == getattr(jd, fn)(v), (fn, v)
        for fn in ("is_valid_url", "url_domain", "url_protocol"):
            for v in self.URLS:
                assert getattr(td, fn)(v) == getattr(jd, fn)(v), (fn, v)
        for v in [raw for raw, _, _ in PHONE_CASES] + [None]:
            assert td.parse_phone(v) == jd.parse_phone(v)

    @pytest.mark.parametrize("cls,tname,values", [
        ("ValidEmailTransformer", "Email", EMAILS), ("EmailToPickList", "Email", EMAILS),
        ("ValidUrlTransformer", "URL", URLS), ("UrlToDomainTransformer", "URL", URLS),
        ("PhoneNumberValidator", "Phone", ["+1 415 555 2671", "555", None, "020 7183 8750"]),
        ("MimeTypeDetector", "Base64", ["iVBORw0KGgoAAAAAAAAAAAAAAAA=", "JVBERi0xLjQK", None,
                                        "", "aGVsbG8gd29ybGQ="])])
    def test_value_stages(self, cls, tname, values):
        both("domains", cls, {"v": values}, {"v": tname})


# -- serde both ways ---------------------------------------------------------------------

def _serde_dag(which):
    """(result features, dataset) over every new stage class of the slice."""
    P, ft, root = _pkg(which)
    mods = {m: importlib.import_module(f"{root}.ops.{m}")
            for m in ("text", "dates", "phone", "domains", "ner", "embeddings")}
    cols, names = _table(160, seed=13)
    names["tags"] = names["tags2"] = "MultiPickList"
    rng = np.random.default_rng(13)
    cols["tags"] = [set(rng.choice(list("abcde"), int(rng.integers(0, 3)))) for _ in range(160)]
    cols["tags2"] = [set(rng.choice(list("abcde"), int(rng.integers(0, 3)))) for _ in range(160)]
    names["visits"], names["stamps"] = "DateList", "DateMap"
    cols["visits"] = [cols["created"][i:i + i % 5] for i in range(160)]
    cols["stamps"] = [{"a": cols["created"][i]} if i % 3 else {} for i in range(160)]
    names["region"] = "Text"
    cols["region"] = ["US" if i % 2 else "GB" for i in range(160)]
    use = list(names)
    ftypes = {k: ft(names[k]) for k in use}
    fs = {k: P.FeatureBuilder.of(k, ftypes[k]).extract_field().as_predictor() for k in use}
    t, e = mods["text"], mods["embeddings"]
    toks = fs["review"].transform_with(t.TextTokenizer(remove_stop_words=True,
                                                       stemming="never"))
    clean = toks.transform_with(t.StopWordsRemover(language="en"))
    outs = [
        toks, clean, clean.transform_with(t.NGramTransformer(n=3)),
        fs["review"].transform_with(t.TextLenTransformer()),
        fs["review"].transform_with(t.LanguageDetector()),
        clean.transform_with(t.HashingTF(num_features=32, binary=True)),
        clean.transform_with(t.CountVectorizer(vocab_size=24, min_count=2)),
        fs["title"].transform_with(t.NGramSimilarity(n=2), fs["review"]),
        fs["tags"].transform_with(t.JaccardSimilarity(), fs["tags2"]),
        clean.transform_with(e.Word2Vec(embedding_dim=4, max_vocab=30, epochs=1)),
        clean.transform_with(e.LDA(k=3, max_vocab=30, max_iter=2, inner_iter=2)),
        fs["title"].transform_with(mods["ner"].NameEntityRecognizer(language="en")),
        fs["created"].transform_with(mods["dates"].TimePeriodTransformer(period="WeekOfYear")),
        fs["visits"].transform_with(mods["dates"].TimePeriodListTransformer(
            period="HourOfDay", max_elements=4)),
        fs["stamps"].transform_with(mods["dates"].TimePeriodMapTransformer(period="DayOfWeek")),
        fs["phone"].transform_with(mods["phone"].ParsePhoneDefaultCountry(default_region="US")),
        fs["phone"].transform_with(mods["phone"].IsValidPhoneNumber(strict_validation=True),
                                   fs["region"]),
        fs["email"].transform_with(mods["domains"].ValidEmailTransformer()),
        fs["url"].transform_with(mods["domains"].UrlToDomainTransformer()),
    ]
    return outs, P.Dataset.from_features({k: cols[k] for k in use}, ftypes)


def _values(col):
    return col.data.tobytes() if col.ftype.__name__ == "OPVector" else col.to_values()


@pytest.mark.parametrize("saver", ["t", "j"])
def test_every_new_class_crosses_serde(saver, tmp_path):
    loader = "j" if saver == "t" else "t"
    outs, ds = _serde_dag(saver)
    P = _pkg(saver)[0]
    kw = {"device": "cpu"} if saver == "t" else {}
    model = P.Workflow().set_input_dataset(ds).set_result_features(*outs).train(**kw)
    path = str(tmp_path / "m")
    model.save(path)
    loaded = _pkg(loader)[0].WorkflowModel.load(path)
    classes = {type(x).__name__ for x in loaded.fitted.values()}
    assert {"CountVectorizerModel", "Word2VecModel", "LDAModel"} <= classes
    _, lds = _serde_dag(loader)
    fit_s, fit_l = (TFit, JFit) if saver == "t" else (JFit, TFit)
    args_s = ("cpu",) if saver == "t" else ()
    args_l = ("cpu",) if loader == "t" else ()
    want = fit_s.transform_dag(ds, outs, model.fitted, *args_s)
    got = fit_l.transform_dag(lds, loaded.result_features, loaded.fitted, *args_l)
    for a, b in zip(outs, loaded.result_features):
        wa, gb = want[a.name], got[b.name]
        if type(a.origin_stage).__name__ == "LDA":
            # the E-step's float32 digamma: XLA's and torch's differ in the last bits
            np.testing.assert_allclose(gb.data, wa.data, rtol=1e-5, atol=1e-6)
        else:
            assert _values(gb) == _values(wa), a.name


# -- the slice: the small text pipeline against the JAX record ---------------------------

def feed_reference_draws(monkeypatch, prefix: str):
    """Replace the port's Word2Vec and LDA seams with the record's draws."""
    def w2v(seed, v, dim, device):
        w_in, w_out = EMBED[f"{prefix}w2v_w_in0"], EMBED[f"{prefix}w2v_w_out0"]
        assert w_in.shape == (v, dim) and seed == 42
        return torch.from_numpy(w_in.copy()).to(device), torch.from_numpy(w_out.copy()).to(device)

    def lda(seed, k, v, device):
        lam0 = EMBED[f"{prefix}lda_lam0"]
        assert lam0.shape == (k, v) and seed == 42
        return torch.from_numpy(lam0.copy()).to(device)

    monkeypatch.setattr(TE, "draw_word2vec_init", w2v)
    monkeypatch.setattr(TE, "draw_lda_init", lda)


def _torch_ns():
    import types

    from transmogrifai_tpu_torch.ops import text

    return types.SimpleNamespace(
        FeatureBuilder=T.FeatureBuilder, transmogrify=T.transmogrify,
        SanityChecker=T.SanityChecker,
        BinaryClassificationModelSelector=T.BinaryClassificationModelSelector,
        LogisticRegression=TLR, text=text, embeddings=TE)


@pytest.fixture(scope="module")
def pipeline():
    mp = pytest.MonkeyPatch()
    feed_reference_draws(mp, "pipe_")
    try:
        rec = RECORD["pipeline"]
        cols, schema = D.make_text(2000, seed=rec["seed"])
        cols = {k: v[:rec["rows"]] for k, v in cols.items()}
        ftypes = {s["name"]: tft(s["type"]) for s in schema}
        label, sel, _, pred, handles = D.text_pipeline(_torch_ns(), ftypes, wide=False)
        ds = T.Dataset.from_features(cols, ftypes)
        model = T.Workflow().set_input_dataset(ds).set_result_features(label, pred) \
            .train(device="cpu")
    finally:
        mp.undo()
    return model, sel, handles


class TestPipeline:
    def test_fitted_states_equal_the_record(self, pipeline):
        model, _, handles = pipeline
        assert D.fitted_states(model) == RECORD["pipeline"]["states"]
        w2v = model.fitted[handles["w2v"].origin_stage.uid]
        lda = model.fitted[handles["lda"].origin_stage.uid]
        np.testing.assert_allclose(w2v.vectors, EMBED["pipe_w2v_vectors"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(lda.topic_word, EMBED["pipe_lda_topic_word"], rtol=1e-4)

    def test_cv_and_winner_within_the_lr_gate(self, pipeline):
        model, sel, _ = pipeline
        rec = RECORD["pipeline"]
        summary = model.fitted[sel.uid].summary
        got = [[float(v) for v in e.metric_values] for e in summary.validation_results]
        np.testing.assert_allclose(got, [r["values"] for r in rec["cv"]], rtol=0, atol=1e-4)
        assert summary.best_grid == rec["winner"]["grid"]
        win = model.fitted[sel.uid].model
        np.testing.assert_allclose(np.asarray(win.coef), rec["winner"]["coef"],
                                   rtol=0, atol=1e-4)

    def test_jax_saved_model_scores_on_the_port(self):
        model = T.WorkflowModel.load(os.path.join(FIXTURE, "model"))
        plan = model.serving_plan(device="cpu")
        pname = RECORD["pipeline"]["prediction"]
        for batch in RECORD["pipeline"]["batches"]:
            got = plan.score(batch["records"])
            assert len(got) == len(batch["scored"])
            for g, w in zip(got, batch["scored"]):
                assert g.keys() == w.keys()
                gp, wp = g[pname], w[pname]
                assert gp.keys() == wp.keys() and gp["prediction"] == wp["prediction"]
                for k in gp:
                    assert abs(gp[k] - wp[k]) <= 1e-5 * max(1.0, abs(wp[k])), (k, gp, wp)
