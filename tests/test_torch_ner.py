"""Named-entity recognition: the port against the JAX package.

The reference's hand-labelled real-prose sentences
(``tests/ner_real_fixture{,_es,_nl}.py``) go through both packages and are
held **exactly**: the tokenizer, the hashed features, the rule tagger, the
learned perceptron taggers of en, es and nl (from the weights the port
ships, the same bytes as the reference's), and ``NameEntityRecognizer``
with the language pinned, detected, and with the rule backend; also against
the JAX package's record in ``fixtures/text_stack`` (what the card's run
holds).
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

import transmogrifai_tpu as J
from transmogrifai_tpu.ops import ner as jn
from transmogrifai_tpu.ops import ner_model as jm
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.ops import ner as tn
from transmogrifai_tpu_torch.ops import ner_model as tm
from transmogrifai_tpu.types import Text as JText
from transmogrifai_tpu_torch.types import Text as TText

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from ner_real_fixture import REAL_TEXT  # noqa: E402
from ner_real_fixture_es import REAL_TEXT_ES  # noqa: E402
from ner_real_fixture_nl import REAL_TEXT_NL  # noqa: E402

SENTENCES = {"en": [s for s, _ in REAL_TEXT], "es": [s for s, _ in REAL_TEXT_ES],
             "nl": [s for s, _ in REAL_TEXT_NL]}
with open(os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "text_stack",
                       "record.json")) as _fh:
    RECORD = json.load(_fh)["ner"]
LANGS = ("en", "es", "nl")


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


class TestArtifacts:
    @pytest.mark.parametrize("lang", LANGS)
    def test_port_ships_the_reference_weights(self, lang):
        tpath, jpath = tm.artifact_path_for(lang), jm.artifact_path_for(lang)
        assert tpath.startswith(os.path.join(REPO, "transmogrifai_tpu_torch", "artifacts"))
        assert _sha(tpath) == _sha(jpath)

    @pytest.mark.parametrize("lang", LANGS)
    def test_load_pretrained_returns_a_tagger(self, lang):
        tagger = tm.load_pretrained(language=lang)
        assert isinstance(tagger, tm.PerceptronNameEntityTagger)
        assert tagger.language == lang
        assert tm.load_pretrained(language=lang) is tagger  # cached per language
        np.testing.assert_array_equal(tagger.weights,
                                      jm.load_pretrained(language=lang).weights)

    def test_absent_artifact_gives_none_and_bad_shape_refused(self, tmp_path):
        assert tm.load_pretrained(path=str(tmp_path / "none.npz")) is None
        with pytest.raises(ValueError):
            tm.PerceptronNameEntityTagger(np.zeros((3, 3), np.float32))


class TestTaggers:
    @pytest.mark.parametrize("lang", LANGS)
    def test_tokens_features_and_shapes(self, lang):
        for s in SENTENCES[lang]:
            toks = tn.ner_tokenize(s)
            assert toks == jn.ner_tokenize(s)
            for i, w in enumerate(toks):
                assert tm.word_shape(w) == jm.word_shape(w)
                tf = tm.token_features(toks, i, "Person", lang)
                assert tf == jm.token_features(toks, i, "Person", lang)
                assert tm.hash_features(tf).tolist() == jm.hash_features(tf).tolist()

    @pytest.mark.parametrize("lang", LANGS)
    def test_rule_tagger(self, lang):
        for s in SENTENCES[lang]:
            assert tn.RuleNameEntityTagger().tag(s) == jn.RuleNameEntityTagger().tag(s)

    @pytest.mark.parametrize("lang", LANGS)
    def test_learned_tagger(self, lang):
        tt, jt = tm.load_pretrained(language=lang), jm.load_pretrained(language=lang)
        for s in SENTENCES[lang]:
            toks = tn.ner_tokenize(s)
            assert tt.tag(toks) == jt.tag(toks)
            assert tt.tag_to_entities(toks) == jt.tag_to_entities(toks)


def _recognize(which, sentences, **params):
    P, Text = (J, JText) if which == "j" else (T, TText)
    mod = jn if which == "j" else tn
    f = P.FeatureBuilder.of("t", Text).extract_field().as_predictor()
    stage = mod.NameEntityRecognizer(**params)
    out = f.transform_with(stage)
    ds = P.Dataset.from_features({"t": sentences}, {"t": Text})
    return stage.transform(ds)[out.name].to_values(), stage


class TestRecognizer:
    @pytest.mark.parametrize("lang", LANGS)
    @pytest.mark.parametrize("params", [{}, {"language": "pinned"}, {"tagger": "rules"}])
    def test_real_prose_exact(self, lang, params):
        params = {k: (lang if v == "pinned" else v) for k, v in params.items()}
        rows = SENTENCES[lang] + ["", None, " ".join(SENTENCES[lang][:3])]
        got, stage = _recognize("t", rows, **params)
        want, _ = _recognize("j", rows, **params)
        assert got == want
        for s in SENTENCES[lang][:5]:
            assert stage.transform_values([s]) == \
                jn.NameEntityRecognizer(**params).transform_values([s])

    @pytest.mark.parametrize("lang", LANGS)
    def test_equal_to_the_record(self, lang):
        rec = RECORD[lang]
        assert [r["sentence"] for r in rec] == SENTENCES[lang]
        pinned = tn.NameEntityRecognizer(language=lang)
        auto = tn.NameEntityRecognizer()
        for r in rec:
            assert pinned.transform_values([r["sentence"]]) == r["pinned"]
            assert auto.transform_values([r["sentence"]]) == r["auto"]

    def test_params_refused_alike(self):
        for bad in ({"language": "xx"}, {"tagger": "maxent"}):
            with pytest.raises(ValueError):
                tn.NameEntityRecognizer(**bad)
            with pytest.raises(ValueError):
                jn.NameEntityRecognizer(**bad)
