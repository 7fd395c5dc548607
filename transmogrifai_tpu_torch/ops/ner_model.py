"""Learned named-entity tagger: an averaged perceptron over hashed features
(counterpart of ``transmogrifai_tpu/ops/ner_model.py``).

The role of TransmogrifAI's OpenNLPNameEntityTagger and its trained maxent
models: a compact averaged-perceptron tagger whose trained weights ship as npz
artifacts in this package (``transmogrifai_tpu_torch/artifacts/ner_tagger.npz``
and the ``_es``/``_nl`` ones: copies of the reference package's, the same
bytes), loaded lazily at first use, one per language.

Per-token multiclass scoring over murmur3-hashed string features (word
identity, orthographic shape, affixes, neighbours, regex classes, the
previous predicted tag), greedy left-to-right decode.  All host string work:
strings never reach the device.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..utils.hashing import murmur3_32

#: classes, aligned with the reference NameEntityType enum
#: (utils/.../text/NameEntityTagger.scala:78-86); index 0 is the null tag
TAG_SET = ("O", "Person", "Location", "Organization", "Date", "Time",
           "Money", "Percentage", "Misc")
TAG_INDEX = {t: i for i, t in enumerate(TAG_SET)}

#: hashed feature space (2^15 buckets keeps the shipped artifact ~1 MB fp16)
NUM_BUCKETS = 1 << 15
HASH_SEED = 7

ARTIFACT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts", "ner_tagger.npz")

_MONEY_RE = re.compile(r"^[$€£¥]\d[\d,]*(?:\.\d+)?[kmb]?$", re.IGNORECASE)
_PERCENT_RE = re.compile(r"^\d[\d,]*(?:\.\d+)?%$")
_TIME_RE = re.compile(r"^\d{1,2}:\d{2}(?::\d{2})?(?:am|pm)?$|^\d{1,2}(?:am|pm)$",
                      re.IGNORECASE)
_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$|^\d{1,2}/\d{1,2}/\d{2,4}$")
_YEAR_RE = re.compile(r"^(19|20)\d{2}$")
_NUM_RE = re.compile(r"^\d[\d,.]*$")


def word_shape(tok: str) -> str:
    """Compressed orthographic shape: 'McDonald' -> 'XxXx', '3:30pm' -> 'd:dx'."""
    out = []
    last = None
    for ch in tok:
        if ch.isupper():
            c = "X"
        elif ch.islower():
            c = "x"
        elif ch.isdigit():
            c = "d"
        else:
            c = ch
        if c != last or c not in "Xxd":
            out.append(c)
        last = c
    return "".join(out)


#: role titles that precede a Person the way honorifics do ("Inspector
#: Valdez", "Secretary Hammond") — dictionary feature, not a tag by itself
ROLE_TITLES = frozenset({
    "secretary", "inspector", "captain", "professor", "sergeant", "maestro",
    "madame", "miss", "uncle", "aunt", "grandmother", "grandfather",
    "councilman", "councilwoman", "senator", "governor", "mayor", "judge",
    "general", "colonel", "lieutenant", "detective", "officer", "president",
    "chairman", "chairwoman", "minister", "ambassador", "bishop", "father",
    "sister", "brother", "coach", "principal", "dean", "reverend",
})


def _dictionary_feats(low: str) -> List[str]:
    """Gazetteer-membership features (the OpenNLP dictionary-feature role):
    the model learns how much to trust each list from data."""
    from .ner import (_CITIES, _COUNTRIES, _FIRST_NAMES, _HONORIFICS,
                      _MONTHS, _ORG_SUFFIXES, _STATES, _WEEKDAYS)

    feats = []
    if low in _MONTHS:
        feats.append("dict=month")
    if low in _WEEKDAYS:
        feats.append("dict=weekday")
    if low in _CITIES:
        feats.append("dict=city")
    if low in _COUNTRIES:
        feats.append("dict=country")
    if low in _STATES:
        feats.append("dict=state")
    if low in _ORG_SUFFIXES:
        feats.append("dict=orgsuf")
    if low in _FIRST_NAMES:
        feats.append("dict=firstname")
    if low in _HONORIFICS:
        feats.append("dict=honorific")
    if low in ROLE_TITLES:
        feats.append("dict=role")
    return feats


def token_features(tokens: Sequence[str], i: int, prev_tag: str,
                   language: str = "en") -> List[str]:
    """Feature strings for token i (shared by training and inference).

    ``language`` swaps ONLY the dictionary layer (per-language gazetteers,
    ops/ner_lang.py); the shape/affix/context features are language-neutral.
    ``"en"`` keeps the exact historical feature stream — the shipped en
    artifact depends on it."""
    if language != "en":
        from .ner_lang import dictionary_feats as _dict_lang

        def dict_feats(lw):
            return _dict_lang(lw, language)
    else:
        dict_feats = _dictionary_feats
    w = tokens[i]
    low = w.lower()
    prev = tokens[i - 1] if i > 0 else "<s>"
    nxt = tokens[i + 1] if i + 1 < len(tokens) else "</s>"
    prev2 = tokens[i - 2] if i > 1 else "<s>"
    nxt2 = tokens[i + 2] if i + 2 < len(tokens) else "</s>"
    prev_low, nxt_low = prev.lower(), nxt.lower()
    feats = [
        f"w={low}",
        f"shape={word_shape(w)}",
        f"pre2={low[:2]}", f"pre3={low[:3]}",
        f"suf2={low[-2:]}", f"suf3={low[-3:]}",
        f"prev={prev_low}", f"next={nxt_low}",
        # 2-away context: "Tunde Bakare works ..." — the FIRST name token
        # only learns person-vs-org from the verb two tokens to its right
        f"prev2={prev2.lower()}", f"next2={nxt2.lower()}",
        f"prevshape={word_shape(prev)}", f"nextshape={word_shape(nxt)}",
        f"prevtag={prev_tag}",
        f"prevtag+shape={prev_tag}|{word_shape(w)}",
        f"w+next={low}|{nxt_low}",
        f"prev+w={prev_low}|{low}",
    ]
    feats.extend(dict_feats(low))
    for df in dict_feats(prev_low):
        feats.append(f"prev{df}")
    for df in dict_feats(nxt_low):
        feats.append(f"next{df}")
    if i == 0:
        feats.append("bos")
    if w[:1].isupper():
        feats.append("cap")
        if i > 0:
            feats.append("cap-mid")  # capitalized NOT at sentence start
    if w.isupper() and len(w) > 1:
        feats.append("allcaps")
    if any(c.isdigit() for c in w):
        feats.append("hasdigit")
    if _MONEY_RE.match(w):
        feats.append("re=money")
    if _PERCENT_RE.match(w):
        feats.append("re=percent")
    if _TIME_RE.match(w):
        feats.append("re=time")
    if _DATE_RE.match(w):
        feats.append("re=date")
    if _YEAR_RE.match(w):
        feats.append("re=year")
    if _NUM_RE.match(w):
        feats.append("re=num")
    return feats


def hash_features(feats: Sequence[str]) -> np.ndarray:
    return np.fromiter(
        (murmur3_32(f, HASH_SEED) % NUM_BUCKETS for f in feats),
        dtype=np.int64, count=len(feats))


class PerceptronNameEntityTagger:
    """Greedy averaged-perceptron tagger over hashed features.

    ``tag(sentence_tokens)`` -> one TAG_SET entry per token;
    ``tag_to_entities(tokens)`` -> token -> set(entity types), the
    NameEntityRecognizer output shape.
    """

    def __init__(self, weights: np.ndarray, language: str = "en"):
        if weights.shape != (NUM_BUCKETS, len(TAG_SET)):
            raise ValueError(
                f"NER weights must be {(NUM_BUCKETS, len(TAG_SET))}, "
                f"got {weights.shape}")
        self.weights = weights.astype(np.float32)
        self.language = language

    def tag(self, tokens: Sequence[str]) -> List[str]:
        prev_tag = "O"
        out = []
        for i in range(len(tokens)):  # opcheck: allow(TM302) a tagger walks a document's tokens in order (host stage)
            idx = hash_features(token_features(tokens, i, prev_tag,
                                               self.language))
            scores = self.weights[idx].sum(axis=0)
            prev_tag = TAG_SET[int(scores.argmax())]
            out.append(prev_tag)
        return out

    def tag_to_entities(self, tokens: Sequence[str]) -> Dict[str, Set[str]]:
        tags: Dict[str, Set[str]] = {}
        for tok, tag in zip(tokens, self.tag(tokens)):
            if tag != "O":
                tags.setdefault(tok, set()).add(tag)
        return tags


_cached_taggers: Dict[str, PerceptronNameEntityTagger] = {}
_load_lock = threading.Lock()


def artifact_path_for(language: str) -> str:
    """Shipped artifact path for a language ('en' keeps the historical
    unsuffixed name) — the OpenNLPModels per-(language) file-map role."""
    if language == "en":
        return ARTIFACT_PATH
    base, ext = os.path.splitext(ARTIFACT_PATH)
    return f"{base}_{language}{ext}"


def load_pretrained(path: Optional[str] = None, language: str = "en"
                    ) -> Optional[PerceptronNameEntityTagger]:
    """The shipped tagger for ``language``, or None when its artifact is
    absent (callers fall back to the rule/gazetteer tagger).  Per-language
    taggers cache independently (OpenNLPModels.scala:48-70 loads one model
    per language the same way)."""
    if path is None and language in _cached_taggers:
        return _cached_taggers[language]
    p = path or artifact_path_for(language)
    if not os.path.exists(p):
        return None
    with _load_lock:
        if path is None and language in _cached_taggers:
            return _cached_taggers[language]
        with np.load(p) as z:
            tagger = PerceptronNameEntityTagger(
                z["weights"].astype(np.float32), language=language)
        if path is None:
            _cached_taggers[language] = tagger
    return tagger
