"""SmartTextVectorizer — the categorical-or-free-text decision per feature
(counterpart of ``transmogrifai_tpu/ops/text_smart.py``).

One fit pass keeps each feature's capped value counts (:class:`TextStats`).
A feature with at most ``max_cardinality`` distinct values pivots as a
categorical (top-K one-hot + OTHER + null); any other is tokenized and
hashed (murmur3) into ``num_hashes`` buckets, with a null indicator.  The
analyzer of a hashed feature is fixed at fit time by a vote over its first
values: English or unknown text takes the fused native tokenize + hash
(``native.tokenize_hash_count``), any other analyzer language the
stemming analyzer (``utils/text.analyze``) and then the hashing fill.
Every decision keeps the reference's order (the first 1000 distinct values,
the vocabulary sorted by (-count, value), the vote's tie broken by the
sorted languages), so both packages decide alike.
``SmartTextMapVectorizer`` makes the same decision for each key of a string
map, the key its metadata grouping.  All of it is host work, as in the
reference: the models have no device half.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from ..data.dataset import Column
from ..stages.base import Param, SequenceEstimator, Transformer
from ..types import OPVector, Text
from ..types.maps import _StringMap
from ..utils.vector_metadata import (
    NULL_INDICATOR,
    OTHER_INDICATOR,
    VectorColumnMetadata,
    VectorMetadata,
)
from .onehot import MIN_SUPPORT_DEFAULT, TOP_K_DEFAULT, clean_text_value

MAX_CARDINALITY_DEFAULT = 30   # SmartTextVectorizer maxCardinality
NUM_HASHES_DEFAULT = 512       # the Transmogrifier's DefaultNumOfFeatures


class TextStats:
    """Capped value counts of one text feature (one fit pass)."""

    __slots__ = ("value_counts", "cardinality_capped")

    def __init__(self, cap: int = 1000):
        self.value_counts: Counter = Counter()
        self.cardinality_capped = cap

    def update(self, value: Optional[str]) -> None:
        if value:
            if len(self.value_counts) < self.cardinality_capped or value in self.value_counts:
                self.value_counts[value] += 1

    @property
    def cardinality(self) -> int:
        return len(self.value_counts)


_LANG_SAMPLE = 64


def _column_language(values, declared: str = "auto") -> str:
    """Dominant language of a text column: a majority vote of
    ``detect_language`` over its first 64 non-empty values (ties go to the
    first language in sorted order; "en" when no vote is cast)."""
    if declared != "auto":
        return declared
    from ..utils.text import detect_language

    votes: Dict[str, int] = {}
    seen = 0
    for v in values:
        if not v:
            continue
        lang = detect_language(v)
        if lang != "unknown":
            votes[lang] = votes.get(lang, 0) + 1
        seen += 1
        if seen >= _LANG_SAMPLE:
            break
    if not votes:
        return "en"
    return max(sorted(votes), key=votes.get)


def _analyzed_hash_block(values, language: str, width: int) -> np.ndarray:
    """Hashed counts through the language's analyzer (stemming + Unicode
    tokenization), bucketed by the same murmur3 as the fused kernel."""
    from ..native import hash_count_block
    from ..utils.text import analyze

    docs = [analyze(v, language=language, stemming="auto") for v in values]
    return hash_count_block(docs, width)


def _use_native_hash(language: str) -> bool:
    """English and unknown columns, and languages with no analyzer, take the
    fused native tokenize + hash (English is not stemmed)."""
    from ..utils.text import analyzer_languages

    return language in ("en", "unknown") or language not in analyzer_languages()


def _decide_plan(stats: TextStats, max_cardinality: int, min_support: int,
                 top_k: int):
    """(is_categorical, vocab): the SmartText decision rule."""
    if 0 < stats.cardinality <= max_cardinality:
        kept = [v for v, c in stats.value_counts.items() if c >= min_support]
        kept = sorted(kept, key=lambda v: (-stats.value_counts[v], v))[:top_k]
        return True, kept
    return False, []


def _categorical_block(values, vocab, clean_text: bool, track_nulls: bool):
    """One-hot top-K + OTHER (+ null) block of a value list."""
    n = len(values)
    k = len(vocab)
    block = np.zeros((n, k + 1 + (1 if track_nulls else 0)), dtype=np.float32)
    index: Dict[str, int] = {v: i for i, v in enumerate(vocab)}
    for i, v in enumerate(values):
        if not v:
            if track_nulls:
                block[i, k + 1] = 1.0
            continue
        j = index.get(clean_text_value(v) if clean_text else v)
        block[i, j if j is not None else k] = 1.0
    return block


def _categorical_meta(f, vocab, grouping: str, track_nulls: bool):
    tname = f.ftype.__name__
    cols = [VectorColumnMetadata(f.name, tname, grouping=grouping,
                                 indicator_value=level) for level in vocab]
    cols.append(VectorColumnMetadata(f.name, tname, grouping=grouping,
                                     indicator_value=OTHER_INDICATOR))
    if track_nulls:
        cols.append(VectorColumnMetadata(f.name, tname, grouping=grouping,
                                         indicator_value=NULL_INDICATOR))
    return cols


class SmartTextVectorizer(SequenceEstimator):
    sequence_input_type = Text
    output_type = OPVector

    max_cardinality = Param(default=MAX_CARDINALITY_DEFAULT)
    num_hashes = Param(default=NUM_HASHES_DEFAULT)
    top_k = Param(default=TOP_K_DEFAULT)
    min_support = Param(default=MIN_SUPPORT_DEFAULT)
    clean_text = Param(default=True)
    track_nulls = Param(default=True)
    track_text_len = Param(default=False)
    language = Param(default="auto", doc="auto = per-feature majority vote")

    def fit_columns(self, cols, dataset, device):
        is_categorical: List[bool] = []
        vocabs: List[List[str]] = []
        languages: List[str] = []
        for col in cols:
            stats = TextStats()
            for v in col.data:
                if v:
                    stats.update(clean_text_value(v) if self.clean_text else v)
            cat, vocab = _decide_plan(stats, self.max_cardinality,
                                      self.min_support, self.top_k)
            is_categorical.append(cat)
            vocabs.append(vocab)
            languages.append("en" if cat else _column_language(col.data, self.language))
        return SmartTextVectorizerModel(
            is_categorical=is_categorical, vocabs=vocabs,
            num_hashes=self.num_hashes, clean_text=self.clean_text,
            track_nulls=self.track_nulls, track_text_len=self.track_text_len,
            languages=languages)


class SmartTextVectorizerModel(Transformer):
    sequence_input_type = Text
    output_type = OPVector

    def __init__(self, is_categorical: List[bool], vocabs: List[List[str]],
                 num_hashes: int = NUM_HASHES_DEFAULT, clean_text: bool = True,
                 track_nulls: bool = True, track_text_len: bool = False,
                 languages: Optional[List[str]] = None, **kw):
        super().__init__(**kw)
        self.is_categorical = is_categorical
        self.vocabs = vocabs
        self.num_hashes = num_hashes
        self.clean_text = clean_text
        self.track_nulls = track_nulls
        self.track_text_len = track_text_len
        #: each feature's analyzer language, fixed at fit time (None: all en)
        self.languages = languages

    def _lang(self, idx: int) -> str:
        return self.languages[idx] if self.languages else "en"

    def transform_columns(self, cols, dataset):
        blocks: List[np.ndarray] = []
        meta_cols: List[VectorColumnMetadata] = []
        for fi, (f, col, cat, vocab) in enumerate(
                zip(self.inputs, cols, self.is_categorical, self.vocabs)):
            tname = f.ftype.__name__
            if cat:
                blocks.append(_categorical_block(list(col.data), vocab,
                                                 self.clean_text, self.track_nulls))
                meta_cols.extend(_categorical_meta(f, vocab, f.name, self.track_nulls))
                continue
            width = self.num_hashes
            lang = self._lang(fi)
            if _use_native_hash(lang):
                from ..native import tokenize_hash_count

                block, _ = tokenize_hash_count(list(col.data), width)
            else:
                block = _analyzed_hash_block(list(col.data), lang, width)
            for b in range(width):
                meta_cols.append(VectorColumnMetadata(f.name, tname, grouping=f.name,
                                                      descriptor_value=f"hash_{b}"))
            extras = []
            if self.track_text_len:
                lens = np.array([float(len(v)) if v else 0.0 for v in col.data],
                                dtype=np.float32)
                extras.append(lens[:, None])
                meta_cols.append(VectorColumnMetadata(f.name, tname, grouping=f.name,
                                                      descriptor_value="textLen"))
            if self.track_nulls:
                nulls = np.array([0.0 if v else 1.0 for v in col.data], dtype=np.float32)
                extras.append(nulls[:, None])
                meta_cols.append(VectorColumnMetadata(f.name, tname, grouping=f.name,
                                                      indicator_value=NULL_INDICATOR))
            blocks.append(np.hstack([block] + extras) if extras else block)
        meta = VectorMetadata(self.output_name, meta_cols,
                              {f.name: f.history().to_dict() for f in self.inputs}).reindexed()
        return Column.vector(np.hstack(blocks), meta)


class SmartTextMapVectorizer(SequenceEstimator):
    """Per-map-key categorical-vs-free-text decision (SmartTextMapVectorizer.scala:1-296).

    One fit pass computes TextStats per (feature, key); each key independently
    pivots as a categorical (<= max_cardinality distinct values -> top-K one-hot
    + OTHER + null) or hashes as free text, exactly like the scalar
    SmartTextVectorizer but with the map's key as the grouping.  Accepts any
    string-valued map (TextMap, TextAreaMap, ...).
    """

    sequence_input_type = _StringMap
    output_type = OPVector

    max_cardinality = Param(default=MAX_CARDINALITY_DEFAULT)
    num_hashes = Param(default=NUM_HASHES_DEFAULT)
    top_k = Param(default=TOP_K_DEFAULT)
    min_support = Param(default=MIN_SUPPORT_DEFAULT)
    clean_text = Param(default=True)
    track_nulls = Param(default=True)
    language = Param(default="auto", doc="auto = per-key majority vote")

    def fit_columns(self, cols, dataset, device):
        key_plans: List[Dict[str, dict]] = []
        for col in cols:
            stats: Dict[str, TextStats] = {}
            for m in col.data:
                for k, v in (m or {}).items():
                    # register every seen key — keys with only empty values still
                    # need a plan (hashed block + null indicator), like the
                    # scalar vectorizer's all-empty column handling
                    st = stats.setdefault(k, TextStats())
                    if v:
                        st.update(clean_text_value(v) if self.clean_text else v)
            plan: Dict[str, dict] = {}
            for k in sorted(stats):
                cat, vocab = _decide_plan(stats[k], self.max_cardinality,
                                          self.min_support, self.top_k)
                lang = "en" if cat else _column_language(
                    [(m or {}).get(k) for m in col.data], self.language)
                plan[k] = {"categorical": cat, "vocab": vocab,
                           "language": lang}
            key_plans.append(plan)
        return SmartTextMapVectorizerModel(
            key_plans=key_plans, num_hashes=self.num_hashes,
            clean_text=self.clean_text, track_nulls=self.track_nulls)


class SmartTextMapVectorizerModel(Transformer):
    sequence_input_type = _StringMap
    output_type = OPVector

    def __init__(self, key_plans: List[Dict[str, dict]],
                 num_hashes: int = NUM_HASHES_DEFAULT, clean_text: bool = True,
                 track_nulls: bool = True, **kw):
        super().__init__(**kw)
        self.key_plans = key_plans
        self.num_hashes = num_hashes
        self.clean_text = clean_text
        self.track_nulls = track_nulls

    def transform_columns(self, cols, dataset):
        n = len(cols[0])
        blocks: List[np.ndarray] = []
        meta_cols: List[VectorColumnMetadata] = []
        for f, col, plan in zip(self.inputs, cols, self.key_plans):
            tname = f.ftype.__name__
            for key, spec in plan.items():
                grouping = f"{f.name}_{key}"
                values = [(m or {}).get(key) for m in col.data]
                if spec["categorical"]:
                    block = _categorical_block(values, spec["vocab"],
                                               self.clean_text, self.track_nulls)
                    meta_cols.extend(_categorical_meta(f, spec["vocab"], grouping,
                                                       self.track_nulls))
                else:
                    lang = spec.get("language", "en")
                    if _use_native_hash(lang):
                        from ..native import tokenize_hash_count

                        block, _ = tokenize_hash_count(values, self.num_hashes)
                    else:
                        block = _analyzed_hash_block(values, lang,
                                                     self.num_hashes)
                    for b in range(self.num_hashes):
                        meta_cols.append(VectorColumnMetadata(
                            f.name, tname, grouping=grouping,
                            descriptor_value=f"hash_{b}"))
                    if self.track_nulls:
                        nulls = np.array([0.0 if v else 1.0 for v in values],
                                         dtype=np.float32)
                        block = np.hstack([block, nulls[:, None]])
                        meta_cols.append(VectorColumnMetadata(
                            f.name, tname, grouping=grouping,
                            indicator_value=NULL_INDICATOR))
                blocks.append(block)
        if not blocks:
            blocks = [np.zeros((n, 0), np.float32)]
        meta = VectorMetadata(
            self.output_name, meta_cols,
            {f.name: f.history().to_dict() for f in self.inputs},
        ).reindexed()
        return Column.vector(np.hstack(blocks), meta)
