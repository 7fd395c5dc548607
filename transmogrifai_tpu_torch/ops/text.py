"""Text stages: tokenizer, stop words, n-grams, hashing TF, count vectorizer,
similarities and language detection (counterpart of
``transmogrifai_tpu/ops/text.py``).

The roles of TransmogrifAI's TextTokenizer (Lucene analyzers and its
language detector), OpHashingTF, OpCountVectorizer, OpNGram, NGramSimilarity,
OpStopWordsRemover and TextLenTransformer.  String analysis is host work, as
in the reference: every vectorizer emits a dense count block, and strings
never reach the device.  ``HashingTF`` goes through
``native.hash_count_block`` (murmur3 in C++, the same bits as the Python
path).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..data.dataset import Column
from ..stages.base import (
    BinaryTransformer,
    Param,
    Transformer,
    UnaryEstimator,
    UnaryTransformer,
)
from ..native import hash_count_block
from ..types import Integral, MultiPickList, OPVector, RealMap, RealNN, Text, TextList
from ..utils.text import char_ngrams, ngrams, stop_words_for
from ..utils.vector_metadata import VectorColumnMetadata, VectorMetadata


class TextTokenizer(UnaryTransformer):
    """Text -> TextList with language auto-detection, per-language stopwords
    and Snowball-style stemming (TextTokenizer.scala + LuceneTextAnalyzer).

    ``language='auto'`` detects per row (30+ language n-gram profiles);
    ``stemming='auto'`` stems every language with a language-specific
    analyzer except English — exactly Lucene's analyzer inventory semantics
    (the default English pipeline is the non-stemming StandardAnalyzer).
    """

    input_types = (Text,)
    output_type = TextList

    to_lowercase = Param(default=True)
    min_token_length = Param(default=1)
    remove_stop_words = Param(default=False)
    language = Param(default="auto")
    stemming = Param(default="auto", doc="auto | always | never")

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        from ..utils.text import analyze

        out = np.empty(len(cols[0]), dtype=object)
        for i, v in enumerate(cols[0].data):
            out[i] = analyze(
                v, language=self.language, to_lowercase=self.to_lowercase,
                min_token_length=self.min_token_length,
                remove_stop_words=self.remove_stop_words,
                stemming=self.stemming)
        return Column(TextList, out)


class StopWordsRemover(UnaryTransformer):
    """TextList -> TextList minus stop words (OpStopWordsRemover)."""

    input_types = (TextList,)
    output_type = TextList

    language = Param(default="en")

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        stops = stop_words_for(self.language)
        out = np.empty(len(cols[0]), dtype=object)
        for i, toks in enumerate(cols[0].data):
            out[i] = [t for t in (toks or []) if t.lower() not in stops]
        return Column(TextList, out)


class NGramTransformer(UnaryTransformer):
    """TextList -> TextList of word n-grams (OpNGram)."""

    input_types = (TextList,)
    output_type = TextList

    n = Param(default=2, validator=lambda v: v >= 1)

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        out = np.empty(len(cols[0]), dtype=object)
        for i, toks in enumerate(cols[0].data):
            out[i] = ngrams(toks or [], self.n)
        return Column(TextList, out)


class TextLenTransformer(UnaryTransformer):
    """Text -> Integral length, 0 for empty (TextLenTransformer)."""

    input_types = (Text,)
    output_type = Integral

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        return Column.from_values(
            Integral, [len(v) if v else 0 for v in cols[0].data])


class LanguageDetector(UnaryTransformer):
    """Text -> RealMap of language -> confidence
    (reference RichTextFeature.detectLanguages, LangDetector capability)."""

    input_types = (Text,)
    output_type = RealMap

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        from ..utils.text import detect_language_scores

        return Column.from_values(
            RealMap, [detect_language_scores(v) for v in cols[0].data])

    def transform_values(self, values):
        from ..utils.text import detect_language_scores

        return detect_language_scores(values[0])


def _hash_block(col: Column, width: int, binary: bool) -> np.ndarray:
    # native C++ single-pass kernel when the toolchain is available (native/)
    return hash_count_block(col.data, width, binary=binary)


class HashingTF(UnaryTransformer):
    """TextList -> OPVector via the hashing trick (OpHashingTF, murmur3)."""

    input_types = (TextList,)
    output_type = OPVector

    num_features = Param(default=512)
    binary = Param(default=False)

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        f = self.inputs[0]
        block = _hash_block(cols[0], self.num_features, self.binary)
        meta_cols = [
            VectorColumnMetadata(f.name, f.ftype.__name__, grouping=f.name,
                                 descriptor_value=f"hash_{b}")
            for b in range(self.num_features)
        ]
        meta = VectorMetadata(self.output_name, meta_cols).reindexed()
        return Column.vector(block, meta)


class CountVectorizer(UnaryEstimator):
    """TextList -> OPVector over a fitted vocabulary (OpCountVectorizer)."""

    input_types = (TextList,)
    output_type = OPVector

    vocab_size = Param(default=512)
    min_count = Param(default=1, doc="minimum corpus frequency to enter the vocabulary")
    binary = Param(default=False)

    def fit_columns(self, cols: List[Column], dataset, device) -> Transformer:
        counts: Dict[str, int] = {}
        for toks in cols[0].data:
            for tok in toks or ():
                counts[tok] = counts.get(tok, 0) + 1
        vocab = sorted(
            (t for t, c in counts.items() if c >= self.min_count),
            key=lambda t: (-counts[t], t))[: self.vocab_size]
        return CountVectorizerModel(vocab=vocab, binary=self.binary)


class CountVectorizerModel(UnaryTransformer):
    input_types = (TextList,)
    output_type = OPVector

    def __init__(self, vocab: List[str], binary: bool = False, **kw):
        super().__init__(**kw)
        self.vocab = list(vocab)
        self.binary = bool(binary)
        self._index = {t: j for j, t in enumerate(self.vocab)}

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        f = self.inputs[0]
        if not hasattr(self, "_index") or len(self._index) != len(self.vocab):
            self._index = {t: j for j, t in enumerate(self.vocab)}
        block = np.zeros((len(cols[0]), len(self.vocab)), dtype=np.float32)
        for i, toks in enumerate(cols[0].data):
            for tok in toks or ():
                j = self._index.get(tok)
                if j is not None:
                    if self.binary:
                        block[i, j] = 1.0
                    else:
                        block[i, j] += 1.0
        meta_cols = [
            VectorColumnMetadata(f.name, f.ftype.__name__, grouping=f.name,
                                 indicator_value=t)
            for t in self.vocab
        ]
        meta = VectorMetadata(self.output_name, meta_cols).reindexed()
        return Column.vector(block, meta)


class NGramSimilarity(BinaryTransformer):
    """(Text, Text) -> RealNN char-ngram Jaccard similarity (NGramSimilarity.scala)."""

    input_types = (Text, Text)
    output_type = RealNN

    n = Param(default=3, validator=lambda v: v >= 1)

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        a_col, b_col = cols
        out = []
        for a, b in zip(a_col.data, b_col.data):
            if not a or not b:
                out.append(0.0)
                continue
            sa = set(char_ngrams(a.lower(), self.n))
            sb = set(char_ngrams(b.lower(), self.n))
            union = len(sa | sb)
            out.append(len(sa & sb) / union if union else 0.0)
        return Column.from_values(RealNN, out)


class JaccardSimilarity(BinaryTransformer):
    """(MultiPickList, MultiPickList) -> RealNN set Jaccard (JaccardSimilarity)."""

    input_types = (MultiPickList, MultiPickList)
    output_type = RealNN

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        out = []
        for a, b in zip(cols[0].data, cols[1].data):
            sa, sb = set(a or ()), set(b or ())
            if not sa and not sb:
                out.append(1.0)  # reference: two empties are identical
                continue
            union = len(sa | sb)
            out.append(len(sa & sb) / union if union else 0.0)
        return Column.from_values(RealNN, out)
