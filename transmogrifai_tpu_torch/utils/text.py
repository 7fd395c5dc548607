"""Host text utilities: tokenization, n-grams, language-aware analysis and
sentence splitting (the port's copy of ``transmogrifai_tpu/utils/text.py``).

The roles of TransmogrifAI's LuceneTextAnalyzer and TextTokenizer, as simple
host functions: strings never reach the device; the tokenizers feed the
hashing trick, whose count blocks do.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

_TOKEN_RE = re.compile(r"[^\W\d_]+|\d+", re.UNICODE)

# CJK scripts that carry no word delimiters: Han (incl. extension A and
# compatibility ideographs), Hiragana, Katakana (incl. phonetic extensions).
# Hangul is space-delimited in modern Korean and keeps whole-word tokens.
_CJK_RUN_RE = re.compile(
    "[㐀-䶿一-鿿豈-﫿"
    "぀-ゟ゠-ヿㇰ-ㇿ]+")


def _cjk_bigrams(run: str) -> List[str]:
    """Overlapping character bigrams of one CJK run (unigram for singletons)
    — the Lucene CJKAnalyzer recipe (LuceneTextAnalyzer.scala routes zh/ja
    to bigram analyzers): no dictionary, stable hash features, and two-char
    units approximate real word boundaries well for Chinese and Japanese."""
    if len(run) < 2:
        return [run]
    return [run[i:i + 2] for i in range(len(run) - 1)]


def _segment_cjk(token: str) -> List[str]:
    """Split a mixed token into CJK bigrams + non-CJK remainder pieces."""
    out: List[str] = []
    pos = 0
    for m in _CJK_RUN_RE.finditer(token):
        if m.start() > pos:
            out.append(token[pos:m.start()])
        out.extend(_cjk_bigrams(m.group()))
        pos = m.end()
    if pos < len(token):
        out.append(token[pos:])
    return out

# minimal English stop set (reference uses Lucene per-language analyzers)
STOP_WORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such that the
    their then there these they this to was will with""".split()
)

MIN_TOKEN_LENGTH = 1


def tokenize(
    text: Optional[str],
    to_lowercase: bool = True,
    min_token_length: int = MIN_TOKEN_LENGTH,
    remove_stop_words: bool = False,
) -> List[str]:
    """Analyze a string into tokens (Lucene-standard-analyzer-like behavior)."""
    if not text:
        return []
    if to_lowercase:
        text = text.lower()
    # ONE scan of the raw string decides the CJK path (CJK chars always
    # survive _TOKEN_RE, so this is equivalent to scanning every token —
    # and keeps the pure-Latin hashing hot path at a single regex pass)
    has_cjk = _CJK_RUN_RE.search(text) is not None
    tokens = _TOKEN_RE.findall(text)
    # undelimited CJK runs segment into overlapping character bigrams so
    # zh/ja free text feeds the hashing trick with word-like units instead
    # of one giant token per clause (the Lucene CJKAnalyzer role)
    if has_cjk:
        tokens = [piece for t in tokens for piece in _segment_cjk(t)]
    if min_token_length > 1:
        # CJK bigrams are 2 chars by construction and survive any sane
        # min length; latin filtering applies unchanged
        tokens = [t for t in tokens if len(t) >= min_token_length
                  or _CJK_RUN_RE.search(t)]
    if remove_stop_words:
        tokens = [t for t in tokens if t not in STOP_WORDS]
    return tokens


def ngrams(tokens: Sequence[str], n: int = 2) -> List[str]:
    """Word n-grams (reference OpNGram)."""
    if n <= 1:
        return list(tokens)
    return [" ".join(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


def char_ngrams(text: str, n: int = 3) -> List[str]:
    """Character n-grams (reference NGramSimilarity's Lucene char-ngram analyzer)."""
    if len(text) < n:
        return [text] if text else []
    return [text[i:i + n] for i in range(len(text) - n + 1)]


# Language identification, per-language stopwords, and stemming live in
# utils/lang.py (30+ language char-n-gram profiles, 10 Snowball-style
# stemmers — the optimaize LanguageDetector + LuceneTextAnalyzer roles).
from .lang import (  # noqa: E402, F401 — re-exported public surface
    LANGUAGES,
    STEMMED_LANGUAGES,
    analyzer_languages,
    detect_language,
    detect_language_scores,
    stem,
    stem_tokens,
    stop_words_for,
)


def analyze(
    text: Optional[str],
    language: str = "auto",
    to_lowercase: bool = True,
    min_token_length: int = MIN_TOKEN_LENGTH,
    remove_stop_words: bool = False,
    stemming: str = "auto",
) -> List[str]:
    """Language-aware analysis: tokenize + per-language stopwords + stemming
    (the LuceneTextAnalyzer per-language analyzer role, TextTokenizer.scala).

    ``language='auto'`` detects per input.  ``stemming`` mirrors Lucene's
    analyzer inventory semantics: ``'auto'`` stems every language that has a
    language-specific analyzer EXCEPT English (Lucene's default English
    pipeline is the non-stemming StandardAnalyzer, so English hash features
    stay stable); ``'always'`` also applies the English Porter-lite pass;
    ``'never'`` disables stemming.
    """
    if not text:
        return []
    tokens = tokenize(text, to_lowercase=to_lowercase,
                      min_token_length=min_token_length)
    wants_stem = stemming in ("always", "auto")
    if not (remove_stop_words or wants_stem):
        return tokens  # nothing downstream reads the language — skip detect

    if language != "auto":
        lang, confident = language, True
    else:
        # Short rows carry too little n-gram signal to trust a non-English
        # analyzer: a misdetected 'sv'/'nl' stemmer would silently mangle
        # English tokens ("Server error" -> "serv err").  Auto-stemming
        # requires a confident detection over enough text; stopword removal
        # uses the detected language either way (en fallback is harmless).
        scores = detect_language_scores(text)
        lang = max(scores, key=scores.get) if scores else "unknown"
        confident = (bool(scores) and scores[lang] >= 0.55
                     and len(text) >= 24)
    if remove_stop_words and tokens:
        stops = stop_words_for(lang)
        tokens = [t for t in tokens if t.lower() not in stops]
    if stemming == "always" or (stemming == "auto" and confident
                                and lang != "en"):
        tokens = stem_tokens(tokens, lang)
    return tokens


_ABBREVIATIONS = frozenset({
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "inc",
    "corp", "ltd", "dept", "univ", "approx", "fig",
    "e.g", "i.e", "u.s", "u.k",
})

#: per-language EXTRA abbreviation sets — kept out of the English default so
#: short English words ("nr", "tel") never suppress English boundaries
#: selected by split_sentences(language=...)
_ABBREVIATIONS_LANG = {
    "es": frozenset({"sra", "srta", "dra", "avda", "núm", "pág", "tel",
                     "ud", "uds"}),
    "nl": frozenset({"dhr", "mevr", "drs", "ir", "nr", "bv", "n.v", "b.v",
                     "o.a"}),
}

_SENTENCE_END_RE = re.compile(r"([.!?]+)(\s+|$)")


def split_sentences(text: Optional[str], language: str = "en") -> List[str]:
    """Abbreviation-aware sentence splitter (OpenNLPSentenceSplitter role —
    the reference likewise ships per-language sentence models,
    OpenNLPModels.scala:48-70).

    Splits on ./!/? followed by whitespace, except after known abbreviations
    (the English base set plus ``language``'s extras) and single initials
    ("J. Doe" — but not the pronoun "I").
    """
    abbrevs = _ABBREVIATIONS | _ABBREVIATIONS_LANG.get(language, frozenset())
    if not text:
        return []
    sentences: List[str] = []
    start = 0
    for m in _SENTENCE_END_RE.finditer(text):
        end = m.end(1)
        prev_word = text[start:m.start(1)].rsplit(None, 1)
        last = prev_word[-1] if prev_word else ""
        low = last.lower().rstrip(".")
        if m.group(1) == ".":
            is_initial = len(last) == 1 and last.isupper() and last != "I"
            if low in abbrevs or is_initial:
                continue  # abbreviation or initial, not a boundary
        chunk = text[start:end].strip()
        if chunk:
            sentences.append(chunk)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences
