"""The text table (``text_wide``): review-like documents with the columns
the reference's text stack reads, made from a seed with numpy, and the text
pipeline written once for either package.

Used by ``tests/test_torch_text.py``, ``tests/test_torch_embeddings.py``,
``tools/make_torch_text_fixture.py`` and ``chip_smoke.py`` (so it imports
neither jax nor either package).  The columns:

- ``label`` (RealNN): 1 for a positive review, from its sentiment words;
- ``review`` (Text): 8-40 tokens, Zipf over :data:`VOCAB_SIZE` word types
  plus ``examples/text_reviews.py``'s fill and sentiment words (1-3 of the
  label's lexicon, one of the other's in 10 % of rows) and a few English
  stop words;
- ``title`` (Text): 2-6 tokens, half of them from the row's review;
- ``category`` (PickList): 8 levels (the encode kernel's one-hot slots);
- ``stars`` (Real): 1-5, 5 % null;
- ``created`` (Date): 2015-2025;
- ``email`` (Email), ``url`` (URL), ``phone`` (Phone): ~90 % well formed,
  the rest malformed, 3 % null.

:func:`text_pipeline` builds the stages of the text stack over them:
tokenizer (auto language) -> stop words -> bigrams -> CountVectorizer, the
HashingTF, Word2Vec and LDA of the cleaned tokens, the category's pivot, the
title's n-gram
similarity to the review, the review's length and languages, the creation
day of the week, the e-mail's validity and domain, the URL's domain and the
phone's validity -> transmogrify -> SanityChecker -> a CV LogisticRegression
selector.  ``wide=True`` gives the stages their default widths (Word2Vec 64
dimensions over 10 000 words, LDA 10 topics over 10 000 words, 20 x 5
iterations); ``wide=False`` the fixture's small ones.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import re
import types

import numpy as np

#: word types of the Zipf vocabulary
VOCAB_SIZE = 20_000
_START_MS = 1420070400000   # 2015-01-01T00:00:00Z
_END_MS = 1767225600000     # 2026-01-01T00:00:00Z

# examples/text_reviews.py's lexicons
POS = ("great", "excellent", "loved", "wonderful", "perfect", "amazing",
       "fantastic", "happy", "best", "recommend")
NEG = ("terrible", "awful", "hated", "broken", "poor", "worst",
       "refund", "disappointed", "useless", "never")
FILL = ("the", "product", "arrived", "yesterday", "and", "it", "was",
        "overall", "quite", "really", "shipping", "box", "works")
_STOP = ("the", "a", "and", "of", "to", "is", "it", "this", "with", "for")
_CATEGORIES = ("home", "garden", "tech", "books", "toys", "sports", "beauty",
               "grocery")
_DOMAINS = ("example.com", "mail.org", "inbox.net", "corp.io", "post.de",
            "shop.co.uk")
_ONSETS = ("b", "c", "d", "f", "g", "k", "l", "m", "n", "p", "r", "s", "t",
           "v", "z", "br", "st", "tr", "pl", "gr")
_VOWELS = ("a", "e", "i", "o", "u", "ai", "ou")


def vocabulary(size: int = VOCAB_SIZE) -> list:
    """``size`` distinct pseudo-words of 2-3 syllables, in a fixed order."""
    sylls = [o + v for o, v in itertools.product(_ONSETS, _VOWELS)]
    words = []
    seen = set(POS) | set(NEG) | set(FILL) | set(_STOP)
    for n in (2, 3):
        for combo in itertools.product(sylls, repeat=n):
            w = "".join(combo)
            if w not in seen:
                seen.add(w)
                words.append(w)
                if len(words) == size:
                    return words
    return words


def _zipf(n: int) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1)
    return p / p.sum()


def make_text(n: int, seed: int = 0):
    """(columns, schema) of ``n`` rows: {name: list of values} and
    [{"name", "type", "response"?}] in the pipeline's column order."""
    rng = np.random.default_rng(seed)
    vocab = np.asarray(vocabulary(), dtype=object)
    zipf = _zipf(len(vocab))
    label = (rng.random(n) > 0.5).astype(np.float64)
    lens = rng.integers(8, 41, n)
    n_sent = rng.integers(1, 4, n)
    n_stop = rng.integers(0, 4, n)
    n_fill = rng.integers(0, 4, n)
    mixed = rng.random(n) < 0.1
    n_zipf = np.maximum(lens - n_sent - n_stop - n_fill - mixed, 1)
    # each row: its Zipf words, then the extras, all in a random order
    lex = np.where(label[:, None] > 0, np.asarray(POS, object)[None, :],
                   np.asarray(NEG, object)[None, :])
    other = np.where(label > 0, np.asarray(NEG, object)[rng.integers(0, 10, n)],
                     np.asarray(POS, object)[rng.integers(0, 10, n)])
    sent = np.take_along_axis(lex, rng.integers(0, 10, (n, 3)), axis=1)
    stop = np.asarray(_STOP, object)[rng.integers(0, len(_STOP), (n, 3))]
    fill = np.asarray(FILL, object)[rng.integers(0, len(FILL), (n, 3))]
    words = vocab[rng.choice(len(vocab), int(n_zipf.sum()), p=zipf)]
    base = np.split(words, np.cumsum(n_zipf)[:-1])
    rows = []
    for i in range(n):
        row = list(base[i]) + list(sent[i, :n_sent[i]]) + list(stop[i, :n_stop[i]]) \
            + list(fill[i, :n_fill[i]]) + ([other[i]] if mixed[i] else [])
        rows.append(row)
    sizes = np.asarray([len(r) for r in rows])
    order = np.lexsort((rng.random(int(sizes.sum())), np.repeat(np.arange(n), sizes)))
    flat = np.asarray([w for r in rows for w in r], dtype=object)[order]
    toks = np.split(flat, np.cumsum(sizes)[:-1])
    review = [" ".join(t) for t in toks]
    t_len = rng.integers(2, 7, n)
    n_own = t_len // 2 + 1
    own_pos = (rng.random((n, 4)) * sizes[:, None]).astype(np.int64)
    n_other = t_len - n_own + 1
    other_words = np.split(vocab[rng.choice(len(vocab), int(n_other.sum()), p=zipf)],
                           np.cumsum(n_other)[:-1])
    title = [" ".join(list(toks[i][own_pos[i, :n_own[i]]]) + list(other_words[i])).title()
             for i in range(n)]
    category = [str(c) for c in rng.choice(_CATEGORIES, n, p=_zipf(len(_CATEGORIES)))]
    stars = rng.integers(1, 6, n).astype(np.float64)
    stars_null = rng.random(n) < 0.05
    created = rng.integers(_START_MS, _END_MS, n)
    user = vocab[rng.integers(0, 2000, n)]
    dom = rng.choice(_DOMAINS, n)
    num = rng.integers(0, 1000, n)
    kind = rng.random((n, 3))
    nulls = rng.random((n, 3)) < 0.03
    area = rng.integers(200, 1000, n)
    exch = rng.integers(200, 1000, n)
    line = rng.integers(0, 10000, n)
    email, url, phone = [], [], []
    for i in range(n):
        if nulls[i, 0]:
            email.append(None)
        elif kind[i, 0] < 0.9:
            email.append(f"{user[i]}{num[i]}@{dom[i]}")
        else:
            email.append(f"{user[i]} at {dom[i]}")
        if nulls[i, 1]:
            url.append(None)
        elif kind[i, 1] < 0.9:
            scheme = "https" if num[i] % 3 else "http"
            url.append(f"{scheme}://www.{dom[i]}/{user[i]}/{num[i]}")
        else:
            url.append(f"www {user[i]} {dom[i]}")
        if nulls[i, 2]:
            phone.append(None)
        elif kind[i, 2] < 0.9:
            phone.append(f"({area[i]}) {exch[i]}-{line[i]:04d}")
        else:
            phone.append(f"{exch[i]}-{line[i] % 100}")
    cols = {
        "label": [float(v) for v in label],
        "review": review,
        "title": title,
        "category": category,
        "stars": [None if stars_null[i] else float(stars[i]) for i in range(n)],
        "created": [int(v) for v in created],
        "email": email,
        "url": url,
        "phone": phone,
    }
    schema = [{"name": "label", "type": "RealNN", "response": True},
              {"name": "review", "type": "Text"}, {"name": "title", "type": "Text"},
              {"name": "category", "type": "PickList"}, {"name": "stars", "type": "Real"},
              {"name": "created", "type": "Date"}, {"name": "email", "type": "Email"},
              {"name": "url", "type": "URL"}, {"name": "phone", "type": "Phone"}]
    return cols, schema


#: the small widths of the fixture and the CPU tests, and the defaults
SMALL = {"w2v": {"embedding_dim": 16, "max_vocab": 200, "epochs": 1, "batch_size": 256},
         "lda": {"k": 4, "max_vocab": 200, "max_iter": 5, "inner_iter": 5},
         "count": {"vocab_size": 64}, "hash": {"num_features": 64}}
WIDE = {"w2v": {}, "lda": {}, "count": {"vocab_size": 512},
        "hash": {"num_features": 512}}


def text_pipeline(pkg, ftypes, wide: bool = False, num_folds: int = 3):
    """(label, selector, checker, prediction, handles) of the text pipeline
    in ``pkg``, a namespace with the package's ``FeatureBuilder``,
    ``transmogrify``, ``SanityChecker``, ``BinaryClassificationModelSelector``,
    ``LogisticRegression`` and its ``ops.text`` / ``ops.embeddings`` modules
    (``text``, ``embeddings``).  ``handles`` names the intermediate features
    (tokens, clean, bigrams, counts, hashed, w2v, lda, ...)."""
    widths = WIDE if wide else SMALL
    fb = {name: pkg.FeatureBuilder.of(name, ftypes[name]).extract_field()
          for name in ftypes}
    label = fb["label"].as_response()
    f = {k: v.as_predictor() for k, v in fb.items() if k != "label"}
    txt, emb = pkg.text, pkg.embeddings
    tokens = f["review"].tokenize()
    clean = tokens.transform_with(txt.StopWordsRemover())
    bigrams = clean.transform_with(txt.NGramTransformer(n=2))
    counts = bigrams.transform_with(txt.CountVectorizer(**widths["count"]))
    hashed = clean.transform_with(txt.HashingTF(**widths["hash"]))
    w2v = clean.word2vec(**widths["w2v"])
    lda = clean.lda_topics(**widths["lda"])
    sim = f["title"].to_ngram_similarity(f["review"])
    length = f["review"].transform_with(txt.TextLenTransformer())
    langs = f["review"].detect_languages()
    dow = f["created"].to_time_period("DayOfWeek")
    valid_email = f["email"].is_valid_email()
    email_domain = f["email"].to_email_domain()
    url_domain = f["url"].to_domain()
    valid_phone = f["phone"].is_valid_phone()
    # the raw category pivots on its own, so the serving plan encodes it on
    # the device (a one-hot stage that also read url_domain, a host stage's
    # output, would stay on the host)
    category = f["category"].pivot(min_support=1)
    vec = pkg.transmogrify([category, f["stars"], f["created"], sim, length,
                            langs, dow, valid_email, email_domain, url_domain,
                            valid_phone, counts, hashed, w2v, lda])
    checker = pkg.SanityChecker(correlation_exclusion="hashed_text")
    checked = label.transform_with(checker, vec)
    sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds,
        models=[(pkg.LogisticRegression(), [{"reg_param": 0.01}, {"reg_param": 0.1}])])
    pred = label.transform_with(sel, checked)
    handles = {"tokens": tokens, "clean": clean, "bigrams": bigrams, "counts": counts,
               "hashed": hashed, "w2v": w2v, "lda": lda, "sim": sim, "length": length,
               "langs": langs, "dow": dow, "valid_email": valid_email,
               "email_domain": email_domain, "url_domain": url_domain,
               "valid_phone": valid_phone, "category": category, "vector": vec}
    return label, sel, checker, pred, handles


def make_records(cols, rows) -> list:
    """Request records (the raw columns, label left out) of ``rows``."""
    names = [k for k in cols if k != "label"]
    return [{k: cols[k][i] for k in names} for i in rows]


#: fitted attribute(s) recorded for each stage class of the pipelines
STATE_ATTRS = {
    "SmartTextVectorizerModel": ("is_categorical", "vocabs", "languages"),
    "OneHotVectorizerModel": ("vocabs",),
    "NumericVectorizerModel": ("fills",),
    "CountVectorizerModel": ("vocab", "binary"),
    "Word2VecModel": ("vocab",),
    "LDAModel": ("vocab", "k", "inner_iter"),
    "TextMapPivotVectorizerModel": ("vocabs",),
    "NumericMapVectorizerModel": ("keys", "fills"),
    "SanityCheckerModel": ("kept_indices",),
}


def fitted_states(model) -> dict:
    """``torch_families_data.fitted_states`` over :data:`STATE_ATTRS`, the
    stage uids in derived features' names written ``_<uid>`` (each package
    counts its own)."""
    from torch_families_data import fitted_states as _states

    return json.loads(re.sub(r"_[0-9a-f]{12}(?![0-9A-Za-z])", "_<uid>",
                             json.dumps(_states(model, STATE_ATTRS))))


def token_digest(col) -> str:
    """sha256 of a token-list column (rows joined by newlines, tokens by
    tabs; a missing row is empty)."""
    text = "\n".join("\t".join(v or ()) for v in col)
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def block_digest(arr: np.ndarray) -> str:
    """sha256 of a block's float32 bytes."""
    return hashlib.sha256(
        np.ascontiguousarray(arr, dtype=np.float32).tobytes()).hexdigest()


def load_example(repo: str, name: str, package: str):
    """``examples/<name>.py`` as a module, ``transmogrifai_tpu`` swapped for
    ``package`` in memory (the file is not touched)."""
    path = os.path.join(repo, "examples", f"{name}.py")
    with open(path) as fh:
        src = fh.read().replace("transmogrifai_tpu", package)
    mod = types.ModuleType(f"example_{name}_{package}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def run_text_reviews(repo: str, pkg, transform_dag, *device) -> dict:
    """``examples/text_reviews.py`` run on ``pkg`` (either package), its
    two ``Workflow.train`` calls caught: the evaluate metrics, the main and
    side models, the fitted states, the CV rows, the checker's input
    vector (``transform_dag(dataset, [vector], fitted, *device)``) and the
    side workflow's language and NER maps of every row."""
    from torch_families_data import vector_digest

    mod = load_example(repo, "text_reviews", pkg.__name__)
    trained = []
    train = pkg.Workflow.train

    def catching(self, *a, **kw):
        m = train(self, *a, **kw)
        trained.append(m)
        return m

    pkg.Workflow.train = catching
    try:
        metrics = mod.main()
    finally:
        pkg.Workflow.train = train
    model, side = trained
    ft = pkg.types.feature_type_by_name
    ds = pkg.Dataset.from_features(
        mod.reviews_dataframe(), {"review": ft("Text"), "category": ft("PickList"),
                                  "stars": ft("Real"), "label": ft("RealNN")})
    vec = next(s for s in model.fitted.values()
               if type(s).__name__ == "SanityCheckerModel").inputs[1]
    vector = transform_dag(ds, [vec], model.fitted, *device)[vec.name].data
    summary = next(st.summary for st in model.fitted.values()
                   if hasattr(getattr(st, "summary", None), "validation_results"))
    scored = side.score(ds)
    langs, ner = (scored[f.name].to_values() for f in side.result_features)
    return {"metrics": dict(metrics), "model": model, "side": side, "vector_block": vector,
            "states": fitted_states(model),
            "cv": [{"grid": e.grid, "values": [float(v) for v in e.metric_values]}
                   for e in summary.validation_results],
            "vector": vector_digest(vector),
            "languages": [dict(sorted(m.items())) for m in langs],
            "ner": [dict(sorted(m.items())) if m else {} for m in ner]}
