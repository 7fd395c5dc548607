"""The families table: raw typed columns of every transmogrify family the
port vectorizes, made from a seed with numpy, and its pipeline written once
for either package.

Used by ``tests/test_torch_families.py``, ``tools/make_torch_families_fixture.py``
and ``chip_smoke.py`` (so it imports neither jax nor either package), with
the helpers that record a trained model's fitted states and a vector's
digest the same way in every one of them.  The columns:

- ``label`` (RealNN): a logistic draw from the review's sentiment words, two
  Real columns, a pick list and the tags;
- ``review`` (Text): 8-30 tokens, Zipf over ~2000 English words, 5 % null,
  ~10 % of rows with an accented or CJK word (the fused tokenizer hands
  those rows to the exact Unicode one);
- ``review_de`` (Text): German, 6-20 tokens (SmartText's analyzer path,
  with stemming);
- ``channel`` (Text): 12 levels (SmartText's categorical branch);
- ``email`` (Email): first.last<n>@domain;
- ``p0``, ``p1`` (PickList): 30 Zipf levels each (the encode kernel's slots);
- ``tags`` (MultiPickList): 40 levels, 0-5 per row;
- ``opened`` (Date) and ``last_seen`` (DateTime): 2015-2025, 5 % null;
- ``visits`` (DateList): 0-10 events, pivoted against :data:`REFERENCE_DATE_MS`;
- ``keywords`` (TextList): 0-8 tokens;
- ``home`` (Geolocation): 5 % null;
- ``r0``..``r7`` (Real, 10 % null), ``i0``, ``i1`` (Integral), ``b0`` (Binary).
"""

from __future__ import annotations

import hashlib

import numpy as np

#: the date lists' "now": 2026-01-01T00:00:00Z, handed to both packages
REFERENCE_DATE_MS = 1767225600000
_START_MS = 1420070400000   # 2015-01-01T00:00:00Z
_END_MS = 1767225600000     # 2026-01-01T00:00:00Z

_FUNCTION = ("the and was is it to of a in for with on that this but my they "
             "we very not at as be have had are so just from all an or our "
             "were there too when would if their one out about").split()
_SENTIMENT_POS = ("great", "excellent", "love", "perfect", "friendly")
_SENTIMENT_NEG = ("bad", "poor", "slow", "broken", "rude")
_BASES = (
    "order delivery price quality service product staff store food room "
    "table menu drink coffee seat screen phone battery camera sound color "
    "size shape design box package pilot window door floor bed shower "
    "light music game book story movie song class course teacher lesson "
    "ticket flight hotel train station road street city park garden beach "
    "water wine beer bread cheese salad soup pasta pizza burger chicken "
    "fish steak dessert cake sauce kitchen chef waiter manager owner "
    "customer friend family child parent team company shop market mall "
    "account card bank payment refund return exchange receipt label code "
    "update version feature button page link site app account email "
    "message call chat support help topic problem question answer review "
    "rating star point value deal offer discount coupon bonus gift sale "
    "week month year morning evening night weekend holiday season summer "
    "winter spring autumn rain snow wind cloud sun heat cold air smell "
    "taste view noise space time minute hour day trip visit stay walk "
    "drive ride move start finish open close clean wash cook bake serve "
    "wait ask answer check test try use fix build paint print write read "
    "play watch listen talk speak work plan pack ship deliver charge pay "
    "cost save spend buy sell rent book reserve cancel change pick choose "
    "fresh warm cool hot soft hard quick quiet loud bright dark clear "
    "smooth rough light heavy large small short long wide narrow deep "
    "high low fast early late easy simple nice fine real fair kind calm").split()
_SUFFIXES = ("", "s", "ed", "ing", "er", "ly", "ness", "ful")
_FOREIGN = ("café", "naïve", "crème", "résumé", "jalapeño", "über", "façade",
            "東京", "日本語", "美味しい", "服务", "很好", "咖啡店", "ありがとう")
_GERMAN = (
    "der die das und ist nicht ein eine zu mit auf für von dem den des sich "
    "es auch als wie bei noch nach sehr aber war waren wird wurde haben hat "
    "kellner essen preise hoch gut schlecht freundlich schnell langsam "
    "bestellung lieferung zimmer hotel frühstück getränke bedienung "
    "mitarbeiter kunden kinder häuser straßen städte gärten tische stühle "
    "gespielt spielen spielte gekauft kaufen kaufte bestellt bestellen "
    "geliefert liefern lieferte empfohlen empfehlen wunderbar schöne "
    "schönen schöner günstig günstigen teuer teuren sauber sauberen "
    "leider wieder immer manchmal morgens abends wochenende urlaub reise "
    "zufrieden unzufrieden enttäuscht begeistert").split()
_CHANNELS = ("web", "mobile app", "phone", "email", "store", "partner",
             "affiliate", "social", "search", "referral", "direct mail", "kiosk")
_FIRST = ("anna ben carla david emma felix grace henry iris jack kate liam "
          "maria noah olga paul quinn rosa sam tina uma victor wendy xavier "
          "yara zoe").split()
_LAST = ("smith jones brown taylor wilson davies evans thomas johnson "
         "roberts walker wright thompson white hughes edwards green hall "
         "wood harris").split()
_DOMAINS = ("example.com", "mail.org", "inbox.net", "corp.io", "post.de")
_KEYWORDS = tuple(f"kw{k:03d}" for k in range(300))


def _english_vocab():
    # the sentiment words sit among the most frequent ranks, so most reviews
    # carry a few of them
    words = list(_FUNCTION[:8])
    for p, q in zip(_SENTIMENT_POS, _SENTIMENT_NEG):
        words += [p, q]
    words += list(_FUNCTION[8:])
    seen = set(words)
    for suffix in _SUFFIXES:
        for b in _BASES:
            w = b + suffix
            if w not in seen:
                seen.add(w)
                words.append(w)
    return words


def _zipf(n: int) -> np.ndarray:
    ranks = np.arange(1, n + 1)
    return (1.0 / ranks) / (1.0 / ranks).sum()


def _sentences(rng, n: int, vocab, lo: int, hi: int):
    """(all token indices, row of each token, per-row index lists): ``n``
    rows of lengths in [lo, hi], Zipf over ``vocab``."""
    lens = rng.integers(lo, hi + 1, size=n)
    idx = rng.choice(len(vocab), size=int(lens.sum()), p=_zipf(len(vocab)))
    return idx, np.repeat(np.arange(n), lens), np.split(idx, np.cumsum(lens)[:-1])


def _null(rng, n: int, rate: float) -> np.ndarray:
    return rng.random(n) < rate


def make_families(n: int, seed: int = 0):
    """(columns, schema): python lists (None for a missing scalar or text,
    [] for a missing geolocation) and one entry per column naming its type,
    all drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    cols = {}
    schema = []

    def add(name, ftype, values, **extra):
        cols[name] = values
        schema.append({"name": name, "type": ftype, **extra})

    vocab = _english_vocab()
    pos = np.array([vocab.index(w) for w in _SENTIMENT_POS])
    neg = np.array([vocab.index(w) for w in _SENTIMENT_NEG])
    idx, row_of, docs = _sentences(rng, n, vocab, 8, 30)
    sentiment = np.bincount(row_of, weights=np.isin(idx, pos).astype(np.float64)
                            - np.isin(idx, neg), minlength=n)
    foreign = rng.random(n) < 0.10
    foreign_word = rng.integers(0, len(_FOREIGN), size=n)
    gone = _null(rng, n, 0.05)
    review = []
    for i, d in enumerate(docs):
        if gone[i]:
            review.append(None)
            continue
        words = [vocab[j] for j in d]
        if foreign[i]:
            words.insert(int(rng.integers(0, len(words) + 1)), _FOREIGN[foreign_word[i]])
        review.append(" ".join(words).capitalize() + ".")
    add("review", "Text", review)

    gone = _null(rng, n, 0.05)
    add("review_de", "Text", [None if g else " ".join(_GERMAN[j] for j in d)
                              for d, g in zip(_sentences(rng, n, _GERMAN, 6, 20)[2], gone)])

    ch = rng.choice(len(_CHANNELS), size=n, p=_zipf(len(_CHANNELS)))
    gone = _null(rng, n, 0.05)
    add("channel", "Text", [None if g else _CHANNELS[c] for c, g in zip(ch, gone)])

    first = rng.integers(0, len(_FIRST), size=n)
    last = rng.integers(0, len(_LAST), size=n)
    num = rng.integers(0, 100, size=n)
    dom = rng.integers(0, len(_DOMAINS), size=n)
    gone = _null(rng, n, 0.05)
    add("email", "Email", [
        None if gone[i] else f"{_FIRST[first[i]]}.{_LAST[last[i]]}{num[i]}@{_DOMAINS[dom[i]]}"
        for i in range(n)])

    pick_effect = np.zeros(n)
    for j in range(2):
        levels = [f"p{j}v{k:02d}" for k in range(30)]
        idx = rng.choice(30, size=n, p=_zipf(30))
        gone = _null(rng, n, 0.05)
        add(f"p{j}", "PickList", [None if g else levels[i] for i, g in zip(idx, gone)],
            levels=levels)
        if j == 0:
            pick_effect = np.where(gone, 0.0, np.where(idx % 3 == 0, 0.8, -0.3))

    tag_levels = [f"tag{k:02d}" for k in range(40)]
    k_tags = rng.integers(0, 6, size=n)
    # Zipf draws without replacement, all rows at once: the first k of each
    # row's levels ordered by log p + Gumbel noise
    order = np.argsort(-(np.log(_zipf(40)) + rng.gumbel(size=(n, 40))), axis=1)
    tags = [{tag_levels[c] for c in order[i, :k]} for i, k in enumerate(k_tags)]
    tag_effect = 0.7 * (np.isin(order, (0, 1))
                        & (np.arange(40) < k_tags[:, None])).sum(axis=1)
    add("tags", "MultiPickList", tags, levels=tag_levels)

    for name, ftype, step in (("opened", "Date", 86_400_000), ("last_seen", "DateTime", 1)):
        ms = rng.integers(_START_MS // step, _END_MS // step, size=n) * step
        gone = _null(rng, n, 0.05)
        add(name, ftype, [None if g else int(v) for v, g in zip(ms, gone)])

    k_visits = rng.integers(0, 11, size=n)
    stamps = rng.integers(_START_MS, _END_MS, size=int(k_visits.sum()))
    add("visits", "DateList",
        [[int(v) for v in s] for s in np.split(stamps, np.cumsum(k_visits)[:-1])],
        reference_date_ms=REFERENCE_DATE_MS)

    k_kw = rng.integers(0, 9, size=n)
    kw = rng.choice(len(_KEYWORDS), size=int(k_kw.sum()), p=_zipf(len(_KEYWORDS)))
    add("keywords", "TextList",
        [[_KEYWORDS[j] for j in s] for s in np.split(kw, np.cumsum(k_kw)[:-1])])

    lat = rng.uniform(-60.0, 70.0, size=n)
    lon = rng.uniform(-180.0, 180.0, size=n)
    acc = rng.integers(1, 10, size=n)
    gone = _null(rng, n, 0.05)
    add("home", "Geolocation", [[] if gone[i] else [float(lat[i]), float(lon[i]), float(acc[i])]
                                for i in range(n)])

    real = rng.normal(size=(n, 8))
    for j in range(8):
        gone = _null(rng, n, 0.10)
        add(f"r{j}", "Real", [None if g else float(x) for x, g in zip(real[:, j], gone)])
    for j in range(2):
        v = rng.integers(0, 20, size=n)
        gone = _null(rng, n, 0.10)
        add(f"i{j}", "Integral", [None if g else int(x) for x, g in zip(v, gone)])
    b = rng.random(n) < 0.3
    gone = _null(rng, n, 0.05)
    add("b0", "Binary", [None if g else bool(x) for x, g in zip(b, gone)])

    logit = (0.9 * sentiment + 0.8 * real[:, 0] - 0.6 * real[:, 1]
             + pick_effect + tag_effect)
    logit -= logit.mean()
    label = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(float)
    add("label", "RealNN", label.tolist(), response=True)
    return cols, schema


def families_pipeline(pkg, ftypes, schema, num_folds: int = 3):
    """(label, selector, checker, prediction) of the families pipeline in
    ``pkg``, a namespace with the package's ``FeatureBuilder``,
    ``transmogrify``, ``SanityChecker``, ``BinaryClassificationModelSelector``
    and ``LogisticRegression``: transmogrify's defaults, the date lists
    pivoted against :data:`REFERENCE_DATE_MS`, ``SanityChecker(
    correlation_exclusion="hashed_text")`` and a ``num_folds``-fold CV
    LogisticRegression selector over reg_param 0.01 and 0.1."""
    label = pkg.FeatureBuilder.of("label", ftypes["label"]).extract_field().as_response()
    preds = [pkg.FeatureBuilder.of(s["name"], ftypes[s["name"]]).extract_field().as_predictor()
             for s in schema if not s.get("response")]
    vec = pkg.transmogrify(preds)
    for p in vec.parents:
        if type(p.origin_stage).__name__ == "DateListVectorizer":
            p.origin_stage.reference_date_ms = REFERENCE_DATE_MS
    checker = pkg.SanityChecker(correlation_exclusion="hashed_text")
    checked = label.transform_with(checker, vec)
    sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds,
        models=[(pkg.LogisticRegression(),
                 [{"reg_param": 0.01}, {"reg_param": 0.1}])])
    pred = label.transform_with(sel, checked)
    return label, sel, checker, pred


def make_records(cols, rows) -> list:
    """Request records (dicts of the raw columns, label left out) of the
    table's ``rows``; sets become sorted lists, as a JSON request carries
    them."""
    names = [k for k in cols if k != "label"]
    out = []
    for i in rows:
        r = {}
        for k in names:
            v = cols[k][i]
            r[k] = sorted(v) if isinstance(v, set) else v
        out.append(r)
    return out


#: fitted attribute(s) recorded for each stage class of the pipeline
STATE_ATTRS = {
    "SmartTextVectorizerModel": ("is_categorical", "vocabs", "languages"),
    "MultiPickListVectorizerModel": ("vocabs",),
    "OneHotVectorizerModel": ("vocabs",),
    "GeolocationVectorizerModel": ("fills",),
    "NumericVectorizerModel": ("fills",),
    "DateListVectorizer": ("reference_date_ms", "pivot"),
    "SanityCheckerModel": ("kept_indices",),
}


def plain(v):
    """numpy arrays and scalars -> JSON-able python, recursively."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    return v


def fitted_states(model, state_attrs=None) -> dict:
    """{class: {"input,names": {attr: value}}} of the model's fitted stages
    and of its stage nodes that carry state of their own (the date list's
    reference date), the attributes of ``state_attrs`` (default
    :data:`STATE_ATTRS`).  Keyed by input names: the packages count stage
    uids on their own."""
    state_attrs = STATE_ATTRS if state_attrs is None else state_attrs
    stages = list(model.fitted.values())
    seen = {id(s) for s in stages}
    stack = list(model.result_features)
    while stack:
        f = stack.pop()
        st = f.origin_stage
        if st is not None and id(st) not in seen:
            seen.add(id(st))
            stages.append(st)
        stack.extend(f.parents)
    out: dict = {}
    for st in stages:
        attrs = state_attrs.get(type(st).__name__)
        if attrs is None:
            continue
        key = ",".join(f.name for f in st.inputs)
        if type(st).__name__ == "SanityCheckerModel":
            key = "checker"
        out.setdefault(type(st).__name__, {})[key] = {
            a: plain(getattr(st, a)) for a in attrs}
    return out


def vector_digest(arr: np.ndarray) -> dict:
    """Shape and sha256 of a block's float32 bytes (equal digests: the same
    bits)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    return {"shape": list(arr.shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
