"""The maps table: a CRM object whose custom fields arrive as typed maps,
made from a seed with numpy, its scoring table, and its pipeline written
once for either package.

Used by ``tests/test_torch_maps.py``, ``tests/test_torch_rff.py``,
``tools/make_torch_maps_fixture.py`` and ``chip_smoke.py`` (so it imports
neither jax nor either package).  Every map's keys are present with a Zipf
spread (key j in a row with probability 0.95 / (j + 1)^0.8), so rare and
common keys both reach every map stage.  The columns:

- ``amounts`` (RealMap, 9 keys; ``Deal_Size__c`` and ``DealSize__c`` clean
  to one key) and ``fees`` (CurrencyMap, 6 keys, one of them ``Refund__c``
  present exactly on positive rows: its nulls track the label);
- ``counts`` (IntegralMap, 6 keys) and ``flags`` (BinaryMap, 6 keys);
- ``picks`` (PickListMap, 8 keys of 4-12 Zipf levels, ``Legacy__c`` always
  empty: its fill is 0) and ``tags`` (MultiPickListMap, 6 keys, 0-3 of 8
  levels each);
- ``notes`` (TextMap, 8 keys: 5 of 3-8 levels, SmartText's categorical
  branch, and 3 of free text, its hashed branch) and ``memo`` (TextAreaMap,
  2 keys of free text, empty in the scoring table: the whole map goes);
- ``dates`` (DateMap, 6 keys) and ``places`` (GeolocationMap, 6 keys);
- ``p0``, ``p1`` (PickList, 20 Zipf levels: the encode kernel's one-hot
  slots), ``amount`` (Real, auto-bucketized against the label: a bucketize
  slot), ``r0``..``r3`` (Real) and ``legacy_score`` (Real, shifted in the
  scoring table but protected);
- ``label`` (RealNN, 0/1).

The scoring table (:func:`make_scoring`) differs from training in four
ways: ``amounts[Shifted__c]`` moves far past the training range (its JS
divergence is ~1), ``memo``'s keys are always empty, ``fees[Refund__c]``'s
nulls track the training label, and ``legacy_score`` is shifted but
protected (:data:`PROTECTED`), so it stays.
"""

from __future__ import annotations

import numpy as np

from torch_families_data import (  # noqa: F401  (re-exported for the users)
    fitted_states as _fitted_states,
    plain,
    vector_digest,
)

_START_MS = 1420070400000   # 2015-01-01T00:00:00Z
_END_MS = 1767225600000     # 2026-01-01T00:00:00Z

#: the raw features the filter must keep whatever it measures
PROTECTED = ("legacy_score",)

_AMOUNT_KEYS = ("Annual_Revenue__c", "Deal_Size__c", "DealSize__c", "Budget__c",
                "Forecast__c", "Margin__c", "Shifted__c", "Risk__c", "Spend__c")
_FEE_KEYS = ("Setup__c", "Monthly__c", "Refund__c", "Support__c", "Travel__c", "Other__c")
_COUNT_KEYS = ("Seats__c", "Calls__c", "Emails__c", "Meetings__c", "Tickets__c", "Logins__c")
_FLAG_KEYS = ("Is_Partner__c", "Has_Contract__c", "Churned__c", "Upsell__c",
              "Verified__c", "Opt_Out__c")
_PICK_KEYS = (("Stage__c", 8), ("Industry__c", 12), ("Region__c", 6), ("Source__c", 8),
              ("Tier__c", 4), ("Rating__c", 5), ("Legacy__c", 4), ("Segment__c", 6))
_TAG_KEYS = ("Products__c", "Channels__c", "Interests__c", "Competitors__c",
             "Languages__c", "Features__c")
_NOTE_CATEGORICAL = (("Priority__c", 3), ("Status__c", 6), ("Owner_Team__c", 8),
                     ("Next_Step__c", 8), ("Forecast_Cat__c", 5))
_NOTE_FREE = ("Description__c", "Comments__c", "Summary__c")
_MEMO_KEYS = ("Background__c", "History__c")
_DATE_KEYS = ("Created__c", "Close__c", "Last_Activity__c", "Renewal__c", "Signed__c",
              "Kickoff__c")
_PLACE_KEYS = ("Billing__c", "Shipping__c", "HQ__c", "Branch__c", "Warehouse__c", "Site__c")
_WORDS = ("renewal pricing discount contract legal review budget approval "
          "timeline competitor champion blocker integration migration pilot "
          "security compliance onboarding training support escalation demo "
          "proposal quote procurement signature expansion seats license usage "
          "feedback roadmap feature request bug outage latency invoice payment "
          "refund credit upgrade downgrade cancel churn risk health score "
          "meeting call email followup intro kickoff workshop sponsor").split()


def _zipf(n: int) -> np.ndarray:
    ranks = np.arange(1, n + 1)
    return (1.0 / ranks) / (1.0 / ranks).sum()


def _presence(rng, n: int, k: int) -> np.ndarray:
    """(n, k) bool: key j present with probability 0.95 / (j + 1)^0.8."""
    p = 0.95 / np.arange(1, k + 1) ** 0.8
    return rng.random((n, k)) < p


def _phrases(rng, n: int, lo: int, hi: int) -> list:
    lens = rng.integers(lo, hi + 1, size=n)
    idx = rng.choice(len(_WORDS), size=int(lens.sum()), p=_zipf(len(_WORDS)))
    return [" ".join(_WORDS[j] for j in part)
            for part in np.split(idx, np.cumsum(lens)[:-1])]


def _table(n: int, seed: int, scoring: bool):
    rng = np.random.default_rng(seed)
    cols: dict = {}
    schema: list = []

    def add(name, ftype, values, **extra):
        cols[name] = values
        schema.append({"name": name, "type": ftype, **extra})

    def numeric_map(keys, draw):
        present = _presence(rng, n, len(keys))
        vals = [draw(j, k) for j, k in enumerate(keys)]
        return [{k: v[i] for j, (k, v) in enumerate(zip(keys, vals)) if present[i, j]}
                for i in range(n)], present

    # the label first: the maps' effects are drawn from it
    z = rng.normal(size=n)
    label = (rng.random(n) < 1.0 / (1.0 + np.exp(-1.5 * z))).astype(float)

    def real(j, k):
        if k == "Shifted__c" and scoring:
            return (rng.normal(size=n) + 1e7).tolist()
        base = rng.lognormal(mean=8 + j * 0.3, sigma=1.0, size=n)
        if j == 0:
            base = base * np.exp(0.6 * z)
        return np.round(base, 2).tolist()

    amounts, _ = numeric_map(_AMOUNT_KEYS, real)
    add("amounts", "RealMap", amounts)

    fee_present = _presence(rng, n, len(_FEE_KEYS))
    fee_vals = np.round(rng.gamma(2.0, 50.0, size=(n, len(_FEE_KEYS))), 2)
    refund = _FEE_KEYS.index("Refund__c")
    fee_present[:, refund] = label > 0.5
    add("fees", "CurrencyMap", [
        {k: float(fee_vals[i, j]) for j, k in enumerate(_FEE_KEYS) if fee_present[i, j]}
        for i in range(n)])

    counts, _ = numeric_map(_COUNT_KEYS, lambda j, k: rng.poisson(3 + 2 * j, size=n).tolist())
    add("counts", "IntegralMap", counts)
    flags, _ = numeric_map(_FLAG_KEYS, lambda j, k: (
        rng.random(n) < (0.3 + 0.4 * (z > 0) if j == 0 else 0.2 + 0.1 * j)).tolist())
    add("flags", "BinaryMap", [{k: bool(v) for k, v in m.items()} for m in flags])

    present = _presence(rng, n, len(_PICK_KEYS))
    picks = [dict() for _ in range(n)]
    for j, (k, levels) in enumerate(_PICK_KEYS):
        if k == "Legacy__c":
            vals = [""] * n
        else:
            draw = rng.choice(levels, size=n, p=_zipf(levels))
            if j == 0:  # the stage tracks the label
                draw = np.where(z > 0.5, 0, draw)
            vals = [f"{k[:-3].lower()} {v}" for v in draw]
        for i in np.nonzero(present[:, j])[0]:
            picks[i][k] = vals[i]
    add("picks", "PickListMap", picks)

    present = _presence(rng, n, len(_TAG_KEYS))
    tag_n = rng.integers(0, 4, size=(n, len(_TAG_KEYS)))
    tags = [dict() for _ in range(n)]
    for j, k in enumerate(_TAG_KEYS):
        order = np.argsort(-(np.log(_zipf(8)) + rng.gumbel(size=(n, 8))), axis=1)
        for i in np.nonzero(present[:, j])[0]:
            tags[i][k] = {f"{k[:3].lower()}{c}" for c in order[i, :tag_n[i, j]]}
    add("tags", "MultiPickListMap", tags)

    present = _presence(rng, n, len(_NOTE_CATEGORICAL) + len(_NOTE_FREE))
    notes = [dict() for _ in range(n)]
    for j, (k, levels) in enumerate(_NOTE_CATEGORICAL):
        draw = rng.choice(levels, size=n, p=_zipf(levels))
        for i in np.nonzero(present[:, j])[0]:
            notes[i][k] = f"{k[:4]} level {draw[i]}"
    for j, k in enumerate(_NOTE_FREE, start=len(_NOTE_CATEGORICAL)):
        phrases = _phrases(rng, n, 3, 12)
        for i in np.nonzero(present[:, j])[0]:
            notes[i][k] = phrases[i]
    add("notes", "TextMap", notes)

    present = _presence(rng, n, len(_MEMO_KEYS))
    memo = [dict() for _ in range(n)]
    for j, k in enumerate(_MEMO_KEYS):
        phrases = _phrases(rng, n, 4, 10)
        for i in np.nonzero(present[:, j])[0]:
            memo[i][k] = "" if scoring else phrases[i]
    add("memo", "TextAreaMap", memo)

    dates, _ = numeric_map(_DATE_KEYS, lambda j, k: rng.integers(
        _START_MS, _END_MS, size=n).tolist())
    add("dates", "DateMap", dates)

    present = _presence(rng, n, len(_PLACE_KEYS))
    lat = rng.uniform(-60.0, 70.0, size=(n, len(_PLACE_KEYS)))
    lon = rng.uniform(-180.0, 180.0, size=(n, len(_PLACE_KEYS)))
    acc = rng.integers(1, 10, size=(n, len(_PLACE_KEYS)))
    add("places", "GeolocationMap", [
        {k: [float(lat[i, j]), float(lon[i, j]), float(acc[i, j])]
         for j, k in enumerate(_PLACE_KEYS) if present[i, j]} for i in range(n)])

    for j in range(2):
        levels = [f"p{j}v{k:02d}" for k in range(20)]
        idx = rng.choice(20, size=n, p=_zipf(20))
        if j == 0:  # the low levels track the label
            idx = np.where((z > 1.0) & (rng.random(n) < 0.5), idx % 3, idx)
        gone = rng.random(n) < 0.05
        add(f"p{j}", "PickList", [None if g else levels[i] for i, g in zip(idx, gone)])
    amount = np.round(rng.lognormal(6.0, 1.0, size=n) * np.exp(0.5 * z), 2)
    gone = rng.random(n) < 0.05
    add("amount", "Real", [None if g else float(v) for v, g in zip(amount, gone)])
    real = rng.normal(size=(n, 4))
    real[:, 0] += 0.5 * z
    for j in range(4):
        gone = rng.random(n) < 0.10
        add(f"r{j}", "Real", [None if g else float(x) for x, g in zip(real[:, j], gone)])
    legacy = rng.normal(size=n) + (40.0 if scoring else 0.0)
    add("legacy_score", "Real", legacy.tolist())
    if scoring:
        return cols, schema
    add("label", "RealNN", label.tolist(), response=True)
    return cols, schema


def make_maps(n: int, seed: int = 0):
    """(columns, schema) of the training table: python lists (an empty dict
    for a row without a map, a missing key left out) and one entry per
    column naming its type, all drawn from ``default_rng(seed)``."""
    return _table(n, seed, scoring=False)


def make_scoring(n: int, seed: int = 1):
    """(columns, schema) of the scoring table (no label): the training
    table's draws from ``default_rng(seed)`` with its four differences."""
    return _table(n, seed, scoring=True)


def maps_pipeline(pkg, ftypes, schema, num_folds: int = 3):
    """(label, selector, checker, prediction) of the maps pipeline in
    ``pkg``, a namespace with the package's ``FeatureBuilder``,
    ``transmogrify``, ``SanityChecker``, ``BinaryClassificationModelSelector``
    and ``LogisticRegression``: transmogrify's defaults over every predictor
    (``amount`` also through ``auto_bucketize(label)``),
    ``SanityChecker(correlation_exclusion="hashed_text")`` and a
    ``num_folds``-fold CV LogisticRegression selector over reg_param 0.01
    and 0.1."""
    label = pkg.FeatureBuilder.of("label", ftypes["label"]).extract_field().as_response()
    preds = [pkg.FeatureBuilder.of(s["name"], ftypes[s["name"]]).extract_field().as_predictor()
             for s in schema if not s.get("response")]
    amount = next(f for f in preds if f.name == "amount")
    vec = pkg.transmogrify(preds + [amount.auto_bucketize(label)])
    checker = pkg.SanityChecker(correlation_exclusion="hashed_text")
    checked = label.transform_with(checker, vec)
    sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds,
        models=[(pkg.LogisticRegression(),
                 [{"reg_param": 0.01}, {"reg_param": 0.1}])])
    pred = label.transform_with(sel, checked)
    return label, sel, checker, pred


def maps_filter(pkg, scoring_ds):
    """The pipeline's raw feature filter in ``pkg`` (a namespace with the
    package's ``RawFeatureFilter``): the reference's defaults, the scoring
    table, :data:`PROTECTED`."""
    return pkg.RawFeatureFilter(scoring_dataset=scoring_ds, protected_features=PROTECTED)


def make_records(cols, rows) -> list:
    """Request records of the table's ``rows`` (label left out): a
    MultiPickListMap's sets become sorted lists, as a JSON request carries
    them; every third record drops its ``tags`` map, every fifth empties
    its ``notes``, and every seventh loses its ``amounts`` keys but one."""
    names = [k for k in cols if k != "label"]
    out = []
    for i in rows:
        r = {}
        for k in names:
            v = cols[k][i]
            if k == "tags":
                v = {key: sorted(s) for key, s in v.items()}
            r[k] = v
        if i % 3 == 0:
            del r["tags"]
        if i % 5 == 0:
            r["notes"] = {}
        if i % 7 == 0 and r["amounts"]:
            first = sorted(r["amounts"])[0]
            r["amounts"] = {first: r["amounts"][first]}
        out.append(r)
    return out


#: fitted attribute(s) recorded for each stage class of the pipeline
STATE_ATTRS = {
    "NumericMapVectorizerModel": ("keys", "fills"),
    "TextMapPivotVectorizerModel": ("vocabs",),
    "SmartTextMapVectorizerModel": ("key_plans",),
    "DateMapToUnitCircleVectorizerModel": ("key_sets", "time_periods"),
    "GeolocationMapVectorizerModel": ("keys", "fills"),
    "OneHotVectorizerModel": ("vocabs",),
    "NumericVectorizerModel": ("fills",),
    "DecisionTreeNumericBucketizerModel": ("splits",),
    "SanityCheckerModel": ("kept_indices",),
}


def fitted_states(model) -> dict:
    """{class: {"input,names": {attr: value}}} of the model's fitted stages
    (``torch_families_data.fitted_states`` over :data:`STATE_ATTRS`), maps'
    dict values made JSON-able."""
    return _fitted_states(model, STATE_ATTRS)
