"""Raw columns of the wide serving pipeline, made from a seed with numpy.

A copy of ``make_data`` in ``tools/make_torch_serving_fixture.py``, which
made the committed ``fixtures/serving_wide`` model, so that ``chip_smoke.py``
and the port's tests draw the same columns without loading a file that
names the JAX package (``tests/test_torch_transmogrify.py`` holds the copy
equal to the original on the same seed).  Also the pipeline itself, written
against either package: :func:`train_wide` takes the package's namespace.
"""

from __future__ import annotations

import numpy as np


def make_data(n: int, n_real: int, n_bucketized: int, n_pick: int,
              n_levels: int, n_binary: int, seed: int = 0,
              missing: float = 0.1):
    """Columns (python lists, None for missing) and the schema of the
    fixture's raw features, all drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    cols = {}
    schema = []
    real = rng.normal(size=(n, n_real))
    # each bucketized feature moves the label by a step function with three
    # thresholds, so its tree finds several real splits
    thresholds = np.sort(rng.uniform(-1.2, 1.2, size=(n_bucketized, 3)),
                         axis=1)
    steps = np.array([-1.5, 1.0, -1.0, 1.5])
    logit = np.zeros(n)
    for j in range(n_bucketized):
        logit += steps[np.searchsorted(thresholds[j], real[:, j])]
    logit -= logit.mean()
    label = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(float)
    for j in range(n_real):
        v = real[:, j].copy()
        gone = rng.random(n) < missing
        cols[f"r{j}"] = [None if g else float(x) for x, g in zip(v, gone)]
        schema.append({"name": f"r{j}", "type": "Real", "missing": missing,
                       "bucketized": j < n_bucketized})
    ranks = np.arange(1, n_levels + 1)
    zipf = (1.0 / ranks) / (1.0 / ranks).sum()
    for j in range(n_pick):
        levels = [f"p{j}v{k:02d}" for k in range(n_levels)]
        idx = rng.choice(n_levels, size=n, p=zipf)
        gone = rng.random(n) < missing / 2
        cols[f"p{j}"] = [None if g else levels[i] for i, g in zip(idx, gone)]
        schema.append({"name": f"p{j}", "type": "PickList",
                       "missing": missing / 2, "levels": levels})
    for j in range(n_binary):
        b = rng.random(n) < 0.3
        gone = rng.random(n) < missing / 2
        cols[f"b{j}"] = [None if g else bool(x) for x, g in zip(b, gone)]
        schema.append({"name": f"b{j}", "type": "Binary",
                       "missing": missing / 2})
    cols["label"] = label.tolist()
    schema.append({"name": "label", "type": "RealNN", "response": True})
    return cols, schema


#: the committed fixture's cut: 20 000 rows at full width (seed 0)
FIXTURE_SHAPE = dict(n_real=64, n_bucketized=8, n_pick=32, n_levels=30, n_binary=4)


def wide_pipeline(pkg, ftypes, schema, num_folds: int = 2):
    """(label, selector, checker, prediction) of the fixture's pipeline in
    ``pkg``, a namespace with the package's ``FeatureBuilder``,
    ``transmogrify``, ``BinaryClassificationModelSelector`` and
    ``LogisticRegression`` (either package: the pipeline is written the
    same way in both)."""
    label = pkg.FeatureBuilder.of("label", ftypes["label"]).extract_field() \
        .as_response()
    preds = {s["name"]: pkg.FeatureBuilder.of(s["name"], ftypes[s["name"]])
             .extract_field().as_predictor()
             for s in schema if not s.get("response")}
    buckets = [preds[s["name"]].auto_bucketize(label)
               for s in schema if s.get("bucketized")]
    vec = pkg.transmogrify(list(preds.values()) + buckets)
    checked = label.sanity_check(vec)
    sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds,
        models=[(pkg.LogisticRegression(),
                 [{"reg_param": 0.01}, {"reg_param": 0.1}])])
    pred = label.transform_with(sel, checked)
    return label, sel, checked.origin_stage, pred


# -- the DSL features over the wide table ----------------------------------------

#: NumericBucketizer splits of the 8 fixed-split features: the even ones over
#: +-inf edges without track_invalid, the odd ones finite with track_invalid
DSL_SPLITS = ((float("-inf"), -0.5, 0.0, 0.5, float("inf")), (-1.0, 0.0, 1.0))


def score_column(n: int, seed: int = 0) -> list:
    """A non-null RealNN predictor for the PercentileCalibrator (the wide
    table has none): standard normal from ``default_rng(seed + 1)``."""
    return np.random.default_rng(seed + 1).normal(size=n).tolist()


def head_level(v) -> bool:
    """The exists predicate: a pick-list value at one of the top levels."""
    return v is not None and v[-2:] in ("00", "01")


def level_number(v):
    """The map_to function: a pick-list level's number, as a Real."""
    return None if v is None else float(v[-2:])


def dsl_pipeline(pkg, ftypes, schema, num_folds: int = 2):
    """(label, selector, checker, prediction) of the wide pipeline with the
    DSL's features added, in ``pkg`` (either package's module): the raw
    columns and 8 auto-bucketized Reals as in :func:`wide_pipeline`, plus 8
    fixed-split ``NumericBucketizer`` features over Reals that are not
    auto-bucketized (:data:`DSL_SPLITS`), 8 pairwise ``+ - * /`` features,
    ``to_occur`` on 2 pick lists and ``exists`` on 2 more, a
    ``PercentileCalibrator`` over the RealNN ``score`` column
    (:func:`score_column`), an ``alias`` and a ``map_to``; then transmogrify
    -> sanity_check -> the 2-fold LR selector."""
    import importlib

    scal = importlib.import_module(pkg.__name__ + ".ops.scalers")
    lr = importlib.import_module(pkg.__name__ + ".models.logistic").LogisticRegression
    label = pkg.FeatureBuilder.of("label", ftypes["label"]).extract_field() \
        .as_response()
    preds = {s["name"]: pkg.FeatureBuilder.of(s["name"], ftypes[s["name"]])
             .extract_field().as_predictor()
             for s in schema if not s.get("response")}
    score = pkg.FeatureBuilder.of("score", ftypes["score"]).extract_field() \
        .as_predictor()
    reals = [s["name"] for s in schema if s["type"] == "Real" and not s["bucketized"]]
    picks = [s["name"] for s in schema if s["type"] == "PickList"]
    buckets = [preds[s["name"]].auto_bucketize(label)
               for s in schema if s.get("bucketized")]
    fixed = [preds[r].transform_with(scal.NumericBucketizer(
        splits=DSL_SPLITS[j % 2], track_invalid=bool(j % 2)))
        for j, r in enumerate(reals[:8])]
    a, b = [preds[r] for r in reals[8:24:2]], [preds[r] for r in reals[9:24:2]]
    math = [a[0] + b[0], a[1] - b[1], a[2] * b[2], a[3] / b[3],
            a[4] + b[4], a[5] - b[5], a[6] * b[6], a[7] / b[7]]
    values = [preds[picks[0]].to_occur(), preds[picks[1]].to_occur(),
              preds[picks[2]].exists(head_level), preds[picks[3]].exists(head_level),
              score.transform_with(scal.PercentileCalibrator(buckets=10)),
              preds[reals[24]].alias(reals[24] + "_alias"),
              preds[picks[4]].map_to(level_number, ftypes[reals[0]], name="level")]
    vec = pkg.transmogrify(list(preds.values()) + buckets + fixed + math + values)
    checked = label.sanity_check(vec)
    sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds,
        models=[(lr(), [{"reg_param": 0.01}, {"reg_param": 0.1}])])
    pred = label.transform_with(sel, checked)
    return label, sel, checked.origin_stage, pred
