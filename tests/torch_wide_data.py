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
