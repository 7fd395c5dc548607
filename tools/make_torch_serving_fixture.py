"""Train the wide serving fixture with the JAX package and save it for the
PyTorch port.

The PyTorch port (``transmogrifai_tpu_torch``) has no trainer yet and its
machine has no JAX, so the model it serves is trained here, by the reference
package, and committed as the reference's saved-model directory
(``model.json.gz`` + ``arrays.npz``).  ``schema.json`` beside it lists every
raw feature with its type and levels, so requests can be made from a seed
without importing JAX.

The model widens the repo's serving fixture (benchmarks/local_scoring_latency.py)
to a production tabular width at the reference's defaults:

- 64 ``Real`` features with 10 % missing, vectorized by transmogrify's
  NumericVectorizer (mean fill + null indicator);
- the first 8 of them also ``auto_bucketize(label)``d (DecisionTreeNumericBucketizer
  at its defaults); the label depends on thresholds of exactly these 8, so each
  tree finds real splits;
- 32 ``PickList`` features with 30 Zipf-distributed levels each (top_k 20,
  min_support 10: 22 one-hot columns each);
- 4 ``Binary`` features;
- a ``RealNN`` 0/1 label, ``label.sanity_check(transmogrify(...))`` and a
  2-fold cross-validated LogisticRegression selector.

Run from the repo root (CPU is enough; takes a few minutes):

    JAX_PLATFORMS=cpu python tools/make_torch_serving_fixture.py
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                           "serving_wide")


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


def train(cols, schema, num_folds: int = 2):
    """Fit the fixture's workflow with the JAX package; returns the model."""
    from transmogrifai_tpu import (
        BinaryClassificationModelSelector,
        Dataset,
        FeatureBuilder,
        Workflow,
        transmogrify,
    )
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.types import feature_type_by_name

    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = Dataset.from_features(cols, ftypes)
    label = FeatureBuilder.of("label", ftypes["label"]).extract_field() \
        .as_response()
    preds = {s["name"]: FeatureBuilder.of(s["name"], ftypes[s["name"]])
             .extract_field().as_predictor()
             for s in schema if not s.get("response")}
    buckets = [preds[s["name"]].auto_bucketize(label)
               for s in schema if s.get("bucketized")]
    vec = transmogrify(list(preds.values()) + buckets)
    checked = label.sanity_check(vec)
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds,
        models=[(LogisticRegression(),
                 [{"reg_param": 0.01}, {"reg_param": 0.1}])])
    pred = label.transform_with(sel, checked)
    return Workflow().set_input_dataset(ds) \
        .set_result_features(label, pred).train()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--picklists", type=int, default=32)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    cols, schema = make_data(args.rows, n_real=64, n_bucketized=8,
                             n_pick=args.picklists, n_levels=30, n_binary=4)
    model = train(cols, schema)
    if os.path.isdir(args.out):
        shutil.rmtree(args.out)
    model.save(args.out)
    with open(os.path.join(args.out, "schema.json"), "w") as fh:
        json.dump({"seed": 0, "rows": args.rows, "features": schema}, fh,
                  indent=1)
    split = [t for t in model.fitted.values()
             if type(t).__name__ == "DecisionTreeNumericBucketizerModel"]
    size = sum(os.path.getsize(os.path.join(args.out, f))
               for f in os.listdir(args.out))
    print(json.dumps({
        "out": args.out, "bytes": size,
        "bucketizers_split": sum(t.should_split for t in split),
        "bucketizers": len(split),
        "splits": [len(t.splits) for t in split],
        "winner": model.summary().best_model_name,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
