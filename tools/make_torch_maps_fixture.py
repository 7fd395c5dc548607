"""Train the maps pipeline with the JAX package, raw feature filter first,
and save its record for the PyTorch port.

The maps table (``tests/torch_maps_data.py``: a CRM object's custom fields
as the typed maps, two pick lists, reals) and its scoring table go through
``Workflow().with_raw_feature_filter(RawFeatureFilter(scoring_dataset=...,
protected_features=("legacy_score",)))`` -> transmogrify ->
SanityChecker(correlation_exclusion="hashed_text") -> a 3-fold CV
LogisticRegression selector, here on the CPU, by the reference package (its
encode kernels in interpret mode, as its own tests run them).  The output
directory (default ``transmogrifai_tpu_torch/fixtures/training_maps``)
holds:

- ``model.json.gz`` + ``arrays.npz``: the saved model (its blacklist
  among the manifest's fields);
- ``records.json``: ``2 x 32`` request records of the table (label left
  out; some without their ``tags`` map, with an empty ``notes`` map, or
  with one ``amounts`` key) and the JAX serving plan's output records, one
  entry per batch;
- ``states.json``: the fitted states (each stage's by class and input
  names), the CV metrics, the winner's coefficients and the training
  vector's shape and sha256 (float32 bytes);
- ``rff.json``: the filter's record (``RawFeatureFilterResults.to_dict()``:
  the training and scoring distributions, every metric, the blacklist) and
  the map keys it stripped.

Run from the repo root (takes about a minute):

    JAX_PLATFORMS=cpu python tools/make_torch_maps_fixture.py
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "training_maps")
ROWS = 4096
SCORING_ROWS = 1024
SEED = 0
SCORING_SEED = 1
BATCH = 32
N_BATCHES = 2


def stripped_keys(results) -> dict:
    """{map feature: sorted keys the filter removed from its column} of a
    filter run (keys of a feature it kept)."""
    out: dict = {}
    for m in results.metrics:
        if m.key is not None and m.excluded and m.name not in results.excluded_features:
            out.setdefault(m.name, []).append(m.key)
    return {k: sorted(v) for k, v in sorted(out.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import transmogrifai_tpu as J
    from torch_maps_data import (
        fitted_states,
        make_maps,
        make_records,
        make_scoring,
        maps_filter,
        maps_pipeline,
        plain,
        vector_digest,
    )
    from transmogrifai_tpu.filters import RawFeatureFilter
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.perf.kernels import dispatch as KD
    from transmogrifai_tpu.types import feature_type_by_name
    from transmogrifai_tpu.workflow.fit import transform_dag

    cols, schema = make_maps(ROWS, seed=SEED)
    scols, sschema = make_scoring(SCORING_ROWS, seed=SCORING_SEED)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ns = types.SimpleNamespace(
        FeatureBuilder=J.FeatureBuilder, transmogrify=J.transmogrify,
        SanityChecker=J.SanityChecker,
        BinaryClassificationModelSelector=J.BinaryClassificationModelSelector,
        LogisticRegression=LogisticRegression, RawFeatureFilter=RawFeatureFilter)
    label, sel, checker, pred = maps_pipeline(ns, ftypes, schema)
    ds = J.Dataset.from_features(cols, ftypes)
    sds = J.Dataset.from_features(scols, {s["name"]: ftypes[s["name"]] for s in sschema})
    wf = J.Workflow().set_input_dataset(ds).set_result_features(label, pred) \
        .with_raw_feature_filter(maps_filter(ns, sds))
    with KD.force_kernel_mode("interpret"):
        model = wf.train()
        # the raw table: the map stages pass over keys they were not fitted
        # on, so the stripped keys make no difference to the vector
        vec = checker.inputs[1]
        vector = transform_dag(ds, [vec], model.fitted)[vec.name].data
    if os.path.isdir(args.out):
        shutil.rmtree(args.out)
    model.save(args.out)

    plan = model.serving_plan()
    batches = []
    for b in range(N_BATCHES):
        recs = make_records(cols, range(b * BATCH, (b + 1) * BATCH))
        batches.append({"records": recs, "scored": plan.score(recs)})
    with open(os.path.join(args.out, "records.json"), "w") as fh:
        json.dump({"seed": SEED, "rows": ROWS, "batch": BATCH,
                   "prediction": pred.name, "batches": batches}, fh, separators=(",", ":"))

    summary = model.fitted[sel.uid].summary
    win = model.fitted[sel.uid].model
    states = {
        "seed": SEED, "rows": ROWS, "scoring_seed": SCORING_SEED,
        "scoring_rows": SCORING_ROWS, "fitted": fitted_states(model),
        "cv": [{"grid": e.grid, "values": [float(v) for v in e.metric_values]}
               for e in summary.validation_results],
        "winner": {"name": summary.best_model_name, "grid": summary.best_grid,
                   "coef": plain(np.asarray(win.coef)),
                   "intercept": float(win.intercept)},
        "vector": vector_digest(vector)}
    with open(os.path.join(args.out, "states.json"), "w") as fh:
        json.dump(states, fh)
    with open(os.path.join(args.out, "rff.json"), "w") as fh:
        json.dump({"results": model.rff_summary.to_dict(), "blacklist": model.blacklist,
                   "stripped_keys": stripped_keys(model.rff_summary)}, fh,
                  separators=(",", ":"))
    size = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(json.dumps({"out": args.out, "bytes": size, "vector": states["vector"],
                      "blacklist": model.blacklist,
                      "stripped": stripped_keys(model.rff_summary),
                      "kept": len(states["fitted"]["SanityCheckerModel"]["checker"]
                                  ["kept_indices"]),
                      "winner": states["winner"]["grid"], "cv": states["cv"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
