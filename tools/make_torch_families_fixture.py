"""Train the families pipeline with the JAX package and save its record for
the PyTorch port.

The families table (``tests/torch_families_data.py``: free text in English
and German, a categorical text, an email, pick lists, a multi-pick list,
dates, a date list, a text list, a geolocation, numerics) goes through
transmogrify -> SanityChecker(correlation_exclusion="hashed_text") -> a
3-fold CV LogisticRegression selector, here on the CPU, by the reference
package (its encode kernels in interpret mode, as its own tests run them).
The output directory (default ``transmogrifai_tpu_torch/fixtures/
training_families``) holds:

- ``model.json.gz`` + ``arrays.npz``: the saved model;
- ``records.json``: the table's first ``2 x 128`` rows as request records
  (label left out) and the JAX serving plan's output records, one entry
  per batch of 128;
- ``states.json``: the fitted states (each stage's by class and input
  names), the SanityChecker's kept indices, the CV metrics, the winner's
  coefficients and the training vector's shape and sha256 (float32 bytes).

Run from the repo root (takes about a minute):

    JAX_PLATFORMS=cpu python tools/make_torch_families_fixture.py
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
DEFAULT_OUT = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                           "training_families")
ROWS = 4096
SEED = 0
BATCH = 128
N_BATCHES = 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import transmogrifai_tpu as J
    from torch_families_data import (
        families_pipeline,
        fitted_states,
        make_families,
        make_records,
        plain,
        vector_digest,
    )
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.perf.kernels import dispatch as KD
    from transmogrifai_tpu.types import feature_type_by_name
    from transmogrifai_tpu.workflow.fit import transform_dag

    cols, schema = make_families(ROWS, seed=SEED)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ns = types.SimpleNamespace(
        FeatureBuilder=J.FeatureBuilder, transmogrify=J.transmogrify,
        SanityChecker=J.SanityChecker,
        BinaryClassificationModelSelector=J.BinaryClassificationModelSelector,
        LogisticRegression=LogisticRegression)
    label, sel, checker, pred = families_pipeline(ns, ftypes, schema)
    ds = J.Dataset.from_features(cols, ftypes)
    with KD.force_kernel_mode("interpret"):
        model = J.Workflow().set_input_dataset(ds).set_result_features(label, pred).train()
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
                   "prediction": pred.name, "batches": batches}, fh)

    summary = model.fitted[sel.uid].summary
    win = model.fitted[sel.uid].model
    states = {
        "seed": SEED, "rows": ROWS, "fitted": fitted_states(model),
        "cv": [{"grid": e.grid, "values": [float(v) for v in e.metric_values]}
               for e in summary.validation_results],
        "winner": {"name": summary.best_model_name, "grid": summary.best_grid,
                   "coef": plain(np.asarray(win.coef)),
                   "intercept": float(win.intercept)},
        "vector": vector_digest(vector)}
    with open(os.path.join(args.out, "states.json"), "w") as fh:
        json.dump(states, fh)
    size = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(json.dumps({"out": args.out, "bytes": size, "vector": states["vector"],
                      "kept": len(states["fitted"]["SanityCheckerModel"]["checker"]
                                  ["kept_indices"]),
                      "winner": states["winner"]["grid"], "cv": states["cv"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
