"""Run the reference's four example apps with the JAX package and save their
record for the PyTorch port.

``examples/titanic_simple.py`` (its ``main()``), ``iris_app.py`` and
``boston_app.py`` (``App().main`` train, then a score run of the model it
saved) and ``dataprep_readers.py`` (``main()``) run on the CPU, each as
its own source says; the Titanic run's model is caught as ``Workflow.train``
returns it.  The output (default ``transmogrifai_tpu_torch/fixtures/
examples/record.json``) holds, per example:

- ``titanic``: ``main()``'s metrics (``cv_auPR`` among them), the selector
  summary (``to_dict()``), ``summary_pretty()``, and the scored training
  rows' prediction arrays with their sha256 (float64 bytes);
- ``iris`` / ``boston``: the train run's metrics (the selector summary) and
  the score run's prediction arrays and sha256 over the example's scoring
  reader;
- ``dataprep``: the aggregate and conditional readers' values by key.

A tree family's CV rows and any run a tree wins depend on the reference's
threefry draws, which the port does not reproduce: the tests hold those to
a tolerance, the linear rows to the LR gate.  ``chip_smoke.py`` and
``tests/test_torch_examples.py`` read the record; neither imports JAX.

Run from the repo root (about a minute):

    JAX_PLATFORMS=cpu python tools/make_torch_examples_fixture.py
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                           "examples", "record.json")


def prediction_record(col) -> dict:
    """A prediction column's arrays and the sha256 of their float64 bytes."""
    parts = {"pred": np.asarray(col.pred, np.float64)}
    for name in ("raw", "prob"):
        a = getattr(col, name)
        if a is not None:
            parts[name] = np.asarray(a, np.float64)
    h = hashlib.sha256()
    for name in sorted(parts):
        h.update(np.ascontiguousarray(parts[name]).tobytes())
    return {**{k: v.tolist() for k, v in parts.items()}, "sha256": h.hexdigest()}


def _pred_name(model) -> str:
    return next(f.name for f in model.result_features
                if f.ftype.__name__ == "Prediction")


def run_titanic(J) -> dict:
    import titanic_simple

    trained = []
    train = J.Workflow.train

    def catching(self, *a, **kw):
        m = train(self, *a, **kw)
        trained.append(m)
        return m

    J.Workflow.train = catching
    try:
        metrics = titanic_simple.main()
    finally:
        J.Workflow.train = train
    model = trained[-1]
    ds = J.readers.files.DataReaders.Simple.dataframe(
        titanic_simple.titanic_dataframe()).generate_dataset(
        titanic_simple.model_raw_features(model))
    scored = model.score(ds)
    return {"metrics": metrics, "summary": model.summary().to_dict(),
            "pretty": model.summary_pretty(),
            "scores": prediction_record(scored[_pred_name(model)])}


def run_app(app_cls, tmp: str, name: str) -> dict:
    loc = os.path.join(tmp, name)
    train = app_cls().main(["--run-type", "train", "--model-location", loc])
    score = app_cls().main(["--run-type", "score", "--model-location", loc])
    from transmogrifai_tpu.workflow.workflow import WorkflowModel

    pred = _pred_name(WorkflowModel.load(loc))
    return {"train": train.metrics, "scores": prediction_record(score.scores[pred])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import transmogrifai_tpu as J
    import transmogrifai_tpu.readers.files  # noqa: F401
    import dataprep_readers
    from boston_app import OpBoston
    from iris_app import OpIris

    record = {"titanic": run_titanic(J)}
    with tempfile.TemporaryDirectory() as tmp:
        record["iris"] = run_app(OpIris, tmp, "iris")
        record["boston"] = run_app(OpBoston, tmp, "boston")
    (agg_keys, agg_ds), (cond_keys, cond_ds) = dataprep_readers.main()
    record["dataprep"] = {
        "aggregate": dict(zip(agg_keys, agg_ds["amount"].to_values())),
        "conditional": dict(zip(cond_keys, cond_ds["amount"].to_values()))}
    record["environment"] = {"jax": jax.__version__, "numpy": np.__version__}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True, default=float)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
