#!/usr/bin/env python3
"""Write the linear-family parity fixture of the PyTorch port (JAX package, CPU).

    JAX_PLATFORMS=cpu python tools/make_torch_linear_fixture.py \
        [--out transmogrifai_tpu_torch/fixtures/training_linear] [--rows 16384]

Runs the JAX package on the data of ``bench.py``'s ``synth`` (the formula is
copied here, not imported: n rows x 128 features, numpy seed 0) and records:

- the CV metric (auPR) per (grid, fold) of LogisticRegression over bench.py's
  grid {reg_param 0.001|0.01|0.1} x {elastic_net 0|0.5} and of LinearSVC over
  {reg_param 0.01|0.1}, each family's ``cv_sweep`` on the folds of
  ``CrossValidator(num_folds=3, seed=7)``;
- the refit coefficients and intercept of every grid point on all rows
  (unit weights);
- the default selector's run: ``BinaryClassificationModelSelector
  .with_cross_validation(num_folds=3, seed=7)`` with no ``models=`` through
  ``Workflow.train`` -- every (family, grid) CV metric, the winner, its grid
  and its train metrics.

It writes ``summary.json`` (metrics, winner, recipe, versions) and
``arrays.npz`` (the coefficients, float64).  ``chip_smoke.py`` regenerates x
and y from the same numpy seed on the card and holds the port's sweeps and
refits to this record; the forest's bootstrap draws of the default selector
come from ``fixtures/training_trees`` (the same seed, rows and trees).  The
port never imports this tool.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                           "training_linear")
D = 128
FOLDS = 3
SELECTOR_SEED = 7
LR_GRIDS = [{"reg_param": r, "elastic_net": e}
            for r in (0.001, 0.01, 0.1) for e in (0.0, 0.5)]
SVC_GRIDS = [{"reg_param": r} for r in (0.01, 0.1)]


def synth(n: int, d: int, seed: int = 0):
    """bench.py's ``synth``: standard-normal features, a logistic label."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d).astype(np.float32) / np.sqrt(d)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(x @ beta)))).astype(np.float64)
    return x, y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--rows", type=int, default=16384)
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    from transmogrifai_tpu.data.dataset import Column, Dataset
    from transmogrifai_tpu.evaluators.base import BinaryClassificationEvaluator
    from transmogrifai_tpu.features.builder import FeatureBuilder
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.models.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.models.svm import LinearSVC
    from transmogrifai_tpu.models.tuning import CrossValidator
    from transmogrifai_tpu.types import RealNN
    from transmogrifai_tpu.workflow.workflow import Workflow

    t0 = time.perf_counter()
    x, y = synth(args.rows, D, seed=0)
    y32 = y.astype(np.float32)
    ones = np.ones(args.rows, np.float32)
    ev = BinaryClassificationEvaluator("auPR")
    train_w, val_w = CrossValidator(ev, num_folds=FOLDS, seed=SELECTOR_SEED) \
        .fold_weights(y32, ones)
    metric = ev.metric_fn()
    lr_cv = LogisticRegression().cv_sweep(x, y32, train_w, val_w, LR_GRIDS, metric)
    svc_cv = LinearSVC().cv_sweep(x, y32, train_w, val_w, SVC_GRIDS, metric)
    arrays = {}
    for fam, cls, grids in (("lr", LogisticRegression, LR_GRIDS),
                            ("svc", LinearSVC, SVC_GRIDS)):
        fits = [cls(**g)._fit_arrays(x, y32, ones) for g in grids]
        arrays[f"{fam}_coef"] = np.stack([m.coef for m in fits])
        arrays[f"{fam}_intercept"] = np.asarray([m.intercept for m in fits])

    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    vec = FeatureBuilder.OPVector("features").extract_field().as_predictor()
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=FOLDS, seed=SELECTOR_SEED)
    pred = label.transform_with(selector, vec)
    ds = Dataset({"label": Column.from_values(RealNN, y.tolist()),
                  "features": Column.vector(x)})
    model = Workflow().set_input_dataset(ds).set_result_features(label, pred).train()
    summary = model.fitted[selector.uid].summary
    t_fit = time.perf_counter() - t0

    record = {
        "recipe": {"synth_rows": args.rows, "features": D, "data_seed": 0,
                   "folds": FOLDS, "selector_seed": SELECTOR_SEED,
                   "lr_grids": LR_GRIDS, "svc_grids": SVC_GRIDS,
                   "metric": "auPR"},
        "lr_cv": lr_cv.tolist(),
        "svc_cv": svc_cv.tolist(),
        "winner": {"name": summary.best_model_name, "grid": summary.best_grid},
        "validation": [{"model": e.model_name, "grid": e.grid,
                        "metric": e.metric_name, "values": e.metric_values}
                       for e in summary.validation_results],
        "train_evaluation": summary.train_evaluation,
        "data_prep_weights_all_one": bool(summary.data_prep is not None
                                          and "downSampleFraction"
                                          not in summary.data_prep.details),
        "versions": {"jax": jax.__version__, "numpy": np.__version__},
        "fit_seconds_cpu": t_fit,
    }
    assert record["data_prep_weights_all_one"], "the balancer reweighted the rows"
    os.makedirs(args.out, exist_ok=True)
    np.savez_compressed(os.path.join(args.out, "arrays.npz"), **arrays)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
    size = sum(os.path.getsize(os.path.join(args.out, f))
               for f in os.listdir(args.out))
    print(json.dumps({"out": args.out, "bytes": size, "winner": record["winner"],
                      "fit_seconds_cpu": t_fit}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
