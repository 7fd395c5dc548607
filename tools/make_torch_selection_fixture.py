#!/usr/bin/env python3
"""Write the regression and multiclass selection fixture of the PyTorch port
(JAX package, CPU).

    JAX_PLATFORMS=cpu python tools/make_torch_selection_fixture.py \
        [--out transmogrifai_tpu_torch/fixtures/training_selection]

Runs the JAX package's default selectors through ``Workflow.train`` on three
data sets of 4096 rows x 16 features (the formulas are copied in
``chip_smoke.py``, numpy seed 0):

- ``regression``: y = x[:, :8] @ w + 0.5 sin(x[:, 8]) + N(0, 0.5^2), through
  ``RegressionModelSelector.with_cross_validation(seed=7)`` (LinearRegression
  6 grids, RandomForestRegressor 2, GBT 1, GLM gaussian 2: 33 fold-models);
- ``multiclass3`` and ``multiclass30``: y = argmax(x @ W + Gumbel) with 3 and
  30 classes, through ``MultiClassificationModelSelector
  .with_cross_validation(seed=7)`` (multinomial LR 3 grids, RandomForest 2,
  DecisionTree 2, NaiveBayes 1: 24 fold-models, behind a DataCutter).

It records each run's CV metric per (family, grid, fold), the winner and its
grid, the train metrics and the data prep, in ``summary.json``, and in
``arrays.npz`` the forests' Poisson bootstrap draws (seed 42 + 1, 50 trees,
4096 rows: the same for all three runs), which the port's one seam,
``trees.draw_bootstrap``, takes in the parity run.  ``chip_smoke.py``
regenerates the data from the same seeds on the card and holds the port to
this record.  The port never imports this tool.
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
                           "training_selection")
ROWS, D, SELECTOR_SEED = 4096, 16, 7
RUNS = (("regression", None), ("multiclass3", 3), ("multiclass30", 30))


def regression_data(n: int, d: int, seed: int = 0):
    """x standard normal; y = x[:, :8] @ w + 0.5 sin(x[:, 8]) + N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=8)
    y = x[:, :8] @ w + 0.5 * np.sin(x[:, 8]) + rng.normal(size=n) * 0.5
    return x, y.astype(np.float64)


def multiclass_data(n: int, d: int, classes: int, seed: int = 0):
    """x standard normal; y = argmax(x[:, :16] @ W + Gumbel) over ``classes``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(16, classes))
    y = np.argmax(x[:, :16] @ w + rng.gumbel(size=(n, classes)), axis=1)
    return x, y.astype(np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    from transmogrifai_tpu.data.dataset import Column, Dataset
    from transmogrifai_tpu.features.builder import FeatureBuilder
    from transmogrifai_tpu.models.selector import (
        MultiClassificationModelSelector,
        RegressionModelSelector,
    )
    from transmogrifai_tpu.types import RealNN
    from transmogrifai_tpu.workflow.workflow import Workflow

    t0 = time.perf_counter()
    runs = {}
    for name, classes in RUNS:
        if classes is None:
            x, y = regression_data(ROWS, D)
            selector = RegressionModelSelector.with_cross_validation(seed=SELECTOR_SEED)
        else:
            x, y = multiclass_data(ROWS, D, classes)
            selector = MultiClassificationModelSelector.with_cross_validation(
                seed=SELECTOR_SEED)
        label = FeatureBuilder.RealNN("label").extract_field().as_response()
        vec = FeatureBuilder.OPVector("features").extract_field().as_predictor()
        pred = label.transform_with(selector, vec)
        ds = Dataset({"label": Column.from_values(RealNN, y.tolist()),
                      "features": Column.vector(x)})
        model = Workflow().set_input_dataset(ds).set_result_features(label, pred).train()
        s = model.fitted[selector.uid].summary
        runs[name] = {
            "classes": classes,
            "winner": {"name": s.best_model_name, "grid": s.best_grid,
                       "model": type(model.fitted[selector.uid].model).__name__},
            "validation": [{"model": e.model_name, "grid": e.grid,
                            "metric": e.metric_name, "values": e.metric_values}
                           for e in s.validation_results],
            "train_evaluation": {k: v for k, v in s.train_evaluation.items()
                                 if k != "confusion"},
            "data_prep": {"kind": s.data_prep.kind, "details": s.data_prep.details},
        }
    boot = jax.random.poisson(jax.random.PRNGKey(42 + 1), 1.0, (50, ROWS))
    boot = np.asarray(boot)
    assert boot.max() < 256
    record = {
        "recipe": {"rows": ROWS, "features": D, "data_seed": 0, "folds": 3,
                   "selector_seed": SELECTOR_SEED, "rf_boot_seed": 43,
                   "rf_trees": 50},
        "runs": runs,
        "versions": {"jax": jax.__version__, "numpy": np.__version__},
        "fit_seconds_cpu": time.perf_counter() - t0,
    }
    os.makedirs(args.out, exist_ok=True)
    np.savez_compressed(os.path.join(args.out, "arrays.npz"),
                        rf_boot=boot.astype(np.uint8))
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
    size = sum(os.path.getsize(os.path.join(args.out, f))
               for f in os.listdir(args.out))
    print(json.dumps({"out": args.out, "bytes": size,
                      "winners": {k: v["winner"] for k, v in runs.items()},
                      "fit_seconds_cpu": record["fit_seconds_cpu"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
