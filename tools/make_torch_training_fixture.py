#!/usr/bin/env python3
"""Write the training-parity fixture of the PyTorch port (JAX package, CPU).

    JAX_PLATFORMS=cpu python tools/make_torch_training_fixture.py \
        [--out transmogrifai_tpu_torch/fixtures/training_trees] [--rows 16384]

Runs the JAX package's tree model selection on the data of ``bench.py``'s
``synth`` (the formula is copied here, not imported: n rows x 128 features,
numpy seed 0): ``BinaryClassificationModelSelector.with_cross_validation``
with 3 folds, seed 7, RandomForest {50 trees, depth 3|6} and GBT {50 rounds,
depth 3}, through ``Workflow.train``.  It writes:

- ``summary.json`` — every (family, grid) CV metric per fold, the winner and
  its grid, the winner's train metrics, the data recipe and the versions;
- ``arrays.npz`` — the quantile edges, the winner's refit trees, the refit
  trees of both forest grid points, and the forests' Poisson bootstrap draws
  (uint8; both grid points draw the same (50, n) counts from seed 42 + 1).

``chip_smoke.py`` regenerates x and y from the same numpy seed on the card,
feeds these draws to the port through ``models/trees.py::draw_bootstrap`` and
holds the port's fit to this record.  The port never imports this tool.
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
                           "training_trees")
D = 128
FOLDS = 3
SELECTOR_SEED = 7
RF_GRIDS = [{"num_trees": 50, "max_depth": d} for d in (3, 6)]
GBT_GRIDS = [{"num_rounds": 50, "max_depth": 3}]


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
    from transmogrifai_tpu.features.builder import FeatureBuilder
    from transmogrifai_tpu.models.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.models.trees import (
        GradientBoostedTreesClassifier,
        RandomForestClassifier,
    )
    from transmogrifai_tpu.types import RealNN
    from transmogrifai_tpu.workflow.workflow import Workflow

    t0 = time.perf_counter()
    x, y = synth(args.rows, D, seed=0)
    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    vec = FeatureBuilder.OPVector("features").extract_field().as_predictor()
    rf, gbt = RandomForestClassifier(), GradientBoostedTreesClassifier()
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=FOLDS, seed=SELECTOR_SEED,
        models=[(rf, RF_GRIDS), (gbt, GBT_GRIDS)])
    pred = label.transform_with(selector, vec)
    ds = Dataset({"label": Column.from_values(RealNN, y.tolist()),
                  "features": Column.vector(x)})
    model = Workflow().set_input_dataset(ds).set_result_features(label, pred).train()
    fitted = model.fitted[selector.uid]
    summary = fitted.summary
    t_fit = time.perf_counter() - t0

    arrays = {"edges": fitted.model.edges}
    for k, v in fitted.model.trees.items():
        arrays[f"winner_{k}"] = np.asarray(v)
    base_w = np.ones(args.rows, np.float32)   # DataBalancer keeps unit weights here
    for grid in RF_GRIDS:
        m = rf.copy().set_params(**grid)._fit_arrays(x, y.astype(np.float32), base_w)
        for k, v in m.trees.items():
            arrays[f"rf_depth{grid['max_depth']}_{k}"] = np.asarray(v)
    boot = np.asarray(rf._boot(args.rows))
    assert boot.max() < 256 and np.all(boot == np.round(boot))
    arrays["rf_boot"] = boot.astype(np.uint8)

    record = {
        "recipe": {"synth_rows": args.rows, "features": D, "data_seed": 0,
                   "folds": FOLDS, "selector_seed": SELECTOR_SEED,
                   "rf_grids": RF_GRIDS, "gbt_grids": GBT_GRIDS,
                   "rf_seed": int(rf.seed), "rf_boot_seed": int(rf.seed) + 1},
        "winner": {"name": summary.best_model_name, "grid": summary.best_grid,
                   "model_class": type(fitted.model).__name__,
                   "max_depth": int(fitted.model.max_depth),
                   "n_bins": int(fitted.model.n_bins),
                   "base_score": [float(v) for v in fitted.model.base_score]},
        "validation": [{"model": ev.model_name, "grid": ev.grid,
                        "metric": ev.metric_name, "values": ev.metric_values}
                       for ev in summary.validation_results],
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
