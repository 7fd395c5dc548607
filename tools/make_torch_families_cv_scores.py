"""Record the JAX package's LR validation scores of the families record, for
the PyTorch port's test of its LR CV gap.

The families record (``transmogrifai_tpu_torch/fixtures/training_families``,
``tools/make_torch_families_fixture.py``) holds the JAX package's LR CV
metrics.  This script loads that record's model, transforms its table
(``tests/torch_families_data.py``, the record's rows and seed) to the
selector's input vector (the kernels in interpret mode, as the JAX
package's tests run them), runs the JAX LogisticRegression CV sweep over it
with the CrossValidator's folds and the record's grids, and saves each
(grid, fold) fit's validation scores, as the sweep's eval program computes
them, to ``cv_scores.npz`` beside the record:

- ``scores``: float32 (grids, folds, rows), sigmoid of the sweep's margins;
- ``metrics``: float64 (grids, folds), the sweep's auPR (equal to the
  record's CV).

Run from the repo root (about half a minute):

    JAX_PLATFORMS=cpu python tools/make_torch_families_cv_scores.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "training_families")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=RECORD)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import transmogrifai_tpu as J
    import transmogrifai_tpu.perf.programs as JP
    from torch_families_data import make_families
    from transmogrifai_tpu.evaluators.base import BinaryClassificationEvaluator
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.models.tuning import CrossValidator
    from transmogrifai_tpu.perf.kernels import dispatch as KD
    from transmogrifai_tpu.types import feature_type_by_name
    from transmogrifai_tpu.workflow import fit as JFit

    with open(os.path.join(args.record, "states.json")) as fh:
        states = json.load(fh)
    model = J.WorkflowModel.load(args.record)
    [sel] = [t for t in model.fitted.values()
             if type(getattr(t, "summary", None)).__name__ == "ModelSelectorSummary"]
    label, checked = sel.inputs
    cols, schema = make_families(states["rows"], seed=states["seed"])
    ds = J.Dataset.from_features(
        cols, {s["name"]: feature_type_by_name(s["type"]) for s in schema})
    with KD.force_kernel_mode("interpret"):
        out = JFit.transform_dag(ds, [label, checked], model.fitted)
    x = np.asarray(out[checked.name].data, np.float32)
    y = np.asarray(out[label.name].data, np.float32)
    ev = BinaryClassificationEvaluator()
    tw, vw = CrossValidator(ev, num_folds=len(states["cv"][0]["values"])) \
        .fold_weights(y, np.ones_like(y))
    grids = [c["grid"] for c in states["cv"]]
    seen = {}
    run_cached = JP.run_cached

    def capture(fn, *a, **kw):
        if kw.get("label") == "LogisticRegression/eval_sweep":
            seen["xd_betas"] = (a[0], a[2])
        return run_cached(fn, *a, **kw)

    JP.run_cached = capture
    try:
        metrics = np.asarray(LogisticRegression()._cv_sweep_device(
            x, y, tw, vw, grids, ev.metric_fn()), np.float64)
    finally:
        JP.run_cached = run_cached
    xd, betas = seen["xd_betas"]
    scores = np.asarray(jax.jit(lambda a, b: jax.nn.sigmoid(
        jnp.einsum("nd,gkd->gkn", a, b)))(xd, betas))[:, :, :len(y)]
    for gi, c in enumerate(states["cv"]):
        if not np.allclose(metrics[gi], c["values"], rtol=0, atol=1e-7):
            raise SystemExit(f"sweep metrics {metrics[gi]} != the record's {c['values']}")
    path = os.path.join(args.record, "cv_scores.npz")
    np.savez_compressed(path, scores=scores.astype(np.float32), metrics=metrics)
    print(f"wrote {path}: scores {scores.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
