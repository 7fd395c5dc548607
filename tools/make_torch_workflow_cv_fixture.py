"""Train the wide pipeline with workflow-level CV in the JAX package and
save its record for the PyTorch port.

The wide table (``tests/torch_wide_data.py``: 64 Reals, 8 of them
``auto_bucketize(label)``-ed, 32 Zipf PickLists of 30 levels, 4 Binaries;
the serving fixture's full width) goes through transmogrify ->
SanityChecker -> a 3-fold selector over LogisticRegression (reg_param 0.01,
0.1) and MultilayerPerceptronClassifier (hidden_layers (10,)), trained by
``Workflow().with_workflow_cv().train()`` here on the CPU, by the reference
package (its encode kernels in interpret mode, as its own tests run them).
The output directory (default ``transmogrifai_tpu_torch/fixtures/workflow_cv``)
holds:

- ``model.json.gz`` + ``arrays.npz``: the saved model;
- ``states.json``: each fold's bucketizer splits, checker kept indices and
  vector digest (sha256 of its float32 bytes), the CV metrics, the winner
  and its coefficients, and the cut's stage classes;
- ``insights.json``: the model's ``model_insights().to_dict()``;
- ``loco.json``: ``RecordInsightsLOCO`` of the selected model over the
  first 256 rows' checked vectors (abs, top 20; and positive, top 5);
- ``mlp_init.npz``: the MLP's initial draws (``jax.random``) for every
  network size the run used, keyed by ``torch_wide_data.mlp_key``.

Run from the repo root (takes about a minute):

    JAX_PLATFORMS=cpu python tools/make_torch_workflow_cv_fixture.py
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
DEFAULT_OUT = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "workflow_cv")
ROWS = 8192
SEED = 0
LOCO_ROWS = 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import transmogrifai_tpu as J
    from torch_wide_data import (
        FIXTURE_SHAPE,
        WCV_FOLDS,
        fold_states,
        make_data,
        mlp_key,
        mlp_sizes,
        wcv_models,
        wide_pipeline,
    )
    from transmogrifai_tpu.insights import RecordInsightsLOCO
    from transmogrifai_tpu.insights.model_insights import _json_default
    from transmogrifai_tpu.models import mlp as JM
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.perf.kernels import dispatch as KD
    from transmogrifai_tpu.types import feature_type_by_name
    from transmogrifai_tpu.workflow import plan as JP
    from transmogrifai_tpu.workflow.dag import cut_dag

    cols, schema = make_data(ROWS, seed=SEED, **FIXTURE_SHAPE)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ns = types.SimpleNamespace(
        FeatureBuilder=J.FeatureBuilder, transmogrify=J.transmogrify,
        BinaryClassificationModelSelector=J.BinaryClassificationModelSelector,
        LogisticRegression=LogisticRegression,
        MultilayerPerceptronClassifier=JM.MultilayerPerceptronClassifier)
    label, sel, checker, pred = wide_pipeline(ns, ftypes, schema, WCV_FOLDS,
                                              wcv_models(ns))
    before, during, _ = cut_dag([label, pred])
    ds = J.Dataset.from_features(cols, ftypes)

    captured = {}
    real = JP.fused_fold_transforms

    def capture(dataset, during_, maps, **kw):
        out = real(dataset, during_, maps, **kw)
        captured["maps"], captured["datasets"] = maps, out
        return out

    JP.fused_fold_transforms = capture
    try:
        with KD.force_kernel_mode("interpret"):
            model = J.Workflow().set_input_dataset(ds) \
                .set_result_features(label, pred).with_workflow_cv().train()
            scored = model.score(ds.take(np.arange(LOCO_ROWS)), keep_intermediate=True)
    finally:
        JP.fused_fold_transforms = real
    if os.path.isdir(args.out):
        shutil.rmtree(args.out)
    model.save(args.out)

    vec_name = sel.inputs[1].name
    folds = fold_states(captured["maps"], captured["datasets"], vec_name)
    widths = [len(f["kept"]) for f in folds]
    final_kept = next(t.kept_indices for t in model.fitted.values()
                      if type(t).__name__ == "SanityCheckerModel")
    draws = {}
    seed = JM.MultilayerPerceptronClassifier().seed
    for sizes in mlp_sizes(widths + [len(final_kept)]):
        for layer, (w, b) in enumerate(JM._init_params(sizes, jax.random.PRNGKey(seed))):
            draws[mlp_key(sizes, seed, layer, "w")] = np.asarray(w)
            draws[mlp_key(sizes, seed, layer, "b")] = np.asarray(b)
    np.savez_compressed(os.path.join(args.out, "mlp_init.npz"), **draws)

    summary = model.summary()
    win = model.selector_model().model
    states = {
        "seed": SEED, "rows": ROWS, "shape": FIXTURE_SHAPE, "folds": folds,
        "before": [type(s).__name__ for s in before],
        "during": [type(s).__name__ for s in during],
        "mlp_seed": int(seed),
        "cv": [{"model": e.model_name, "grid": e.grid,
                "values": [float(v) for v in e.metric_values]}
               for e in summary.validation_results],
        "winner": {"name": summary.best_model_name, "grid": summary.best_grid,
                   "coef": np.asarray(getattr(win, "coef", [])).tolist(),
                   "intercept": float(getattr(win, "intercept", 0.0))},
        "train_evaluation": summary.train_evaluation,
        "final_kept": [int(j) for j in final_kept]}
    with open(os.path.join(args.out, "states.json"), "w") as fh:
        json.dump(states, fh)
    with open(os.path.join(args.out, "insights.json"), "w") as fh:
        fh.write(model.model_insights().to_json())

    vec_col = scored[vec_name]
    loco = {}
    for strategy, top_k in (("abs", 20), ("positive", 5)):
        out = RecordInsightsLOCO(model.selector_model(), top_k=top_k,
                                 strategy=strategy).transform_columns([vec_col], None)
        loco[strategy] = {"top_k": top_k, "rows": [dict(m) for m in out.data]}
    with open(os.path.join(args.out, "loco.json"), "w") as fh:
        json.dump({"rows": LOCO_ROWS, "vector": vec_name, **loco}, fh,
                  separators=(",", ":"), default=_json_default)
    size = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(json.dumps({"out": args.out, "bytes": size, "widths": widths,
                      "winner": states["winner"]["name"],
                      "grid": states["winner"]["grid"], "cv": states["cv"],
                      "mlp_sizes": mlp_sizes(widths + [len(final_kept)])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
