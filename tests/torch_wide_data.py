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


def wide_pipeline(pkg, ftypes, schema, num_folds: int = 2, models=None):
    """(label, selector, checker, prediction) of the fixture's pipeline in
    ``pkg``, a namespace with the package's ``FeatureBuilder``,
    ``transmogrify``, ``BinaryClassificationModelSelector`` and
    ``LogisticRegression`` (either package: the pipeline is written the
    same way in both).  ``models``: the selector's (estimator, grids)
    pairs, by default LR over reg_param 0.01 and 0.1."""
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
        models=models or [(pkg.LogisticRegression(),
                           [{"reg_param": 0.01}, {"reg_param": 0.1}])])
    pred = label.transform_with(sel, checked)
    return label, sel, checked.origin_stage, pred


#: workflow CV over the wide pipeline: 3 folds, LR's two grid points and an
#: MLP with one hidden layer of 10 (the reference's default network)
WCV_FOLDS = 3
WCV_MLP_GRIDS = ({"hidden_layers": (10,)},)


def wcv_models(pkg):
    """The workflow-CV selector's families in ``pkg`` (a namespace with
    ``LogisticRegression`` and ``MultilayerPerceptronClassifier``)."""
    return [(pkg.LogisticRegression(), [{"reg_param": 0.01}, {"reg_param": 0.1}]),
            (pkg.MultilayerPerceptronClassifier(), [dict(g) for g in WCV_MLP_GRIDS])]


# -- the DSL features over the wide table ----------------------------------------

#: NumericBucketizer splits of the 8 fixed-split features: the even ones over
#: +-inf edges without track_invalid, the odd ones finite with track_invalid
DSL_SPLITS = ((float("-inf"), -0.5, 0.0, 0.5, float("inf")), (-1.0, 0.0, 1.0))


def score_column(n: int, seed: int = 0) -> list:
    """A non-null RealNN predictor for the PercentileCalibrator (the wide
    table has none): standard normal from ``default_rng(seed + 1)``."""
    return np.random.default_rng(seed + 1).normal(size=n).tolist()


def head_level(v) -> bool:
    """The exists predicate: a pick-list value at one of the top levels."""
    return v is not None and v[-2:] in ("00", "01")


def level_number(v):
    """The map_to function: a pick-list level's number, as a Real."""
    return None if v is None else float(v[-2:])


def dsl_pipeline(pkg, ftypes, schema, num_folds: int = 2):
    """(label, selector, checker, prediction) of the wide pipeline with the
    DSL's features added, in ``pkg`` (either package's module): the raw
    columns and 8 auto-bucketized Reals as in :func:`wide_pipeline`, plus 8
    fixed-split ``NumericBucketizer`` features over Reals that are not
    auto-bucketized (:data:`DSL_SPLITS`), 8 pairwise ``+ - * /`` features,
    ``to_occur`` on 2 pick lists and ``exists`` on 2 more, a
    ``PercentileCalibrator`` over the RealNN ``score`` column
    (:func:`score_column`), an ``alias`` and a ``map_to``; then transmogrify
    -> sanity_check -> the 2-fold LR selector."""
    import importlib

    scal = importlib.import_module(pkg.__name__ + ".ops.scalers")
    lr = importlib.import_module(pkg.__name__ + ".models.logistic").LogisticRegression
    label = pkg.FeatureBuilder.of("label", ftypes["label"]).extract_field() \
        .as_response()
    preds = {s["name"]: pkg.FeatureBuilder.of(s["name"], ftypes[s["name"]])
             .extract_field().as_predictor()
             for s in schema if not s.get("response")}
    score = pkg.FeatureBuilder.of("score", ftypes["score"]).extract_field() \
        .as_predictor()
    reals = [s["name"] for s in schema if s["type"] == "Real" and not s["bucketized"]]
    picks = [s["name"] for s in schema if s["type"] == "PickList"]
    buckets = [preds[s["name"]].auto_bucketize(label)
               for s in schema if s.get("bucketized")]
    fixed = [preds[r].transform_with(scal.NumericBucketizer(
        splits=DSL_SPLITS[j % 2], track_invalid=bool(j % 2)))
        for j, r in enumerate(reals[:8])]
    a, b = [preds[r] for r in reals[8:24:2]], [preds[r] for r in reals[9:24:2]]
    math = [a[0] + b[0], a[1] - b[1], a[2] * b[2], a[3] / b[3],
            a[4] + b[4], a[5] - b[5], a[6] * b[6], a[7] / b[7]]
    values = [preds[picks[0]].to_occur(), preds[picks[1]].to_occur(),
              preds[picks[2]].exists(head_level), preds[picks[3]].exists(head_level),
              score.transform_with(scal.PercentileCalibrator(buckets=10)),
              preds[reals[24]].alias(reals[24] + "_alias"),
              preds[picks[4]].map_to(level_number, ftypes[reals[0]], name="level")]
    vec = pkg.transmogrify(list(preds.values()) + buckets + fixed + math + values)
    checked = label.sanity_check(vec)
    sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds,
        models=[(lr(), [{"reg_param": 0.01}, {"reg_param": 0.1}])])
    pred = label.transform_with(sel, checked)
    return label, sel, checked.origin_stage, pred


# -- workflow-level CV over the wide pipeline ----------------------------------

def vector_digest(block) -> dict:
    """Shape and sha256 of a vector block's float32 C-order bytes."""
    import hashlib

    a = np.ascontiguousarray(np.asarray(block, np.float32))
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def fold_states(runner_maps, fold_datasets, vec_name: str) -> list:
    """Per fold of a workflow-CV run: its bucketizers' splits by input name,
    its checker's kept indices and its vector's digest."""
    out = []
    for runners, ds in zip(runner_maps, fold_datasets):
        splits, kept = {}, None
        for r in runners.values():
            cls = type(r).__name__
            if cls == "DecisionTreeNumericBucketizerModel":
                splits[r.inputs[1].name] = [float(s) for s in r.splits]
            elif cls == "SanityCheckerModel":
                kept = [int(j) for j in r.kept_indices]
        out.append({"splits": dict(sorted(splits.items())), "kept": kept,
                    "vector": vector_digest(ds[vec_name].data)})
    return out


def mlp_sizes(widths, classes: int = 2) -> list:
    """The (d, hidden..., classes) network sizes of the workflow-CV MLP
    grids over vectors of the given widths."""
    return sorted({(int(d), *g["hidden_layers"], classes)
                   for d in widths for g in WCV_MLP_GRIDS})


def mlp_key(sizes, seed: int, layer: int, part: str) -> str:
    """The record's array name of one initial draw."""
    return "mlp_" + "x".join(str(s) for s in sizes) + f"_s{seed}_l{layer}_{part}"


def insights_deviation(a, b, skip=frozenset(), path: str = "", seen=None) -> float:
    """The largest relative deviation |x - y| / max(1, |x|) between the
    floats of two ``ModelInsights.to_dict()`` trees (NaN equal to NaN);
    raises AssertionError on any other difference (keys, lengths, names,
    strings, None).  Keys in ``skip`` are not compared.  ``seen`` (a list)
    collects (deviation, path) of every float that differs."""
    import math

    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        return max([insights_deviation(a[k], b[k], skip, f"{path}.{k}", seen)
                    for k in a if k not in skip] or [0.0])
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        return max([insights_deviation(x, y, skip, f"{path}[{i}]", seen)
                    for i, (x, y) in enumerate(zip(a, b))] or [0.0])
    if isinstance(a, float) and isinstance(b, (int, float)) \
            and not isinstance(b, bool):
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), path
            return 0.0
        dev = abs(a - b) / max(1.0, abs(a))
        if seen is not None and dev > 0:
            seen.append((dev, path))
        return dev
    assert a == b, (path, a, b)
    return 0.0


def _rank(v, strategy: str) -> float:
    if strategy == "positive":
        return v[-1]
    if strategy == "negative":
        return -v[-1]
    return max(abs(c) for c in v)


def loco_deviation(want_rows, got_rows, strategy: str, tie: float = 1e-9) -> float:
    """The largest absolute deviation between two runs' LOCO maps (JSON
    lists by name, ranked), row by row: the ordered names must be equal
    wherever the ranked values differ by more than ``tie``
    (AssertionError otherwise); the values are compared name by name."""
    import json

    assert len(want_rows) == len(got_rows)
    dev = 0.0
    for want, got in zip(want_rows, got_rows):
        w = {k: json.loads(v) for k, v in want.items()}
        g = {k: json.loads(v) for k, v in got.items()}
        assert len(w) == len(g)
        for (wn, wv), (gn, gv) in zip(w.items(), g.items()):
            if wn != gn:
                gap = abs(_rank(wv, strategy) - _rank(gv, strategy))
                assert gap <= tie, (wn, gn, gap)
                continue
            dev = max(dev, max(abs(a - b) for a, b in zip(wv, gv)))
    return dev


def mlp_fold_cv(selector, fold_datasets, device, **params) -> np.ndarray:
    """(grid, fold) CV metrics of the port's MLP over the WCV_MLP_GRIDS
    (each grid point updated by ``params``), swept on each fold's vector of
    a workflow-CV run as the run's own sweep does (the selector's splitter
    weights, folds and metric); ``fold_datasets`` may hold the first folds
    only."""
    from transmogrifai_tpu_torch.models.mlp import MultilayerPerceptronClassifier
    from transmogrifai_tpu_torch.models.tuning import sweep_families

    y = fold_datasets[0][selector.inputs[0].name].data.astype(np.float32)
    base_w, _ = (selector.splitter.prepare(y) if selector.splitter is not None
                 else (np.ones_like(y), None))
    train_w, val_w = selector.validator.fold_weights(y, base_w)
    metric_fn = selector.validator.evaluator.metric_fn()
    grids = [dict(g, **params) for g in WCV_MLP_GRIDS]
    out = []
    for f, ds in enumerate(fold_datasets):
        x = np.asarray(ds[selector.inputs[1].name].data, np.float32)
        scores, _ = sweep_families([(MultilayerPerceptronClassifier(), grids)], x, y,
                                   train_w[f:f + 1], val_w[f:f + 1], metric_fn, device)
        out.append(scores[0][:, 0])
    return np.stack(out, axis=1)


def split_family_cv(insights: dict, family: str):
    """(a copy of a ``ModelInsights.to_dict()`` tree without ``family``'s CV
    metric values and means under selectedModelInfo.validationResults,
    those floats in order)."""
    import copy

    out = copy.deepcopy(insights)
    taken: list = []
    for r in out.get("selectedModelInfo", {}).get("validationResults", []):
        if r.get("modelName") == family:
            taken.extend(r.pop("values"))
            taken.append(r.pop("mean"))
    return out, taken


def wide_wcv_run(record_dir: str) -> dict:
    """The port's workflow-CV train of the wide pipeline on the record's
    rows (``fixtures/workflow_cv``; the MLP's initial draws fed from the
    record), on the CPU, as plain data: every fold's states, the cut, the
    CV rows, the winner's coefficients, the final kept indices, the fold
    transform's record; and the MLP swept again on the run's fold vectors
    (as run, and fold 0 with 10 Adam steps short and with lr 0.049)."""
    import json
    import os

    import torch

    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch.models import mlp as TM
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow import fit as TFit
    from transmogrifai_tpu_torch.workflow.dag import cut_dag

    with open(os.path.join(record_dir, "states.json")) as fh:
        states = json.load(fh)
    with np.load(os.path.join(record_dir, "mlp_init.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}

    def draws(sizes, seed, device):
        return [(torch.from_numpy(arrays[mlp_key(sizes, seed, i, "w")].copy()).to(device),
                 torch.from_numpy(arrays[mlp_key(sizes, seed, i, "b")].copy()).to(device))
                for i in range(len(sizes) - 1)]

    cols, schema = make_data(states["rows"], seed=states["seed"], **states["shape"])
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    label, sel, _, pred = wide_pipeline(T, ftypes, schema, WCV_FOLDS, wcv_models(T))
    captured = {}
    real = TFit.fused_fold_transforms

    def capture(dataset, during, maps, *a, **kw):
        out = real(dataset, during, maps, *a, **kw)
        captured["maps"], captured["datasets"] = maps, out
        return out

    own = TM.draw_mlp_init
    TM.draw_mlp_init, TFit.fused_fold_transforms = draws, capture
    try:
        wf = T.Workflow().set_input_dataset(T.Dataset.from_features(cols, ftypes)) \
            .set_result_features(label, pred).with_workflow_cv()
        model = wf.train(device="cpu")
        folds = captured["datasets"]
        again = mlp_fold_cv(sel, folds, "cpu")
        controls = {"190_steps": mlp_fold_cv(sel, folds[:1], "cpu", max_iter=190),
                    "lr_0.049": mlp_fold_cv(sel, folds[:1], "cpu", learning_rate=0.049)}
    finally:
        TM.draw_mlp_init, TFit.fused_fold_transforms = own, real
    summary = model.summary()
    win = model.selector_model().model
    before, during, _ = cut_dag([label, pred])
    [ft] = [r for r in wf.last_train_profile if r["kind"] == "fold_transform"]
    return {
        "folds": fold_states(captured["maps"], folds, sel.inputs[1].name),
        "before": [type(s).__name__ for s in before],
        "during": [type(s).__name__ for s in during],
        "cv": [{"model": e.model_name, "values": [float(v) for v in e.metric_values],
                "grid": {k: list(v) if isinstance(v, tuple) else v
                         for k, v in e.grid.items()}}
               for e in summary.validation_results],
        "winner": {"name": summary.best_model_name, "grid": summary.best_grid,
                   "coef": np.asarray(win.coef, np.float64).tolist(),
                   "intercept": float(win.intercept)},
        "final_kept": [int(j) for j in next(
            t.kept_indices for t in model.fitted.values()
            if type(t).__name__ == "SanityCheckerModel")],
        "fold_transform": {"plans": ft["plans"], "encode_slots": ft["encode_slots"]},
        "split_slots": sum(1 for m in captured["maps"] for r in m.values()
                           if type(r).__name__ == "DecisionTreeNumericBucketizerModel"
                           and r.should_split),
        "mlp_again": again.tolist(),
        "mlp_controls": {k: v.tolist() for k, v in controls.items()}}
