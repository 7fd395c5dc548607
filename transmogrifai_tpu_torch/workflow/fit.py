"""DAG fitting and whole-table transforms (counterpart of
``transmogrifai_tpu/workflow/fit.py``).

Stages run in one topologically ordered pass.  Fitted runners (transformers
and the models of estimators already fitted) collect in a pending list; when
an estimator needs a column that a pending runner has still to produce, the
pending runners it needs (those that make its missing inputs, and theirs in
turn) flush through one training-time transform plan
(``workflow/plan.py::fused_transform``): their device prefix runs over the
whole table on ``device`` (every encode slot of the flush in one launch of
the encode kernel), the rest on the host.  The other pending runners wait
for a later flush, so a host stage an estimator needs early (a math
feature) does not split the encode slots over two launches.  The estimator then fits on the
dataset as it stands, and its model joins the pending list.  A last flush
runs what is pending at the end.

:func:`transform_dag` is the scoring twin: every fitted runner, through one
plan.  :func:`workflow_cv_validate` is workflow-level cross-validation: the
label-dependent stages re-fitted inside every fold.  The reference's
out-of-core epochs, fault points, stage checkpoints and sweep journal are
not ported.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import Dataset
from ..features.feature import Feature
from ..stages.base import Estimator, PipelineStage, Transformer
from .dag import compute_dag
from .plan import fused_fold_transforms, fused_transform


def fit_dag(dataset: Dataset, result_features: Sequence[Feature],
            fitted: Optional[Dict[str, Transformer]] = None,
            device=None, profile: Optional[list] = None
            ) -> Tuple[Dataset, Dict[str, Transformer]]:
    """Fit every estimator and apply every transformer.  Returns
    (transformed dataset, {stage uid: fitted transformer}); stages already
    in ``fitted`` are reused.  ``profile``: see :func:`fit_stage_list`."""
    fitted = dict(fitted or {})
    stages = [s for layer in compute_dag(result_features) for s in layer]
    dataset = fit_stage_list(dataset, stages, fitted, device=device,
                             profile=profile)
    return dataset, fitted


def _resolve(stage: PipelineStage, fitted: Dict[str, Transformer]):
    if stage.uid in fitted:
        return fitted[stage.uid]
    if isinstance(stage, Estimator):
        return None
    return stage


def _needed(pending: List[Transformer], stage: PipelineStage,
            dataset: Dataset) -> List[Transformer]:
    """The pending runners that make ``stage``'s inputs missing from
    ``dataset``, and the pending runners those need in turn, in pending
    order."""
    by_output = {r.output_name: r for r in pending}
    need: set = set()
    stack = [f.name for f in stage.inputs if f.name not in dataset]
    while stack:
        runner = by_output.get(stack.pop())
        if runner is None or id(runner) in need:
            continue
        need.add(id(runner))
        stack.extend(f.name for f in runner.inputs if f.name not in dataset)
    return [r for r in pending if id(r) in need]


def fit_stage_list(dataset: Dataset, stages, fitted: Dict[str, Transformer],
                   device=None, profile: Optional[list] = None) -> Dataset:
    """Fit/transform an explicit stage list in topological order; fitted
    models land in ``fitted`` under their estimator's uid.  With ``profile``
    (a list), appends one record per estimator fit (``{"kind": "fit",
    "stage": class name, "seconds": ...}``) and one per flush (the plan's
    timings, :func:`~.plan.fused_transform`)."""
    pending: List[Transformer] = []
    for stage in stages:
        runner = _resolve(stage, fitted)
        if runner is None:
            if pending and any(f.name not in dataset for f in stage.inputs):
                now = _needed(pending, stage, dataset)
                dataset = fused_transform(dataset, now, device, profile)
                pending = [r for r in pending if all(r is not x for x in now)]
            t0 = time.perf_counter()
            runner = stage.fit(dataset, device=device)
            if profile is not None:
                profile.append({"kind": "fit", "stage": type(stage).__name__,
                                "uid": stage.uid,
                                "seconds": time.perf_counter() - t0})
            fitted[stage.uid] = runner
        pending.append(runner)
    if pending:
        dataset = fused_transform(dataset, pending, device, profile)
    return dataset


def transform_dag(dataset: Dataset, result_features: Sequence[Feature],
                  fitted: Dict[str, Transformer], device) -> Dataset:
    """Scoring: apply every fitted runner of the DAG to ``dataset`` through
    one whole-table plan (no fitting; an unfitted estimator raises)."""
    runners = []
    for layer in compute_dag(result_features):
        for stage in layer:
            runner = _resolve(stage, fitted)
            if runner is None:
                raise ValueError(
                    f"Stage {stage.uid} is an unfitted estimator; cannot score. "
                    "Train the workflow first.")
            runners.append(runner)
    return fused_transform(dataset, runners, device)


def workflow_cv_validate(ds_before: Dataset, during, selector, device,
                         profile: Optional[list] = None):
    """In-fold feature engineering CV (counterpart of the reference's
    ``workflow_cv_validate``): for every fold, copies of the label-dependent
    ``during`` stages (uids kept: the fold maps are keyed by uid) fit on the
    fold's training rows only; every fold's fitted stages then transform
    ALL rows (:func:`~.plan.fused_fold_transforms`: all folds' encode slots
    in one launch); and every (family, grid) of the selector sweeps each
    fold's vector on ``device``, the metrics aggregated as the selector's
    own CV does.  Returns the ValidationResult the selector is seeded with.
    With ``profile`` (a list), the fold fits' records carry ``"fold": f``,
    then come the fold transform's record and one ``{"kind": "fold_sweep"}``
    record per fold (host seconds by family)."""
    from ..models.tuning import sweep_families

    label_f, vec_f = selector.inputs[0], selector.inputs[1]
    if label_f.name not in ds_before:
        raise ValueError("workflow CV: label column not materialized before selector")
    y = ds_before[label_f.name].data.astype(np.float32)
    # the selector's own base weights: splitter rebalancing and sample weights
    base_w, _ = (selector.splitter.prepare(y) if selector.splitter is not None
                 else (np.ones_like(y, dtype=np.float32), None))
    if "__sample_weight__" in ds_before:
        base_w = base_w * ds_before["__sample_weight__"].data.astype(np.float32)
    validator = selector.validator
    train_w, val_w = validator.fold_weights(y, base_w)
    k = train_w.shape[0]
    metric_fn = validator.evaluator.metric_fn()

    # the fold fits read only the during stages' inputs (and label, weights)
    fit_cols = {label_f.name, "__sample_weight__"}
    for s in during:
        fit_cols.update(fi.name for fi in s.inputs)
    ds_fit_view = ds_before.select([c for c in ds_before.names if c in fit_cols])

    fold_runner_maps: List[Dict[str, Transformer]] = []
    for f in range(k):
        fold_fitted: Dict[str, Transformer] = {}
        copies = [s.copy() for s in during]
        fold_profile: Optional[list] = [] if profile is not None else None
        fit_stage_list(ds_fit_view.take(np.flatnonzero(train_w[f] > 0)), copies,
                       fold_fitted, device=device, profile=fold_profile)
        if profile is not None:
            profile.extend({**r, "fold": f} for r in fold_profile)
        # plain transformers in the cut have no fitted entry: the copy runs
        fold_runner_maps.append({c.uid: fold_fitted.get(c.uid, c) for c in copies})

    fold_datasets = fused_fold_transforms(
        ds_before, during, fold_runner_maps, device,
        keep=frozenset({vec_f.name}), profile=profile)

    scores: List[List[np.ndarray]] = []
    seconds: Dict[str, float] = {}
    for f in range(k):
        x_f = np.asarray(fold_datasets[f][vec_f.name].data, np.float32)
        t0 = time.perf_counter()
        sc, sec = sweep_families(selector.models, x_f, y, train_w[f:f + 1],
                                 val_w[f:f + 1], metric_fn, device)
        scores.append(sc)
        for name, v in sec.items():
            seconds[name] = seconds.get(name, 0.0) + v
        if profile is not None:
            profile.append({"kind": "fold_sweep", "fold": f,
                            "seconds": time.perf_counter() - t0,
                            "family_seconds": sec, "rows": len(y),
                            "width": int(x_f.shape[1])})
    per_family = [np.concatenate([scores[f][i] for f in range(k)], axis=1)
                  for i in range(len(selector.models))]
    return validator.result(selector.models, per_family, seconds)
