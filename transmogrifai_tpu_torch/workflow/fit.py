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
label-dependent stages re-fitted inside every fold.  Under
``resilient_training`` (``Workflow.train(resume=...)``) a stage fit retries
transient faults (the ``stage_fit`` fault point) and every fold's sweep is a
journaled block; ``on_fit`` hands each fitted model to a stage
checkpointer.

A :class:`~..data.chunked.ChunkedDataset` takes the out-of-core twins
(``workflow/ooc.py``): each flush a chunked epoch (one encode launch per
chunk tile, outputs spilled), each estimator fit over its materialized
input columns only.  ``hbm_budget`` arms the TM601 gate on every plan a fit
runs (``workflow/plan.py::check_plan_hbm_budget``); ``host_budget`` the
TM607 gate on every materialization a chunked fit cannot avoid.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import Dataset
from ..features.feature import Feature
from ..stages.base import Estimator, PipelineStage, Transformer
from .dag import compute_dag
from .plan import fused_fold_transforms, fused_transform


def fit_dag(dataset: Dataset, result_features: Sequence[Feature],
            fitted: Optional[Dict[str, Transformer]] = None,
            device=None, profile: Optional[list] = None,
            on_fit: Optional[Callable[[Transformer], None]] = None,
            hbm_budget: Optional[float] = None,
            host_budget: Optional[float] = None
            ) -> Tuple[Dataset, Dict[str, Transformer]]:
    """Fit every estimator and apply every transformer.  Returns
    (transformed dataset, {stage uid: fitted transformer}); stages already
    in ``fitted`` are reused.  ``profile``, ``on_fit``, the budgets: see
    :func:`fit_stage_list`."""
    fitted = dict(fitted or {})
    stages = [s for layer in compute_dag(result_features) for s in layer]
    dataset = fit_stage_list(dataset, stages, fitted, device=device,
                             profile=profile, on_fit=on_fit,
                             hbm_budget=hbm_budget, host_budget=host_budget)
    return dataset, fitted


def _is_chunked(dataset) -> bool:
    from ..data.chunked import ChunkedDataset

    return isinstance(dataset, ChunkedDataset)


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


def _fit_stage(stage: Estimator, dataset: Dataset, fitted: Dict[str, Transformer],
               device=None, profile: Optional[list] = None,
               on_fit: Optional[Callable[[Transformer], None]] = None) -> Transformer:
    """Fit one estimator on ``dataset`` (retried with bounded backoff under
    ``resilient_training``: a fit is pure given its inputs), as a
    ``fit.<stage>`` phase and a listener's ``fit`` record; its model lands
    in ``fitted`` and goes to ``on_fit``."""
    from ..perf.timers import phase
    from ..serve.faults import fault_point
    from ..utils.listener import stage_timer
    from .plan import operation_name
    from .resilience import retry_call

    def fit_once():
        fault_point("stage_fit", stage=stage.uid)
        return stage.fit(dataset, device=device)

    t0 = time.perf_counter()
    with phase(f"fit.{operation_name(stage)}"), \
            stage_timer(stage, "fit", dataset) as finish:
        runner = retry_call(fit_once, "stage_fit", stage=stage.uid)
        finish(None)
    if profile is not None:
        profile.append({"kind": "fit", "stage": type(stage).__name__,
                        "uid": stage.uid, "seconds": time.perf_counter() - t0})
    fitted[stage.uid] = runner
    if on_fit is not None:
        on_fit(runner)
    return runner


def fit_stage_list(dataset: Dataset, stages, fitted: Dict[str, Transformer],
                   device=None, profile: Optional[list] = None,
                   on_fit: Optional[Callable[[Transformer], None]] = None,
                   hbm_budget: Optional[float] = None,
                   host_budget: Optional[float] = None) -> Dataset:
    """Fit/transform an explicit stage list in topological order; fitted
    models land in ``fitted`` under their estimator's uid, and ``on_fit``
    (when given) receives each as it is fitted.  With ``profile`` (a list),
    appends one record per estimator fit (``{"kind": "fit", "stage": class
    name, "seconds": ...}``) and one per flush (the plan's timings,
    :func:`~.plan.fused_transform`; a chunked epoch's ``{"kind":
    "epoch"}``).  Each fit is a ``fit.<stage>`` phase (``perf/timers.py``)
    and, with a stage-metrics listener active (``utils/listener.py``), a
    ``fit`` record; the flushes report their stages as ``transform``
    records.  A :class:`~..data.chunked.ChunkedDataset` takes
    ``workflow/ooc.py::fit_stage_list_chunked``; ``hbm_budget`` gates every
    flush's plan (TM601), ``host_budget`` a chunked fit's materializations
    (TM607)."""
    if _is_chunked(dataset):
        from .ooc import fit_stage_list_chunked

        return fit_stage_list_chunked(dataset, stages, fitted, on_fit=on_fit,
                                      hbm_budget=hbm_budget,
                                      host_budget=host_budget, device=device,
                                      profile=profile)
    pending: List[Transformer] = []
    for stage in stages:
        runner = _resolve(stage, fitted)
        if runner is None:
            if pending and any(f.name not in dataset for f in stage.inputs):
                now = _needed(pending, stage, dataset)
                dataset = fused_transform(dataset, now, device, profile,
                                          hbm_budget=hbm_budget)
                pending = [r for r in pending if all(r is not x for x in now)]
            runner = _fit_stage(stage, dataset, fitted, device=device,
                                profile=profile, on_fit=on_fit)
        pending.append(runner)
    if pending:
        dataset = fused_transform(dataset, pending, device, profile,
                                  hbm_budget=hbm_budget)
    return dataset


def _runners(result_features: Sequence[Feature],
             fitted: Dict[str, Transformer]) -> List[Transformer]:
    """Every fitted runner of the DAG in topological order (an unfitted
    estimator raises)."""
    runners = []
    for layer in compute_dag(result_features):
        for stage in layer:
            runner = _resolve(stage, fitted)
            if runner is None:
                raise ValueError(
                    f"Stage {stage.uid} is an unfitted estimator; cannot score. "
                    "Train the workflow first.")
            runners.append(runner)
    return runners


def transform_dag(dataset: Dataset, result_features: Sequence[Feature],
                  fitted: Dict[str, Transformer], device) -> Dataset:
    """Scoring: apply every fitted runner of the DAG to ``dataset`` through
    one whole-table plan (no fitting; an unfitted estimator raises).  A
    :class:`~..data.chunked.ChunkedDataset` goes chunk by chunk through
    one epoch (``workflow/ooc.py::transform_dag_chunked``) and comes back
    chunked."""
    if _is_chunked(dataset):
        from .ooc import transform_dag_chunked

        return transform_dag_chunked(dataset, result_features, fitted, device)
    return fused_transform(dataset, _runners(result_features, fitted), device)


def workflow_cv_validate(ds_before: Dataset, during, selector, device,
                         profile: Optional[list] = None,
                         hbm_budget: Optional[float] = None,
                         host_budget: Optional[float] = None):
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
    record per fold (host seconds by family).  A chunked ``ds_before``
    materializes exactly the ``during`` stages' inputs, the label, the
    vector and ``__sample_weight__``, behind the TM607 gate of
    ``host_budget``; ``hbm_budget`` gates the fold fits' flushes and the
    fold transform (TM601)."""
    from ..models.tuning import sweep_families

    label_f, vec_f = selector.inputs[0], selector.inputs[1]
    if _is_chunked(ds_before):
        from .ooc import _gate_fit_residency

        need = {label_f.name, vec_f.name, "__sample_weight__"}
        for s in during:
            need.update(fi.name for fi in s.inputs)
        names = [n for n in ds_before.names if n in need]
        _gate_fit_residency(ds_before, selector, names, host_budget)
        ds_before = ds_before.materialize(names)
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
                       fold_fitted, device=device, profile=fold_profile,
                       hbm_budget=hbm_budget)
        if profile is not None:
            profile.extend({**r, "fold": f} for r in fold_profile)
        # plain transformers in the cut have no fitted entry: the copy runs
        fold_runner_maps.append({c.uid: fold_fitted.get(c.uid, c) for c in copies})

    fold_datasets = fused_fold_transforms(
        ds_before, during, fold_runner_maps, device,
        keep=frozenset({vec_f.name}), profile=profile, hbm_budget=hbm_budget)

    scores: List[List[np.ndarray]] = []
    seconds: Dict[str, float] = {}
    for f in range(k):
        x_f = np.asarray(fold_datasets[f][vec_f.name].data, np.float32)
        t0 = time.perf_counter()
        sc, sec = sweep_families(
            selector.models, x_f, y, train_w[f:f + 1], val_w[f:f + 1],
            metric_fn, device,
            fold_spec=(validator.num_folds, validator.seed, validator.stratify),
            metric_name=validator.evaluator.default_metric, block=f"fold{f}")
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
