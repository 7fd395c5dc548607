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
plan.  The reference's out-of-core epochs, fault points, stage checkpoints
and workflow-level cross-validation are not ported.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..data.dataset import Dataset
from ..features.feature import Feature
from ..stages.base import Estimator, PipelineStage, Transformer
from .dag import compute_dag
from .plan import fused_transform


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
