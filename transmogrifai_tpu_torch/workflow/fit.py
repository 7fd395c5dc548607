"""Layer-by-layer DAG fitting (counterpart of ``transmogrifai_tpu/workflow/fit.py``).

Stages run in topological order: an estimator fits on the dataset as it
stands (on ``device``) and its model joins the fitted map; every runner then
transforms the dataset in memory.  The reference's fused transform planner,
out-of-core epochs, fault points and stage checkpoints are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from ..data.dataset import Dataset
from ..features.feature import Feature
from ..stages.base import Estimator, PipelineStage, Transformer
from .dag import compute_dag
from .plan import run_host_stages


def fit_dag(dataset: Dataset, result_features: Sequence[Feature],
            fitted: Optional[Dict[str, Transformer]] = None,
            device=None) -> Tuple[Dataset, Dict[str, Transformer]]:
    """Fit every estimator and apply every transformer, layer by layer.
    Returns (transformed dataset, {stage uid: fitted transformer}); stages
    already in ``fitted`` are reused."""
    fitted = dict(fitted or {})
    stages = [s for layer in compute_dag(result_features) for s in layer]
    dataset = fit_stage_list(dataset, stages, fitted, device=device)
    return dataset, fitted


def _resolve(stage: PipelineStage, fitted: Dict[str, Transformer]):
    if stage.uid in fitted:
        return fitted[stage.uid]
    if isinstance(stage, Estimator):
        return None
    return stage


def fit_stage_list(dataset: Dataset, stages, fitted: Dict[str, Transformer],
                   device=None) -> Dataset:
    """Fit/transform an explicit stage list in topological order; fitted
    models land in ``fitted`` under their estimator's uid."""
    for stage in stages:
        runner = _resolve(stage, fitted)
        if runner is None:
            runner = stage.fit(dataset, device=device)
            fitted[stage.uid] = runner
        dataset = run_host_stages(dataset, [runner], device=device)
    return dataset
