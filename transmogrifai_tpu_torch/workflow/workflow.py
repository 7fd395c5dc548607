"""WorkflowModel — a fitted workflow, loaded for scoring (counterpart of
``transmogrifai_tpu/workflow/workflow.py``, scoring entry points only).

    model = WorkflowModel.load(path)         # a reference-saved model directory
    plan = model.serving_plan()              # on the CUDA card
    rows = plan.score(records)               # [{result name: value}, ...]
    scored = model.score(dataset)            # columnar, returns a Dataset

Every entry point runs on the CUDA card unless ``device`` names another
device (the tests pass ``device="cpu"``); with no card it raises.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from ..data.dataset import Dataset
from ..features.feature import Feature


class WorkflowModel:
    def __init__(self, result_features: Sequence[Feature], fitted: Dict):
        self.result_features: List[Feature] = list(result_features)
        self.fitted = dict(fitted)

    def serving_plan(self, device=None, min_bucket: int = 8,
                     max_bucket: int = 1024):
        """Bind this model to ``device`` for batch scoring
        (:class:`~..serve.plan.CompiledScoringPlan`)."""
        from ..serve.plan import CompiledScoringPlan

        return CompiledScoringPlan(self, device=device, min_bucket=min_bucket,
                                   max_bucket=max_bucket)

    def score(self, dataset: Dataset, device=None) -> Dataset:
        """Score a dataset of raw columns: its raw columns plus the result
        features."""
        out = self.serving_plan(device=device).transform(dataset)
        keep = [f.name for f in self.result_features if f.name in out]
        raw_names = [c for c in dataset.names if c in out.names]
        return out.select(list(dict.fromkeys(raw_names + keep)))

    @staticmethod
    def load(path: str) -> "WorkflowModel":
        from .serde import load_model

        return load_model(path)
