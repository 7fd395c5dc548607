"""Workflow and WorkflowModel (counterpart of ``transmogrifai_tpu/workflow/workflow.py``).

Training::

    wf = Workflow().set_input_dataset(ds).set_result_features(label, pred)
    model = wf.train()                       # fits on the CUDA card

Scoring a fitted or loaded model::

    model = WorkflowModel.load(path)         # a reference-saved model directory
    plan = model.serving_plan()              # on the CUDA card
    rows = plan.score(records)               # [{result name: value}, ...]
    scored = model.score(dataset)            # columnar, returns a Dataset

Every entry point runs on the CUDA card unless ``device`` names another
device (the tests pass ``device="cpu"``); with no card it raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..data.dataset import Dataset
from ..features.feature import Feature
from .dag import compute_dag


class Workflow:
    """DAG of stages reached from the result features; ``train()`` fits it."""

    def __init__(self):
        self.result_features: List[Feature] = []
        self._input_dataset: Optional[Dataset] = None

    def set_result_features(self, *features: Feature) -> "Workflow":
        self.result_features = list(features)
        seen: Dict[str, object] = {}
        for layer in compute_dag(self.result_features):
            for stage in layer:
                if seen.get(stage.uid, stage) is not stage:
                    raise ValueError(f"[TM102] Duplicate stage uid in DAG: {stage.uid}")
                seen[stage.uid] = stage
        return self

    def set_input_dataset(self, ds: Dataset) -> "Workflow":
        self._input_dataset = ds
        return self

    def with_raw_feature_filter(self, rff) -> "Workflow":
        raise NotImplementedError(
            "the raw feature filter is not ported to transmogrifai_tpu_torch yet")

    def raw_features(self) -> List[Feature]:
        out: Dict[str, Feature] = {}
        for f in self.result_features:
            for r in f.raw_features():
                out.setdefault(r.uid, r)
        return list(out.values())

    def generate_raw_data(self) -> Dataset:
        if self._input_dataset is None:
            raise ValueError("No input data: call set_input_dataset first")
        ds = self._input_dataset
        missing = [f.name for f in self.raw_features() if f.name not in ds]
        if missing:
            raise KeyError(f"Input dataset is missing raw feature columns: {missing}")
        return ds

    def train(self, seed: int = 42, device=None, test_fraction: float = 0.0,
              strict: bool = False, host_budget=None, telemetry=None,
              resume=None, checkpointer=None) -> "WorkflowModel":
        """Fit the DAG on ``device`` (the CUDA card unless the caller names
        another).  ``seed`` is accepted for the reference's signature; the
        stages' own seeds drive their draws.  The reference's test split,
        strict validation, host budget, telemetry, resume and checkpointing
        are not ported and raise when asked for."""
        from ..perf.kernels.dispatch import resolve_device
        from .fit import fit_dag

        asked = {"test_fraction": test_fraction > 0.0, "strict": strict,
                 "host_budget": host_budget is not None,
                 "telemetry": telemetry is not None,
                 "resume": resume is not None,
                 "checkpointer": checkpointer is not None}
        unported = [k for k, v in asked.items() if v]
        if unported:
            raise NotImplementedError(
                f"Workflow.train option(s) {unported} are not ported to "
                "transmogrifai_tpu_torch yet")
        if not self.result_features:
            raise ValueError("set_result_features before train()")
        dev = resolve_device(device)
        raw = self.generate_raw_data()
        _, fitted = fit_dag(raw, self.result_features, device=dev)
        return WorkflowModel(result_features=self.result_features, fitted=fitted)


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
