"""score_function — bind a fitted WorkflowModel into a record-level closure
(counterpart of ``transmogrifai_tpu/local/scoring.py``).

Reference: local/.../OpWorkflowModelLocal.scala:93-200: partition stages into row
transformers vs wrapped models (:101-108), convert models to local functions
(:154-200), and return ``Map[String,Any] => Map[String,Any]`` (:117-135).

Everything that does not depend on the records is bound when the scorer is
made: the raw feature generators, the DAG's order, its fitted runners, and
the whole-table transform plan with its executor
(``workflow/plan.py::ColumnarTransformPlan`` / ``JointPrefix``: the
partition into the device prefix and the host remainder, the wiring and
the encode slot table).  ``batch(records)`` then extracts the raw columns
as scoring does and runs that plan on the card: one encode launch a batch,
the same plan ``WorkflowModel.score`` builds (``workflow/fit.py::
transform_dag``), so the outputs equal its.  ``scorer(record)`` is
``batch([record])[0]``.  No tensor reaches the caller: every value is
plain Python.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..data.dataset import Dataset
from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..perf.kernels.dispatch import resolve_device
from ..readers.base import extract_columns
from ..workflow.dag import compute_dag
from ..workflow.fit import _resolve
from ..workflow.plan import ColumnarTransformPlan, JointPrefix, run_host_stages


def bound_generators(result_features: Sequence[Feature]) -> List[FeatureGeneratorStage]:
    """The raw features' generator stages, each once, in the order the
    result features reach them."""
    out: List[FeatureGeneratorStage] = []
    seen = set()
    for f in result_features:
        for raw in f.raw_features():
            st = raw.origin_stage
            if isinstance(st, FeatureGeneratorStage) and st.uid not in seen:
                seen.add(st.uid)
                out.append(st)
    return out


class LocalScorer:
    """Callable scorer: ``scorer(record) -> {result feature name: value}``,
    and ``batch(records)`` for a list of records in one columnar pass, on
    ``device`` (the CUDA card unless it names another; no card raises)."""

    def __init__(self, model, *, device=None):
        self.device = resolve_device(device)
        self._result_features: List[Feature] = list(model.result_features)
        self._named = [(g.raw_name, g)
                       for g in bound_generators(self._result_features)]
        self._runners = []
        for stage in (s for layer in compute_dag(self._result_features)
                      for s in layer):
            runner = _resolve(stage, model.fitted)
            if runner is None:
                raise ValueError(
                    f"Stage {stage.uid} is an unfitted estimator; cannot score locally")
            self._runners.append(runner)
        #: the raw columns a batch carries (a batch may lack the label) ->
        #: (the transform plan, its executor, the host remainder)
        self._plans: Dict[frozenset, tuple] = {}
        self._plan_for(frozenset(name for name, g in self._named if not g.is_response))

    def _plan_for(self, names: frozenset):
        bound = self._plans.get(names)
        if bound is None:
            plan = ColumnarTransformPlan(self._runners, names, self.device)
            joint = JointPrefix([plan]) if plan._prefix else None
            bound = self._plans[names] = (plan, joint, plan.remainder)
        return bound

    # -- single record (the reference scoreFunction shape) -------------------
    def __call__(self, record: Mapping[str, Any]) -> Dict[str, Any]:
        return self.batch([record])[0]

    # -- columnar batch ------------------------------------------------------
    def batch(self, records: Sequence[Mapping[str, Any]]) -> List[Dict[str, Any]]:
        if not records:  # nothing to score: skip the zero-row Dataset walk
            return []
        # the label may be absent at inference time: the model stages never
        # read it (scoring without a label, as the engine does)
        ds = Dataset(extract_columns(records, self._named,
                                     allow_missing_response=True))
        _, joint, remainder = self._plan_for(frozenset(ds.names))
        if joint is not None:
            (ds,) = joint.apply_prefix(ds)
        ds = run_host_stages(ds, remainder, device=self.device)
        out: List[Dict[str, Any]] = [{} for _ in records]
        for f in self._result_features:
            if f.name not in ds:
                continue
            for i, v in enumerate(ds[f.name].to_values()):
                out[i][f.name] = _plain(v)
        return out


def _plain(v: Any):
    """numpy scalars and arrays and torch tensors -> plain Python for the
    Map[String,Any] contract (a dict's values one by one): a device
    tensor must never leak to a serving caller."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def score_function(model, *, device=None) -> LocalScorer:
    """Bind ``model`` into a local scorer (OpWorkflowModelLocal.scoreFunction)
    on ``device`` (the CUDA card unless it names another)."""
    return LocalScorer(model, device=device)
