"""Workflow and WorkflowModel (counterpart of ``transmogrifai_tpu/workflow/workflow.py``).

Training from raw typed columns::

    vec = transmogrify([*predictors, *[r.auto_bucketize(label) for r in reals]])
    pred = label.transform_with(
        BinaryClassificationModelSelector.with_cross_validation(),
        label.sanity_check(vec))
    wf = Workflow().set_input_dataset(ds).set_result_features(label, pred)
    model = wf.train()                       # fits on the CUDA card

Scoring a fitted or loaded model::

    model = WorkflowModel.load(path)         # a saved model directory
    plan = model.serving_plan()              # on the CUDA card
    rows = plan.score(records)               # [{result name: value}, ...]
    scored = model.score(dataset)            # columnar, returns a Dataset
    metrics = model.evaluate(Evaluators.binary_classification(), dataset)
    model.save(path)                         # the JAX package loads it too

Every entry point takes the reference's parameters in the reference's order,
and ``device`` by keyword only: it runs on the CUDA card unless ``device``
names another device (the tests pass ``device="cpu"``); with no card it
raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..data.dataset import Dataset
from ..evaluators.base import Evaluator
from ..features.feature import Feature
from .dag import compute_dag


class Workflow:
    """DAG of stages reached from the result features; ``train()`` fits it."""

    def __init__(self):
        self.result_features: List[Feature] = []
        self._input_dataset: Optional[Dataset] = None
        #: records of the last ``train()``: one per estimator fit and one per
        #: transform flush (``workflow/fit.py::fit_stage_list``)
        self.last_train_profile: List[dict] = []

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

    def train(self, test_fraction: float = 0.0, seed: int = 42,
              checkpointer=None, strict: bool = False,
              hbm_budget: Optional[float] = None,
              host_budget: Optional[float] = None, telemetry=None,
              resume: Optional[str] = None, *, device=None) -> "WorkflowModel":
        """Fit the DAG on ``device`` (the CUDA card unless the caller names
        another).  The parameters are the reference's, in its order.  With
        ``test_fraction`` > 0 the input splits first (``Dataset.split`` by
        ``seed``, the reference's draw): the DAG fits on the train part and
        the model selector's summary gets the metrics of the held-out part
        (``holdout_evaluation``).  The reference's checkpointing, strict
        validation, device-memory budget, host budget, telemetry and resume
        are not ported: each raises ``NotImplementedError`` by name when
        asked for."""
        from ..perf.kernels.dispatch import resolve_device
        from .fit import fit_dag

        _refuse_unported("Workflow.train", {
            "checkpointer": checkpointer is not None, "strict": bool(strict),
            "hbm_budget": hbm_budget is not None,
            "host_budget": host_budget is not None,
            "telemetry": telemetry is not None, "resume": resume is not None})
        if not self.result_features:
            raise ValueError("set_result_features before train()")
        dev = resolve_device(device)
        raw = self.generate_raw_data()
        test_ds = None
        if test_fraction > 0.0:
            raw, test_ds = raw.split(test_fraction, seed=seed)
        profile: List[dict] = []
        _, fitted = fit_dag(raw, self.result_features, device=dev, profile=profile)
        self.last_train_profile = profile
        model = WorkflowModel(result_features=self.result_features, fitted=fitted)
        if test_ds is not None and test_ds.n_rows > 0:
            model._evaluate_holdout(test_ds, dev)
        return model


def _refuse_unported(entry: str, asked: Dict[str, bool]) -> None:
    """Raise ``NotImplementedError`` naming every parameter of ``entry``
    given a value the port does not implement."""
    unported = [k for k, v in asked.items() if v]
    if unported:
        raise NotImplementedError(
            f"{entry}: {', '.join(unported)} not ported to "
            "transmogrifai_tpu_torch yet")


class WorkflowModel:
    def __init__(self, result_features: Sequence[Feature], fitted: Dict):
        self.result_features: List[Feature] = list(result_features)
        self.fitted = dict(fitted)

    def serving_plan(self, min_bucket: int = 8, max_bucket: int = 1024,
                     strict: bool = True, hbm_budget: Optional[float] = None,
                     *, device=None):
        """Bind this model to ``device`` for batch scoring
        (:class:`~..serve.plan.CompiledScoringPlan`).  Whatever ``strict``
        says, the plan checks only that every estimator is fitted (TM501):
        the reference's servability validator is not ported, nor is its
        device-memory admission gate, ``hbm_budget``."""
        from ..serve.plan import CompiledScoringPlan

        _refuse_unported("WorkflowModel.serving_plan",
                         {"hbm_budget": hbm_budget is not None})
        return CompiledScoringPlan(self, device=device, min_bucket=min_bucket,
                                   max_bucket=max_bucket)

    def score(self, dataset: Optional[Dataset] = None,
              keep_intermediate: bool = False, *, device=None) -> Dataset:
        """Score a dataset of raw columns through one whole-table transform
        plan (``workflow/fit.py::transform_dag``): its raw columns plus the
        result features, or every stage's output with ``keep_intermediate``.
        The reference's reader (``dataset=None``) is not ported."""
        from ..perf.kernels.dispatch import resolve_device
        from .fit import transform_dag

        dev = resolve_device(device)
        _refuse_unported("WorkflowModel.score", {"dataset=None": dataset is None})
        out = transform_dag(dataset, self.result_features, self.fitted, dev)
        if keep_intermediate:
            return out
        keep = [f.name for f in self.result_features if f.name in out]
        raw_names = [c for c in dataset.names if c in out.names]
        return out.select(list(dict.fromkeys(raw_names + keep)))

    @staticmethod
    def _check_eval_args(evaluator, dataset):
        """Forgive swapped (dataset, evaluator) order; fail fast on bad types."""
        if isinstance(evaluator, Dataset) and isinstance(dataset, Evaluator):
            evaluator, dataset = dataset, evaluator
        if not isinstance(evaluator, Evaluator):
            raise TypeError(
                f"expected an Evaluator (e.g. Evaluators.binary_classification()), "
                f"got {type(evaluator).__name__}: call evaluate(evaluator, dataset)")
        return evaluator, dataset

    def evaluate(self, evaluator: Evaluator, dataset: Optional[Dataset] = None,
                 *, device=None) -> Dict[str, float]:
        """Score ``dataset`` and evaluate the prediction against its label."""
        return self.score_and_evaluate(evaluator, dataset, device=device)[1]

    def score_and_evaluate(self, evaluator: Evaluator,
                           dataset: Optional[Dataset] = None, *, device=None):
        """(the scored result features, the metrics) of one scoring pass."""
        evaluator, dataset = self._check_eval_args(evaluator, dataset)
        label, pred = self._label_and_pred()
        scored = self.score(dataset, keep_intermediate=True, device=device)
        metrics = evaluator.evaluate(scored, label.name, pred.name)
        keep = [f.name for f in self.result_features if f.name in scored]
        return scored.select(keep), metrics

    def selector_model(self):
        """The fitted model selector's stage, or None."""
        from ..models.selector import SelectedModel

        return next((t for t in self.fitted.values() if isinstance(t, SelectedModel)),
                    None)

    def _evaluate_holdout(self, test_ds: Dataset, device) -> None:
        """The selector summary's ``holdout_evaluation``: the held-out rows
        scored and evaluated by the problem's evaluator (binary for two
        class probabilities, multiclass for more, else regression)."""
        from ..evaluators.base import (
            BinaryClassificationEvaluator,
            MultiClassificationEvaluator,
            RegressionEvaluator,
        )
        from .fit import transform_dag

        try:
            label, pred = self._label_and_pred()
        except ValueError:
            return
        selected = self.selector_model()
        if selected is None:
            return
        scored = transform_dag(test_ds, self.result_features, self.fitted, device)
        prob = getattr(scored[pred.name], "prob", None)
        n_classes = None if prob is None else prob.shape[1]
        if n_classes == 2:
            ev = BinaryClassificationEvaluator()
        elif n_classes is not None and n_classes > 2:
            ev = MultiClassificationEvaluator()
        else:
            ev = RegressionEvaluator()
        selected.summary.holdout_evaluation = ev.evaluate(scored, label.name, pred.name)

    def _label_and_pred(self):
        label = next((f for f in self.result_features if f.is_response), None)
        pred = next((f for f in self.result_features
                     if f.ftype.__name__ == "Prediction"), None)
        if label is None or pred is None:
            raise ValueError(
                "evaluate() needs a response feature and a Prediction result feature")
        return label, pred

    def save(self, path: str) -> None:
        """Write the model in the reference's format (``model.json.gz`` +
        ``arrays.npz``, FORMAT_VERSION 1): this package and the JAX package
        both load it."""
        from .serde import save_model

        save_model(self, path)

    @staticmethod
    def load(path: str) -> "WorkflowModel":
        from .serde import load_model

        return load_model(path)
