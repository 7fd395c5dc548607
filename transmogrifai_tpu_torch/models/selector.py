"""ModelSelector — model and hyperparameter selection by cross-validation
(counterpart of ``transmogrifai_tpu/models/selector.py``).

``fit`` runs the reference's four steps on one device: data prep (the
splitter's weights), validation of every (family, grid) over the folds or
one train/validation split, refit of the winner on all training rows, and
the winner's train (and reserved holdout) metrics.  Each problem type has
the reference's factory with its default families and grids:
``BinaryClassificationModelSelector`` (LogisticRegression, RandomForest,
GBT, LinearSVC; a DataBalancer), ``MultiClassificationModelSelector``
(multinomial LogisticRegression, RandomForest, DecisionTree, NaiveBayes; a
DataCutter) and ``RegressionModelSelector`` (LinearRegression,
RandomForest, GBT, GLM gaussian; a DataSplitter).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Column
from ..evaluators.base import (
    BinaryClassificationEvaluator,
    Evaluator,
    Evaluators,
    MultiClassificationEvaluator,
    RegressionEvaluator,
)
from .base import PredictionEstimatorBase, PredictionModelBase
from .prediction import PredictionColumn
from .tuning import (
    CrossValidator,
    DataBalancer,
    DataCutter,
    DataSplitter,
    ModelEvaluation,
    PrepSummary,
    TrainValidationSplit,
    ValidationResult,
)


@dataclass
class ModelSelectorSummary:
    """Validation results, the winner, data prep and train/holdout metrics."""

    validation_type: str = "cv"
    validation_results: List[ModelEvaluation] = field(default_factory=list)
    best_model_name: str = ""
    best_model_uid: str = ""
    best_grid: Dict[str, Any] = field(default_factory=dict)
    metric_name: str = ""
    larger_is_better: bool = True
    data_prep: Optional[PrepSummary] = None
    train_evaluation: Dict[str, float] = field(default_factory=dict)
    holdout_evaluation: Dict[str, float] = field(default_factory=dict)
    failed_models: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "validationType": self.validation_type,
            "bestModelName": self.best_model_name,
            "bestModelUID": self.best_model_uid,
            "bestGrid": self.best_grid,
            "metricName": self.metric_name,
            "failedModels": self.failed_models,
            "dataPrep": vars(self.data_prep) if self.data_prep else None,
            "trainEvaluation": self.train_evaluation,
            "holdoutEvaluation": self.holdout_evaluation,
            "validationResults": [
                {"modelName": ev.model_name, "grid": ev.grid,
                 "metric": ev.metric_name, "values": ev.metric_values,
                 "mean": ev.mean_metric}
                for ev in self.validation_results],
        }


class ModelSelector(PredictionEstimatorBase):
    """Estimator over (label, features): validates every (model, grid)
    candidate and refits the best."""

    def __init__(self, models: Sequence[Tuple[PredictionEstimatorBase,
                                              List[Dict[str, Any]]]],
                 validator: CrossValidator,
                 splitter: Optional[DataSplitter] = None,
                 train_evaluators: Sequence[Evaluator] = (), **kw):
        super().__init__(operation_name=kw.pop("operation_name", "modelSelector"),
                         **kw)
        self.models = list(models)
        self.validator = validator
        self.splitter = splitter
        self.train_evaluators = list(train_evaluators)
        #: phase -> host seconds of the last fit (prep, validate, refit,
        #: train_eval) and ``cv.<family>`` per family
        self.last_fit_profile: Dict[str, float] = {}

    def fit_columns(self, cols, dataset, device):
        profile: Dict[str, float] = {}
        t0 = time.perf_counter()
        label, vec = cols
        x = np.asarray(vec.data, np.float32)
        y = np.asarray(label.data, np.float32)
        base_w, prep_summary = (self.splitter.prepare(y) if self.splitter is not None
                                else (np.ones_like(y, dtype=np.float32), None))
        if "__sample_weight__" in dataset:
            base_w = base_w * dataset["__sample_weight__"].data.astype(np.float32)
        t1 = time.perf_counter()
        profile["prep"] = t1 - t0

        result: ValidationResult = self.validator.validate(
            self.models, x, y, base_w, device)
        t2 = time.perf_counter()
        profile["validate"] = t2 - t1
        profile.update({f"cv.{k}": v for k, v in result.family_seconds.items()})
        if result.evaluations and not any(
                np.isfinite(v) for ev in result.evaluations for v in ev.metric_values):
            names = result.failed_models or sorted(
                {ev.model_name for ev in result.evaluations})
            raise RuntimeError("model selection failed: no candidate produced a "
                               f"finite CV metric (failed: {', '.join(names)})")
        best_eval = result.best
        best_est = next(e for e, _ in self.models if e.uid == best_eval.model_uid)
        best_model = best_est.copy().set_params(**best_eval.grid) \
            ._fit_arrays(x, y, base_w, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t3 = time.perf_counter()
        profile["refit"] = t3 - t2

        payload = best_model.eval_payload_device(x, device)
        yd = wd = None
        if payload is not None:
            yd = torch.from_numpy(y).to(device)
            wd = torch.ones_like(yd)
        pred_cache: List[PredictionColumn] = []

        def evaluate(ev, w: Optional[np.ndarray]) -> Dict[str, float]:
            # threshold curves read host rows
            if payload is not None and hasattr(ev, "evaluate_device") \
                    and getattr(ev, "num_thresholds", 0) == 0:
                wv = wd if w is None else torch.from_numpy(
                    np.asarray(w, np.float32)).to(device)
                return ev.evaluate_device(payload[0], payload[1], yd, wv)
            if not pred_cache:
                pred_cache.append(best_model.predict_column(Column.vector(x), device))
            return ev.evaluate_arrays(y.astype(np.float64), pred_cache[0], w=w)

        evaluators = [self.validator.evaluator] + self.train_evaluators
        train_eval: Dict[str, float] = {}
        for ev in evaluators:
            train_eval.update(evaluate(ev, None))
        holdout_eval: Dict[str, float] = {}
        hmask = getattr(self.splitter, "holdout_mask", None)
        if hmask is not None and hmask.any():
            for ev in evaluators:
                holdout_eval.update(evaluate(ev, hmask.astype(np.float64)))
        profile["train_eval"] = time.perf_counter() - t3

        summary = ModelSelectorSummary(
            validation_type=type(self.validator).__name__,
            validation_results=result.evaluations,
            best_model_name=best_eval.model_name,
            best_model_uid=best_eval.model_uid,
            best_grid=best_eval.grid,
            metric_name=best_eval.metric_name,
            larger_is_better=self.validator.evaluator.larger_is_better,
            data_prep=prep_summary,
            train_evaluation=train_eval,
            holdout_evaluation=holdout_eval,
            failed_models=list(result.failed_models))
        self.last_fit_profile = profile
        return SelectedModel(model=best_model, summary=summary,
                             feature_meta=vec.meta)


class SelectedModel(PredictionModelBase):
    """The winning fitted model and the selection summary (a
    :class:`ModelSelectorSummary` after a fit, plain data after a load)."""

    def __init__(self, model: PredictionModelBase, summary=None,
                 feature_meta=None, **kw):
        super().__init__(**kw)
        self.model = model
        self.summary = summary
        self.feature_meta = feature_meta

    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        return self.model.predict_column(vec, device)

    def eval_payload_device(self, x32, device):
        return self.model.eval_payload_device(x32, device)


class BinaryClassificationModelSelector:
    """Binary selector factories with the reference's defaults (3 folds,
    auPR, a DataBalancer splitter, binary train metrics)."""

    @staticmethod
    def default_models() -> List[Tuple[PredictionEstimatorBase, List[Dict[str, Any]]]]:
        """The reference's default families and grids, in its order."""
        from .logistic import LogisticRegression
        from .svm import LinearSVC
        from .trees import GradientBoostedTreesClassifier, RandomForestClassifier

        return [
            (LogisticRegression(), [{"reg_param": r, "elastic_net": e}
                                    for r in (0.001, 0.01, 0.1) for e in (0.0, 0.5)]),
            (RandomForestClassifier(), [{"num_trees": 50, "max_depth": d}
                                        for d in (3, 6)]),
            (GradientBoostedTreesClassifier(), [{"num_rounds": 50, "max_depth": 3}]),
            (LinearSVC(), [{"reg_param": r} for r in (0.01, 0.1)]),
        ]

    @staticmethod
    def with_cross_validation(num_folds: int = 3, validation_metric: str = "auPR",
                              seed: int = 42,
                              splitter: Optional[DataSplitter] = None,
                              models: Optional[Sequence] = None,
                              stratify: bool = False) -> ModelSelector:
        ev = BinaryClassificationEvaluator(validation_metric)
        return ModelSelector(
            models=models or BinaryClassificationModelSelector.default_models(),
            validator=CrossValidator(ev, num_folds=num_folds, seed=seed,
                                     stratify=stratify),
            splitter=splitter if splitter is not None else DataBalancer(),
            train_evaluators=[Evaluators.binary_classification()])

    @staticmethod
    def with_train_validation_split(train_ratio: float = 0.75,
                                    validation_metric: str = "auPR",
                                    seed: int = 42,
                                    splitter: Optional[DataSplitter] = None,
                                    models: Optional[Sequence] = None) -> ModelSelector:
        ev = BinaryClassificationEvaluator(validation_metric)
        return ModelSelector(
            models=models or BinaryClassificationModelSelector.default_models(),
            validator=TrainValidationSplit(ev, train_ratio=train_ratio, seed=seed),
            splitter=splitter if splitter is not None else DataBalancer(),
            train_evaluators=[Evaluators.binary_classification()])


class MultiClassificationModelSelector:
    """Multiclass selector factories with the reference's defaults (3
    folds, error, a DataCutter splitter, multiclass train metrics)."""

    @staticmethod
    def default_models() -> List[Tuple[PredictionEstimatorBase, List[Dict[str, Any]]]]:
        """The reference's default families and grids, in its order."""
        from .naive_bayes import NaiveBayes
        from .softmax import MultinomialLogisticRegression
        from .trees import DecisionTreeClassifier, RandomForestClassifier

        return [
            (MultinomialLogisticRegression(), [{"reg_param": r}
                                               for r in (0.001, 0.01, 0.1)]),
            (RandomForestClassifier(), [{"num_trees": 50, "max_depth": d}
                                        for d in (3, 6)]),
            (DecisionTreeClassifier(), [{"max_depth": d} for d in (3, 6)]),
            (NaiveBayes(), [{"smoothing": 1.0}]),
        ]

    @staticmethod
    def with_cross_validation(num_folds: int = 3, validation_metric: str = "error",
                              seed: int = 42,
                              splitter: Optional[DataSplitter] = None,
                              models: Optional[Sequence] = None,
                              stratify: bool = False) -> ModelSelector:
        ev = MultiClassificationEvaluator(validation_metric)
        return ModelSelector(
            models=models or MultiClassificationModelSelector.default_models(),
            validator=CrossValidator(ev, num_folds=num_folds, seed=seed,
                                     stratify=stratify),
            splitter=splitter if splitter is not None else DataCutter(),
            train_evaluators=[Evaluators.multi_classification()])


class RegressionModelSelector:
    """Regression selector factories with the reference's defaults (3 folds,
    rmse, a DataSplitter, regression train metrics)."""

    @staticmethod
    def default_models() -> List[Tuple[PredictionEstimatorBase, List[Dict[str, Any]]]]:
        """The reference's default families and grids, in its order."""
        from .glm import GeneralizedLinearRegression
        from .linear import LinearRegression
        from .trees import GradientBoostedTreesRegressor, RandomForestRegressor

        return [
            (LinearRegression(), [{"reg_param": r, "elastic_net": e}
                                  for r in (0.001, 0.01, 0.1) for e in (0.0, 0.5)]),
            (RandomForestRegressor(), [{"num_trees": 50, "max_depth": d}
                                       for d in (3, 6)]),
            (GradientBoostedTreesRegressor(), [{"num_rounds": 50, "max_depth": 3}]),
            (GeneralizedLinearRegression(), [{"family": "gaussian", "reg_param": r}
                                             for r in (0.0, 0.01)]),
        ]

    @staticmethod
    def with_cross_validation(num_folds: int = 3, validation_metric: str = "rmse",
                              seed: int = 42,
                              splitter: Optional[DataSplitter] = None,
                              models: Optional[Sequence] = None) -> ModelSelector:
        ev = RegressionEvaluator(validation_metric)
        return ModelSelector(
            models=models or RegressionModelSelector.default_models(),
            validator=CrossValidator(ev, num_folds=num_folds, seed=seed),
            splitter=splitter if splitter is not None else DataSplitter(),
            train_evaluators=[Evaluators.regression()])
