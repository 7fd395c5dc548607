"""WorkflowRunner + App — production entry points for train/score/evaluate
runs (counterpart of ``transmogrifai_tpu/workflow/runner.py``).

Reference: core/.../OpWorkflowRunner.scala:70-459 (run types :358-365, train :163-181,
score, streamingScore, computeFeatures :190-194, evaluate; metrics written to
metricsLocation) and OpApp/OpAppWithRunner (OpApp.scala:49-213) parsing args into
OpParams and dispatching the run type.

All five run types are ported.  STREAMING_SCORE scores each micro-batch
of the streaming reader (``readers/streaming.py``) through
``WorkflowModel.score`` (one whole-table plan, one encode launch a batch)
and commits the reader's offset only after the batch's output is written
under ``write_location`` (at-least-once; with no write location nothing is
committed).  ``OpParams.log_stage_metrics`` / ``collect_stage_metrics``
attach an :class:`~..utils.listener.OpMetricsListener` for the run (the
collected ``appMetrics`` join the result's metrics), and
``profile_trace_dir`` wraps the run in a ``torch.profiler`` capture
exported as a Chrome trace.  The runs call the workflow's entry points with no
device, so they run on the CUDA card unless the caller wraps them in
``perf.kernels.dispatch.use_device``.  A ``write_location`` writes through
pandas, imported only then.
"""

from __future__ import annotations

import argparse
import enum
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..evaluators.base import Evaluator
from ..features.feature import Feature
from ..params import OpParams
from ..utils.listener import (
    OpMetricsListener,
    add_listener,
    profile_trace,
    remove_listener,
)
from .workflow import Workflow, WorkflowModel, dedup_raw_features


class RunType(enum.Enum):
    TRAIN = "train"
    SCORE = "score"
    STREAMING_SCORE = "streaming_score"
    FEATURES = "features"
    EVALUATE = "evaluate"


@dataclass
class RunResult:
    run_type: RunType
    metrics: Dict[str, Any] = field(default_factory=dict)
    model_location: Optional[str] = None
    scores: Any = None  # Dataset (score/features) or list of Datasets (streaming)

    def to_dict(self) -> dict:
        return {"runType": self.run_type.value, "metrics": self.metrics,
                "modelLocation": self.model_location}


class WorkflowRunner:
    """Dispatches a workflow through the reference's run types."""

    def __init__(
        self,
        workflow: Workflow,
        train_reader=None,
        scoring_reader=None,
        streaming_reader=None,
        evaluator: Optional[Evaluator] = None,
        features_to_compute: Optional[Feature] = None,
        on_run_complete: Optional[Callable[[RunResult], None]] = None,
    ):
        self.workflow = workflow
        self.train_reader = train_reader
        self.scoring_reader = scoring_reader
        self.streaming_reader = streaming_reader
        self.evaluator = evaluator
        self.features_to_compute = features_to_compute
        #: application-end handlers (OpWorkflowRunner.addApplicationEndHandler)
        self._end_handlers: List[Callable[[RunResult], None]] = (
            [on_run_complete] if on_run_complete else [])

    def add_application_end_handler(self, fn: Callable[[RunResult], None]) -> None:
        self._end_handlers.append(fn)

    # -- dispatch ------------------------------------------------------------
    def run(self, run_type: RunType, params: Optional[OpParams] = None) -> RunResult:
        params = params or OpParams()
        handler = {
            RunType.TRAIN: self._train,
            RunType.SCORE: self._score,
            RunType.STREAMING_SCORE: self._streaming_score,
            RunType.FEATURES: self._features,
            RunType.EVALUATE: self._evaluate,
        }[run_type]
        listener = None
        if params.log_stage_metrics or params.collect_stage_metrics:
            listener = add_listener(OpMetricsListener(
                log_stage_metrics=params.log_stage_metrics,
                collect_stage_metrics=params.collect_stage_metrics,
                custom_tag=params.custom_tag))
            listener.on_app_start(run_type.value)
        try:
            with profile_trace(params.profile_trace_dir):
                result = handler(params)
        finally:
            if listener is not None:
                listener.on_app_end()
                remove_listener(listener)
        if listener is not None and params.collect_stage_metrics:
            result.metrics = dict(result.metrics)
            result.metrics["appMetrics"] = listener.metrics.to_dict()
        if params.metrics_location and result.metrics:
            _write_json(params.metrics_location, result.to_dict())
        for fn in self._end_handlers:
            fn(result)
        return result

    # -- handlers ------------------------------------------------------------
    def _apply_params(self, params: OpParams) -> None:
        if params.stage_params:
            # delegate so the workflow remembers them for later set_result_features
            self.workflow.set_parameters(params)

    def _train(self, params: OpParams) -> RunResult:
        self._apply_params(params)
        if self.train_reader is not None:
            self.workflow.set_reader(self.train_reader)
        model = self.workflow.train()
        loc = params.model_location
        if loc:
            model.save(loc)
        summary = model.summary()
        metrics = summary.to_dict() if summary else {}
        return RunResult(RunType.TRAIN, metrics=metrics, model_location=loc)

    def _load_model(self, params: OpParams) -> WorkflowModel:
        if not params.model_location:
            raise ValueError(f"{type(self).__name__}: params.model_location is required")
        return WorkflowModel.load(params.model_location)

    def _score(self, params: OpParams) -> RunResult:
        model = self._load_model(params)
        if self.scoring_reader is None:
            raise ValueError("score run needs a scoring_reader")
        model.set_reader(self.scoring_reader)
        metrics: Dict[str, Any] = {}
        if self.evaluator is not None:
            scores, metrics = model.score_and_evaluate(self.evaluator)
        else:
            scores = model.score()
        if params.write_location:
            _write_dataset(params.write_location, scores)
        return RunResult(RunType.SCORE, metrics=metrics,
                         model_location=params.model_location, scores=scores)

    def _streaming_score(self, params: OpParams) -> RunResult:
        model = self._load_model(params)
        if self.streaming_reader is None:
            raise ValueError("streaming_score run needs a streaming_reader")
        raws = dedup_raw_features(model.result_features)
        outs = []
        commit = getattr(self.streaming_reader, "commit", None)
        for i, batch in enumerate(self.streaming_reader.stream_datasets(raws)):
            scored = model.score(batch)
            outs.append(scored)
            # offset-checkpointing readers commit only AFTER the batch's
            # output is durable (at-least-once).  Without a write_location
            # the scores live only in this process, so nothing is committed:
            # a crash replays instead of dropping the in-memory batches.
            if params.write_location:
                _write_dataset(_indexed_path(params.write_location, i), scored)
                if commit is not None:
                    commit()
        return RunResult(RunType.STREAMING_SCORE,
                         metrics={"batches": len(outs)},
                         model_location=params.model_location, scores=outs)

    def _features(self, params: OpParams) -> RunResult:
        model = self._load_model(params)
        if self.features_to_compute is None:
            raise ValueError("features run needs features_to_compute")
        if self.scoring_reader is None:
            raise ValueError("features run needs a scoring_reader")
        raws = self.features_to_compute.raw_features()
        ds = self.scoring_reader.generate_dataset(raws)
        out = model.compute_data_up_to(self.features_to_compute, ds)
        if params.write_location:
            _write_dataset(params.write_location, out)
        return RunResult(RunType.FEATURES, scores=out,
                         model_location=params.model_location)

    def _evaluate(self, params: OpParams) -> RunResult:
        model = self._load_model(params)
        if self.evaluator is None or self.scoring_reader is None:
            raise ValueError("evaluate run needs evaluator + scoring_reader")
        model.set_reader(self.scoring_reader)
        scores, metrics = model.score_and_evaluate(self.evaluator)
        return RunResult(RunType.EVALUATE, metrics=metrics,
                         model_location=params.model_location, scores=scores)


# ---------------------------------------------------------------------------
# App scaffold (OpApp / OpAppWithRunner)
# ---------------------------------------------------------------------------

class App:
    """Subclass and implement ``runner(params)``; call ``main()`` from __main__."""

    def runner(self, params: OpParams) -> WorkflowRunner:
        raise NotImplementedError

    def main(self, argv: Optional[List[str]] = None) -> RunResult:
        ap = argparse.ArgumentParser(description=type(self).__name__)
        ap.add_argument("--run-type", required=True,
                        choices=[t.value for t in RunType])
        ap.add_argument("--param-location", default=None,
                        help="OpParams JSON/YAML file")
        ap.add_argument("--model-location", default=None)
        ap.add_argument("--metrics-location", default=None)
        ap.add_argument("--write-location", default=None)
        ns = ap.parse_args(argv)
        params = (OpParams.from_file(ns.param_location) if ns.param_location
                  else OpParams())
        # CLI args override file locations (most-specific wins)
        if ns.model_location:
            params.model_location = ns.model_location
        if ns.metrics_location:
            params.metrics_location = ns.metrics_location
        if ns.write_location:
            params.write_location = ns.write_location
        return self.runner(params).run(RunType(ns.run_type), params)


# ---------------------------------------------------------------------------
# IO helpers
# ---------------------------------------------------------------------------

def _write_json(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, default=str)


def _write_dataset(path: str, ds) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    df = ds.to_pandas()
    if path.endswith(".parquet"):
        df.to_parquet(path)
    elif path.endswith(".json"):
        df.to_json(path, orient="records")
    else:
        df.to_csv(path, index=False)


def _indexed_path(path: str, i: int) -> str:
    base, ext = os.path.splitext(path)
    return f"{base}_{i}{ext}"
