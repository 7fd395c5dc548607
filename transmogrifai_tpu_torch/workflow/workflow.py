"""Workflow and WorkflowModel (counterpart of ``transmogrifai_tpu/workflow/workflow.py``).

Training from raw typed columns::

    vec = transmogrify([*predictors, *[r.auto_bucketize(label) for r in reals]])
    pred = label.transform_with(
        BinaryClassificationModelSelector.with_cross_validation(),
        label.sanity_check(vec))
    wf = Workflow().set_input_dataset(ds).set_result_features(label, pred)
    # or .set_reader(DataReaders.Simple.dataframe(df)) / CustomReader(...)
    # optionally drop sparse, drifting or leaky raw features (or map keys)
    # first: wf.with_raw_feature_filter(RawFeatureFilter(scoring_dataset=sds))
    model = wf.train()                       # fits on the CUDA card
    # or wf.with_workflow_cv().train(): the label-dependent stages (the
    # bucketizers, the checker) re-fit inside every CV fold
    print(model.summary_pretty())            # the selector's CV table
    print(model.model_insights().pretty())   # per-slot stats, contributions

Scoring a fitted or loaded model::

    model = WorkflowModel.load(path)         # a saved model directory
    plan = model.serving_plan()              # on the CUDA card
    rows = plan.score(records)               # [{result name: value}, ...]
    with model.serve(max_batch=256) as server:   # records one at a time
        row = server.submit(record).result()
    scored = model.score(dataset)            # columnar, returns a Dataset
    metrics = model.evaluate(Evaluators.binary_classification(), dataset)
    model.save(path)                         # the JAX package loads it too

Every entry point takes the reference's parameters in the reference's order,
and ``device`` by keyword only: it runs on the CUDA card unless ``device``
names another device (the tests pass ``device="cpu"``); with no card it
raises.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence

from ..data.dataset import Dataset
from ..evaluators.base import Evaluator
from ..features.feature import Feature
from .dag import all_stages, compute_dag

log = logging.getLogger(__name__)


def dedup_raw_features(result_features: Sequence[Feature]) -> List[Feature]:
    """All raw ancestors of the result features, each once (by uid)."""
    out: Dict[str, Feature] = {}
    for f in result_features:
        for r in f.raw_features():
            out.setdefault(r.uid, r)
    return list(out.values())


class Workflow:
    """DAG of stages reached from the result features; ``train()`` fits it."""

    def __init__(self):
        self.result_features: List[Feature] = []
        self._input_dataset: Optional[Dataset] = None
        self._reader = None
        self._warm_models: Dict[str, object] = {}
        self._op_params = None
        self._raw_feature_filter = None
        self._workflow_cv = False
        #: records of the last ``train()``: the raw feature filter's, one per
        #: estimator fit and one per transform flush
        #: (``workflow/fit.py::fit_stage_list``); with workflow CV also the
        #: fold fits (``"fold": f``), the fold transform and the fold sweeps
        #: (``workflow/fit.py::workflow_cv_validate``)
        self.last_train_profile: List[dict] = []

    def with_workflow_cv(self) -> "Workflow":
        """Move the CV loop outside the model selector: ``train()`` re-fits
        the label-dependent stages between the raw features and the
        selector inside every fold (``workflow/dag.py::cut_dag``), so the CV
        estimate carries no label leakage from their fits."""
        self._workflow_cv = True
        return self

    def set_result_features(self, *features: Feature) -> "Workflow":
        self.result_features = list(features)
        seen: Dict[str, object] = {}
        for layer in compute_dag(self.result_features):
            for stage in layer:
                if seen.get(stage.uid, stage) is not stage:
                    raise ValueError(f"[TM102] Duplicate stage uid in DAG: {stage.uid}")
                seen[stage.uid] = stage
        if self._op_params is not None:
            self._op_params.apply_to_stages(all_stages(self.result_features))
        return self

    def set_input_dataset(self, ds: Dataset) -> "Workflow":
        self._input_dataset = ds
        return self

    def set_reader(self, reader) -> "Workflow":
        """Read the training data through ``reader`` (``readers/``): its
        ``generate_dataset`` of the raw features; the trained model keeps
        it for ``score()`` with no dataset."""
        self._reader = reader
        return self

    def with_model_stages(self, model: "WorkflowModel") -> "Workflow":
        """Warm start: reuse ``model``'s fitted stages by uid."""
        self._warm_models.update(model.fitted)
        return self

    def set_parameters(self, params) -> "Workflow":
        """Apply an :class:`~..params.OpParams`' stage overrides (by class
        name or uid); a param set in code wins over the configuration."""
        self._op_params = params
        if self.result_features:
            params.apply_to_stages(all_stages(self.result_features))
        return self

    def validate(self, serving: bool = False, cost: bool = False,
                 hbm_budget: Optional[float] = None,
                 single_host: bool = False,
                 host_budget: Optional[float] = None,
                 rows: Optional[int] = None):
        """Static validation, without touching data (the reference's
        parameters and defaults): every analyzer family of
        ``checkers/opcheck.py`` over the DAG reached from the result
        features (structure, types, each device half run on meta operands,
        the device-hazard lint of the stages' sources, label leakage).
        Returns the :class:`~..checkers.diagnostics.DiagnosticReport`.

        ``serving=True`` adds the TM5xx servability analyzers; ``cost=True``
        (or a ``hbm_budget``, or ``single_host``) the TM6xx plan-cost pass
        (``checkers/plancheck.py``; on an untrained workflow only the
        recompile-hazard map, and an armed budget fails closed with TM606);
        ``host_budget`` with ``rows`` the TM607 host-residency estimate.
        Nothing is allocated on the card, built or launched."""
        from ..checkers.opcheck import validate_result_features

        return validate_result_features(self.result_features,
                                        workflow_cv=self._workflow_cv,
                                        serving=serving, cost=cost,
                                        hbm_budget=hbm_budget,
                                        single_host=single_host,
                                        host_budget=host_budget, rows=rows)

    def with_raw_feature_filter(self, rff) -> "Workflow":
        """Run ``rff`` (a :class:`~..filters.RawFeatureFilter`) over the raw
        table at the start of ``train()``: the blacklisted features leave
        the table and the DAG, bad map keys leave their columns."""
        self._raw_feature_filter = rff
        return self

    def raw_features(self) -> List[Feature]:
        return dedup_raw_features(self.result_features)

    def generate_raw_data(self) -> Dataset:
        """The raw table: the reader's dataset of the raw features, else the
        input dataset."""
        if self._reader is not None:
            return self._reader.generate_dataset(self.raw_features())
        if self._input_dataset is None:
            raise ValueError("No input data: call set_input_dataset or set_reader first")
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
        ``test_fraction`` > 0 the input splits (after the raw feature
        filter, when one is set) first (``Dataset.split`` by
        ``seed``, the reference's draw): the DAG fits on the train part and
        the model selector's summary gets the metrics of the held-out part
        (``holdout_evaluation``).

        ``checkpointer`` (a :class:`~.checkpoint.StageCheckpointer`) saves
        each fitted stage as it completes and warm-starts the stages it
        finds on disk whose uid and fingerprint match; a stage whose params
        changed refits, and so does every checkpointed estimator downstream
        of a stage that refits.

        ``resume`` (a directory) makes the fit durable: the stages
        checkpoint under ``resume/stages`` (unless a ``checkpointer`` was
        passed), every completed sweep block commits to the fsync'd
        ``resume/sweep_journal.json``, and the fit runs inside
        :func:`~.resilience.resilient_training`: transient faults retry with
        bounded backoff, an out-of-memory sweep retries on fewer rows, and
        a killed run re-invoked with the same directory replays every
        committed block without launching it, ending in the model of an
        uninterrupted run.  Chunked epochs commit their chunk offsets to
        ``resume/chunk_offsets.json``, so a re-run over the same chunked
        table skips every committed chunk.

        ``hbm_budget`` (bytes) arms the TM601 gate on every plan the fit
        runs (a flush, the fold transform, a chunked epoch's tile): an
        over-budget plan raises :class:`~..checkers.diagnostics.OpCheckError`
        before anything launches.  ``host_budget`` (bytes; default the
        ``TMOG_HOST_BUDGET`` env var) bounds host DRAM: an in-memory table
        over it spills to a chunked store (``data/chunked.py``) and fits
        out of core (``workflow/ooc.py``), and a working set the chunked fit
        cannot avoid (an estimator's input columns) over it raises TM607.

        ``telemetry`` (an output directory path, or a prebuilt
        :class:`~..obs.Telemetry`; default: the ``TMOG_TELEMETRY`` env var)
        wraps the fit in the ``obs`` layer: every ``perf.phase`` site lands
        as a ``train`` trace span, kernel builds and loads land in the
        flight recorder, dumped as ``trace.json`` / ``flight.json`` / a
        ``metrics.jsonl`` line (compile counts and phase seconds) under the
        directory when the fit finishes.  A bundle the caller already
        started keeps its session: the fit neither stops nor dumps it.

        ``strict=True`` runs :meth:`validate` first and raises
        :class:`~..checkers.diagnostics.OpCheckError` on any error finding,
        before any read, allocation or launch: a bad DAG, a label leak or a
        device half that fails on meta operands fails in milliseconds, not
        minutes into a job on the card."""
        from contextlib import ExitStack

        from ..obs import resolve_telemetry

        if strict:
            if not self.result_features:
                raise ValueError("set_result_features before train()")
            report = self.validate()
            if report.errors():
                from ..checkers.diagnostics import OpCheckError

                raise OpCheckError(report)
        with ExitStack() as stack:
            if resume is not None:
                from ..readers.streaming import OffsetCheckpoint
                from .checkpoint import StageCheckpointer
                from .resilience import SweepJournal, resilient_training

                os.makedirs(resume, exist_ok=True)
                if checkpointer is None:
                    checkpointer = StageCheckpointer(os.path.join(resume, "stages"))
                stack.enter_context(resilient_training(
                    journal=SweepJournal(os.path.join(resume, "sweep_journal.json")),
                    chunk_checkpoint=OffsetCheckpoint(
                        os.path.join(resume, "chunk_offsets.json")),
                    seed=seed))
            tel = resolve_telemetry(telemetry)
            if tel is None:
                return self._train(test_fraction, seed, checkpointer, device,
                                   hbm_budget, host_budget)
            from ..perf import PhaseRecorder, compile_snapshot, record_phases

            # ownership-aware activation: a caller that already started this
            # bundle keeps its session — we neither stop nor dump over it
            owned = tel.activate()
            t0 = compile_snapshot()
            rec = PhaseRecorder()
            try:
                with record_phases(rec):
                    return self._train(test_fraction, seed, checkpointer, device,
                                       hbm_budget, host_budget)
            finally:
                if owned:
                    # dump in the finally so a FAILED fit still leaves its
                    # trace/flight postmortem
                    tel.stop()
                    tel.dump(metrics_payload={
                        "compile": compile_snapshot().minus(t0).to_dict(),
                        "phases": rec.report(),
                        "source": "Workflow.train",
                    })

    def _train(self, test_fraction: float, seed: int, checkpointer,
               device, hbm_budget: Optional[float] = None,
               host_budget: Optional[float] = None) -> "WorkflowModel":
        from ..data.chunked import ChunkedDataset, maybe_chunk
        from ..data.chunked import host_budget as env_host_budget
        from ..perf.kernels.dispatch import resolve_device
        from .fit import fit_dag

        if not self.result_features:
            raise ValueError("set_result_features before train()")
        dev = resolve_device(device)
        raw = self.generate_raw_data()
        profile: List[dict] = []
        blacklist: List[str] = []
        rff_summary = None
        if self._raw_feature_filter is not None:
            if isinstance(raw, ChunkedDataset):
                # the filter's distributions are whole-column passes
                log.warning("RawFeatureFilter on a chunked dataset materializes "
                            "the raw table in host DRAM")
                raw = raw.materialize()
            t0 = time.perf_counter()
            raw, blacklist, rff_summary = self._raw_feature_filter.filter_raw(
                raw, self.raw_features(), self.result_features, device=dev)
            profile.append({"kind": "filter", "stage": "RawFeatureFilter",
                            "seconds": time.perf_counter() - t0,
                            "blacklist": list(blacklist)})
        # host-DRAM residency: a table over the budget spills to the chunked
        # store and the whole fit goes out of core
        if host_budget is None:
            host_budget = env_host_budget()
        if host_budget is not None:
            raw = maybe_chunk(raw, budget=host_budget)
        test_ds = None
        if test_fraction > 0.0:
            if isinstance(raw, ChunkedDataset):
                log.warning("test_fraction on a chunked dataset materializes both "
                            "splits in host DRAM transiently; use test_fraction=0 "
                            "for fits whose train split must stay out of core")
            raw, test_ds = raw.split(test_fraction, seed=seed)
            if host_budget is not None:
                # the split made in-memory datasets: the budget re-arms on the
                # train split, so the fit (and its TM607 gate) stays out of core
                raw = maybe_chunk(raw, budget=host_budget)
        warm = dict(self._warm_models)
        on_fit = None
        if checkpointer is not None:
            on_fit = self._resume_checkpoints(checkpointer, warm)
        preseeded = None
        if self._workflow_cv:
            from .dag import cut_dag
            from .fit import fit_stage_list, workflow_cv_validate

            cut = cut_dag(self.result_features)
            if cut is None:
                raise ValueError("with_workflow_cv requires a ModelSelector in the DAG")
            before, during, selector = cut
            if selector.uid not in warm:
                ds_before = fit_stage_list(raw, before, warm, device=dev,
                                           profile=profile, on_fit=on_fit,
                                           hbm_budget=hbm_budget,
                                           host_budget=host_budget)
                selector._preselected = workflow_cv_validate(
                    ds_before, during, selector, dev, profile=profile,
                    hbm_budget=hbm_budget, host_budget=host_budget)
                preseeded = selector
        try:
            _, fitted = fit_dag(raw, self.result_features, fitted=warm,
                                device=dev, profile=profile, on_fit=on_fit,
                                hbm_budget=hbm_budget, host_budget=host_budget)
        finally:
            if preseeded is not None:
                del preseeded._preselected
        self.last_train_profile = profile
        model = WorkflowModel(result_features=self.result_features, fitted=fitted,
                              blacklist=blacklist, rff_summary=rff_summary,
                              workflow_cv=self._workflow_cv)
        if self._reader is not None:
            # the model keeps the workflow's reader for score() with no dataset
            model.set_reader(self._reader)
        if test_ds is not None and test_ds.n_rows > 0:
            model._evaluate_holdout(test_ds, dev)
        return model

    def _resume_checkpoints(self, checkpointer, warm: Dict):
        """Warm-start from ``checkpointer``'s entries (into ``warm``): an
        entry binds to the DAG stage of its uid when the saved fingerprint
        matches the stage's; then every loaded entry downstream of an
        estimator that will refit is dropped (it was fitted on stale
        inputs), looking through transformers to the nearest estimator
        ancestors.  Returns the ``on_fit`` hook that checkpoints each stage
        as it is fitted."""
        from ..stages.base import Estimator
        from .checkpoint import stage_fingerprint

        by_uid = {s.uid: s for s in all_stages(self.result_features)}
        entries = checkpointer.load_entries()
        for uid, (model, saved_fp) in entries.items():
            dag_stage = by_uid.get(uid)
            if dag_stage is None:
                continue
            if saved_fp is not None and saved_fp != stage_fingerprint(dag_stage):
                log.warning("checkpoint for %s has different stage params; "
                            "refitting", uid)
                continue
            model._input_features = tuple(dag_stage.inputs)
            model._output_feature = dag_stage.get_output()
            warm[uid] = model

        def estimator_ancestors(stage):
            seen, stack, found = set(), list(stage.inputs), []
            while stack:
                st = stack.pop().origin_stage
                if st is None or st.uid in seen:
                    continue
                seen.add(st.uid)
                if isinstance(st, Estimator):
                    found.append(st)
                else:
                    stack.extend(st.inputs)
            return found

        loaded = set(entries) & set(warm)
        changed = True
        while changed:
            changed = False
            for uid in list(loaded):
                if any(est.uid in by_uid and est.uid not in warm
                       for est in estimator_ancestors(by_uid[uid])):
                    del warm[uid]
                    loaded.discard(uid)
                    changed = True

        def on_fit(model):
            dag_stage = by_uid.get(model.uid)
            fp = stage_fingerprint(dag_stage) if dag_stage is not None else None
            checkpointer.save_stage(model, fingerprint=fp)

        return on_fit


class WorkflowModel:
    """A fitted workflow.  ``blacklist`` names the raw features the raw
    feature filter dropped (saved with the model); ``rff_summary`` is the
    filter's :class:`~..filters.RawFeatureFilterResults` (not saved).
    :meth:`model_insights` explains it (``insights/``)."""

    def __init__(self, result_features: Sequence[Feature], fitted: Dict,
                 blacklist: Sequence[str] = (), rff_summary=None,
                 workflow_cv: bool = False):
        self.result_features: List[Feature] = list(result_features)
        self.fitted = dict(fitted)
        self.blacklist = list(blacklist)
        self.rff_summary = rff_summary
        #: whether the producing workflow re-fit the label-dependent stages
        #: per fold (``with_workflow_cv``; saved with the model)
        self.workflow_cv = bool(workflow_cv)
        self._reader = None

    def set_reader(self, reader) -> "WorkflowModel":
        """The reader ``score``/``evaluate`` read through when given no
        dataset."""
        self._reader = reader
        return self

    def _read(self, dataset: Optional[Dataset]) -> Dataset:
        if dataset is not None:
            return dataset
        if self._reader is None:
            raise ValueError("score() needs a dataset or a reader")
        return self._reader.generate_dataset(dedup_raw_features(self.result_features))

    def score_function(self, *, device=None):
        """Engine-free scoring closure (``local/scoring.py::score_function``):
        ``scorer(record) -> {result: value}``, and ``scorer.batch(records)``
        for many records, on ``device`` (the CUDA card unless it names
        another)."""
        from ..local.scoring import score_function

        return score_function(self, device=device)

    def validate(self, serving: bool = True, cost: bool = False,
                 hbm_budget: Optional[float] = None,
                 single_host: bool = False,
                 host_budget: Optional[float] = None,
                 rows: Optional[int] = None):
        """Static validation of the fitted model, scoring-path aware (the
        reference's parameters and defaults): the analyzers of
        :meth:`Workflow.validate` with estimators resolved through the
        fitted models, so a missing fit is a TM501 error and the TM502/TM503
        servability analyzers see the stages that run at request time.
        ``cost=True`` (or a ``hbm_budget``) traces the scoring plan's device
        prefix on meta operands at every bucket of its ladder and attaches
        the :class:`~..checkers.plancheck.PlanCostReport` as
        ``report.plan_cost``.  Nothing is allocated on the card, built or
        launched."""
        from ..checkers.opcheck import validate_result_features

        return validate_result_features(self.result_features,
                                        workflow_cv=self.workflow_cv,
                                        serving=serving, fitted=self.fitted,
                                        cost=cost, hbm_budget=hbm_budget,
                                        single_host=single_host,
                                        host_budget=host_budget, rows=rows)

    def serving_plan(self, min_bucket: int = 8, max_bucket: int = 1024,
                     strict: bool = True, hbm_budget: Optional[float] = None,
                     *, device=None):
        """Bind this model to ``device`` for batch scoring
        (:class:`~..serve.plan.CompiledScoringPlan`).  ``strict`` runs the
        servability checks (TM501-TM504); ``hbm_budget`` (bytes) arms the
        TM601 admission gate: a plan whose static peak device-memory
        estimate exceeds it refuses to build."""
        from ..serve.plan import CompiledScoringPlan

        return CompiledScoringPlan(self, min_bucket, max_bucket, strict,
                                   hbm_budget, device=device)

    def serve(self, **kwargs):
        """In-process scoring server over this model
        (:class:`~..serve.server.ScoringServer`, the keyword arguments its
        own, ``device`` among them): the plan behind a micro-batcher.  Close
        it (or use it as a context manager) to drain its queue."""
        from ..serve.server import ScoringServer

        return ScoringServer(self, **kwargs)

    def score(self, dataset: Optional[Dataset] = None,
              keep_intermediate: bool = False, *, device=None) -> Dataset:
        """Score a dataset of raw columns (with none, the reader's: see
        :meth:`set_reader`) through one whole-table transform plan
        (``workflow/fit.py::transform_dag``): its raw columns plus the
        result features, or every stage's output with ``keep_intermediate``.
        A :class:`~..data.chunked.ChunkedDataset` is scored chunk by chunk
        (one encode launch per chunk) and comes back chunked."""
        from ..perf.kernels.dispatch import resolve_device
        from .fit import transform_dag

        dev = resolve_device(device)
        dataset = self._read(dataset)
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

    @staticmethod
    def _eval_view(scored, names):
        """Evaluators read whole columns: a chunked score materializes
        exactly those (the rest of the table stays spilled)."""
        from ..data.chunked import as_dataset

        return as_dataset(scored, [n for n in names if n in scored])

    def evaluate(self, evaluator: Evaluator, dataset: Optional[Dataset] = None,
                 *, device=None) -> Dict[str, float]:
        """Score ``dataset`` and evaluate the prediction against its label."""
        return self.score_and_evaluate(evaluator, dataset, device=device)[1]

    def score_and_evaluate(self, evaluator: Evaluator,
                           dataset: Optional[Dataset] = None, *, device=None):
        """(the scored result features, the metrics) of one scoring pass."""
        evaluator, dataset = self._check_eval_args(evaluator, dataset)
        label, pred = self._label_and_pred()
        scored = self.score(self._read(dataset), keep_intermediate=True, device=device)
        metrics = evaluator.evaluate(self._eval_view(scored, [label.name, pred.name]),
                                     label.name, pred.name)
        keep = [f.name for f in self.result_features if f.name in scored]
        return scored.select(keep), metrics

    def selector_model(self):
        """The fitted model selector's stage, or None."""
        from ..models.selector import SelectedModel

        return next((t for t in self.fitted.values() if isinstance(t, SelectedModel)),
                    None)

    def summary(self):
        """The model selector's summary (``ModelSelectorSummary``), or None."""
        m = self.selector_model()
        return m.summary if m else None

    def summary_pretty(self) -> str:
        """The selector's summary as text: the winner, a table of every
        candidate's mean CV metric, the train (and holdout) metrics."""
        s = self.summary()
        return s.pretty() if s else "(no model selector in workflow)"

    def model_insights(self):
        """The :class:`~..insights.ModelInsights` of this model: every slot
        of the checked vector with its provenance, the sanity checker's
        statistics and the selected model's contribution, the label summary
        and the selection summary (``insights/model_insights.py``)."""
        from ..insights.model_insights import extract_model_insights

        return extract_model_insights(self)

    def compute_data_up_to(self, feature: Feature, dataset: Dataset, *,
                           device=None) -> Dataset:
        """Transform ``dataset`` by the fitted DAG only up to ``feature``."""
        from ..perf.kernels.dispatch import resolve_device
        from .fit import transform_dag

        return transform_dag(dataset, [feature], self.fitted, resolve_device(device))

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
