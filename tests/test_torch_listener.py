"""The port's metrics listener and profiling hooks
(``transmogrifai_tpu_torch/utils/listener.py``; SURVEY §5.1
OpSparkListener equivalent), held to the JAX package's.

The reference's ``tests/test_listener.py`` test by test, under the same
names, on the CPU.  The port's training flush stays one plan with a
listener active (its device prefix one encode launch; prefix work never
moves to the host) and hands the listener one ``transform`` record per
stage it ran; the parity tests below hold those records' stage classes,
phases, rows and columns to the reference's per-stage path on the same
workflow.
"""

import json
import logging
import os

import numpy as np
import pytest

import transmogrifai_tpu as J
import transmogrifai_tpu.utils.listener as JL
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.ops.numeric import NumericVectorizer as JNumericVectorizer
from transmogrifai_tpu.types import Real as JReal
from transmogrifai_tpu.types import RealNN as JRealNN
from transmogrifai_tpu_torch import FeatureBuilder, Workflow
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.ops.numeric import NumericVectorizer
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.types import Real, RealNN
from transmogrifai_tpu_torch.utils.listener import (
    AppMetrics,
    OpMetricsListener,
    StageMetrics,
    add_listener,
    remove_listener,
)


def _tiny_workflow(pkg=None):
    rng = np.random.default_rng(0)
    cols = {"x": rng.normal(size=20).tolist(),
            "label": (rng.random(20) > 0.5).astype(float).tolist()}
    if pkg is None:
        ds = Dataset.from_features(cols, {"x": Real, "label": RealNN})
        x = FeatureBuilder.of("x", Real).extract_field().as_predictor()
        vec = x.transform_with(NumericVectorizer())
        return Workflow().set_input_dataset(ds).set_result_features(vec), ds, vec
    ds = JDataset.from_features(cols, {"x": JReal, "label": JRealNN})
    x = J.FeatureBuilder.of("x", JReal).extract_field().as_predictor()
    vec = x.transform_with(JNumericVectorizer())
    return J.Workflow().set_input_dataset(ds).set_result_features(vec), ds, vec


@pytest.fixture(autouse=True)
def _cpu():
    with use_device("cpu"):
        yield


class TestListenerCollection:
    def test_collects_fit_and_transform_metrics(self):
        listener = add_listener(OpMetricsListener())
        try:
            wf, ds, vec = _tiny_workflow()
            model = wf.train()
            model.score(ds)
        finally:
            remove_listener(listener)
        phases = {(m.stage_class, m.phase) for m in listener.metrics.stage_metrics}
        assert ("NumericVectorizer", "fit") in phases
        assert ("NumericVectorizerModel", "transform") in phases
        for m in listener.metrics.stage_metrics:
            assert m.wall_ms >= 0
            assert m.n_rows == 20
            assert m.stage_uid

    def test_no_listener_no_collection(self):
        wf, ds, _ = _tiny_workflow()
        wf.train()  # must not raise or collect anywhere

    def test_app_metrics_serde(self):
        m = AppMetrics(run_type="train", started_at=1.0, ended_at=3.5)
        m.stage_metrics.append(StageMetrics(
            stage_uid="u1", stage_class="C", operation_name="op", phase="fit",
            wall_ms=5.0, n_rows=10, n_cols_in=2, n_cols_out=3, started_at=1.0))
        d = json.loads(m.to_json())
        assert d["appDurationMs"] == 2500.0
        assert d["stageMetrics"][0]["stage_uid"] == "u1"
        # the reference's serde, key for key
        jm = JL.AppMetrics(run_type="train", started_at=1.0, ended_at=3.5)
        jm.stage_metrics.append(JL.StageMetrics(**m.stage_metrics[0].to_dict()))
        assert m.to_dict() == jm.to_dict()

    def test_log_mode(self, caplog):
        listener = add_listener(OpMetricsListener(log_stage_metrics=True,
                                                  collect_stage_metrics=False))
        try:
            with caplog.at_level(logging.INFO,
                                 logger="transmogrifai_tpu_torch.metrics"):
                wf, _, _ = _tiny_workflow()
                wf.train()
        finally:
            remove_listener(listener)
        assert listener.metrics.stage_metrics == []
        assert any("NumericVectorizer" in r.message for r in caplog.records)


class TestRunnerIntegration:
    def test_runner_exports_app_metrics(self, tmp_path):
        from transmogrifai_tpu_torch.params import OpParams
        from transmogrifai_tpu_torch.workflow.runner import RunType, WorkflowRunner

        wf, ds, vec = _tiny_workflow()
        metrics_path = os.path.join(tmp_path, "metrics.json")
        model_path = os.path.join(tmp_path, "model")
        runner = WorkflowRunner(workflow=wf)
        params = OpParams(model_location=model_path,
                          metrics_location=metrics_path,
                          collect_stage_metrics=True)
        result = runner.run(RunType.TRAIN, params)
        assert "appMetrics" in result.metrics
        app = result.metrics["appMetrics"]
        assert app["runType"] == "train"
        assert len(app["stageMetrics"]) > 0
        with open(metrics_path) as fh:
            on_disk = json.load(fh)
        assert on_disk["metrics"]["appMetrics"]["stageMetrics"]

    def test_listener_removed_after_run(self, tmp_path):
        from transmogrifai_tpu_torch.params import OpParams
        from transmogrifai_tpu_torch.utils.listener import active_listeners
        from transmogrifai_tpu_torch.workflow.runner import RunType, WorkflowRunner

        wf, _, _ = _tiny_workflow()
        runner = WorkflowRunner(workflow=wf)
        params = OpParams(model_location=os.path.join(tmp_path, "m"),
                          collect_stage_metrics=True)
        runner.run(RunType.TRAIN, params)
        assert active_listeners() == []


def _shape(listener):
    return [(m.stage_class, m.phase, m.n_rows, m.n_cols_in, m.n_cols_out)
            for m in listener.metrics.stage_metrics]


class TestParity:
    def test_train_and_score_records_equal_the_reference(self):
        """One fit and one transform record per stage, in the reference's
        order, with its rows and columns: the port's fused flush reports
        each stage it ran as the reference's per-stage path does."""
        shapes = {}
        for key, pkg, add, remove, cls in (
                ("t", None, add_listener, remove_listener, OpMetricsListener),
                ("j", J, JL.add_listener, JL.remove_listener, JL.OpMetricsListener)):
            listener = add(cls())
            try:
                wf, ds, _ = _tiny_workflow(pkg)
                model = wf.train()
                model.score(ds)
            finally:
                remove(listener)
            shapes[key] = _shape(listener)
        assert shapes["t"] == shapes["j"]
        assert shapes["t"][0] == ("NumericVectorizer", "fit", 20, 2, 0)

    def test_device_memory_fields_are_none_without_a_card(self):
        """``track_device_memory`` reads ``torch.cuda`` on a card; here,
        with no card, the fields stay None (as the reference's where the
        backend reports no memory stats)."""
        listener = add_listener(OpMetricsListener(track_device_memory=True))
        try:
            wf, _, _ = _tiny_workflow()
            wf.train()
        finally:
            remove_listener(listener)
        assert listener.metrics.stage_metrics
        for m in listener.metrics.stage_metrics:
            assert m.device_bytes_in_use is None and m.device_peak_bytes is None

    def test_profile_trace_writes_a_chrome_trace(self, tmp_path):
        from transmogrifai_tpu_torch.utils.listener import profile_trace

        with profile_trace(str(tmp_path / "prof")):
            wf, _, _ = _tiny_workflow()
            wf.train()
        (name,) = os.listdir(tmp_path / "prof")
        with open(tmp_path / "prof" / name) as fh:
            assert json.load(fh)["traceEvents"]
        with profile_trace(None):  # no directory: a plain block
            pass
