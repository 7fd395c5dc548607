"""The names of the copied host modules the port lacked, against the JAX
package: ``PipelineStage.input_names``, ``Transformer.is_model`` (set by
``Estimator.fit`` and by the model loader, never written by the port's
serde), ``Column.to_values(ftype)``, ``Feature.distributions``,
``FeatureGeneratorStage.make_output_name`` and ``BinScoreMetrics``.  The
default ``Transformer.transform_values`` is held row by row by the registry
sweep (``tests/test_torch_stage_registry_specs.py``)."""

import dataclasses
import gzip
import json
import os

import pytest

import transmogrifai_tpu as J
from transmogrifai_tpu.evaluators.base import BinScoreMetrics as JBinScoreMetrics
from transmogrifai_tpu.ops import scalers as JScalers  # noqa: F401  (the JAX
# package's loader finds a stage class once its module is imported)
from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.evaluators.base import BinScoreMetrics as TBinScoreMetrics
from transmogrifai_tpu_torch.ops.scalers import FillMissingWithMean, FillMissingWithMeanModel
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as TModel

import torch_registry_cases as RC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "serving_wide")


@pytest.fixture(autouse=True)
def _cpu():
    with use_device("cpu"):
        yield


def _wired(pkg):
    a = pkg.FeatureBuilder.Real("a").extract_field().as_predictor()
    b = pkg.FeatureBuilder.Real("b").extract_field().as_predictor()
    stage = pkg.ops.math.BinaryMathTransformer(op="plus")
    return a, b, stage, a.transform_with(stage, b)


def test_input_names_and_generator_names_equal_the_jax_package():
    for pkg in (T, J):
        a, b, stage, out = _wired(pkg)
        assert stage.input_names == ["a", "b"]
        assert a.origin_stage.make_output_name() == "a" == a.name
    assert _wired(T)[2].input_names == _wired(J)[2].input_names


def test_distributions_slot():
    for pkg in (T, J):
        a, _b, _stage, out = _wired(pkg)
        assert a.distributions == () and out.distributions == ()
        a.distributions = ("d",)
        assert a.distributions == ("d",)
        with pytest.raises(AttributeError):
            a.not_a_slot = 1


@pytest.mark.parametrize("tname", sorted(RC.TYPE_VALUES))
def test_to_values_with_a_type_equals_the_jax_package(tname):
    values = RC.TYPE_VALUES[tname]
    t = T.Dataset.from_features({"c": values}, {"c": getattr(T.types, tname)})["c"]
    j = J.Dataset.from_features({"c": values}, {"c": getattr(J.types, tname)})["c"]
    got = t.to_values(getattr(T.types, tname))
    assert got == t.to_values() == j.to_values(getattr(J.types, tname))


def test_bin_score_metrics_fields_equal_the_reference():
    tf = [(f.name, f.type) for f in dataclasses.fields(TBinScoreMetrics)]
    jf = [(f.name, f.type) for f in dataclasses.fields(JBinScoreMetrics)]
    assert tf == jf
    assert dataclasses.asdict(TBinScoreMetrics()) == dataclasses.asdict(JBinScoreMetrics())


def _fill_model(tmp_path):
    a = T.FeatureBuilder.Real("a").extract_field().as_predictor()
    est = FillMissingWithMean()
    filled = a.transform_with(est)
    ds = T.Dataset.from_features({"a": [1.0, None, 3.0, 4.0]}, {"a": T.types.Real})
    model = T.Workflow().set_input_dataset(ds).set_result_features(filled) \
        .train(device="cpu")
    path = str(tmp_path / "model")
    model.save(path)
    return model, path, est.uid


def test_is_model_set_by_fit_and_load_never_saved(tmp_path):
    model, path, uid = _fill_model(tmp_path)
    assert model.fitted[uid].is_model
    assert not FillMissingWithMeanModel(mean=1.0).is_model  # built, not fitted
    with gzip.open(os.path.join(path, "model.json.gz"), "rt") as fh:
        manifest = json.load(fh)
    assert all("is_model" not in s.get("attrs", {})
               for s in manifest["fitted"].values())
    for loaded in (TModel.load(path), JModel.load(path), TModel.load(FIXTURE)):
        assert loaded.fitted and all(t.is_model for t in loaded.fitted.values())
    ds = T.Dataset.from_features({"a": [None, 2.0]}, {"a": T.types.Real})
    jds = J.Dataset.from_features({"a": [None, 2.0]}, {"a": J.types.Real})
    name = model.fitted[uid].output_name
    got = TModel.load(path).score(ds, device="cpu")[name].to_values()
    assert got == JModel.load(path).score(jds)[name].to_values()
    assert got == pytest.approx([8 / 3, 2.0])
