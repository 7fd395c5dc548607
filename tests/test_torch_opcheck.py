"""opcheck on the port: the JAX package's ``tests/test_opcheck.py`` with its
fixture stages written for torch, and the port's ``validate()`` held to the
JAX package's on the same DAGs.

Each fixture workflow seeds exactly one violation and asserts its stable
diagnostic code fires exactly once; the clean-workflow tests assert zero
warning-or-worse findings on the example workflows.  Translations:

- ``OcBadConcat`` — the reference's ``lax.concatenate`` of float32 with
  int32 raises under ``jax.eval_shape``; torch promotes instead, so the
  port's seeded bug packs the block as integer codes (int64), which its
  TM204 catches as an output dtype the declared OPVector cannot take.
- ``OcHostSync`` — ``float(torch.sum(x))`` in place of ``float(jnp.sum(x))``;
  the lint sources use ``torch.``/``torch.compile`` where the reference's use
  ``jnp.``/``jax.jit``.
- "no device buffer" — ``jax.live_arrays()`` becomes a dispatch-mode spy:
  every op ``validate()`` runs makes meta tensors only.

Not translated: the stacked-fold TM204 pair
(``test_broken_stateful_form_fires_tm204_via_stacked_fold_eval``,
``test_stateful_output_drift_fires_tm204``): the port has no
``device_transform_stateful`` (its fold transforms run one plan per fold,
``workflow/plan.py::FoldTransformPlan``), so the form they check does not
exist in it.

Parity: for every DAG below, built once in each package, and for each of the
82 cases of ``tests/torch_registry_cases.py``, the port's findings equal the
JAX package's as a multiset of (code, severity, stage class), TM3xx aside
(the two packages lint different sources).
"""

import gzip
import importlib
import json
import os
import pkgutil
import sys
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import transmogrifai_tpu
import transmogrifai_tpu_torch
from transmogrifai_tpu.checkers.opcheck import (
    validate_result_features as j_validate,
)
from transmogrifai_tpu.ops.combiner import VectorsCombiner as JVectorsCombiner
from transmogrifai_tpu_torch import FeatureBuilder, Workflow, transmogrify
from transmogrifai_tpu_torch.checkers.diagnostics import (
    DagCycleError,
    OpCheckError,
    Severity,
)
from transmogrifai_tpu_torch.checkers.opcheck import (
    lint_source,
    lint_stage_class,
    validate_result_features,
)
from transmogrifai_tpu_torch.data.dataset import Column
from transmogrifai_tpu_torch.models.logistic import LogisticRegression
from transmogrifai_tpu_torch.models.selector import BinaryClassificationModelSelector
from transmogrifai_tpu_torch.ops.combiner import VectorsCombiner
from transmogrifai_tpu_torch.perf.timers import measure_compiles
from transmogrifai_tpu_torch.stages.base import (
    BinaryTransformer,
    UnaryEstimator,
    UnaryTransformer,
)
from transmogrifai_tpu_torch.types import Integral, OPVector, Real, RealNN, Text
from transmogrifai_tpu_torch.workflow.dag import compute_dag, cut_dag

import test_opcheck as JO  # the reference's fixture stages (JAX package)
import torch_examples_data as EX
import torch_registry_cases as RC


# ---------------------------------------------------------------------------
# fixture stages (module level so inspect.getsource works for the AST lint)
# ---------------------------------------------------------------------------

class OcScale(UnaryTransformer):
    input_types = (Real,)
    output_type = Real

    def transform_columns(self, cols, dataset):
        v = cols[0].values_f64() * 2.0
        return Column.from_values(Real, [None if np.isnan(x) else x for x in v])


class OcVectorize(UnaryTransformer):
    input_types = (Real,)
    output_type = OPVector

    def transform_columns(self, cols, dataset):
        return Column.vector(np.nan_to_num(
            cols[0].values_f64()).reshape(-1, 1).astype(np.float32))


class OcBadConcat(BinaryTransformer):
    """Seeded TM204: packs the block as integer codes (int64), not the
    float32 an OPVector is."""

    input_types = (Real, Integral)
    output_type = OPVector

    def device_transform(self, x, y):
        return torch.cat([x.reshape(-1, 1).long(), y.reshape(-1, 1).long()], dim=1)

    def transform_columns(self, cols, dataset):
        return Column.vector(np.stack(
            [cols[0].data, cols[1].data], axis=1).astype(np.float32))


class OcHostSync(UnaryTransformer):
    """Seeded TM301: float() on a torch reduction mid-transform."""

    input_types = (Real,)
    output_type = Real

    def transform_columns(self, cols, dataset):
        x = torch.as_tensor(cols[0].data)
        total = float(torch.sum(x))  # deliberate blocking host sync
        return Column.from_values(Real, [total] * len(cols[0]))


class OcFoldStateful(UnaryTransformer):
    """Clean stage with a device state: the port's fold plans run its plain
    ``device_transform`` once per fold."""

    input_types = (Real,)
    output_type = Real

    def transform_columns(self, cols, dataset):
        return Column.from_values(Real, list(cols[0].values_f64() * 2.0))

    def device_transform(self, x):
        return x * 2.0

    def device_state(self):
        return (np.asarray([2.0], np.float32),)


class OcLabelGrab(UnaryTransformer):
    """Seeded TM401: consumes the response as a plain input (no label slot)
    and emits a predictor-typed feature — the label leaks downstream."""

    input_types = (RealNN,)
    output_type = Real
    allow_label_as_input = True  # bypasses set_input's guard; opcheck catches it

    def transform_columns(self, cols, dataset):
        return Column.from_values(Real, list(cols[0].data))


class OcLabelEstimator(UnaryEstimator):
    """Label-dependent estimator (for cut_dag/TM402 tests): input IS the label."""

    input_types = (RealNN,)
    output_type = Real
    allow_label_as_input = True

    def _is_label_slot(self, feature, features):
        return feature is features[0]

    def fit_columns(self, cols, dataset):
        return OcScale()


def _raw(name, ftype=Real, response=False):
    b = FeatureBuilder.of(name, ftype).extract_field()
    return b.as_response() if response else b.as_predictor()


def _selector():
    return BinaryClassificationModelSelector.with_train_validation_split(
        models=[(LogisticRegression(), [{"reg_param": 0.01}])])


def _selector_workflow():
    """label + 2 predictors -> transmogrify -> sanity_check -> selector."""
    label = _raw("label", RealNN, response=True)
    x = _raw("x")
    v = x.transform_with(OcVectorize())
    checked = label.sanity_check(v)
    pred = label.transform_with(_selector(), checked)
    return label, pred


# ---------------------------------------------------------------------------
# TM101 — cycles
# ---------------------------------------------------------------------------

class TestCycleDetection:
    def _cyclic_features(self):
        a = _raw("a")
        s1, s2 = OcScale(), OcScale()
        o1 = a.transform_with(s1)
        o2 = o1.transform_with(s2)
        # force s1 to depend on s2's output: s1 -> s2 -> s1
        s1._input_features = (o2,)
        o1.parents = (o2,)
        return o2, s1, s2

    def test_compute_dag_raises_tm101_with_cycle_path(self):
        o2, s1, s2 = self._cyclic_features()
        with pytest.raises(DagCycleError) as ei:
            compute_dag([o2])
        assert ei.value.diagnostic.code == "TM101"
        assert s1.uid in ei.value.cycle_uids and s2.uid in ei.value.cycle_uids
        assert s1.uid in str(ei.value)

    def test_validate_reports_tm101_exactly_once(self):
        o2, s1, s2 = self._cyclic_features()
        report = validate_result_features([o2])
        assert [d.code for d in report] == ["TM101"]
        assert s2.uid in report.by_code("TM101")[0].message

    def test_set_result_features_raises_on_cycle(self):
        o2, *_ = self._cyclic_features()
        with pytest.raises(DagCycleError):
            Workflow().set_result_features(o2)


# ---------------------------------------------------------------------------
# TM102-TM106 — structural
# ---------------------------------------------------------------------------

class TestStructural:
    def test_duplicate_uid_fires_tm102_exactly_once(self):
        a, b = _raw("a"), _raw("b")
        s1 = OcScale()
        o1 = a.transform_with(s1)
        s2 = OcScale(uid=s1.uid)  # same class: constructor permits, DAG must not
        o2 = b.transform_with(s2)
        report = validate_result_features([o1, o2])
        assert len(report.by_code("TM102")) == 1
        assert s1.uid in report.by_code("TM102")[0].message

    def test_constructor_rejects_cross_class_uid_collision(self):
        s = OcScale()
        with pytest.raises(ValueError, match="TM102"):
            OcVectorize(uid=s.uid)

    def test_constructor_allows_same_class_uid_reuse(self):
        s = OcScale()
        assert OcScale(uid=s.uid).uid == s.uid  # e.g. re-loading a saved model

    def test_orphaned_wiring_fires_tm103(self):
        a, b = _raw("a"), _raw("b")
        s = OcScale()
        stale = a.transform_with(s)
        s.set_input(b)  # re-wire: `stale` no longer matches the stage output
        s.get_output()
        report = validate_result_features([stale])
        assert len(report.by_code("TM103")) == 1

    def test_duplicate_generator_uid_fires_tm102(self):
        a1, a2 = _raw("a"), _raw("b")
        a2.origin_stage.uid = a1.origin_stage.uid  # forge the collision
        out = a1.transform_with(OcScale())
        out2 = a2.transform_with(OcScale())
        report = validate_result_features([out, out2])
        assert len(report.by_code("TM102")) == 1

    def test_duplicate_raw_name_fires_tm104(self):
        a1, a2 = _raw("a"), _raw("a")  # two distinct generators, same column
        out = a1.transform_with(OcScale())
        out2 = a2.transform_with(OcScale())
        report = validate_result_features([out, out2])
        assert len(report.by_code("TM104")) == 1

    def test_two_selectors_fire_tm105_exactly_once(self):
        label = _raw("label", RealNN, response=True)
        v = _raw("x").transform_with(OcVectorize())
        pred1 = label.transform_with(_selector(), v)
        pred2 = label.transform_with(_selector(), v)
        report = validate_result_features([label, pred1, pred2])
        assert len(report.by_code("TM105")) == 1

    def test_lambda_extract_fires_tm106_info(self):
        f = FeatureBuilder.Real("z").extract(lambda r: r.get("z")).as_predictor()
        out = f.transform_with(OcScale())
        report = validate_result_features([out])
        tm106 = report.by_code("TM106")
        assert len(tm106) == 1 and tm106[0].severity == Severity.INFO

    def test_lambda_extract_saves_and_reloads_by_name(self, tmp_path):
        """What TM106's info promises, as the JAX package does it: a model
        whose raw feature extracts by a lambda saves (the extract written as
        the reference's ``__unserializable__`` marker), and the reloaded
        model extracts the column by name."""
        from transmogrifai_tpu_torch import Dataset
        from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel

        f = FeatureBuilder.Real("z").extract(lambda r: r.get("z")).as_predictor()
        out = f.transform_with(OcScale())
        ds = Dataset.from_features({"z": [1.0, 2.0]}, {"z": Real})
        model = Workflow().set_result_features(out).set_input_dataset(ds) \
            .train(device="cpu")
        model.save(str(tmp_path / "m"))
        back = WorkflowModel.load(str(tmp_path / "m"))
        got = back.score(ds, device="cpu")[out.name].values_f64()
        assert got.tolist() == [2.0, 4.0]


# ---------------------------------------------------------------------------
# TM2xx — type & shape inference (no data, no device buffers)
# ---------------------------------------------------------------------------

class _DeviceSpy(TorchDispatchMode):
    """Records the device of every tensor each op run inside it makes."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ != "lift_fresh":
            # (``torch.from_numpy`` of a stage constant wraps host memory
            # numpy already holds, and a 0-dim CPU tensor is a host scalar)
            self.devices.update(t.device.type for t in tree_leaves(out)
                                if isinstance(t, torch.Tensor)
                                and (t.dim() or t.device.type != "cpu"))
        return out


class TestTypeShape:
    def test_type_mismatch_fires_tm202(self):
        t = _raw("t", Text)
        s = OcScale()
        # bypass set_input's runtime guard, as a serde-loaded DAG would
        s._input_features = (t,)
        out = s.get_output()
        report = validate_result_features([out])
        assert len(report.by_code("TM202")) == 1

    def test_arity_mismatch_fires_tm201(self):
        a = _raw("a")
        s = OcBadConcat()
        s._input_features = (a,)  # needs 2 inputs
        out = s.get_output()
        report = validate_result_features([out])
        assert len(report.by_code("TM201")) == 1

    def test_dtype_mismatch_fires_tm204_via_eval_shape_alone(self):
        a, n = _raw("a"), _raw("n", Integral)
        bad = a.transform_with(OcBadConcat(), n)
        with _DeviceSpy() as spy:
            report = validate_result_features([bad])
        assert spy.devices <= {"meta"}, \
            f"validate() must make meta tensors only, made {spy.devices}"
        tm204 = report.by_code("TM204")
        assert len(tm204) == 1
        assert "dtype" in tm204[0].message
        assert report.errors()  # dtype mismatch is error severity

    def test_clean_device_transform_passes(self):
        a, b = _raw("a"), _raw("b")
        va, vb = a.transform_with(OcVectorize()), b.transform_with(OcVectorize())
        combined = va.transform_with(VectorsCombiner(), vb)
        report = validate_result_features([combined])
        assert not report.by_code("TM204")

    def test_output_type_drift_fires_tm203(self):
        a = _raw("a")
        s = OcScale()
        out = a.transform_with(s)
        s.output_type = Integral  # params changed after get_output()
        report = validate_result_features([out])
        assert len(report.by_code("TM203")) == 1

    def test_clean_device_state_stage_passes_stacked_fold_check(self):
        out = _raw("a").transform_with(OcFoldStateful())
        report = validate_result_features([out])
        assert not report.by_code("TM204"), report.pretty()

    def test_meta_run_exception_fires_tm204(self):
        """The other half of the port's TM204: a device half that raises on
        meta operands (a reshape to a size the block does not have)."""

        class OcBadReshape(UnaryTransformer):
            input_types = (Real,)
            output_type = Real

            def device_transform(self, x):
                return x.reshape(3, -1)[0]

        out = _raw("a").transform_with(OcBadReshape())
        tm204 = validate_result_features([out]).by_code("TM204")
        assert len(tm204) == 1 and "fails on meta operands" in tm204[0].message


# ---------------------------------------------------------------------------
# TM3xx — device-hazard AST lint
# ---------------------------------------------------------------------------

class TestHazardLint:
    def test_host_sync_stage_fires_tm301_exactly_once(self):
        out = _raw("a").transform_with(OcHostSync())
        report = validate_result_features([out])
        assert len(report.by_code("TM301")) == 1
        assert "float()" in report.by_code("TM301")[0].message

    def test_row_loop_fires_tm302(self):
        src = (
            "def transform_columns(self, cols, dataset):\n"
            "    out = []\n"
            "    for i in range(len(cols[0])):\n"
            "        out.append(cols[0].data[i] * 2)\n"
            "    return out\n")
        assert [f.code for f in lint_source(src)] == ["TM302"]

    def test_jit_call_in_body_fires_tm303(self):
        src = (
            "def transform_columns(self, cols, dataset):\n"
            "    f = torch.compile(lambda x: x * 2)\n"
            "    return f(cols[0].data)\n")
        assert "TM303" in [f.code for f in lint_source(src)]

    def test_jit_closure_fires_tm304(self):
        src = (
            "def fit_columns(self, cols, dataset):\n"
            "    @partial(torch.compile, dynamic=False)\n"
            "    def step(x, k=2):\n"
            "        return x * k\n"
            "    return step(cols[0].data)\n")
        assert "TM304" in [f.code for f in lint_source(src)]

    def test_inline_allow_marker_suppresses(self):
        src = (
            "def transform_columns(self, cols, dataset):\n"
            "    x = torch.as_tensor(cols[0].data)\n"
            "    total = float(torch.sum(x))  # opcheck: allow(TM301) one fetch\n"
            "    return total\n")
        assert lint_source(src) == []

    def test_shape_metadata_access_is_not_a_host_sync(self):
        src = (
            "def transform_columns(self, cols, dataset):\n"
            "    x = torch.as_tensor(cols[0].data)\n"
            "    n = int(x.shape[0])\n"  # static metadata, not a transfer
            "    m = int(len(x)) + int(x.numel()) + x.ndim\n"
            "    return n + m\n")
        assert lint_source(src) == []

    def test_subscript_index_is_not_device_tainted(self):
        src = (
            "def transform_columns(self, cols, dataset):\n"
            "    out = {}\n"
            "    for i, c in enumerate(cols):\n"
            "        out[i] = torch.sum(torch.as_tensor(c.data))\n"
            "    return float(i)\n")  # i is a host int; `out` is the device name
        assert lint_source(src) == []

    def test_host_conversion_result_is_not_device_tainted(self):
        src = (
            "def transform_columns(self, cols, dataset):\n"
            "    dev = torch.cumsum(torch.as_tensor(cols[0].data), 0)\n"
            "    host = dev.cpu()  # opcheck: allow(TM301) one fetch\n"
            "    return float(host[0])\n")  # host value: must NOT re-flag
        assert lint_source(src) == []

    def test_lint_stage_class_locates_method(self):
        findings = lint_stage_class(OcHostSync)
        assert len(findings) == 1
        assert findings[0].code == "TM301"
        assert findings[0].qualname == "OcHostSync.transform_columns"
        assert findings[0].filename.endswith("test_torch_opcheck.py")

    @pytest.mark.parametrize("line,what", [
        ("    v = x.item()\n", ".item()"),
        ("    v = x.tolist()\n", ".tolist()"),
        ("    v = x.cpu()\n", ".cpu()"),
        ("    v = x.numpy()\n", ".numpy()"),
        ("    v = bool(x.any())\n", "bool()"),
        ("    v = np.asarray(x)\n", "np.asarray()"),
        ("    torch.cuda.synchronize()\n", "torch.cuda.synchronize()"),
        ("    ev.synchronize()\n", ".synchronize()"),
    ], ids=["item", "tolist", "cpu", "numpy", "bool", "asarray", "cuda_sync",
            "event_sync"])
    def test_torch_host_syncs_fire_tm301(self, line, what):
        src = ("def device_transform(self, ev):\n"
               "    x = torch.ones(3, device='cuda')\n" + line + "    return x\n")
        found = lint_source(src)
        assert [f.code for f in found] == ["TM301"] and what in found[0].message

    def test_host_torch_helpers_are_not_device_roots(self):
        src = ("def transform_columns(self, cols, dataset):\n"
               "    a = torch.from_numpy(cols[0].data)\n"
               "    b = torch.finfo(torch.float32).max\n"
               "    return float(a[0]) + float(b) + int(a.numel())\n")
        assert lint_source(src) == []


# ---------------------------------------------------------------------------
# TM4xx — leakage
# ---------------------------------------------------------------------------

class TestLeakage:
    def test_label_in_feature_path_fires_tm401_exactly_once(self):
        label = _raw("label", RealNN, response=True)
        leaked = label.transform_with(OcLabelGrab())  # label -> "predictor"
        v = leaked.transform_with(OcVectorize())
        pred = label.transform_with(_selector(), v)
        report = validate_result_features([label, pred])
        assert len(report.by_code("TM401")) == 1
        assert report.errors()

    def test_sanctioned_label_slot_path_is_clean(self):
        label, pred = _selector_workflow()
        report = validate_result_features([label, pred])
        assert not report.by_code("TM401")

    def test_label_dependent_estimator_fires_tm402_info(self):
        label, pred = _selector_workflow()  # SanityChecker consumes the label
        report = validate_result_features([label, pred], workflow_cv=False)
        tm402 = report.by_code("TM402")
        assert len(tm402) == 1 and tm402[0].severity == Severity.INFO
        assert "SanityChecker" in tm402[0].message

    def test_workflow_cv_silences_tm402(self):
        label, pred = _selector_workflow()
        report = validate_result_features([label, pred], workflow_cv=True)
        assert not report.by_code("TM402")


# ---------------------------------------------------------------------------
# cut_dag edge cases
# ---------------------------------------------------------------------------

class TestCutDagEdges:
    def test_no_selector_returns_none(self):
        out = _raw("a").transform_with(OcScale())
        assert cut_dag([out]) is None

    def test_two_selectors_raise(self):
        label = _raw("label", RealNN, response=True)
        v = _raw("x").transform_with(OcVectorize())
        pred1 = label.transform_with(_selector(), v)
        pred2 = label.transform_with(_selector(), v)
        with pytest.raises(ValueError, match="exactly one ModelSelector"):
            cut_dag([label, pred1, pred2])

    def test_label_dependent_estimator_and_downstream_land_in_during(self):
        label = _raw("label", RealNN, response=True)
        x = _raw("x")
        est = OcLabelEstimator()
        enriched = label.transform_with(est)
        downstream = enriched.transform_with(OcScale())
        v = downstream.transform_with(OcVectorize())
        independent = OcScale()
        vx = x.transform_with(independent).transform_with(OcVectorize())
        vec = v.transform_with(VectorsCombiner(), vx)
        pred = label.transform_with(_selector(), vec)
        before, during, sel = cut_dag([label, pred])
        during_uids = {s.uid for s in during}
        before_uids = {s.uid for s in before}
        assert est.uid in during_uids
        assert downstream.origin_stage.uid in during_uids
        assert v.origin_stage.uid in during_uids
        assert independent.uid in before_uids
        assert sel.uid not in during_uids and sel.uid not in before_uids


# ---------------------------------------------------------------------------
# wiring: workflow.validate(), the strict train gate, serde uid checks
# ---------------------------------------------------------------------------

class TestWorkflowWiring:
    def test_validate_returns_report(self):
        label, pred = _selector_workflow()
        report = Workflow().set_result_features(label, pred).validate()
        assert not report.at_least(Severity.WARNING)

    def test_strict_train_raises_opcheck_error_before_touching_data(self):
        a, n = _raw("a"), _raw("n", Integral)
        bad = a.transform_with(OcBadConcat(), n)
        wf = Workflow().set_result_features(bad)
        # no dataset/reader attached: OpCheckError firing first proves the
        # gate runs before any data access (which would raise ValueError)
        with pytest.raises(OpCheckError, match="TM204"):
            wf.train(strict=True, device="cpu")

    def test_non_strict_train_unaffected_by_warnings(self):
        from transmogrifai_tpu_torch import Dataset

        out = _raw("a").transform_with(OcScale())
        ds = Dataset.from_features({"a": [1.0, 2.0, 3.0]}, {"a": Real})
        wf = Workflow().set_result_features(out).set_input_dataset(ds)
        model = wf.train(strict=True, device="cpu")  # clean: the gate passes
        assert model.score(ds, device="cpu").n_rows == 3

    def test_load_rejects_duplicate_manifest_uids(self, tmp_path):
        from transmogrifai_tpu_torch import Dataset
        from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel

        out = _raw("a").transform_with(OcScale())
        ds = Dataset.from_features({"a": [1.0, 2.0]}, {"a": Real})
        model = Workflow().set_result_features(out).set_input_dataset(ds) \
            .train(device="cpu")
        path = str(tmp_path / "m")
        model.save(path)
        manifest_path = os.path.join(path, "model.json.gz")
        with gzip.open(manifest_path, "rt") as fh:
            manifest = json.load(fh)
        manifest["stages"].append(dict(manifest["stages"][-1]))  # forge a dup
        with gzip.open(manifest_path, "wt") as fh:
            json.dump(manifest, fh)
        with pytest.raises(ValueError, match="TM102"):
            WorkflowModel.load(path)

    def test_validate_defaults_are_the_reference_s(self):
        import inspect

        from transmogrifai_tpu.workflow.workflow import Workflow as JWorkflow
        from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel
        from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel

        for t, j in ((Workflow.validate, JWorkflow.validate),
                     (WorkflowModel.validate, JModel.validate)):
            tp, jp = inspect.signature(t).parameters, inspect.signature(j).parameters
            assert list(tp) == list(jp)
            assert [p.default for p in tp.values()] == [p.default for p in jp.values()]


# ---------------------------------------------------------------------------
# zero false positives on the example workflows
# ---------------------------------------------------------------------------

class TestCleanWorkflows:
    """The acceptance contract: no warning-or-worse findings on the example
    workflows (TM402/TM106 advisories are informational)."""

    def _assert_clean(self, wf):
        report = wf.validate()
        noisy = report.at_least(Severity.WARNING)
        assert not noisy, report.pretty()

    def test_runner_style_workflow_clean(self):
        label = FeatureBuilder.RealNN("label").extract_field().as_response()
        fx = FeatureBuilder.Real("x").extract_field().as_predictor()
        fc = FeatureBuilder.PickList("c").extract_field().as_predictor()
        checked = label.sanity_check(transmogrify([fx, fc]))
        pred = label.transform_with(_selector(), checked)
        self._assert_clean(Workflow().set_result_features(label, pred))

    def test_titanic_e2e_workflow_clean(self):
        wf, _survived, _pred = EX.titanic_workflow(EX.records_reader([]))
        self._assert_clean(wf)

    def test_iris_example_workflow_clean(self):
        self._assert_clean(EX.OpIris().build_workflow())

    def test_boston_example_workflow_clean(self):
        self._assert_clean(EX.OpBoston().build_workflow())


# ---------------------------------------------------------------------------
# parity with the JAX package: the DAGs above, built once in each package
# ---------------------------------------------------------------------------

def _ns(pkg):
    """The fixtures of one package: the port's (this file) or the JAX
    package's (``tests/test_opcheck.py``)."""
    if pkg == "jax":
        from transmogrifai_tpu import types as t

        return types.SimpleNamespace(
            raw=JO._raw, Scale=JO.OcScale, Vectorize=JO.OcVectorize,
            BadConcat=JO.OcBadConcat, HostSync=JO.OcHostSync,
            FoldStateful=JO.OcFoldStateful, LabelGrab=JO.OcLabelGrab,
            LabelEstimator=JO.OcLabelEstimator, selector=JO._selector,
            Combiner=JVectorsCombiner, FB=JO.FeatureBuilder, t=t,
            validate=j_validate)
    from transmogrifai_tpu_torch import types as t

    return types.SimpleNamespace(
        raw=_raw, Scale=OcScale, Vectorize=OcVectorize, BadConcat=OcBadConcat,
        HostSync=OcHostSync, FoldStateful=OcFoldStateful, LabelGrab=OcLabelGrab,
        LabelEstimator=OcLabelEstimator, selector=_selector,
        Combiner=VectorsCombiner, FB=FeatureBuilder, t=t,
        validate=validate_result_features)


def _dag_cycle(ns):
    a = ns.raw("a")
    s1, s2 = ns.Scale(), ns.Scale()
    o1 = a.transform_with(s1)
    o2 = o1.transform_with(s2)
    s1._input_features = (o2,)
    o1.parents = (o2,)
    return [o2], {}


def _dag_dup_uid(ns):
    s1 = ns.Scale()
    o1 = ns.raw("a").transform_with(s1)
    return [o1, ns.raw("b").transform_with(ns.Scale(uid=s1.uid))], {}


def _dag_orphan(ns):
    s = ns.Scale()
    stale = ns.raw("a").transform_with(s)
    s.set_input(ns.raw("b"))
    s.get_output()
    return [stale], {}


def _dag_dup_generator_uid(ns):
    a1, a2 = ns.raw("a"), ns.raw("b")
    a2.origin_stage.uid = a1.origin_stage.uid
    return [a1.transform_with(ns.Scale()), a2.transform_with(ns.Scale())], {}


def _dag_dup_raw_name(ns):
    return [ns.raw("a").transform_with(ns.Scale()),
            ns.raw("a").transform_with(ns.Scale())], {}


def _dag_two_selectors(ns):
    label = ns.raw("label", ns.t.RealNN, response=True)
    v = ns.raw("x").transform_with(ns.Vectorize())
    return [label, label.transform_with(ns.selector(), v),
            label.transform_with(ns.selector(), v)], {}


def _dag_lambda_extract(ns):
    f = ns.FB.Real("z").extract(lambda r: r.get("z")).as_predictor()
    return [f.transform_with(ns.Scale())], {}


def _dag_type_mismatch(ns):
    s = ns.Scale()
    s._input_features = (ns.raw("t", ns.t.Text),)
    return [s.get_output()], {}


def _dag_arity(ns):
    s = ns.BadConcat()
    s._input_features = (ns.raw("a"),)
    return [s.get_output()], {}


def _dag_bad_concat(ns):
    return [ns.raw("a").transform_with(ns.BadConcat(), ns.raw("n", ns.t.Integral))], {}


def _dag_clean_combiner(ns):
    va = ns.raw("a").transform_with(ns.Vectorize())
    vb = ns.raw("b").transform_with(ns.Vectorize())
    return [va.transform_with(ns.Combiner(), vb)], {}


def _dag_output_drift(ns):
    s = ns.Scale()
    out = ns.raw("a").transform_with(s)
    s.output_type = ns.t.Integral
    return [out], {}


def _dag_device_state(ns):
    return [ns.raw("a").transform_with(ns.FoldStateful())], {}


def _dag_host_sync(ns):
    return [ns.raw("a").transform_with(ns.HostSync())], {}


def _dag_label_grab(ns):
    label = ns.raw("label", ns.t.RealNN, response=True)
    v = label.transform_with(ns.LabelGrab()).transform_with(ns.Vectorize())
    return [label, label.transform_with(ns.selector(), v)], {}


def _selector_dag(ns):
    label = ns.raw("label", ns.t.RealNN, response=True)
    checked = label.sanity_check(ns.raw("x").transform_with(ns.Vectorize()))
    return [label, label.transform_with(ns.selector(), checked)]


def _dag_selector(ns):
    return _selector_dag(ns), {}


def _dag_selector_wcv(ns):
    return _selector_dag(ns), {"workflow_cv": True}


def _dag_label_estimator(ns):
    label = ns.raw("label", ns.t.RealNN, response=True)
    v = label.transform_with(ns.LabelEstimator()).transform_with(ns.Scale()) \
        .transform_with(ns.Vectorize())
    vx = ns.raw("x").transform_with(ns.Scale()).transform_with(ns.Vectorize())
    return [label, label.transform_with(ns.selector(), v.transform_with(ns.Combiner(), vx))], {}


def _dag_selector_serving_cost(ns):
    return _selector_dag(ns), {"serving": True, "cost": True}


DAGS = {
    "cycle": _dag_cycle, "dup_uid": _dag_dup_uid, "orphan": _dag_orphan,
    "dup_generator_uid": _dag_dup_generator_uid, "dup_raw_name": _dag_dup_raw_name,
    "two_selectors": _dag_two_selectors, "lambda_extract": _dag_lambda_extract,
    "type_mismatch": _dag_type_mismatch, "arity": _dag_arity,
    "bad_concat": _dag_bad_concat, "clean_combiner": _dag_clean_combiner,
    "output_drift": _dag_output_drift, "device_state": _dag_device_state,
    "host_sync": _dag_host_sync, "label_grab": _dag_label_grab,
    "selector": _dag_selector, "selector_workflow_cv": _dag_selector_wcv,
    "label_estimator": _dag_label_estimator,
    "selector_serving_cost": _dag_selector_serving_cost,
}


def _multiset(report):
    """(code, severity, stage class) of every finding but TM3xx; the class
    is the uid's prefix (a uid is ``<Class>_<12 hex>``)."""
    return sorted((d.code, str(d.severity),
                   d.stage_uid.rsplit("_", 1)[0] if d.stage_uid else None)
                  for d in report if not d.code.startswith("TM3"))


@pytest.mark.parametrize("name", sorted(DAGS))
def test_validate_equals_the_jax_package_on_each_dag(name):
    features_t, kw = DAGS[name](_ns("torch"))
    features_j, _ = DAGS[name](_ns("jax"))
    got = _multiset(validate_result_features(features_t, **kw))
    want = _multiset(j_validate(features_j, **kw))
    assert got == want


@pytest.mark.parametrize("name", ["iris", "boston"])
def test_validate_equals_the_jax_package_on_the_example_apps(name):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    if name == "iris":
        from iris_app import OpIris as JApp
        wf = EX.OpIris().build_workflow()
    else:
        from boston_app import OpBoston as JApp
        wf = EX.OpBoston().build_workflow()
    assert _multiset(wf.validate()) == _multiset(JApp().build_workflow().validate())


# -- the registry sweep's cases ---------------------------------------------------

for _pkg in (transmogrifai_tpu, transmogrifai_tpu_torch):
    for _m in pkgutil.walk_packages(_pkg.__path__, prefix=_pkg.__name__ + "."):
        if "__main__" not in _m.name:
            importlib.import_module(_m.name)


def _registry_pkgs():
    from transmogrifai_tpu import types as JT
    from transmogrifai_tpu.data import dataset as JD
    from transmogrifai_tpu.features import builder as JFB
    from transmogrifai_tpu.stages import base as JB
    from transmogrifai_tpu.utils import vector_metadata as JVM
    from transmogrifai_tpu_torch import types as TT
    from transmogrifai_tpu_torch.data import dataset as TD
    from transmogrifai_tpu_torch.features import builder as TFB
    from transmogrifai_tpu_torch.stages import base as TB
    from transmogrifai_tpu_torch.utils import vector_metadata as TVM

    return RC.namespace(TD, TB, TT, TVM, TFB), RC.namespace(JD, JB, JT, JVM, JFB)


TPKG, JPKG = _registry_pkgs()


@pytest.mark.parametrize("name", sorted(RC.CASES))
def test_validate_equals_the_jax_package_on_each_registry_case(name):
    t_stage, _, _ = RC.build(TPKG, name)
    j_stage, _, _ = RC.build(JPKG, name)
    assert _multiset(validate_result_features([t_stage.get_output()])) \
        == _multiset(j_validate([j_stage.get_output()]))


# ---------------------------------------------------------------------------
# zero cost: validate allocates on meta only and counts no compile event
# ---------------------------------------------------------------------------

def test_validate_and_cost_make_meta_tensors_only_and_no_compile_event():
    label, pred = _selector_workflow()
    with measure_compiles() as probe, _DeviceSpy() as spy:
        report = Workflow().set_result_features(label, pred).validate(
            serving=True, cost=True)
    assert spy.devices <= {"meta"}, spy.devices
    assert probe.events == {} and probe.backend_compiles == 0
    assert report.plan_cost is not None and not report.errors()


def test_validate_equals_the_jax_package_on_a_loaded_model():
    """A saved model's estimator nodes load as stubs in the port (the JAX
    package loads the estimator classes): the stubs declare their classes'
    wiring, so the loaded DAG validates as the reference's does, for the
    workflow over its features and for the fitted model."""
    import transmogrifai_tpu as J
    import transmogrifai_tpu_torch as T

    path = os.path.join(os.path.dirname(__file__), "..", "transmogrifai_tpu_torch",
                        "fixtures", "serving_wide")
    tm, jm = T.WorkflowModel.load(path), J.WorkflowModel.load(path)
    assert _multiset(T.Workflow().set_result_features(*tm.result_features).validate()) \
        == _multiset(J.Workflow().set_result_features(*jm.result_features).validate())
    assert _multiset(tm.validate()) == _multiset(jm.validate())
