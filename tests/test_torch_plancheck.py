"""plancheck on the port: the JAX package's ``tests/test_plancheck.py`` with
its fixtures written for torch — the meta-tensor cost trace (FLOPs, bytes,
peak device memory, order-sensitive ops, recompile hazards), the TM6xx
diagnostic family and the admission gates it powers
(``train(hbm_budget=...)``, serving admission, ``validate(cost=True)``).

Every seeded fixture fires its stable code exactly once, and the whole
analyzer runs on meta tensors: a full cost-validate pass makes meta tensors
only and counts no compile event (``perf/timers.py::measure_compiles``).

Translations: the reference's jaxpr walk becomes an aten-op trace, so
"traces through jit and scan" becomes "traces through a Python loop" and
"baked constants" are the stages' device constants (counted apart from the
transient storages, once); a hand-written kernel is a node of the trace
with its module's ``bound_ops``/``bound_bytes``.

Not translated: ``test_tm603_collective_under_single_host`` and
``test_collective_inventory_without_single_host_is_not_an_error``.  They
seed a ``with_sharding_constraint`` under a mesh, a layout hint with no
torch meaning; the port's TM603/608/609 cases trace its sharded programs
under a ``virtual_mesh`` (``tests/test_torch_mesh.py::TestStaticScalabilityGate``).

Cross-package: TM601 decides as the JAX package's does at budgets well
above and well below both packages' estimates (the bytes are each
package's own).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import transmogrifai_tpu as J
from transmogrifai_tpu_torch import (
    BinaryClassificationModelSelector,
    FeatureBuilder,
    Workflow,
    transmogrify,
)
from transmogrifai_tpu_torch.checkers.diagnostics import OpCheckError, Severity
from transmogrifai_tpu_torch.checkers.opcheck import validate_result_features
from transmogrifai_tpu_torch.checkers.plancheck import (
    CARD_RIDGE_INTENSITY,
    MEMORY_BOUND_INTENSITY,
    BucketCost,
    PlanCostReport,
    SegmentCost,
    analyze_program,
    cost_diagnostics,
    trace_cost,
)
from transmogrifai_tpu_torch.data.dataset import Column
from transmogrifai_tpu_torch.models.logistic import LogisticRegression
from transmogrifai_tpu_torch.perf.kernels import encode as KE
from transmogrifai_tpu_torch.perf.kernels import histogram as KH
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.perf.timers import measure_compiles
from transmogrifai_tpu_torch.readers.files import DataReaders
from transmogrifai_tpu_torch.stages.base import BinaryTransformer, UnaryTransformer
from transmogrifai_tpu_torch.types import OPVector, Real, RealNN


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


# ---------------------------------------------------------------------------
# fixture stages
# ---------------------------------------------------------------------------

class PcSortStage(UnaryTransformer):
    """Seeded TM605: a float sort in the device path (row-local: sorts a
    per-row pair, not across rows)."""

    input_types = (Real,)
    output_type = Real

    def transform_columns(self, cols, dataset):
        v = cols[0].values_f64()
        return Column.from_values(Real, list(np.minimum(v, v * 0.5)))

    def device_transform(self, x):
        pair = torch.stack([x, x * 0.5], dim=1)
        return torch.sort(pair, dim=1).values[:, 0]


class PcVecCombine(BinaryTransformer):
    """Device-capable consumer of raw OPVector features — the TM602
    data-dependent-width recompile hazard."""

    input_types = (OPVector, OPVector)
    output_type = OPVector

    def transform_columns(self, cols, dataset):
        return Column.vector(np.concatenate(
            [np.asarray(cols[0].data, np.float32),
             np.asarray(cols[1].data, np.float32)], axis=1))

    def device_transform(self, a, b):
        return torch.cat([a, b], dim=1)


def _raw(name, ftype=Real, response=False):
    b = FeatureBuilder.of(name, ftype).extract_field()
    return b.as_response() if response else b.as_predictor()


def _records(n=300, seed=11):
    rng = np.random.default_rng(seed)
    return [
        {"label": float(rng.random() < 0.5), "x1": float(rng.normal()),
         "color": str(rng.choice(["red", "green", "blue"])),
         "age": None if rng.random() < 0.1 else float(rng.normal(40, 10))}
        for _ in range(n)]


def _fitted(pkg, records):
    import pandas as pd

    fb = pkg.FeatureBuilder
    label = fb.RealNN("label").extract_field().as_response()
    vec = pkg.transmogrify([fb.Real("x1").extract_field().as_predictor(),
                            fb.PickList("color").extract_field().as_predictor(),
                            fb.Real("age").extract_field().as_predictor()])
    checked = label.sanity_check(vec)
    sel = pkg.BinaryClassificationModelSelector.with_train_validation_split(
        models=[(pkg.LogisticRegression(), [{"reg_param": 0.01}])])
    pred = label.transform_with(sel, checked)
    reader = pkg.DataReaders.Simple.dataframe(pd.DataFrame(records))
    return pkg.Workflow().set_result_features(label, pred).set_reader(reader).train()


def _pkg(name):
    """The names ``_fitted`` uses, from the port or the JAX package."""
    import types

    if name == "jax":
        from transmogrifai_tpu.models.logistic import LogisticRegression as JLR
        from transmogrifai_tpu.readers.files import DataReaders as JReaders

        return types.SimpleNamespace(
            FeatureBuilder=J.FeatureBuilder, transmogrify=J.transmogrify,
            BinaryClassificationModelSelector=J.BinaryClassificationModelSelector,
            LogisticRegression=JLR, DataReaders=JReaders, Workflow=J.Workflow)
    return types.SimpleNamespace(
        FeatureBuilder=FeatureBuilder, transmogrify=transmogrify,
        BinaryClassificationModelSelector=BinaryClassificationModelSelector,
        LogisticRegression=LogisticRegression, DataReaders=DataReaders,
        Workflow=Workflow)


@pytest.fixture(scope="module")
def fitted_model():
    """Small fitted workflow whose scoring plan has a real device prefix
    (vectorizers + combiner + sanity checker)."""
    with use_device("cpu"):
        return _fitted(_pkg("torch"), _records())


class _DeviceSpy(TorchDispatchMode):
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


# ---------------------------------------------------------------------------
# core: the aten-op trace
# ---------------------------------------------------------------------------

class TestTraceCost:
    def test_dot_general_flops_exact(self):
        seg = trace_cost(lambda x, y: x @ y, ((8, 4), "float32"), ((4, 3), "float32"),
                         name="matmul")
        assert seg.flops == 2 * 8 * 3 * 4
        assert seg.bytes_read >= (8 * 4 + 4 * 3) * 4
        assert seg.bytes_written >= 8 * 3 * 4
        assert seg.peak_live_bytes >= (8 * 4 + 4 * 3 + 8 * 3) * 4

    def test_elementwise_and_reduce_counts(self):
        seg = trace_cost(lambda v: (v * 2.0 + 1.0).sum(), ((64,), "float32"), name="ew")
        assert 3 * 64 <= seg.flops <= 6 * 64
        assert seg.op_counts.get("sum") == 1

    def test_trace_is_abstract_zero_compiles(self):
        with measure_compiles() as c, _DeviceSpy() as spy:
            seg = trace_cost(lambda v: (v @ v.T).sum(), ((128, 16), "float32"),
                             name="abstract")
        assert c.backend_compiles == 0 and c.events == {}
        assert spy.devices <= {"meta"}
        assert seg.flops > 0

    def test_traces_through_jit_and_scan(self):
        """A Python loop of ten steps (the port's scan) counts every trip."""
        def stepped(v):
            for _ in range(10):
                v = v * 1.5 + 1.0
            return v

        seg = trace_cost(stepped, ((32,), "float32"), name="loop")
        assert seg.flops >= 10 * 2 * 32

    def test_baked_constants_counted_once_in_peak(self):
        """A program closing over a host constant: the constant's copy onto
        the device is a stage constant (counted apart, by the plan), not a
        transient storage counted again in the peak."""
        w = np.ones((512, 512), np.float32)  # 1 MiB constant

        def f(x):
            return x @ torch.from_numpy(w).to(x.device)

        seg = trace_cost(f, ((4, 512), "float32"), name="const")
        assert seg.peak_live_bytes < 1.5 * w.nbytes
        assert seg.flops == 2 * 4 * 512 * 512

    def test_order_sensitive_ops_recorded(self):
        seg = trace_cost(lambda v: torch.sort(v, dim=1).values, ((16, 2), "float32"),
                         name="sort")
        assert seg.order_sorts >= 1

    def test_solve_counts_cubic(self):
        seg = trace_cost(lambda a, b: torch.linalg.solve_ex(a, b)[0],
                         ((3, 8, 8), "float32"), ((3, 8, 1), "float32"), name="solve")
        assert seg.flops >= 3 * (2 / 3) * 8 ** 3

    def test_kernel_nodes_carry_their_bounds(self):
        """A hand-written kernel is a node of the trace: its FLOPs and bytes
        are its module's own bounds, nothing launches or counts."""
        L, n, d, nn, n_bins = 2, 64, 4, 2, 8
        seg = trace_cost(lambda local, gh, b: KH.hist_level(local, gh, b, nn, n_bins,
                                                            int_exact=True),
                         ((L, n), "int32"), ((L, 2, n), "int8"), ((n, d), "int32"))
        assert seg.op_counts["kernel:hist_level"] == 1
        assert seg.flops == KH.bound_ops(L, n, d, 2)
        assert seg.bytes_total == KH.bound_bytes(L, n, d, nn, 2, n_bins, True)
        assert KH.launches == 0

    def test_encode_bounds_are_the_chip_script_s(self):
        """``encode.bound_bytes`` is the count the chip script used before it
        moved: each operand, the splits and the output once."""
        table = KE.slot_table((KE.onehot_slot(7),
                               KE.bucketize_slot([0.0, 1.0, 2.0], True, False)))
        ins = [torch.zeros(100, dtype=torch.int32), torch.zeros(100)]
        want = sum(x.numel() * 4 for x in ins) + table.splits.nbytes + 100 * table.width * 4
        assert KE.bound_bytes(100, table) == want
        assert KE.bound_ops(100, table) >= 100 * table.width

    def test_analyze_program_across_buckets(self):
        rep = analyze_program(lambda x: (x * 2.0).sum(),
                              [(b, [((b, 4), "float32")]) for b in (8, 64)])
        assert [b.bucket for b in rep.buckets] == [8, 64]
        assert rep.buckets[1].flops > rep.buckets[0].flops


# ---------------------------------------------------------------------------
# full model analysis + TM6xx wiring
# ---------------------------------------------------------------------------

class TestCostValidate:
    def test_cost_report_nonzero_and_zero_compiles(self, fitted_model):
        with measure_compiles() as c, _DeviceSpy() as spy:
            report = fitted_model.validate(serving=True, cost=True)
        assert c.backend_compiles == 0 and c.events == {}
        assert spy.devices <= {"meta"}, spy.devices
        cost = report.plan_cost
        assert cost is not None
        assert cost.total_flops > 0 and cost.total_bytes > 0
        assert cost.buckets, "per-bucket HBM estimates missing"
        assert all(b.peak_hbm_bytes > 0 for b in cost.buckets)
        peaks = [b.peak_hbm_bytes for b in cost.buckets]
        assert peaks == sorted(peaks)
        assert cost.segments, "per-stage segments missing"
        assert any(k["name"] == "encode_slots" for s in cost.segments
                   for k in s.kernels)
        d = cost.to_dict()
        assert d["totalFlops"] == cost.total_flops
        text = cost.pretty()
        assert "PlanCostReport" in text and "ridge point" in text
        assert f"{CARD_RIDGE_INTENSITY:.1f}" in text

    def test_default_validate_skips_cost(self, fitted_model):
        report = fitted_model.validate(serving=True)
        assert report.plan_cost is None
        assert not report.by_code("TM604")

    def test_tm601_fires_on_tiny_budget(self, fitted_model):
        report = fitted_model.validate(serving=True, hbm_budget=16)
        tm601 = report.by_code("TM601")
        assert len(tm601) == 1
        assert tm601[0].severity == Severity.ERROR
        assert report.errors()

    def test_generous_budget_is_clean(self, fitted_model):
        report = fitted_model.validate(serving=True, hbm_budget=1e15)
        assert not report.by_code("TM601")

    def test_tm604_memory_bound_worklist(self, fitted_model):
        report = fitted_model.validate(serving=True, cost=True)
        tm604 = report.by_code("TM604")
        assert len(tm604) == 1
        assert tm604[0].severity == Severity.INFO
        assert "fused-kernel" in tm604[0].message

    def test_unfitted_workflow_reports_hazards_only(self):
        label = _raw("label", RealNN, response=True)
        vec = transmogrify([_raw("x")])
        checked = label.sanity_check(vec)
        sel = BinaryClassificationModelSelector.with_train_validation_split(
            models=[(LogisticRegression(), [{"reg_param": 0.01}])])
        pred = label.transform_with(sel, checked)
        wf = Workflow().set_result_features(label, pred)
        report = wf.validate(cost=True)
        assert report.plan_cost is not None
        assert report.plan_cost.total_flops == 0
        assert any("unfitted" in n for n in report.plan_cost.notes)
        assert not report.by_code("TM606")
        armed = wf.validate(hbm_budget=1e9)
        tm606 = armed.by_code("TM606")
        assert len(tm606) == 1 and tm606[0].severity == Severity.ERROR
        assert armed.errors()

    def test_static_peak_matches_admission_number(self, fitted_model):
        """The report's per-bucket peaks are the admission estimate (the
        fleet's TM509 number): validate's meta plan sizes what the served
        plan sizes."""
        from transmogrifai_tpu_torch.checkers.plancheck import analyze_scoring_plan

        plan = fitted_model.serving_plan(device="cpu")
        live = analyze_scoring_plan(plan)
        static = fitted_model.validate(serving=True, cost=True).plan_cost
        assert [b.peak_hbm_bytes for b in static.buckets] == \
            [b.peak_hbm_bytes for b in live.buckets]


class TestSeededTm60x:
    def test_tm605_float_sort(self):
        out = _raw("a").transform_with(PcSortStage())
        report = validate_result_features([out], fitted={}, cost=True)
        tm605 = report.by_code("TM605")
        assert len(tm605) == 1
        assert tm605[0].severity == Severity.WARNING
        assert "sort" in tm605[0].message
        assert report.plan_cost.order_sorts >= 1
        assert report.plan_cost.to_dict()["orderSensitiveOps"]["sorts"] >= 1

    def test_no_mesh_means_no_collectives(self):
        """Without a mesh the collective inventory is empty and TM603 cannot
        fire, even under a single-host contract (the reference's unmeshed
        plans read the same)."""
        out = _raw("a").transform_with(PcSortStage())
        report = validate_result_features([out], fitted={}, cost=True,
                                          single_host=True)
        assert not report.by_code("TM603")
        assert report.plan_cost.collectives == {} and report.plan_cost.mesh is None
        assert report.plan_cost.collective_bytes_per_step == 0

    def test_tm602_data_dependent_width(self):
        va, vb = _raw("va", OPVector), _raw("vb", OPVector)
        out = va.transform_with(PcVecCombine(), vb)
        report = validate_result_features([out], fitted={}, cost=True)
        tm602 = report.by_code("TM602")
        assert len(tm602) == 2  # one per raw OPVector input
        assert all(d.severity == Severity.WARNING for d in tm602)
        assert {h.kind for h in report.plan_cost.hazards} == {"data_dependent_width"}

    def test_cost_diagnostics_threshold_is_configurable(self):
        seg = SegmentCost(name="s", flops=10, bytes_read=50, bytes_written=50)
        rep = PlanCostReport(plan="t", segments=[seg],
                             buckets=[BucketCost(8, 0, 400, 10, 50, 50)])
        assert [d.code for d in cost_diagnostics(rep)] == ["TM604"]
        assert cost_diagnostics(rep, intensity_threshold=0.01) == []
        assert seg.intensity < MEMORY_BOUND_INTENSITY


# ---------------------------------------------------------------------------
# admission gates: train(hbm_budget=...) and serving
# ---------------------------------------------------------------------------

class TestAdmissionGates:
    def _workflow(self, n=200):
        import pandas as pd

        rng = np.random.default_rng(5)
        records = [{"label": float(rng.random() < 0.5),
                    "x1": float(rng.normal()), "x2": float(rng.normal())}
                   for _ in range(n)]
        label = FeatureBuilder.RealNN("label").extract_field().as_response()
        vec = transmogrify([FeatureBuilder.Real("x1").extract_field().as_predictor(),
                            FeatureBuilder.Real("x2").extract_field().as_predictor()])
        checked = label.sanity_check(vec)
        sel = BinaryClassificationModelSelector.with_train_validation_split(
            models=[(LogisticRegression(), [{"reg_param": 0.01}])])
        pred = label.transform_with(sel, checked)
        return (Workflow().set_result_features(label, pred)
                .set_reader(DataReaders.Simple.dataframe(pd.DataFrame(records))))

    def test_train_hbm_budget_blocks_over_budget_plan(self):
        with pytest.raises(OpCheckError, match="TM601"):
            self._workflow().train(strict=True, hbm_budget=16)

    def test_train_generous_budget_trains(self):
        model = self._workflow().train(strict=True, hbm_budget=1e15)
        assert model.selector_model() is not None

    def test_workflow_cv_path_is_gated_too(self):
        with pytest.raises(OpCheckError, match="TM601"):
            self._workflow().with_workflow_cv().train(strict=True, hbm_budget=16)
        model = self._workflow().with_workflow_cv().train(strict=True, hbm_budget=1e15)
        assert model.selector_model() is not None

    def test_serving_plan_admission_blocks(self, fitted_model):
        with pytest.raises(OpCheckError, match="TM601"):
            fitted_model.serving_plan(hbm_budget=16, device="cpu")

    def test_scoring_server_admission_blocks(self, fitted_model):
        from transmogrifai_tpu_torch.serve import ScoringServer

        with pytest.raises(OpCheckError, match="TM601"):
            ScoringServer(fitted_model, hbm_budget=16, device="cpu")

    def test_check_plan_admission_direct(self, fitted_model):
        from transmogrifai_tpu_torch.serve.validator import check_plan_admission

        plan = fitted_model.serving_plan(device="cpu")
        blocked = check_plan_admission(plan, hbm_budget=16)
        assert [d.code for d in blocked] == ["TM601"]
        assert blocked.plan_cost is not None
        assert len(check_plan_admission(plan, hbm_budget=1e15)) == 0

    def test_admission_is_abstract_zero_compiles(self, fitted_model):
        from transmogrifai_tpu_torch.serve.validator import check_plan_admission

        plan = fitted_model.serving_plan(device="cpu")
        with measure_compiles() as c:
            check_plan_admission(plan, hbm_budget=1e15)
        assert c.backend_compiles == 0


# ---------------------------------------------------------------------------
# cross-package: TM601 decisions
# ---------------------------------------------------------------------------

def test_tm601_decisions_equal_the_jax_package(fitted_model):
    jm = _fitted(_pkg("jax"), _records())
    ours = fitted_model.validate(serving=True, cost=True).plan_cost.peak_hbm_bytes
    theirs = jm.validate(serving=True, cost=True).plan_cost.peak_hbm_bytes
    low, high = min(ours, theirs) / 4, max(ours, theirs) * 4
    for budget, fires in ((low, True), (high, False)):
        t = bool(fitted_model.validate(serving=True, hbm_budget=budget).by_code("TM601"))
        j = bool(jm.validate(serving=True, hbm_budget=budget).by_code("TM601"))
        assert t == j == fires, (budget, ours, theirs)
