"""Reduced-precision prefix classes of the port's serving plan
(``serve/plan.py::Precision``, ``lower_block``; ``serve/validator.py``'s
TM511 gate) on the CPU, held against the JAX package.

The port's counterpart of the reference's ``tests/test_precision.py`` (its
17 tests, each under its name; the ``cli top`` console is not ported, so
its rendering test checks the fleet's ``statusz`` precision column), with
that file's model trained by the JAX package and loaded into the port.
Then the parity, against the JAX plan's compiled prefix on the same
inputs:

- ``entry_specs`` equal, in the reference's entry order, so the TM511
  synthetic batch (``default_rng(511)``, drawn in that order) is the same
  and its ``max_precision_delta`` agrees within 1e-6;
- int8 prefix outputs bitwise (``amax``, IEEE division and half-even
  rounding are exact; XLA compiles ``max|x| / 127`` into a multiply by
  float32(1/127) and keeps ``x / scale`` a division, as the port does);
- bf16 prefix outputs within 1 bf16 ulp (relative 2^-8) and scores within
  1e-3 (measured: bitwise on this model and on serving_wide);
- each prefix stage's ``device_transform`` under a bf16 operand gives the
  reference's dtype and values (JAX promotes a bf16 array with a
  strongly typed float32 constant to float32 and keeps bf16 with a Python
  scalar; torch's 0-dim tensors do not promote).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transmogrifai_tpu.serve as JS
import transmogrifai_tpu_torch.serve as TS
from transmogrifai_tpu_torch.checkers.diagnostics import OpCheckError
from transmogrifai_tpu_torch.serve import (
    TM511_BOUNDS,
    FleetServer,
    Precision,
    check_precision_parity,
    compile_plan,
)
from transmogrifai_tpu_torch.serve.registry import ModelRegistry
from transmogrifai_tpu_torch.serve.plan import lower_block
from transmogrifai_tpu_torch.serve.validator import _calibration_entries
from transmogrifai_tpu_torch.types import Prediction

import torch_fleet_data as FD

MIN_BUCKET, MAX_BUCKET = FD.MIN_BUCKET, FD.MAX_BUCKET
CPU = {"device": "cpu"}
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    jm, records = FD.train_precision_model()
    tm = FD.port_copy(jm, str(tmp_path_factory.mktemp("precision") / "m"))
    return jm, tm, records


@pytest.fixture(scope="module")
def model_and_records(both):
    return both[1], both[2]


def _plan(model, precision=None):
    return compile_plan(model, min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET,
                        strict=False, precision=precision, **CPU)


def _jplan(model, precision=None):
    return JS.compile_plan(model, min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET,
                           strict=False, precision=precision)


def _unlabeled(records, n=128):
    return [{k: v for k, v in r.items() if k != "label"} for r in records[:n]]


class TestPrecisionClass:
    def test_normalize_aliases(self):
        assert Precision.normalize(None) == Precision.F32
        assert Precision.normalize("f32") == Precision.F32
        assert Precision.normalize("float32") == Precision.F32
        assert Precision.normalize("FP32") == Precision.F32
        assert Precision.normalize("bf16") == Precision.BF16
        assert Precision.normalize("BFloat16") == Precision.BF16
        assert Precision.normalize("int8") == Precision.INT8
        assert Precision.normalize("i8") == Precision.INT8

    def test_unknown_class_refused_fail_closed(self):
        with pytest.raises(ValueError, match="precision"):
            Precision.normalize("fp8")

    def test_every_reduced_class_has_a_documented_bound(self):
        assert TM511_BOUNDS == JS.TM511_BOUNDS
        assert TM511_BOUNDS[Precision.BF16] == 1e-2
        assert TM511_BOUNDS[Precision.INT8] == 5e-2
        assert Precision.F32 not in TM511_BOUNDS


class TestFingerprints:
    def test_f32_fingerprint_does_not_move(self, model_and_records):
        model = model_and_records[0]
        plan = _plan(model)
        assert plan.fingerprint == _plan(model, precision="float32").fingerprint
        # the hash an f32 plan had before precision classes existed
        assert plan.fingerprint == plan.prefix_fingerprint(environment=True)

    def test_reduced_classes_fork_the_fingerprint(self, model_and_records):
        model = model_and_records[0]
        fps = {p: _plan(model, precision=p).fingerprint for p in (None, "bf16", "int8")}
        assert len(set(fps.values())) == 3, fps

    def test_precision_property(self, model_and_records):
        model = model_and_records[0]
        assert _plan(model).precision == "f32"
        assert _plan(model, precision="bf16").precision == "bf16"
        assert _plan(model, precision="i8").precision == "int8"


class TestParity:
    @pytest.mark.parametrize("precision", ["bf16", "int8"])
    def test_deterministic_and_within_bound(self, model_and_records, precision):
        model, records = model_and_records
        f32 = _plan(model)
        reduced = _plan(model, precision=precision)
        batch = _unlabeled(records)
        assert reduced.score(batch) == _plan(model, precision=precision).score(batch)
        report = check_precision_parity(f32, reduced, records=batch)
        assert not report.errors(), report.pretty()
        delta = report.max_precision_delta
        assert delta is not None
        assert 0.0 < delta <= TM511_BOUNDS[Precision.normalize(precision)]

    def test_synthetic_gate_runs_without_records(self, model_and_records):
        model = model_and_records[0]
        report = check_precision_parity(_plan(model), _plan(model, precision="bf16"))
        assert not report.errors(), report.pretty()
        assert report.max_precision_delta is not None

    def test_continuous_scores_bounded_not_argmax(self, model_and_records):
        model, records = model_and_records
        rows = _plan(model, precision="int8").score(_unlabeled(records))
        pred_name = next(n for n, v in rows[0].items() if isinstance(v, dict))
        assert Prediction.PredictionName in rows[0][pred_name]

    def test_int8_quantizer_is_nan_safe(self, model_and_records):
        x = torch.tensor([[1.0, -3.5, float("nan"), 0.25, float("inf"), 0.0]])
        out = lower_block(x, Precision.INT8)[0].numpy()
        assert np.isnan(out[2]) and np.isinf(out[4])
        finite = np.isfinite(x[0].numpy())
        assert np.allclose(out[finite], x[0].numpy()[finite], atol=3.5 / 127 + 1e-6)
        zeros = lower_block(torch.zeros((1, 8)), Precision.INT8)
        assert np.array_equal(zeros.numpy(), np.zeros((1, 8)))


class TestRegistryGate:
    def test_reduced_class_admitted_with_calibration(self, model_and_records):
        model, records = model_and_records
        reg = ModelRegistry(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET, **CPU)
        state = reg.register("quant", model, precision="bf16",
                             calibration=records[:64], warm=False)
        assert state.swapper.active.plan.precision == "bf16"
        assert reg.metrics()["tenants"]["quant"]["precision"] == "bf16"
        reg.unregister("quant")

    def test_tightened_bound_refuses_fail_closed(self, model_and_records, monkeypatch):
        model, records = model_and_records
        monkeypatch.setitem(TM511_BOUNDS, Precision.BF16, 1e-12)
        reg = ModelRegistry(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET, **CPU)
        with pytest.raises(OpCheckError, match="TM511"):
            reg.register("quant", model, precision="bf16",
                         calibration=records[:64], warm=False)
        assert "quant" not in reg

    def test_undocumented_bound_refuses_fail_closed(self, model_and_records, monkeypatch):
        model, records = model_and_records
        monkeypatch.delitem(TM511_BOUNDS, Precision.INT8)
        reg = ModelRegistry(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET, **CPU)
        with pytest.raises(OpCheckError, match="TM511"):
            reg.register("quant", model, precision="int8",
                         calibration=records[:64], warm=False)

    def test_swap_to_other_precision_refused_tm507(self, model_and_records):
        model, records = model_and_records
        reg = ModelRegistry(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET, **CPU)
        reg.register("t", model, warm=False)
        with pytest.raises(OpCheckError, match="TM507"):
            reg.stage_candidate("t", model, precision="bf16", warm=False,
                                calibration=records[:64])
        reg.unregister("t")

    def test_same_precision_swap_stages(self, model_and_records):
        model, records = model_and_records
        reg = ModelRegistry(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET, **CPU)
        reg.register("t", model, precision="bf16", calibration=records[:64], warm=False)
        assert reg.stage_candidate("t", model, precision="bf16", warm=False,
                                   calibration=records[:64])
        reg.unregister("t")

    def test_f32_coresident_with_reduced_class(self, model_and_records):
        model, records = model_and_records
        reg = ModelRegistry(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET, **CPU)
        a = reg.register("full", model, warm=False)
        b = reg.register("quant", model, precision="bf16",
                         calibration=records[:64], warm=False)
        assert a.swapper.active.fingerprint != b.swapper.active.fingerprint
        assert a.swapper.active.fingerprint == _plan(model).fingerprint
        m = reg.metrics()["tenants"]
        assert m["full"]["precision"] == "f32"
        assert m["quant"]["precision"] == "bf16"
        reg.unregister("full")
        reg.unregister("quant")


class TestConsoleRendering:
    def test_top_renders_precision_column(self, model_and_records):
        """The reference renders statusz in ``cli top`` (not ported); the
        port's statusz carries each tenant's class."""
        model, records = model_and_records
        with FleetServer(max_batch=8, max_wait_ms=1, min_bucket=MIN_BUCKET,
                         max_bucket=MAX_BUCKET, **CPU) as fleet:
            fleet.register("full", model, slo="gold", warm=False)
            fleet.register("quant", model, slo="bronze", precision="bf16",
                           calibration=records[:64], warm=False)
            status = fleet.statusz()
        assert status["tenants"]["full"]["precision"] == "f32"
        assert status["tenants"]["quant"]["precision"] == "bf16"


class TestJaxParity:
    def test_entry_specs_equal_in_the_reference_order(self, both):
        jm, tm, _ = both
        for p in (None, "bf16", "int8"):
            assert _plan(tm, p).entry_specs == [tuple(s) for s in _jplan(jm, p).entry_specs]
        j, t = _jplan(jm), _plan(tm)
        assert [list(k) for k in t._entry_keys] == [list(k) for k in j._entry_keys]

    @pytest.mark.parametrize("precision", ["bf16", "int8"])
    def test_synthetic_delta_equals_the_reference(self, both, precision):
        jm, tm, _ = both
        want = JS.check_precision_parity(_jplan(jm), _jplan(jm, precision))
        got = check_precision_parity(_plan(tm), _plan(tm, precision))
        assert abs(got.max_precision_delta - want.max_precision_delta) <= 1e-6
        assert [d.code for d in got] == [d.code for d in want]

    @pytest.mark.parametrize("precision", ["bf16", "int8"])
    def test_prefix_outputs_against_the_jax_program(self, both, precision):
        jm, tm, records = both
        jp, tp = _jplan(jm, precision), _plan(tm, precision)
        batch = _unlabeled(records, 64)
        for entries in (tp._encode_records(batch)[1], _calibration_entries(tp, 64)):
            want = [np.asarray(a) for a in jp._ensure_compiled(64)(*entries)]
            got = tp._fused(*entries)
            assert len(got) == len(want)
            for w, g in zip(want, got):
                assert g.dtype == w.dtype and g.shape == w.shape
                if precision == "int8":
                    assert np.array_equal(g, w, equal_nan=True)
                else:
                    ok = np.isnan(w) == np.isnan(g)
                    assert ok.all()
                    fin = ~np.isnan(w)
                    assert np.all(np.abs(g[fin] - w[fin])
                                  <= BF16_ULP * np.maximum(np.abs(w[fin]), 1e-30))
        want = jp.score(batch)
        got = tp.score(batch)
        key = next(iter(want[0]))
        assert max(abs(a[key][k] - b[key][k]) for a, b in zip(want, got)
                   for k in a[key]) <= 1e-3

    def test_lowering_equals_the_jax_formula(self):
        """The int8 lowering against the reference's ``_lower_entry`` as XLA
        compiles it, over magnitudes from 1e-6 to 1e6 with NaN and inf."""
        from transmogrifai_tpu.serve.plan import CompiledScoringPlan as JPlan

        lower = jax.jit(lambda x: JPlan._lower_entry(
            type("P", (), {"_precision": "int8"})(), x))
        rng = np.random.default_rng(0)
        rows = []
        for k in range(48):
            x = (rng.standard_normal(96) * 10.0 ** rng.uniform(-6, 6)).astype(np.float32)
            x[k % 96] = np.nan
            if k % 5 == 0:
                x[(k + 7) % 96] = np.inf
            rows.append(x)
        block = np.stack(rows)
        got = lower_block(torch.from_numpy(block), Precision.INT8).numpy()
        want = np.stack([np.asarray(lower(jnp.asarray(r))) for r in rows])
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        bf = lower_block(torch.from_numpy(block), Precision.BF16).float().numpy()
        assert np.array_equal(bf, np.asarray(jnp.asarray(block, jnp.bfloat16)
                                             .astype(jnp.float32)), equal_nan=True)

    @pytest.mark.parametrize("stage", ["fill", "scaler", "percentile", "bucketizer",
                                       "numeric", "binary", "realnn", "combiner"])
    def test_stage_under_bf16_follows_the_reference(self, stage):
        import transmogrifai_tpu.ops.combiner as JC
        import transmogrifai_tpu.ops.numeric as JN
        import transmogrifai_tpu.ops.scalers as JSc
        import transmogrifai_tpu_torch.ops.combiner as TC
        import transmogrifai_tpu_torch.ops.numeric as TN
        import transmogrifai_tpu_torch.ops.scalers as TSc

        rng = np.random.default_rng(3)
        x = (rng.standard_normal((64, 3)) * 3).astype(np.float32)
        x[::5, 0] = np.nan
        splits = np.array([-np.inf, -1.3, 0.1, 0.77, np.inf])
        make = {
            "fill": lambda M: M.FillMissingWithMeanModel(mean=0.123456789),
            "scaler": lambda M: M.StandardScalerModel(mean=0.3333333, std=1.7777777),
            "percentile": lambda M: M.PercentileCalibratorModel(splits=splits),
            "bucketizer": lambda M: M.NumericBucketizer(
                splits=(-np.inf, -1.0, 0.5, np.inf), track_nulls=True),
            "numeric": lambda M: _fitted_numeric(M),
            "binary": lambda M: M.BinaryVectorizer(),
            "realnn": lambda M: M.RealNNVectorizer(),
            "combiner": lambda M: M.VectorsCombiner(),
        }[stage]
        mods = {"fill": (JSc, TSc), "scaler": (JSc, TSc), "percentile": (JSc, TSc),
                "bucketizer": (JSc, TSc), "combiner": (JC, TC)}.get(stage, (JN, TN))
        jst, tst = make(mods[0]), make(mods[1])
        cols = 1 if stage in ("fill", "scaler", "percentile", "bucketizer") else 3
        jops = [jnp.asarray(x[:, i], jnp.bfloat16) for i in range(cols)]
        tops = [torch.from_numpy(x[:, i]).to(torch.bfloat16) for i in range(cols)]
        if stage == "combiner":   # a bf16 block beside a float32 one, unified
            jops = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(x, jnp.float32)]
            tops = [torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(x)]
            from transmogrifai_tpu_torch.workflow.plan import _unify_float_dtypes

            tops = _unify_float_dtypes(tops)
            jops = [o.astype(jnp.float32) for o in jops]
        want = jax.jit(jst.device_transform)(*jops)
        got = tst.device_transform(*tops)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                              equal_nan=True)


def _fitted_numeric(M):
    """A NumericVectorizerModel of three inputs with fitted fills."""
    return M.NumericVectorizerModel(fills=np.array([0.5, -1.25, 3.0]), track_nulls=True)
