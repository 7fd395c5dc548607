"""The continual loop of the port (``workflow/continual.py``) against the JAX
package: drift statistics and codes exactly the reference's (float64 host
code, copied), the promotion gate's decisions, and the end-to-end loop
(stream -> drift -> warm refit -> shadow -> swap) on
``tests/test_continual.py``'s records with an LR selector held to the JAX
package's record (``fixtures/streaming/continual.json``): the same
counters and diagnostic codes (the reference's TM809 for an XLA compile of
its own aside), candidate coefficients within 1e-6, the refit's prefix
reused with 0 kernel builds or loads.  Also the diagnostic and metric
catalogues this slice copies, and the build/load counter of
``perf/kernels/dispatch.py`` that a refit reads.
"""

import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

import transmogrifai_tpu.checkers.diagnostics as JD
import transmogrifai_tpu.obs.metrics as JM
import transmogrifai_tpu.readers.base as J_rb
import transmogrifai_tpu.workflow.continual as JC
import transmogrifai_tpu_torch as T
import transmogrifai_tpu_torch.checkers.diagnostics as TD
import transmogrifai_tpu_torch.obs.metrics as TM
import transmogrifai_tpu_torch.workflow.continual as TC
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu_torch.models.logistic import LogisticRegression
from transmogrifai_tpu_torch.perf import measure_compiles
from transmogrifai_tpu_torch.perf.kernels import dispatch
from transmogrifai_tpu_torch.readers import ListSource, MicroBatchStreamingReader
from transmogrifai_tpu_torch.readers.base import rows_to_dataset
from transmogrifai_tpu_torch.serve import (
    FaultHarness,
    ScoringServer,
    TransientScoringError,
)
from transmogrifai_tpu_torch.workflow.workflow import dedup_raw_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_stream_data as S  # noqa: E402

with open(os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "streaming",
                       "continual.json")) as _fh:
    RECORD = json.load(_fh)

CPU = {"device": "cpu"}
PKG = types.SimpleNamespace(
    FeatureBuilder=T.FeatureBuilder, transmogrify=T.transmogrify,
    BinaryClassificationModelSelector=T.BinaryClassificationModelSelector,
    LogisticRegression=LogisticRegression, Workflow=T.Workflow,
    rows_to_dataset=rows_to_dataset, dedup_raw_features=dedup_raw_features,
    ScoringServer=ScoringServer, ListSource=ListSource,
    MicroBatchStreamingReader=MicroBatchStreamingReader, FaultHarness=FaultHarness,
    TransientScoringError=TransientScoringError, continual=TC)


@pytest.fixture(scope="module")
def base():
    return S.continual_base(PKG, CPU)


def _raws(pkg_fb):
    label = pkg_fb.RealNN("label").extract_field().as_response()
    return [label] + [pkg_fb.Real(f"num{j}").extract_field().as_predictor()
                      for j in range(3)]


def _both(records):
    """The same records as a dataset of each package, and its raw features."""
    jr, tr = _raws(JFB), _raws(T.FeatureBuilder)
    return (J_rb.rows_to_dataset(records, jr, allow_missing_response=True), jr), \
        (rows_to_dataset(records, tr, allow_missing_response=True), tr)


class TestCatalogues:
    def test_tm8xx_codes_are_the_reference_codes(self):
        ref = {c: v for c, v in JD.DIAGNOSTIC_CODES.items() if c.startswith("TM8")}
        got = {c: v for c, v in TD.DIAGNOSTIC_CODES.items() if c.startswith("TM8")}
        assert sorted(got) == sorted(ref) and len(got) == 13
        for code, (sev, title, hint) in ref.items():
            assert (got[code][0].name, got[code][1]) == (sev.name, title), code
            if code not in ("TM809", "TM821"):   # no XLA compile, no mesh rung
                assert got[code][2] == hint, code

    def test_continual_metrics_are_the_reference_entries(self):
        ref = {k: v for k, v in JM.CANONICAL_METRICS.items() if "continual" in k}
        got = {k: v for k, v in TM.CANONICAL_METRICS.items() if "continual" in k}
        assert got == ref and len(got) == 11

    def test_build_counter_counts_builds_and_loads(self, monkeypatch, tmp_path):
        monkeypatch.setattr(dispatch, "_LIBS", {})
        monkeypatch.setattr(dispatch, "build", lambda names: {n: "/x.so" for n in names})
        monkeypatch.setattr(dispatch.ctypes, "CDLL", lambda path: types.SimpleNamespace())
        with measure_compiles() as probe:
            dispatch.load("probe", {})
            dispatch.load("probe", {})
        assert probe.events == {"library_load": 1}
        assert probe.backend_compiles == 1


class TestDrift:
    @pytest.mark.parametrize("shift, missing, n", [
        (0.0, 0.0, 512), (3.0, 0.0, 512), (0.0, 0.5, 400), (0.0, 1.0, 300),
        (0.2, 0.1, 150), (-1.0, 0.0, 64)])
    def test_statistics_and_codes_exactly_the_reference(self, shift, missing, n):
        (jtrain, jr), (ttrain, tr) = _both(S.make_records(S.N_TRAIN, 1))
        jsnap = JC.TrainingSnapshot.from_dataset(jtrain, features=jr)
        tsnap = TC.TrainingSnapshot.from_dataset(ttrain, features=tr)
        assert tsnap.to_dict() == jsnap.to_dict()
        jdet, tdet = JC.DriftDetector(jsnap), TC.DriftDetector(tsnap)
        recs = S.make_records(n, 40, shift=shift, missing_rate=missing)
        for i in range(0, n, 100):
            (jb, _), (tb, _) = _both(recs[i:i + 100])
            jdet.observe(jb)
            tdet.observe(tb)
        assert _nan_safe(tdet.feature_stats()) == _nan_safe(jdet.feature_stats())
        jrep, trep = jdet.evaluate(), tdet.evaluate()
        assert [(d.code, d.message, d.location) for d in trep] == \
            [(d.code, d.message, d.location) for d in jrep]
        assert TC.DriftDetector.drifted(trep) == JC.DriftDetector.drifted(jrep)

    def test_constant_feature_moved_to_a_new_constant(self):
        out = []
        for mod, fb, rb in ((JC, JFB, J_rb.rows_to_dataset), (TC, T.FeatureBuilder,
                                                               rows_to_dataset)):
            f = fb.Real("c").extract_field().as_predictor()
            snap = mod.TrainingSnapshot.from_dataset(
                rb([{"c": 1.0}] * 300, [f]), features=[f])
            det = mod.DriftDetector(snap, min_records=10)
            det.observe(rb([{"c": 2.0}] * 50, [f]))
            out.append([(d.code, d.message) for d in det.evaluate()])
        assert out[0] == out[1] and out[1][0][0] == "TM802"

    def test_population_stability_index(self):
        p, q = [0.1, 0.2, 0.7], [0.0, 0.5, 0.5]
        assert TC.population_stability_index(p, q) == JC.population_stability_index(p, q)


def _nan_safe(stats):
    return {k: {a: ("nan" if isinstance(b, float) and math.isnan(b) else b)
                for a, b in v.items()} for k, v in stats.items()}


class TestPromotionGate:
    @pytest.mark.parametrize("shadow, active, cand, gate", [
        ({"mirrored_records": 10, "shadow_failures": 0}, None, None, {}),
        ({"mirrored_records": 100, "shadow_failures": 2}, None, None, {}),
        ({"mirrored_records": 100, "shadow_failures": 0, "mean_abs_delta": 0.3,
          "max_abs_delta": float("inf")}, None, None, {}),
        ({"mirrored_records": 100, "shadow_failures": 0, "mean_abs_delta": 0.3,
          "max_abs_delta": 0.9}, None, None, {"max_prediction_delta": 0.1}),
        ({"mirrored_records": 100, "shadow_failures": 0}, ("auPR", 0.9, True),
         ("auPR", 0.7, True), {"max_metric_drop": 0.1}),
        ({"mirrored_records": 100, "shadow_failures": 0}, ("rmse", 1.0, False),
         ("rmse", 1.05, False), {"max_metric_drop": 0.1}),
    ])
    def test_decisions_equal_the_reference(self, shadow, active, cand, gate):
        got = TC.PromotionGate(**gate).check(shadow, active, cand)
        want = JC.PromotionGate(**gate).check(shadow, active, cand)
        assert [(d.code, d.message) for d in got] == [(d.code, d.message) for d in want]

    def test_best_validation_metric(self, base):
        name, value, larger = TC.best_validation_metric(base[0])
        assert (name, larger) == ("auPR", True) and 0.0 < value <= 1.0


class TestLoop:
    def test_base_coefficients_within_1e6(self, base):
        got = S.coefficients(base[0])
        assert np.max(np.abs(np.subtract(got, RECORD["base_coefficients"]))) <= 1e-6

    @pytest.mark.parametrize("scenario", sorted(S.SCENARIOS))
    def test_e2e_counters_and_codes_equal_the_jax_record(self, base, scenario):
        got = S.run_e2e(PKG, base, scenario, CPU)
        want = RECORD["scenarios"][scenario]
        assert got["counters"] == want["counters"]
        assert got["codes"] == [c for c in want["codes"] if c != "TM809"]
        assert got["swap"] == want["swap"] and got["batcher"] == want["batcher"]
        assert got["prefix_reused"] == want["prefix_reused"]
        if want["backend_compiles"] is not None:
            assert got["backend_compiles"] == 0
        if want["candidate_coefficients"] is not None:
            assert np.max(np.abs(np.subtract(got["candidate_coefficients"],
                                             want["candidate_coefficients"]))) <= 1e-6

    def test_post_swap_trip_rolls_back_through_the_loop(self, base, tmp_path):
        model, raws, train_ds, snap = base
        ckpt_dir = str(tmp_path / "cks")
        server = ScoringServer(model, max_batch=64, max_wait_ms=1.0, max_queue=8192,
                               resilience={"max_retries": 0, "failure_threshold": 2,
                                           "recovery_batches": 8}, **CPU)
        reader = MicroBatchStreamingReader(
            ListSource(S.make_records(512, 45, shift=3.0), "stream"),
            batch_interval=0.0, max_batch_records=128, max_empty_polls=1)
        trainer = TC.ContinualTrainer(
            server, model, reader, snapshot=snap,
            refit=TC.RefitController(model, sleep=lambda s: None,
                                     checkpoint_dir=ckpt_dir, **CPU),
            gate=TC.PromotionGate(min_shadow_records=64),
            window_records=S.N_TRAIN, drift_params={"min_records": 128},
            probation_batches=16)
        try:
            metrics = trainer.run()
            assert metrics["promotions"] == 1 and server.in_probation()
            with open(os.path.join(ckpt_dir, "CURRENT")) as fh:
                assert fh.read().strip() == "model-0001"
            assert trainer._model is not model
            harness = FaultHarness(seed=0)
            harness.script("device", [TransientScoringError("dead"),
                                      TransientScoringError("dead")])
            probe = [{k: v for k, v in r.items() if k != "label"}
                     for r in S.make_records(4, 46, shift=3.0)]
            with harness:
                for r in probe[:3]:
                    server.score(r, timeout=5)
            m = server.swap_metrics()
            assert m["rollbacks"] == 1 and m["active_version"] == 1
            trainer._tick()
            assert any(d.code == "TM808" for d in trainer.diagnostics)
            assert trainer._model is model
            assert not os.path.exists(os.path.join(ckpt_dir, "CURRENT"))
            assert os.path.isdir(os.path.join(ckpt_dir, "model-0001"))
        finally:
            server.close()


class TestBootstrap:
    """``snapshot=None``: the trainer anchors its drift baseline on the
    stream's head (``rows_to_snapshot``) once ``bootstrap_records`` arrive."""

    def test_baseline_built_past_the_bootstrap_equals_the_reference(self, base):
        model, *_ = base
        records = S.make_records(384, 48)
        server = ScoringServer(model, max_batch=64, max_wait_ms=1.0,
                               max_queue=8192, **CPU)
        reader = MicroBatchStreamingReader(
            ListSource(records, "stream"), batch_interval=0.0,
            max_batch_records=64, max_empty_polls=1)
        trainer = TC.ContinualTrainer(
            server, model, reader, snapshot=None, bootstrap_records=128,
            refit_enabled=False, drift_params={"min_records": 64})
        try:
            metrics = trainer.run()
        finally:
            server.close()
        assert metrics["records"] == len(records)
        det = trainer._detector
        assert det is not None and det.records == len(records) - 128
        jr = _raws(JFB)
        jsnap = JC.rows_to_snapshot(records[:128], jr)
        assert det.snapshot.to_dict() == jsnap.to_dict()
        jdet = JC.DriftDetector(jsnap, min_records=64)
        for i in range(128, len(records), 64):
            jdet.observe(J_rb.rows_to_dataset(records[i:i + 64], jr,
                                              allow_missing_response=True))
        # the streamed batches reach the port's detector through the reader's
        # dataset, so running sums may differ from the reference's in the
        # last bit: 1e-12 relative
        got, want = det.feature_stats(), jdet.feature_stats()
        assert sorted(got) == sorted(want)
        for name in want:
            assert sorted(got[name]) == sorted(want[name]), name
            for k, w in want[name].items():
                g = got[name][k]
                if isinstance(w, float):
                    assert (math.isnan(g) and math.isnan(w)) or \
                        math.isclose(g, w, rel_tol=1e-12, abs_tol=1e-15), (name, k)
                else:
                    assert g == w, (name, k)
        assert [d.code for d in det.evaluate()] == [d.code for d in jdet.evaluate()]

    def test_bootstrap_mode_with_staged_candidate_does_not_crash(self, base):
        model, raws, train_ds, snap = base
        cand = TC.RefitController(model, **CPU).refit(train_ds).model
        records = S.make_records(192, 47)
        server = ScoringServer(model, max_batch=64, max_wait_ms=1.0,
                               max_queue=8192, **CPU)
        reader = MicroBatchStreamingReader(
            ListSource(records, "stream"), batch_interval=0.0,
            max_batch_records=64, max_empty_polls=1)
        trainer = TC.ContinualTrainer(
            server, model, reader, snapshot=None, bootstrap_records=10_000,
            gate=TC.PromotionGate(min_shadow_records=64), probation_batches=2)
        try:
            server.stage_candidate(cand)
            metrics = trainer.run()
            assert metrics["records"] == len(records)
            assert server.swap_metrics()["swaps"] == 1
        finally:
            server.close()


class TestRefitController:
    def test_frozen_prefix_refit_builds_nothing(self, base):
        model, raws, train_ds, snap = base
        ctl = TC.RefitController(model, sleep=lambda s: None, **CPU)
        assert ctl.prime(train_ds) == 0
        window = rows_to_dataset(S.make_records(S.N_TRAIN, 9, shift=1.0), raws)
        res = ctl.refit(window)
        assert res.backend_compiles == 0 and res.prefix_reused
        assert res.diagnostics == [] and res.attempts == 1
        sel_uid = next(iter(ctl.refit_uids))
        assert res.model.fitted[sel_uid] is not model.fitted[sel_uid]
        for uid, m in model.fitted.items():
            if uid != sel_uid:
                assert res.model.fitted[uid] is m

    def test_a_build_during_the_refit_fires_tm809(self, base, monkeypatch):
        """Three kernel builds inside the refit (reported through the
        compile probe's hook, as ``perf/kernels/dispatch.py`` reports a real
        ``nvcc`` build) make a TM809 refit with 3 compiles."""
        from transmogrifai_tpu_torch.perf.timers import note_compile
        from transmogrifai_tpu_torch.workflow import plan as TP

        model, raws, train_ds, _ = base
        real = TP.JointPrefix.apply_prefix

        def building(self, *a, **kw):
            for _ in range(3):
                note_compile("nvcc_build", 0.0, cache_hit=False, library="probe")
            monkeypatch.setattr(TP.JointPrefix, "apply_prefix", real)
            return real(self, *a, **kw)

        monkeypatch.setattr(TP.JointPrefix, "apply_prefix", building)
        res = TC.RefitController(model, sleep=lambda s: None, **CPU).refit(train_ds)
        assert res.backend_compiles == 3
        assert [d.code for d in res.diagnostics] == ["TM809"]

    def test_exhausted_retries_raise_tm805(self, base):
        model, raws, train_ds, _ = base
        harness = FaultHarness(seed=0).fail_when(
            "refit", lambda ctx: True, lambda: TransientScoringError("down"))
        with harness, pytest.raises(TC.RefitError) as e:
            TC.RefitController(model, max_retries=1, sleep=lambda s: None,
                               **CPU).refit(train_ds)
        assert [d.code for d in e.value.diagnostics] == ["TM805"]
        assert harness.calls["refit"] == 2

    def test_checkpoint_current_flips_only_when_marked(self, base, tmp_path):
        model, raws, train_ds, _ = base
        d = str(tmp_path / "cks")
        ctl = TC.RefitController(model, sleep=lambda s: None, checkpoint_dir=d, **CPU)
        res = ctl.refit(train_ds)
        assert res.checkpoint_path.endswith("model-0001")
        assert not os.path.exists(os.path.join(d, "CURRENT"))
        ctl.mark_current(res.checkpoint_path)
        loaded = TC.RefitController.load_checkpoint(d)
        a = loaded.score(train_ds, **CPU)
        b = res.model.score(train_ds, **CPU)
        pred = model.result_features[-1].name
        assert np.asarray(a[pred].prob).tobytes() == np.asarray(b[pred].prob).tobytes()
        with open(os.path.join(d, "CURRENT"), "w") as fh:
            fh.write("  \n")
        assert TC.RefitController.load_checkpoint(d) is None

    def test_a_loaded_model_refits_its_recorded_winner(self, base, tmp_path):
        model, raws, train_ds, _ = base
        model.save(str(tmp_path / "m"))
        loaded = T.WorkflowModel.load(str(tmp_path / "m"))
        res = TC.RefitController(loaded, sleep=lambda s: None, **CPU).refit(train_ds)
        summary = res.model.summary()
        assert summary.best_model_name == "LogisticRegression"
        assert summary.best_grid == model.summary().best_grid
        assert res.prefix_reused and res.backend_compiles == 0

    def test_no_card_and_slo_monitor_raise(self, base, monkeypatch):
        """The trainer takes an SLO monitor and polls it at stream cadence
        (tests/test_torch_slo.py drives it); one without ``poll`` raises at
        the first poll.  Without a card and a device, the refit raises."""
        model = base[0]
        server = ScoringServer(model, max_batch=8, **CPU)
        try:
            trainer = TC.ContinualTrainer(server, model, None, slo_monitor=object())
            with pytest.raises(AttributeError, match="poll"):
                trainer._poll_slo()
        finally:
            server.close()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.RefitController(model)
