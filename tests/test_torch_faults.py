"""The port's fault-tolerant serving against the JAX package's, on the CPU.

Every FaultHarness script of the reference's fault tests runs on both
packages — the committed full-width fixture loaded by each — and must give
equal per-record outcomes (the same indices quarantined, the survivors'
records ``==``), equal retry, split and bisect counts, and the same breaker
transitions.  The batcher's deadline, backpressure, shedding and accounting
tests run on both packages' MicroBatcher.  Then the port's own rule: a
kernel's or the device's fault (``KernelError``, ``torch.AcceleratorError``)
fails every record of its batch and is never bisected, quarantined, retried
or served from the host path.
"""

import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import transmogrifai_tpu.serve as JS
import transmogrifai_tpu.serve.faults as JF
import transmogrifai_tpu_torch.serve as TS
import transmogrifai_tpu_torch.serve.faults as TF
from transmogrifai_tpu.checkers.diagnostics import OpCheckError as JOpCheckError
from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel
from transmogrifai_tpu_torch import WorkflowModel as TModel
from transmogrifai_tpu_torch.checkers.diagnostics import OpCheckError as TOpCheckError
from transmogrifai_tpu_torch.perf.kernels.dispatch import KernelError

from test_torch_serving import FIXTURE, _records

SERVE = {"jax": JS, "torch": TS}
FAULTS = {"jax": JF, "torch": TF}
OPCHECK = {"jax": JOpCheckError, "torch": TOpCheckError}
both = pytest.mark.parametrize("pkg", ["jax", "torch"])
#: long enough that a test's batches flush on size, never on the deadline
SIZE_ONLY_MS = 60_000
RESILIENCE_KEYS = ("quarantined", "retries", "bucket_splits", "bisect_batches",
                   "device_failures", "fallback_batches", "fallback_records")


@pytest.fixture(scope="module")
def fx():
    with open(f"{FIXTURE}/schema.json") as fh:
        schema = json.load(fh)
    jm, tm = JModel.load(FIXTURE), TModel.load(FIXTURE)
    recs = _records(schema["features"], 64, 21)
    plans = {"jax": jm.serving_plan(8, 64), "torch": tm.serving_plan(8, 64, device="cpu")}
    return SimpleNamespace(jm=jm, tm=tm, models={"jax": jm, "torch": tm},
                           recs=recs, plans=plans)


def _poison(rec):
    return dict(rec, r0="not-a-number")


def _server(fx, pkg, **kw):
    if pkg == "torch":
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("warm", False)
    kw.setdefault("min_bucket", 8)
    return SERVE[pkg].ScoringServer(fx.models[pkg], **kw)


def _outcomes(out):
    """Per-record outcomes comparable across packages: the row, or the
    error's class name."""
    return [type(o).__name__ if isinstance(o, Exception) else o for o in out]


def _res(m):
    return {k: m[k] for k in RESILIENCE_KEYS}


def _on_both(run):
    """``run(pkg)`` on either package; both results, which must be equal."""
    got = {pkg: run(pkg) for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

class TestFaultHarness:
    @both
    def test_script_consumed_per_firing(self, pkg):
        F = FAULTS[pkg]
        h = F.FaultHarness(seed=3).script(
            "device", [None, F.TransientScoringError("boom")])
        with h:
            F.fault_point("device")
            with pytest.raises(F.TransientScoringError):
                F.fault_point("device")
            F.fault_point("device")
        assert h.calls["device"] == 3 and h.fired == [("device", 1)]

    @both
    def test_fail_when_predicate_and_times(self, pkg):
        F = FAULTS[pkg]
        h = F.FaultHarness().fail_when("encode", lambda ctx: ctx.get("n", 0) > 2,
                                       lambda: ValueError("big"), times=1)
        with h:
            F.fault_point("encode", n=1)
            with pytest.raises(ValueError):
                F.fault_point("encode", n=5)
            F.fault_point("encode", n=5)
        assert [p for p, _ in h.fired] == ["encode"]

    @both
    def test_single_active_harness(self, pkg):
        F = FAULTS[pkg]
        with F.FaultHarness():
            with pytest.raises(RuntimeError, match="already active"):
                F.FaultHarness().__enter__()
        with F.FaultHarness():
            pass

    @both
    def test_inactive_is_noop(self, pkg):
        FAULTS[pkg].fault_point("device")

    @both
    def test_max_fires_caps_total_injected_failures(self, pkg):
        F = FAULTS[pkg]
        h = F.FaultHarness().script(
            "device", [F.TransientScoringError(x) for x in "abc"], max_fires=2)
        with h:
            for _ in range(2):
                with pytest.raises(F.TransientScoringError):
                    F.fault_point("device")
            F.fault_point("device")
        assert len(h.fired) == 2 and h.calls["device"] == 3
        h2 = F.FaultHarness().fail_when("encode", lambda ctx: True,
                                        lambda: ValueError("x"), max_fires=1)
        with h2:
            with pytest.raises(ValueError):
                F.fault_point("encode")
            F.fault_point("encode")
        assert len(h2.fired) == 1

    def test_is_retryable_classification(self):
        assert TF.is_retryable(TF.TransientScoringError("x"))
        assert TF.is_retryable(torch.OutOfMemoryError("CUDA out of memory"))
        assert not TF.is_retryable(ValueError("bad payload"))
        assert not TF.is_retryable(RuntimeError("out of memory"))   # no sniffing
        assert not TF.is_retryable(KernelError("launch failed"))
        assert not TF.is_retryable(torch.AcceleratorError("illegal address"))


# ---------------------------------------------------------------------------
# Poison isolation
# ---------------------------------------------------------------------------

class TestPoisonIsolation:
    def test_poison_fails_own_future_survivors_equal(self, fx):
        def run(pkg):
            dead = []
            batch = list(fx.recs[:7]) + [_poison(fx.recs[7])]
            with _server(fx, pkg, max_batch=8, max_wait_ms=SIZE_ONLY_MS,
                         resilience={"dead_letter": lambda r, e: dead.append(r),
                                     "seed": 0}) as srv:
                futs = [srv.submit(r) for r in batch]
                out = [f.exception(timeout=30) or f.result(timeout=30) for f in futs]
                m = srv.metrics()
            assert len(dead) == 1 and dead[0] is batch[7]
            assert m["resilience"]["breaker"]["state"] == "closed"
            return (_outcomes(out), _res(m["resilience"]),
                    m["batcher"]["failed"], m["batcher"]["completed"])

        out, res, failed, completed = _on_both(run)
        assert out[7] == "PoisonRecordError" and all(isinstance(o, dict) for o in out[:7])
        assert (res["quarantined"], failed, completed) == (1, 1, 7)

    def test_injected_encode_fault_bisects_to_marked_record(self, fx):
        batch = list(fx.recs[:6])
        batch[3] = dict(batch[3], __mark__=1)

        def run(pkg):
            rs = SERVE[pkg].ResilientScorer(fx.plans[pkg], seed=1)
            h = FAULTS[pkg].FaultHarness().fail_when(
                "encode", lambda ctx: any("__mark__" in r for r in ctx["records"]),
                lambda: ValueError("marked record rejected"))
            with h:
                out = rs.score_isolated(batch)
            return _outcomes(out), _res(rs.metrics())

        out, res = _on_both(run)
        assert out[3] == "PoisonRecordError"
        assert res["quarantined"] == 1 and res["bisect_batches"] >= 1

    def test_all_records_clean_passthrough(self, fx):
        def run(pkg):
            rs = SERVE[pkg].ResilientScorer(fx.plans[pkg], seed=2)
            out = rs.score_isolated(fx.recs[:5])
            assert out == fx.plans[pkg].score(fx.recs[:5])
            return out, _res(rs.metrics())

        _, res = _on_both(run)
        assert res["quarantined"] == 0 and res["retries"] == 0


# ---------------------------------------------------------------------------
# Transient retry with backoff
# ---------------------------------------------------------------------------

class TestTransientRetry:
    def test_scripted_transient_fault_succeeds_on_retry(self, fx):
        def run(pkg):
            F, sleeps = FAULTS[pkg], []
            rs = SERVE[pkg].ResilientScorer(fx.plans[pkg], max_retries=2,
                                            backoff_base_s=0.01, seed=7,
                                            sleep=sleeps.append)
            with F.FaultHarness(seed=7).script(
                    "device", [F.TransientScoringError("RESOURCE_EXHAUSTED")]):
                out = rs.score_isolated(fx.recs[:6])
            assert out == fx.plans[pkg].score(fx.recs[:6])
            return out, _res(rs.metrics()), rs.metrics()["breaker"]["state"], sleeps

        _, res, state, sleeps = _on_both(run)
        assert res["retries"] == 1 and res["quarantined"] == 0 and state == "closed"
        assert len(sleeps) == 1 and 0.005 <= sleeps[0] <= 0.01

    def test_backoff_grows_exponentially_and_is_bounded(self, fx):
        def run(pkg):
            F, sleeps = FAULTS[pkg], []
            rs = SERVE[pkg].ResilientScorer(fx.plans[pkg], max_retries=3,
                                            backoff_base_s=0.01, backoff_cap_s=0.02,
                                            seed=8, sleep=sleeps.append)
            with F.FaultHarness().script("device", [F.TransientScoringError("oom")] * 3):
                out = rs.score_isolated(fx.recs[:4])
            assert out == fx.plans[pkg].score(fx.recs[:4])
            return out, sleeps

        _, sleeps = _on_both(run)
        assert len(sleeps) == 3 and all(s <= 0.02 for s in sleeps)

    def test_split_to_smaller_bucket_on_batch_shaped_failure(self, fx):
        def run(pkg):
            F = FAULTS[pkg]
            rs = SERVE[pkg].ResilientScorer(fx.plans[pkg], max_retries=0, seed=9,
                                            sleep=lambda s: None)
            with F.FaultHarness().script("device", [F.TransientScoringError("oom")]):
                out = rs.score_isolated(fx.recs[:8])
            halves = fx.plans[pkg].score(fx.recs[:4]) + fx.plans[pkg].score(fx.recs[4:8])
            assert out == halves
            return out, _res(rs.metrics()), rs.metrics()["breaker"]["state"]

        _, res, state = _on_both(run)
        assert res["bucket_splits"] == 1 and res["device_failures"] == 0
        assert state == "closed"

    def test_out_of_memory_is_retried_like_the_reference_resource_exhausted(self, fx):
        sleeps = []
        rs = TS.ResilientScorer(fx.plans["torch"], max_retries=2, backoff_base_s=0.01,
                                seed=7, sleep=sleeps.append)
        with TS.FaultHarness().script("device", [torch.OutOfMemoryError("CUDA oom")]):
            out = rs.score_isolated(fx.recs[:6])
        assert out == fx.plans["torch"].score(fx.recs[:6])
        assert rs.metrics()["retries"] == 1 and len(sleeps) == 1


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

class TestCircuitBreaker:
    @both
    def test_state_machine_unit(self, pkg):
        br = SERVE[pkg].CircuitBreaker(failure_threshold=2, recovery_batches=2)
        assert br.allow_device() and br.state == br.CLOSED
        br.record_failure()
        assert br.state == br.CLOSED
        br.record_failure()
        assert br.state == br.OPEN and not br.allow_device()
        br.record_host_batch()
        assert not br.allow_device()
        br.record_host_batch()
        assert br.allow_device() and br.state == br.HALF_OPEN
        br.record_failure()
        assert br.state == br.OPEN
        br.record_host_batch(), br.record_host_batch()
        assert br.allow_device()
        br.record_success()
        assert br.state == br.CLOSED
        m = br.metrics()
        assert (m["opened"], m["reclosed"], m["probes"]) == (2, 1, 2)

    @both
    def test_force_open_holds_until_force_close(self, pkg):
        br = SERVE[pkg].CircuitBreaker(failure_threshold=1, recovery_batches=1)
        br.force_open()
        for _ in range(5):
            br.record_host_batch()
        assert not br.allow_device()
        br.force_close()
        assert br.allow_device() and br.state == br.CLOSED

    def test_breaker_degrades_to_host_and_recloses(self, fx):
        recs = fx.recs[:8]

        def run(pkg):
            F, plan = FAULTS[pkg], fx.plans[pkg]
            host_ref, clean = plan.score_host(recs), plan.score(recs)
            rs = SERVE[pkg].ResilientScorer(plan, max_retries=0, failure_threshold=1,
                                            recovery_batches=1, seed=4,
                                            sleep=lambda s: None)
            # 4 faults: the split fallback's leftmost descent 8 -> 4 -> 2 -> 1
            with F.FaultHarness(seed=4).script(
                    "device", [F.TransientScoringError("RESOURCE_EXHAUSTED")] * 4):
                out1 = rs.score_isolated(recs)
                m1 = rs.metrics()
                out2 = rs.score_isolated(recs)
                m2 = rs.metrics()
                out3 = rs.score_isolated(recs)
            assert out1 == host_ref and out2 == clean and out3 == clean
            return out1, out2, m1, m2

        out1, out2, m1, m2 = _on_both(run)
        assert m1["breaker"]["state"] == "open" and m1["breaker"]["opened"] == 1
        assert (m1["device_failures"], m1["fallback_batches"], m1["fallback_records"]) \
            == (1, 1, 8)
        assert m2["breaker"]["state"] == "closed" and m2["breaker"]["reclosed"] == 1
        assert m2["breaker"]["probes"] == 1 and m2["quarantined"] == 0
        assert "closed->open" in m1["breaker"]["transitions"]
        assert m2["breaker"]["transitions"][-2:] == ["open->half_open", "half_open->closed"]

    def test_bisect_success_resets_consecutive_failures(self, fx):
        def run(pkg):
            F = FAULTS[pkg]
            rs = SERVE[pkg].ResilientScorer(fx.plans[pkg], max_retries=0,
                                            failure_threshold=3, recovery_batches=2,
                                            seed=6, sleep=lambda s: None)
            with F.FaultHarness().script("device", [F.TransientScoringError("oom")] * 2):
                rs.score_isolated(fx.recs[:1])
                rs.score_isolated(fx.recs[:1])
            before = rs.metrics()["breaker"]["consecutive_failures"]
            out = rs.score_isolated(list(fx.recs[:3]) + [_poison(fx.recs[3])])
            after = rs.metrics()["breaker"]["consecutive_failures"]
            with F.FaultHarness().script("device", [F.TransientScoringError("oom")]):
                rs.score_isolated(fx.recs[:1])
            return before, _outcomes(out), after, rs.metrics()["breaker"]

        before, out, after, br = _on_both(run)
        assert (before, after) == (2, 0) and out[3] == "PoisonRecordError"
        assert br["state"] == "closed" and br["opened"] == 0
        assert br["consecutive_failures"] == 1

    def test_breaker_open_with_poison_still_isolates(self, fx):
        def run(pkg):
            rs = SERVE[pkg].ResilientScorer(fx.plans[pkg], max_retries=0,
                                            failure_threshold=1, recovery_batches=100,
                                            seed=5, sleep=lambda s: None)
            rs.breaker.force_open()
            out = rs.score_isolated(list(fx.recs[:3]) + [_poison(fx.recs[3])])
            assert out[:3] == fx.plans[pkg].score_host(fx.recs[:3])
            return _outcomes(out), rs.metrics()["quarantined"]

        out, quarantined = _on_both(run)
        assert out[3] == "PoisonRecordError" and quarantined == 1


# ---------------------------------------------------------------------------
# Deadlines, backpressure and accounting, on both packages' MicroBatcher
# ---------------------------------------------------------------------------

def _gated():
    entered, gate = threading.Event(), threading.Event()

    def fn(rs):
        entered.set()
        gate.wait(10)
        return list(rs)
    return fn, entered, gate


def _fill_window(mb, n=3):
    """Submit ``n`` fillers, each claimed by the flusher before the next
    (depth + 1 claimed batches saturate a depth-2 window)."""
    fillers = []
    for _ in range(n):
        fillers.append(mb.submit({"i": 0}))
        end = time.monotonic() + 30
        while mb.metrics()["queue_depth"] and time.monotonic() < end:
            time.sleep(0.001)
    time.sleep(0.02)
    return fillers


class TestDeadlines:
    @both
    def test_expired_request_evicted_without_device_call(self, pkg):
        calls = []

        def scorer(rs):
            calls.append(list(rs))
            return list(rs)

        mb = SERVE[pkg].MicroBatcher(scorer, max_batch=8, max_wait_ms=60, max_queue=8)
        try:
            f = mb.submit({"i": 0}, deadline_ms=1)
            with pytest.raises(SERVE[pkg].DeadlineExceededError):
                f.result(timeout=30)
        finally:
            mb.shutdown(drain=True, timeout=30)
        assert calls == []
        m = mb.metrics()
        assert m["deadline_expired"] == 1 and m["completed"] == 0

    @both
    def test_mixed_batch_scores_only_live_requests(self, pkg):
        seen = []

        def scorer(rs):
            seen.extend(r["i"] for r in rs)
            return list(rs)

        mb = SERVE[pkg].MicroBatcher(scorer, max_batch=8, max_wait_ms=40, max_queue=8)
        try:
            f_dead = mb.submit({"i": 0}, deadline_ms=1)
            f_live = mb.submit({"i": 1})
            assert f_live.result(timeout=30) == {"i": 1}
            with pytest.raises(SERVE[pkg].DeadlineExceededError):
                f_dead.result(timeout=30)
        finally:
            mb.shutdown(drain=True, timeout=30)
        assert seen == [1]

    @both
    def test_queue_side_eviction_makes_room_under_backpressure(self, pkg):
        fn, entered, gate = _gated()
        mb = SERVE[pkg].MicroBatcher(fn, max_batch=1, max_wait_ms=1, max_queue=2,
                                     pipeline_depth=2)
        try:
            fillers = _fill_window(mb)
            f1 = mb.submit({"i": 1}, deadline_ms=1)
            f2 = mb.submit({"i": 2}, deadline_ms=1)
            time.sleep(0.02)
            f3 = mb.submit({"i": 3})            # the expired pair makes room
            for f in (f1, f2):
                with pytest.raises(SERVE[pkg].DeadlineExceededError):
                    f.result(timeout=30)
            gate.set()
            assert f3.result(timeout=30) == {"i": 3}
            assert all(f.result(timeout=30) == {"i": 0} for f in fillers)
            m = mb.metrics()
            assert m["deadline_expired"] == 2 and m["rejected"] == 0
        finally:
            gate.set()
            mb.shutdown(drain=True, timeout=30)

    @both
    def test_server_default_deadline_applies(self, fx, pkg):
        with _server(fx, pkg, max_batch=4, max_wait_ms=100, deadline_ms=1.0) as srv:
            f = srv.submit(fx.recs[0])
            with pytest.raises(SERVE[pkg].DeadlineExceededError):
                f.result(timeout=30)
            assert srv.score(fx.recs[0], timeout=30, deadline_ms=10_000)


class TestBatcherAccounting:
    @both
    def test_shutdown_no_drain_counts_cancelled_not_failed(self, pkg):
        fn, entered, gate = _gated()
        mb = SERVE[pkg].MicroBatcher(fn, max_batch=1, max_wait_ms=1, max_queue=8,
                                     pipeline_depth=0)
        mb.submit({"i": 0})
        assert entered.wait(30)
        futs = [mb.submit({"i": i}) for i in range(1, 4)]
        mb.shutdown(drain=False, timeout=0.2)
        m = mb.metrics()
        assert m["cancelled"] == 3 and m["failed"] == 0
        assert all(f.done() for f in futs)
        gate.set()
        mb.shutdown(drain=False, timeout=30)

    @both
    def test_reclaim_counter_split_deadline_vs_cancelled_vs_shed(self, pkg):
        S = SERVE[pkg]
        fn, entered, gate = _gated()
        mb = S.MicroBatcher(fn, max_batch=1, max_wait_ms=1, max_queue=3,
                            pipeline_depth=2)

        def counts():
            m = mb.metrics()
            return (m["deadline_expired"], m["cancelled"], m["shed"], m["rejected"])

        try:
            fillers = _fill_window(mb)
            f_exp = mb.submit({"i": 1}, deadline_ms=1, slo="bronze")
            f_cancel = mb.submit({"i": 2}, slo="bronze")
            f_low = mb.submit({"i": 3}, slo="bronze")
            time.sleep(0.02)
            f_gold1 = mb.submit({"i": 4}, slo="gold")
            with pytest.raises(S.DeadlineExceededError):
                f_exp.result(timeout=30)
            assert counts() == (1, 0, 0, 0)
            assert f_cancel.cancel()
            f_gold2 = mb.submit({"i": 5}, slo="gold")
            assert counts() == (1, 1, 0, 0)
            f_gold3 = mb.submit({"i": 6}, slo="gold")
            with pytest.raises(S.LoadShedError):
                f_low.result(timeout=30)
            assert counts() == (1, 1, 1, 0)
            with pytest.raises(S.QueueFullError):
                mb.submit({"i": 7}, slo="bronze")
            assert counts() == (1, 1, 1, 1)
            gate.set()
            for f in (f_gold1, f_gold2, f_gold3, *fillers):
                assert f.result(timeout=30)
        finally:
            gate.set()
            mb.shutdown(drain=True, timeout=30)

    @both
    def test_degraded_tenant_absorbs_shedding_first(self, pkg):
        S = SERVE[pkg]
        fn, entered, gate = _gated()
        mb = S.MicroBatcher(fn, max_batch=1, max_wait_ms=1, max_queue=2,
                            pipeline_depth=0)
        try:
            mb.submit({"i": 0})
            assert entered.wait(30)
            mb.set_degraded("sick", True)
            f_sick = mb.submit({"i": 1}, tenant="sick", slo="gold")
            f_healthy = mb.submit({"i": 2}, tenant="ok", slo="bronze")
            f_in = mb.submit({"i": 3}, tenant="ok", slo="bronze")
            with pytest.raises(S.LoadShedError) as ei:
                f_sick.result(timeout=30)
            assert ei.value.tenant == "sick" and not f_healthy.done()
            m = mb.metrics()
            assert m["shed"] == 1 and m["rejected"] == 0
            assert mb.tenant_metrics()["sick"]["shed"] == 1
            mb.set_degraded("sick", False)
            gate.set()
            assert f_in.result(timeout=30) == {"i": 3}
            assert mb.tenant_metrics()["ok"]["completed"] == 2
        finally:
            gate.set()
            mb.shutdown(drain=True, timeout=30)

    @both
    def test_client_cancel_counts_cancelled(self, pkg):
        fn, entered, gate = _gated()
        mb = SERVE[pkg].MicroBatcher(fn, max_batch=1, max_wait_ms=1, max_queue=8,
                                     pipeline_depth=0)
        try:
            mb.submit({"i": 0})
            assert entered.wait(30)
            f = mb.submit({"i": 1})
            assert f.cancel()
            gate.set()
            mb.submit({"i": 2}).result(timeout=30)
        finally:
            gate.set()
            mb.shutdown(drain=True, timeout=30)
        m = mb.metrics()
        assert m["cancelled"] == 1 and m["failed"] == 0


# ---------------------------------------------------------------------------
# Server wiring and configuration
# ---------------------------------------------------------------------------

class TestServerWiring:
    def test_resilient_server_matches_plain_plan(self, fx):
        def run(pkg):
            with _server(fx, pkg, max_batch=16, max_wait_ms=SIZE_ONLY_MS) as srv:
                assert srv.resilience is not None
                out = [f.result(timeout=30) for f in
                       [srv.submit(r) for r in fx.recs[:32]]]
                direct = srv.score_batch(fx.recs[:16]) + srv.score_batch(fx.recs[16:32])
                m = srv.metrics()
            assert out == direct
            return out, m["resilience"]["breaker"]["state"], m["resilience"]["quarantined"]

        _, state, quarantined = _on_both(run)
        assert state == "closed" and quarantined == 0

    @both
    def test_resilience_opt_out(self, fx, pkg):
        with _server(fx, pkg, max_batch=8, max_wait_ms=1, resilience=False) as srv:
            assert srv.resilience is None and "resilience" not in srv.metrics()
            assert srv.score(fx.recs[0], timeout=30)

    @both
    def test_unknown_resilience_param_rejected(self, fx, pkg):
        with pytest.raises(TypeError, match="unknown resilience"):
            _server(fx, pkg, warm=False, resilience={"bogus": 1})

    @both
    def test_tm505_errors(self, pkg):
        report = SERVE[pkg].check_resilience_config(
            max_retries=-1, backoff_base_s=0.0, failure_threshold=0,
            recovery_batches=0, dead_letter="not-callable")
        codes = [d.code for d in report.errors()]
        assert set(codes) == {"TM505"} and len(codes) >= 4

    def test_tm505_tm506_reports_equal_jax(self):
        cases = [dict(max_retries=-1, backoff_base_s=0.0, backoff_cap_s=0.0,
                      failure_threshold=0, recovery_batches=0, dead_letter=3,
                      default_deadline_ms=-1.0),
                 dict(default_deadline_ms=1.0, max_wait_ms=2.0),
                 dict(default_deadline_ms=50.0, max_wait_ms=2.0)]
        for kw in cases:
            got = SERVE["torch"].check_resilience_config(**kw)
            ref = SERVE["jax"].check_resilience_config(**kw)
            assert [(d.code, str(d.severity), d.message) for d in got] == \
                [(d.code, str(d.severity), d.message) for d in ref]

    @both
    def test_tm506_deadline_vs_flush_wait(self, pkg):
        report = SERVE[pkg].check_resilience_config(default_deadline_ms=1.0,
                                                     max_wait_ms=2.0)
        assert [d.code for d in report.warnings()] == ["TM506"] and not report.errors()
        ok = SERVE[pkg].check_resilience_config(default_deadline_ms=50.0,
                                                 max_wait_ms=2.0)
        assert not ok.by_code("TM506")

    @both
    def test_server_raises_on_invalid_config(self, fx, pkg):
        with pytest.raises(OPCHECK[pkg], match="TM505"):
            _server(fx, pkg, warm=False, resilience={"failure_threshold": 0})


# ---------------------------------------------------------------------------
# Kernel and device faults: never hidden
# ---------------------------------------------------------------------------

KERNEL_FAULTS = [lambda: KernelError("encode_slots: CUDA kernel launch failed"),
                 lambda: torch.AcceleratorError("an illegal memory access")]


class TestKernelFaults:
    @pytest.mark.parametrize("make", KERNEL_FAULTS, ids=["KernelError", "AcceleratorError"])
    @pytest.mark.parametrize("staged", [False, True], ids=["lockstep", "pipelined"])
    def test_fails_whole_batch_nothing_hidden(self, fx, make, staged):
        plan = fx.plans["torch"]
        host0 = plan.metrics()["host_scored_records"]
        rs = TS.ResilientScorer(plan, max_retries=2, failure_threshold=1,
                                seed=0, sleep=lambda s: None)
        h = TS.FaultHarness().script("device", [make()])
        with h:
            out = rs.begin_isolated(fx.recs[:8])() if staged \
                else rs.score_isolated(fx.recs[:8])
            after = rs.score_isolated(fx.recs[:8])
        err = type(make())
        assert all(type(o) is err for o in out) and len({id(o) for o in out}) == 1
        assert h.calls["device"] == 2                   # no retry, no split
        m = rs.metrics()
        assert {k: m[k] for k in RESILIENCE_KEYS} == dict.fromkeys(RESILIENCE_KEYS, 0)
        assert m["breaker"]["state"] == "closed" and m["breaker"]["consecutive_failures"] == 0
        assert plan.metrics()["host_scored_records"] == host0
        assert after == plan.score(fx.recs[:8])          # the next batch: the device

    def test_kernel_fault_met_while_bisecting_fails_the_batch(self, fx):
        batch = list(fx.recs[:4])
        batch[3] = dict(batch[3], __mark__=1)
        rs = TS.ResilientScorer(fx.plans["torch"], seed=0, sleep=lambda s: None)
        h = TS.FaultHarness().fail_when(
            "encode", lambda ctx: any("__mark__" in r for r in ctx["records"]),
            lambda: ValueError("poison")).script("device", [KernelError("boom")])
        with h:
            out = rs.score_isolated(batch)
        assert all(isinstance(o, KernelError) for o in out)
        m = rs.metrics()
        assert m["quarantined"] == 0 and m["bisect_batches"] == 1
        assert m["fallback_batches"] == 0 and m["retries"] == 0

    @pytest.mark.parametrize("depth", [0, 2])
    def test_server_counts_the_batch_failed(self, fx, depth):
        h = TS.FaultHarness().fail_when(
            "device", lambda ctx: any("__k" in r for r in ctx["records"]),
            lambda: KernelError("launch failed"))
        marked = [dict(r, __k=1) for r in fx.recs[:8]]
        with _server(fx, "torch", max_batch=8, max_wait_ms=SIZE_ONLY_MS,
                     pipeline_depth=depth) as srv:
            with h:
                futs = [srv.submit(r) for r in marked]
                errs = [f.exception(timeout=30) for f in futs]
                clean = [srv.submit(r) for r in fx.recs[:8]]
                rows = [f.result(timeout=30) for f in clean]
            m = srv.metrics()
        assert all(isinstance(e, KernelError) for e in errs)
        assert rows == fx.plans["torch"].score(fx.recs[:8])
        assert (m["batcher"]["failed"], m["batcher"]["completed"]) == (8, 8)
        assert {k: m["resilience"][k] for k in RESILIENCE_KEYS} == \
            dict.fromkeys(RESILIENCE_KEYS, 0)
        assert m["resilience"]["breaker"]["state"] == "closed"
        assert m["plan"]["host_scored_records"] == 0

    def test_without_resilience_layer(self, fx):
        with _server(fx, "torch", max_batch=4, max_wait_ms=SIZE_ONLY_MS,
                     resilience=False) as srv:
            with TS.FaultHarness().script("device", [KernelError("boom")]):
                errs = [f.exception(timeout=30)
                        for f in [srv.submit(r) for r in fx.recs[:4]]]
            m = srv.metrics()
        assert all(isinstance(e, KernelError) for e in errs)
        assert m["batcher"]["failed"] == 4 and m["plan"]["host_scored_records"] == 0


class TestNoHostPathOnTheCard:
    """A plan on the card has no host path: an out-of-memory error that
    survives the retries and splits fails its batch, and the open breaker
    fails batches with CircuitOpenError, instead of moving them to the CPU.
    The plan is the CPU plan behind a card device, so only the device type
    differs from the CPU case."""

    def test_oom_fails_the_batch_and_the_breaker_never_serves_the_host(self, fx):
        plan = fx.plans["torch"]
        host_calls = []
        card = SimpleNamespace(device=torch.device("cuda", 0), score=plan.score,
                               score_host=host_calls.append)
        rs = TS.ResilientScorer(card, max_retries=1, failure_threshold=1,
                                recovery_batches=2, seed=0, sleep=lambda s: None)
        recs = fx.recs[:4]
        with TS.FaultHarness().fail_when("device", lambda ctx: True,
                                         lambda: torch.OutOfMemoryError("CUDA oom")):
            first = rs.score_isolated(recs)
            second = rs.begin_isolated(recs)()
        third = rs.score_isolated(recs)
        assert all(isinstance(o, torch.OutOfMemoryError) for o in first)
        assert all(isinstance(o, TS.CircuitOpenError) for o in second)
        assert third == plan.score(recs)                 # the half-open probe recloses
        m = rs.metrics()
        assert host_calls == []
        assert (m["device_failures"], m["fallback_batches"], m["fallback_records"],
                m["quarantined"]) == (1, 0, 0, 0)
        assert (m["retries"], m["bucket_splits"]) == (3, 2)   # 4 -> 2 -> 1, one retry each
        assert m["breaker"]["transitions"] == ["closed->open", "open->half_open",
                                               "half_open->closed"]

    def test_cpu_plan_keeps_its_host_path(self, fx):
        rs = TS.ResilientScorer(fx.plans["torch"], max_retries=0, failure_threshold=1,
                                seed=0, sleep=lambda s: None)
        with TS.FaultHarness().fail_when("device", lambda ctx: True,
                                         lambda: torch.OutOfMemoryError("CUDA oom")):
            out = rs.score_isolated(fx.recs[:4])
        assert out == fx.plans["torch"].score_host(fx.recs[:4])
        assert rs.metrics()["fallback_batches"] == 1
