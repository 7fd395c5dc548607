"""The port's scoring server against the JAX package's, on the CPU.

(a) the committed full-width fixture, loaded by both packages, takes the
    same 300 records one ``submit`` each through either package's
    ``ScoringServer`` at pipeline depth 0 and 2: equal records (``==``);
(b) the staged plan: ``score == begin_score()()`` with batches in flight
    out of order, landing sets reused and counted, ``warm()`` allocating
    everything serving needs, ``score_host`` equal to the JAX package's,
    fingerprints stable across a reload, concurrent callers;
(c) the entry points take the reference's parameters in its order,
    ``device`` by keyword only; the plan's signature repair; unported
    parameters raise by name; with no card and no device they raise;
(d) the reference's batcher and pipeline tests, run on both packages'
    MicroBatcher and ring, with events and injected sleeps in place of
    wall-clock assertions;
(e) faults and a blue/green swap inside a pipelined window, a reloaded
    candidate promoted (TM508 silent) and rolled back, TM507 on a
    schema-changing candidate.

The fixture's model head is a float64 product on the host (numpy, in both
packages), whose last bit can depend on a row's place in its batch (the BLAS
kernels treat a batch's tail rows apart).  So a test that holds served
records to a plan's makes the batches the same: ``max_batch`` divides the
records and ``max_wait_ms`` is long enough that every batch flushes on size.
"""

import inspect
import json
import logging
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import transmogrifai_tpu.serve as JS
import transmogrifai_tpu.serve.pipeline as JPipe
import transmogrifai_tpu_torch.serve as TS
import transmogrifai_tpu_torch.serve.pipeline as TPipe
from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel
from transmogrifai_tpu_torch import WorkflowModel as TModel
from transmogrifai_tpu_torch.checkers.diagnostics import OpCheckError

from test_torch_serving import FIXTURE, _records

SERVE = {"jax": JS, "torch": TS}
PIPE = {"jax": JPipe, "torch": TPipe}
both = pytest.mark.parametrize("pkg", ["jax", "torch"])


@pytest.fixture(scope="module")
def fx():
    with open(f"{FIXTURE}/schema.json") as fh:
        schema = json.load(fh)
    jm, tm = JModel.load(FIXTURE), TModel.load(FIXTURE)
    recs = _records(schema["features"], 300, 11)
    plan = tm.serving_plan(device="cpu")

    def chunked(size, records=recs):
        """The plan's records for ``records`` scored in batches of ``size``."""
        return [row for i in range(0, len(records), size)
                for row in plan.score(records[i:i + size])]
    return SimpleNamespace(jm=jm, tm=tm, schema=schema, recs=recs, chunked=chunked)


#: long enough that a test's batches flush on size, never on the deadline
SIZE_ONLY_MS = 60_000


def _tserver(fx, **kw):
    kw.setdefault("device", "cpu")
    return TS.ScoringServer(fx.tm, **kw)


def _jserver(fx, **kw):
    kw.setdefault("min_bucket", 8)
    kw.setdefault("warm", False)
    return JS.ScoringServer(fx.jm, **kw)


def _submit_all(server, records):
    futs = [server.submit(r) for r in records]
    return [f.result(timeout=30) for f in futs]


# ---------------------------------------------------------------------------
# (a) the server against the JAX package's
# ---------------------------------------------------------------------------

class TestServerParity:
    @pytest.mark.parametrize("depth", [0, 2])
    def test_submitted_records_equal_jax_server(self, fx, depth):
        kw = dict(max_batch=60, max_wait_ms=SIZE_ONLY_MS, pipeline_depth=depth)
        with _jserver(fx, **kw) as js:
            jout = _submit_all(js, fx.recs)
        with _tserver(fx, **kw) as ts:
            tout = _submit_all(ts, fx.recs)
            m = ts.metrics()
        assert tout == jout
        assert tout == fx.chunked(60)
        assert m["batcher"]["batch_size_hist"] == {"60": 5}
        assert m["batcher"]["completed"] == 300 and m["batcher"]["failed"] == 0
        assert m["plan"]["scored_records"] == 300
        assert m["batcher"]["pipeline"]["depth"] == depth
        assert (m["batcher"]["pipeline"]["batches"] > 0) == (depth > 0)
        res = m["resilience"]
        assert res["breaker"]["state"] == "closed"
        assert [res[k] for k in ("quarantined", "retries", "bucket_splits",
                                 "device_failures", "fallback_batches")] == [0] * 5
        assert m["plan"]["host_scored_records"] == 0

    def test_model_serve_helper(self, fx):
        with fx.tm.serve(max_batch=16, max_wait_ms=2, device="cpu") as server:
            got = server.score(fx.recs[0], timeout=30)
            assert got == server.score_batch([fx.recs[0]])[0]
        assert got == fx.jm.serving_plan().score([fx.recs[0]])[0]

    def test_metrics_surface(self, fx):
        with _tserver(fx, max_batch=32, max_wait_ms=2) as server:
            _submit_all(server, fx.recs[:40])
            prom = server.prometheus()
            snap = server.metrics_snapshot()
            status = server.statusz()
            bat = server.batcher.metrics()
        assert "# TYPE tmog_serve_batcher_submitted_total counter" in prom
        assert "tmog_serve_batcher_submitted_total 40" in prom
        assert '# TYPE tmog_serve_batcher_latency_seconds summary' in prom
        assert "# HELP tmog_serve_swap_swaps_total" in prom
        assert snap["tmog_serve_batcher_completed_total"] == 40
        json.dumps(snap, sort_keys=True)
        json.dumps(status, sort_keys=True)
        assert status["completed"] == 40 and status["breaker"] == "closed"
        assert status["device"] == "cpu" and status["warm_buckets"] == 3
        assert bat["latency_p50_ms"] <= bat["latency_p95_ms"] <= bat["latency_p99_ms"]
        assert sum(bat["batch_size_hist"].values()) == bat["batches"]


# ---------------------------------------------------------------------------
# (b) the staged plan
# ---------------------------------------------------------------------------

class TestStagedPlan:
    def test_out_of_order_finalize_equals_score(self, fx):
        ring = 3
        plan = fx.tm.serving_plan(8, 64, device="cpu").reserve_inflight(ring).warm()
        batches = [fx.recs[i * 20:i * 20 + 17 + i] for i in range(ring + 1)]
        cc = plan.metrics()["compile_count"]
        fins = [plan.begin_score(b) for b in batches[:ring]]
        assert plan.metrics()["compile_count"] == cc       # the ring holds them
        fins.append(plan.begin_score(batches[ring]))      # one more in flight
        assert plan.metrics()["compile_count"] == cc + 1
        outs = [None] * len(fins)
        for i in reversed(range(len(fins))):
            outs[i] = fins[i]()
        jplan = fx.jm.serving_plan(8, 64)
        for b, out in zip(batches, outs):
            assert out == plan.score(b) == jplan.score(b)
        assert plan.metrics()["compile_count"] == cc + 1   # the extra set stays

    @pytest.mark.parametrize("depth, env", [(0, None), (2, None), (4, None), (None, "3")])
    def test_server_reserves_a_landing_set_per_batch_in_flight(self, fx, monkeypatch,
                                                               depth, env):
        """The server's own depth sizes its plans' rings: depth + 1 batches
        begun and not finalized (the ring's and the one being begun)
        allocate nothing after warm()."""
        if env is not None:
            monkeypatch.setenv("TMOG_SERVE_PIPELINE_DEPTH", env)
        with _tserver(fx, max_batch=64, max_wait_ms=2, pipeline_depth=depth) as server:
            plan = server.plan
            held = server.batcher.pipeline_depth + 1
            assert held == (int(env) if depth is None else depth) + 1
            cc = plan.metrics()["compile_count"]
            batches = [fx.recs[i:i + 17] for i in range(held + 1)]   # bucket 32
            fins = [plan.begin_score(b) for b in batches[:held]]
            assert plan.metrics()["compile_count"] == cc
            fins.append(plan.begin_score(batches[held]))
            assert plan.metrics()["compile_count"] == cc + 1
            for b, fin in zip(batches, fins):
                assert fin() == plan.score(b)

    def test_reserve_inflight_grows_built_rings(self, fx):
        plan = fx.tm.serving_plan(8, 32, device="cpu").warm()
        assert plan.metrics()["compile_count"] == 2 * 3
        plan.reserve_inflight(4)
        assert plan.metrics()["compile_count"] == 3 * 3    # one growth per bucket
        fins = [plan.begin_score(fx.recs[:5]) for _ in range(4)]
        assert plan.metrics()["compile_count"] == 9
        outs = [fin() for fin in fins]
        assert all(o == plan.score(fx.recs[:5]) for o in outs)
        plan.reserve_inflight(2)                           # never shrinks a ring
        assert plan.metrics()["compile_count"] == 9

    def test_warm_builds_every_bucket_serving_adds_none(self, fx):
        plan = fx.tm.serving_plan(8, 256, device="cpu")
        assert plan.metrics()["compile_count"] == 0
        plan.warm()
        m = plan.metrics()
        assert m["buckets_compiled"] == plan.bucket_ladder() == [8, 16, 32, 64, 128, 256]
        assert m["compile_count"] == 2 * 6                 # staging + ring each
        assert m["scored_batches"] == 0                    # warm-up is not scoring
        for n in (1, 9, 37, 200, 256, 300):
            plan.score(fx.recs[:n])
        m = plan.metrics()
        assert m["compile_count"] == 12
        # 300 records score as 256 + 44
        assert m["bucket_batches"] == {8: 1, 16: 1, 64: 2, 256: 3}
        assert m["scored_records"] == 1 + 9 + 37 + 200 + 256 + 300
        assert m["padding_rows"] == 7 + 7 + 27 + 56 + 0 + 0 + 20

    def test_timings_per_batch(self, fx):
        plan = fx.tm.serving_plan(device="cpu")
        plan.score(fx.recs[:10])
        plan.score(fx.recs[:70])
        assert set(plan.last_timings) == {"encode_ms", "device_ms", "host_ms"}
        rows = list(plan.batch_timings)
        assert [(r["rows"], r["bucket"]) for r in rows] == [(10, 16), (70, 128)]
        assert all(r[k] >= 0 for r in rows for k in ("encode_ms", "device_ms", "host_ms"))
        assert plan.last_timings == {k: rows[-1][k] for k in plan.last_timings}

    def test_score_host_equals_jax_score_host(self, fx):
        plan = fx.tm.serving_plan(device="cpu")
        got = plan.score_host(fx.recs[:50])
        assert got == fx.jm.serving_plan().score_host(fx.recs[:50])
        assert plan.metrics()["host_scored_records"] == 50
        assert plan.metrics()["scored_records"] == 0
        assert got == plan.score(fx.recs[:50])

    def test_fingerprint_stable_across_reload(self, fx):
        a = fx.tm.serving_plan(device="cpu")
        a.score(fx.recs[:5])                               # caches filled
        b = TModel.load(FIXTURE).serving_plan(device="cpu")
        c = fx.tm.serving_plan(device="cpu")
        assert a.fingerprint == b.fingerprint == c.fingerprint
        assert a.content_fingerprint == b.content_fingerprint != a.fingerprint

    def test_concurrent_direct_callers(self, fx):
        plan = fx.tm.serving_plan(8, 64, device="cpu")
        chunks = [fx.recs[i:i + 13 + i % 5] for i in range(0, 240, 20)]
        want = [plan.score(c) for c in chunks]
        errors, outs = [], {}

        def run(k):
            try:
                for i in range(k, len(chunks), 4):
                    outs[i] = plan.score(chunks[i])
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads) and not errors
        assert [outs[i] for i in range(len(chunks))] == want


# ---------------------------------------------------------------------------
# (c) signatures, unported parameters, the device default
# ---------------------------------------------------------------------------

class TestSignatures:
    def test_plan_takes_the_reference_order(self, fx):
        plan = TS.CompiledScoringPlan(fx.tm, 16, device="cpu")
        assert (plan.min_bucket, plan.max_bucket) == (16, 1024)
        plan = TS.CompiledScoringPlan(fx.tm, 8, 64, True, None, "float32", device="cpu")
        assert (plan.max_bucket, plan.precision) == (64, "f32")
        plan = TS.CompiledScoringPlan(fx.tm, 8, 64, True, 1e9, device="cpu")
        assert plan.max_bucket == 64                  # a budget it fits
        with pytest.raises(OpCheckError, match="TM601"):
            TS.CompiledScoringPlan(fx.tm, 8, 64, True, 1024.0, device="cpu")
        for p, name in (("bf16", "bf16"), ("BFloat16", "bf16"), ("i8", "int8")):
            assert TS.CompiledScoringPlan(fx.tm, precision=p, device="cpu").precision == name
        with pytest.raises(ValueError, match="unknown precision"):
            TS.CompiledScoringPlan(fx.tm, precision="fp8", device="cpu")
        with pytest.raises(TypeError):
            TS.CompiledScoringPlan(fx.tm, 8, 64, True, None, None, "cpu")

    @pytest.mark.parametrize("name", ["ScoringServer", "MicroBatcher", "ResilientScorer",
                                      "SwappableScorer", "CompiledScoringPlan"])
    def test_signature_equals_the_reference(self, name):
        ref = inspect.signature(getattr(JS, name)).parameters
        got = inspect.signature(getattr(TS, name)).parameters
        assert [(n, p.kind) for n, p in got.items() if n != "device"] == \
            [(n, p.kind) for n, p in ref.items()]
        if "device" in got:
            assert got["device"].kind is inspect.Parameter.KEYWORD_ONLY
            assert list(got)[-1] == "device"

    def test_unfitted_estimator_is_tm501(self, fx):
        from transmogrifai_tpu_torch.models.selector import SelectedModel

        fitted = {k: v for k, v in fx.tm.fitted.items()
                  if not isinstance(v, SelectedModel)}
        broken = TModel(fx.tm.result_features, fitted)
        with pytest.raises(OpCheckError, match="TM501") as ei:
            TS.CompiledScoringPlan(broken, device="cpu")
        assert [d.code for d in ei.value.report.errors()] == ["TM501"]
        with pytest.raises(ValueError, match="TM501"):
            TS.CompiledScoringPlan(broken, strict=False, device="cpu")

    def test_server_refuses_hbm_budget(self, fx):
        """A budget the model's plan cannot fit refuses it with TM601 (the
        plan's admission gate); one it fits serves."""
        with pytest.raises(OpCheckError, match="TM601"):
            TS.ScoringServer(fx.tm, hbm_budget=1024.0, device="cpu")
        with TS.ScoringServer(fx.tm, max_batch=8, hbm_budget=1e9, device="cpu") as server:
            assert server.plan.max_bucket == 8

    def test_without_card_every_entry_point_raises(self, fx, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (lambda: TS.ScoringServer(fx.tm, warm=False),
                     lambda: fx.tm.serve(),
                     lambda: TS.CompiledScoringPlan(fx.tm)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


# ---------------------------------------------------------------------------
# (d) the reference's batcher and pipeline tests, on both packages
# ---------------------------------------------------------------------------

def _gated():
    """A scorer that signals when a batch reaches it and holds it until the
    gate opens."""
    entered, gate = threading.Event(), threading.Event()

    def fn(rs):
        entered.set()
        gate.wait(10)
        return list(rs)
    return fn, entered, gate


class TestMicroBatcher:
    @both
    def test_flush_on_size(self, pkg):
        batches = []

        def fn(rs):
            batches.append(len(rs))
            return [{"ok": r["i"]} for r in rs]

        with SERVE[pkg].MicroBatcher(fn, max_batch=4, max_wait_ms=5000,
                                     max_queue=64) as mb:
            futs = [mb.submit({"i": i}) for i in range(8)]
            out = [f.result(timeout=30) for f in futs]
        assert [o["ok"] for o in out] == list(range(8))
        assert batches and max(batches) <= 4 and sum(batches) == 8

    @both
    def test_flush_on_deadline_with_concurrent_submitters(self, pkg):
        mb = SERVE[pkg].MicroBatcher(lambda rs: list(rs), max_batch=1000,
                                     max_wait_ms=20, max_queue=256)
        results, lock = [], threading.Lock()

        def submitter(i):
            v = mb.score({"i": i}, timeout=30)
            with lock:
                results.append(v["i"])

        threads = [threading.Thread(target=submitter, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert sorted(results) == list(range(12))
        mb.shutdown(drain=True, timeout=30)
        m = mb.metrics()
        assert m["completed"] == 12 and m["queue_depth"] == 0 and m["batches"] >= 1

    @both
    def test_backpressure_rejects_when_full(self, pkg):
        fn, entered, gate = _gated()
        mb = SERVE[pkg].MicroBatcher(fn, max_batch=1, max_wait_ms=1, max_queue=2,
                                     pipeline_depth=0)
        try:
            mb.submit({"i": 0})
            assert entered.wait(30)          # the flusher holds it on the gate
            mb.submit({"i": 1})
            mb.submit({"i": 2})
            with pytest.raises(SERVE[pkg].QueueFullError):
                mb.submit({"i": 3})
            assert mb.metrics()["rejected"] == 1
        finally:
            gate.set()
            mb.shutdown(drain=True, timeout=30)
        assert mb.queue_depth == 0

    @both
    def test_shutdown_rejects_new_submits(self, pkg):
        mb = SERVE[pkg].MicroBatcher(lambda rs: list(rs), max_batch=4, max_wait_ms=1)
        mb.shutdown(drain=True, timeout=30)
        with pytest.raises(SERVE[pkg].BatcherClosedError):
            mb.submit({})

    @both
    def test_scorer_error_propagates_to_futures(self, pkg):
        def fn(rs):
            raise RuntimeError("boom")

        with SERVE[pkg].MicroBatcher(fn, max_batch=4, max_wait_ms=1) as mb:
            fut = mb.submit({"i": 0})
            with pytest.raises(RuntimeError, match="boom"):
                fut.result(timeout=30)
            assert mb.metrics()["failed"] == 1

    @both
    def test_cancelled_future_does_not_kill_flusher(self, pkg):
        fn, entered, gate = _gated()
        mb = SERVE[pkg].MicroBatcher(fn, max_batch=1, max_wait_ms=1, max_queue=8,
                                     pipeline_depth=0)
        try:
            mb.submit({"i": 0})
            assert entered.wait(30)
            f1 = mb.submit({"i": 1})          # still pending in the queue
            assert f1.cancel()
            gate.set()
            assert mb.submit({"i": 2}).result(timeout=30) == {"i": 2}
        finally:
            gate.set()
            mb.shutdown(drain=True, timeout=30)
        assert mb.queue_depth == 0 and mb.metrics()["cancelled"] == 1

    @both
    def test_latency_percentiles_exported(self, pkg):
        with SERVE[pkg].MicroBatcher(lambda rs: list(rs), max_batch=8,
                                     max_wait_ms=1) as mb:
            for i in range(20):
                mb.score({"i": i}, timeout=30)
            m = mb.metrics()
        assert m["latency_p50_ms"] is not None
        assert m["latency_p50_ms"] <= m["latency_p95_ms"] <= m["latency_p99_ms"]
        assert m["batch_size_hist"]


class TestRingAndKnob:
    @both
    def test_depth_env_knob(self, pkg, monkeypatch):
        depth = PIPE[pkg].pipeline_depth
        monkeypatch.delenv("TMOG_SERVE_PIPELINE_DEPTH", raising=False)
        assert depth() == 2
        for env, want in (("3", 3), ("0", 0), ("junk", 2), ("-4", 0)):
            monkeypatch.setenv("TMOG_SERVE_PIPELINE_DEPTH", env)
            assert depth() == want

    @both
    def test_ring_rejects_nonpositive_depth(self, pkg):
        with pytest.raises(ValueError):
            PIPE[pkg].InflightRing(0)

    @both
    def test_ring_bounds_inflight_and_preserves_fifo(self, pkg):
        ring = PIPE[pkg].InflightRing(2)
        ring.put("a")
        ring.put("b")
        assert ring.inflight == 2
        started, passed = threading.Event(), threading.Event()

        def producer():
            started.set()
            ring.put("c")                     # blocks: the window is full
            passed.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        assert started.wait(30)
        assert not passed.is_set()
        assert ring.get() == "a"
        assert not passed.wait(0.05)          # a get alone frees no slot
        ring.task_done()
        assert passed.wait(30)
        assert ring.get() == "b" and ring.get() == "c"
        ring.task_done()
        ring.task_done()
        t.join(30)
        assert not t.is_alive()

    @both
    def test_ring_close_drain_and_sentinel(self, pkg):
        ring = PIPE[pkg].InflightRing(2)
        ring.put(1)
        ring.close()
        ring.put(2)
        assert ring.get() == 1 and ring.get() == 2
        ring.task_done()
        ring.task_done()
        assert ring.get() is None
        assert ring.drain(timeout=1)

    @both
    def test_ring_drain_times_out_while_inflight(self, pkg):
        ring = PIPE[pkg].InflightRing(1)
        ring.put("x")
        assert not ring.drain(timeout=0.01)
        assert ring.get() == "x"
        ring.task_done()
        assert ring.drain(timeout=1)

    @both
    def test_depth_zero_is_the_lockstep_loop(self, pkg):
        mb = SERVE[pkg].MicroBatcher(lambda rs: list(rs), max_batch=4,
                                     max_wait_ms=1, pipeline_depth=0)
        try:
            assert mb._ring is None and mb._fin_thread is None
            assert mb.submit({"i": 1}).result(timeout=30) == {"i": 1}
            pipe = mb.metrics()["pipeline"]
            assert pipe["depth"] == 0 and pipe["batches"] == 0
            assert pipe["overlap_fraction"] == 1.0
        finally:
            mb.shutdown(drain=True, timeout=30)


class TestStormAccounting:
    @both
    def test_threaded_storm_every_request_terminal_once(self, pkg):
        def scorer(rs):
            time.sleep(0.002)                 # lets the window fill
            return [dict(r) for r in rs]

        mb = SERVE[pkg].MicroBatcher(scorer, max_batch=8, max_wait_ms=1,
                                     max_queue=64, pipeline_depth=2)
        futs, flock, rejected = [], threading.Lock(), [0]

        def storm(tid):
            for i in range(60):
                try:
                    f = mb.submit({"t": tid, "i": i},
                                  deadline_ms=0.5 if i % 7 == 0 else None)
                except SERVE[pkg].QueueFullError:
                    with flock:
                        rejected[0] += 1
                    continue
                if i % 13 == 0:
                    f.cancel()
                with flock:
                    futs.append(f)

        threads = [threading.Thread(target=storm, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        mb.shutdown(drain=True, timeout=30)
        assert all(f.done() for f in futs)
        m = mb.metrics()
        assert m["submitted"] == len(futs) and m["rejected"] == rejected[0]
        assert m["submitted"] == (m["completed"] + m["failed"] + m["cancelled"]
                                  + m["deadline_expired"] + m["shed"])

    @both
    def test_deadline_enforced_with_saturated_window(self, pkg):
        fn, entered, gate = _gated()
        mb = SERVE[pkg].MicroBatcher(fn, max_batch=1, max_wait_ms=1, max_queue=16,
                                     pipeline_depth=2)
        try:
            for i in range(3):                # depth + 1 claimed batches
                mb.submit({"i": i})
                _wait_claimed(mb)
            f = mb.submit({"i": 99}, deadline_ms=1.0)
            with pytest.raises(SERVE[pkg].DeadlineExceededError):
                f.result(timeout=30)
        finally:
            gate.set()
            mb.shutdown(drain=True, timeout=30)
        assert mb.metrics()["deadline_expired"] == 1

    @both
    def test_non_drain_shutdown_still_finalizes_inflight(self, pkg):
        fn, entered, gate = _gated()
        mb = SERVE[pkg].MicroBatcher(fn, max_batch=1, max_wait_ms=1, max_queue=64,
                                     pipeline_depth=2)
        futs = [mb.submit({"i": i}) for i in range(20)]
        assert entered.wait(30)
        threading.Timer(0.3, gate.set).start()
        mb.shutdown(drain=False, timeout=30)
        ok = [f for f in futs if f.exception(timeout=30) is None]
        evicted = [f for f in futs if isinstance(f.exception(timeout=30),
                                                 SERVE[pkg].BatcherClosedError)]
        assert len(ok) >= 1 and len(evicted) >= 1
        assert len(ok) + len(evicted) == len(futs)
        assert all("i" in f.result(timeout=1) for f in ok)
        assert mb.metrics()["cancelled"] == len(evicted)


def _wait_claimed(mb, timeout=30.0):
    """Poll until the flusher has taken everything queued."""
    end = time.monotonic() + timeout
    while mb.metrics()["queue_depth"] and time.monotonic() < end:
        time.sleep(0.001)
    time.sleep(0.02)


# ---------------------------------------------------------------------------
# (e) faults and swaps inside a pipelined window
# ---------------------------------------------------------------------------

class TestFaultsMidWindow:
    def test_transient_device_fault_mid_window_retries(self, fx):
        harness = TS.FaultHarness(seed=0).fail_when(
            "device", lambda ctx: True,
            lambda: TS.TransientScoringError("out of memory"), times=1)
        with _tserver(fx, max_batch=32, max_wait_ms=SIZE_ONLY_MS, pipeline_depth=2,
                      resilience={"seed": 0, "backoff_base_s": 1e-4}) as srv:
            with harness:
                out = _submit_all(srv, fx.recs[:96])
            m = srv.metrics()
        assert out == fx.chunked(32, fx.recs[:96])
        assert m["resilience"]["retries"] == 1
        assert m["batcher"]["completed"] == 96 and m["batcher"]["failed"] == 0

    def test_breaker_trip_mid_window_degrades_whole_batches(self, fx):
        harness = TS.FaultHarness(seed=1).fail_when(
            "device", lambda ctx: True, lambda: torch.OutOfMemoryError("oom"))
        with _tserver(fx, max_batch=16, max_wait_ms=SIZE_ONLY_MS, pipeline_depth=2,
                      resilience={"seed": 1, "max_retries": 1,
                                  "backoff_base_s": 1e-4, "failure_threshold": 2,
                                  "recovery_batches": 1000}) as srv:
            with harness:
                out = _submit_all(srv, fx.recs[:128])
            m = srv.metrics()
        # every batch is served whole by the host path, which gives the
        # device path's records for the same batch
        assert out == fx.chunked(16, fx.recs[:128])
        assert m["resilience"]["breaker"]["state"] == "open"
        assert m["resilience"]["fallback_records"] >= 16
        assert m["plan"]["host_scored_records"] == m["resilience"]["fallback_records"]
        assert m["batcher"]["completed"] == 128

    def test_swap_during_inflight_window(self, fx):
        stop = threading.Event()
        outs, errs = [], []
        # one request at a time: every batch is that one record
        single = fx.chunked(1, fx.recs[:40])
        with _tserver(fx, max_batch=16, max_wait_ms=1, pipeline_depth=2) as srv:
            def traffic():
                i = 0
                while not stop.is_set():
                    f = srv.submit(fx.recs[i % 40])
                    try:
                        outs.append((i % 40, f.result(timeout=30)))
                    except Exception as e:  # noqa: BLE001
                        errs.append(e)
                    i += 1

            t = threading.Thread(target=traffic, daemon=True)
            t.start()
            srv.stage_candidate(TModel.load(FIXTURE))
            swap = srv.promote(probation_batches=0)
            n_swap = len(outs)
            while len(outs) < n_swap + 20 and t.is_alive():
                time.sleep(0.005)
            stop.set()
            t.join(30)
            m = srv.metrics()
        assert not t.is_alive() and errs == [] and outs
        for idx, row in outs:
            assert row == single[idx]
        assert swap["to_version"] == 2 and swap["shared_prefix"]
        assert m["swap"]["swaps"] == 1
        assert m["batcher"]["completed"] == len(outs)


class TestSwap:
    def test_reloaded_candidate_promotes_and_rolls_back(self, fx, caplog):
        ref = fx.chunked(32, fx.recs[:128])
        with _tserver(fx, max_batch=32, max_wait_ms=SIZE_ONLY_MS) as srv:
            fp = srv.plan.fingerprint
            with caplog.at_level(logging.INFO, logger="transmogrifai_tpu_torch"):
                cand_fp = srv.stage_candidate(TModel.load(FIXTURE))
            assert cand_fp == fp
            assert "TM508" not in caplog.text
            assert _submit_all(srv, fx.recs[:64]) == ref[:64]
            report = srv.shadow_report()
            assert report["mirrored_records"] == 64 and report["shadow_failures"] == 0
            assert report["max_abs_delta"] == 0.0
            rec = srv.promote()
            assert (rec["from_version"], rec["to_version"]) == (1, 2)
            assert rec["shared_prefix"] and srv.in_probation()
            assert _submit_all(srv, fx.recs[64:128]) == ref[64:128]
            back = srv.rollback()
            assert back["to_version"] == 1
            assert srv.swap_metrics()["active_version"] == 1
            assert _submit_all(srv, fx.recs[:32]) == ref[:32]
            bat = srv.batcher.metrics()
        assert bat["submitted"] == bat["completed"] == 64 + 64 + 32

    def test_schema_changing_candidate_is_tm507(self, fx):
        other = TModel(fx.tm.result_features[1:], fx.tm.fitted)
        with _tserver(fx, max_batch=8, max_wait_ms=2) as srv:
            with pytest.raises(OpCheckError, match="TM507"):
                srv.stage_candidate(other)
            assert not srv.has_candidate()
