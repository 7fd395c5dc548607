"""The port's telemetry layer (``transmogrifai_tpu_torch/obs/``,
``perf/timers.py``) held to the JAX package's: trace spans, the metrics
registry, the flight-recorder event log across train, serve and refit.

The reference's ``tests/test_obs.py`` test by test, under the same names,
on the CPU (``use_device("cpu")``), less ``TestCliTelemetry`` (the port
has no ``cli/`` yet).  The port compiles no program at run time: its
counterparts of a backend compile are a kernel library's ``nvcc`` build
and load and a serving plan's first allocation for a row bucket (staging
buffers, a landing set), each counted by ``perf/timers.py::note_compile``
from the site that does it.  So where the reference injects a fresh
``jax.jit`` into a warm path, these tests take a bucket the plan has not
allocated yet, and compile events are compared between the packages as
"0 on a warm path, >= 1 on a cold bucket", never by count.

Then parity: the same call sequence to both packages gives the same span
names, nesting and args, the same flight event kinds in the same order
(compile events aside), and served records with telemetry on equal to
those with it off.
"""

import json
import os
import time

import numpy as np
import pytest

import transmogrifai_tpu as J
import transmogrifai_tpu.obs as JO
import transmogrifai_tpu.serve as JS
from transmogrifai_tpu.models.logistic import LogisticRegression as JLR
from transmogrifai_tpu.readers.files import DataReaders as JDataReaders
from transmogrifai_tpu_torch import (
    BinaryClassificationModelSelector,
    FeatureBuilder,
    Workflow,
    transmogrify,
)
from transmogrifai_tpu_torch.models.logistic import LogisticRegression
from transmogrifai_tpu_torch.obs import (
    CANONICAL_METRICS,
    FlightRecorder,
    MetricsRegistry,
    Telemetry,
    Tracer,
    flight as obs_flight,
    resolve_telemetry,
    trace as obs_trace,
)
from transmogrifai_tpu_torch.obs.metrics import assert_json_stable, legacy_aliases
from transmogrifai_tpu_torch.perf import measure_compiles
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.perf.timers import note_compile
from transmogrifai_tpu_torch.readers.files import DataReaders
from transmogrifai_tpu_torch.serve import (
    FaultHarness,
    ScoringServer,
    TransientScoringError,
)
from transmogrifai_tpu_torch.workflow.continual import RefitController
from transmogrifai_tpu_torch.workflow.workflow import dedup_raw_features

N_TRAIN = 256


def make_records(n, seed, shift=0.0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 3)) + shift
    out = []
    for i in range(n):
        rec = {"label": float(r.random() < 1 / (1 + np.exp(-x[i, 0])))}
        for j in range(3):
            rec[f"num{j}"] = float(x[i, j])
        out.append(rec)
    return out


def _train_port(train, telemetry=None):
    import pandas as pd

    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    feats = [FeatureBuilder.Real(f"num{j}").extract_field().as_predictor()
             for j in range(3)]
    checked = label.sanity_check(transmogrify(feats))
    sel = BinaryClassificationModelSelector.with_train_validation_split(
        models=[(LogisticRegression(), [{"reg_param": 0.01}])])
    pred = label.transform_with(sel, checked)
    return (Workflow().set_result_features(label, pred)
            .set_reader(DataReaders.Simple.dataframe(pd.DataFrame(train)))
            ).train(telemetry=telemetry)


def _train_jax(train, telemetry=None):
    import pandas as pd

    label = J.FeatureBuilder.RealNN("label").extract_field().as_response()
    feats = [J.FeatureBuilder.Real(f"num{j}").extract_field().as_predictor()
             for j in range(3)]
    checked = label.sanity_check(J.transmogrify(feats))
    sel = J.BinaryClassificationModelSelector.with_train_validation_split(
        models=[(JLR(), [{"reg_param": 0.01}])])
    pred = label.transform_with(sel, checked)
    return (J.Workflow().set_result_features(label, pred)
            .set_reader(JDataReaders.Simple.dataframe(pd.DataFrame(train)))
            ).train(telemetry=telemetry)


@pytest.fixture(scope="module")
def base():
    """(model, train records, raw features, train dataset, candidate) —
    candidate is a frozen-prep warm-refit model sharing the plan
    fingerprint (the swap e2e needs matching fingerprints)."""
    from transmogrifai_tpu_torch.readers.base import rows_to_dataset

    train = make_records(N_TRAIN, 1)
    with use_device("cpu"):
        model = _train_port(train)
        raws = dedup_raw_features(model.result_features)
        train_ds = rows_to_dataset(train, raws)
        refit = RefitController(model, sleep=lambda s: None)
        refit.prime(train_ds)
        candidate = refit.refit(train_ds).model
    return model, train, raws, train_ds, candidate


@pytest.fixture(scope="module")
def jax_model():
    return _train_jax(make_records(N_TRAIN, 1))


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Every test starts and ends with telemetry fully uninstalled (both
    packages), on the CPU."""
    for mod in (obs_trace, JO.trace):
        mod.uninstall_tracer()
    for mod in (obs_flight, JO.flight):
        mod.uninstall_recorder()
    with use_device("cpu"):
        yield
    for mod in (obs_trace, JO.trace):
        mod.uninstall_tracer()
    for mod in (obs_flight, JO.flight):
        mod.uninstall_recorder()


def nesting_violations(events):
    """Within each tid, X events must be properly nested: any two spans
    either disjoint or one contains the other (small float tolerance)."""
    by_tid = {}
    for ev in events:
        if ev.get("ph") == "X":
            by_tid.setdefault(ev["tid"], []).append(ev)
    bad = []
    eps = 1.0  # us: timestamps round to 0.1us; clock noise tolerance
    for tid, evs in by_tid.items():
        evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for ev in evs:
            while stack and ev["ts"] >= stack[-1]["ts"] \
                    + stack[-1]["dur"] - eps:
                stack.pop()
            if stack and ev["ts"] + ev["dur"] > stack[-1]["ts"] \
                    + stack[-1]["dur"] + eps:
                bad.append((tid, stack[-1]["name"], ev["name"]))
            stack.append(ev)
    return bad


def _cold_plan(model, bucket=2):
    """A plan whose ``bucket`` no earlier plan of its fingerprint holds:
    scoring ``bucket`` records allocates (the port's compile)."""
    plan = model.serving_plan(min_bucket=bucket, max_bucket=bucket, strict=False)
    plan.release_executables()
    return plan


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

class TestTracer:
    def test_disabled_is_noop(self):
        assert obs_trace.active_tracer() is None
        with obs_trace.span("nothing", cat="test"):
            pass
        obs_trace.instant("nothing")  # must not raise anywhere

    def test_span_nesting_records_contextvar_parent(self):
        tracer = obs_trace.install_tracer(Tracer())
        try:
            with obs_trace.span("outer", cat="test"):
                with obs_trace.span("inner", cat="test"):
                    assert obs_trace.current_span_stack() == ("outer",
                                                              "inner")
        finally:
            obs_trace.uninstall_tracer()
        evs = tracer.chrome_trace()["traceEvents"]
        inner = next(e for e in evs if e.get("name") == "inner")
        outer = next(e for e in evs if e.get("name") == "outer")
        assert inner["args"]["parent"] == "outer"
        assert "parent" not in outer["args"]
        # inner nests inside outer on the same thread
        assert nesting_violations(evs) == []

    def test_chrome_trace_structure(self):
        tracer = obs_trace.install_tracer(Tracer())
        try:
            with obs_trace.span("a", cat="test", k=1):
                time.sleep(0.001)
            obs_trace.instant("mark", cat="test")
        finally:
            obs_trace.uninstall_tracer()
        doc = tracer.chrome_trace()
        assert "traceEvents" in doc
        xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        metas = [e for e in doc["traceEvents"] if e.get("ph") == "M"]
        insts = [e for e in doc["traceEvents"] if e.get("ph") == "i"]
        assert len(xs) == 1 and len(insts) == 1
        assert any(m["name"] == "thread_name" for m in metas)
        for e in xs + insts:
            assert e["ts"] >= 0 and "pid" in e and "tid" in e
        assert xs[0]["dur"] >= 1000  # slept 1ms
        json.dumps(doc)  # exportable

    def test_bounded_capacity_counts_drops(self):
        tracer = Tracer(capacity=4)
        for i in range(10):
            tracer.add_instant(f"e{i}", "test")
        assert len(tracer) == 4 and tracer.dropped == 6

    def test_second_install_raises(self):
        t = obs_trace.install_tracer(Tracer())
        try:
            with pytest.raises(RuntimeError):
                obs_trace.install_tracer(Tracer())
        finally:
            obs_trace.uninstall_tracer(t)

    def test_requests_detail_validation(self):
        with pytest.raises(ValueError):
            Tracer(detail="everything")


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

class TestMetricsRegistry:
    def test_counter_gauge_histogram(self):
        reg = MetricsRegistry()
        c = reg.counter("tmog_test_total")
        c.inc()
        c.inc(3)
        assert c.value == 4
        g = reg.gauge("tmog_test_depth")
        g.set(7)
        assert g.value == 7
        h = reg.histogram("tmog_test_size", exact=True)
        for v in (1, 2, 2, 8):
            h.observe(v)
        assert h.count == 4 and h.sum == 13
        assert h.exact_counts() == {1: 1, 2: 2, 8: 1}
        assert h.quantile(0.5) == 2

    def test_get_or_create_and_type_conflict(self):
        reg = MetricsRegistry()
        a = reg.counter("tmog_x_total")
        assert reg.counter("tmog_x_total") is a
        with pytest.raises(TypeError):
            reg.gauge("tmog_x_total")

    def test_labels_render_in_prometheus(self):
        reg = MetricsRegistry()
        reg.counter("tmog_y_total", "help text",
                    labels={"entry": "1"}).inc(5)
        reg.counter("tmog_y_total", labels={"entry": "2"}).inc(7)
        text = reg.to_prometheus()
        assert '# TYPE tmog_y_total counter' in text
        assert 'tmog_y_total{entry="1"} 5' in text
        assert 'tmog_y_total{entry="2"} 7' in text
        assert '# HELP tmog_y_total help text' in text

    def test_snapshot_sorted_and_json_stable(self):
        reg = MetricsRegistry()
        reg.counter("tmog_b_total").inc()
        reg.counter("tmog_a_total").inc()
        reg.histogram("tmog_c_size", exact=True).observe(3)
        snap = reg.snapshot()
        assert list(snap) == sorted(snap)
        assert assert_json_stable(snap)  # dumps with sort_keys

    def test_canonical_table_audit(self):
        """The canonical name table is collision-free — every (owner,
        legacy alias) pair maps to exactly ONE canonical name — and its
        names, kinds, owners and aliases are the reference's (the two cost
        counters included)."""
        seen = {}
        for name, (kind, owner, alias, help_) in CANONICAL_METRICS.items():
            assert kind in ("counter", "gauge", "histogram"), name
            assert name.startswith("tmog_"), name
            assert help_, f"{name} has no help text"
            if alias is not None:
                key = (owner, alias)
                assert key not in seen, \
                    f"alias collision: {key} -> {seen.get(key)} and {name}"
                seen[key] = name
        assert ("batcher", "batches") in seen \
            and ("continual", "batches") in seen
        assert seen[("batcher", "batches")] != seen[("continual", "batches")]
        assert {k: v[:3] for k, v in CANONICAL_METRICS.items()} == \
            {k: v[:3] for k, v in JO.CANONICAL_METRICS.items()}
        for name in ("tmog_serve_batcher_device_seconds_total",
                     "tmog_serve_batcher_padding_rows_total"):
            assert CANONICAL_METRICS[name] == JO.CANONICAL_METRICS[name]


class TestRegistryEviction:
    def test_drop_labeled_and_labeled_values(self):
        reg = MetricsRegistry()
        reg.counter("tmog_z_total", labels={"entry": "1"}).inc()
        reg.counter("tmog_z_total", labels={"entry": "2"}).inc()
        reg.gauge("tmog_z_state", labels={"entry": "1"}).set(1)
        assert reg.labeled_values("entry") == ["1", "2"]
        assert reg.drop_labeled("entry", "1") == 2
        assert reg.labeled_values("entry") == ["2"]
        assert 'tmog_z_total{entry="2"}' in reg.snapshot()

    def test_server_prunes_dead_entry_series(self, base):
        """A continual loop stages one entry per refit; the registry must
        stay bounded to the live active/previous/candidate generations."""
        model, train, raws, train_ds, candidate = base
        with ScoringServer(model, max_batch=8, max_wait_ms=1.0) as server:
            for _ in range(4):  # stage/discard churn: versions 2..5
                server.stage_candidate(candidate, warm=False)
                server.discard_candidate()
            server.stage_candidate(candidate, warm=False)
            live = set(server.registry.labeled_values("entry"))
            # active v1 + the latest candidate only — dead entries evicted
            assert "1" in live and len(live) <= 3, live


class TestTelemetryOwnership:
    def test_nested_enter_does_not_tear_down_outer(self, tmp_path):
        tel = Telemetry(out_dir=str(tmp_path / "t"))
        with tel:
            with tel:  # inner enter: not the owner
                pass
            # outer session still recording
            assert obs_trace.active_tracer() is tel.tracer
            assert obs_flight.active_recorder() is tel.recorder
        assert obs_trace.active_tracer() is None

    def test_train_with_caller_started_telemetry(self, base, tmp_path):
        """train(telemetry=<already-started bundle>) must not stop the
        caller's session (and must not dump over it mid-session)."""
        model, train, *_ = base
        tel = Telemetry(out_dir=str(tmp_path / "outer")).start()
        try:
            _train_port(train, telemetry=tel)
            # the caller's session survived the inner train
            assert obs_trace.active_tracer() is tel.tracer
            assert not os.path.exists(tmp_path / "outer" / "trace.json")
        finally:
            tel.stop()


class TestPartialWarm:
    def test_partial_warm_does_not_arm_tm901(self, base):
        model, *_ = base
        plan = model.serving_plan(strict=False)
        plan.warm(buckets=[8])  # partial: later buckets legitimately allocate
        assert plan._warmed is False
        plan.warm()  # the full ladder arms the expectation
        assert plan._warmed is True
        plan.release_executables(drop_shared=False)
        assert plan._warmed is False  # an evicted plan is cold again


class TestLegacyViews:
    """metrics() plain dicts survive as views over the registry, and every
    exported payload round-trips through json with stable keys."""

    def test_batcher_view_matches_registry(self):
        from transmogrifai_tpu_torch.serve import MicroBatcher

        with MicroBatcher(lambda recs: [{"v": 1} for _ in recs],
                          max_batch=4, max_wait_ms=1.0) as mb:
            for _ in range(3):
                mb.score({"a": 1})
            view = mb.metrics()
            snap = mb.registry.snapshot()
        for legacy, canonical in legacy_aliases("batcher").items():
            assert legacy in view, legacy
            if legacy in ("batch_size_hist",):
                continue  # shape differs (exact counts vs summary)
            if isinstance(view[legacy], (int, float)):
                assert view[legacy] == snap[canonical], (legacy, canonical)
        assert view["submitted"] == 3 and view["completed"] == 3
        assert assert_json_stable(view)

    def test_server_views_json_stable(self, base):
        model, *_ = base
        with ScoringServer(model, max_batch=8, max_wait_ms=1.0) as server:
            server.score({f"num{j}": 0.1 for j in range(3)}, timeout=10)
            m = server.metrics()
            snap = server.metrics_snapshot()
            prom = server.prometheus()
        assert assert_json_stable(m)
        assert assert_json_stable(snap)
        # one registry covers batcher + swap + breaker + resilience
        assert "tmog_serve_batcher_submitted_total" in snap
        assert "tmog_serve_swap_swaps_total" in snap
        assert any(k.startswith("tmog_serve_breaker_state") for k in snap)
        assert any(k.startswith("tmog_serve_resilience_quarantined_total")
                   for k in snap)
        assert "# TYPE tmog_serve_batcher_submitted_total counter" in prom
        # legacy view values mirror the canonical source of truth
        assert m["batcher"]["submitted"] \
            == snap["tmog_serve_batcher_submitted_total"]
        assert m["batcher"]["device_seconds"] \
            == snap["tmog_serve_batcher_device_seconds_total"] > 0

    def test_trainer_counters_view(self, base):
        from transmogrifai_tpu_torch.readers import (ListSource,
                                                     MicroBatchStreamingReader)
        from transmogrifai_tpu_torch.workflow.continual import ContinualTrainer

        model, train, raws, train_ds, _cand = base
        reader = MicroBatchStreamingReader(
            ListSource(make_records(32, 5), "s"), batch_interval=0.0,
            max_batch_records=16, max_empty_polls=1)
        with ScoringServer(model, max_batch=16, max_wait_ms=1.0) as server:
            trainer = ContinualTrainer(server, model, reader,
                                       refit_enabled=False)
            metrics = trainer.run()
        assert trainer.counters["batches"] >= 2
        assert trainer.counters["records"] == 32
        # the trainer joined the SERVER's registry (one scrape covers both)
        assert server.registry.snapshot()["tmog_continual_records_total"] \
            == 32
        assert assert_json_stable(metrics)


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

class TestFlightRecorder:
    def test_ring_bound_and_payload_stable(self):
        rec = FlightRecorder(capacity=4)
        for i in range(9):
            rec.record("tick", i=i)
        assert len(rec) == 4 and rec.dropped == 5
        payload = rec.to_payload()
        assert payload["events"][-1]["data"]["i"] == 8
        assert [e["seq"] for e in payload["events"]] == [6, 7, 8, 9]
        assert assert_json_stable(payload)

    def test_compile_event_tagged_with_context(self, base):
        """The compile hook tags its event with the caller's context (a
        library load calls it under no context of its own); a plan's cold
        bucket tags its own ``serve.plan`` site and fingerprint."""
        model, *_ = base
        rec = obs_flight.install_recorder(FlightRecorder())
        try:
            with obs_flight.compile_context("test.site", fingerprint="fp123"):
                with measure_compiles() as probe:
                    note_compile("library_load", library="probe")
                # the probe is live: read it before the plan allocates
                counted = (probe.backend_compiles, probe.events)
            plan = _cold_plan(model)
            with obs_flight.compile_context("test.site", fingerprint="fp123"):
                plan.score([{f"num{j}": 0.5 for j in range(3)}] * 2)
        finally:
            obs_flight.uninstall_recorder()
        assert counted == (1, {"library_load": 1})
        evs = rec.events("backend_compile")
        assert len(evs) >= 2
        assert evs[0]["data"]["site"] == "test.site"
        assert evs[0]["data"]["fingerprint"] == "fp123"
        assert evs[0]["data"]["unexpected"] is False
        assert {e["data"]["what"] for e in evs[1:]} <= {"staging", "landing"}
        assert all(e["data"]["site"] == "serve.plan"
                   and e["data"]["fingerprint"] == plan.fingerprint
                   for e in evs[1:])
        assert rec.unexpected_compiles == 0

    def test_warm_context_compile_fires_tm901(self, base):
        model, *_ = base
        plan = _cold_plan(model)
        rec = obs_flight.install_recorder(FlightRecorder())
        try:
            # the plan's own serve.plan context inherits the WARM expectation
            # from the outer one (a refit wraps layers that open their own)
            with obs_flight.compile_context("outer.warm", warm=True):
                plan.score([{f"num{j}": 0.5 for j in range(3)}] * 2)
        finally:
            obs_flight.uninstall_recorder()
        evs = rec.events("backend_compile")
        assert evs and evs[-1]["data"]["unexpected"] is True
        assert evs[-1]["data"]["site"] == "serve.plan"
        assert rec.unexpected_compiles >= 1
        diags = rec.diagnostics()
        assert diags and all(d.code == "TM901" for d in diags)
        assert "serve.plan" in diags[-1].message

    def test_fault_injection_records_and_autodumps(self, base, tmp_path):
        model, *_ = base
        rec = obs_flight.install_recorder(
            FlightRecorder(dump_dir=str(tmp_path)))
        harness = FaultHarness(seed=0)
        harness.script("device", [TransientScoringError("boom")])
        try:
            with ScoringServer(model, max_batch=4, max_wait_ms=1.0) as srv:
                with harness:
                    out = srv.score({f"num{j}": 0.2 for j in range(3)},
                                    timeout=10)
            assert "error" not in out  # retry/fallback served the record
        finally:
            obs_flight.uninstall_recorder()
        faults = rec.events("fault_injected")
        assert faults and faults[0]["data"]["point"] == "device"
        assert faults[0]["data"]["error"] == "TransientScoringError"
        dumps = [f for f in os.listdir(tmp_path)
                 if f.startswith("flight-fault-")]
        assert dumps, "injected fault did not auto-dump the recorder"
        blob = json.load(open(tmp_path / dumps[0]))
        assert blob["reason"] == "fault_injected:device"
        assert any(e["kind"] == "fault_injected" for e in blob["events"])


# ---------------------------------------------------------------------------
# Serve-path telemetry
# ---------------------------------------------------------------------------

class TestServeTelemetry:
    def test_spans_cover_the_request_lifecycle(self, base):
        model, *_ = base
        tel = Telemetry()
        with tel:
            with ScoringServer(model, max_batch=8, max_wait_ms=1.0) as srv:
                futs = [srv.submit({f"num{j}": 0.1 * i for j in range(3)})
                        for i in range(24)]
                for f in futs:
                    f.result(timeout=10)
        evs = tel.tracer.chrome_trace()["traceEvents"]
        names = {e["name"] for e in evs if e.get("ph") == "X"}
        assert {"serve.flush", "serve.encode", "serve.device",
                "serve.host"} <= names
        assert nesting_violations(evs) == []
        # pipelined serving: encode runs on the flusher thread while the
        # flush span wraps finalize on the finalizer thread, so the causal
        # chain joins on the batch_seq key, not the tid
        flush = next(e for e in evs if e["name"] == "serve.flush")
        seq = flush["args"].get("batch_seq")
        assert seq is not None
        enc = next(e for e in evs if e["name"] == "serve.encode"
                   and e["args"].get("batch_seq") == seq)
        host = next(e for e in evs if e["name"] == "serve.host"
                    and e["args"].get("batch_seq") == seq)
        # the host remainder runs inside its batch's finalize/flush span
        assert host["tid"] == flush["tid"]
        assert host["args"].get("parent") == "serve.flush"
        # encode precedes the batch's host remainder (overlap-safe order)
        assert enc["ts"] <= host["ts"]

    def test_warm_serve_records_zero_compile_events(self, base):
        """A WARM serve replay under the recorder logs no compile events —
        and a cold bucket taken inside a warm context raises TM901."""
        model, *_ = base
        with ScoringServer(model, max_batch=8, max_wait_ms=1.0) as srv:
            srv.score({f"num{j}": 0.3 for j in range(3)}, timeout=10)
            rec = obs_flight.install_recorder(FlightRecorder())
            try:
                with measure_compiles() as probe:
                    for i in range(12):
                        srv.score({f"num{j}": 0.01 * i for j in range(3)},
                                  timeout=10)
                assert probe.backend_compiles == 0
                assert rec.events("backend_compile") == []
                assert rec.unexpected_compiles == 0
                # a cold bucket in a warm path: TM901 must fire
                plan = _cold_plan(model)
                with obs_flight.compile_context("serve.warm-injected",
                                                warm=True):
                    plan.score([{f"num{j}": 0.2 for j in range(3)}] * 2)
                assert rec.unexpected_compiles >= 1
                diags = rec.diagnostics()
                assert diags and {d.code for d in diags} == {"TM901"}
            finally:
                obs_flight.uninstall_recorder()


# ---------------------------------------------------------------------------
# The acceptance e2e: fault schedule -> flight record in causal order
# ---------------------------------------------------------------------------

def _breaker_rollback_run(server_cls, harness_cls, err_cls, obs_mod, model,
                          candidate, records):
    """The reference's breaker-trip -> rollback schedule on one package;
    returns the recorder."""
    rec = obs_mod.flight.install_recorder(obs_mod.FlightRecorder())
    harness = harness_cls(seed=0)
    try:
        # min_bucket=2 keeps at least one bucket out of any earlier plan's
        # state, so the build logs compile events
        with server_cls(model, max_batch=4, max_wait_ms=1.0, min_bucket=2,
                        resilience={"max_retries": 0,
                                    "failure_threshold": 2,
                                    "recovery_batches": 8}) as srv:
            srv.stage_candidate(candidate)
            srv.promote(probation_batches=6)
            harness.script("device", [err_cls("dead"), err_cls("dead")])
            with harness:
                for r in records[:3]:
                    srv.score(r, timeout=10)
            m = srv.swap_metrics()
            assert m["rollbacks"] == 1 and m["active_version"] == 1
    finally:
        obs_mod.flight.uninstall_recorder()
    return rec


class TestFlightE2E:
    def test_breaker_trip_rollback_causal_order(self, base):
        """Under the injected fault schedule (breaker trip ->
        auto-rollback), the flight dump holds compile, breaker-transition,
        swap, and rollback events in causal (seq) order, with the swap's
        plan fingerprints matching the compile events'."""
        import transmogrifai_tpu_torch.obs as TO

        model, train, raws, train_ds, candidate = base
        records = [{k: v for k, v in r.items() if k != "label"}
                   for r in make_records(8, 33)]
        rec = _breaker_rollback_run(ScoringServer, FaultHarness,
                                    TransientScoringError, TO, model,
                                    candidate, records)
        payload = rec.to_payload()
        assert assert_json_stable(payload)
        compiles = rec.events("backend_compile")
        swaps = rec.events("swap")
        rollbacks = rec.events("rollback")
        transitions = rec.events("breaker_transition")
        faults = rec.events("fault_injected")
        assert compiles and swaps and rollbacks and transitions and faults
        # causal order: plan compiles < swap < injected faults < breaker
        # open < rollback
        opened = next(t for t in transitions if t["data"]["to"] == "open")
        assert max(c["seq"] for c in compiles) < swaps[0]["seq"]
        assert swaps[0]["seq"] < faults[0]["seq"] <= opened["seq"]
        assert opened["seq"] < rollbacks[0]["seq"]
        # matching plan fingerprints: the frozen-prep candidate shares the
        # active plan's fingerprint, and the compiles carry the same one
        fp = swaps[0]["data"]["from"]
        assert swaps[0]["data"]["to"] == fp  # shared prefix
        assert rollbacks[0]["data"]["from"] == fp
        assert rollbacks[0]["data"]["to"] == fp
        serve_compiles = [c for c in compiles
                          if c["data"]["site"] == "serve.plan"]
        assert serve_compiles
        assert all(c["data"]["fingerprint"] == fp for c in serve_compiles)
        assert all(c["data"]["unexpected"] is False for c in compiles)

    def test_warm_refit_zero_compile_events(self, base):
        """A warm refit under the recorder logs ZERO compile events (no
        kernel built or loaded, no bucket allocated) and no TM901."""
        model, train, raws, train_ds, _cand = base
        refit = RefitController(model, sleep=lambda s: None)
        refit.prime(train_ds)
        refit.refit(train_ds)  # ensure everything is warm
        rec = obs_flight.install_recorder(FlightRecorder())
        try:
            res = refit.refit(train_ds)
        finally:
            obs_flight.uninstall_recorder()
        assert res.backend_compiles == 0
        assert rec.events("backend_compile") == []
        assert rec.unexpected_compiles == 0 and rec.diagnostics() == []


# ---------------------------------------------------------------------------
# Workflow.train telemetry + TMOG_PROFILE
# ---------------------------------------------------------------------------

class TestTrainTelemetry:
    def test_train_writes_trace_and_metrics(self, base, tmp_path):
        model, train, *_ = base
        teldir = str(tmp_path / "traintel")
        _train_port(train, telemetry=teldir)
        doc = json.load(open(os.path.join(teldir, "trace.json")))
        cats = {e.get("cat") for e in doc["traceEvents"]
                if e.get("ph") == "X"}
        assert "train" in cats  # perf.phase sites re-emit as spans
        names = {e["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "X"}
        assert any(n.startswith("fit.") for n in names), names
        line = json.loads(open(os.path.join(teldir, "metrics.jsonl"))
                          .read().splitlines()[-1])
        assert line["source"] == "Workflow.train"
        assert "backend_compiles" in line["compile"]
        assert any(p.startswith("fit.") for p in line["phases"])
        assert os.path.exists(os.path.join(teldir, "flight.json"))
        # telemetry is OFF again after the context
        assert obs_trace.active_tracer() is None
        assert obs_flight.active_recorder() is None


class TestProfileHook:
    def test_profile_dir_created_and_scores_bitwise_identical(
            self, base, tmp_path, monkeypatch):
        """TMOG_PROFILE wraps the serve dispatch in a torch.profiler
        capture — one Chrome trace written, scores unchanged."""
        model, *_ = base
        records = [{f"num{j}": 0.1 * i for j in range(3)}
                   for i in range(8)]
        plan = model.serving_plan(strict=False)
        baseline = plan.score(records)
        prof = tmp_path / "prof"
        monkeypatch.setenv("TMOG_PROFILE", str(prof))
        profiled = plan.score(records)
        monkeypatch.delenv("TMOG_PROFILE")
        assert os.path.isdir(prof)
        (capture,) = os.listdir(prof)
        assert capture.startswith("serve-") and capture.endswith(".json")
        assert json.load(open(prof / capture))["traceEvents"]
        assert json.dumps(profiled, sort_keys=True) \
            == json.dumps(baseline, sort_keys=True)

    def test_a_capture_short_of_kernels_says_so(self, tmp_path, monkeypatch,
                                                caplog):
        """Each capture counts the kernels the host launched against those
        the device reported (``last_capture``) and warns when the device
        reported fewer — a CPU capture launches none and is complete."""
        import logging
        import types

        from transmogrifai_tpu_torch.obs import profile as P

        monkeypatch.setenv("TMOG_PROFILE", str(tmp_path / "p"))
        with P.maybe_profile("test"):
            pass
        cap = P.last_capture()
        assert cap["tag"] == "test" and os.path.exists(cap["path"])
        assert (cap["launches"], cap["kernels"], cap["complete"]) == (0, 0, True)

        def ev(name, dev):
            return types.SimpleNamespace(
                name=name, device_type=types.SimpleNamespace(name=dev))

        seen = [ev("cudaLaunchKernel", "CPU"), ev("cudaLaunchKernel", "CPU"),
                ev("cudaMemcpyAsync", "CPU"), ev("Memcpy HtoD", "CUDA"),
                ev("encode_slots_kernel<false>", "CUDA")]
        assert P._count(seen) == (2, 1)

        class _Prof:
            def __init__(self, activities):
                pass

            def start(self):
                pass

            def stop(self):
                pass

            def export_chrome_trace(self, path):
                open(path, "w").write("{}")

            def events(self):
                return seen

        monkeypatch.setattr("torch.profiler.profile", _Prof)
        with caplog.at_level(logging.WARNING, logger=P.__name__):
            with P.maybe_profile("short"):
                pass
        cap = P.last_capture()
        assert (cap["tag"], cap["launches"], cap["kernels"], cap["complete"]) \
            == ("short", 2, 1, False)
        assert "missing GPU events: 2 kernel launches, 1 kernels" in caplog.text

    def test_unset_env_is_noop(self, base, monkeypatch):
        monkeypatch.delenv("TMOG_PROFILE", raising=False)
        from transmogrifai_tpu_torch.obs.profile import maybe_profile, profile_dir

        assert profile_dir() == ""
        with maybe_profile("test"):
            pass

    def test_tmog_telemetry_env_switch(self, base, tmp_path, monkeypatch):
        """The TMOG_TELEMETRY env var enables the train's artifacts with no
        argument (and resolve_telemetry defers when already active) — the
        reference's env test, through ``Workflow.train`` (the port has no
        ``cli``)."""
        model, train, *_ = base
        teldir = tmp_path / "envtel"
        monkeypatch.setenv("TMOG_TELEMETRY", str(teldir))
        _train_port(train)
        assert (teldir / "trace.json").exists()
        assert (teldir / "flight.json").exists()
        tel = Telemetry().start()
        try:
            assert resolve_telemetry(None) is None
        finally:
            tel.stop()


# ---------------------------------------------------------------------------
# Parity with the JAX package on the same call sequences
# ---------------------------------------------------------------------------

def _serve_spans(server_cls, obs_mod, model, records, **kw):
    """X spans of one lockstep, flush-on-size serve: {(name, parent, arg
    keys)} and the records served."""
    tel = obs_mod.Telemetry()
    with tel:
        with server_cls(model, max_batch=8, max_wait_ms=10_000,
                        pipeline_depth=0, **kw) as srv:
            futs = [srv.submit(r) for r in records]
            out = [f.result(timeout=30) for f in futs]
    evs = tel.tracer.chrome_trace()["traceEvents"]
    spans = {(e["name"], e["args"].get("parent"),
              tuple(sorted(k for k in e["args"] if k != "parent")))
             for e in evs if e.get("ph") == "X"}
    return spans, out, evs


class TestParity:
    def test_serve_span_names_nesting_and_args_equal_the_reference(
            self, base, jax_model):
        model, *_ = base
        records = [{k: v for k, v in r.items() if k != "label"}
                   for r in make_records(16, 3)]
        tspans, _, tevs = _serve_spans(ScoringServer, __import__(
            "transmogrifai_tpu_torch.obs", fromlist=["x"]), model, records)
        jspans, _, jevs = _serve_spans(JS.ScoringServer, JO, jax_model, records)
        assert tspans == jspans
        assert {s[0] for s in tspans} == {"serve.flush", "serve.encode",
                                          "serve.device", "serve.host"}
        # one flush per 8 records, each with its three phases, in both
        for evs in (tevs, jevs):
            flushes = [e for e in evs if e.get("name") == "serve.flush"]
            assert [f["args"]["batch"] for f in flushes] == [8, 8]
            assert nesting_violations(evs) == []

    def test_train_span_names_equal_the_reference(self, base, tmp_path):
        """The train's ``train`` spans: the port's are the reference's,
        less its program-cache ``compile.*`` phases (the port compiles
        nothing at run time)."""
        model, train, *_ = base
        names = {}
        for key, fn in (("t", _train_port), ("j", _train_jax)):
            d = str(tmp_path / key)
            fn(train, telemetry=d)
            doc = json.load(open(os.path.join(d, "trace.json")))
            names[key] = {e["name"] for e in doc["traceEvents"]
                          if e.get("ph") == "X" and e.get("cat") == "train"
                          and ".compile." not in e["name"]
                          and not e["name"].startswith("compile.")}
        assert names["t"] == names["j"]
        assert "fit.modelSelector.validate.cv.dispatch.LogisticRegression" \
            in names["t"]

    def test_flight_event_kinds_in_order_equal_the_reference(
            self, base, jax_model):
        """The breaker-trip -> rollback schedule gives the same event kinds
        in the same order in both packages; compile events are compared as
        "0 on the warm path, >= 1 at the build", not by count."""
        import transmogrifai_tpu_torch.obs as TO
        from transmogrifai_tpu.readers.base import rows_to_dataset as j_rows
        from transmogrifai_tpu.workflow.continual import (
            RefitController as JRefit)
        from transmogrifai_tpu.workflow.workflow import (
            dedup_raw_features as j_dedup)

        model, train, raws, train_ds, candidate = base
        jraws = j_dedup(jax_model.result_features)
        jds = j_rows(train, jraws)
        jref = JRefit(jax_model, sleep=lambda s: None)
        jref.prime(jds)
        jcand = jref.refit(jds).model
        records = [{k: v for k, v in r.items() if k != "label"}
                   for r in make_records(8, 33)]
        kinds = {}
        for key, args in (
                ("t", (ScoringServer, FaultHarness, TransientScoringError, TO,
                       model, candidate)),
                ("j", (JS.ScoringServer, JS.FaultHarness,
                       JS.TransientScoringError, JO, jax_model, jcand))):
            rec = _breaker_rollback_run(*args, records)
            evs = rec.events()
            first_swap = next(i for i, e in enumerate(evs) if e["kind"] == "swap")
            assert any(e["kind"] == "backend_compile" for e in evs[:first_swap])
            assert not any(e["kind"] == "backend_compile"
                           for e in evs[first_swap:])
            kinds[key] = [e["kind"] for e in evs if e["kind"] != "backend_compile"]
        assert kinds["t"] == kinds["j"]
        assert kinds["t"][0] == "swap" and kinds["t"][-1] == "rollback"

    def test_served_records_bitwise_with_telemetry_on_and_off(self, base):
        model, *_ = base
        records = [{k: v for k, v in r.items() if k != "label"}
                   for r in make_records(32, 9)]
        _, on, _ = _serve_spans(ScoringServer, __import__(
            "transmogrifai_tpu_torch.obs", fromlist=["x"]), model, records)
        with ScoringServer(model, max_batch=8, max_wait_ms=10_000,
                           pipeline_depth=0) as srv:
            off = [f.result(timeout=30) for f in [srv.submit(r) for r in records]]
        assert json.dumps(on, sort_keys=True) == json.dumps(off, sort_keys=True)
        # and at the requests detail, pipelined
        tel = Telemetry(detail="requests")
        with tel:
            with ScoringServer(model, max_batch=8, max_wait_ms=10_000) as srv:
                req = [f.result(timeout=30)
                       for f in [srv.submit(r) for r in records]]
        assert json.dumps(req, sort_keys=True) == json.dumps(off, sort_keys=True)


# ---------------------------------------------------------------------------
# The training resilience trail in the flight recorder
# ---------------------------------------------------------------------------

def _selector_sweep(pkg_key, path):
    """Two LR families swept under a journal in one package; returns the
    flight events recorded."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    y = (rng.random(300) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float64)
    if pkg_key == "t":
        from transmogrifai_tpu_torch.data.dataset import Column, Dataset
        from transmogrifai_tpu_torch.types import OPVector, RealNN
        from transmogrifai_tpu_torch.workflow import resilience as R
        fb, sel_cls, lr, obs_mod = (FeatureBuilder, BinaryClassificationModelSelector,
                                    LogisticRegression, __import__(
                                        "transmogrifai_tpu_torch.obs", fromlist=["x"]))
    else:
        from transmogrifai_tpu.data.dataset import Column, Dataset
        from transmogrifai_tpu.types import OPVector, RealNN
        from transmogrifai_tpu.workflow import resilience as R
        fb, sel_cls, lr, obs_mod = (J.FeatureBuilder, J.BinaryClassificationModelSelector,
                                    JLR, JO)
    label = fb.of("label", RealNN).extract_field().as_response()
    vec = fb.of("v", OPVector).extract_field().as_predictor()
    ds = Dataset({"label": Column.from_values(RealNN, y.tolist()),
                  "v": Column.vector(x)})
    sel = sel_cls.with_cross_validation(
        num_folds=2, models=[(lr(), [{"reg_param": 0.001}]),
                             (lr(), [{"reg_param": 0.1}])])
    label.transform_with(sel, vec)
    rec = obs_mod.flight.install_recorder(obs_mod.FlightRecorder())
    try:
        with R.resilient_training(journal=R.SweepJournal(path)):
            sel.fit(ds)
    finally:
        obs_mod.flight.uninstall_recorder()
    return rec.events()


class TestTrainingFlightEvents:
    def test_replayed_sweep_blocks_record_resume_events_as_the_reference(
            self, tmp_path):
        """A re-run of a journaled sweep records one ``sweep_block_resume``
        per replayed family in both packages, the first run none."""
        kinds = {}
        for key in ("t", "j"):
            path = str(tmp_path / f"{key}.json")
            first = _selector_sweep(key, path)
            again = _selector_sweep(key, path)
            assert not any(e["kind"] == "sweep_block_resume" for e in first)
            kinds[key] = [(e["kind"], e["data"]["family"]) for e in again
                          if e["kind"] != "backend_compile"]
        assert kinds["t"] == kinds["j"] == [
            ("sweep_block_resume", "LogisticRegression")] * 2

    def test_retry_and_bucket_shrink_events(self):
        """A retried training fault records ``train_retry`` (as the
        reference's retry_call does); an out-of-memory block that drops to
        the next row bucket records ``degrade_bucket_shrink``."""
        from transmogrifai_tpu.workflow import resilience as JR
        from transmogrifai_tpu_torch.workflow import resilience as TR

        def flaky_fn(err_cls):
            left = [1]

            def flaky():
                if left[0]:
                    left[0] -= 1
                    raise err_cls("unavailable: preempted")
                return "ok"
            return flaky

        events = {}
        for key, R, obs_mod, err in (
                ("t", TR, __import__("transmogrifai_tpu_torch.obs", fromlist=["x"]),
                 TransientScoringError),
                ("j", JR, JO, JS.TransientScoringError)):
            rec = obs_mod.flight.install_recorder(obs_mod.FlightRecorder())
            try:
                with R.resilient_training(policy=R.RetryPolicy(sleep=lambda s: None)):
                    assert R.retry_call(flaky_fn(err), "stage_fit", stage="s") == "ok"
            finally:
                obs_mod.flight.uninstall_recorder()
            events[key] = [(e["kind"], e["data"]["point"], e["data"]["attempt"],
                            e["data"]["stage"]) for e in rec.events()]
        assert events["t"] == events["j"] == [("train_retry", "stage_fit", 1, "s")]

        def attempt(row_cap, i):
            if (1000 if row_cap is None else row_cap) > 512:
                raise TransientScoringError("CUDA out of memory")
            return np.ones((1, 2))

        rec = obs_flight.install_recorder(FlightRecorder())
        try:
            with TR.resilient_training(policy=TR.RetryPolicy(sleep=lambda s: None)):
                TR.run_sweep_block(attempt, "F", rows=1000)
        finally:
            obs_flight.uninstall_recorder()
        (shrink,) = rec.events("degrade_bucket_shrink")
        assert (shrink["data"]["family"], shrink["data"]["rows_from"],
                shrink["data"]["row_cap"]) == ("F", 1000, 512)
