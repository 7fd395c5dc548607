"""Per-request causal tracing, per-tenant device cost and the fleet's status
line in the port (``obs/reqtrace.py``, ``serve/batcher.py``,
``serve/registry.py``) and the deploy store's flight events
(``deploy/store.py``), held to the JAX package's.

The reference's ``tests/test_obs_requests.py`` test by test, under the same
names, on the CPU, less the ``cli top`` half of
``test_statusz_stream_and_cli_top`` (no ``cli/`` yet); the out-of-core
flight events (``spill_activation``, ``prefetch_stall``, ``chunk_resume``)
also carry the JAX package's payload keys.  The reference's
fleet replay runs through ``cli serve --models ... --telemetry DIR
--trace-detail requests --statusz-out``; here the same replay runs through
the library calls that command makes (a ``FleetServer`` under
``Telemetry(out_dir, detail="requests")`` with the SLO monitor armed, one
``statusz()`` line written after the replay).

Then parity: the same call sequences to both packages give the same
canonical metric names and label sets, per-tenant device seconds that sum
to the batch total in each, and ``reconstruct_request`` chains with the
same phases.  The port's ``device`` cost mark is the batch's prefix as the
plan times it (CUDA events on a card; the host's clock here).
"""

import json
import re
import threading
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
    Telemetry,
    flight as obs_flight,
    reconstruct_request,
    trace as obs_trace,
)
from transmogrifai_tpu_torch.obs.reqtrace import request_events
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.readers.files import DataReaders
from transmogrifai_tpu_torch.serve import (
    FaultHarness,
    FleetServer,
    ScoringServer,
    TransientScoringError,
)


def _records(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(0, 1, n)
    color = rng.choice(["red", "green", "blue"], n)
    y = (rng.random(n) < 1 / (1 + np.exp(-(1.5 * x1 + (color == "red"))))
         ).astype(float)
    return [{"label": float(y[i]), "x1": float(x1[i]),
             "color": str(color[i])} for i in range(n)]


def _train(seed: int, n: int = 200, pkg=None):
    """One tenant's model (trained by the port, or by the JAX package when
    ``pkg`` is given) and its records without the label."""
    import pandas as pd

    records = _records(seed, n)
    if pkg is None:
        fb, tm, sel_cls, wf_cls, lr, dr = (
            FeatureBuilder, transmogrify, BinaryClassificationModelSelector,
            Workflow, LogisticRegression, DataReaders)
    else:
        fb, tm, sel_cls, wf_cls, lr, dr = (
            J.FeatureBuilder, J.transmogrify, J.BinaryClassificationModelSelector,
            J.Workflow, JLR, JDataReaders)
    label = fb.RealNN("label").extract_field().as_response()
    f_x1 = fb.Real("x1").extract_field().as_predictor()
    f_color = fb.PickList("color").extract_field().as_predictor()
    checked = label.sanity_check(tm([f_x1, f_color]))
    sel = sel_cls.with_train_validation_split(
        models=[(lr(), [{"reg_param": 0.01}])])
    pred = label.transform_with(sel, checked)
    model = (wf_cls().set_result_features(label, pred)
             .set_reader(dr.Simple.dataframe(pd.DataFrame(records)))
             ).train()
    nolabel = [{k: v for k, v in r.items() if k != "label"}
               for r in records]
    return model, nolabel


@pytest.fixture(scope="module")
def two_models():
    with use_device("cpu"):
        a = _train(7)
        b = _train(99)
        assert a[0].serving_plan().fingerprint != b[0].serving_plan().fingerprint
    return a, b


@pytest.fixture(scope="module")
def two_jax_models():
    return _train(7, pkg=J), _train(99, pkg=J)


@pytest.fixture(autouse=True)
def _clean_telemetry():
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


def _replay(fleet_cls, tel_cls, models, tel_dir, statusz_path):
    """The reference's fleet replay: 24 records of each tenant interleaved,
    flushed as one batch that mixes both tenants (``max_batch`` is the 48
    records and the window is longer than any submit loop, so the only flush
    is on size, however busy the host), the SLO monitor armed, telemetry at
    the requests detail dumped under ``tel_dir``, one statusz line after."""
    (model_a, recs_a), (model_b, recs_b) = models
    records = []
    for ra, rb in zip(recs_a[:24], recs_b[:24]):
        records.append(("t_a", ra))
        records.append(("t_b", rb))
    tel = tel_cls(out_dir=str(tel_dir), detail="requests")
    with tel:
        with fleet_cls(max_batch=len(records), max_wait_ms=30_000) as fleet:
            fleet.register("t_a", model_a)
            fleet.register("t_b", model_b)
            fleet.arm_slo_monitor()
            futs = [fleet.submit(t, r) for t, r in records]
            rows = [f.result(timeout=60) for f in futs]
            with open(statusz_path, "w") as fh:
                fh.write(json.dumps(fleet.statusz(), sort_keys=True) + "\n")
    trace = json.loads((tel_dir / "trace.json").read_text())
    return trace, rows


# ---------------------------------------------------------------------------
# Fleet replay -> trace.json -> full causal chain per request
# ---------------------------------------------------------------------------

class TestFleetReplayCausalChain:
    @pytest.fixture(scope="class")
    def replay(self, two_models, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("fleet_replay")
        statusz = tmp / "statusz.jsonl"
        with use_device("cpu"):
            trace, _rows = _replay(FleetServer, Telemetry, two_models,
                                   tmp / "tel", statusz)
        return tmp, trace, statusz

    def test_causal_chain_across_shared_batch(self, replay):
        _tmp, trace, _statusz = replay
        reqs = request_events(trace)
        assert reqs, "the replay recorded no request tracks"
        # choose a request whose flushed batch carried BOTH tenants
        chosen = None
        for rid, pair in sorted(reqs.items()):
            if "e" not in pair:
                continue
            seq = pair["e"]["args"].get("batch_seq")
            peers = {p["e"]["args"].get("tenant") for p in reqs.values()
                     if "e" in p
                     and p["e"]["args"].get("batch_seq") == seq}
            if len(peers) >= 2:
                chosen = rid
                break
        assert chosen is not None, "no flush mixed two tenants"
        chain = reconstruct_request(trace, chosen)
        # the complete causal chain with per-phase durations
        assert chain["outcome"] == "ok"
        assert chain["tenant"] in ("t_a", "t_b")
        assert chain["queue_ms"] is not None and chain["queue_ms"] >= 0
        assert chain["total_ms"] >= chain["queue_ms"]
        assert chain["batch"] is not None and chain["batch"]["size"] >= 2
        for phase in ("encode", "device", "host"):
            assert phase in chain["phases"], chain
            assert chain["phases"][phase]["ms"] >= 0.0
        # padding waste + bucket of the device dispatch are recorded
        assert chain["phases"]["device"]["bucket"] >= 1
        assert chain["phases"]["device"]["padded"] >= 0
        # the batch really was shared with the other tenant
        assert len(chain["peer_tenants"]) == 2, chain["peer_tenants"]
        # submit precedes flush precedes response on the trace timeline
        assert chain["submit_ts_us"] <= chain["batch"]["ts_us"] + 1.0
        assert chain["response_ts_us"] >= chain["batch"]["ts_us"]

    def test_every_request_tracked_and_linked(self, replay):
        _tmp, trace, _statusz = replay
        reqs = request_events(trace)
        assert len(reqs) == 48  # one track per replayed record
        flush_seqs = {ev["args"]["batch_seq"]
                      for ev in trace["traceEvents"]
                      if ev.get("ph") == "X"
                      and ev.get("name") == "serve.flush"}
        for rid, pair in reqs.items():
            assert set(pair) == {"b", "e"}, f"request {rid} unpaired"
            assert pair["e"]["args"]["batch_seq"] in flush_seqs

    def test_statusz_stream_and_cli_top(self, replay):
        _tmp, _trace, statusz = replay
        lines = [json.loads(line) for line
                 in statusz.read_text().splitlines() if line.strip()]
        assert lines, "the replay emitted no statusz lines"
        last = lines[-1]
        assert set(last["tenants"]) == {"t_a", "t_b"}
        assert last["fleet"]["slo_monitor_armed"] is True
        row = last["tenants"]["t_a"]
        assert row["completed"] == 24
        assert row["device_seconds"] > 0
        assert row["budget_remaining"] is not None


# ---------------------------------------------------------------------------
# Per-tenant device-time accounting sums to the batch total
# ---------------------------------------------------------------------------

class TestDeviceCostAccounting:
    def test_per_tenant_device_seconds_sum_to_total(self, two_models):
        (model_a, recs_a), (model_b, recs_b) = two_models
        with FleetServer(max_batch=64, max_wait_ms=20) as fleet:
            fleet.register("a", model_a, slo="gold")
            fleet.register("b", model_b, slo="bronze")
            futs = []
            for ra, rb in zip(recs_a[:40], recs_b[:40]):
                futs.append(fleet.submit("a", ra))
                futs.append(fleet.submit("b", rb))
            for f in futs:
                f.result(timeout=30)
            total = fleet.batcher.metrics()["device_seconds"]
            per_tenant = fleet.batcher.tenant_metrics()
            status = fleet.statusz()
            plans = sum(fleet.models.get(t).swapper.active.plan.metrics()["device_ms"]
                        for t in ("a", "b")) / 1e3
        assert total > 0
        assert per_tenant["a"]["device_seconds"] > 0
        assert per_tenant["b"]["device_seconds"] > 0
        # exact amortization: the fleet fans each flush out per tenant
        # sub-batch, so tenant attribution is direct measurement
        assert sum(row["device_seconds"] for row in per_tenant.values()) \
            == pytest.approx(total, rel=1e-6)
        # statusz reads the canonical counters: the same seconds the plans
        # summed before the counters existed
        assert status["fleet"]["device_seconds"] == total
        assert total == pytest.approx(plans, rel=1e-9)

    def test_single_model_total_and_padding(self, two_models):
        (model_a, recs_a), _ = two_models
        with ScoringServer(model_a, max_batch=32, max_wait_ms=5) as server:
            futs = [server.submit(r) for r in recs_a[:50]]
            for f in futs:
                f.result(timeout=30)
            status = server.statusz()
            plan = server.plan.metrics()
        assert status["device_seconds"] > 0
        assert status["padding_rows"] >= 0
        assert status["completed"] == 50
        assert status["breaker"] == "closed"
        assert status["padding_rows"] == plan["padding_rows"]
        assert status["device_seconds"] == pytest.approx(
            plan["device_ms"] / 1e3, rel=1e-9)


# ---------------------------------------------------------------------------
# Threaded multi-tenant submit storm — structural trace checks
# ---------------------------------------------------------------------------

class TestRequestStorm:
    def test_no_orphans_under_concurrent_load(self, two_models):
        from test_torch_obs import nesting_violations

        (model_a, recs_a), (model_b, recs_b) = two_models
        tel = Telemetry(detail="requests")
        n_threads, per_thread = 6, 25
        tel.start()
        try:
            with FleetServer(max_batch=32, max_wait_ms=2) as fleet:
                fleet.register("a", model_a, slo="gold")
                fleet.register("b", model_b, slo="bronze")
                errors = []

                def storm(i):
                    try:
                        tenant, recs = (("a", recs_a), ("b", recs_b))[i % 2]
                        futs = [fleet.submit(tenant, recs[j % len(recs)])
                                for j in range(per_thread)]
                        for f in futs:
                            f.result(timeout=60)
                    except Exception as e:  # noqa: BLE001 — surfaced below
                        errors.append(e)

                threads = [threading.Thread(target=storm, args=(i,))
                           for i in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                assert not errors, errors
        finally:
            tel.stop()
        trace = tel.tracer.chrome_trace()
        reqs = request_events(trace)
        assert len(reqs) == n_threads * per_thread
        # no orphaned async events: every begin pairs with exactly one end
        for rid, pair in reqs.items():
            assert set(pair) == {"b", "e"}, f"request {rid} unpaired"
        # every end links to a real flush span of this trace
        flush_seqs = {ev["args"]["batch_seq"]
                      for ev in trace["traceEvents"]
                      if ev.get("ph") == "X"
                      and ev.get("name") == "serve.flush"}
        outcomes = set()
        for pair in reqs.values():
            outcomes.add(pair["e"]["args"]["outcome"])
            assert pair["e"]["args"]["batch_seq"] in flush_seqs
        assert outcomes == {"ok"}
        # X spans still nest per thread under the storm
        assert nesting_violations(trace["traceEvents"]) == []


# ---------------------------------------------------------------------------
# Prometheus exposition conformance over the canonical table
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?'
    r' (-?(?:[0-9.]+(?:[eE][+-]?[0-9]+)?|inf|nan))$')


def _parse_exposition(text: str):
    """Parse the full text exposition, asserting format conformance:
    every line is HELP/TYPE/sample, TYPE precedes its family's samples,
    no duplicate TYPE, every sample belongs to a typed family."""
    helps, types = {}, {}
    samples = []
    assert text.endswith("\n")
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# HELP "):
            name, _, rest = line[len("# HELP "):].partition(" ")
            helps[name] = rest
        elif line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            assert name not in types, f"duplicate TYPE for {name}"
            assert kind in ("counter", "gauge", "summary"), line
            types[name] = kind
        else:
            m = _SAMPLE_RE.match(line)
            assert m, f"malformed exposition line: {line!r}"
            name = m.group(1)
            family = name
            if family not in types:
                for suffix in ("_count", "_sum"):
                    if name.endswith(suffix) \
                            and name[:-len(suffix)] in types:
                        family = name[:-len(suffix)]
                        break
            assert family in types, f"sample {name} precedes its TYPE"
            if family != name:
                assert types[family] == "summary", line
            float(m.group(3))
            samples.append((name, m.group(2)))
    return helps, types, samples


class TestPrometheusConformance:
    def test_full_exposition_covers_canonical_table(self, two_models):
        (model_a, recs_a), (model_b, recs_b) = two_models
        with FleetServer(max_batch=32, max_wait_ms=5) as fleet:
            fleet.register("a", model_a, slo="gold")
            fleet.register("b", model_b, slo="bronze")
            futs = [fleet.submit("a", r) for r in recs_a[:20]] \
                + [fleet.submit("b", r) for r in recs_b[:20]]
            for f in futs:
                f.result(timeout=30)
            text = fleet.prometheus()
        helps, types, samples = _parse_exposition(text)
        prom_kind = {"counter": "counter", "gauge": "gauge",
                     "histogram": "summary"}
        for name, (kind, _own, _alias, help_text) in \
                CANONICAL_METRICS.items():
            assert name in types, f"no # TYPE for canonical {name}"
            assert types[name] == prom_kind[kind], name
            assert name in helps, f"no # HELP for canonical {name}"
            assert helps[name] == help_text, name
        # live per-tenant series made it into the exposition
        sample_keys = {n + (lab or "") for n, lab in samples}
        assert 'tmog_serve_batcher_completed_total{tenant="a"}' \
            in sample_keys
        assert 'tmog_serve_batcher_device_seconds_total{tenant="b"}' \
            in sample_keys

    def test_single_server_exposition_parses(self, two_models):
        (model_a, recs_a), _ = two_models
        with ScoringServer(model_a, max_batch=16, max_wait_ms=2) as server:
            futs = [server.submit(r) for r in recs_a[:10]]
            for f in futs:
                f.result(timeout=30)
            _parse_exposition(server.prometheus())


# ---------------------------------------------------------------------------
# Fleet fault points carry the tenant into the flight snapshot
# ---------------------------------------------------------------------------

class TestFaultTenantAttribution:
    def test_route_fault_tagged_and_autodumped_with_tenant(
            self, two_models, tmp_path):
        (model_a, recs_a), _ = two_models
        recorder = obs_flight.install_recorder(
            FlightRecorder(dump_dir=str(tmp_path)))
        try:
            with FleetServer(max_batch=8, max_wait_ms=1) as fleet:
                fleet.register("victim", model_a, slo="gold")
                harness = FaultHarness(seed=0)
                harness.script("route", [TransientScoringError("boom")])
                with harness:
                    fut = fleet.submit("victim", recs_a[0])
                    with pytest.raises(TransientScoringError):
                        fut.result(timeout=30)
        finally:
            obs_flight.uninstall_recorder()
        faults = recorder.events("fault_injected")
        assert len(faults) == 1
        assert faults[0]["data"]["point"] == "route"
        assert faults[0]["data"]["tenant"] == "victim"
        dump = json.loads((tmp_path / "flight-fault-001.json").read_text())
        dumped = [ev for ev in dump["events"]
                  if ev["kind"] == "fault_injected"]
        assert dumped and dumped[0]["data"]["tenant"] == "victim"

    def test_serve_level_fault_stays_untagged(self, two_models, tmp_path):
        (model_a, recs_a), _ = two_models
        recorder = obs_flight.install_recorder(FlightRecorder())
        try:
            plan = model_a.serving_plan()
            harness = FaultHarness(seed=0)
            harness.script("device", [TransientScoringError("boom")])
            with harness, pytest.raises(TransientScoringError):
                plan.score(recs_a[:4])
        finally:
            obs_flight.uninstall_recorder()
        faults = recorder.events("fault_injected")
        assert len(faults) == 1
        assert "tenant" not in faults[0]["data"]


# ---------------------------------------------------------------------------
# Out-of-core flight events (data/chunked.py, readers/prefetch.py,
# workflow/ooc.py)
# ---------------------------------------------------------------------------

def _recorded(flight_mod, kind, fn):
    """The ``kind`` events ``fn()`` records under a fresh recorder of
    ``flight_mod`` (either package's), and ``fn``'s result."""
    recorder = flight_mod.install_recorder(flight_mod.FlightRecorder())
    try:
        out = fn()
    finally:
        flight_mod.uninstall_recorder()
    return recorder.events(kind), out


class TestOutOfCoreFlightEvents:
    def test_spill_activation_recorded(self, tmp_path):
        from transmogrifai_tpu.data import chunked as JC
        from transmogrifai_tpu.data.dataset import Column as JColumn
        from transmogrifai_tpu.data.dataset import Dataset as JDataset
        from transmogrifai_tpu_torch.data.chunked import ChunkedDataset, maybe_chunk
        from transmogrifai_tpu_torch.data.dataset import Column, Dataset
        from transmogrifai_tpu_torch.types import Real

        x = np.arange(4096, dtype=np.float64)
        ds = Dataset({"x": Column(Real, x, np.ones(4096, dtype=np.bool_))})
        evs, out = _recorded(obs_flight, "spill_activation", lambda: maybe_chunk(
            ds, budget=1024, spill_dir=str(tmp_path / "spill")))
        assert isinstance(out, ChunkedDataset)
        assert len(evs) == 1
        assert evs[0]["data"]["host_budget"] == 1024
        assert evs[0]["data"]["dataset_bytes"] > 1024
        jds = JDataset({"x": JColumn(J.types.Real, x, np.ones(4096, dtype=np.bool_))})
        jevs, _ = _recorded(JO.flight, "spill_activation", lambda: JC.maybe_chunk(
            jds, budget=1024, spill_dir=str(tmp_path / "jspill")))
        assert evs[0]["data"] == jevs[0]["data"]

    def test_prefetch_stall_recorded(self):
        from transmogrifai_tpu.readers import prefetch as JPF
        from transmogrifai_tpu_torch.readers.prefetch import (ChunkPrefetcher,
                                                              PrefetchStats)

        def slow_loader(ci):
            time.sleep(0.02)
            return ci * 10

        stats = PrefetchStats()

        def drain():
            with ChunkPrefetcher(slow_loader, 4, stats=stats) as chunks:
                return [item for _ci, item in chunks]

        evs, got = _recorded(obs_flight, "prefetch_stall", drain)
        assert got == [0, 10, 20, 30]
        assert evs, "an immediately-draining consumer must record stalls"
        assert stats.stalls == len(evs)
        assert all(ev["data"]["wait_s"] > 0 for ev in evs)
        assert all(ev["data"]["chunk"] < 4 for ev in evs)

        def jdrain():
            with JPF.ChunkPrefetcher(slow_loader, 4) as chunks:
                return [item for _ci, item in chunks]

        jevs, _ = _recorded(JO.flight, "prefetch_stall", jdrain)
        assert jevs and sorted(evs[0]["data"]) == sorted(jevs[0]["data"])

    def test_chunk_resume_recorded(self, tmp_path):
        from transmogrifai_tpu.data import chunked as JC
        from transmogrifai_tpu.data.dataset import Column as JColumn
        from transmogrifai_tpu.data.dataset import Dataset as JDataset
        from transmogrifai_tpu.readers import OffsetCheckpoint as JOffsetCheckpoint
        from transmogrifai_tpu.workflow import ooc as JOoc
        from transmogrifai_tpu.workflow.dag import compute_dag as j_compute_dag
        from transmogrifai_tpu_torch.data.chunked import ChunkedDataset
        from transmogrifai_tpu_torch.data.dataset import Column, Dataset
        from transmogrifai_tpu_torch.readers import OffsetCheckpoint
        from transmogrifai_tpu_torch.types import Real, RealNN
        from transmogrifai_tpu_torch.workflow.dag import compute_dag
        from transmogrifai_tpu_torch.workflow.ooc import (EpochStats,
                                                          chunked_transform_epoch)

        rng = np.random.default_rng(3)
        n = 600
        nums = [rng.normal(size=n) for _ in range(3)]
        y = (rng.random(n) > 0.5).astype(np.float64)
        data = {}
        for key, pkg, column, dataset, real, realnn in (
                ("t", None, Column, Dataset, Real, RealNN),
                ("j", J, JColumn, JDataset, J.types.Real, J.types.RealNN)):
            cols = {f"num{i}": column(real, v, np.ones(n, dtype=np.bool_))
                    for i, v in enumerate(nums)}
            cols["label"] = column(realnn, y, np.ones(n, dtype=np.bool_))
            fb = FeatureBuilder if pkg is None else pkg.FeatureBuilder
            tm = transmogrify if pkg is None else pkg.transmogrify
            label = fb.of("label", realnn).extract_field().as_response()
            feats = [fb.of(f"num{i}", real).extract_field().as_predictor()
                     for i in range(3)]
            checked = label.sanity_check(tm(feats))
            wf = (Workflow() if pkg is None else pkg.Workflow())
            m = wf.set_input_dataset(dataset(cols)).set_result_features(
                label, checked).train()
            data[key] = (dataset(cols), m)

        out = {}
        for key, cds_cls, ckpt_cls, dag, epoch, stats_cls, flight in (
                ("t", ChunkedDataset, OffsetCheckpoint, compute_dag,
                 chunked_transform_epoch, EpochStats, obs_flight),
                ("j", JC.ChunkedDataset, JOffsetCheckpoint, j_compute_dag,
                 JOoc.chunked_transform_epoch, JOoc.EpochStats, JO.flight)):
            ds, m = data[key]
            runners = [m.fitted.get(s.uid, s)
                       for layer in dag(m.result_features) for s in layer]
            cds = cds_cls.from_dataset(ds, chunk_rows=256,
                                       spill_dir=str(tmp_path / f"store_{key}"))
            ckpt = ckpt_cls(str(tmp_path / f"offsets_{key}.json"))
            epoch(cds, runners, checkpoint=ckpt)
            # re-run the SAME committed epoch under a recorder: the resume
            # skips every chunk and records exactly that
            stats = stats_cls()
            evs, _ = _recorded(flight, "chunk_resume", lambda: epoch(
                cds, runners, checkpoint=ckpt, stats=stats))
            assert stats.chunks_skipped == cds.n_chunks
            assert len(evs) == 1
            assert evs[0]["data"]["skipped_chunks"] == cds.n_chunks
            assert evs[0]["data"]["total_chunks"] == cds.n_chunks
            out[key] = evs[0]["data"]
        assert sorted(out["t"]) == sorted(out["j"])
        assert {k: v for k, v in out["t"].items() if k != "epoch"} == \
            {k: v for k, v in out["j"].items() if k != "epoch"}


class TestDeployFlightEvents:
    """The four ``artifact_*`` flight kinds of the deploy store carry the JAX
    package's payload keys: a pack, a hydrate, a clean miss (kernel
    dispatch drift in each package's terms) and a TM510 refusal."""

    @pytest.fixture(scope="class")
    def artifacts(self, two_models, two_jax_models, tmp_path_factory):
        from transmogrifai_tpu.deploy import pack_model as j_pack
        from transmogrifai_tpu_torch.deploy import pack_model

        out = {}
        for key, flight, pack, model in (
                ("t", obs_flight, pack_model, two_models[0][0]),
                ("j", JO.flight, j_pack, two_jax_models[0][0])):
            root = str(tmp_path_factory.mktemp(f"artifact_{key}"))
            with use_device("cpu"):
                evs, _ = _recorded(flight, "artifact_packed", lambda: pack(
                    model, root, min_bucket=8, max_bucket=32))
            out[key] = (root, model, evs)
        return out

    @staticmethod
    def _keys(evs):
        assert len(evs) == 1, evs
        return sorted(evs[0]["data"])

    def test_packed_keys(self, artifacts):
        (_, _, t), (_, _, j) = artifacts["t"], artifacts["j"]
        assert self._keys(t) == self._keys(j)
        assert t[0]["data"]["buckets"] == j[0]["data"]["buckets"] == [8, 16, 32]

    def test_hydrated_keys(self, artifacts):
        from transmogrifai_tpu.deploy import ArtifactStore as JStore
        from transmogrifai_tpu_torch.deploy import ArtifactStore

        got = {}
        for key, flight, store in (("t", obs_flight, ArtifactStore),
                                   ("j", JO.flight, JStore)):
            root, model, _ = artifacts[key]
            plan = model.serving_plan(min_bucket=8, max_bucket=32)
            evs, res = _recorded(flight, "artifact_hydrated",
                                 lambda: store(root).hydrate(plan, tenant="a"))
            assert res["hydrated"] == [8, 16, 32], res
            plan.release_executables()
            got[key] = evs
        assert self._keys(got["t"]) == self._keys(got["j"])
        assert got["t"][0]["data"]["live_compile_buckets"] == \
            got["j"][0]["data"]["live_compile_buckets"] == []

    def test_miss_keys(self, artifacts):
        from transmogrifai_tpu.deploy import ArtifactStore as JStore
        from transmogrifai_tpu.perf.kernels.dispatch import force_kernel_mode
        from transmogrifai_tpu_torch.deploy import ArtifactStore
        from transmogrifai_tpu_torch.perf.kernels.dispatch import force_serve_donation

        got = {}
        for key, flight, store, drift in (
                ("t", obs_flight, ArtifactStore, lambda: force_serve_donation(True)),
                ("j", JO.flight, JStore, lambda: force_kernel_mode("interpret"))):
            root, model, _ = artifacts[key]
            with drift():
                plan = model.serving_plan(min_bucket=8, max_bucket=32)
                evs, res = _recorded(flight, "artifact_miss",
                                     lambda: store(root).hydrate(plan, tenant="a"))
            assert res["hydrated"] == [] and not res["refused"], res
            got[key] = evs
        assert self._keys(got["t"]) == self._keys(got["j"])

    def test_refused_keys(self, artifacts, tmp_path):
        from transmogrifai_tpu.deploy import ArtifactStore as JStore
        from transmogrifai_tpu_torch.deploy import ArtifactStore

        got = {}
        for key, flight, store in (("t", obs_flight, ArtifactStore),
                                   ("j", JO.flight, JStore)):
            _, model, _ = artifacts[key]
            plan = model.serving_plan(min_bucket=8, max_bucket=32)
            evs, res = _recorded(flight, "artifact_refused", lambda: store(
                str(tmp_path / "absent")).hydrate(plan, tenant="a"))
            assert res["refused"], res
            got[key] = evs
        assert self._keys(got["t"]) == self._keys(got["j"])
        assert got["t"][0]["data"]["code"] == got["j"][0]["data"]["code"] == "TM510"


# ---------------------------------------------------------------------------
# statusz: the JSON status line
# ---------------------------------------------------------------------------

class TestStatusz:
    def test_fleet_statusz_rps_and_json_stable(self, two_models):
        from transmogrifai_tpu_torch.obs.metrics import assert_json_stable

        (model_a, recs_a), _ = two_models
        with FleetServer(max_batch=16, max_wait_ms=2) as fleet:
            fleet.arm_slo_monitor()
            fleet.register("a", model_a, slo="gold")
            first = fleet.statusz()  # rps baseline
            assert first["tenants"]["a"]["rps"] is None
            futs = [fleet.submit("a", r) for r in recs_a[:30]]
            for f in futs:
                f.result(timeout=30)
            time.sleep(0.01)
            status = fleet.statusz()
        row = status["tenants"]["a"]
        assert row["rps"] is not None and row["rps"] > 0
        assert row["completed"] == 30
        assert row["breaker"] == "closed"
        assert row["warm_buckets"] > 0
        assert row["budget_remaining"] == 1.0  # clean traffic, full budget
        assert status["fleet"]["slo_monitor_armed"] is True
        assert_json_stable(status)  # the statusz JSONL line contract


# ---------------------------------------------------------------------------
# Parity with the JAX package on the same call sequences
# ---------------------------------------------------------------------------

def _label_sets(snapshot):
    """{metric name: sorted label-name tuples} of a registry snapshot."""
    out = {}
    for key in snapshot:
        name, _, rest = key.partition("{")
        labels = tuple(sorted(re.findall(r'(\w+)="', rest)))
        out.setdefault(name, set()).add(labels)
    return {k: sorted(v) for k, v in out.items()}


class TestParity:
    @pytest.fixture(scope="class")
    def replays(self, two_models, two_jax_models, tmp_path_factory):
        out = {}
        for key, fleet_cls, tel_cls, models in (
                ("t", FleetServer, Telemetry, two_models),
                ("j", JS.FleetServer, JO.Telemetry, two_jax_models)):
            tmp = tmp_path_factory.mktemp(f"parity_{key}")
            with use_device("cpu"):
                out[key] = _replay(fleet_cls, tel_cls, models, tmp / "tel",
                                   tmp / "statusz.jsonl")
        return out

    def test_served_rows_equal_the_reference(self, replays):
        """The replay's rows equal the JAX package's (the same tenants'
        models, trained by each package from the same records, within the
        LR fits' 1e-6)."""
        (_, trows), (_, jrows) = replays["t"], replays["j"]
        assert len(trows) == len(jrows) == 48

        def uidless(row):  # result names carry each process's stage uids
            return {re.sub(r"_[0-9a-f]{12}", "", k): v for k, v in row.items()}

        for t, j in zip(map(uidless, trows), map(uidless, jrows)):
            assert set(t) == set(j)
            for k in t:
                tp, jp = t[k], j[k]
                assert set(tp) == set(jp)
                np.testing.assert_allclose(
                    [tp[n] for n in sorted(tp)], [jp[n] for n in sorted(jp)],
                    rtol=0, atol=1e-6)

    def test_reconstructed_chains_have_the_reference_phases(self, replays):
        chains = {}
        for key, rec in (("t", reconstruct_request),
                         ("j", JO.reconstruct_request)):
            trace, _ = replays[key]
            reqs = request_events(trace)
            chains[key] = [rec(trace, rid) for rid in sorted(reqs)]
        assert len(chains["t"]) == len(chains["j"]) == 48
        for t, j in zip(chains["t"], chains["j"]):
            assert sorted(t["phases"]) == sorted(j["phases"]) \
                == ["device", "encode", "host"]
            assert (t["tenant"], t["outcome"]) == (j["tenant"], j["outcome"])
            assert sorted(t["phases"]["device"]) == sorted(j["phases"]["device"])

    def test_canonical_metric_names_and_label_sets_equal_the_reference(
            self, two_models, two_jax_models):
        snaps = {}
        for key, fleet_cls, models in (("t", FleetServer, two_models),
                                       ("j", JS.FleetServer, two_jax_models)):
            (model_a, recs_a), (model_b, recs_b) = models
            with fleet_cls(max_batch=32, max_wait_ms=5) as fleet:
                fleet.register("a", model_a, slo="gold")
                fleet.register("b", model_b, slo="bronze")
                futs = [fleet.submit("a", r) for r in recs_a[:20]] \
                    + [fleet.submit("b", r) for r in recs_b[:20]]
                for f in futs:
                    f.result(timeout=30)
                snaps[key] = fleet.registry.snapshot()
                total = fleet.batcher.metrics()["device_seconds"]
                per = fleet.batcher.tenant_metrics()
            # per-tenant device seconds sum to the batch total in each
            assert total > 0
            assert sum(r["device_seconds"] for r in per.values()) \
                == pytest.approx(total, rel=1e-6)
        assert _label_sets(snaps["t"]) == _label_sets(snaps["j"])
        assert 'tmog_serve_batcher_device_seconds_total{tenant="a"}' in snaps["t"]
        assert "tmog_serve_batcher_padding_rows_total" in snaps["t"]
