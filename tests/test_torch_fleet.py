"""The port's multi-tenant serving fleet (``serve/registry.py``) on the CPU,
held against the JAX package's ``FleetServer``.

The port's counterpart of the reference's ``tests/test_fleet.py`` (its 15
tests, each under its name), with the models of its recipe (seeds 7, 99,
123) trained by the JAX package and loaded into the port.  Then the
parity: one sequence of register/submit/stage/promote/rollback/unregister
calls fed to both packages' fleets (``torch_fleet_data.fleet_sequence``)
gives the same admissions, LRU evictions, refusal codes (TM507, TM509,
TM511, TM601), fleet metric series and, for f32 tenants, bitwise-equal
records.  Budgets are multiples of each package's own static peak
estimate.  The reference's flight-recorder attribution is not ported
(its test here checks the attribution the port records).
"""

import inspect
import threading
import time

import pytest

import transmogrifai_tpu.serve as JS
import transmogrifai_tpu_torch.serve as TS
from transmogrifai_tpu_torch.checkers.diagnostics import OpCheckError
from transmogrifai_tpu_torch.serve import (
    DEFAULT_SLO_CLASSES,
    FaultHarness,
    FleetServer,
    LoadShedError,
    ModelRegistry,
    PoisonRecordError,
    TransientScoringError,
    UnknownTenantError,
)

import torch_fleet_data as FD
from test_fleet import _train

MIN_BUCKET, MAX_BUCKET = FD.MIN_BUCKET, FD.MAX_BUCKET
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """{name: (jax model, port model, records)} for A, B, C (the reference's
    fleet recipe) and P (its precision recipe)."""
    root = tmp_path_factory.mktemp("fleet_models")
    out = {}
    for name, seed in (("A", 7), ("B", 99), ("C", 123)):
        jm, recs = _train(seed)
        out[name] = (jm, FD.port_copy(jm, str(root / name)), recs)
    jm, recs = FD.train_precision_model()
    out["P"] = (jm, FD.port_copy(jm, str(root / "P")), recs)
    return out


@pytest.fixture(scope="module")
def fleet_models(both):
    """The port's models with their records and solo CPU plans, as the
    reference's fixture of the same name."""
    out = {}
    for name in ("A", "B", "C"):
        _, tm, recs = both[name]
        out[name] = (tm, recs, tm.serving_plan(MIN_BUCKET, MAX_BUCKET, **CPU))
    assert len({out[k][2].fingerprint for k in out}) == 3
    return out


@pytest.fixture(scope="module")
def sequences(both):
    jax_models = {k: (v[0], v[2]) for k, v in both.items()}
    port_models = {k: (v[1], v[2]) for k, v in both.items()}
    return FD.fleet_sequence(JS, jax_models), FD.fleet_sequence(TS, port_models, **CPU)


def _peak(plan):
    return FD.peak(plan)


class TestRegistryLifecycle:
    def test_register_routes_and_per_tenant_metrics(self, fleet_models):
        model_a, recs_a, plan_a = fleet_models["A"]
        model_b, recs_b, plan_b = fleet_models["B"]
        with FleetServer(max_batch=32, max_wait_ms=2, min_bucket=MIN_BUCKET,
                         max_bucket=MAX_BUCKET, **CPU) as fleet:
            fleet.register("a", model_a, slo="gold")
            fleet.register("b", model_b, slo="bronze")
            assert fleet.tenants() == ["a", "b"]
            futs = [fleet.submit("a", r) for r in recs_a[:12]] + \
                   [fleet.submit("b", r) for r in recs_b[:12]]
            out = [f.result(timeout=30) for f in futs]
            m = fleet.metrics()
        assert out[:12] == plan_a.score(recs_a[:12])
        assert out[12:] == plan_b.score(recs_b[:12])
        assert m["tenants"]["a"]["scored_records"] == 12
        assert m["tenants"]["b"]["scored_records"] == 12
        assert m["tenants"]["a"]["slo"] == "gold"
        assert m["tenants"]["a"]["latency_p99_ms"] is not None
        assert m["fleet"]["tenants"] == 2

    def test_duplicate_and_unknown_tenant(self, fleet_models):
        model_a, recs_a, _ = fleet_models["A"]
        with FleetServer(max_batch=8, max_wait_ms=1, **CPU) as fleet:
            fleet.register("a", model_a, warm=False)
            with pytest.raises(ValueError, match="already registered"):
                fleet.register("a", model_a)
            with pytest.raises(UnknownTenantError):
                fleet.submit("nope", recs_a[0])
            with pytest.raises(ValueError, match="unknown SLO"):
                fleet.register("b", model_a, slo="platinum")

    def test_shared_fingerprint_pair_compiles_once(self, fleet_models):
        """The second tenant of a shared fingerprint warms its whole ladder
        on the first tenant's staging buffers: it builds none."""
        model_a, recs_a, plan_a = fleet_models["A"]
        with FleetServer(max_batch=32, max_wait_ms=2, min_bucket=MIN_BUCKET,
                         max_bucket=MAX_BUCKET, **CPU) as fleet:
            fleet.register("alpha", model_a, slo="gold")
            fleet.register("beta", model_a, slo="silver")
            m = fleet.metrics()
            assert m["tenants"]["beta"]["plan"]["staging_builds"] == 0
            assert m["fleet"]["shared_prefix_registrations"] == 1
            assert m["tenants"]["beta"]["warm_buckets"] == \
                m["tenants"]["alpha"]["warm_buckets"]
            assert fleet.score("beta", recs_a[0], timeout=30) == \
                plan_a.score([recs_a[0]])[0]

    def test_unregister_prunes_labeled_series(self, fleet_models):
        model_a, recs_a, _ = fleet_models["A"]
        with FleetServer(max_batch=8, max_wait_ms=1, **CPU) as fleet:
            fleet.register("gone", model_a, warm=False)
            fleet.score("gone", recs_a[0], timeout=30)
            assert "gone" in fleet.registry.labeled_values("tenant")
            fleet.unregister("gone")
            assert "gone" not in fleet.registry.labeled_values("tenant")
            assert not [v for v in fleet.registry.labeled_values("entry")
                        if v.startswith("gone/")]
            with pytest.raises(UnknownTenantError):
                fleet.submit("gone", recs_a[0])

    def test_per_tenant_blue_green_swap_and_rollback(self, fleet_models):
        model_a, recs_a, plan_a = fleet_models["A"]
        model_b, recs_b, plan_b = fleet_models["B"]
        with FleetServer(max_batch=16, max_wait_ms=1, min_bucket=MIN_BUCKET,
                         max_bucket=MAX_BUCKET, **CPU) as fleet:
            fleet.register("a", model_a, slo="gold")
            fleet.register("b", model_b, slo="silver")
            fp = fleet.stage_candidate("a", model_a, warm=False)
            assert fp == plan_a.fingerprint
            fleet.score("a", recs_a[0], timeout=30)  # mirrors to candidate
            rec = fleet.promote("a", probation_batches=2)
            assert rec["shared_prefix"] is True and rec["tenant"] == "a"
            rb = fleet.rollback("a")
            assert rb["tenant"] == "a"
            m = fleet.metrics()
            assert m["tenants"]["a"]["swap"]["swaps"] == 1
            assert m["tenants"]["a"]["swap"]["rollbacks"] == 1
            assert m["tenants"]["b"]["swap"]["swaps"] == 0
            assert fleet.score("b", recs_b[0], timeout=30) == \
                plan_b.score([recs_b[0]])[0]


class TestHbmAdmission:
    def test_eviction_lru_then_typed_refusal(self, fleet_models):
        model_a, recs_a, plan_a = fleet_models["A"]
        model_b, recs_b, plan_b = fleet_models["B"]
        model_c, recs_c, plan_c = fleet_models["C"]
        pa, pb = _peak(plan_a), _peak(plan_b)
        with FleetServer(max_batch=32, max_wait_ms=2, min_bucket=MIN_BUCKET,
                         max_bucket=MAX_BUCKET, hbm_budget=pa + pb, **CPU) as fleet:
            fleet.register("a", model_a, slo="gold")
            fleet.register("b", model_b, slo="bronze")
            [f.result(30) for f in [fleet.submit("b", r) for r in recs_b[:8]]]
            [f.result(30) for f in [fleet.submit("a", r) for r in recs_a[:8]]]
            fleet.register("c", model_c, slo="silver")
            m = fleet.metrics()
            assert m["fleet"]["evictions"] == 1
            assert m["tenants"]["b"]["warm_buckets"] == []       # evicted
            assert m["tenants"]["a"]["warm_buckets"]             # spared
            assert m["tenants"]["c"]["warm_buckets"]             # admitted
            before = m["tenants"]["b"]["plan"]["compile_count"]
            # the cold tenant still serves: its bucket is built again
            assert fleet.score("b", recs_b[0], timeout=30) == \
                plan_b.score([recs_b[0]])[0]
            assert fleet.metrics()["tenants"]["b"]["plan"]["compile_count"] > before

        fleet2 = FleetServer(max_batch=16, max_wait_ms=1, hbm_budget=16.0, **CPU)
        try:
            with pytest.raises(OpCheckError, match="TM509") as ei:
                fleet2.register("tiny", model_a)
            assert [d.code for d in ei.value.report.errors()] == ["TM509"]
            assert fleet2.metrics()["fleet"]["admission_refusals"] == 1
            assert fleet2.tenants() == []
        finally:
            fleet2.close()

    def test_eviction_spares_shared_fingerprints(self, fleet_models):
        model_a, recs_a, plan_a = fleet_models["A"]
        model_b, recs_b, plan_b = fleet_models["B"]
        model_c, _, plan_c = fleet_models["C"]
        pa, pb = _peak(plan_a), _peak(plan_b)
        with FleetServer(max_batch=32, max_wait_ms=2, min_bucket=MIN_BUCKET,
                         max_bucket=MAX_BUCKET, hbm_budget=pa + pb, **CPU) as fleet:
            fleet.register("a1", model_a, slo="gold")
            fleet.register("a2", model_a, slo="silver")  # shared fingerprint
            fleet.register("b", model_b, slo="bronze")
            [f.result(30) for f in [fleet.submit("a2", r) for r in recs_a[:4]]]
            [f.result(30) for f in [fleet.submit("b", r) for r in recs_b[:4]]]
            [f.result(30) for f in [fleet.submit("a1", r) for r in recs_a[:4]]]
            fleet.register("c", model_c, slo="silver")
            m = fleet.metrics()
            assert m["fleet"]["evictions"] == 1
            assert m["tenants"]["b"]["warm_buckets"] == []
            assert m["tenants"]["a1"]["warm_buckets"]
            assert m["tenants"]["a2"]["warm_buckets"]
            counts = {t: m["tenants"][t]["plan"]["compile_count"] for t in ("a1", "a2")}
            out = fleet.score("a1", recs_a[0], timeout=30)
            out2 = fleet.score("a2", recs_a[0], timeout=30)
            m = fleet.metrics()
            assert {t: m["tenants"][t]["plan"]["compile_count"] for t in counts} == counts
            assert out == out2 == plan_a.score([recs_a[0]])[0]


class TestTenantIsolationUnderFaults:
    def test_poison_trip_and_rollback_leave_other_tenant_bitwise(
            self, fleet_models):
        """Tenant A's poison records, breaker trip and forced rollback leave
        the bystander's records bitwise unchanged (a CPU plan's breaker
        serves the victim from its host path)."""
        model_a, recs_a, plan_a = fleet_models["A"]
        solo = plan_a.score(recs_a[:24])
        with FleetServer(max_batch=16, max_wait_ms=2, min_bucket=MIN_BUCKET,
                         max_bucket=MAX_BUCKET,
                         resilience={"max_retries": 0, "failure_threshold": 1,
                                     "recovery_batches": 1000, "seed": 0},
                         **CPU) as fleet:
            fleet.register("victim", model_a, slo="gold")
            fleet.register("bystander", model_a, slo="silver")
            marked = [dict(r, __victim__=1) for r in recs_a]
            harness = FaultHarness(seed=0).fail_when(
                "device",
                lambda ctx: any("__victim__" in r for r in ctx.get("records", ())),
                lambda: TransientScoringError("RESOURCE_EXHAUSTED"))
            with harness:
                vfuts = [fleet.submit("victim", r) for r in marked[:16]]
                bfuts = [fleet.submit("bystander", r) for r in recs_a[:24]]
                poison = fleet.submit("victim", {"x1": "not-a-number", "color": "red"})
                bout = [f.result(timeout=60) for f in bfuts]
                vout = [f.result(timeout=60) for f in vfuts]
                with pytest.raises(PoisonRecordError):
                    poison.result(timeout=60)
                fleet.stage_candidate("victim", model_a, warm=False)
                fleet.promote("victim", probation_batches=0)
                fleet.rollback("victim")
                bout2 = [f.result(timeout=60) for f in
                         [fleet.submit("bystander", r) for r in recs_a[:24]]]
            m = fleet.metrics()
        assert m["tenants"]["victim"]["resilience"]["breaker"]["state"] == "open"
        assert m["tenants"]["victim"]["resilience"]["fallback_records"] >= 16
        assert m["tenants"]["victim"]["resilience"]["quarantined"] == 1
        assert vout == plan_a.score_host(marked[:16])
        assert bout == solo and bout2 == solo
        by = m["tenants"]["bystander"]
        assert by["resilience"]["breaker"]["state"] == "closed"
        assert by["resilience"]["quarantined"] == 0
        assert by["resilience"]["fallback_records"] == 0
        assert by["latency_p99_ms"] is not None and by["latency_p99_ms"] < 10_000
        assert by["plan"]["staging_builds"] == 0   # shared with the victim

    def test_route_fault_fails_only_its_tenant(self, fleet_models):
        model_a, recs_a, plan_a = fleet_models["A"]
        with FleetServer(max_batch=32, max_wait_ms=50, min_bucket=MIN_BUCKET,
                         max_bucket=MAX_BUCKET, **CPU) as fleet:
            fleet.register("a", model_a, slo="gold")
            fleet.register("b", model_a, slo="silver")
            harness = FaultHarness(seed=1).fail_when(
                "route", lambda ctx: ctx.get("tenant") == "a",
                lambda: RuntimeError("routing blackout"), times=1)
            with harness:
                afuts = [fleet.submit("a", r) for r in recs_a[:4]]
                bfuts = [fleet.submit("b", r) for r in recs_a[:4]]
                bout = [f.result(timeout=30) for f in bfuts]
                aerrs = [f.exception(timeout=30) for f in afuts]
        assert bout == plan_a.score(recs_a[:4])
        assert all(isinstance(e, RuntimeError) for e in aerrs)
        assert harness.calls["route"] >= 1


class TestOverloadEndToEnd:
    def test_overload_with_tripped_breaker_and_eviction(self, fleet_models):
        model_a, recs_a, plan_a = fleet_models["A"]
        model_b, recs_b, plan_b = fleet_models["B"]
        model_c, recs_c, plan_c = fleet_models["C"]
        pa, pb = _peak(plan_a), _peak(plan_b)
        fleet = FleetServer(max_batch=4096, max_wait_ms=300.0, max_queue=32,
                            min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET,
                            hbm_budget=pa + pb,
                            resilience={"max_retries": 0, "failure_threshold": 1,
                                        "recovery_batches": 1000, "seed": 2},
                            **CPU)
        try:
            fleet.register("gold_t", model_a, slo="gold")
            fleet.register("bronze_t", model_b, slo="bronze")
            [f.result(30) for f in [fleet.submit("bronze_t", r) for r in recs_b[:8]]]
            [f.result(30) for f in [fleet.submit("gold_t", r) for r in recs_a[:8]]]
            fleet.register("silver_t", model_c, slo="silver")
            assert fleet.metrics()["fleet"]["evictions"] >= 1
            marked_b = [dict(r, __bad__=1) for r in recs_b]
            harness = FaultHarness(seed=2).fail_when(
                "device",
                lambda ctx: any("__bad__" in r for r in ctx.get("records", ())),
                lambda: TransientScoringError("RESOURCE_EXHAUSTED"))
            with harness:
                trip = [fleet.submit("bronze_t", r) for r in marked_b[:8]]
                tout = [f.result(timeout=60) for f in trip]
                assert tout == plan_b.score_host(marked_b[:8])
                m = fleet.metrics()
                assert m["tenants"]["bronze_t"]["resilience"]["breaker"]["state"] == "open"
                time.sleep(0.05)
                flood = [fleet.submit("bronze_t", r) for r in (marked_b * 2)[:32]]
                gold_burst = [fleet.submit("gold_t", r) for r in recs_a[:12]]
                silver_burst = [fleet.submit("silver_t", r) for r in recs_c[:8]]
                gout = [f.result(timeout=60) for f in gold_burst]
                sout = [f.result(timeout=60) for f in silver_burst]
                shed = [f for f in flood
                        if isinstance(f.exception(timeout=60), LoadShedError)]
                m = fleet.metrics()
        finally:
            fleet.close()
        assert len(shed) == 20
        assert m["tenants"]["bronze_t"]["shed"] == 20
        assert m["tenants"]["gold_t"].get("shed", 0) == 0
        assert m["tenants"]["silver_t"].get("shed", 0) == 0
        assert m["batcher"]["rejected"] == 0
        assert gout == plan_a.score(recs_a[:12])
        assert sout == plan_c.score(recs_c[:8])
        assert m["tenants"]["bronze_t"]["resilience"]["fallback_records"] > 0


class TestFlightAttribution:
    def test_quarantine_and_dead_letter_events_carry_tenant(self, fleet_models):
        """The port has no flight recorder yet: the poisoned record reaches
        the tenant's dead-letter hook and its quarantine counter, and the
        rollback record carries the tenant."""
        model_a, _, _ = fleet_models["A"]
        dead = []
        with FleetServer(max_batch=8, max_wait_ms=2, min_bucket=MIN_BUCKET,
                         max_bucket=MAX_BUCKET,
                         resilience={"seed": 0,
                                     "dead_letter": lambda r, e: dead.append(r)},
                         **CPU) as fleet:
            fleet.register("acme", model_a, slo="gold", warm=False)
            f = fleet.submit("acme", {"x1": "not-a-number", "color": "red"})
            with pytest.raises(PoisonRecordError):
                f.result(timeout=30)
            fleet.stage_candidate("acme", model_a, warm=False)
            fleet.promote("acme", probation_batches=0)
            rb = fleet.rollback("acme")
            m = fleet.metrics()
        assert dead == [{"x1": "not-a-number", "color": "red"}]
        assert m["tenants"]["acme"]["resilience"]["quarantined"] == 1
        assert rb["tenant"] == "acme"
        assert "acme/1" in {v for v in fleet.registry.labeled_values("entry")}


class TestSloClasses:
    def test_default_ladder_and_tiered_deadlines(self):
        assert DEFAULT_SLO_CLASSES["gold"].tier \
            > DEFAULT_SLO_CLASSES["silver"].tier \
            > DEFAULT_SLO_CLASSES["bronze"].tier

    def test_slo_deadline_applies(self):
        from transmogrifai_tpu_torch.serve import (DeadlineExceededError,
                                                   MicroBatcher, SloClass)

        gate = threading.Event()

        def scorer(rs):
            gate.wait(5)
            return list(rs)

        classes = {"rt": SloClass("rt", 2, deadline_ms=1.0),
                   "batch": SloClass("batch", 0)}
        mb = MicroBatcher(scorer, max_batch=1, max_wait_ms=1, max_queue=8,
                          slo_classes=classes, pipeline_depth=2)
        try:
            for i in range(3):
                mb.submit({"i": i})
            time.sleep(0.05)
            f = mb.submit({"i": 99}, slo="rt")
            with pytest.raises(DeadlineExceededError):
                f.result(timeout=10)
        finally:
            gate.set()
            mb.shutdown(drain=True, timeout=10)
        assert mb.metrics()["deadline_expired"] == 1

    def test_registry_rejects_unknown_class_at_submit(self, fleet_models):
        model_a, recs_a, _ = fleet_models["A"]
        with FleetServer(max_batch=8, max_wait_ms=1, **CPU) as fleet:
            fleet.register("a", model_a, warm=False)
            with pytest.raises(ValueError, match="unknown SLO"):
                fleet.submit("a", recs_a[0], slo="diamond")


class TestRegistryStandalone:
    def test_model_registry_is_usable_without_a_batcher(self, fleet_models):
        model_a, recs_a, plan_a = fleet_models["A"]
        reg = ModelRegistry(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET, **CPU)
        state = reg.register("solo", model_a, slo="gold")
        assert "solo" in reg and len(reg) == 1
        out = state.swapper.score_isolated(recs_a[:4])
        assert out == plan_a.score(recs_a[:4])
        m = reg.metrics()
        assert m["fleet"]["resident_hbm_bytes"] > 0
        reg.unregister("solo")
        assert len(reg) == 0


class TestJaxParity:
    def test_decisions_equal_the_jax_fleet(self, sequences):
        jax_out, port_out = sequences
        assert port_out["log"] == jax_out["log"]
        kinds = [e[0] for e in port_out["log"]]
        assert kinds == ["after_c", "after_a2", "stage_same_fp", "promote", "rollback",
                         "swap_bf16", "unregister_c", "bf16_admitted", "bf16_tight",
                         "tiny", "plan_budget"]

    def test_records_bitwise_equal_the_jax_fleet(self, sequences):
        jax_out, port_out = sequences
        assert len(port_out["records"]) == len(jax_out["records"]) == 6
        assert port_out["records"] == jax_out["records"]

    def test_fleet_series_equal_after_pruning(self, sequences):
        jax_out, port_out = sequences
        assert port_out["fleet_series"] == jax_out["fleet_series"]

    @pytest.mark.parametrize("name", ["FleetServer", "ModelRegistry"])
    def test_signature_equals_the_reference(self, name):
        ref = inspect.signature(getattr(JS, name)).parameters
        got = inspect.signature(getattr(TS, name)).parameters
        assert [(n, p.kind) for n, p in got.items() if n != "device"] == \
            [(n, p.kind) for n, p in ref.items()]
        assert got["device"].kind is inspect.Parameter.KEYWORD_ONLY
        for method in ("register", "stage_candidate", "submit", "score", "promote",
                       "rollback", "arm_slo_monitor"):
            if hasattr(getattr(JS, name), method):
                assert list(inspect.signature(getattr(getattr(TS, name), method)).parameters) \
                    == list(inspect.signature(getattr(getattr(JS, name), method)).parameters)

    def test_release_frees_buckets_and_the_next_batch_rebuilds(self, fleet_models):
        model_a, recs_a, plan_a = fleet_models["A"]
        reg = ModelRegistry(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET, **CPU)
        plan = reg.register("solo", model_a).swapper.active.plan
        assert plan.warm_buckets() == [8, 16, 32, 64]
        assert plan.release_executables() == 4 and plan.warm_buckets() == []
        before = plan.metrics()["compile_count"]
        assert plan.score(recs_a[:5]) == plan_a.score(recs_a[:5])
        assert plan.warm_buckets() == [8]
        assert plan.metrics()["compile_count"] > before
        reg.unregister("solo")
