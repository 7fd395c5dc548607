"""The port's SLO error-budget / burn-rate monitor (``obs/slo.py``) on the
CPU, held against the JAX package's.

The port's counterpart of the reference's ``tests/test_slo.py`` (its 8
tests, each under its name), with that file's model (seed 11) trained by
the JAX package and loaded into the port.  The reference's flight-recorder
events (``slo_burn``, ``slo_escalation``) and its per-tenant device-time
accounting (request traces) are not ported; the rest of each test is.
Then the parity: the same counter histories, polled at the same injected
``now=`` times, give both packages' monitors equal statuses, findings and
escalation calls.
"""

import time

import pytest

from transmogrifai_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from transmogrifai_tpu.obs.slo import SloBudget as JSloBudget
from transmogrifai_tpu.obs.slo import SloMonitor as JSloMonitor
from transmogrifai_tpu_torch.obs import SloBudget, SloMonitor
from transmogrifai_tpu_torch.obs.metrics import MetricsRegistry
from transmogrifai_tpu_torch.serve import FleetServer, LoadShedError, ScoringServer

import torch_fleet_data as FD
from test_slo import _train

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def fleet_model(tmp_path_factory):
    jm, records = _train(11)
    return FD.port_copy(jm, str(tmp_path_factory.mktemp("slo") / "m")), records


class _Counters:
    """Hand-drivable per-tenant good/bad series in a real registry (either
    package's)."""

    def __init__(self, tenant="t", registry_cls=MetricsRegistry):
        self.registry = registry_cls()
        labels = {"tenant": tenant}
        self.completed = self.registry.counter(
            "tmog_serve_batcher_completed_total", labels=labels)
        self.shed = self.registry.counter(
            "tmog_serve_batcher_shed_total", labels=labels)
        self.deadline = self.registry.counter(
            "tmog_serve_batcher_deadline_expired_total", labels=labels)
        self.failed = self.registry.counter(
            "tmog_serve_batcher_failed_total", labels=labels)


class TestSloMonitorUnit:
    BUDGET = SloBudget(target=0.9, window_s=600.0, fast_burn=5.0,
                       slow_burn=3.0, short_window_s=10.0, long_window_s=60.0)

    def test_burn_fires_before_budget_exhausts(self):
        c = _Counters()
        clock = [0.0]
        mon = SloMonitor(c.registry, {"t": "svc"}, budgets={"svc": self.BUDGET},
                         clock=lambda: clock[0])
        mon.poll()
        clock[0] = 5.0
        c.completed.inc(1000)
        st = mon.poll()["t"]
        assert st["budget_remaining"] == 1.0 and st["firing"] == []
        assert mon.diagnostics() == []
        clock[0] = 20.0
        c.shed.inc(30)
        st = mon.poll()["t"]
        assert "fast" in st["firing"]
        assert 0.0 < st["budget_remaining"] < 1.0
        codes = [d.code for d in mon.diagnostics()]
        assert "TM902" in codes and "TM903" not in codes

    def test_firing_is_edge_triggered_with_hysteresis(self):
        c = _Counters()
        clock = [0.0]
        mon = SloMonitor(c.registry, {"t": "svc"}, budgets={"svc": self.BUDGET},
                         clock=lambda: clock[0])
        mon.poll()
        clock[0] = 5.0
        c.completed.inc(1000)
        mon.poll()
        clock[0] = 20.0
        c.shed.inc(30)
        mon.poll()
        n_fired = len(mon.diagnostics())
        assert n_fired > 0
        clock[0] = 22.0
        c.shed.inc(5)
        mon.poll()
        assert len(mon.diagnostics()) == n_fired
        clock[0] = 120.0
        c.completed.inc(5000)
        mon.poll()
        clock[0] = 130.0
        c.shed.inc(600)
        mon.poll()
        assert len(mon.diagnostics()) > n_fired

    def test_exhaustion_escalates_and_recovery_disarms(self):
        c = _Counters()
        clock = [0.0]
        escalations = []
        mon = SloMonitor(c.registry, {"t": "svc"}, budgets={"svc": self.BUDGET},
                         clock=lambda: clock[0],
                         escalate=lambda t, d: escalations.append((t, d)))
        mon.poll()
        clock[0] = 5.0
        c.completed.inc(100)
        mon.poll()
        clock[0] = 10.0
        c.shed.inc(50)
        st = mon.poll()["t"]
        assert st["budget_remaining"] <= 0.0
        assert st["escalated"] is True
        assert escalations == [("t", True)]
        assert "TM903" in [d.code for d in mon.diagnostics()]
        clock[0] = 60.0
        c.completed.inc(50_000)
        st = mon.poll()["t"]
        assert st["escalated"] is False
        assert escalations == [("t", True), ("t", False)]
        assert {d.code for d in mon.diagnostics()} == {"TM902", "TM903"}

    def test_rearm_disarms_previous_monitors_escalations(self, fleet_model):
        model, _records = fleet_model
        with FleetServer(max_batch=8, max_wait_ms=1, **CPU) as fleet:
            fleet.register("t", model, slo="bronze")
            mon1 = fleet.arm_slo_monitor()
            mon1._escalated.add("t")
            fleet.batcher.set_degraded("t", True)
            fleet.arm_slo_monitor()
            assert "t" not in fleet.batcher._degraded

    def test_no_traffic_no_findings(self):
        c = _Counters()
        mon = SloMonitor(c.registry, {"t": "svc"}, budgets={"svc": self.BUDGET},
                         clock=lambda: 0.0)
        for _ in range(5):
            st = mon.poll()["t"]
        assert st["budget_remaining"] == 1.0
        assert st["firing"] == [] and mon.diagnostics() == []

    def test_budget_validation(self):
        with pytest.raises(ValueError, match="target"):
            SloBudget(target=1.5)
        with pytest.raises(ValueError, match="windows"):
            SloBudget(window_s=-1)

    def test_trainer_polls_monitor(self, fleet_model):
        from transmogrifai_tpu_torch.readers.base import rows_to_dataset
        from transmogrifai_tpu_torch.workflow.continual import ContinualTrainer

        model, records = fleet_model

        class _OneBatchReader:
            last_records = records[:8]

            def stream_datasets(self, raws):
                yield rows_to_dataset(self.last_records, list(raws),
                                      allow_missing_response=True)

        polls = []

        class _SpyMonitor:
            def poll(self):
                polls.append(1)
                return {}

            def diagnostics(self):
                return []

            def status(self):
                return {"spied": True}

        with ScoringServer(model, max_batch=8, max_wait_ms=1, **CPU) as server:
            trainer = ContinualTrainer(server, model, _OneBatchReader(),
                                       refit_enabled=False, slo_monitor=_SpyMonitor())
            metrics = trainer.run(max_batches=1)
        assert polls == [1]
        assert metrics["slo"] == {"spied": True}


class TestBurnRateE2E:
    def test_overload_burn_exhaustion_and_cost_accounting(self, fleet_model):
        model, records = fleet_model
        budgets = {
            "gold": SloBudget(),
            "bronze": SloBudget(target=0.5, window_s=3600.0, fast_burn=1.5,
                                slow_burn=5.0, short_window_s=0.2, long_window_s=60.0),
        }
        with FleetServer(max_batch=4096, max_wait_ms=250.0, max_queue=32, **CPU) as fleet:
            monitor = fleet.arm_slo_monitor(budgets=budgets)
            fleet.register("og", model, slo="gold")
            fleet.register("ob", model, slo="bronze")
            monitor.poll()
            futs = [fleet.submit("ob", records[i % len(records)]) for i in range(30)]
            for f in futs:
                f.result(timeout=60)
            monitor.poll()
            time.sleep(0.25)
            bronze = [fleet.submit("ob", records[i % len(records)]) for i in range(32)]
            gold = [fleet.submit("og", records[i % len(records)]) for i in range(24)]
            st = monitor.poll()["ob"]
            shed_now = sum(1 for f in bronze
                           if f.done() and isinstance(f.exception(), LoadShedError))
            assert shed_now == 24
            assert "fast" in st["firing"] or "slow" in st["firing"]
            assert st["budget_remaining"] > 0.0, st
            codes = [d.code for d in monitor.diagnostics()]
            assert "TM902" in codes and "TM903" not in codes
            assert monitor.diagnostics()[0].location == "tenant:ob"
            for f in gold:
                f.result(timeout=60)
            for f in bronze:
                if not (f.done() and isinstance(f.exception(), LoadShedError)):
                    f.result(timeout=60)
            bronze2 = [fleet.submit("ob", records[i % len(records)]) for i in range(32)]
            gold2 = [fleet.submit("og", records[i % len(records)]) for i in range(24)]
            st = monitor.poll()["ob"]
            assert st["budget_remaining"] <= 0.0
            assert st["escalated"] is True
            assert "ob" in fleet.batcher._degraded
            assert "TM903" in [d.code for d in monitor.diagnostics()]
            for f in gold2:
                f.result(timeout=60)
            for f in bronze2:
                if not (f.done() and isinstance(f.exception(), LoadShedError)):
                    f.result(timeout=60)
            gold_st = monitor.poll()["og"]
            assert gold_st["firing"] == []
            assert gold_st["budget_remaining"] == 1.0
            # until request traces are ported, each tenant's device seconds
            # are its plan's summed device-prefix time
            status = fleet.statusz()
            assert status["tenants"]["ob"]["escalated"] is True
            assert status["tenants"]["ob"]["budget_remaining"] <= 0.0
            assert status["fleet"]["device_seconds"] == pytest.approx(
                sum(r["device_seconds"] for r in status["tenants"].values()))
            assert status["fleet"]["device_seconds"] > 0


class TestJaxParity:
    @pytest.mark.parametrize("history", ["burn_then_recover", "slow_burn", "two_tenants"])
    def test_findings_equal_the_reference(self, history):
        budgets = {"svc": dict(target=0.9, window_s=600.0, fast_burn=5.0, slow_burn=3.0,
                               short_window_s=10.0, long_window_s=60.0),
                   "gold": dict(target=0.999)}
        steps = {
            "burn_then_recover": [(5.0, "t", 1000, 0), (20.0, "t", 0, 30), (22.0, "t", 0, 5),
                                  (40.0, "t", 0, 400), (120.0, "t", 5000, 0),
                                  (130.0, "t", 0, 600), (900.0, "t", 90_000, 0)],
            "slow_burn": [(t, "t", 100, 14) for t in range(5, 300, 5)],
            "two_tenants": [(5.0, "t", 100, 0), (5.0, "u", 1000, 0), (9.0, "u", 0, 3),
                            (12.0, "t", 0, 40), (70.0, "u", 0, 1), (400.0, "t", 9000, 0)],
        }[history]
        tenants = {"t": "svc", "u": "gold"}

        def run(registry_cls, budget_cls, monitor_cls):
            counters = {t: _Counters(t, registry_cls) for t in tenants}
            reg = registry_cls()
            for t, c in counters.items():
                reg._metrics.update(c.registry._metrics)
            calls = []
            mon = monitor_cls(reg, tenants, clock=lambda: 0.0,
                              budgets={k: budget_cls(**v) for k, v in budgets.items()},
                              escalate=lambda t, d: calls.append((t, d)))
            statuses = [mon.poll(now=0.0)]
            for now, t, good, bad in steps:
                counters[t].completed.inc(good)
                counters[t].shed.inc(bad)
                statuses.append(mon.poll(now=now))
            return statuses, [(d.code, d.message, d.location) for d in mon.diagnostics()], calls

        want = run(JMetricsRegistry, JSloBudget, JSloMonitor)
        got = run(MetricsRegistry, SloBudget, SloMonitor)
        assert got == want
        assert want[1]   # every history fires something
