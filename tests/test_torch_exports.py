"""The port's public surface against the JAX package's: the top-level and
``serve`` ``__all__`` lists, the names the reference exports by star
import, and ``WorkflowModel.score_function``.

Runs on the CPU; the serving_wide fixture is the JAX package's saved model.
"""

import json

import numpy as np
import pytest

import transmogrifai_tpu as J
import transmogrifai_tpu.serve as JS
import transmogrifai_tpu_torch as T
import transmogrifai_tpu_torch.serve as TS
from transmogrifai_tpu_torch.local import score_function

from test_torch_serving import FIXTURE, _records


class TestAllLists:
    def test_package_all_equals_the_reference(self):
        assert T.__all__ == J.__all__
        for name in T.__all__:
            assert hasattr(T, name), name

    def test_serve_all_equals_the_reference(self):
        assert TS.__all__ == JS.__all__
        for name in TS.__all__:
            assert hasattr(TS, name), name

    def test_feature_types_import_from_the_top(self):
        from transmogrifai_tpu_torch import FeatureHistory, Real, TextMap  # noqa: F401

        ref_types = {n for n in dir(J) if isinstance(getattr(J, n), type)
                     and issubclass(getattr(J, n), J.types.FeatureType)}
        got_types = {n for n in dir(T) if isinstance(getattr(T, n), type)
                     and issubclass(getattr(T, n), T.types.FeatureType)}
        assert got_types == ref_types and len(got_types) > 40

    @pytest.mark.parametrize("sub", ["deploy", "perf"])
    def test_subpackage_all_equals_the_reference_names(self, sub):
        """The reference's ``deploy`` and ``perf`` define no ``__all__``;
        the port's lists exactly the public names they export."""
        import importlib
        import inspect

        ref = importlib.import_module(f"transmogrifai_tpu.{sub}")
        got = importlib.import_module(f"transmogrifai_tpu_torch.{sub}")
        public = sorted(n for n in dir(ref) if not n.startswith("_")
                        and not inspect.ismodule(getattr(ref, n)))
        assert sorted(got.__all__) == public
        for name in got.__all__:
            assert hasattr(got, name), name

    def test_fleet_stays_in_serve(self):
        assert not hasattr(J, "FleetServer") and not hasattr(T, "FleetServer")
        from transmogrifai_tpu_torch.serve import FleetServer, Precision  # noqa: F401


class TestScoreFunction:
    def test_method_equals_the_local_function(self):
        model = T.WorkflowModel.load(FIXTURE)
        with open(f"{FIXTURE}/schema.json") as fh:
            schema = json.load(fh)
        recs = _records(schema["features"], 24, 5)
        by_method = model.score_function(device="cpu")
        by_function = score_function(model, device="cpu")
        assert by_method.batch(recs) == by_function.batch(recs)
        assert by_method(recs[0]) == by_function(recs[0])
        want = model.serving_plan(device="cpu").score(recs)
        got = by_method.batch(recs)
        key = next(iter(want[0]))
        assert max(abs(a[key]["probability_1"] - b[key]["probability_1"])
                   for a, b in zip(want, got)) < 1e-12
        with pytest.raises(TypeError):
            model.score_function("cpu")

    def test_unported_arguments_still_raise_by_name(self):
        """``strict`` is ported: it validates first (this clean model's DAG
        passes and the fit reaches its data); ``hbm_budget`` and
        ``host_budget`` are ported and reach the data as in the JAX package
        (here: no input data, the reference's ValueError); ``artifact`` is
        ported: an unreadable artifact is refused with TM510 and the tenant
        warms and serves live."""
        model = T.WorkflowModel.load(FIXTURE)
        wf = T.Workflow().set_result_features(*model.result_features)
        with pytest.raises(ValueError, match="No input data"):
            wf.train(0.0, 42, None, True, device="cpu")
        for args in ((0.0, 42, None, False, 1e9), (0.0, 42, None, False, None, 1e9)):
            with pytest.raises(ValueError, match="No input data"):
                wf.train(*args, device="cpu")
        from transmogrifai_tpu_torch.obs import flight as obs_flight
        from transmogrifai_tpu_torch.serve import ModelRegistry

        reg = ModelRegistry(device="cpu")
        rec = obs_flight.install_recorder(obs_flight.FlightRecorder())
        try:
            reg.register("t", model, artifact="/nowhere")
        finally:
            obs_flight.uninstall_recorder()
        (ev,) = rec.events("artifact_refused")
        assert ev["data"]["code"] == "TM510" and ev["data"]["tenant"] == "t"
        assert any("manifest unreadable" in r for r in ev["data"]["reasons"])
        np.testing.assert_equal(reg.tenants(), ["t"])
        plan = reg.get("t").swapper.active.plan
        assert plan.warm_buckets() == plan.bucket_ladder()
        with open(f"{FIXTURE}/schema.json") as fh:
            recs = _records(json.load(fh)["features"], 16, 3)
        assert plan.score(recs) == model.serving_plan(device="cpu").score(recs)
