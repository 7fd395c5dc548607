"""The port's training path against the JAX package's, end to end on the CPU.

The same seeded data (n=400, d=6, NaNs in one feature) and the same wiring —
``FeatureBuilder`` label + vector, ``label.transform_with(selector, vec)``,
``Workflow().set_input_dataset(ds).set_result_features(label, pred).train()``
— in both packages, with RF (4 trees, depth 2|3) and GBT (4 rounds, eta
0.3|0.1) over 2 folds and the reference's bootstrap draws fed to the port:

- the same winner and grid, every CV metric within 1e-6; the winner's
  train metrics within 1e-6 for a forest and 1e-3 for GBT (GBT scores round
  differently in the last bit — its float histograms and sigmoid — and
  scores tied to within that bit may swap ranks);
- the refit forest's trees bitwise (the GBT refit to 1e-6 in leaf values);
- ``ModelSelector.fit`` called directly gives the same summary;
- a tree winner the JAX package trained and saved loads in the port and
  scores equal to the JAX ``model.score``: bitwise at <=512 rows (both take
  the host path), within 1e-6 above it (both take their device path);
- ``default_models()`` gives the reference's families and grids, in its
  order; ``Workflow.train`` takes the reference's parameters in its order
  (``device`` by keyword only, unported options raise by name), and every
  training entry point raises without a card when no device is named;
- a family whose sweep fails is left out of selection, but a kernel that
  does not build or launch raises out of the fit.
"""

import numpy as np
import pytest
import torch

import jax

from transmogrifai_tpu.data.dataset import Column as JCol
from transmogrifai_tpu.data.dataset import Dataset as JDs
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import trees as JT
from transmogrifai_tpu.models.selector import BinaryClassificationModelSelector as JSel
from transmogrifai_tpu.types import RealNN as JRealNN
from transmogrifai_tpu.workflow.workflow import Workflow as JWorkflow
from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel
from transmogrifai_tpu_torch import BinaryClassificationModelSelector as TSel
from transmogrifai_tpu_torch import FeatureBuilder as TFB
from transmogrifai_tpu_torch import Workflow as TWorkflow
from transmogrifai_tpu_torch import WorkflowModel as TModel
from transmogrifai_tpu_torch.data.dataset import Column as TCol
from transmogrifai_tpu_torch.data.dataset import Dataset as TDs
from transmogrifai_tpu_torch.models import trees as TT
from transmogrifai_tpu_torch.perf.kernels import dispatch as TD
from transmogrifai_tpu_torch.types import RealNN as TRealNN

CPU = torch.device("cpu")
RF_GRIDS = [{"max_depth": 2}, {"max_depth": 3}]
GBT_GRIDS = [{"eta": 0.3}, {"eta": 0.1}]


def _reference_bootstrap(seed, rate, n_trees, n, device):
    draws = jax.random.poisson(jax.random.PRNGKey(int(seed)), float(rate),
                               (int(n_trees), int(n)))
    return torch.from_numpy(np.asarray(draws).astype(np.float32)).to(device)


@pytest.fixture(autouse=True)
def _ref_draws(monkeypatch):
    monkeypatch.setattr(TT, "draw_bootstrap", _reference_bootstrap)


def _data(n=400, d=6, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[::17, 2] = np.nan
    beta = rng.normal(size=d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(np.nan_to_num(x) @ beta)))).astype(np.float64)
    return x, y


def _reference(x, y, families=("rf", "gbt")):
    label = JFB.RealNN("label").extract_field().as_response()
    vec = JFB.OPVector("d").extract_field().as_predictor()
    fams = {"rf": (JT.RandomForestClassifier(num_trees=4), RF_GRIDS),
            "gbt": (JT.GradientBoostedTreesClassifier(num_rounds=4, max_depth=2),
                    GBT_GRIDS)}
    sel = JSel.with_cross_validation(num_folds=2, seed=3,
                                     models=[fams[f] for f in families])
    pred = label.transform_with(sel, vec)
    ds = JDs({"label": JCol.from_values(JRealNN, y.tolist()), "d": JCol.vector(x)})
    model = JWorkflow().set_input_dataset(ds).set_result_features(label, pred).train()
    return model, model.fitted[sel.uid], ds


def _port_wiring(families=("rf", "gbt")):
    label = TFB.RealNN("label").extract_field().as_response()
    vec = TFB.OPVector("d").extract_field().as_predictor()
    fams = {"rf": (TT.RandomForestClassifier(num_trees=4), RF_GRIDS),
            "gbt": (TT.GradientBoostedTreesClassifier(num_rounds=4, max_depth=2),
                    GBT_GRIDS)}
    sel = TSel.with_cross_validation(num_folds=2, seed=3,
                                     models=[fams[f] for f in families])
    pred = label.transform_with(sel, vec)
    return label, vec, sel, pred


def _port_ds(x, y):
    return TDs({"label": TCol.from_values(TRealNN, y.tolist()), "d": TCol.vector(x)})


FAMILY_SETS = {"rf+gbt": ("rf", "gbt"), "rf": ("rf",), "gbt": ("gbt",)}


@pytest.fixture(scope="module", params=sorted(FAMILY_SETS))
def trained(request):
    x, y = _data()
    fams = FAMILY_SETS[request.param]
    jmodel, jsel, jds = _reference(x, y, fams)
    return x, y, jmodel, jsel, fams


def _assert_same_selection(tsum, jsum):
    assert tsum.best_model_name == jsum.best_model_name
    assert tsum.best_grid == jsum.best_grid
    assert len(tsum.validation_results) == len(jsum.validation_results) > 0
    for te, je in zip(tsum.validation_results, jsum.validation_results):
        assert (te.model_name, te.grid) == (je.model_name, je.grid)
        np.testing.assert_allclose(te.metric_values, je.metric_values,
                                   rtol=0, atol=1e-6)
    tol = 1e-6 if jsum.best_model_name == "RandomForestClassifier" else 1e-3
    for k, v in jsum.train_evaluation.items():
        np.testing.assert_allclose(tsum.train_evaluation[k], v, rtol=0,
                                   atol=tol, err_msg=k)


def _assert_same_refit(tm, jm):
    assert type(tm).__name__ == type(jm).__name__
    exact = type(jm).__name__ == "ForestClassifierModel"
    for k in jm.trees:
        if exact or k != "value":
            np.testing.assert_array_equal(tm.trees[k], jm.trees[k], err_msg=k)
        else:
            np.testing.assert_allclose(tm.trees[k], jm.trees[k], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.edges, jm.edges)


class TestWorkflowTrain:
    def test_train_matches_reference(self, trained):
        x, y, _, jsel, fams = trained
        label, _, sel, pred = _port_wiring(fams)
        model = TWorkflow().set_input_dataset(_port_ds(x, y)) \
            .set_result_features(label, pred).train(device="cpu")
        tsel = model.fitted[sel.uid]
        _assert_same_selection(tsel.summary, jsel.summary)
        _assert_same_refit(tsel.model, jsel.model)
        assert set(sel.last_fit_profile) >= {"prep", "validate", "refit",
                                             "train_eval"}

    def test_selector_fit_directly(self, trained):
        x, y, _, jsel, fams = trained
        _, _, sel, _ = _port_wiring(fams)
        fitted = sel.fit(_port_ds(x, y), device="cpu")
        assert fitted.uid == sel.uid
        _assert_same_selection(fitted.summary, jsel.summary)
        _assert_same_refit(fitted.model, jsel.model)


class TestSavedTreeWinner:
    @pytest.mark.parametrize("fam", ["rf", "gbt"])
    @pytest.mark.parametrize("n", [200, 700])
    def test_jax_saved_tree_model_scores_equal(self, tmp_path, fam, n):
        x, y = _data(n=900, seed=21)
        label = JFB.RealNN("label").extract_field().as_response()
        vec = JFB.OPVector("d").extract_field().as_predictor()
        est = (JT.RandomForestClassifier(num_trees=4, max_depth=3) if fam == "rf"
               else JT.GradientBoostedTreesClassifier(num_rounds=4, max_depth=3))
        sel = JSel.with_cross_validation(num_folds=2, seed=3, models=[(est, [{}])])
        pred = label.transform_with(sel, vec)
        jds = JDs({"label": JCol.from_values(JRealNN, y.tolist()), "d": JCol.vector(x)})
        jm = JWorkflow().set_input_dataset(jds).set_result_features(label, pred).train()
        path = str(tmp_path / "model")
        jm.save(path)
        ref = JModel.load(path).score(JDs({"d": JCol.vector(x[:n])}))[pred.name]
        got = TModel.load(path).score(TDs({"d": TCol.vector(x[:n])}),
                                      device="cpu")[pred.name]
        assert got.data.shape == np.asarray(ref.data).shape
        if n <= 512:
            assert got.data.tobytes() == np.asarray(ref.data).tobytes()
        else:
            np.testing.assert_allclose(got.data, np.asarray(ref.data),
                                       rtol=0, atol=1e-6)


class TestEntryPoints:
    def test_default_models_equal_the_reference(self):
        ref = [(type(e).__name__, g) for e, g in JSel.default_models()]
        got = [(type(e).__name__, g) for e, g in TSel.default_models()]
        assert got == ref
        assert [n for n, _ in got] == ["LogisticRegression", "RandomForestClassifier",
                                       "GradientBoostedTreesClassifier", "LinearSVC"]
        for (je, _), (te, _) in zip(JSel.default_models(), TSel.default_models()):
            assert te.get_params() == {k: v for k, v in je.get_params().items()
                                       if k in te.get_params()}
        sel = TSel.with_cross_validation()
        assert [(type(e).__name__, g) for e, g in sel.models] == ref

    def test_train_takes_the_reference_positional_order(self):
        """``train(0.2, 7)`` asks for a 20 % test split drawn from seed 7: it
        trains on the rest and evaluates the held-out rows, it does not train
        on every row with seed 0.2; the third positional is the checkpointer,
        not ported."""
        import inspect

        label, _, _, pred = _port_wiring(("rf",))
        wf = TWorkflow().set_input_dataset(_port_ds(*_data(n=60))) \
            .set_result_features(label, pred)
        held = wf.train(0.2, 7, device="cpu")
        assert set(held.selector_model().summary.holdout_evaluation) >= {"auPR", "auROC"}
        with pytest.raises(NotImplementedError, match="checkpointer"):
            wf.train(0.2, 7, object(), device="cpu")
        with pytest.raises(NotImplementedError, match="hbm_budget"):
            wf.train(0.0, 42, None, False, 1e9, device="cpu")
        with pytest.raises(TypeError):
            wf.train(0.0, 42, None, False, None, None, None, None, "cpu")
        ref = list(inspect.signature(JWorkflow.train).parameters)
        got = inspect.signature(TWorkflow.train).parameters
        assert [p for p in got if p != "device"] == ref
        assert got["device"].kind is inspect.Parameter.KEYWORD_ONLY
        model = wf.train(0.0, 7, device="cpu")
        assert model.fitted[pred.origin_stage.uid].summary.best_model_name \
            == "RandomForestClassifier"

    def test_no_card_raises_for_every_entry_point(self, monkeypatch):
        x, y = _data(n=50)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        label, _, sel, pred = _port_wiring()
        ds = _port_ds(x, y)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TWorkflow().set_input_dataset(ds).set_result_features(label, pred).train()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sel.fit(ds)
        est = TT.RandomForestClassifier(num_trees=2)
        label.transform_with(est, pred.parents[1])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est.fit(ds)

    def test_unported_train_options_raise(self):
        label, _, _, pred = _port_wiring()
        wf = TWorkflow().set_input_dataset(_port_ds(*_data(n=50))) \
            .set_result_features(label, pred)
        for kw in ({"strict": True}, {"resume": "/nonexistent"},
                   {"host_budget": 1}, {"telemetry": "x"},
                   {"checkpointer": object()}, {"hbm_budget": 1e9}):
            with pytest.raises(NotImplementedError):
                wf.train(device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="raw feature filter"):
            wf.with_raw_feature_filter(object())

    def test_estimator_fit_on_cpu(self):
        x, y = _data(n=120)
        label = TFB.RealNN("label").extract_field().as_response()
        vec = TFB.OPVector("d").extract_field().as_predictor()
        est = TT.RandomForestClassifier(num_trees=3, max_depth=2)
        out = label.transform_with(est, vec)
        model = est.fit(_port_ds(x, y), device="cpu")
        assert model.uid == est.uid and model.get_output() is out
        assert model.n_trees == 3


def _failing_gbt_sweep(monkeypatch, phase, exc):
    """GBT's CV sweep raises ``exc`` when launched or when gathered."""
    def sweep(self, *args, **kwargs):
        if phase == "launch":
            raise exc

        def gather():
            raise exc
        return gather
    monkeypatch.setattr(TT.GradientBoostedTreesClassifier, "cv_sweep_async", sweep)


class TestSweepFailures:
    @pytest.mark.parametrize("phase", ["launch", "gather"])
    @pytest.mark.parametrize("exc", [
        TD.KernelError("hist_level: CUDA kernel launch failed (cudaError_t 719)"),
        TD.KernelError("CUDA kernel build failed:\ntrees: nvcc exit 1")])
    def test_kernel_failure_raises(self, monkeypatch, phase, exc):
        _failing_gbt_sweep(monkeypatch, phase, exc)
        _, _, sel, _ = _port_wiring()
        with pytest.raises(TD.KernelError, match="CUDA kernel"):
            sel.fit(_port_ds(*_data(n=120)), device="cpu")

    @pytest.mark.parametrize("phase", ["launch", "gather"])
    def test_model_failure_leaves_the_family_out(self, monkeypatch, phase):
        _failing_gbt_sweep(monkeypatch, phase, ValueError("no finite split"))
        _, _, sel, _ = _port_wiring()
        fitted = sel.fit(_port_ds(*_data(n=120)), device="cpu")
        summary = fitted.summary
        assert summary.best_model_name == "RandomForestClassifier"
        gbt = [ev for ev in summary.validation_results
               if ev.model_name == "GradientBoostedTreesClassifier"]
        assert len(gbt) == len(GBT_GRIDS)
        assert all(np.isnan(v) for ev in gbt for v in ev.metric_values)

    def test_kernel_faults_are_told_from_model_faults(self):
        assert TD.is_kernel_fault(TD.KernelError("x"))
        assert not TD.is_kernel_fault(ValueError("x"))
        assert not TD.is_kernel_fault(RuntimeError("x"))
