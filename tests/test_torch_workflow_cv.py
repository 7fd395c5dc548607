"""Workflow-level CV in the port against the JAX package.

``cut_dag`` splits the DAG around the selector the same way in both
packages (the same stage classes in the same order).  The reference's
workflow-CV cases (``tests/test_workflow_cv.py``) run through both
packages on the same numpy columns: LR CV metrics within 1e-4, the same
winner, the checker re-fitted once per fold plus once for the refit, the
seed cleared after ``train``, a label made by a StringIndexer fitted before
the cut, splitter weights reaching the fold sweeps, a plain transformer in
the ``during`` cut.

The wide pipeline at full width (64 Reals, 8 auto-bucketized, 32 Zipf
PickLists, 4 Binaries; 3 folds; LR + MLP) at 8192 rows meets the JAX
package's committed record (``fixtures/workflow_cv``,
``tools/make_torch_workflow_cv_fixture.py``), the MLP's initial draws fed
from it: every fold's bucketizer splits and checker kept indices ``==``,
every fold's vector the record's sha256, LR fold metrics within 1e-4, the
winner and its grid, the refit coefficients within the IRLS rule of
``tests/test_torch_linear.py`` (rtol 1e-4 / atol 1e-5; measured with
torch on one thread: 1.4e-5 at most, the intercept 7.5e-6 of 0.022).
The MLP's fold metrics are held within MLP_CPU_TOL = 3e-4: 200 full-batch
float32 Adam steps amplify last-bit differences (XLA's reductions and tanh
against torch's), by ~10x per 50 steps on this data (measured on the CPU
with torch on one thread: 2.06e-4 at most).  The controls show the bound
separates a wrong fit: 10 Adam steps short deviates 5.1e-4, a learning
rate of 0.049 for 0.05 9.5e-3.

The fold transform: all folds' encode slots in one slot table
(``workflow/plan.py::FoldTransformPlan``), equal bitwise to the per-fold
host loop, also where one fold's bucketizer found no split.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import transmogrifai_tpu as J
from transmogrifai_tpu.models.logistic import LogisticRegression as JLR
from transmogrifai_tpu.models.mlp import MultilayerPerceptronClassifier as JMLP
from transmogrifai_tpu.perf.kernels import dispatch as KD
from transmogrifai_tpu.types import feature_type_by_name as jft
from transmogrifai_tpu.workflow.dag import cut_dag as j_cut_dag
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.models.logistic import LogisticRegression as TLR
from transmogrifai_tpu_torch.types import feature_type_by_name as tft
from transmogrifai_tpu_torch.workflow import fit as TFit
from transmogrifai_tpu_torch.workflow import plan as TP
from transmogrifai_tpu_torch.workflow.dag import cut_dag as t_cut_dag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_wide_data import (  # noqa: E402
    FIXTURE_SHAPE,
    WCV_FOLDS,
    make_data,
    wcv_models,
    wide_pipeline,
)

RECORD = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "workflow_cv")
MLP_CPU_TOL = 3e-4
J_NS = types.SimpleNamespace(
    FeatureBuilder=J.FeatureBuilder, transmogrify=J.transmogrify,
    BinaryClassificationModelSelector=J.BinaryClassificationModelSelector,
    LogisticRegression=JLR, MultilayerPerceptronClassifier=JMLP)


def _small(pkg, n=240, d=5, seed=0, signal=1.0, grids=(0.01, 0.1)):
    """The reference test's pipeline in ``pkg`` (J or T): d Reals ->
    transmogrify -> sanity_check -> a 3-fold LR selector."""
    lr = JLR if pkg is J else TLR
    rng = np.random.default_rng(seed)
    cols = {f"x{i}": rng.normal(size=n).tolist() for i in range(d)}
    beta = rng.normal(size=d)
    z = sum(beta[i] * np.asarray(cols[f"x{i}"]) for i in range(d))
    cols["label"] = (rng.random(n) < 1 / (1 + np.exp(-signal * z))).astype(float).tolist()
    ds = pkg.Dataset.from_features(
        cols, {**{f"x{i}": pkg.types.Real for i in range(d)}, "label": pkg.types.RealNN})
    label = pkg.FeatureBuilder.of("label", pkg.types.RealNN).extract_field().as_response()
    feats = [pkg.FeatureBuilder.of(f"x{i}", pkg.types.Real).extract_field().as_predictor()
             for i in range(d)]
    vec = pkg.transmogrify(feats)
    checked = label.sanity_check(vec)
    sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, models=[(lr(), [{"reg_param": r} for r in grids])])
    return ds, label, vec, checked, label.transform_with(sel, checked)


def _train(pkg, ds, *results, wcv=True):
    wf = pkg.Workflow().set_input_dataset(ds).set_result_features(*results)
    if wcv:
        wf = wf.with_workflow_cv()
    if pkg is J:
        with KD.force_kernel_mode("interpret"):
            return wf, wf.train()
    return wf, wf.train(device="cpu")


def _same_cv(jm, tm, atol=1e-4):
    js, ts = jm.summary(), tm.summary()
    assert (ts.best_model_name, ts.best_grid) == (js.best_model_name, js.best_grid)
    assert len(ts.validation_results) == len(js.validation_results)
    for a, b in zip(js.validation_results, ts.validation_results):
        assert (a.model_name, a.grid) == (b.model_name, b.grid)
        np.testing.assert_allclose(b.metric_values, a.metric_values, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def small():
    out = {}
    for key, pkg in (("j", J), ("t", T)):
        ds, label, vec, checked, pred = _small(pkg)
        wf, model = _train(pkg, ds, label, pred)
        out[key] = dict(ds=ds, label=label, vec=vec, pred=pred, wf=wf, model=model)
    return out


class TestCutDag:
    @pytest.mark.parametrize("case", ["small", "wide"])
    def test_before_and_during_match_the_reference(self, case):
        cuts = []
        for pkg, cut in ((J, j_cut_dag), (T, t_cut_dag)):
            if case == "small":
                _, label, _, _, pred = _small(pkg)
            else:
                cols, schema = make_data(50, seed=0, **FIXTURE_SHAPE)
                ns = J_NS if pkg is J else T
                ftypes = {s["name"]: (jft if pkg is J else tft)(s["type"]) for s in schema}
                label, _, _, pred = wide_pipeline(ns, ftypes, schema, 3, wcv_models(ns))
            before, during, sel = cut([label, pred])
            assert sel is pred.origin_stage
            cuts.append(([type(s).__name__ for s in before],
                         [type(s).__name__ for s in during]))
        assert cuts[0] == cuts[1]
        assert "SanityChecker" in cuts[1][1] and "SanityChecker" not in cuts[1][0]
        if case == "wide":
            assert cuts[1][1].count("DecisionTreeNumericBucketizer") == 8
            assert "VectorsCombiner" in cuts[1][1]

    def test_no_selector_returns_none(self):
        _, label, vec, _, _ = _small(T)
        assert t_cut_dag([label, vec]) is None

    def test_two_selectors_raise(self):
        _, label, vec, checked, pred = _small(T)
        sel2 = T.BinaryClassificationModelSelector.with_cross_validation(
            models=[(TLR(), [{}])])
        pred2 = label.transform_with(sel2, pred.origin_stage.inputs[1])
        with pytest.raises(ValueError, match="exactly one ModelSelector"):
            t_cut_dag([label, pred, pred2])


class TestWorkflowCV:
    def test_trains_and_scores(self, small):
        _same_cv(small["j"]["model"], small["t"]["model"])
        s = small["t"]["model"].summary()
        assert len(s.validation_results) == 2
        assert all(len(ev.metric_values) == 3 for ev in s.validation_results)
        scored = small["t"]["model"].score(small["t"]["ds"], device="cpu")
        jscored = small["j"]["model"].score(small["j"]["ds"])
        name = small["t"]["pred"].name
        assert len(scored[name]) == small["t"]["ds"].n_rows
        np.testing.assert_allclose(scored[name].prob,
                                   np.asarray(jscored[small["j"]["pred"].name].prob),
                                   rtol=0, atol=1e-6)
        assert small["t"]["model"].workflow_cv and small["j"]["model"].workflow_cv

    def test_sanity_checker_refits_per_fold(self, small):
        """The checker fits k + 1 times: once per fold, once for the refit."""
        fits = [r for r in small["t"]["wf"].last_train_profile
                if r["kind"] == "fit" and r["stage"] == "SanityChecker"]
        assert len(fits) == 4
        assert [r.get("fold") for r in fits] == [0, 1, 2, None]
        kinds = [r["kind"] for r in small["t"]["wf"].last_train_profile]
        assert kinds.count("fold_transform") == 1 and kinds.count("fold_sweep") == 3

    def test_matches_plain_cv_selection(self):
        """Both CV modes in both packages reject the crippling grid point."""
        got = []
        for pkg in (J, T):
            for wcv in (False, True):
                ds, label, _, _, pred = _small(pkg, signal=3.0, grids=(0.001, 100.0))
                got.append(_train(pkg, ds, label, pred, wcv=wcv)[1])
        for m in got:
            assert m.summary().best_grid == {"reg_param": 0.001}
        _same_cv(got[1], got[3])

    def test_requires_selector(self):
        for pkg in (J, T):
            ds, label, vec, _, _ = _small(pkg)
            wf = pkg.Workflow().set_input_dataset(ds).set_result_features(label, vec) \
                .with_workflow_cv()
            with pytest.raises(ValueError, match="ModelSelector"):
                wf.train() if pkg is J else wf.train(device="cpu")

    def test_selector_preseed_cleared_after_train(self, small):
        for side in ("j", "t"):
            assert not hasattr(small[side]["pred"].origin_stage, "_preselected")

    def test_string_label_via_indexed(self):
        models = []
        for pkg in (J, T):
            rng = np.random.default_rng(3)
            n = 150
            x = rng.normal(size=n)
            y = np.where(x + rng.normal(0, 0.5, n) > 0, "yes", "no")
            ds = pkg.Dataset.from_features({"x": x.tolist(), "outcome": y.tolist()},
                                           {"x": pkg.types.Real,
                                            "outcome": pkg.types.PickList})
            outcome = pkg.FeatureBuilder.of("outcome", pkg.types.PickList) \
                .extract_field().as_response()
            xf = pkg.FeatureBuilder.of("x", pkg.types.Real).extract_field().as_predictor()
            label = outcome.indexed()
            checked = label.sanity_check(pkg.transmogrify([xf]))
            sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
                num_folds=3, models=[((JLR if pkg is J else TLR)(), [{"reg_param": 0.01}])])
            pred = label.transform_with(sel, checked)
            before, _, _ = (j_cut_dag if pkg is J else t_cut_dag)([label, pred])
            assert "StringIndexer" in {type(s).__name__ for s in before}
            models.append(_train(pkg, ds, label, pred)[1])
        _same_cv(*models)

    def test_splitter_weights_flow_into_workflow_cv(self):
        models = []
        for pkg in (J, T):
            sel_mod = __import__(pkg.__name__ + ".models.selector", fromlist=["x"])
            tun = __import__(pkg.__name__ + ".models.tuning", fromlist=["x"])
            ev = __import__(pkg.__name__ + ".evaluators.base", fromlist=["x"])
            rng = np.random.default_rng(4)
            n = 400
            x = rng.normal(size=n)
            yv = (rng.random(n) < np.clip(0.05 + 0.2 * (x > 1.0), 0, 1)).astype(float)
            ds = pkg.Dataset.from_features({"x": x.tolist(), "label": yv.tolist()},
                                           {"x": pkg.types.Real, "label": pkg.types.RealNN})
            label = pkg.FeatureBuilder.of("label", pkg.types.RealNN).extract_field() \
                .as_response()
            xf = pkg.FeatureBuilder.of("x", pkg.types.Real).extract_field().as_predictor()
            checked = label.sanity_check(pkg.transmogrify([xf]))
            sel = sel_mod.ModelSelector(
                models=[((JLR if pkg is J else TLR)(), [{"reg_param": 0.01}])],
                validator=tun.CrossValidator(ev.BinaryClassificationEvaluator(), num_folds=3),
                splitter=tun.DataBalancer(sample_fraction=0.4))
            pred = label.transform_with(sel, checked)
            models.append(_train(pkg, ds, label, pred)[1])
        _same_cv(*models)
        assert all(np.isfinite(v) for v in models[1].summary().validation_results[0]
                   .metric_values)

    def test_plain_transformer_between_checker_and_selector(self):
        models = []
        for pkg in (J, T):
            misc = __import__(pkg.__name__ + ".ops.misc", fromlist=["x"])
            ds, label, vec, checked, _ = _small(pkg)
            thinned = checked.transform_with(misc.DropIndicesByTransformer(
                match_fn=lambda c: False))
            sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
                num_folds=2, models=[((JLR if pkg is J else TLR)(), [{"reg_param": 0.01}])])
            pred = label.transform_with(sel, thinned)
            _, during, _ = (j_cut_dag if pkg is J else t_cut_dag)([label, pred])
            assert "DropIndicesByTransformer" in {type(s).__name__ for s in during}
            models.append(_train(pkg, ds, label, pred)[1])
        _same_cv(*models)

    def test_workflow_cv_survives_save_and_load_both_ways(self, small, tmp_path):
        from transmogrifai_tpu.workflow.workflow import WorkflowModel as JWM

        t_path, j_path = str(tmp_path / "t"), str(tmp_path / "j")
        small["t"]["model"].save(t_path)
        small["j"]["model"].save(j_path)
        assert JWM.load(t_path).workflow_cv
        assert T.WorkflowModel.load(j_path).workflow_cv
        assert T.WorkflowModel.load(t_path).workflow_cv


# -- the wide pipeline at full width against the JAX record ----------------------

@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """The port's run of the record (``torch_wide_data.wide_wcv_run``) in a
    child process whose torch runs on one thread: the suite runs several
    processes at once, and there torch's default thread team, with the
    CPU oversubscribed, made this run ~70x slower (10 s alone, 679 s in
    the suite); changing this process's thread count instead slowed the
    torch modules run after it in the same process."""
    out = tmp_path_factory.mktemp("wide") / "run.json"
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from torch_wide_data import wide_wcv_run; "
            "json.dump(wide_wcv_run(sys.argv[2]), open(sys.argv[3], 'w'))")
    subprocess.run([sys.executable, "-c", code, os.path.join(REPO, "tests"), RECORD,
                    str(out)], cwd=REPO, check=True,
                   env=dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1"))
    with open(out) as fh:
        run = json.load(fh)
    with open(os.path.join(RECORD, "states.json")) as fh:
        run["states"] = json.load(fh)
    return run


class TestWideRecord:
    def test_fold_states_bitwise(self, wide):
        """Every fold's bucketizer splits, kept indices and vector digest."""
        got, want = wide["folds"], wide["states"]["folds"]
        assert len(got) == len(want) == WCV_FOLDS
        for f, (g, w) in enumerate(zip(got, want)):
            assert g["splits"] == w["splits"], f"fold {f} splits"
            assert g["kept"] == w["kept"], f"fold {f} kept indices"
            assert g["vector"] == w["vector"], f"fold {f} vector"

    def test_cut_matches_the_record(self, wide):
        assert wide["before"] == wide["states"]["before"]
        assert wide["during"] == wide["states"]["during"]

    def test_cv_metrics_and_winner(self, wide):
        got, rec = wide["cv"], wide["states"]["cv"]
        assert len(got) == len(rec)
        for g, r in zip(got, rec):
            assert (g["model"], g["grid"]) == (r["model"], r["grid"])
            atol = 1e-4 if g["model"] == "LogisticRegression" else MLP_CPU_TOL
            np.testing.assert_allclose(g["values"], r["values"], rtol=0, atol=atol)
        win = wide["states"]["winner"]
        assert (wide["winner"]["name"], wide["winner"]["grid"]) == (win["name"], win["grid"])

    def test_mlp_fold_sweep_repeats_the_run(self, wide):
        """The MLP swept again on the run's fold vectors gives the run's CV
        metrics bitwise (the ground of the controls below)."""
        want = [g["values"] for g in wide["cv"]
                if g["model"] == "MultilayerPerceptronClassifier"]
        assert np.asarray(wide["mlp_again"]).tobytes() == np.asarray(want).tobytes()

    @pytest.mark.parametrize("control", ["190_steps", "lr_0.049"])
    def test_mlp_tolerance_fails_a_wrong_fit(self, wide, control):
        """The MLP's tolerance against the record separates a wrong fit: 10
        Adam steps short, or a learning rate 2 % off (fold 0 alone shows
        it)."""
        want = [r["values"][:1] for r in wide["states"]["cv"]
                if r["model"] == "MultilayerPerceptronClassifier"]
        got = np.asarray(wide["mlp_controls"][control])
        assert np.max(np.abs(got - np.asarray(want))) > MLP_CPU_TOL

    def test_refit_coefficients(self, wide):
        win, rec = wide["winner"], wide["states"]["winner"]
        np.testing.assert_allclose(win["coef"], rec["coef"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(win["intercept"], rec["intercept"], rtol=1e-4, atol=1e-5)
        assert wide["final_kept"] == wide["states"]["final_kept"]

    def test_fold_transform_is_one_table(self, wide):
        """All folds' bucketize slots in one slot table: 3 x 8 (every fold's
        8 bucketizers found splits here)."""
        ft = wide["fold_transform"]
        assert ft["plans"] == WCV_FOLDS
        assert ft["encode_slots"] == wide["split_slots"] == WCV_FOLDS * 8


# -- the fold transform --------------------------------------------------------

def _host_loop(dataset, during, maps):
    out = []
    for m in maps:
        ds = dataset
        for s in during:
            ds = m[s.uid].transform(ds)
        out.append(ds)
    return out


class TestFoldTransform:
    @pytest.fixture(scope="class")
    def fitted(self):
        """A small wide cut's ``before`` dataset, ``during`` stages and two
        sets of fold maps: as fitted, and with fold 1's first bucketizer
        fitted at min_info_gain 1.0 (no split; the checker after it fits
        on that fold's narrower vector)."""
        cut = dict(n_real=6, n_bucketized=3, n_pick=4, n_levels=30, n_binary=2)
        cols, schema = make_data(2000, seed=1, **cut)
        ftypes = {s["name"]: tft(s["type"]) for s in schema}
        label, sel, checker, pred = wide_pipeline(T, ftypes, schema, 3)
        ds = T.Dataset.from_features(cols, ftypes)
        before, during, _ = t_cut_dag([label, pred])
        ds_before = TFit.fit_stage_list(ds, before, {}, device="cpu")
        bucket = next(s for s in during if type(s).__name__ == "DecisionTreeNumericBucketizer")

        def maps(no_split_fold=None):
            out = []
            for f in range(3):
                rows = np.flatnonzero(np.arange(ds.n_rows) % 3 != f)
                ff = {}
                copies = [s.copy() for s in during]
                if f == no_split_fold:
                    next(c for c in copies if c.uid == bucket.uid).set_params(
                        min_info_gain=1.0)
                TFit.fit_stage_list(ds_before.take(rows), copies, ff, device="cpu")
                out.append({c.uid: ff.get(c.uid, c) for c in copies})
            return out

        return ds_before, during, maps(), maps(1), bucket.uid, sel.inputs[1].name

    @staticmethod
    def _equal(a, b, names):
        for n in names:
            x, y = np.asarray(a[n].data), np.asarray(b[n].data)
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), n

    @staticmethod
    def _slots(m) -> int:
        return sum(1 for r in m.values()
                   if type(r).__name__ == "DecisionTreeNumericBucketizerModel"
                   and r.should_split)

    @pytest.mark.parametrize("which", ["fitted", "no_split_in_fold_1"])
    def test_table_equals_the_per_fold_host_loop(self, fitted, which):
        """One slot table of every fold's slots (a fold whose bucketizer
        found no split has no slot for it: its null indicator is a wired
        torch op there), bitwise the per-fold host loop."""
        ds, during, maps, no_split, uid, vec = fitted
        maps = maps if which == "fitted" else no_split
        if which != "fitted":
            assert not maps[1][uid].should_split and maps[0][uid].should_split
        plan = TP.FoldTransformPlan([[m[s.uid] for s in during] for m in maps],
                                    frozenset(ds.names), TP.resolve_device("cpu"))
        assert len(plan.table) == sum(self._slots(m) for m in maps)
        got = TP.fused_fold_transforms(ds, during, maps, "cpu")
        want = _host_loop(ds, during, maps)
        names = [s.output_name for s in during]
        for g, w in zip(got, want):
            self._equal(g, w, names)

    def test_keep_limits_the_columns(self, fitted):
        ds, during, maps, _, _, vec = fitted
        got = TP.fused_fold_transforms(ds, during, maps, "cpu", keep=frozenset({vec}))
        want = _host_loop(ds, during, maps)
        for g, w in zip(got, want):
            self._equal(g, w, [vec])
            assert all(s.output_name not in g for s in during
                       if s.output_name != vec)
