"""The reference's example apps on the port, held to the JAX package's record.

The sources of ``examples/titanic_simple.py``, ``iris_app.py``,
``boston_app.py`` and ``dataprep_readers.py`` run on the CPU with
``transmogrifai_tpu`` swapped for ``transmogrifai_tpu_torch`` in memory (the
files are not touched), under ``use_device("cpu")``.  Their results are held
to ``transmogrifai_tpu_torch/fixtures/examples/record.json``, which
``tools/make_torch_examples_fixture.py`` made by running the same four
examples with the JAX package on the CPU:

- the winner's family and grid equal the record's (the examples' winners
  are linear models, which do not draw);
- the deterministic CV rows lie within the LR gate, 1e-4 (LR, LinearSVC,
  LinearRegression, GLM, multinomial LR, NaiveBayes), the decision trees'
  within 3e-3 and the GBTs' within 1e-3 (2e-3 of the value for regression):
  float32 sums in another order, and for the trees a near-tie split that
  may go the other way, as the selection record's tolerances say;
- a random forest's rows depend on its bootstrap draws, which the port makes
  with torch and not threefry: each is held within 4 standard deviations of
  the port's own CV metric over 8 forest seeds on the same features (the
  record's rows lie within 0.9 of them);
- Titanic's ``cv_auPR`` lies in the reference's own band (0.67-0.90) and the
  scores of the winner within 1e-5 of the record's; the apps' score runs
  within 1e-4 (probabilities) and 1e-4 of the value (Boston's predictions,
  in the label's units).

``tests/torch_examples_data.py`` (the numpy-only copy that ``chip_smoke.py``
runs on the card) is pinned here value for value to the examples' frames,
and its apps' evaluate runs hold a model the example saved.

``examples/serving_streaming.py`` (the local scorer, the standalone bundle
in a subprocess, the checkpointed stream through the runner) runs the same
way, held to ``fixtures/streaming/example.json``
(``tools/make_torch_streaming_fixture.py``).
"""

import json
import math
import os
import sys
import types

import numpy as np
import pytest

import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.models.selector import (
    MultiClassificationModelSelector,
    RegressionModelSelector,
)
from transmogrifai_tpu_torch.models.trees import (
    RandomForestClassifier,
    RandomForestRegressor,
)
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.readers.files import DataReaders
from transmogrifai_tpu_torch.workflow import fit as TFit
from transmogrifai_tpu_torch.workflow import workflow as TW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_examples_data as E  # noqa: E402

with open(os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "examples",
                       "record.json")) as _fh:
    RECORD = json.load(_fh)

TOL = E.EXAMPLE_TOL
FOREST_SEEDS = list(range(42, 50))


def load_example(name: str):
    """The example's source, run as a module with the package swapped."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    with open(path) as fh:
        src = fh.read().replace("transmogrifai_tpu", "transmogrifai_tpu_torch")
    mod = types.ModuleType(f"torch_example_{name}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


_rows = E.cv_rows


def forest_spread(build, selector_cls, forest_cls) -> dict:
    """max_depth -> (mean, std) of the port's forest CV metric over
    FOREST_SEEDS on the example's own features."""
    grids = [{"num_trees": 50, "max_depth": d, "seed": s}
             for d in (3, 6) for s in FOREST_SEEDS]
    sel = selector_cls.with_cross_validation(num_folds=3, models=[(forest_cls(), grids)])
    with use_device("cpu"):
        summary = build(sel).train().summary()
    out = {}
    for d in (3, 6):
        vals = [e.mean_metric for e in summary.validation_results
                if e.grid["max_depth"] == d]
        out[d] = (float(np.mean(vals)), float(np.std(vals, ddof=1)))
    return out


def check_rows(got: dict, want: dict, spread: dict):
    E.cv_beside_record({"validationResults": list(got.values())},
                       {"validationResults": list(want.values())})
    for k, w in want.items():
        name, g = k[0], got[k]
        if name.startswith("RandomForest"):
            mean, std = spread[w["grid"]["max_depth"]]
            assert abs(w["mean"] - mean) <= 4 * std, (k, w["mean"], mean, std)
            assert abs(g["mean"] - mean) <= 4 * std, (k, g["mean"], mean, std)
            continue
        rtol, atol = TOL[name]
        np.testing.assert_allclose(g["values"], w["values"], rtol=rtol, atol=atol,
                                   err_msg=str(k))


def _same_winner(got: dict, want: dict):
    assert (got["bestModelName"], got["bestGrid"]) == (want["bestModelName"],
                                                       want["bestGrid"])


@pytest.fixture(scope="module")
def titanic():
    mod = load_example("titanic_simple")
    trained = []
    train = TW.Workflow.train

    def catching(self, *a, **kw):
        m = train(self, *a, **kw)
        trained.append(m)
        return m

    TW.Workflow.train = catching
    try:
        with use_device("cpu"):
            metrics = mod.main()
    finally:
        TW.Workflow.train = train
    model = trained[-1]
    return mod, metrics, model


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    out = {}
    for name, cls in (("iris", "OpIris"), ("boston", "OpBoston")):
        mod = load_example(f"{name}_app")
        loc = str(tmp_path_factory.mktemp(name) / "model")
        with use_device("cpu"):
            train = getattr(mod, cls)().main(["--run-type", "train", "--model-location", loc])
            score = getattr(mod, cls)().main(["--run-type", "score", "--model-location", loc])
        out[name] = (mod, train, score, loc)
    return out


class TestTitanic:
    def test_winner_and_cv_rows(self, titanic):
        _, metrics, model = titanic
        got, want = model.summary().to_dict(), RECORD["titanic"]["summary"]
        _same_winner(got, want)
        spread = forest_spread(
            lambda sel: E.titanic_workflow(E.records_reader(E.titanic_records()), sel)[0],
            T.BinaryClassificationModelSelector, RandomForestClassifier)
        check_rows(_rows(got), _rows(want), spread)

    def test_metrics_in_the_reference_band(self, titanic):
        _, metrics, _ = titanic
        want = RECORD["titanic"]["metrics"]
        assert 0.67 <= metrics["cv_auPR"] <= 0.90
        for k in ("cv_auPR", "auPR", "auROC", "error"):
            np.testing.assert_allclose(metrics[k], want[k], rtol=0, atol=1e-4, err_msg=k)

    def test_scores_and_summary_text(self, titanic):
        mod, _, model = titanic
        ds = DataReaders.Simple.dataframe(mod.titanic_dataframe()).generate_dataset(
            mod.model_raw_features(model))
        pred = next(f.name for f in model.result_features
                    if f.ftype.__name__ == "Prediction")
        with use_device("cpu"):
            col = model.score(ds)[pred]
        want = RECORD["titanic"]["scores"]
        np.testing.assert_allclose(col.prob, want["prob"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(col.pred, want["pred"])
        text = model.summary_pretty().splitlines()
        assert text[0] == RECORD["titanic"]["pretty"].splitlines()[0]
        assert len(text) == len(RECORD["titanic"]["pretty"].splitlines())

    def test_numpy_records_equal_the_example_frame(self, titanic):
        mod, _, model = titanic
        df = mod.titanic_dataframe()
        want = [{k: (None if isinstance(v, float) and math.isnan(v) else v)
                 for k, v in r.items()} for r in df.to_dict("records")]
        assert E.titanic_records() == want
        raws = mod.model_raw_features(model)
        a = DataReaders.Simple.dataframe(df).generate_dataset(raws)
        b = E.records_reader(E.titanic_records()).generate_dataset(raws)
        for f in raws:
            assert a[f.name].to_values() == b[f.name].to_values(), f.name


class TestApps:
    @pytest.mark.parametrize("name, selector, forest, records", [
        ("iris", MultiClassificationModelSelector, RandomForestClassifier, E.iris_records),
        ("boston", RegressionModelSelector, RandomForestRegressor, E.boston_records)])
    def test_train_run(self, apps, name, selector, forest, records):
        _, train, _, loc = apps[name]
        want = RECORD[name]["train"]
        assert train.run_type.value == "train" and os.path.exists(loc)
        _same_winner(train.metrics, want)
        assert train.metrics["failedModels"] == want["failedModels"] == []
        build = {"iris": E.iris_workflow, "boston": E.boston_workflow}[name]
        spread = forest_spread(lambda sel: build(E.records_reader(records()), sel),
                               selector, forest)
        check_rows(_rows(train.metrics), _rows(want), spread)
        for k, w in want["trainEvaluation"].items():
            np.testing.assert_allclose(train.metrics["trainEvaluation"][k], w,
                                       rtol=0, atol=1e-4, err_msg=k)

    @pytest.mark.parametrize("name", ["iris", "boston"])
    def test_score_run(self, apps, name):
        _, _, score, _ = apps[name]
        pred = next(n for n in score.scores.names if "modelSelector" in n)
        col = score.scores[pred]
        want = RECORD[name]["scores"]
        if col.prob is not None:
            np.testing.assert_allclose(col.prob, want["prob"], rtol=0, atol=1e-4)
            top2 = np.sort(np.asarray(want["prob"]), axis=1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 1e-3
            np.testing.assert_array_equal(col.pred[clear], np.asarray(want["pred"])[clear])
        else:   # label units: the coefficients agree to ~1e-6 of their value
            np.testing.assert_allclose(col.pred, want["pred"], rtol=1e-4, atol=0)

    @pytest.mark.parametrize("name, frame, records", [
        ("iris", "iris_dataframe", E.iris_records),
        ("boston", "boston_dataframe", E.boston_records)])
    def test_numpy_records_equal_the_example_frame(self, apps, name, frame, records):
        mod = apps[name][0]
        for kw in ({}, {"seed": {"iris": 4, "boston": 12}[name]}):
            assert records(**kw) == getattr(mod, frame)(**kw).to_dict("records")

    @pytest.mark.parametrize("name, evaluator, metric", [
        ("iris", T.Evaluators.multi_classification, "error"),
        ("boston", T.Evaluators.regression, "rmse")])
    def test_the_card_apps_evaluate_the_saved_model(self, apps, name, evaluator, metric):
        """chip_smoke's apps (numpy records) score and evaluate the model the
        example saved: the same metrics as scoring the example's frame."""
        _, _, score, loc = apps[name]
        app = {"iris": E.OpIris, "boston": E.OpBoston}[name](evaluator())
        with use_device("cpu"):
            ev = app.main(["--run-type", "evaluate", "--model-location", loc])
            sc = app.main(["--run-type", "score", "--model-location", loc])
        assert ev.run_type.value == "evaluate" and ev.metrics == sc.metrics
        pred = next(n for n in score.scores.names if "modelSelector" in n)
        np.testing.assert_array_equal(sc.scores[pred].pred, score.scores[pred].pred)
        assert math.isfinite(ev.metrics[metric])


def test_dataprep_readers():
    mod = load_example("dataprep_readers")
    (agg_keys, agg_ds), (cond_keys, cond_ds) = mod.main()
    got = {"aggregate": dict(zip(agg_keys, agg_ds["amount"].to_values())),
           "conditional": dict(zip(cond_keys, cond_ds["amount"].to_values()))}
    assert got == RECORD["dataprep"] == E.dataprep()
    assert E.PURCHASES == mod.PURCHASES


class TestIrisRefit:
    """The Iris refit's sensitivity to the order of one sum: every class
    starts at probability 1/3 and the classes are balanced, so the first
    intercept gradient is zero in exact arithmetic and Adam's first step
    turns its float32 rounding into a move of up to 0.3 per intercept."""

    @pytest.fixture(scope="class")
    def refit(self):
        with E.refit_inputs() as kept:
            model = E.iris_workflow(E.records_reader(E.iris_records())).train(device="cpu")
        assert len(kept) == 1
        return model, kept[0]

    def test_first_intercept_gradient_is_rounding(self, refit):
        import torch

        _, (x, y1, w, regs, _) = refit
        p = torch.exp(torch.log_softmax(torch.zeros_like(y1), -1))
        exact = ((p - y1).double() * w.T.double()).sum(0) / float(w.sum())
        rounded = (x.T @ (w.T * (p - y1)))[-1] / w.sum()
        # the exact mean of the float32 probabilities' excess over 1/3 is
        # of the order of Adam's eps (1e-8), and the float32 product's is
        # its 150 terms' rounding: the first step's size is set by rounding
        assert (exact.abs() < 5e-8).all() and (rounded.abs() < 1e-6).all()
        assert not torch.equal(rounded.double(), exact)

    def test_family_reproduces_the_refit(self, refit):
        from transmogrifai_tpu_torch.models.softmax import _softmax_fits

        _, (x, y1, w, regs, max_iter) = refit
        first = _softmax_fits(x, y1, w, regs, 1, True)[0, -1]
        assert (first.abs() < 0.3).all() and (first.abs() > 0.1).all()
        b = E.softmax_refit_family(x, y1, w, float(regs[0]), max_iter, first[None].numpy())
        assert torch_equal(b[0], _softmax_fits(x, y1, w, regs, max_iter, True)[0])

    def test_record_within_the_refit_bound(self, refit):
        """The JAX record's probabilities lie within the refit family's
        spread of the port's (the bound chip_smoke holds the card to), and
        that spread is what lets two summation orders differ by ~1e-2."""
        model, kept = refit
        bound = E.iris_refit_bound(model, kept)
        from transmogrifai_tpu_torch.data.dataset import Column

        col = model.selector_model().predict_column(
            Column.vector(E.iris_scoring_vector(model)), "cpu")
        dev = float(np.max(np.abs(col.prob - np.asarray(RECORD["iris"]["scores"]["prob"]))))
        assert dev <= 1e-4 < 1e-2 < bound < 0.05


@pytest.fixture(scope="module")
def text_reviews():
    import torch_text_data as TD

    with open(os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "text_stack",
                           "record.json")) as fh:
        want = json.load(fh)["text_reviews"]
    with use_device("cpu"):
        got = TD.run_text_reviews(REPO, T, TFit.transform_dag, "cpu")
    return got, want


class TestTextReviews:
    """``examples/text_reviews.py`` with the import swapped, against the JAX
    package's record (``fixtures/text_stack``, made by
    ``tools/make_torch_text_fixture.py``)."""

    def test_fitted_states_and_vector_equal(self, text_reviews):
        got, want = text_reviews
        assert got["states"] == want["states"]
        assert got["vector"] == want["vector"]

    def test_cv_and_metrics_within_the_lr_gate(self, text_reviews):
        got, want = text_reviews
        assert [r["grid"] for r in got["cv"]] == [r["grid"] for r in want["cv"]]
        np.testing.assert_allclose([r["values"] for r in got["cv"]],
                                   [r["values"] for r in want["cv"]], rtol=0, atol=1e-4)
        assert got["metrics"].keys() == want["metrics"].keys()
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-4, k

    def test_side_workflow_maps_equal_every_row(self, text_reviews):
        got, want = text_reviews
        assert len(got["languages"]) == len(want["languages"]) == 2000
        assert got["languages"] == want["languages"]
        assert got["ner"] == want["ner"]


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


# ---------------------------------------------------------------------------
# serving_streaming: local scorer, the standalone bundle, checkpointed stream
# ---------------------------------------------------------------------------

with open(os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "streaming",
                       "example.json")) as _fh:
    STREAM_RECORD = json.load(_fh)


@pytest.fixture(scope="module")
def serving_streaming():
    mod = load_example("serving_streaming")
    captured = {}
    train = mod.train_model

    def keep(workdir):
        wf, model = train(workdir)
        captured["best"] = model.summary().best_model_name
        return wf, model

    mod.train_model = keep
    with use_device("cpu"):
        out = mod.main()
    return out, captured


class TestServingStreaming:
    """``examples/serving_streaming.py`` on the port (LR and GBT(20 rounds,
    depth 3) in 3-fold CV, the in-process scorer, the standalone bundle in a
    subprocess, the checkpointed stream through the runner) against the
    JAX package's run (``fixtures/streaming/example.json``)."""

    def test_winner_and_stream_batches(self, serving_streaming):
        out, captured = serving_streaming
        assert captured["best"] == STREAM_RECORD["best_model_name"]
        assert out["result"].metrics["batches"] == STREAM_RECORD["batches"]

    def test_in_process_and_standalone_within_the_record(self, serving_streaming):
        out, _ = serving_streaming
        want = STREAM_RECORD["in_process"]
        assert set(out["in_process"]) == set(want)
        for k, v in want.items():
            assert abs(out["in_process"][k] - v) <= TOL["LogisticRegression"][1], k
        sa, want_sa = out["standalone"], STREAM_RECORD["standalone"]
        assert sa["prediction"] == want_sa["prediction"]
        assert abs(sa["probability"][1] - want_sa["probability"][1]) \
            <= TOL["LogisticRegression"][1]
        assert abs(sa["probability"][1] - out["in_process"]["probability_1"]) <= 1e-6
