"""The reference's example apps, written once for the port with numpy-only
data (``examples/titanic_simple.py``, ``iris_app.py``, ``boston_app.py``,
``dataprep_readers.py``).

Each data function repeats its example's numpy draws in the same order and
returns the rows as records (dicts; None where the example's frame holds
NaN), so no pandas is needed: ``tests/test_torch_examples.py`` holds them
value for value to the examples' own frames.  The workflow builders wire the
examples' features, stages and selectors through the port's entry points
(``transmogrifai_tpu_torch``), read through ``CustomReader``; the card's
``chip_smoke.py`` and the CPU tests drive them.  Imports numpy and the port
only.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np

import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.aggregators.monoid import CutOffTime
from transmogrifai_tpu_torch.models.selector import (
    MultiClassificationModelSelector,
    RegressionModelSelector,
)
from transmogrifai_tpu_torch.ops.onehot import StringIndexer
from transmogrifai_tpu_torch.readers.base import (
    AggregateReader,
    ConditionalReader,
    CustomReader,
)
from transmogrifai_tpu_torch.workflow.runner import App, WorkflowRunner

FB = T.FeatureBuilder

#: CV tolerance (rtol, atol) of each family whose fit draws nothing, against
#: the JAX record of the examples (fixtures/examples): the linear families'
#: float32 sums run in another order (the port's LR gate, 1e-4); a tree's
#: float histograms too, so a near-tie split may go the other way (the
#: selection record's tolerances).  The random forests draw their bootstrap
#: with torch, not threefry: their rows are not held to the record here.
EXAMPLE_TOL = {"LogisticRegression": (0, 1e-4), "LinearSVC": (0, 1e-4),
               "LinearRegression": (0, 1e-4), "GeneralizedLinearRegression": (0, 1e-4),
               "MultinomialLogisticRegression": (0, 1e-4), "NaiveBayes": (0, 1e-4),
               "DecisionTreeClassifier": (0, 3e-3),
               "GradientBoostedTreesClassifier": (0, 1e-3),
               "GradientBoostedTreesRegressor": (2e-3, 0)}


def cv_rows(summary: dict) -> dict:
    """(family, grid as JSON) -> validation row of a summary's ``to_dict()``."""
    return {(r["modelName"], json.dumps(r["grid"], sort_keys=True)): r
            for r in summary["validationResults"]}


def winner_or_tie(got: dict, want: dict) -> bool:
    """Whether ``got``'s winner (summaries' ``to_dict()``) is the record's, or
    ties it: both candidates' means in the record, and in ``got``, within
    the deterministic families' 1e-4 of each other (the Boston app's ridge
    and gaussian GLM at reg 0.01 fit the same model and differ by 4.6e-6 in
    the record, so float32 sums can order them either way)."""
    key = lambda s: (s["bestModelName"],  # noqa: E731
                     json.dumps(s["bestGrid"], sort_keys=True))
    if key(got) == key(want):
        return True
    g, w = cv_rows(got), cv_rows(want)
    a, b = key(got), key(want)
    return (a in w and b in g and a[0] in EXAMPLE_TOL and b[0] in EXAMPLE_TOL
            and abs(w[a]["mean"] - w[b]["mean"]) <= 1e-4
            and abs(g[a]["mean"] - g[b]["mean"]) <= 1e-4)


def cv_beside_record(got: dict, want: dict) -> list:
    """Each validation row of ``got`` beside the record's (summaries'
    ``to_dict()``), with its largest deviation over the tolerance of its
    family (None for a forest); raises AssertionError when the rows differ
    or a row is out of its tolerance."""
    g, w = cv_rows(got), cv_rows(want)
    if g.keys() != w.keys():
        raise AssertionError(f"CV rows {sorted(g)} != the record's {sorted(w)}")
    out = []
    for k, wr in w.items():
        gr, over = g[k], None
        if k[0] in EXAMPLE_TOL:
            rtol, atol = EXAMPLE_TOL[k[0]]
            over = max(abs(a - b) / (atol + rtol * abs(b))
                       for a, b in zip(gr["values"], wr["values"]))
            if over > 1.0:
                raise AssertionError(f"{k} CV {gr['values']} vs the record's "
                                     f"{wr['values']} beyond (rtol, atol) {rtol, atol}")
        out.append({"model": k[0], "grid": gr["grid"], "mean": gr["mean"],
                    "record_mean": wr["mean"], "deviation_over_tol": over})
    return out

# -- data -------------------------------------------------------------------

#: where the multinomial LR refit's first Adam step may put each class's
#: intercept (see :func:`softmax_refit_family`), in steps over (-0.3, 0.3)
REFIT_FIRST_INTERCEPTS = (-0.3, -0.15, 0.0, 0.15, 0.3)


def softmax_refit_family(x, y_onehot, w, reg: float, max_iter: int, first_intercepts):
    """The Adam loop of ``models/softmax.py::_softmax_fits`` for one refit
    (``x`` (n, d1) with its ones column last, one weight row ``w`` (1, n)),
    run for F copies that differ only in the intercept row after the first
    step: copy f's is ``first_intercepts[f]`` (F, C).  Returns B (F, d1, C).

    At B = 0 every class's probability is 1/C, so the intercepts' first
    gradient, mean(p - y) over the rows, is zero in exact arithmetic for
    balanced classes: its float32 value is the rounding left by the sum's
    order (the device's product), and Adam's first step, lr * g / (|g| +
    eps) with |g| ~ eps, moves each intercept by anything in (-lr, lr)
    whatever the data.  The copies span that box."""
    import torch

    from transmogrifai_tpu_torch.models.softmax import (
        _BETA1,
        _BETA2,
        _EPS,
        LR_DEFAULT,
        _bias_corrections,
    )

    first = torch.as_tensor(np.asarray(first_intercepts, np.float32))
    n_fits = first.shape[0]
    n, d1 = x.shape
    c = y_onehot.shape[1]
    wT = w.repeat(n_fits, 1).T[:, :, None]
    sw = torch.clamp_min(w.sum(), 1e-12)
    pen = torch.ones((d1, 1), dtype=torch.float32)
    pen[-1, 0] = 0.0
    b = torch.zeros((n_fits, d1, c), dtype=torch.float32)
    m, v = torch.zeros_like(b), torch.zeros_like(b)
    c1, c2 = _bias_corrections(max_iter)
    for i in range(max_iter):
        logits = (x @ b.permute(1, 0, 2).reshape(d1, n_fits * c)).reshape(n, n_fits, c)
        p = torch.exp(torch.log_softmax(logits, dim=-1))
        r = (wT * (p - y_onehot[:, None, :])).reshape(n, n_fits * c)
        g = (x.T @ r).reshape(d1, n_fits, c).permute(1, 0, 2) / sw + reg * pen[None] * b
        m = _BETA1 * m + (1 - _BETA1) * g
        v = _BETA2 * v + (1 - _BETA2) * g * g
        b = b - LR_DEFAULT * (m / float(c1[i])) / (torch.sqrt(v / float(c2[i])) + _EPS)
        if i == 0:
            b[:, -1, :] = first
    return b


def refit_spread(x, y_onehot, w, reg: float, max_iter: int, vec: np.ndarray) -> float:
    """The largest difference in any probability of the rows ``vec`` (the
    scoring vector, float64 head) between two members of the refit family
    whose first-step intercepts lie on the grid of
    :data:`REFIT_FIRST_INTERCEPTS` per class: how far two summation orders
    may set the refit's probabilities apart."""
    import itertools

    from transmogrifai_tpu_torch.models.base import softmax_probs

    c = y_onehot.shape[1]
    firsts = list(itertools.product(REFIT_FIRST_INTERCEPTS, repeat=c))
    bs = softmax_refit_family(x, y_onehot, w, reg, max_iter, firsts).numpy().astype(np.float64)
    probs = np.stack([softmax_probs(vec.astype(np.float64) @ b[:-1] + b[-1]) for b in bs])
    lo, hi = probs.min(axis=0), probs.max(axis=0)
    return float((hi - lo).max())


@contextlib.contextmanager
def refit_inputs():
    """Inside the block, keep on the host the inputs (x, y_onehot, w, regs,
    max_iter) of every call of ``models/softmax.py::_softmax_fits`` with one
    weight row: the multinomial LR refits."""
    from transmogrifai_tpu_torch.models import softmax as S

    fits, kept = S._softmax_fits, []

    def keep(x, y_onehot, w, regs, max_iter, has_intercept):
        if w.shape[0] == 1:
            kept.append((x.cpu().clone(), y_onehot.cpu().clone(), w.cpu().clone(),
                         regs.cpu().clone(), max_iter))
        return fits(x, y_onehot, w, regs, max_iter, has_intercept)

    S._softmax_fits = keep
    try:
        yield kept
    finally:
        S._softmax_fits = fits


def iris_scoring_vector(model) -> np.ndarray:
    """The Iris app's scoring rows (``iris_records(seed=4)``) through
    ``model``'s fitted transmogrify on the CPU: the selector's input
    vector."""
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    feat = model.selector_model().inputs[1]
    ds = records_reader(iris_records(seed=4)).generate_dataset(feat.raw_features())
    return transform_dag(ds, [feat], model.fitted, "cpu")[feat.name].data


def iris_refit_bound(model, refit) -> float:
    """:func:`refit_spread` of the Iris refit whose inputs ``refit`` were
    kept by :func:`refit_inputs`, over the scoring rows through ``model``:
    the bound on a refit's probabilities against any other summation
    order's (the JAX record's among them)."""
    x, y_onehot, w, regs, max_iter = refit
    return refit_spread(x, y_onehot, w, float(regs[0]), max_iter, iris_scoring_vector(model))


def titanic_records(n: int = 800, seed: int = 7) -> list:
    """``titanic_simple.titanic_dataframe()``'s synthetic table as records."""
    rng = np.random.default_rng(seed)
    sex = rng.choice(["male", "female"], n, p=[0.65, 0.35])
    pclass = rng.choice([1, 2, 3], n, p=[0.25, 0.2, 0.55])
    age = np.where(rng.random(n) < 0.2, np.nan, rng.normal(30, 12, n).clip(1, 80))
    fare = rng.lognormal(2.5, 1.0, n)
    odds = 0.6 * (sex == "female") - 0.25 * (pclass == 3) + 0.1 * (fare > 30)
    y = (rng.random(n) < np.clip(0.25 + odds, 0.02, 0.95)).astype(int)
    sib_sp = rng.integers(0, 4, n)
    par_ch = rng.integers(0, 3, n)
    embarked = rng.choice(["S", "C", "Q"], n)
    return [{"id": i, "survived": int(y[i]), "pClass": int(pclass[i]),
             "name": f"Passenger {i}", "sex": str(sex[i]),
             "age": None if np.isnan(age[i]) else float(age[i]),
             "sibSp": int(sib_sp[i]), "parCh": int(par_ch[i]),
             "ticket": f"T{i % 100}", "fare": float(fare[i]), "cabin": None,
             "embarked": str(embarked[i])} for i in range(n)]


IRIS_CENTERS = {
    "setosa": (5.0, 3.4, 1.5, 0.25),
    "versicolor": (5.9, 2.8, 4.3, 1.3),
    "virginica": (6.6, 3.0, 5.5, 2.0),
}


def iris_records(n_per_class: int = 50, seed: int = 3) -> list:
    """``iris_app.iris_dataframe()``'s three gaussian clusters as records."""
    rng = np.random.default_rng(seed)
    rows = []
    for sp, c in IRIS_CENTERS.items():
        for _ in range(n_per_class):
            rows.append({
                "sepalLength": float(rng.normal(c[0], 0.35)),
                "sepalWidth": float(rng.normal(c[1], 0.3)),
                "petalLength": float(rng.normal(c[2], 0.35)),
                "petalWidth": float(rng.normal(c[3], 0.15)),
                "irisClass": sp,
            })
    return rows


BOSTON_FEATURES = ["crim", "zn", "indus", "nox", "rm", "age", "dis", "rad", "tax",
                   "ptratio", "lstat"]
BOSTON_MOMENTS = {
    "crim": (3.6, 8.6), "zn": (11.4, 23.3), "indus": (11.1, 6.9),
    "nox": (0.55, 0.12), "rm": (6.3, 0.7), "age": (68.6, 28.1),
    "dis": (3.8, 2.1), "rad": (9.5, 8.7), "tax": (408.0, 168.5),
    "ptratio": (18.5, 2.2), "lstat": (12.7, 7.1),
}


def boston_records(n: int = 500, seed: int = 11) -> list:
    """``boston_app.boston_dataframe()``'s linear + noise table as records."""
    rng = np.random.default_rng(seed)
    cols = {name: rng.normal(size=n) * s + m for name, (m, s) in BOSTON_MOMENTS.items()}
    cols["medv"] = (22.5 + 5.0 * (cols["rm"] - 6.3) - 0.6 * (cols["lstat"] - 12.7)
                    - 0.5 * (cols["crim"] - 3.6) / 8.6 + rng.normal(0, 2.0, n))
    return [{k: float(v[i]) for k, v in cols.items()} for i in range(n)]


#: dataprep_readers.PURCHASES: a purchase log, several rows per customer
PURCHASES = [
    {"id": "a", "t": 100, "amount": 10.0, "store": "north"},
    {"id": "a", "t": 200, "amount": 20.0, "store": "north"},
    {"id": "a", "t": 300, "amount": 40.0, "store": "south"},
    {"id": "b", "t": 150, "amount": 5.0, "store": "south"},
    {"id": "b", "t": 250, "amount": 15.0, "store": "south"},
]


def records_reader(records: list) -> CustomReader:
    return CustomReader(lambda: records)


# -- the examples' workflows ------------------------------------------------

def pclass_str(r):
    return None if r.get("pClass") is None else str(r["pClass"])


def titanic_workflow(reader, selector=None):
    """titanic_simple.main()'s DAG: DSL math, transmogrify, sanity check and
    the default binary selector (3 folds) unless ``selector`` is given.
    Returns (workflow, survived, prediction)."""
    survived = FB.RealNN("survived").extract_field().as_response()
    p_class = FB.PickList("pClass").extract(pclass_str).as_predictor()
    sex = FB.PickList("sex").extract_field().as_predictor()
    age = FB.Real("age").extract_field().as_predictor()
    sib_sp = FB.Integral("sibSp").extract_field().as_predictor()
    par_ch = FB.Integral("parCh").extract_field().as_predictor()
    fare = FB.Real("fare").extract_field().as_predictor()
    embarked = FB.PickList("embarked").extract_field().as_predictor()

    family_size = sib_sp + par_ch + 1
    estimated_cost = family_size * fare
    pivoted_sex = sex.pivot(min_support=1)
    normed_age = age.fill_missing_with_mean().z_normalize()

    passenger_features = T.transmogrify([
        p_class, age, sib_sp, par_ch, fare, embarked,
        family_size, estimated_cost, pivoted_sex, normed_age,
    ])
    checked = survived.sanity_check(passenger_features)
    selector = selector or T.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3)
    prediction = survived.transform_with(selector, checked)
    wf = T.Workflow().set_reader(reader).set_result_features(survived, prediction)
    return wf, survived, prediction


def titanic_metrics(model, reader) -> dict:
    """titanic_simple.main()'s metrics: evaluate on the reader's rows, and
    the winner's CV auPR as ``cv_auPR``."""
    raws = []
    for f in model.result_features:
        for r in f.raw_features():
            if r not in raws:
                raws.append(r)
    ds = reader.generate_dataset(raws)
    metrics = model.evaluate(T.Evaluators.binary_classification(), ds)
    summary = model.summary()
    best = next(r for r in summary.validation_results
                if r.model_name == summary.best_model_name
                and r.grid == summary.best_grid)
    metrics["cv_auPR"] = best.mean_metric
    return metrics


class _ExampleApp(App):
    """An example's App; ``evaluator`` (None in the examples) makes the
    score run evaluate too and enables the evaluate run."""

    def __init__(self, evaluator=None):
        self.evaluator = evaluator


def iris_workflow(reader, selector=None) -> T.Workflow:
    """iris_app.OpIris.build_workflow(): the text label indexed, the
    measurements transmogrified, the default multiclass selector (3 folds)
    unless ``selector`` is given."""
    iris_class = FB.PickList("irisClass").extract_field().as_response()
    measures = [FB.Real(n).extract_field().as_predictor()
                for n in ("sepalLength", "sepalWidth", "petalLength", "petalWidth")]
    label = iris_class.transform_with(StringIndexer())
    features = T.transmogrify(measures)
    selector = selector or MultiClassificationModelSelector.with_cross_validation(
        num_folds=3)
    prediction = label.transform_with(selector, features)
    return T.Workflow().set_reader(reader).set_result_features(label, prediction)


def boston_workflow(reader, selector=None) -> T.Workflow:
    """boston_app.OpBoston.build_workflow(): the default regression selector
    (3 folds) over the transmogrified reals unless ``selector`` is given."""
    medv = FB.RealNN("medv").extract_field().as_response()
    predictors = [FB.Real(name).extract_field().as_predictor()
                  for name in BOSTON_FEATURES]
    features = T.transmogrify(predictors)
    selector = selector or RegressionModelSelector.with_cross_validation(num_folds=3)
    prediction = medv.transform_with(selector, features)
    return T.Workflow().set_reader(reader).set_result_features(medv, prediction)


class OpIris(_ExampleApp):
    """iris_app.OpIris over numpy records: an indexed text label and the
    default multiclass selector."""

    def build_workflow(self) -> T.Workflow:
        return iris_workflow(records_reader(iris_records()))

    def runner(self, params) -> WorkflowRunner:
        return WorkflowRunner(workflow=self.build_workflow(),
                              scoring_reader=records_reader(iris_records(seed=4)),
                              evaluator=self.evaluator)


class OpBoston(_ExampleApp):
    """boston_app.OpBoston over numpy records: the default regression
    selector over transmogrified reals."""

    def build_workflow(self) -> T.Workflow:
        return boston_workflow(records_reader(boston_records()))

    def runner(self, params) -> WorkflowRunner:
        return WorkflowRunner(workflow=self.build_workflow(),
                              scoring_reader=records_reader(boston_records(seed=12)),
                              evaluator=self.evaluator)


def dataprep() -> dict:
    """dataprep_readers.main(): each customer's purchases summed before a
    global cutoff (AggregateReader), and before the first 'south' purchase
    (ConditionalReader), over a CustomReader of the log."""
    def amount():
        return FB.Real("amount").extract(lambda r: r.get("amount")).as_predictor()

    agg = AggregateReader(
        CustomReader(lambda: PURCHASES, key_fn=lambda r: r["id"]),
        key_fn=lambda r: r["id"], time_fn=lambda r: r["t"],
        cutoff=CutOffTime.unix(250))
    agg_ds, agg_keys = agg.generate_dataset_with_keys([amount()])
    cond = ConditionalReader(
        CustomReader(lambda: PURCHASES, key_fn=lambda r: r["id"]),
        key_fn=lambda r: r["id"], time_fn=lambda r: r["t"],
        condition_fn=lambda r: r["store"] == "south")
    cond_ds, cond_keys = cond.generate_dataset_with_keys([amount()])
    return {"aggregate": dict(zip(agg_keys, agg_ds["amount"].to_values())),
            "conditional": dict(zip(cond_keys, cond_ds["amount"].to_values()))}
