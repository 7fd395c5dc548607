"""The out-of-core tests' table and pipeline, written once for either package
(``tests/test_torch_ooc.py``; the crash-and-resume child process imports it
with the port alone).

``make_table(pkg, n, seed)`` is the reference's ``tests/test_chunked_ingest.py
::_fixture`` (4 Real with 10 % missing, 2 PickList of 8 levels with 5 % None,
a logistic RealNN label) built from one numpy stream, as a ``Dataset`` of
``pkg``; ``features(pkg, ...)`` its pipeline (transmogrify -> sanity_check,
and optionally a 2-fold LR selector).  ``pkg`` is a namespace with the
package's ``Column``, ``Dataset``, ``FeatureBuilder``, ``transmogrify``,
``BinaryClassificationModelSelector``, ``LogisticRegression`` and ``types``.
"""

import types as _types

import numpy as np


def namespace(root, logistic, data, types):
    """The names ``make_table`` / ``features`` read, from a package."""
    return _types.SimpleNamespace(
        Column=data.Column, Dataset=data.Dataset,
        FeatureBuilder=root.FeatureBuilder, transmogrify=root.transmogrify,
        BinaryClassificationModelSelector=root.BinaryClassificationModelSelector,
        LogisticRegression=logistic.LogisticRegression, types=types)


def port_namespace():
    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch import types
    from transmogrifai_tpu_torch.data import dataset
    from transmogrifai_tpu_torch.models import logistic

    return namespace(T, logistic, dataset, types)


def make_table(pkg, n: int = 2000, seed: int = 12):
    t = pkg.types
    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(4):
        cols[f"num{i}"] = pkg.Column(t.Real, rng.normal(size=n), rng.random(n) > 0.1)
    levels = [f"lv{j}" for j in range(8)]
    for i in range(2):
        data = np.array(
            [None if rng.random() < 0.05
             else levels[rng.integers(0, len(levels))] for _ in range(n)],
            dtype=object)
        cols[f"cat{i}"] = pkg.Column(t.PickList, data)
    z = cols["num0"].data - cols["num1"].data
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    cols["label"] = pkg.Column(t.RealNN, y, np.ones(n, dtype=np.bool_))
    return pkg.Dataset(cols)


def features(pkg, with_selector: bool = False, folds: int = 2):
    t = pkg.types
    FB = pkg.FeatureBuilder
    label = FB.of("label", t.RealNN).extract_field().as_response()
    feats = [FB.of(f"num{i}", t.Real).extract_field().as_predictor()
             for i in range(4)] + \
        [FB.of(f"cat{i}", t.PickList).extract_field().as_predictor()
         for i in range(2)]
    checked = label.sanity_check(pkg.transmogrify(feats))
    if not with_selector:
        return label, checked
    sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
        models=[(pkg.LogisticRegression(),
                 [{"reg_param": 0.01}, {"reg_param": 0.1}])],
        num_folds=folds)
    return label, label.transform_with(sel, checked)


def runners_of(model):
    """A fitted model's runners in topological order."""
    from importlib import import_module

    dag = import_module(type(model).__module__.rsplit(".", 1)[0] + ".dag")
    return [model.fitted.get(s.uid, s)
            for layer in dag.compute_dag(model.result_features) for s in layer]
