"""The registry-wide stage sweep's cases, written once for either package.

The table and the builders of ``tests/test_stage_registry_specs.py``, with
the package passed in: ``pkg`` is a namespace with ``Dataset``,
``FeatureBuilder``, ``Column``, ``STAGE_REGISTRY``, ``T`` (the package's
``types`` module), ``VectorMetadata`` and ``VectorColumnMetadata``
(:func:`namespace` makes it from the package's modules).  Used by
``tests/test_torch_stage_registry_specs.py`` (the port, and the port against
the JAX package on the same values) and ``chip_smoke.py`` phase 27 (the card
against the CPU), so it imports neither jax nor either package.

``build(pkg, name)`` returns ``(stage, dataset, flags)`` for a name of
:data:`CASES`: the stage wired to raw features over a 12-row table of typed
values (48 rows x 6 for the label-and-vector estimators), and the spec's
flags.  ``column_diff(a, b)`` holds two output columns to one layout and
returns their largest absolute difference.
"""

from __future__ import annotations

import base64
import re
import types
from typing import Any, Callable, Dict, Tuple

import numpy as np

WED_MS = 1528887600000  # 2018-06-13 11:00 UTC
_DAY = 24 * 3600 * 1000
_PNG = base64.b64encode(b"\x89PNG\r\n\x1a\n" + b"\x00" * 16).decode()
_PDF = base64.b64encode(b"%PDF-1.4 hello").decode()

#: deterministic 12-row sample values per feature type name
TYPE_VALUES = {
    "RealNN": [0.5, 1.5, 2.5, 0.25, 3.5, 1.0, 2.0, 0.75, 1.25, 2.75, 0.1, 3.0],
    "Real": [1.0, None, 3.0, 2.0, None, 5.0, 0.5, 4.0, 2.5, 1.5, None, 3.5],
    "Integral": [1, 2, None, 4, 5, 6, 7, None, 9, 10, 11, 12],
    "Binary": [True, False, None, True, False, True, False, True, None, False,
               True, False],
    "Text": ["alpha", "beta gamma", None, "delta", "epsilon zeta", "eta",
             "theta iota", None, "kappa", "lambda mu", "nu", "xi omicron"],
    "PickList": ["red", "blue", "red", None, "green", "blue", "red", "green",
                 "blue", "red", None, "green"],
    "MultiPickList": [{"x", "y"}, {"x"}, set(), {"y", "z"}, {"z"}, {"x", "z"},
                      {"y"}, set(), {"x", "y", "z"}, {"z"}, {"x"}, {"y"}],
    "TextList": [["big", "cat"], ["small", "dog"], [], ["big", "dog"],
                 ["small", "cat", "ran"], ["cat"], ["dog", "ran"], [],
                 ["big"], ["small"], ["ran", "far"], ["cat", "dog"]],
    "Email": ["a@example.com", "b@test.org", None, "bad-email", "c@example.com",
              "d@foo.io", None, "e@bar.net", "f@example.com", "oops@", "g@x.co",
              "h@example.com"],
    "URL": ["https://example.com/a", "http://test.org/b?q=1", None, "not a url",
            "https://foo.io", "https://bar.net/x/y", None, "ftp://files.example.com",
            "https://example.com", "nope", "http://x.co", "https://y.dev/z"],
    "Phone": ["+14155552671", "4155552671", None, "123", "+442071838750",
              "+81312345678", None, "555-867-5309", "+14155550000", "0",
              "+4930123456", "+14155559999"],
    "PhoneMap": [{"home": "+14155552671", "work": "12"} if i % 3 else {}
                 for i in range(12)],
    "Base64": [_PNG, _PDF, None, _PNG, _PDF, _PNG, None, _PDF, _PNG, _PDF,
               _PNG, _PDF],
    "Date": [WED_MS + i * _DAY for i in range(11)] + [None],
    "DateList": [[WED_MS, WED_MS + _DAY], [WED_MS + 2 * _DAY], [],
                 [WED_MS + i * _DAY for i in range(3)]] * 3,
    "DateMap": [{"d1": WED_MS + i * _DAY, "d2": WED_MS - i * _DAY}
                if i % 4 else {} for i in range(12)],
    "RealMap": [{"x": float(i), "y": 2.0 * i} if i % 5 else {"x": float(i)}
                for i in range(12)],
    "TextMap": [{"k1": ["u", "v", "u", "w"][i % 4], "k2": "c"} if i % 3 else {}
                for i in range(12)],
    "GeolocationMap": [{"home": [37.7 + i * 0.1, -122.4 + i * 0.1, 5.0]}
                       if i % 4 else {} for i in range(12)],
    "Geolocation": [[37.77 + (i % 5) * 0.2, -122.42 + (i % 3) * 0.3, 5.0]
                    if i % 6 else None for i in range(12)],
}


def namespace(dataset_mod, base_mod, types_mod, vector_metadata_mod, builder_mod):
    """``pkg`` for :func:`build` from one package's modules: ``data.dataset``,
    ``stages.base``, ``types``, ``utils.vector_metadata`` and
    ``features.builder``."""
    return types.SimpleNamespace(
        Dataset=dataset_mod.Dataset, Column=dataset_mod.Column,
        STAGE_REGISTRY=base_mod.STAGE_REGISTRY, Estimator=base_mod.Estimator,
        T=types_mod, FeatureBuilder=builder_mod.FeatureBuilder,
        VectorMetadata=vector_metadata_mod.VectorMetadata,
        VectorColumnMetadata=vector_metadata_mod.VectorColumnMetadata)


def _feat(pkg, name, ftype, response=False):
    b = pkg.FeatureBuilder.of(name, ftype).extract_field()
    return b.as_response() if response else b.as_predictor()


def _typed_ds(pkg, specs):
    """specs: list of (name, type name) -> (Dataset, [features])."""
    cols = {n: TYPE_VALUES[t] for n, t in specs}
    ds = pkg.Dataset.from_features(cols, {n: getattr(pkg.T, t) for n, t in specs})
    return ds, [_feat(pkg, n, getattr(pkg.T, t)) for n, t in specs]


def _label_vector_ds(pkg, n=48, d=6, classes=2, nonneg=True):
    """RealNN label + OPVector features with full slot metadata."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if nonneg:
        x = np.abs(x)  # NaiveBayes requires non-negative features
    y = rng.integers(0, classes, size=n).astype(float)
    x[:, 0] += y  # signal
    meta = pkg.VectorMetadata(
        "v", [pkg.VectorColumnMetadata(f"f{j}", "Real") for j in range(d)]
    ).reindexed()
    ds = pkg.Dataset({
        "label": pkg.Column.from_values(pkg.T.RealNN, list(y)),
        "v": pkg.Column.vector(x, meta),
    })
    return (ds, _feat(pkg, "label", pkg.T.RealNN, response=True),
            _feat(pkg, "v", pkg.T.OPVector))


def _vector_pair_ds(pkg, n=12, d=3):
    rng = np.random.default_rng(3)
    dsd = {}
    feats = []
    for name in ("v1", "v2"):
        meta = pkg.VectorMetadata(
            name, [pkg.VectorColumnMetadata(f"{name}_f{j}", "Real")
                   for j in range(d)]).reindexed()
        dsd[name] = pkg.Column.vector(rng.normal(size=(n, d)).astype(np.float32), meta)
        feats.append(_feat(pkg, name, pkg.T.OPVector))
    return pkg.Dataset(dsd), feats


# -- named fns for function-param stages (lambdas break copy/get_params eq) ---
def _is_present(v):
    return v is not None


def _over_one(v):
    return v is not None and v > 1.0


def _double(v):
    return None if v is None else 2.0 * v


# --------------------------------------------------------------------------
# case table: stage name -> builder(pkg, cls) returning (stage, dataset, flags)
# --------------------------------------------------------------------------

def _kwargs(pkg, cls_kw):
    return cls_kw(pkg) if callable(cls_kw) else dict(cls_kw or {})


def unary(tname, cls_kw=None, **flags):
    def build(pkg, cls):
        ds, (f,) = _typed_ds(pkg, [("a", tname)])
        stage = cls(**_kwargs(pkg, cls_kw))
        f.transform_with(stage)
        return stage, ds, flags
    return build


def binary(t1, t2, cls_kw=None, **flags):
    def build(pkg, cls):
        ds, (f1, f2) = _typed_ds(pkg, [("a", t1), ("b", t2)])
        stage = cls(**_kwargs(pkg, cls_kw))
        f1.transform_with(stage, f2)
        return stage, ds, flags
    return build


def seq(tname, k=2, cls_kw=None, **flags):
    def build(pkg, cls):
        ds, feats = _typed_ds(pkg, [(f"c{i}", tname) for i in range(k)])
        stage = cls(**_kwargs(pkg, cls_kw))
        feats[0].transform_with(stage, *feats[1:])
        return stage, ds, flags
    return build


def label_vec(cls_kw=None, classes=2, **flags):
    def build(pkg, cls):
        ds, label, vec = _label_vector_ds(pkg, classes=classes)
        stage = cls(**_kwargs(pkg, cls_kw))
        label.transform_with(stage, vec)
        return stage, ds, flags
    return build


def label_col(tname, cls_kw=None, **flags):
    def build(pkg, cls):
        cols = {"label": TYPE_VALUES["RealNN"], "a": TYPE_VALUES[tname]}
        ds = pkg.Dataset.from_features(
            cols, {"label": pkg.T.RealNN, "a": getattr(pkg.T, tname)})
        label = _feat(pkg, "label", pkg.T.RealNN, response=True)
        f = _feat(pkg, "a", getattr(pkg.T, tname))
        stage = cls(**_kwargs(pkg, cls_kw))
        label.transform_with(stage, f)
        return stage, ds, flags
    return build


def vec_seq(cls_kw=None, **flags):
    def build(pkg, cls):
        ds, feats = _vector_pair_ds(pkg)
        stage = cls(**_kwargs(pkg, cls_kw))
        feats[0].transform_with(stage, *feats[1:])
        return stage, ds, flags
    return build


def _descaler_case(pkg, cls):
    ds, (f1, f2) = _typed_ds(pkg, [("a", "Real"), ("b", "Real")])
    scaler = pkg.STAGE_REGISTRY["ScalerTransformer"](
        scaling_type="linear", slope=2.0, intercept=1.0)
    scaled = f1.transform_with(scaler)
    ds = scaler.transform(ds)
    stage = cls()
    scaled.transform_with(stage, scaled)
    return stage, ds, {}


def _drop_indices_case(pkg, cls):
    ds, feats = _vector_pair_ds(pkg)
    stage = cls(match_fn=_is_present)  # drops nothing (metadata always present)
    feats[0].transform_with(stage)
    return stage, ds, {"check_serde": False, "check_row_parity": False}


_SMALL_TREES = {"num_trees": 3, "max_depth": 3}
_SMALL_BOOST = {"num_rounds": 3, "max_depth": 3}

CASES: Dict[str, Callable] = {
    # -- unary transformers ---------------------------------------------------
    "AliasTransformer": unary("Real", {"name": "a_alias"}),
    "ScalarMathTransformer": unary("Real", {"op": "multiply", "scalar": 2.0}),
    "NumericBucketizer": unary(
        "Real", {"splits": [0.0, 2.0, 4.0, 6.0], "track_nulls": True}),
    "ScalerTransformer": unary(
        "Real", {"scaling_type": "linear", "slope": 2.0, "intercept": 1.0}),
    "TextTokenizer": unary("Text"),
    "TextLenTransformer": unary("Text"),
    "LanguageDetector": unary("Text"),
    "NameEntityRecognizer": unary("Text"),
    "EmailToPickList": unary("Email"),
    "ValidEmailTransformer": unary("Email"),
    "ValidUrlTransformer": unary("URL"),
    "UrlToDomainTransformer": unary("URL"),
    "PhoneNumberValidator": unary("Phone"),
    "ParsePhoneDefaultCountry": unary("Phone"),
    "IsValidPhoneDefaultCountry": unary("Phone"),
    "IsValidPhoneMapDefaultCountry": unary("PhoneMap"),
    "ParsePhoneNumber": binary("Phone", "Text"),
    "IsValidPhoneNumber": binary("Phone", "Text"),
    "MimeTypeDetector": unary("Base64"),
    "TimePeriodTransformer": unary("Date", {"period": "DayOfWeek"}),
    "TimePeriodListTransformer": unary("DateList", {"period": "DayOfWeek"}),
    "TimePeriodMapTransformer": unary("DateMap", {"period": "DayOfWeek"}),
    "HashingTF": unary("TextList", {"num_features": 32}),
    "NGramTransformer": unary("TextList", {"n": 2}),
    "StopWordsRemover": unary("TextList"),
    "LiftToList": unary(
        "TextList",
        lambda pkg: {"inner": pkg.STAGE_REGISTRY["ReplaceTransformer"](
            input_type=pkg.T.Text, old_value="cat", new_value="CAT")},
        check_serde=False),
    "LiftToMap": unary(
        "RealMap",
        lambda pkg: {"inner": pkg.STAGE_REGISTRY["UnaryLambdaTransformer"](
            fn=_double, input_type=pkg.T.Real, output_type=pkg.T.Real)},
        check_serde=False),
    "FilterMap": unary("RealMap"),
    "ToOccurTransformer": unary(
        "Real", lambda pkg: {"match_fn": _is_present, "input_type": pkg.T.Real},
        check_serde=False),
    "ReplaceTransformer": unary(
        "Text", lambda pkg: {"input_type": pkg.T.Text, "old_value": "beta gamma",
                             "new_value": "B"}),
    "ExistsTransformer": unary(
        "Real", lambda pkg: {"predicate": _over_one, "input_type": pkg.T.Real},
        check_serde=False),
    "FilterTransformer": unary(
        "Real", lambda pkg: {"predicate": _over_one, "default": -1.0,
                             "input_type": pkg.T.Real},
        check_serde=False),
    "UnaryLambdaTransformer": unary(
        "Real", lambda pkg: {"fn": _double, "input_type": pkg.T.Real,
                             "output_type": pkg.T.Real},
        check_serde=False),
    "IndexToString": unary("Real", {"labels": ["a", "b", "c", "d"]}),
    "DropIndicesByTransformer": _drop_indices_case,
    # -- binary transformers --------------------------------------------------
    "BinaryMathTransformer": binary("Real", "Real", {"op": "plus"}),
    "DescalerTransformer": _descaler_case,
    "SubstringTransformer": binary("Text", "Text"),
    "NGramSimilarity": binary("Text", "Text"),
    "JaccardSimilarity": binary("MultiPickList", "MultiPickList"),
    # -- sequence vectorizers -------------------------------------------------
    "NumericVectorizer": seq("Real"),
    "RealNNVectorizer": seq("RealNN"),
    "BinaryVectorizer": seq("Binary"),
    "OneHotVectorizer": seq("PickList", cls_kw={"top_k": 3, "min_support": 1}),
    "MultiPickListVectorizer": seq(
        "MultiPickList", cls_kw={"top_k": 3, "min_support": 1}),
    "SmartTextVectorizer": seq("Text", cls_kw={"max_cardinality": 3,
                                               "num_hashes": 16}),
    "SmartTextMapVectorizer": seq("TextMap", cls_kw={"max_cardinality": 3,
                                                     "num_hashes": 16}),
    "TextMapPivotVectorizer": seq(
        "TextMap", cls_kw={"top_k": 2, "min_support": 1}),
    "NumericMapVectorizer": seq("RealMap"),
    "GeolocationVectorizer": seq("Geolocation"),
    "GeolocationMapVectorizer": seq("GeolocationMap"),
    "DateToUnitCircleVectorizer": seq("Date"),
    "DateMapToUnitCircleVectorizer": seq("DateMap"),
    "DateListVectorizer": seq("DateList"),
    "TextListHashingVectorizer": seq("TextList", cls_kw={"num_hashes": 16}),
    "VectorsCombiner": vec_seq(),
    # -- unary estimators -----------------------------------------------------
    "FillMissingWithMean": unary("Real"),
    "StandardScaler": unary("RealNN"),
    "PercentileCalibrator": unary("RealNN", {"buckets": 4}),
    "StringIndexer": unary("Text", {"handle_invalid": "keep"}),
    "CountVectorizer": unary("TextList", {"min_count": 1, "vocab_size": 8}),
    "LDA": unary("TextList", {"k": 2, "max_iter": 5}),
    "Word2Vec": unary("TextList", {"embedding_dim": 8, "epochs": 2, "min_count": 1}),
    # -- (label, column) estimators -------------------------------------------
    "IsotonicRegressionCalibrator": label_col("RealNN"),
    "DecisionTreeNumericBucketizer": label_col("Real"),
    "DecisionTreeNumericMapBucketizer": label_col("RealMap"),
    # -- (label, vector) estimators -------------------------------------------
    "SanityChecker": label_vec({"min_variance": 0.0, "max_correlation": 0.999}),
    "LogisticRegression": label_vec(),
    "MultinomialLogisticRegression": label_vec(classes=3),
    "LinearRegression": label_vec(),
    "GeneralizedLinearRegression": label_vec(),
    "LinearSVC": label_vec(),
    "NaiveBayes": label_vec(),
    "MultilayerPerceptronClassifier": label_vec({"max_iter": 20}),
    "RandomForestClassifier": label_vec(_SMALL_TREES),
    "RandomForestRegressor": label_vec(_SMALL_TREES),
    "DecisionTreeClassifier": label_vec({"max_depth": 3}),
    "DecisionTreeRegressor": label_vec({"max_depth": 3}),
    "GradientBoostedTreesClassifier": label_vec(_SMALL_BOOST),
    "GradientBoostedTreesRegressor": label_vec(_SMALL_BOOST),
    "XGBoostClassifier": label_vec(_SMALL_BOOST),
    "XGBoostRegressor": label_vec(_SMALL_BOOST),
}


def build(pkg, name: str) -> Tuple[Any, Any, dict]:
    """(stage, dataset, spec flags) of case ``name`` in ``pkg``'s classes."""
    return CASES[name](pkg, pkg.STAGE_REGISTRY[name])


#: estimator case -> fitted-model class it must produce (covers the Model
#: classes whose constructors take fitted state)
EXPECTED_MODEL = {
    "FillMissingWithMean": "FillMissingWithMeanModel",
    "StandardScaler": "StandardScalerModel",
    "PercentileCalibrator": "PercentileCalibratorModel",
    "StringIndexer": "StringIndexerModel",
    "CountVectorizer": "CountVectorizerModel",
    "LDA": "LDAModel",
    "Word2Vec": "Word2VecModel",
    "OneHotVectorizer": "OneHotVectorizerModel",
    "MultiPickListVectorizer": "MultiPickListVectorizerModel",
    "SmartTextVectorizer": "SmartTextVectorizerModel",
    "SmartTextMapVectorizer": "SmartTextMapVectorizerModel",
    "TextMapPivotVectorizer": "TextMapPivotVectorizerModel",
    "NumericVectorizer": "NumericVectorizerModel",
    "NumericMapVectorizer": "NumericMapVectorizerModel",
    "GeolocationVectorizer": "GeolocationVectorizerModel",
    "GeolocationMapVectorizer": "GeolocationMapVectorizerModel",
    "DateMapToUnitCircleVectorizer": "DateMapToUnitCircleVectorizerModel",
    "DecisionTreeNumericBucketizer": "DecisionTreeNumericBucketizerModel",
    "DecisionTreeNumericMapBucketizer": "DecisionTreeNumericMapBucketizerModel",
    "IsotonicRegressionCalibrator": "IsotonicCalibratorModel",
    "SanityChecker": "SanityCheckerModel",
    "LogisticRegression": "LogisticRegressionModel",
    "MultinomialLogisticRegression": "MultinomialLogisticRegressionModel",
    "LinearRegression": "LinearRegressionModel",
    "GeneralizedLinearRegression": "GLMModel",
    "LinearSVC": "LinearSVCModel",
    "NaiveBayes": "NaiveBayesModel",
    "MultilayerPerceptronClassifier": "MLPClassifierModel",
    "RandomForestClassifier": "ForestClassifierModel",
    "RandomForestRegressor": "ForestRegressorModel",
    "DecisionTreeClassifier": "ForestClassifierModel",
    "DecisionTreeRegressor": "ForestRegressorModel",
    "GradientBoostedTreesClassifier": "GBTClassifierModel",
    "GradientBoostedTreesRegressor": "GBTRegressorModel",
    "XGBoostClassifier": "GBTClassifierModel",
    "XGBoostRegressor": "GBTRegressorModel",
}


#: registered classes deliberately NOT swept here, each with a reason
EXEMPT = {
    # abstract arity/framework bases — never instantiated directly
    "Transformer": "abstract base",
    "UnaryTransformer": "abstract base",
    "BinaryTransformer": "abstract base",
    "TernaryTransformer": "abstract base",
    "QuaternaryTransformer": "abstract base",
    "SequenceTransformer": "abstract base",
    "Estimator": "abstract base",
    "UnaryEstimator": "abstract base",
    "BinaryEstimator": "abstract base",
    "TernaryEstimator": "abstract base",
    "SequenceEstimator": "abstract base",
    "BinarySequenceEstimator": "abstract base",
    "PredictionEstimatorBase": "abstract base for model families",
    "PredictionModelBase": "abstract base for fitted models",
    "_LiftBase": "abstract base for LiftToList/LiftToMap",
    "_UnaryValueTransformer": "abstract base for value transformers",
    "_ForestBase": "abstract base for RF/DT",
    "_GBTBase": "abstract base for GBT/XGBoost",
    "_TreeEstimatorBase": "abstract base for tree estimators",
    "_TreeEnsembleModelBase": "abstract base for tree models",
    # constructed through other machinery, spec-covered elsewhere
    "FeatureGeneratorStage":
        "constructed by FeatureBuilder.extract_field; exercised by every "
        "workflow test (tests/test_features_dag.py)",
    "ModelSelector":
        "requires models+validator config; selection behavior covered in "
        "tests/test_models_selector.py and tests/test_workflow_e2e.py",
    "SelectedModel":
        "product of ModelSelector.fit (serde + scoring covered in "
        "tests/test_models_selector.py, tests/test_workflow_e2e.py)",
    "SelectedModelCombiner":
        "requires two upstream Prediction features; covered in "
        "tests/test_combiner.py",
    "SelectedCombinerModel":
        "product of SelectedModelCombiner.fit; covered in tests/test_combiner.py",
    "RecordInsightsLOCO":
        "requires a fitted prediction model arg; covered in tests/test_insights.py",
    "RecordInsightsCorr":
        "requires a fitted prediction model arg; covered in tests/test_insights.py",
}


_UID = re.compile(r"_[0-9a-f]{12}")


def _meta_rows(meta):
    """A vector's slot metadata without stage uids (each process numbers its
    own stages)."""
    if meta is None:
        return None
    return [_UID.sub("", repr(sorted(c.to_dict().items()))) for c in meta.columns]


def column_diff(a, b) -> float:
    """Hold output columns ``a`` and ``b`` (of either package, or of the card
    and the CPU) to one type, layout, mask and slot metadata; the largest
    absolute difference of their values (0.0 for equal host values; a
    mismatch of anything else raises ``AssertionError``)."""
    assert a.ftype.__name__ == b.ftype.__name__, (a.ftype, b.ftype)
    assert len(a) == len(b), (len(a), len(b))
    if hasattr(a, "pred") or hasattr(b, "pred"):
        diffs = []
        for k in ("pred", "raw", "prob"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is not None:
                assert x.shape == y.shape, (k, x.shape, y.shape)
                diffs.append(float(np.max(np.abs(x - y), initial=0.0)))
        return max(diffs)
    if a.data.dtype == object or b.data.dtype == object:
        va, vb = a.to_values(), b.to_values()
        for i, (x, y) in enumerate(zip(va, vb)):
            assert x == y, f"row {i}: {x!r} != {y!r}"
        return 0.0
    assert a.data.shape == b.data.shape, (a.data.shape, b.data.shape)
    assert _meta_rows(a.meta) == _meta_rows(b.meta), "slot metadata differ"
    pa, pb = a.present(), b.present()
    np.testing.assert_array_equal(pa, pb)
    x = np.asarray(a.data, dtype=np.float64)[pa]
    y = np.asarray(b.data, dtype=np.float64)[pb]
    np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
    same = (x == y) | np.isnan(x)  # equal infinities differ by nothing
    return float(np.max(np.abs(x[~same] - y[~same]), initial=0.0))
