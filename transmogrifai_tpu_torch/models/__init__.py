"""Model library: estimators over (label RealNN, features OPVector) ->
Prediction (counterpart of ``transmogrifai_tpu/models/__init__.py``, the
same registry of names).

Exports resolve lazily (PEP 562), so importing one submodule (the
evaluators import ``models.prediction``) does not import every family.
"""

_EXPORTS = {
    "PredictionEstimatorBase": ".base",
    "PredictionModelBase": ".base",
    "PredictionColumn": ".prediction",
    "LinearRegression": ".linear",
    "LinearRegressionModel": ".linear",
    "LogisticRegression": ".logistic",
    "LogisticRegressionModel": ".logistic",
    "MultinomialLogisticRegression": ".softmax",
    "MultinomialLogisticRegressionModel": ".softmax",
    "GeneralizedLinearRegression": ".glm",
    "GLMModel": ".glm",
    "NaiveBayes": ".naive_bayes",
    "NaiveBayesModel": ".naive_bayes",
    "LinearSVC": ".svm",
    "LinearSVCModel": ".svm",
    "MultilayerPerceptronClassifier": ".mlp",
    "MLPClassifierModel": ".mlp",
    "IsotonicRegressionCalibrator": ".isotonic",
    "IsotonicCalibratorModel": ".isotonic",
    "DecisionTreeClassifier": ".trees",
    "DecisionTreeRegressor": ".trees",
    "GradientBoostedTreesClassifier": ".trees",
    "GradientBoostedTreesRegressor": ".trees",
    "RandomForestClassifier": ".trees",
    "RandomForestRegressor": ".trees",
    "XGBoostClassifier": ".trees",
    "XGBoostRegressor": ".trees",
    "ModelSelector": ".selector",
    "ModelSelectorSummary": ".selector",
    "SelectedModel": ".selector",
    "BinaryClassificationModelSelector": ".selector",
    "MultiClassificationModelSelector": ".selector",
    "RegressionModelSelector": ".selector",
    "RandomParamBuilder": ".random_param",
    "SelectedModelCombiner": ".combiner",
    "SelectedCombinerModel": ".combiner",
    "CrossValidator": ".tuning",
    "TrainValidationSplit": ".tuning",
    "DataSplitter": ".tuning",
    "DataBalancer": ".tuning",
    "DataCutter": ".tuning",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod, __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
