"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

The JAX package beside it is the reference.  This package imports torch and
numpy, never JAX and nothing of ``transmogrifai_tpu``.  It trains from raw
typed columns as the reference does: ``transmogrify(features)`` vectorizes
them (numeric fills and null indicators, categorical pivots, label-aware
bucketizers; free text pivoted or murmur3-hashed, dates on the unit circle,
date lists, text lists, multi-pick lists and geolocations; not the typed
maps), ``label.sanity_check(vector)`` drops low-signal and leaky
slots, and ``label.transform_with(BinaryClassificationModelSelector
.with_cross_validation(), checked)`` selects among the reference's default
families (LogisticRegression, RandomForest, GBT, LinearSVC) or the ones a
caller names; ``RegressionModelSelector`` (LinearRegression, RandomForest,
GBT, GLM) and ``MultiClassificationModelSelector`` (multinomial
LogisticRegression, RandomForest, DecisionTree, NaiveBayes) select for the
other two problem types, by k-fold CV or ``with_train_validation_split``;
``Workflow().set_input_dataset(ds).set_result_features(label,
pred).train()`` fits it all on the CUDA card unless ``device`` says
otherwise (``train(test_fraction=)`` holds rows out and evaluates them),
each run of fitted stages between two fits transformed over the whole table
on the card.  It saves (``model.save(path)``) and loads
(``WorkflowModel.load(path)``) models in the reference's format, either
package's, scores them (``model.score``, ``model.evaluate``) and serves
them: ``model.serving_plan()`` and ``plan.score(records)`` for batches,
``model.serve()`` (a :class:`ScoringServer`: micro-batching, pipelined
flushes, fault isolation, blue/green swap) for records one at a time.  The
encode kernel of the one-hot and bucketize stages
(``perf/kernels/csrc/encode.cu``) and the trees' histogram, split-scan and
routing kernels (``perf/kernels/csrc/trees.cu``) are hand-written CUDA.
"""

__version__ = "0.1.0"

from . import dsl  # noqa: F401  (attaches the feature DSL methods)
from .checkers.sanity import SanityChecker  # noqa: F401
from .data.dataset import Dataset  # noqa: F401
from .evaluators.base import Evaluators  # noqa: F401
from .features.builder import FeatureBuilder  # noqa: F401
from .models.glm import GeneralizedLinearRegression  # noqa: F401
from .models.linear import LinearRegression  # noqa: F401
from .models.logistic import LogisticRegression  # noqa: F401
from .models.naive_bayes import NaiveBayes  # noqa: F401
from .models.selector import (  # noqa: F401
    BinaryClassificationModelSelector,
    MultiClassificationModelSelector,
    RegressionModelSelector,
)
from .models.softmax import MultinomialLogisticRegression  # noqa: F401
from .models.svm import LinearSVC  # noqa: F401
from .ops.bucketizers import DecisionTreeNumericBucketizer  # noqa: F401
from .ops.combiner import VectorsCombiner  # noqa: F401
from .ops.numeric import BinaryVectorizer, NumericVectorizer, RealNNVectorizer  # noqa: F401
from .ops.onehot import OneHotVectorizer  # noqa: F401
from .ops.scalers import FillMissingWithMean, StandardScaler  # noqa: F401
from .ops.transmogrifier import transmogrify  # noqa: F401
from .serve.plan import CompiledScoringPlan  # noqa: F401
from .serve.server import ScoringServer  # noqa: F401
from .workflow.serde import load_model, save_model  # noqa: F401
from .workflow.workflow import Workflow, WorkflowModel  # noqa: F401

__all__ = ["BinaryClassificationModelSelector", "BinaryVectorizer",
           "CompiledScoringPlan", "Dataset", "DecisionTreeNumericBucketizer",
           "Evaluators", "FeatureBuilder", "FillMissingWithMean",
           "GeneralizedLinearRegression", "LinearRegression", "LinearSVC",
           "LogisticRegression", "MultiClassificationModelSelector",
           "MultinomialLogisticRegression", "NaiveBayes", "NumericVectorizer",
           "OneHotVectorizer", "RealNNVectorizer", "RegressionModelSelector",
           "SanityChecker", "ScoringServer", "StandardScaler", "VectorsCombiner",
           "Workflow", "WorkflowModel", "load_model", "save_model", "transmogrify"]
