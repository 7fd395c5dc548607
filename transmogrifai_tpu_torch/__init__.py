"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

The JAX package beside it is the reference.  This package imports torch and
numpy, never JAX and nothing of ``transmogrifai_tpu``.  It trains from raw
typed columns as the reference does: ``transmogrify(features)`` vectorizes
them (numeric fills and null indicators, categorical pivots, label-aware
bucketizers; free text pivoted or murmur3-hashed, dates on the unit circle,
date lists, text lists, multi-pick lists, geolocations, and the 23 typed
maps key by key), ``label.sanity_check(vector)`` drops low-signal and leaky
slots, and ``label.transform_with(BinaryClassificationModelSelector
.with_cross_validation(), checked)`` selects among the reference's default
families (LogisticRegression, RandomForest, GBT, LinearSVC) or the ones a
caller names; ``RegressionModelSelector`` (LinearRegression, RandomForest,
GBT, GLM) and ``MultiClassificationModelSelector`` (multinomial
LogisticRegression, RandomForest, DecisionTree, NaiveBayes) select for the
other two problem types, by k-fold CV or ``with_train_validation_split``;
``Workflow().set_input_dataset(ds).set_result_features(label,
pred).train()`` fits it all on the CUDA card unless ``device`` says
otherwise (``train(test_fraction=)`` holds rows out and evaluates them;
``with_raw_feature_filter(RawFeatureFilter(...))`` first drops raw
features, or map keys, that are sparse, drift from a scoring table or leak
the label through their nulls),
each run of fitted stages between two fits transformed over the whole table
on the card.  Data comes in as a ``Dataset`` or through a reader
(``DataReaders``: CSV, Parquet, JSON lines, Avro, a DataFrame, records;
aggregate, conditional and joined readers), and ``workflow/runner.py``'s
``WorkflowRunner``/``App`` run train, score, features and evaluate the way
the reference's example apps do; the DSL's arithmetic (``a + b``,
``family_size * fare``), ``bucketize``, ``indexed`` and value shortcuts
build host stages, and ``NumericBucketizer`` a left-closed slot of the
encode kernel.  The text stack (``ops/text.py``: tokenizer, stop words,
n-grams, HashingTF, CountVectorizer, similarities, language detection; NER
in ``ops/ner.py`` with the learned en/es/nl taggers; phone, e-mail, URL and
MIME stages; the time-period stages) is host work with the reference's
outputs, and Word2Vec and LDA (``ops/embeddings.py``) train on the card,
where ``LDAModel``'s E-step also runs at transform time.  It saves (``model.save(path)``) and loads
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
from .filters import RawFeatureFilter  # noqa: F401
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
from .ops import embeddings as _embeddings  # noqa: F401  (registers Word2Vec/LDA)
from .ops import ner as _ner  # noqa: F401  (registers NameEntityRecognizer)
from .ops.combiner import VectorsCombiner  # noqa: F401
from .ops.numeric import BinaryVectorizer, NumericVectorizer, RealNNVectorizer  # noqa: F401
from .ops.onehot import OneHotVectorizer  # noqa: F401
from .ops.scalers import FillMissingWithMean, StandardScaler  # noqa: F401
from .ops.transmogrifier import transmogrify  # noqa: F401
from .readers.files import DataReaders  # noqa: F401
from .readers.joined import (  # noqa: F401
    JoinedAggregateReader,
    JoinedReader,
    JoinType,
    TimeBasedFilter,
    TimeColumn,
)
from .serve.plan import CompiledScoringPlan  # noqa: F401
from .serve.server import ScoringServer  # noqa: F401
from .workflow.serde import load_model, save_model  # noqa: F401
from .workflow.workflow import Workflow, WorkflowModel  # noqa: F401

__all__ = ["BinaryClassificationModelSelector", "BinaryVectorizer",
           "CompiledScoringPlan", "DataReaders", "Dataset",
           "DecisionTreeNumericBucketizer",
           "Evaluators", "FeatureBuilder", "FillMissingWithMean",
           "GeneralizedLinearRegression", "JoinType", "JoinedAggregateReader",
           "JoinedReader", "LinearRegression", "LinearSVC",
           "LogisticRegression", "MultiClassificationModelSelector",
           "MultinomialLogisticRegression", "NaiveBayes", "NumericVectorizer",
           "OneHotVectorizer", "RawFeatureFilter", "RealNNVectorizer",
           "RegressionModelSelector",
           "SanityChecker", "ScoringServer", "StandardScaler", "TimeBasedFilter",
           "TimeColumn", "VectorsCombiner", "Workflow", "WorkflowModel",
           "load_model", "save_model", "transmogrify"]
