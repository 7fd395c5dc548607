"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

The JAX package beside it is the reference.  This package imports torch and
numpy, never JAX and nothing of ``transmogrifai_tpu``.  It trains binary
model selection over the reference's default families (LogisticRegression,
RandomForest, GBT, LinearSVC) or the ones a caller names:
``label.transform_with(BinaryClassificationModelSelector.with_cross_validation(),
vector)`` and ``Workflow().set_input_dataset(ds).set_result_features(label,
pred).train()``, on the CUDA card unless ``device`` says otherwise.  It saves
(``model.save(path)``) and loads (``WorkflowModel.load(path)``) models in the
reference's format, either package's, scores them (``model.score``,
``model.evaluate``) and serves them: ``model.serving_plan()`` and
``plan.score(records)``.  The serving prefix's one-hot and
bucketize kernels (``perf/kernels/csrc/encode.cu``) and the trees' histogram,
split-scan and routing kernels (``perf/kernels/csrc/trees.cu``) are
hand-written CUDA.
"""

__version__ = "0.1.0"

from .evaluators.base import Evaluators  # noqa: F401
from .features.builder import FeatureBuilder  # noqa: F401
from .models.logistic import LogisticRegression  # noqa: F401
from .models.selector import BinaryClassificationModelSelector  # noqa: F401
from .models.svm import LinearSVC  # noqa: F401
from .serve.plan import CompiledScoringPlan  # noqa: F401
from .workflow.serde import load_model, save_model  # noqa: F401
from .workflow.workflow import Workflow, WorkflowModel  # noqa: F401

__all__ = ["BinaryClassificationModelSelector", "CompiledScoringPlan",
           "Evaluators", "FeatureBuilder", "LinearSVC", "LogisticRegression",
           "Workflow", "WorkflowModel", "load_model", "save_model"]
