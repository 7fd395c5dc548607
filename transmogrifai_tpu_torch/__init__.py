"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

The JAX package beside it is the reference.  This package imports torch and
numpy, never JAX and nothing of ``transmogrifai_tpu``.  It serves a model the
reference trained and saved: ``WorkflowModel.load(path)``, then
``model.serving_plan()`` (on the CUDA card unless ``device`` says otherwise)
and ``plan.score(records)``.  It trains tree model selection:
``label.transform_with(BinaryClassificationModelSelector.with_cross_validation(
models=[...]), vector)`` and ``Workflow().set_input_dataset(ds)
.set_result_features(label, pred).train()``.  The serving prefix's one-hot and
bucketize kernels (``perf/kernels/csrc/encode.cu``) and the trees' histogram,
split-scan and routing kernels (``perf/kernels/csrc/trees.cu``) are
hand-written CUDA.
"""

__version__ = "0.1.0"

from .features.builder import FeatureBuilder  # noqa: F401
from .models.selector import BinaryClassificationModelSelector  # noqa: F401
from .serve.plan import CompiledScoringPlan  # noqa: F401
from .workflow.serde import load_model  # noqa: F401
from .workflow.workflow import Workflow, WorkflowModel  # noqa: F401

__all__ = ["BinaryClassificationModelSelector", "CompiledScoringPlan",
           "FeatureBuilder", "Workflow", "WorkflowModel", "load_model"]
