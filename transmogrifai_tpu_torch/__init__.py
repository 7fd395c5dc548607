"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

The JAX package beside it is the reference.  This package imports torch and
numpy, never JAX and nothing of ``transmogrifai_tpu``.  Its first slice serves
a model the reference trained and saved: ``WorkflowModel.load(path)``, then
``model.serving_plan()`` (on the CUDA card unless ``device`` says otherwise)
and ``plan.score(records)``.  The serving prefix's one-hot and bucketize
kernels are hand-written CUDA (``perf/kernels/csrc/encode.cu``).
"""

__version__ = "0.1.0"

from .serve.plan import CompiledScoringPlan  # noqa: F401
from .workflow.serde import load_model  # noqa: F401
from .workflow.workflow import WorkflowModel  # noqa: F401

__all__ = ["CompiledScoringPlan", "WorkflowModel", "load_model"]
