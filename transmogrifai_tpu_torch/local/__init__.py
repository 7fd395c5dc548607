"""Local (engine-free) scoring (counterpart of ``transmogrifai_tpu/local``).

Reference: local/.../OpWorkflowModelLocal.scala:93-200 (``scoreFunction:
Map[String,Any] => Map[String,Any]``), MLeapModelConverter.
:func:`score_function` binds a fitted model's DAG and its transform plan
once and scores records on the card; :func:`export_standalone` writes a
numpy-only bundle that scores with no framework at all (the MLeap role).
"""

from .export import export_standalone
from .scoring import LocalScorer, score_function

__all__ = ["LocalScorer", "score_function", "export_standalone"]
