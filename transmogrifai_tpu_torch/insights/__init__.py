"""Explainability: ModelInsights and record-level insights (counterpart of
``transmogrifai_tpu/insights/``).  LOCO's re-scoring runs on the device the
caller names (the CUDA card by default); the rest is host code.
"""

from .loco import RecordInsightsCorr, RecordInsightsLOCO
from .model_insights import (
    DerivedFeatureInsight,
    FeatureInsights,
    LabelSummary,
    ModelInsights,
    extract_model_insights,
)

__all__ = [
    "DerivedFeatureInsight",
    "FeatureInsights",
    "LabelSummary",
    "ModelInsights",
    "extract_model_insights",
    "RecordInsightsLOCO",
    "RecordInsightsCorr",
]
