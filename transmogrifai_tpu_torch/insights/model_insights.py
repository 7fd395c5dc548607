"""ModelInsights: per-feature insights of a fitted workflow (counterpart
of ``transmogrifai_tpu/insights/model_insights.py``, host code copied over
the port's summary dataclasses).

:func:`extract_model_insights` walks the fitted stages and joins the
SanityChecker's statistics (correlations, Cramer's V, variances) with the
selected model's coefficients or feature importances per vector slot,
grouped by the raw parent feature, plus a label summary and the model
selection's summary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.pretty import Table
from ..utils.vector_metadata import VectorMetadata


@dataclass
class LabelSummary:
    """Label distribution (ModelInsights label summary)."""

    name: str = ""
    distinct_count: int = 0
    sample_size: int = 0
    # categorical labels: value -> count; continuous: moments
    distribution: Optional[Dict[str, float]] = None
    mean: Optional[float] = None
    variance: Optional[float] = None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "distinctCount": self.distinct_count,
            "sampleSize": self.sample_size,
            "distribution": self.distribution,
            "mean": self.mean,
            "variance": self.variance,
        }


@dataclass
class DerivedFeatureInsight:
    """One vector slot: provenance + statistics + model contribution."""

    name: str
    parent_feature: str
    parent_type: str
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    descriptor_value: Optional[str] = None
    index: int = 0
    corr_label: Optional[float] = None
    cramers_v: Optional[float] = None
    variance: Optional[float] = None
    mean: Optional[float] = None
    min: Optional[float] = None
    max: Optional[float] = None
    max_rule_confidence: Optional[float] = None
    support: Optional[float] = None
    contribution: List[float] = field(default_factory=list)
    dropped_reason: Optional[str] = None

    @property
    def is_dropped(self) -> bool:
        return self.dropped_reason is not None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "parentFeature": self.parent_feature,
            "parentType": self.parent_type,
            "grouping": self.grouping,
            "indicatorValue": self.indicator_value,
            "descriptorValue": self.descriptor_value,
            "index": self.index,
            "corrLabel": self.corr_label,
            "cramersV": self.cramers_v,
            "variance": self.variance,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "maxRuleConfidence": self.max_rule_confidence,
            "support": self.support,
            "contribution": self.contribution,
            "droppedReason": self.dropped_reason,
        }


@dataclass
class FeatureInsights:
    """All derived slots of one raw feature."""

    feature_name: str
    feature_type: str
    derived: List[DerivedFeatureInsight] = field(default_factory=list)

    @property
    def max_contribution(self) -> float:
        vals = [abs(c) for d in self.derived for c in d.contribution]
        return max(vals) if vals else 0.0

    def to_dict(self) -> dict:
        return {
            "featureName": self.feature_name,
            "featureType": self.feature_type,
            "derivedFeatures": [d.to_dict() for d in self.derived],
        }


@dataclass
class ModelInsights:
    """The full insights report (ModelInsights.scala)."""

    label: LabelSummary = field(default_factory=LabelSummary)
    features: List[FeatureInsights] = field(default_factory=list)
    selected_model_info: Optional[dict] = None
    rff_results: Optional[dict] = None
    stage_info: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "label": self.label.to_dict(),
            "features": [f.to_dict() for f in self.features],
            "selectedModelInfo": self.selected_model_info,
            "rawFeatureFilterResults": self.rff_results,
            "stageInfo": self.stage_info,
        }

    def to_json(self) -> str:
        import json

        return json.dumps(self.to_dict(), indent=2, default=_json_default)

    def pretty(self, top_k: int = 15) -> str:
        """Human-readable tables (reference prettyPrint)."""
        lines = [f"Label: {self.label.name} "
                 f"(distinct={self.label.distinct_count}, n={self.label.sample_size})"]
        slots = [d for f in self.features for d in f.derived]
        contributing = sorted(
            (d for d in slots if d.contribution and not d.is_dropped),
            key=lambda d: -max(abs(c) for c in d.contribution))[:top_k]
        if contributing:
            rows = [
                (d.name, f"{max(abs(c) for c in d.contribution):.4f}",
                 "" if d.corr_label is None or not np.isfinite(d.corr_label)
                 else f"{d.corr_label:.3f}")
                for d in contributing
            ]
            lines.append("Top contributing slots:")
            lines.append(Table(("Slot", "|contribution|", "corr(label)"), rows).render())
        dropped = [d for d in slots if d.is_dropped]
        if dropped:
            rows = [(d.name, d.dropped_reason or "") for d in dropped[:top_k]]
            lines.append("Dropped slots (SanityChecker):")
            lines.append(Table(("Slot", "Reason"), rows).render())
        return "\n".join(lines)


def _json_default(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------

def _model_contributions(model, d: int) -> List[List[float]]:
    """Per-slot contribution vectors from a fitted prediction model.

    Linear family: coefficient (one per class for softmax); tree family: split-count
    feature importances (reference uses Spark featureImportances / XGBoost booster
    scores, ModelInsights.scala extract).
    """
    inner = getattr(model, "model", model)  # unwrap SelectedModel
    coef = getattr(inner, "coef", None)
    if coef is not None:
        coef = np.asarray(coef)
        if coef.ndim == 1:
            return [[float(c)] for c in coef[:d]] + [[]] * max(0, d - coef.shape[0])
        # multiclass: coef is (d_slots, k_classes) — one per-class vector per slot
        return [[float(c) for c in coef[j]] for j in range(min(d, coef.shape[0]))] \
            + [[]] * max(0, d - coef.shape[0])
    if hasattr(inner, "feature_importances"):
        imp = np.asarray(inner.feature_importances(d), dtype=np.float64)
        return [[float(v)] for v in imp[:d]]
    return [[] for _ in range(d)]


def extract_model_insights(workflow_model) -> ModelInsights:
    """Build ModelInsights from a fitted WorkflowModel (reference extractFromStages)."""
    from ..checkers.sanity import SanityCheckerModel
    from ..models.selector import SelectedModel

    sanity: Optional[SanityCheckerModel] = None
    selected: Optional[SelectedModel] = None
    for t in workflow_model.fitted.values():
        if isinstance(t, SanityCheckerModel) and sanity is None:
            sanity = t
        if isinstance(t, SelectedModel) and selected is None:
            selected = t

    # --- slot provenance: prefer the sanity checker's pre-drop metadata ------
    meta: Optional[VectorMetadata] = None
    kept_indices: Optional[List[int]] = None
    if sanity is not None and sanity.meta is not None:
        meta = sanity.meta
        kept_indices = sanity.kept_indices
    elif selected is not None and selected.feature_meta is not None:
        meta = selected.feature_meta
        kept_indices = list(range(meta.size))

    insights = ModelInsights()

    # --- label summary -------------------------------------------------------
    label_f = next((f for f in workflow_model.result_features if f.is_response), None)
    if label_f is not None:
        insights.label.name = label_f.name
    if sanity is not None and sanity.summary is not None:
        insights.label.distinct_count = sanity.summary.label_distinct
        insights.label.sample_size = sanity.summary.sample_size

    # --- per-slot insights ---------------------------------------------------
    if meta is not None:
        stats_by_name = {}
        dropped_reasons: Dict[str, str] = {}
        if sanity is not None and sanity.summary is not None:
            stats_by_name = {s.name: s for s in sanity.summary.stats}
            dropped_reasons = dict(sanity.summary.dropped)

        contribs: Dict[int, List[float]] = {}
        if selected is not None and kept_indices is not None:
            per_kept = _model_contributions(selected, len(kept_indices))
            contribs = {orig: c for orig, c in zip(kept_indices, per_kept)}

        by_parent: Dict[str, FeatureInsights] = {}
        for c in meta.columns:
            name = c.make_name()
            st = stats_by_name.get(name)
            ins = DerivedFeatureInsight(
                name=name,
                parent_feature=c.parent_feature,
                parent_type=c.parent_type,
                grouping=c.grouping,
                indicator_value=c.indicator_value,
                descriptor_value=c.descriptor_value,
                index=c.index,
                contribution=contribs.get(c.index, []),
                dropped_reason=dropped_reasons.get(name),
            )
            if st is not None:
                ins.corr_label = st.corr_label
                ins.cramers_v = st.cramers_v
                ins.variance = st.variance
                ins.mean = st.mean
                ins.min = st.min
                ins.max = st.max
                ins.max_rule_confidence = st.max_rule_confidence
                ins.support = st.support
            fi = by_parent.setdefault(
                c.parent_feature,
                FeatureInsights(feature_name=c.parent_feature,
                                feature_type=c.parent_type))
            fi.derived.append(ins)
        insights.features = list(by_parent.values())

    # --- selection + RFF summaries ------------------------------------------
    if selected is not None:
        insights.selected_model_info = selected.summary.to_dict()
    if workflow_model.rff_summary is not None:
        insights.rff_results = workflow_model.rff_summary.to_dict()

    # --- stage params (reference stageInfo) ---------------------------------
    insights.stage_info = {
        uid: {"class": type(t).__name__, "params": _safe_params(t)}
        for uid, t in workflow_model.fitted.items()
    }
    return insights


def _safe_params(stage) -> Dict[str, Any]:
    try:
        return {k: v for k, v in stage.get_params().items()
                if isinstance(v, (int, float, str, bool, type(None)))}
    except Exception:
        return {}
