"""Raw feature filtering before the DAG is fitted (counterpart of
``transmogrifai_tpu/filters/``): per-feature distributions, their
train-vs-scoring comparison and the blacklist."""

from .distribution import FeatureDistribution, Summary, compute_distributions, js_divergence
from .raw_feature_filter import RawFeatureFilter, RawFeatureFilterResults

__all__ = [
    "FeatureDistribution",
    "Summary",
    "compute_distributions",
    "js_divergence",
    "RawFeatureFilter",
    "RawFeatureFilterResults",
]
