"""Feature DSL shortcuts the ported stages back (counterpart of the parts of
``transmogrifai_tpu/dsl.py`` that reach them).

Importing this module (the package ``__init__`` does) attaches the methods
to :class:`~.features.feature.Feature`, as the reference attaches them:
``feature.pivot()``, ``fill_missing_with_mean()``, ``z_normalize()``,
``auto_bucketize(label)`` and ``label.sanity_check(vector)``;
``transmogrify(features)`` is the package's export.
"""

from __future__ import annotations

from .checkers.sanity import SanityChecker
from .features.feature import Feature
from .ops.bucketizers import DecisionTreeNumericBucketizer
from .ops.onehot import OneHotVectorizer
from .ops.scalers import FillMissingWithMean, StandardScaler
from .ops.transmogrifier import transmogrify


def _pivot(self: Feature, top_k: int = 20, min_support: int = 10) -> Feature:
    return self.transform_with(OneHotVectorizer(top_k=top_k, min_support=min_support))


def _fill_missing_with_mean(self: Feature, default: float = 0.0) -> Feature:
    return self.transform_with(FillMissingWithMean(default_value=default))


def _z_normalize(self: Feature) -> Feature:
    return self.transform_with(StandardScaler())


def _auto_bucketize(self: Feature, label: Feature, track_nulls: bool = True,
                    track_invalid: bool = False, min_info_gain: float = 0.01) -> Feature:
    """Label-aware bucketing (reference RichNumericFeature.autoBucketize)."""
    return label.transform_with(
        DecisionTreeNumericBucketizer(
            track_nulls=track_nulls, track_invalid=track_invalid,
            min_info_gain=min_info_gain),
        self)


def _sanity_check(self: Feature, features: Feature, **params) -> Feature:
    """label.sanity_check(feature_vector) — reference RichNumericFeature.sanityCheck."""
    if not self.is_response:
        raise ValueError("sanity_check must be called on the response (label) feature")
    return self.transform_with(SanityChecker(**params), features)


Feature.pivot = _pivot
Feature.fill_missing_with_mean = _fill_missing_with_mean
Feature.z_normalize = _z_normalize
Feature.auto_bucketize = _auto_bucketize
Feature.sanity_check = _sanity_check

__all__ = ["transmogrify"]
