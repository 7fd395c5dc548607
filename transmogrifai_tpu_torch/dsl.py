"""Feature DSL shortcuts the ported stages back (counterpart of the parts of
``transmogrifai_tpu/dsl.py`` that reach them).

Importing this module (the package ``__init__`` does) attaches the methods
to :class:`~.features.feature.Feature`, as the reference attaches them:

- arithmetic: ``a + b``, ``a - b``, ``a * b``, ``a / b`` with a feature or
  a number (``ops/math.py``);
- numeric: ``fill_missing_with_mean()``, ``z_normalize()``,
  ``bucketize(splits)``, ``auto_bucketize(label)``, ``scale()``,
  ``descale(scaled)``;
- categorical: ``pivot()``, ``indexed()`` (StringIndexer);
- values: ``map_to(fn, type)``, ``alias(name)``, ``to_occur()``,
  ``exists(predicate)``, ``filter_values(predicate, default)``,
  ``replace_with(old, new)``;
- the label: ``label.sanity_check(vector)``.

``transmogrify(features)`` and ``combine(vectors)`` are the module's
exports.  The reference's text, NER, embedding, phone, e-mail, URL and
time-period shortcuts whose stages are not ported yet are attached too:
each raises ``NotImplementedError`` naming its stage when called.  The
type-dispatched ``vectorize`` and the shortcuts over the ported families
(``smart_vectorize``, ``to_unit_circle``, ``is_substring``) are not
attached yet.
"""

from __future__ import annotations

import numbers
from typing import Callable, Optional, Sequence, Type

from .checkers.sanity import SanityChecker
from .features.feature import Feature
from .ops.bucketizers import DecisionTreeNumericBucketizer
from .ops.math import AliasTransformer, BinaryMathTransformer, ScalarMathTransformer
from .ops.onehot import OneHotVectorizer
from .ops.scalers import FillMissingWithMean, NumericBucketizer, StandardScaler
from .ops.transmogrifier import transmogrify
from .stages.base import UnaryLambdaTransformer
from .types import FeatureType


def _binary_op(op: str):
    def method(self: Feature, other):
        if isinstance(other, Feature):
            return self.transform_with(BinaryMathTransformer(op=op), other)
        if isinstance(other, numbers.Number):
            return self.transform_with(ScalarMathTransformer(op=op, scalar=float(other)))
        return NotImplemented

    return method


def _pivot(self: Feature, top_k: int = 20, min_support: int = 10) -> Feature:
    return self.transform_with(OneHotVectorizer(top_k=top_k, min_support=min_support))


def _fill_missing_with_mean(self: Feature, default: float = 0.0) -> Feature:
    return self.transform_with(FillMissingWithMean(default_value=default))


def _z_normalize(self: Feature) -> Feature:
    return self.transform_with(StandardScaler())


def _bucketize(self: Feature, splits: Sequence[float], track_nulls: bool = True) -> Feature:
    """Fixed-split left-closed buckets (reference RichNumericFeature.bucketize)."""
    return self.transform_with(
        NumericBucketizer(splits=tuple(splits), track_nulls=track_nulls))


def _auto_bucketize(self: Feature, label: Feature, track_nulls: bool = True,
                    track_invalid: bool = False, min_info_gain: float = 0.01) -> Feature:
    """Label-aware bucketing (reference RichNumericFeature.autoBucketize)."""
    return label.transform_with(
        DecisionTreeNumericBucketizer(
            track_nulls=track_nulls, track_invalid=track_invalid,
            min_info_gain=min_info_gain),
        self)


def _map_to(self: Feature, fn: Callable, output_type: Type[FeatureType],
            name: Optional[str] = None) -> Feature:
    """Apply a per-value function (reference ``feature.map[T](fn)``)."""
    t = UnaryLambdaTransformer(
        fn=fn, input_type=self.ftype, output_type=output_type,
        operation_name=name or "map",
    )
    return self.transform_with(t)


def _alias(self: Feature, name: str) -> Feature:
    return self.transform_with(AliasTransformer(name=name))


def _sanity_check(self: Feature, features: Feature, **params) -> Feature:
    """label.sanity_check(feature_vector) — reference RichNumericFeature.sanityCheck."""
    if not self.is_response:
        raise ValueError("sanity_check must be called on the response (label) feature")
    return self.transform_with(SanityChecker(**params), features)


def _indexed(self: Feature, **kw) -> Feature:
    """Text-like -> RealNN label index (RichTextFeature.indexed)."""
    from .ops.onehot import StringIndexer

    return self.transform_with(StringIndexer(**kw))


def _scale(self: Feature, **kw) -> Feature:
    from .ops.misc import ScalerTransformer

    return self.transform_with(ScalerTransformer(**kw))


def _descale(self: Feature, scaled: Feature) -> Feature:
    """Invert the scaling applied to ``scaled`` (RichMapFeature.descale)."""
    from .ops.misc import DescalerTransformer

    return self.transform_with(DescalerTransformer(), scaled)


def _to_occur(self: Feature, match_fn=None) -> Feature:
    from .ops.misc import ToOccurTransformer

    return self.transform_with(
        ToOccurTransformer(match_fn=match_fn, input_type=self.ftype))


def _exists(self: Feature, predicate) -> Feature:
    from .ops.misc import ExistsTransformer

    return self.transform_with(
        ExistsTransformer(predicate=predicate, input_type=self.ftype))


def _filter_values(self: Feature, predicate, default) -> Feature:
    from .ops.misc import FilterTransformer

    return self.transform_with(FilterTransformer(
        predicate=predicate, default=default, input_type=self.ftype))


def _replace_with(self: Feature, old_value, new_value) -> Feature:
    from .ops.misc import ReplaceTransformer

    return self.transform_with(ReplaceTransformer(
        input_type=self.ftype, old_value=old_value, new_value=new_value))


def _unported(stage: str):
    def method(self: Feature, *args, **kwargs):
        raise NotImplementedError(
            f"{stage} is not ported to transmogrifai_tpu_torch yet")

    return method


#: the reference's shortcuts whose stages are not ported yet
UNPORTED_SHORTCUTS = {
    "tokenize": "TextTokenizer",
    "name_entity_tags": "NameEntityRecognizer",
    "word2vec": "Word2Vec",
    "lda_topics": "LDA",
    "filter_keys": "FilterMap",
    "to_time_period": "TimePeriodTransformer",
    "to_ngram_similarity": "NGramSimilarity",
    "jaccard_similarity": "JaccardSimilarity",
    "detect_languages": "LanguageDetector",
    "parse_phone": "ParsePhoneNumber",
    "is_valid_phone": "IsValidPhoneNumber",
    "to_email_prefix": "ops.domains.email_prefix",
    "to_email_domain": "ops.domains.email_domain",
    "is_valid_email": "ValidEmailTransformer",
    "to_domain": "UrlToDomainTransformer",
    "to_protocol": "ops.domains.url_protocol",
    "is_valid_url": "ValidUrlTransformer",
    "detect_mime_types": "MimeTypeDetector",
}


def combine(features: Sequence[Feature], name: str = "combined") -> Feature:
    """Concatenate OPVector features (reference ``Seq(...).combine()``)."""
    from .ops.combiner import VectorsCombiner

    if not features:
        raise ValueError("combine needs at least one feature")
    return features[0].transform_with(
        VectorsCombiner(operation_name=name), *features[1:])


Feature.__add__ = _binary_op("plus")
Feature.__sub__ = _binary_op("minus")
Feature.__mul__ = _binary_op("multiply")
Feature.__truediv__ = _binary_op("divide")
Feature.pivot = _pivot
Feature.fill_missing_with_mean = _fill_missing_with_mean
Feature.z_normalize = _z_normalize
Feature.bucketize = _bucketize
Feature.auto_bucketize = _auto_bucketize
Feature.map_to = _map_to
Feature.alias = _alias
Feature.sanity_check = _sanity_check
Feature.indexed = _indexed
Feature.scale = _scale
Feature.descale = _descale
Feature.to_occur = _to_occur
Feature.exists = _exists
Feature.filter_values = _filter_values
Feature.replace_with = _replace_with
for _name, _stage in UNPORTED_SHORTCUTS.items():
    setattr(Feature, _name, _unported(_stage))
del _name, _stage

__all__ = ["transmogrify", "combine"]
