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
- maps: ``filter_keys(white_list, black_list)`` (FilterMap);
- per type: ``vectorize(others, white_list_keys, black_list_keys, **kw)``
  (the type's vectorizer, every map kind included; key lists through
  ``filter_keys``), ``to_unit_circle(*periods)`` (a date or a date map),
  ``to_time_period(period)`` (a date, a date list or a date map),
  ``smart_vectorize()`` (SmartText), ``is_substring(other)``;
- text: ``tokenize()``, ``detect_languages()``, ``name_entity_tags()``,
  ``word2vec()``, ``lda_topics()`` (the last two on a token list),
  ``to_ngram_similarity(other)``, ``jaccard_similarity(other)`` (multi-pick
  lists);
- phone, e-mail, URL and MIME: ``parse_phone(region)``,
  ``is_valid_phone(region)``, ``to_email_prefix()``, ``to_email_domain()``,
  ``is_valid_email()``, ``to_domain()``, ``to_protocol()``,
  ``is_valid_url()``, ``detect_mime_types()``;
- the label: ``label.sanity_check(vector)``.

``transmogrify(features)`` and ``combine(vectors)`` are the module's
exports.
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


def _tokenize(self: Feature, **kw) -> Feature:
    """Text -> TextList (RichTextFeature.tokenize)."""
    from .ops.text import TextTokenizer

    return self.transform_with(TextTokenizer(**kw))


def _name_entity_tags(self: Feature) -> Feature:
    """Text -> MultiPickListMap of token -> entity types (RichTextFeature NER)."""
    from .ops.ner import NameEntityRecognizer

    return self.transform_with(NameEntityRecognizer())


def _word2vec(self: Feature, **kw) -> Feature:
    """TextList -> averaged skip-gram embedding vector (RichTextFeature.word2vec)."""
    from .ops.embeddings import Word2Vec

    return self.transform_with(Word2Vec(**kw))


def _lda_topics(self: Feature, **kw) -> Feature:
    """TextList -> LDA topic-proportion vector (RichTextFeature.lda)."""
    from .ops.embeddings import LDA

    return self.transform_with(LDA(**kw))


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


def _filter_keys(self: Feature, white_list=(), black_list=(),
                 filter_empty: bool = True) -> Feature:
    """Map -> map with key white/black-listing (RichMapFeature.filter)."""
    from .ops.collections_lift import FilterMap

    return self.transform_with(FilterMap(
        white_list_keys=tuple(white_list), black_list_keys=tuple(black_list),
        filter_empty=filter_empty))


def _vectorize(self: Feature, others: Sequence[Feature] = (),
               white_list_keys: Sequence[str] = (),
               black_list_keys: Sequence[str] = (), **kw) -> Feature:
    """Type-dispatched vectorization (RichMapFeature/RichDateFeature/...
    ``.vectorize``): ``others`` are same-typed features vectorized by the
    same stage; for maps, ``white_list_keys``/``black_list_keys`` restrict
    the keys (through ``filter_keys``); ``kw`` goes to the type's
    vectorizer.  Types without one of their own go through ``transmogrify``
    and take no ``kw``."""
    from .types import Date, DateList, Geolocation, MultiPickList, OPMap
    from .types.maps import DateMap, GeolocationMap, TextAreaMap, TextMap

    feats = [self, *list(others)]
    ftype = self.ftype
    if issubclass(ftype, OPMap):
        if white_list_keys or black_list_keys:
            feats = [f.filter_keys(white_list=white_list_keys,
                                   black_list=black_list_keys)
                     for f in feats]
        from .ops.collections_lift import DateMapToUnitCircleVectorizer
        from .ops.maps import (
            GeolocationMapVectorizer,
            NumericMapVectorizer,
            TextMapPivotVectorizer,
        )
        from .ops.text_smart import SmartTextMapVectorizer
        from .types.maps import _SetMap, _StringMap

        if issubclass(ftype, DateMap):
            stage = DateMapToUnitCircleVectorizer(**kw)
        elif issubclass(ftype, GeolocationMap):
            stage = GeolocationMapVectorizer(**kw)
        elif issubclass(ftype, (TextMap, TextAreaMap)):
            stage = SmartTextMapVectorizer(**kw)
        elif issubclass(ftype, (_StringMap, _SetMap)):
            stage = TextMapPivotVectorizer(**kw)
        else:
            stage = NumericMapVectorizer(**kw)
        return feats[0].transform_with(stage, *feats[1:])
    if white_list_keys or black_list_keys:
        raise TypeError("key white/black lists only apply to map features")
    if issubclass(ftype, DateList):
        from .ops.dates import DateListVectorizer

        return feats[0].transform_with(DateListVectorizer(**kw), *feats[1:])
    if issubclass(ftype, Date):
        from .ops.dates import DateToUnitCircleVectorizer

        return feats[0].transform_with(DateToUnitCircleVectorizer(**kw), *feats[1:])
    if issubclass(ftype, MultiPickList):
        from .ops.onehot import MultiPickListVectorizer

        return feats[0].transform_with(MultiPickListVectorizer(**kw), *feats[1:])
    if issubclass(ftype, Geolocation):
        from .ops.geo import GeolocationVectorizer

        return feats[0].transform_with(GeolocationVectorizer(**kw), *feats[1:])
    if kw:
        raise TypeError(
            f"vectorize options {sorted(kw)} unsupported for "
            f"{ftype.__name__}; use the type's vectorizer stage directly")
    return transmogrify(feats)


def _to_unit_circle(self: Feature, *periods: str,
                    others: Sequence[Feature] = ()) -> Feature:
    """Date/DateMap -> (cos, sin) unit-circle encoding per time period."""
    from .ops.collections_lift import DateMapToUnitCircleVectorizer
    from .ops.dates import DateToUnitCircleVectorizer
    from .types.maps import DateMap

    kw = {"time_periods": list(periods)} if periods else {}
    cls = (DateMapToUnitCircleVectorizer if issubclass(self.ftype, DateMap)
           else DateToUnitCircleVectorizer)
    return self.transform_with(cls(**kw), *others)


def _to_time_period(self: Feature, period: str) -> Feature:
    """Date/DateList/DateMap -> extracted calendar field (toTimePeriod)."""
    from .ops.dates import (
        TimePeriodListTransformer,
        TimePeriodMapTransformer,
        TimePeriodTransformer,
    )
    from .types import DateList
    from .types.maps import DateMap

    if issubclass(self.ftype, DateMap):
        stage = TimePeriodMapTransformer(period=period)
    elif issubclass(self.ftype, DateList):
        stage = TimePeriodListTransformer(period=period)
    else:
        stage = TimePeriodTransformer(period=period)
    return self.transform_with(stage)


def _to_ngram_similarity(self: Feature, other: Feature, n: int = 3) -> Feature:
    from .ops.text import NGramSimilarity

    return self.transform_with(NGramSimilarity(n=n), other)


def _jaccard_similarity(self: Feature, other: Feature) -> Feature:
    from .ops.text import JaccardSimilarity

    return self.transform_with(JaccardSimilarity(), other)


def _smart_vectorize(self: Feature, others: Sequence[Feature] = (),
                     **kw) -> Feature:
    from .ops.text_smart import SmartTextVectorizer

    return self.transform_with(SmartTextVectorizer(**kw), *others)


def _detect_languages(self: Feature) -> Feature:
    """Text -> RealMap of language confidences (RichTextFeature.detectLanguages)."""
    from .ops.text import LanguageDetector

    return self.transform_with(LanguageDetector())


def _is_substring(self: Feature, other: Feature) -> Feature:
    """self a substring of other -> Binary (RichTextFeature.isSubstring)."""
    from .ops.misc import SubstringTransformer

    return self.transform_with(SubstringTransformer(), other)


# -- phone (RichTextFeature.scala:451-544) ----------------------------------

def _parse_phone(self: Feature, region: Optional[Feature] = None,
                 **kw) -> Feature:
    from .ops.phone import ParsePhoneDefaultCountry, ParsePhoneNumber

    if region is not None:
        return self.transform_with(ParsePhoneNumber(**kw), region)
    return self.transform_with(ParsePhoneDefaultCountry(**kw))


def _is_valid_phone(self: Feature, region: Optional[Feature] = None,
                    **kw) -> Feature:
    from .ops.phone import IsValidPhoneDefaultCountry, IsValidPhoneNumber

    if region is not None:
        return self.transform_with(IsValidPhoneNumber(**kw), region)
    return self.transform_with(IsValidPhoneDefaultCountry(**kw))


# -- email / url / base64 (RichTextFeature.scala:565-687) -------------------

def _to_email_prefix(self: Feature) -> Feature:
    from .ops.domains import email_prefix
    from .types import Text

    return self.map_to(email_prefix, Text, name="emailPrefix")


def _to_email_domain(self: Feature) -> Feature:
    from .ops.domains import email_domain
    from .types import Text

    return self.map_to(email_domain, Text, name="emailDomain")


def _is_valid_email(self: Feature) -> Feature:
    from .ops.domains import ValidEmailTransformer

    return self.transform_with(ValidEmailTransformer())


def _to_domain(self: Feature) -> Feature:
    from .ops.domains import UrlToDomainTransformer

    return self.transform_with(UrlToDomainTransformer())


def _to_protocol(self: Feature) -> Feature:
    from .ops.domains import url_protocol
    from .types import Text

    return self.map_to(url_protocol, Text, name="urlProtocol")


def _is_valid_url(self: Feature) -> Feature:
    from .ops.domains import ValidUrlTransformer

    return self.transform_with(ValidUrlTransformer())


def _detect_mime_types(self: Feature) -> Feature:
    from .ops.domains import MimeTypeDetector

    return self.transform_with(MimeTypeDetector())


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
Feature.filter_keys = _filter_keys
Feature.vectorize = _vectorize
Feature.to_unit_circle = _to_unit_circle
Feature.smart_vectorize = _smart_vectorize
Feature.is_substring = _is_substring
Feature.tokenize = _tokenize
Feature.name_entity_tags = _name_entity_tags
Feature.word2vec = _word2vec
Feature.lda_topics = _lda_topics
Feature.to_time_period = _to_time_period
Feature.to_ngram_similarity = _to_ngram_similarity
Feature.jaccard_similarity = _jaccard_similarity
Feature.detect_languages = _detect_languages
Feature.parse_phone = _parse_phone
Feature.is_valid_phone = _is_valid_phone
Feature.to_email_prefix = _to_email_prefix
Feature.to_email_domain = _to_email_domain
Feature.is_valid_email = _is_valid_email
Feature.to_domain = _to_domain
Feature.to_protocol = _to_protocol
Feature.is_valid_url = _is_valid_url
Feature.detect_mime_types = _detect_mime_types

__all__ = ["transmogrify", "combine"]
