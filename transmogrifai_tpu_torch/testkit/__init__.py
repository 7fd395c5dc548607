"""testkit — fixtures, random typed-data generators, shared behavior specs
(counterpart of ``transmogrifai_tpu/testkit/``, host only).

Reference: testkit module (TestFeatureBuilder, RandomReal/RandomText/..., SURVEY §2.14)
and the shared spec pattern OpTransformerSpec/OpEstimatorSpec (SURVEY §4) that every
stage suite extends.
"""

from .builder import TestFeatureBuilder
from .random_data import (
    RandomBinary,
    RandomIntegral,
    RandomList,
    RandomMap,
    RandomMultiPickList,
    RandomPickList,
    RandomReal,
    RandomText,
    RandomVector,
)
from .specs import assert_estimator_spec, assert_transformer_spec

__all__ = [
    "TestFeatureBuilder",
    "RandomReal",
    "RandomIntegral",
    "RandomBinary",
    "RandomText",
    "RandomPickList",
    "RandomMultiPickList",
    "RandomList",
    "RandomMap",
    "RandomVector",
    "assert_estimator_spec",
    "assert_transformer_spec",
]
