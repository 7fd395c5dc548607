"""TestFeatureBuilder — typed features + Dataset from literal values
(counterpart of ``transmogrifai_tpu/testkit/builder.py``).

Reference: testkit/.../test/TestFeatureBuilder.scala: builds (features, DataFrame) from
in-memory rows so stage tests never touch readers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Type

from ..data.dataset import Dataset
from ..features.builder import FeatureBuilder
from ..features.feature import Feature
from ..types import FeatureType


class TestFeatureBuilder:
    """Build raw features and the matching Dataset from literal column values.

    >>> feats, ds = TestFeatureBuilder.build(
    ...     {"age": [1.0, None], "label": [0.0, 1.0]},
    ...     {"age": Real, "label": RealNN}, response="label")
    """

    @staticmethod
    def build(
        values: Mapping[str, Sequence[Any]],
        ftypes: Mapping[str, Type[FeatureType]],
        response: Optional[str] = None,
    ) -> Tuple[Dict[str, Feature], Dataset]:
        missing = set(values) - set(ftypes)
        if missing:
            raise KeyError(f"No feature type given for columns: {sorted(missing)}")
        features: Dict[str, Feature] = {}
        for name in values:
            b = FeatureBuilder.of(name, ftypes[name]).extract_field()
            features[name] = b.as_response() if name == response else b.as_predictor()
        ds = Dataset.from_features(values, dict(ftypes))
        return features, ds

    @staticmethod
    def of(name: str, ftype: Type[FeatureType], values: Sequence[Any],
           is_response: bool = False) -> Tuple[Feature, Dataset]:
        """Single-feature convenience (TestFeatureBuilder.apply 1-ary)."""
        feats, ds = TestFeatureBuilder.build(
            {name: values}, {name: ftype}, response=name if is_response else None)
        return feats[name], ds
