"""Transmogrifier — automatic per-type default vectorization (counterpart of
``transmogrifai_tpu/ops/transmogrifier.py``).

``transmogrify(features)`` groups features by type family, applies each
family's default vectorizer, and combines everything into a single OPVector
feature with a ``VectorsCombiner``.  Families are visited in sorted order, as
in the reference, so the combined vector's columns come in the reference's
order.  The port has the vectorizers of the ``realnn``, ``real``,
``integral``, ``binary``, ``categorical_text`` and ``vector`` families; any
other family raises ``NotImplementedError`` naming the family and the
reference vectorizer it waits for.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Type

from ..features.feature import Feature
from ..types import FeatureType
from .combiner import VectorsCombiner
from .numeric import BinaryVectorizer, NumericVectorizer, RealNNVectorizer
from .onehot import OneHotVectorizer

# categorical text subtypes pivot directly (reference: pivot-by-default types)
_CATEGORICAL_TEXT = ("PickList", "ComboBox", "Country", "State", "City",
                     "PostalCode", "Street")
# free-form text subtypes go through the reference's smart text vectorizer
_SMART_TEXT = ("TextArea", "Email", "URL", "Phone", "ID", "Base64")

#: the reference's default vectorizer of each family the port does not have
UNPORTED_FAMILIES = {
    "date": "DateToUnitCircleVectorizer",
    "smart_text": "SmartTextVectorizer",
    "multipicklist": "MultiPickListVectorizer",
    "geolocation": "GeolocationVectorizer",
    "date_list": "DateListVectorizer",
    "text_list": "TextListHashingVectorizer",
    "map": "transmogrify_maps",
}


def _family(ftype: Type[FeatureType]) -> str:
    """The reference's family of ``ftype``, decided by the reference type
    names along its class hierarchy (the port lacks most of the types of
    the families it does not vectorize)."""
    names = {k.__name__ for k in ftype.__mro__}
    if "RealNN" in names:
        return "realnn"
    if "Binary" in names:
        return "binary"
    if "Date" in names:
        return "date"
    if "Integral" in names:
        return "integral"
    if "Real" in names:
        return "real"
    if names.intersection(_CATEGORICAL_TEXT):
        return "categorical_text"
    if names.intersection(_SMART_TEXT) or ftype.__name__ == "Text":
        return "smart_text"
    if "MultiPickList" in names:
        return "multipicklist"
    if "Geolocation" in names:
        return "geolocation"
    if "DateList" in names:
        return "date_list"
    if "TextList" in names:
        return "text_list"
    if "OPVector" in names:
        return "vector"
    if "OPMap" in names:
        return "map"
    raise NotImplementedError(
        f"Transmogrifier has no default vectorizer for {ftype.__name__} yet")


def transmogrify(features: Sequence[Feature], label: Feature | None = None,
                 combiner_name: str = "features") -> Feature:
    """Apply per-type default vectorization and combine into one OPVector feature."""
    groups: Dict[str, List[Feature]] = {}
    for f in features:
        groups.setdefault(_family(f.ftype), []).append(f)
    for family in sorted(groups):
        if family in UNPORTED_FAMILIES:
            raise NotImplementedError(
                f"transmogrify: the {family!r} family "
                f"({', '.join(f.name for f in groups[family])}) needs the "
                f"reference's {UNPORTED_FAMILIES[family]}, which is not ported "
                "to transmogrifai_tpu_torch yet")

    vectors: List[Feature] = []
    for family in sorted(groups):
        feats = groups[family]
        if family == "vector":
            vectors.extend(feats)
            continue
        if family == "realnn":
            stage = RealNNVectorizer()
        elif family == "real":
            stage = NumericVectorizer(fill_strategy="mean")
        elif family == "integral":
            stage = NumericVectorizer(fill_strategy="mode")
        elif family == "binary":
            stage = BinaryVectorizer()
        else:  # categorical_text
            stage = OneHotVectorizer()
        vectors.append(feats[0].transform_with(stage, *feats[1:]))

    if len(vectors) == 1:
        return vectors[0]
    combiner = VectorsCombiner(operation_name=combiner_name)
    return vectors[0].transform_with(combiner, *vectors[1:])
