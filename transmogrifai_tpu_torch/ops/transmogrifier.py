"""Transmogrifier — automatic per-type default vectorization (counterpart of
``transmogrifai_tpu/ops/transmogrifier.py``).

``transmogrify(features)`` groups features by type family, applies each
family's default vectorizer, and combines everything into a single OPVector
feature with a ``VectorsCombiner``.  Families are visited in sorted order, as
in the reference, so the combined vector's columns come in the reference's
order.  Every family but ``map`` has its vectorizer in the port; a map
feature raises ``NotImplementedError`` naming the family and the reference
function it waits for.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Type

from ..features.feature import Feature
from ..types import (
    ID,
    URL,
    Base64,
    Binary,
    City,
    ComboBox,
    Country,
    Date,
    DateList,
    Email,
    FeatureType,
    Geolocation,
    Integral,
    MultiPickList,
    OPMap,
    OPVector,
    Phone,
    PickList,
    PostalCode,
    Real,
    RealNN,
    State,
    Street,
    Text,
    TextArea,
    TextList,
)
from .combiner import VectorsCombiner
from .dates import DateListVectorizer, DateToUnitCircleVectorizer
from .geo import GeolocationVectorizer
from .numeric import BinaryVectorizer, NumericVectorizer, RealNNVectorizer
from .onehot import MultiPickListVectorizer, OneHotVectorizer
from .text_lists import TextListHashingVectorizer
from .text_smart import SmartTextVectorizer

# categorical text subtypes pivot directly (reference: pivot-by-default types)
_CATEGORICAL_TEXT = (PickList, ComboBox, Country, State, City, PostalCode, Street)
# free-form text subtypes go through the smart categorical-vs-text decision
_SMART_TEXT = (TextArea, Email, URL, Phone, ID, Base64)

#: the reference's default vectorizer of each family the port does not have
UNPORTED_FAMILIES = {"map": "transmogrify_maps"}

#: family -> the stage that vectorizes it
_VECTORIZERS = {
    "realnn": RealNNVectorizer,
    "real": lambda: NumericVectorizer(fill_strategy="mean"),
    "integral": lambda: NumericVectorizer(fill_strategy="mode"),
    "binary": BinaryVectorizer,
    "date": DateToUnitCircleVectorizer,
    "categorical_text": OneHotVectorizer,
    "smart_text": SmartTextVectorizer,
    "multipicklist": MultiPickListVectorizer,
    "geolocation": GeolocationVectorizer,
    "date_list": DateListVectorizer,
    "text_list": TextListHashingVectorizer,
}


def _family(ftype: Type[FeatureType]) -> str:
    if issubclass(ftype, RealNN):
        return "realnn"
    if issubclass(ftype, Binary):
        return "binary"
    if issubclass(ftype, Date):
        return "date"
    if issubclass(ftype, Integral):
        return "integral"
    if issubclass(ftype, Real):
        return "real"
    if issubclass(ftype, _CATEGORICAL_TEXT):
        return "categorical_text"
    if issubclass(ftype, _SMART_TEXT) or ftype is Text:
        return "smart_text"
    if issubclass(ftype, MultiPickList):
        return "multipicklist"
    if issubclass(ftype, Geolocation):
        return "geolocation"
    if issubclass(ftype, DateList):
        return "date_list"
    if issubclass(ftype, TextList):
        return "text_list"
    if issubclass(ftype, OPVector):
        return "vector"
    if issubclass(ftype, OPMap):
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
        vectors.append(feats[0].transform_with(_VECTORIZERS[family](), *feats[1:]))

    if len(vectors) == 1:
        return vectors[0]
    combiner = VectorsCombiner(operation_name=combiner_name)
    return vectors[0].transform_with(combiner, *vectors[1:])
