"""Feature type system (45 types).  Reference: features/.../types/ package.

Includes the implicit-conversion equivalents of the reference ``types/package.scala``
(``to_real``, ``to_text``, …) as plain functions.
"""

from .base import (
    ColumnKind,
    FeatureType,
    FeatureTypeError,
    NonNullableEmptyException,
    NonNullable,
    Categorical,
    SingleResponse,
    MultiResponse,
    Location,
    feature_type_by_name,
    all_feature_types,
    is_feature_type_name,
)
from .numerics import (
    OPNumeric,
    Real,
    RealNN,
    Currency,
    Percent,
    Integral,
    Date,
    DateTime,
    Binary,
)
from .text import (
    Text,
    TextArea,
    Email,
    URL,
    Phone,
    ID,
    Base64,
    PickList,
    ComboBox,
    Country,
    State,
    City,
    PostalCode,
    Street,
)
from .collections import (
    OPCollection,
    OPList,
    OPSet,
    TextList,
    DateList,
    DateTimeList,
    MultiPickList,
    Geolocation,
    OPVector,
)
from .maps import (
    OPMap,
    TextMap,
    TextAreaMap,
    EmailMap,
    URLMap,
    PhoneMap,
    IDMap,
    PickListMap,
    ComboBoxMap,
    Base64Map,
    CountryMap,
    StateMap,
    CityMap,
    PostalCodeMap,
    StreetMap,
    RealMap,
    CurrencyMap,
    PercentMap,
    IntegralMap,
    DateMap,
    DateTimeMap,
    BinaryMap,
    MultiPickListMap,
    GeolocationMap,
    Prediction,
)


# --- conversion helpers (package.scala equivalents) -------------------------

def to_real(v) -> Real:
    return Real(v)


def to_real_nn(v) -> RealNN:
    return RealNN(v)


def to_integral(v) -> Integral:
    return Integral(v)


def to_binary(v) -> Binary:
    return Binary(v)


def to_text(v) -> Text:
    return Text(v)


def to_picklist(v) -> PickList:
    return PickList(v)


def to_multi_picklist(v) -> MultiPickList:
    return MultiPickList(v)


import types as _types_mod

__all__ = [
    n for n in dir()
    if not n.startswith("_") and not isinstance(globals()[n], _types_mod.ModuleType)
]
del _types_mod
