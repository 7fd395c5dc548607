"""Feature types of the ported slices: the numerics and dates (Real, RealNN,
Integral, Binary, Date, ...), the text types (Text and its free-form
subtypes, PickList, ComboBox and the location texts), the collections
(TextList, DateList, MultiPickList, Geolocation, OPVector), Prediction and
the 23 typed maps, their abstract bases, and the conversion helpers
``to_real`` ... ``to_multi_picklist`` (the reference's
``types/package.scala`` implicits as plain functions)."""

from .base import (  # noqa: F401
    Categorical,
    ColumnKind,
    FeatureType,
    FeatureTypeError,
    Location,
    MultiResponse,
    NonNullable,
    NonNullableEmptyException,
    SingleResponse,
    feature_type_by_name,
)
from .collections import (  # noqa: F401
    DateList,
    DateTimeList,
    Geolocation,
    MultiPickList,
    OPCollection,
    OPList,
    OPSet,
    OPVector,
    TextList,
)
from .maps import (  # noqa: F401
    Base64Map,
    BinaryMap,
    CityMap,
    ComboBoxMap,
    CountryMap,
    CurrencyMap,
    DateMap,
    DateTimeMap,
    EmailMap,
    GeolocationMap,
    IDMap,
    IntegralMap,
    MultiPickListMap,
    OPMap,
    PercentMap,
    PhoneMap,
    PickListMap,
    PostalCodeMap,
    Prediction,
    RealMap,
    StateMap,
    StreetMap,
    TextAreaMap,
    TextMap,
    URLMap,
)
from .numerics import (  # noqa: F401
    Binary,
    Currency,
    Date,
    DateTime,
    Integral,
    OPNumeric,
    Percent,
    Real,
    RealNN,
)
from .text import (  # noqa: F401
    ID,
    URL,
    Base64,
    City,
    ComboBox,
    Country,
    Email,
    Phone,
    PickList,
    PostalCode,
    State,
    Street,
    Text,
    TextArea,
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
