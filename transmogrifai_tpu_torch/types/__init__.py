"""Feature types of the ported slices: the numerics and dates (Real, RealNN,
Integral, Binary, Date, ...), the text types (Text and its free-form
subtypes, PickList, ComboBox and the location texts), the collections
(TextList, DateList, MultiPickList, Geolocation, OPVector), Prediction and
their abstract bases.  The typed maps other than Prediction are not ported:
transmogrify has no vectorizer for them yet."""

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
from .maps import OPMap, Prediction  # noqa: F401
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
