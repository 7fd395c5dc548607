"""Feature types of the ported slices: the numerics (Real, RealNN, Integral,
Binary, ...), the categorical text types (PickList, ComboBox and the
location texts), OPVector and Prediction (plus their abstract bases).  Dates,
free text, collections other than OPVector, geolocations and the typed maps
are not ported: transmogrify has no vectorizer for them yet."""

from .base import (  # noqa: F401
    ColumnKind,
    FeatureType,
    FeatureTypeError,
    NonNullableEmptyException,
    feature_type_by_name,
)
from .collections import OPCollection, OPVector  # noqa: F401
from .maps import OPMap, Prediction  # noqa: F401
from .numerics import (  # noqa: F401
    Binary,
    Currency,
    Integral,
    OPNumeric,
    Percent,
    Real,
    RealNN,
)
from .text import (  # noqa: F401
    City,
    ComboBox,
    Country,
    PickList,
    PostalCode,
    State,
    Street,
    Text,
)
