"""Feature types of the serving slice: Real, RealNN, Binary, PickList,
OPVector and Prediction (plus their abstract bases)."""

from .base import (  # noqa: F401
    ColumnKind,
    FeatureType,
    FeatureTypeError,
    NonNullableEmptyException,
    feature_type_by_name,
)
from .collections import OPCollection, OPVector  # noqa: F401
from .maps import OPMap, Prediction  # noqa: F401
from .numerics import Binary, OPNumeric, Real, RealNN  # noqa: F401
from .text import PickList, Text  # noqa: F401
