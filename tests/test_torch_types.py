"""Feature type system tests.  Mirrors reference FeatureTypeTest coverage (SURVEY §2.1).

The JAX package's ``tests/test_types.py`` with its import swapped to the port
(``transmogrifai_tpu_torch``): the port's copies of the host-only core
modules must pass the reference's own tests.
"""

import numpy as np
import pytest

from transmogrifai_tpu_torch.types import (
    Binary,
    ColumnKind,
    Currency,
    Date,
    DateList,
    DateTime,
    Email,
    FeatureTypeError,
    Geolocation,
    ID,
    Integral,
    MultiPickList,
    MultiPickListMap,
    NonNullableEmptyException,
    OPVector,
    Percent,
    PickList,
    Prediction,
    Real,
    RealMap,
    RealNN,
    Text,
    TextList,
    TextMap,
    all_feature_types,
    feature_type_by_name,
)


class TestRegistry:
    def test_45_plus_types_registered(self):
        # reference registry has 45 value types + Prediction etc (FeatureType.scala:265-324)
        assert len(all_feature_types()) >= 45

    def test_lookup_by_name(self):
        assert feature_type_by_name("Real") is Real
        assert feature_type_by_name("MultiPickListMap") is MultiPickListMap
        with pytest.raises(FeatureTypeError):
            feature_type_by_name("NotAType")


class TestNumerics:
    def test_real(self):
        assert Real(1.5).value == 1.5
        assert Real(None).is_empty
        assert Real(3).value == 3.0
        with pytest.raises(FeatureTypeError):
            Real("abc")

    def test_realnn_non_nullable(self):
        assert RealNN(2.0).value == 2.0
        with pytest.raises(NonNullableEmptyException):
            RealNN(None)

    def test_integral_rejects_float(self):
        assert Integral(7).value == 7
        with pytest.raises(FeatureTypeError):
            Integral(7.5)

    def test_binary(self):
        assert Binary(True).value is True
        assert Binary(0).value is False
        assert Binary(None).is_empty
        with pytest.raises(FeatureTypeError):
            Binary(2)

    def test_subtyping(self):
        assert issubclass(Currency, Real)
        assert issubclass(Percent, Real)
        assert issubclass(DateTime, Date)
        assert issubclass(Date, Integral)
        assert RealNN.is_subtype_of(Real)

    def test_equality(self):
        assert Real(1.0) == Real(1.0)
        assert Real(1.0) != RealNN(1.0)  # different types are not equal
        assert hash(Real(2.0)) == hash(Real(2.0))


class TestText:
    def test_text(self):
        assert Text("hi").value == "hi"
        assert Text(None).is_empty
        assert Text("").is_empty

    def test_email_parts(self):
        e = Email("ada@example.com")
        assert e.prefix == "ada"
        assert e.domain == "example.com"
        assert Email("not-an-email").prefix is None

    def test_picklist_categorical(self):
        assert PickList.is_categorical
        assert not Text.is_categorical
        assert ID("x").value == "x"


class TestCollections:
    def test_text_list(self):
        assert TextList(["a", "b"]).value == ["a", "b"]
        assert TextList(None).is_empty
        with pytest.raises(FeatureTypeError):
            TextList("abc")

    def test_multipicklist(self):
        assert MultiPickList({"a", "b"}).value == {"a", "b"}
        assert MultiPickList(["a", "a"]).value == {"a"}

    def test_date_list(self):
        assert DateList([1, 2]).value == [1, 2]
        with pytest.raises(FeatureTypeError):
            DateList([1.5])

    def test_geolocation(self):
        g = Geolocation([37.77, -122.42, 5])
        assert g.lat == 37.77 and g.lon == -122.42 and g.accuracy == 5.0
        assert Geolocation(None).is_empty
        with pytest.raises(FeatureTypeError):
            Geolocation([95.0, 0.0, 1.0])
        sphere = g.to_unit_sphere()
        assert np.isclose(np.linalg.norm(sphere), 1.0)

    def test_vector(self):
        v = OPVector([1.0, 2.0])
        assert v.value.dtype == np.float32
        assert OPVector([1.0, 2.0]) == OPVector([1.0, 2.0])
        assert OPVector(None).is_empty


class TestMaps:
    def test_text_map(self):
        assert TextMap({"a": "x"}).value == {"a": "x"}
        with pytest.raises(FeatureTypeError):
            TextMap({"a": 1})

    def test_real_map(self):
        assert RealMap({"a": 1}).value == {"a": 1.0}
        assert RealMap(None).is_empty

    def test_prediction(self):
        p = Prediction.make(1.0, raw_prediction=[0.2, 0.8], probability=[0.3, 0.7])
        assert p.prediction == 1.0
        assert p.raw_prediction == [0.2, 0.8]
        assert p.probability == [0.3, 0.7]
        assert p.score() == 0.7
        with pytest.raises(FeatureTypeError):
            Prediction({"bogus": 1.0})
        with pytest.raises(FeatureTypeError):
            Prediction({"prediction": 1.0, "junk": 2.0})


class TestColumnKinds:
    def test_kinds(self):
        assert Real.kind is ColumnKind.FLOAT
        assert Integral.kind is ColumnKind.INT
        assert Binary.kind is ColumnKind.BOOL
        assert Text.kind is ColumnKind.TEXT
        assert TextList.kind is ColumnKind.TEXT_LIST
        assert MultiPickList.kind is ColumnKind.TEXT_SET
        assert RealMap.kind is ColumnKind.MAP
        assert Geolocation.kind is ColumnKind.GEO
        assert OPVector.kind is ColumnKind.VECTOR
