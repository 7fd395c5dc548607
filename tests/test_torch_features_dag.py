"""Feature DAG, builder, stage wiring, and scheduler tests (SURVEY §2.2, §2.3).

The JAX package's ``tests/test_features_dag.py`` with its import swapped to the port
(``transmogrifai_tpu_torch``): the port's copies of the host-only core
modules must pass the reference's own tests.
"""

import numpy as np
import pytest

from transmogrifai_tpu_torch import Dataset, FeatureBuilder
from transmogrifai_tpu_torch.data.dataset import Column
from transmogrifai_tpu_torch.features.generator import FeatureGeneratorStage
from transmogrifai_tpu_torch.stages.base import (
    BinaryTransformer,
    Estimator,
    Param,
    Transformer,
    UnaryTransformer,
)
from transmogrifai_tpu_torch.types import Real, RealNN, Text
from transmogrifai_tpu_torch.workflow.dag import compute_dag, raw_feature_generators


class AddTwo(BinaryTransformer):
    input_types = (Real, Real)
    output_type = Real

    def transform_columns(self, cols, dataset):
        a, b = cols[0].values_f64(), cols[1].values_f64()
        out = a + b
        return Column.from_values(Real, [None if np.isnan(v) else v for v in out])


class Scale(UnaryTransformer):
    input_types = (Real,)
    output_type = Real
    factor = Param(default=2.0, doc="multiplier")

    def transform_columns(self, cols, dataset):
        v = cols[0].values_f64() * self.factor
        return Column.from_values(Real, [None if np.isnan(x) else x for x in v])


def _raw(name, ftype=Real, response=False):
    b = FeatureBuilder.of(name, ftype).extract_field()
    return b.as_response() if response else b.as_predictor()


class TestFeature:
    def test_builder_creates_raw_feature(self):
        f = _raw("age")
        assert f.is_raw and f.name == "age" and f.ftype is Real
        assert not f.is_response
        assert isinstance(f.origin_stage, FeatureGeneratorStage)

    def test_response_flag(self):
        assert _raw("y", RealNN, response=True).is_response

    def test_builder_dynamic_type_attr(self):
        f = FeatureBuilder.Text("desc").as_predictor()
        assert f.ftype is Text

    def test_transform_with_wires_dag(self):
        a, b = _raw("a"), _raw("b")
        s = AddTwo()
        out = a.transform_with(s, b)
        assert out.parents == (a, b)
        assert out.origin_stage is s
        assert not out.is_raw
        assert out.ftype is Real

    def test_raw_features_dedup(self):
        a, b = _raw("a"), _raw("b")
        s1 = a.transform_with(AddTwo(), b)
        s2 = s1.transform_with(AddTwo(), a)  # a used twice
        raws = s2.raw_features()
        assert {f.name for f in raws} == {"a", "b"}
        assert len(raws) == 2

    def test_history(self):
        a, b = _raw("a"), _raw("b")
        out = a.transform_with(AddTwo(), b).transform_with(Scale())
        h = out.history()
        assert h.origin_features == ["a", "b"]
        assert "addTwo" in h.stages and "scale" in h.stages


class TestStageFramework:
    def test_arity_validation(self):
        a = _raw("a")
        with pytest.raises(ValueError):
            AddTwo().set_input(a)  # needs 2 inputs

    def test_type_validation(self):
        t = FeatureBuilder.Text("t").as_predictor()
        a = _raw("a")
        with pytest.raises(TypeError):
            AddTwo().set_input(a, t)

    def test_response_inputs_rejected_by_default(self):
        y = _raw("y", RealNN, response=True)
        a = _raw("a")
        with pytest.raises(ValueError):
            AddTwo().set_input(a, y)

    def test_params(self):
        s = Scale(factor=3.0)
        assert s.factor == 3.0
        assert s.get_params() == {"factor": 3.0}
        s.set_params(factor=5.0)
        assert s.factor == 5.0
        with pytest.raises(TypeError):
            Scale(bogus=1)

    def test_uid_unique(self):
        assert Scale().uid != Scale().uid

    def test_copy_preserves_identity(self):
        a = _raw("a")
        s = Scale(factor=4.0)
        out = a.transform_with(s)
        c = s.copy()
        assert c.uid == s.uid and c.factor == 4.0
        assert c.get_output() is out

    def test_transform_on_dataset(self):
        a, b = _raw("a"), _raw("b")
        s = AddTwo()
        out = a.transform_with(s, b)
        ds = Dataset.from_features(
            {"a": [1.0, None, 3.0], "b": [10.0, 20.0, 30.0]},
            {"a": Real, "b": Real},
        )
        ds2 = s.transform(ds)
        assert ds2[out.name].to_values() == [11.0, None, 33.0]


class TestDagScheduler:
    def test_layers_by_distance(self):
        a, b, c = _raw("a"), _raw("b"), _raw("c")
        s1, s2, s3 = AddTwo(), AddTwo(), AddTwo()
        ab = a.transform_with(s1, b)        # depth 2 from sink
        abc = ab.transform_with(s2, c)      # depth 1
        scale = Scale()
        final = abc.transform_with(scale)   # depth 0
        layers = compute_dag([final])
        assert [len(l) for l in layers] == [1, 1, 1]
        assert layers[0] == [s1] and layers[1] == [s2] and layers[2] == [scale]

    def test_diamond_max_distance(self):
        # a -> s1 -> x ; (x, x) -> s2 ; s1 must land in the layer at max distance
        a, b = _raw("a"), _raw("b")
        s1 = AddTwo()
        x = a.transform_with(s1, b)
        s2 = Scale()
        y = x.transform_with(s2)
        s3 = AddTwo()
        z = x.transform_with(s3, y)  # x used at distance 1 and 2
        layers = compute_dag([z])
        flat = [s for l in layers for s in l]
        assert flat.index(s1) < flat.index(s2) < flat.index(s3)

    def test_multiple_results_shared_stages(self):
        a, b = _raw("a"), _raw("b")
        s1 = AddTwo()
        x = a.transform_with(s1, b)
        s2, s3 = Scale(), Scale(factor=3.0)
        r1, r2 = x.transform_with(s2), x.transform_with(s3)
        layers = compute_dag([r1, r2])
        assert layers[0] == [s1]
        assert set(layers[1]) == {s2, s3}

    def test_raw_generators(self):
        a, b = _raw("a"), _raw("b")
        out = a.transform_with(AddTwo(), b)
        gens = raw_feature_generators([out])
        assert [g.raw_name for g in gens] == ["a", "b"]


class TestDataset:
    def test_from_features_and_masks(self):
        ds = Dataset.from_features(
            {"a": [1.0, None], "t": ["x", None]}, {"a": Real, "t": Text}
        )
        assert ds.n_rows == 2
        assert ds["a"].fill_rate() == 0.5
        assert list(ds["a"].present()) == [True, False]
        assert ds["t"].to_values() == ["x", None]

    def test_length_mismatch_raises(self):
        with pytest.raises(ValueError):
            Dataset({
                "a": Column.from_values(Real, [1.0]),
                "b": Column.from_values(Real, [1.0, 2.0]),
            })

    def test_take_split_concat(self):
        ds = Dataset.from_features({"a": list(map(float, range(100)))}, {"a": Real})
        tr, te = ds.split(test_fraction=0.2, seed=1)
        assert tr.n_rows == 80 and te.n_rows == 20
        assert tr.concat(te).n_rows == 100

    def test_vector_column(self):
        col = Column.vector(np.arange(6, dtype=np.float32).reshape(3, 2))
        assert col.width == 2 and len(col) == 3

    def test_from_dataframe_inference(self):
        import pandas as pd

        df = pd.DataFrame({
            "age": [1.0, 2.0, None],
            "n": [1, 2, 3],
            "name": ["a", "b", None],
            "y": [0.0, 1.0, 0.0],
        })
        feats, ds = FeatureBuilder.from_dataframe(df, response="y")
        byname = {f.name: f for f in feats}
        assert byname["age"].ftype is Real
        assert byname["n"].ftype.__name__ == "Integral"
        assert byname["name"].ftype is Text
        assert byname["y"].is_response and byname["y"].ftype is RealNN
        assert ds.n_rows == 3
