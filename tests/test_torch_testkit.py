"""testkit tests on the port (the reference's ``tests/test_testkit.py`` with the
import swapped, on the CPU), and the testkit against the JAX package's.

The spec helpers are themselves exercised against real stages (numeric vectorizer,
one-hot, scalers) the way reference suites extend OpTransformerSpec/OpEstimatorSpec.
Parity: every ``Random*`` generator gives the JAX package's values for the same
seed (``limit`` and ``take``, with empties), and ``TestFeatureBuilder`` builds the
same columns.
"""

import numpy as np
import pytest

import transmogrifai_tpu.testkit as JK
import transmogrifai_tpu.types as JT
import transmogrifai_tpu_torch.testkit as TK
import transmogrifai_tpu_torch.types as TT
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device

from transmogrifai_tpu_torch.testkit import (
    RandomBinary,
    RandomIntegral,
    RandomList,
    RandomMap,
    RandomMultiPickList,
    RandomPickList,
    RandomReal,
    RandomText,
    RandomVector,
    TestFeatureBuilder,
    assert_estimator_spec,
    assert_transformer_spec,
)
from transmogrifai_tpu_torch.types import (
    Binary,
    Integral,
    MultiPickList,
    PickList,
    Real,
    RealNN,
    Text,
    TextList,
    TextMap,
)


@pytest.fixture(autouse=True)
def _cpu():
    with use_device("cpu"):
        yield


class TestTestFeatureBuilder:
    def test_build_features_and_dataset(self):
        feats, ds = TestFeatureBuilder.build(
            {"age": [30.0, None, 12.5], "label": [0.0, 1.0, 1.0]},
            {"age": Real, "label": RealNN}, response="label")
        assert ds.n_rows == 3
        assert feats["label"].is_response and not feats["age"].is_response
        assert ds["age"].fill_rate() == pytest.approx(2 / 3)

    def test_of_single(self):
        f, ds = TestFeatureBuilder.of("t", Text, ["a", None, "c"])
        assert f.ftype is Text
        assert ds["t"].to_values() == ["a", None, "c"]

    def test_missing_ftype_raises(self):
        with pytest.raises(KeyError, match="feature type"):
            TestFeatureBuilder.build({"a": [1]}, {})


class TestRandomGenerators:
    def test_deterministic(self):
        a = RandomReal.normal(seed=7).limit(10)
        b = RandomReal.normal(seed=7).limit(10)
        assert a == b

    def test_probability_of_empty(self):
        vals = RandomReal.normal(probability_of_empty=0.4, seed=1).limit(2000)
        frac = sum(v is None for v in vals) / len(vals)
        assert 0.35 < frac < 0.45

    def test_take_returns_typed(self):
        vals = RandomIntegral(0, 10, seed=3).take(5)
        assert all(isinstance(v, Integral) for v in vals)

    def test_binary(self):
        vals = RandomBinary(probability_of_true=0.9, seed=2).limit(500)
        assert sum(vals) > 400

    def test_text_and_picklist(self):
        txt = RandomText.strings(2, 4, seed=5).limit(20)
        assert all(2 <= len(t) <= 4 for t in txt)
        pl = RandomPickList(["a", "b"], seed=5).limit(50)
        assert set(pl) <= {"a", "b"}

    def test_emails(self):
        vals = RandomText.emails(domain="sf.com", seed=9).limit(5)
        assert all(v.endswith("@sf.com") for v in vals)

    def test_multipicklist_list_map_vector(self):
        mpl = RandomMultiPickList(["x", "y", "z"], seed=1).limit(20)
        assert all(isinstance(v, set) for v in mpl)
        lst = RandomList(RandomText.strings(seed=2), max_size=3, seed=2).limit(10)
        assert all(isinstance(v, list) and len(v) <= 3 for v in lst)
        mp = RandomMap(RandomText.strings(seed=3), keys=["k1", "k2"], seed=3).limit(10)
        assert all(isinstance(v, dict) and set(v) <= {"k1", "k2"} for v in mp)
        vec = RandomVector(4, seed=4).limit(3)
        assert all(v.shape == (4,) for v in vec)

    def test_dataset_from_generators(self):
        feats, ds = TestFeatureBuilder.build(
            {"x": RandomReal.normal(seed=1, probability_of_empty=0.1).limit(100),
             "c": RandomPickList(["r", "g", "b"], seed=2).limit(100)},
            {"x": Real, "c": PickList})
        assert ds.n_rows == 100


class TestSharedSpecs:
    def test_transformer_spec_on_math(self):
        from transmogrifai_tpu_torch.ops.math import ScalarMathTransformer

        f, ds = TestFeatureBuilder.of("x", Real, [1.0, 2.0, None])
        stage = ScalarMathTransformer(op="multiply", scalar=2.0)
        stage.set_input(f)
        assert_transformer_spec(stage, ds, expected=[2.0, 4.0, None])

    def test_estimator_spec_on_scaler(self):
        from transmogrifai_tpu_torch.ops.scalers import FillMissingWithMean

        f, ds = TestFeatureBuilder.of("x", Real, [1.0, 3.0, None, None])
        est = FillMissingWithMean()
        est.set_input(f)
        assert_estimator_spec(est, ds, expected=[1.0, 3.0, 2.0, 2.0])

    def test_estimator_spec_on_onehot(self):
        from transmogrifai_tpu_torch.ops.onehot import OneHotVectorizer

        feats, ds = TestFeatureBuilder.build(
            {"c": ["a", "b", "a", None]}, {"c": PickList})
        est = OneHotVectorizer(top_k=5, min_support=1)
        est.set_input(feats["c"])
        model = assert_estimator_spec(est, ds, check_row_parity=False)
        out = model.transform(ds)[model.output_name]
        assert out.data.shape[0] == 4

    def test_spec_catches_bad_expected(self):
        from transmogrifai_tpu_torch.ops.math import ScalarMathTransformer

        f, ds = TestFeatureBuilder.of("x", Real, [1.0])
        stage = ScalarMathTransformer(op="multiply", scalar=2.0)
        stage.set_input(f)
        with pytest.raises(AssertionError):
            assert_transformer_spec(stage, ds, expected=[999.0])


# ---------------------------------------------------------------------------
# The testkit against the JAX package's
# ---------------------------------------------------------------------------

def _generators(K, T):
    """One generator of each kind, with empties where the kind takes them."""
    return {
        "normal": K.RandomReal.normal(2.0, 3.0, seed=11, probability_of_empty=0.2),
        "uniform": K.RandomReal.uniform(-1.0, 4.0, seed=12),
        "lognormal": K.RandomReal.lognormal(seed=13, ftype=T.Currency),
        "integral": K.RandomIntegral(-5, 50, seed=14, probability_of_empty=0.1),
        "binary": K.RandomBinary(0.3, seed=15, probability_of_empty=0.1),
        "strings": K.RandomText.strings(1, 12, seed=16, probability_of_empty=0.3),
        "emails": K.RandomText.emails(domain="sf.com", seed=17),
        "picklist": K.RandomPickList(["r", "g", "b", "y"], seed=18,
                                     probability_of_empty=0.1),
        "multipick": K.RandomMultiPickList(["x", "y", "z", "w"], max_size=3, seed=19),
        "list": K.RandomList(K.RandomText.strings(seed=20), min_size=1, max_size=4,
                             seed=21),
        "map": K.RandomMap(K.RandomReal.normal(seed=22), max_size=5, seed=23,
                           ftype=T.RealMap),
        "vector": K.RandomVector(5, seed=24, sigma=2.0),
    }


def _plain(v):
    return v.tolist() if isinstance(v, np.ndarray) else v


@pytest.mark.parametrize("kind", sorted(_generators(TK, TT)))
def test_generators_equal_the_jax_package(kind):
    t, j = _generators(TK, TT)[kind], _generators(JK, JT)[kind]
    got, want = [_plain(v) for v in t.limit(300)], [_plain(v) for v in j.limit(300)]
    assert got == want
    typed_t, typed_j = t.reset().take(50), j.reset().take(50)
    assert [type(v).__name__ for v in typed_t] == [type(v).__name__ for v in typed_j]
    assert [_plain(v.value) for v in typed_t] == [_plain(v.value) for v in typed_j]
    assert [_plain(v) for v in t.reset().limit(300)] == got  # reset replays


def test_feature_builder_equals_the_jax_package():
    values = {"x": TK.RandomReal.normal(seed=1, probability_of_empty=0.1).limit(100),
              "c": TK.RandomPickList(["r", "g", "b"], seed=2).limit(100),
              "label": TK.RandomBinary(seed=3).limit(100)}
    tf, tds = TK.TestFeatureBuilder.build(
        values, {"x": TT.Real, "c": TT.PickList, "label": TT.RealNN}, response="label")
    jf, jds = JK.TestFeatureBuilder.build(
        values, {"x": JT.Real, "c": JT.PickList, "label": JT.RealNN}, response="label")
    assert tds.names == jds.names
    for name in tds.names:
        assert tds[name].to_values() == jds[name].to_values()
        assert tds[name].data.dtype == jds[name].data.dtype
        assert tf[name].is_response == jf[name].is_response
        assert tf[name].ftype.__name__ == jf[name].ftype.__name__
