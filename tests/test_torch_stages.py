"""Device and host halves of the port's stages against the JAX package.

Each ported stage gets the same fitted state as its JAX counterpart and the
same inputs (made from seeds with numpy); the port's ``device_transform`` on
CPU tensors must equal the JAX stage's jitted ``device_transform`` bit for
bit — the serving prefix is the reference's jitted program, so that is what
the port is held to.  The host halves (``transform_columns``) are compared
on the committed fixture, data and vector metadata.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.checkers import sanity as J_sanity
from transmogrifai_tpu.ops import bucketizers as J_buck
from transmogrifai_tpu.ops import combiner as J_comb
from transmogrifai_tpu.ops import numeric as J_num
from transmogrifai_tpu.ops import onehot as J_onehot
from transmogrifai_tpu.ops import scalers as J_scal
from transmogrifai_tpu.perf.kernels import dispatch as KD
from transmogrifai_tpu_torch.checkers import sanity as T_sanity
from transmogrifai_tpu_torch.ops import bucketizers as T_buck
from transmogrifai_tpu_torch.ops import combiner as T_comb
from transmogrifai_tpu_torch.ops import numeric as T_num
from transmogrifai_tpu_torch.ops import onehot as T_onehot
from transmogrifai_tpu_torch.ops import scalers as T_scal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "serving_wide")


def _lifts(n: int, k: int, seed: int, missing: float = 0.2):
    """k float32 columns with NaN for missing (the canonical device lift)."""
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(k):
        x = (rng.normal(size=n) * 3 + 0.7).astype(np.float32)
        x[rng.random(n) < missing] = np.nan
        cols.append(x)
    return cols


def _same(jax_stage, torch_stage, arrays, kernel_mode="xla"):
    """Run both device halves on the same numpy operands; assert bitwise."""
    with KD.force_kernel_mode(kernel_mode):
        ref = np.asarray(jax.jit(jax_stage.device_transform)(
            *[jnp.asarray(a) for a in arrays]))
    got = torch_stage.device_transform(*[torch.from_numpy(a) for a in arrays])
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    return got


class TestNumeric:
    @pytest.mark.parametrize("track_nulls", [True, False])
    @pytest.mark.parametrize("n", [8, 300])
    def test_numeric_vectorizer(self, track_nulls, n):
        fills = np.random.default_rng(1).normal(size=5) * 10 / 3
        _same(J_num.NumericVectorizerModel(fills=fills, track_nulls=track_nulls),
              T_num.NumericVectorizerModel(fills=fills, track_nulls=track_nulls),
              _lifts(n, 5, seed=n))

    def test_realnn_vectorizer(self):
        xs = [np.nan_to_num(c) for c in _lifts(64, 3, seed=2)]
        _same(J_num.RealNNVectorizer(), T_num.RealNNVectorizer(), xs)

    @pytest.mark.parametrize("track_nulls", [True, False])
    def test_binary_vectorizer(self, track_nulls):
        rng = np.random.default_rng(3)
        xs = []
        for _ in range(4):
            b = (rng.random(100) < 0.4).astype(np.float32)
            b[rng.random(100) < 0.2] = np.nan
            xs.append(b)
        _same(J_num.BinaryVectorizer(track_nulls=track_nulls),
              T_num.BinaryVectorizer(track_nulls=track_nulls), xs)


class TestScalers:
    @pytest.mark.parametrize("mean", [0.1234567891234, -7.3e5, 1 / 3])
    def test_fill_missing_with_mean(self, mean):
        _same(J_scal.FillMissingWithMeanModel(mean=mean),
              T_scal.FillMissingWithMeanModel(mean=mean), _lifts(257, 1, seed=4))

    @pytest.mark.parametrize("mean, std", [(0.1234567891234, 3.3),
                                           (-1e-3, 1 / 7), (12.5, 0.987654321)])
    def test_standard_scaler_rounds_constants_to_float32(self, mean, std):
        x = [np.nan_to_num(_lifts(513, 1, seed=5)[0])]
        _same(J_scal.StandardScalerModel(mean=mean, std=std),
              T_scal.StandardScalerModel(mean=mean, std=std), x)


class TestOneHot:
    VOCABS = [["a", "b", "c"], ["x y", "z"], [f"v{i}" for i in range(20)]]

    def _pair(self, track_nulls):
        return (J_onehot.OneHotVectorizerModel(vocabs=self.VOCABS, track_nulls=track_nulls),
                T_onehot.OneHotVectorizerModel(vocabs=self.VOCABS, track_nulls=track_nulls))

    @pytest.mark.parametrize("track_nulls", [True, False])
    @pytest.mark.parametrize("kernel_mode", ["xla", "interpret"])
    def test_device_transform(self, track_nulls, kernel_mode):
        jm, tm = self._pair(track_nulls)
        rng = np.random.default_rng(6)
        codes = []
        for slot, vocab in enumerate(self.VOCABS):
            k = len(vocab)
            hi = k + 2 if track_nulls else k + 1
            c = rng.integers(0, hi, 77).astype(np.int32)
            if not track_nulls:
                c[::5] = -1                      # untracked null: zero row
            codes.append(c)
        _same(jm, tm, codes, kernel_mode=kernel_mode)

    @pytest.mark.parametrize("track_nulls", [True, False])
    def test_encode_device_input(self, track_nulls):
        from transmogrifai_tpu.data.dataset import Column as JColumn
        from transmogrifai_tpu.types import PickList as JPickList
        from transmogrifai_tpu_torch.data.dataset import Column as TColumn
        from transmogrifai_tpu_torch.types import PickList as TPickList

        jm, tm = self._pair(track_nulls)
        values = ["a", "c", None, "", "unseen", " b ", "x y", "z!", "v19", "a"]
        raw = np.array(values, dtype=object)
        for slot in range(len(self.VOCABS)):
            ref = jm.encode_device_input(slot, JColumn(JPickList, raw))
            got = tm.encode_device_input(slot, TColumn(TPickList, raw))
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, ref)
            # the memo path (second call) encodes identically
            np.testing.assert_array_equal(
                tm.encode_device_input(slot, TColumn(TPickList, raw)), ref)


class TestDecisionTreeBucketizer:
    @pytest.mark.parametrize("splits", [
        [-np.inf, -0.31, 0.2, 1.7, np.inf], [-np.inf, 0.0, np.inf],
        [-2.0, 0.5, 3.0]], ids=["three_splits", "one_split", "finite_edges"])
    @pytest.mark.parametrize("track_nulls", [True, False])
    @pytest.mark.parametrize("track_invalid", [True, False])
    def test_should_split(self, splits, track_nulls, track_invalid):
        kw = dict(should_split=True, splits=splits, track_nulls=track_nulls,
                  track_invalid=track_invalid)
        x = _lifts(300, 1, seed=7)[0]
        x[:4] = [np.inf, -np.inf, np.float32(splits[1]), np.float32(-0.31)]
        for mode in ("xla", "interpret"):
            _same(J_buck.DecisionTreeNumericBucketizerModel(**kw),
                  T_buck.DecisionTreeNumericBucketizerModel(**kw), [x],
                  kernel_mode=mode)

    @pytest.mark.parametrize("track_nulls", [True, False])
    def test_no_split_keeps_null_indicator_only(self, track_nulls):
        kw = dict(should_split=False, splits=[], track_nulls=track_nulls)
        out = _same(J_buck.DecisionTreeNumericBucketizerModel(**kw),
                    T_buck.DecisionTreeNumericBucketizerModel(**kw),
                    _lifts(40, 1, seed=8))
        assert out.shape == (40, 1 if track_nulls else 0)


class TestCombinerAndSanity:
    def test_vectors_combiner(self):
        rng = np.random.default_rng(9)
        blocks = [rng.normal(size=(50, w)).astype(np.float32) for w in (3, 1, 22)]
        _same(J_comb.VectorsCombiner(), T_comb.VectorsCombiner(), blocks)

    def test_combiner_refuses_mixed_dtypes(self):
        with pytest.raises(TypeError):
            T_comb.VectorsCombiner().device_transform(
                torch.zeros((2, 2)), torch.zeros((2, 2), dtype=torch.float64))

    @pytest.mark.parametrize("n", [1, 96])
    def test_sanity_select_is_c_contiguous(self, n):
        kept = [0, 2, 3, 7, 8, 15, 16, 19]
        vec = np.random.default_rng(n).normal(size=(n, 20)).astype(np.float32)
        j = J_sanity.SanityCheckerModel(kept_indices=kept)
        t = T_sanity.SanityCheckerModel(kept_indices=kept)
        _same(j, t, [vec])
        out = t.device_transform(torch.from_numpy(vec))
        assert out.is_contiguous() and out.numpy().flags["C_CONTIGUOUS"]


class TestHostHalvesOnFixture:
    """``transform_columns`` of every prefix stage of the loaded fixture,
    port against reference: same data bits and same vector metadata."""

    def test_host_transforms_match_reference(self):
        from transmogrifai_tpu.data.dataset import Dataset as JDataset
        from transmogrifai_tpu.serve.plan import resolve_scoring_stages as j_resolve
        from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel
        from transmogrifai_tpu_torch.data.dataset import Dataset as TDataset
        from transmogrifai_tpu_torch.serve.plan import resolve_scoring_stages as t_resolve
        from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as TModel

        import json

        jm, tm = JModel.load(FIXTURE), TModel.load(FIXTURE)
        with open(os.path.join(FIXTURE, "schema.json")) as fh:
            schema = json.load(fh)
        rng = np.random.default_rng(10)
        values, jtypes, ttypes = {}, {}, {}
        from transmogrifai_tpu.types import feature_type_by_name as jft
        from transmogrifai_tpu_torch.types import feature_type_by_name as tft

        for f in schema["features"]:
            if f.get("response"):
                continue
            if f["type"] == "Real":
                v = [None if rng.random() < .1 else float(rng.normal()) for _ in range(50)]
            elif f["type"] == "Binary":
                v = [None if rng.random() < .1 else bool(rng.random() < .3) for _ in range(50)]
            else:
                v = [None if rng.random() < .1 else str(rng.choice(f["levels"] + ["new"]))
                     for _ in range(50)]
            values[f["name"]] = v
            jtypes[f["name"]], ttypes[f["name"]] = jft(f["type"]), tft(f["type"])
        jds = JDataset.from_features(values, jtypes)
        tds = TDataset.from_features(values, ttypes)
        jr = j_resolve(jm.result_features, jm.fitted)
        tr = t_resolve(tm.result_features, tm.fitted)
        assert [r.uid for r in jr] == [r.uid for r in tr]
        checked = 0
        for j, t in zip(jr, tr):
            jds, tds = j.transform(jds), t.transform(tds)
            jc, tc = jds[j.output_name], tds[t.output_name]
            np.testing.assert_array_equal(np.asarray(tc.data), np.asarray(jc.data))
            if jc.meta is not None:
                assert tc.meta.to_dict() == jc.meta.to_dict()
            checked += 1
        assert checked == len(jr) > 10
