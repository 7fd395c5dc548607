"""The port's SanityChecker fit against the JAX package's.

Both checkers fit the same label and feature block (the wide pipeline's
transmogrified vector at a cut, made from a seed, with the reference's
vector metadata) under each of the paths the checker has: Pearson and
Spearman, the full matrix or label correlations only, a row sample, the
hashed-text exclusion on and off, thresholds that drop by correlation,
Cramér's V and rule confidence, a categorical label of three levels and a
continuous one.  The kept indices and the drop reasons must be equal; the
column statistics, the correlation matrix and Cramér's V lie within 1e-5
(float32 reductions in another order).  The tie-averaged ranks are equal
to the reference's bit for bit.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.checkers import sanity as JS
from transmogrifai_tpu.data.dataset import Column as JCol
from transmogrifai_tpu.data.dataset import Dataset as JDs
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.types import RealNN as JRealNN
from transmogrifai_tpu.utils import stats as JStats
from transmogrifai_tpu.utils.vector_metadata import VectorMetadata as JMeta
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.checkers import sanity as TS
from transmogrifai_tpu_torch.data.dataset import Column as TCol
from transmogrifai_tpu_torch.types import RealNN as TRealNN
from transmogrifai_tpu_torch.types import feature_type_by_name as tft
from transmogrifai_tpu_torch.utils import stats as TStats
from transmogrifai_tpu_torch.utils.vector_metadata import VectorColumnMetadata, VectorMetadata
from transmogrifai_tpu_torch.workflow.fit import transform_dag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_wide_data import make_data, wide_pipeline  # noqa: E402

CUT = dict(n_real=6, n_bucketized=3, n_pick=4, n_levels=30, n_binary=2)


@pytest.fixture(scope="module")
def block():
    """(label, vector, metadata) of the wide pipeline at 2000 rows, and the
    same vector with 6 hashed-text slots appended."""
    cols, schema = make_data(2000, seed=3, **CUT)
    tf = {s["name"]: tft(s["type"]) for s in schema}
    label, _, chk, _ = wide_pipeline(T, tf, schema)
    vec = chk.inputs[1]
    ds = T.Dataset.from_features(cols, tf)
    model = T.Workflow().set_input_dataset(ds).set_result_features(vec).train(device="cpu")
    col = transform_dag(ds, [vec], model.fitted, "cpu")[vec.name]
    y = np.asarray(cols["label"], np.float64)
    rng = np.random.default_rng(9)
    hashed = (rng.random((2000, 6)) < 0.2).astype(np.float32)
    hashed[:, 0] = y.astype(np.float32)        # a leaky hashed slot
    metas = list(col.meta.columns) + [
        VectorColumnMetadata("txt", "Text", descriptor_value=f"hash_{b}")
        for b in range(6)]
    hmeta = VectorMetadata("hashed", metas).reindexed()
    return y, col.data, col.meta, np.hstack([col.data, hashed]), hmeta


def _fit_both(y, x, meta, params):
    jl = JFB.RealNN("label").extract_field().as_response()
    jv = JFB.OPVector("v").extract_field().as_predictor()
    jc = JS.SanityChecker(**params)
    jl.transform_with(jc, jv)
    jds = JDs({"label": JCol.from_values(JRealNN, y.tolist()),
               "v": JCol.vector(x, JMeta.from_dict(meta.to_dict()))})
    tl = T.FeatureBuilder.RealNN("label").extract_field().as_response()
    tv = T.FeatureBuilder.OPVector("v").extract_field().as_predictor()
    tc = TS.SanityChecker(**params)
    tl.transform_with(tc, tv)
    tds = T.Dataset({"label": TCol.from_values(TRealNN, y.tolist()),
                     "v": TCol.vector(x, meta)})
    return jc.fit(jds), tc.fit(tds, device="cpu")


def _same(jm, tm):
    js, ts = jm.summary, tm.summary
    assert tm.kept_indices == jm.kept_indices
    assert ts.dropped == js.dropped
    assert (ts.sample_size, ts.label_distinct, ts.correlation_type) == \
        (js.sample_size, js.label_distinct, js.correlation_type)
    assert ts.correlation_indices == list(js.correlation_indices)
    for a, b in zip(js.stats, ts.stats):
        assert a.name == b.name
        for k in ("mean", "variance", "min", "max", "corr_label", "cramers_v",
                  "max_rule_confidence", "support"):
            x, y = getattr(a, k), getattr(b, k)
            if x is None or y is None:
                assert x is None and y is None, (a.name, k)
            else:
                np.testing.assert_allclose(y, x, rtol=0, atol=1e-5, err_msg=f"{a.name} {k}")
    if js.correlations_feature is None:
        assert ts.correlations_feature is None
    else:
        np.testing.assert_allclose(ts.correlations_feature,
                                   np.asarray(js.correlations_feature), rtol=0, atol=1e-5)
    return ts


@pytest.mark.parametrize("params, drops", [
    ({}, False),
    ({"correlation_type": "spearman"}, False),
    ({"feature_label_corr_only": True}, False),
    ({"check_sample": 0.5, "sample_seed": 7}, False),
    ({"min_correlation": 0.02}, True),
    ({"max_cramers_v": 0.05}, True),
    ({"max_rule_confidence": 0.6, "min_required_rule_support": 0.0}, True),
    ({"categorical_label": False, "min_variance": 0.1}, True),
    ({"remove_bad_features": False, "min_variance": 0.5}, False),
    ({"correlation_type": "spearman", "max_correlation": 0.3}, True),
], ids=["default", "spearman", "label_corr_only", "check_sample", "min_corr",
        "cramers_v", "rule_confidence", "not_categorical", "keep_all", "spearman_max"])
def test_paths_equal_the_reference(block, params, drops):
    y, x, meta, _, _ = block
    ts = _same(*_fit_both(y, x, meta, params))
    assert bool(ts.dropped) == drops


@pytest.mark.parametrize("exclusion", ["hashed_text", "none"])
def test_hashed_text_exclusion(block, exclusion):
    y, _, _, xh, hmeta = block
    ts = _same(*_fit_both(y, xh, hmeta, {"correlation_exclusion": exclusion}))
    d = xh.shape[1]
    if exclusion == "hashed_text":
        assert ts.correlation_indices == list(range(d - 6))
        assert np.isnan(ts.stats[d - 6].corr_label)
    else:
        # the leaky hashed slot is caught once it is correlated
        assert ts.stats[d - 6].name in ts.dropped


@pytest.mark.parametrize("kind", ["three_levels", "continuous"])
def test_other_labels(block, kind):
    _, x, meta, _, _ = block
    rng = np.random.default_rng(2)
    y = rng.integers(0, 3, x.shape[0]).astype(np.float64) if kind == "three_levels" \
        else rng.normal(size=x.shape[0])
    ts = _same(*_fit_both(y, x, meta, {}))
    assert ts.label_distinct == (3 if kind == "three_levels" else x.shape[0])
    # a continuous label is not categorical: no group gets Cramér's V
    assert any(s.cramers_v is not None for s in ts.stats) == (kind == "three_levels")


def test_rank_columns_on_ties_equal_the_reference():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, size=(301, 5)).astype(np.float32)
    x[:, 1] = 2.0                                    # one long tie
    x[:, 2] = rng.normal(size=301).astype(np.float32)  # no ties
    x[::3, 3] = -np.inf
    want = np.asarray(JS._rank_columns(jnp.asarray(x)))
    got = TS._rank_columns(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_full_corr_one_gram_product(block):
    _, x, _, _, _ = block
    n = x.shape[0]
    want = np.asarray(JS._device_full_corr(jnp.asarray(x), jnp.ones(n, jnp.float32),
                                           float(n)))
    got = TS._device_full_corr(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_every_slot_dropped_raises(block):
    y, x, meta, _, _ = block
    tl = T.FeatureBuilder.RealNN("label").extract_field().as_response()
    tv = T.FeatureBuilder.OPVector("v").extract_field().as_predictor()
    tc = TS.SanityChecker(min_variance=1e9)
    tl.transform_with(tc, tv)
    tds = T.Dataset({"label": TCol.from_values(TRealNN, y.tolist()),
                     "v": TCol.vector(x, meta)})
    with pytest.raises(ValueError, match="dropped every feature slot"):
        tc.fit(tds, device="cpu")
    tds = T.Dataset({"label": tds["label"], "v": TCol.vector(x)})
    with pytest.raises(ValueError, match="requires vector metadata"):
        tc.fit(tds, device="cpu")


def test_spearman_monotonic():
    """The reference's ``test_sanity_checker.py`` case on the port."""
    y = np.arange(100, dtype=float)
    x = np.exp(y / 10)[:, None]  # monotonic but nonlinear
    assert TStats.spearman_with_label(x, y)[0] == pytest.approx(1.0)


def test_spearman_equals_the_reference():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 5, size=(200, 4)).astype(np.float64)
    x[:, 3] = rng.normal(size=200)
    y = rng.normal(size=200)
    got, want = TStats.spearman_with_label(x, y), JStats.spearman_with_label(x, y)
    assert got.tobytes() == want.tobytes()
