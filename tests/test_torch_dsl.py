"""The DSL's numeric shortcuts and the stage library under them, against the
JAX package on the same numpy-seeded inputs.

- ``stages/base.py``'s arity classes and ``UnaryLambdaTransformer``;
  ``types``' ``to_real`` ... ``to_multi_picklist``;
- ``ops/math.py``, ``ops/misc.py``, ``ops/onehot.py``'s ``StringIndexer`` /
  ``IndexToString`` and ``ops/scalers.py``'s ``NumericBucketizer`` and
  ``PercentileCalibrator``: each host ``transform_columns`` (data, mask and
  vector metadata) equal to the reference's, and each device half equal to
  the reference's jitted ``device_transform`` bit for bit;
- the left-closed bucketize slot of the encode kernel: its plain version
  (``bucketize_left_encode_torch``, reached through ``encode_slots_torch``
  in one table with one-hot and right-closed slots) bitwise against the
  reference's ``NumericBucketizer.device_transform`` and, where the values
  are float32-exact, its float64 ``transform_columns``: ties on every split,
  +-inf, NaN, +-FLT_MAX, out of range with and without ``track_invalid``,
  and more than 4096 splits;
- every DSL shortcut builds the reference's stage with its params, and the
  ones whose stages are not ported raise naming them;
- serde of each new class both ways;
- the slice as a whole: a table with every new stage through transmogrify,
  the SanityChecker and an LR selector in both packages, the training
  vector bitwise and the served records equal.

The CUDA kernel's left-closed slot runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transmogrifai_tpu as J
import transmogrifai_tpu.ops.math as J_math
import transmogrifai_tpu.ops.misc as J_misc
import transmogrifai_tpu.ops.onehot as J_onehot
import transmogrifai_tpu.ops.scalers as J_scal
import transmogrifai_tpu.stages.base as J_base
import transmogrifai_tpu.stages.functions as J_fn
import transmogrifai_tpu.types as JT
import transmogrifai_tpu_torch as T
import transmogrifai_tpu_torch.ops.math as T_math
import transmogrifai_tpu_torch.ops.misc as T_misc
import transmogrifai_tpu_torch.ops.onehot as T_onehot
import transmogrifai_tpu_torch.ops.scalers as T_scal
import transmogrifai_tpu_torch.stages.base as T_base
import transmogrifai_tpu_torch.stages.functions as T_fn
import transmogrifai_tpu_torch.types as TT
from transmogrifai_tpu.data.dataset import Dataset as JDs
from transmogrifai_tpu.ops.bucketizers import device_bucketize_right
from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel
from transmogrifai_tpu_torch.data.dataset import Dataset as TDs
from transmogrifai_tpu_torch.perf.kernels import encode as TKE
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as TModel

FLT_MAX = float(np.finfo(np.float32).max)
INF = float("inf")


# -- helpers --------------------------------------------------------------------

def _raw(pkg, name, tname, response=False):
    b = pkg.FeatureBuilder.of(name, tname).extract_field()
    return b.as_response() if response else b.as_predictor()


def _ds(pkg_ds, types_mod, specs):
    return pkg_ds.from_features({n: v for n, _, v in specs},
                                {n: types_mod.feature_type_by_name(t) for n, t, _ in specs})


def _apply(j_stage, t_stage, specs):
    """Wire both stages to raw features of ``specs`` ((name, type, values))
    and run their host transforms on the same values."""
    jf = [_raw(J, n, t) for n, t, _ in specs]
    tf = [_raw(T, n, t) for n, t, _ in specs]
    jf[0].transform_with(j_stage, *jf[1:])
    tf[0].transform_with(t_stage, *tf[1:])
    jds, tds = _ds(JDs, JT, specs), _ds(TDs, TT, specs)
    jc = j_stage.transform_columns([jds[f.name] for f in jf], jds)
    tc = t_stage.transform_columns([tds[f.name] for f in tf], tds)
    return jc, tc


def _same_col(jc, tc):
    assert tc.ftype.__name__ == jc.ftype.__name__
    if jc.kind.value in ("float", "int", "bool", "vector", "geo"):
        assert np.asarray(tc.data).tobytes() == np.asarray(jc.data).tobytes()
        assert np.asarray(tc.data).dtype == np.asarray(jc.data).dtype
    else:
        assert tc.to_values() == jc.to_values()
    if jc.mask is not None or tc.mask is not None:
        np.testing.assert_array_equal(tc.mask, jc.mask)
    if jc.meta is not None or tc.meta is not None:
        # the vector's own name carries its stage's uid, which differs
        assert _meta(tc.meta) == _meta(jc.meta)


def _meta(meta) -> str:
    """Vector metadata as JSON without stage uids: the names of derived
    features carry their stage's uid, which each package counts on its own."""
    return re.sub(r"_[0-9a-f]{12}", "", json.dumps(meta.to_dict(), sort_keys=True))


def _jit(stage, *arrays):
    return np.asarray(jax.jit(stage.device_transform)(*[jnp.asarray(a) for a in arrays]))


NUM_A = [1.5, None, -2.0, 0.0, 3.0, 1e308, INF, -0.0, 7.25, -INF]
NUM_B = [2.0, 1.0, None, 0.0, -3.0, 1e308, 2.0, 5.0, 0.0, -INF]
INT_A = [3, None, -2, 0, 7, 1, 5, -9, 4, 2]


# -- stages/base.py and types ---------------------------------------------------

class TestBaseAndTypes:
    @pytest.mark.parametrize("cls", ["BinaryTransformer", "TernaryTransformer",
                                     "QuaternaryTransformer", "TernaryEstimator",
                                     "BinarySequenceEstimator", "UnaryLambdaTransformer"])
    def test_arity_classes_exist_with_the_reference_bases(self, cls):
        j, t = getattr(J_base, cls), getattr(T_base, cls)
        assert [b.__name__ for b in t.__mro__[:3]] == [b.__name__ for b in j.__mro__[:3]]

    @pytest.mark.parametrize("fn, value", [
        ("to_real", 1.5), ("to_real_nn", -2.0), ("to_integral", 7), ("to_binary", True),
        ("to_text", "abc"), ("to_picklist", "x"), ("to_multi_picklist", ["a", "b"])])
    def test_conversion_helpers(self, fn, value):
        j, t = getattr(JT, fn)(value), getattr(TT, fn)(value)
        assert type(t).__name__ == type(j).__name__ and t.value == j.value

    def test_unary_lambda_transformer(self):
        fn = lambda v: None if v is None else v.upper()  # noqa: E731
        specs = [("s", "Text", ["ab", None, "Cd", ""])]
        jc, tc = _apply(J_base.UnaryLambdaTransformer(fn, JT.Text, JT.PickList),
                        T_base.UnaryLambdaTransformer(fn, TT.Text, TT.PickList), specs)
        _same_col(jc, tc)

    def test_a_response_indexer_makes_a_response(self):
        label = _raw(T, "y", "PickList", response=True)
        out = label.transform_with(T_onehot.StringIndexer())
        assert out.is_response and out.ftype is TT.RealNN


# -- ops/math.py -----------------------------------------------------------------

class TestMath:
    @pytest.mark.parametrize("op", ["plus", "minus", "multiply", "divide"])
    @pytest.mark.parametrize("types", [("Real", "Real"), ("Integral", "Real"),
                                       ("Real", "Integral")])
    def test_binary(self, op, types):
        a = NUM_A if types[0] == "Real" else INT_A
        b = NUM_B if types[1] == "Real" else INT_A[::-1]
        jc, tc = _apply(J_math.BinaryMathTransformer(op=op),
                        T_math.BinaryMathTransformer(op=op),
                        [("a", types[0], a), ("b", types[1], b)])
        _same_col(jc, tc)

    @pytest.mark.parametrize("op", ["plus", "minus", "multiply", "divide"])
    @pytest.mark.parametrize("scalar", [0.0, -2.5, 1e-320])
    def test_scalar(self, op, scalar):
        jc, tc = _apply(J_math.ScalarMathTransformer(op=op, scalar=scalar),
                        T_math.ScalarMathTransformer(op=op, scalar=scalar),
                        [("a", "Real", NUM_A)])
        _same_col(jc, tc)

    def test_alias_names_and_types_its_output(self):
        f = _raw(T, "x", "Integral")
        out = f.alias("renamed")
        assert out.name == "renamed" and out.ftype is TT.Integral
        ds = _ds(TDs, TT, [("x", "Integral", INT_A)])
        col = out.origin_stage.transform(ds)["renamed"]
        assert col.to_values() == INT_A


# -- ops/misc.py -----------------------------------------------------------------

def is_positive(v):
    return v is not None and v > 0


def long_text(v):
    return v is not None and len(v) > 2


class TestMisc:
    def test_exists(self):
        specs = [("a", "Real", NUM_A)]
        jc, tc = _apply(J_misc.ExistsTransformer(is_positive, JT.Real),
                        T_misc.ExistsTransformer(is_positive, TT.Real), specs)
        _same_col(jc, tc)

    @pytest.mark.parametrize("tname, vals, pred, default", [
        ("Real", NUM_A, is_positive, -1.0), ("Text", ["abc", None, "x", "long"],
                                             long_text, "short")])
    def test_filter(self, tname, vals, pred, default):
        jc, tc = _apply(J_misc.FilterTransformer(pred, default, getattr(JT, tname)),
                        T_misc.FilterTransformer(pred, default, getattr(TT, tname)),
                        [("a", tname, vals)])
        _same_col(jc, tc)

    def test_replace(self):
        jc, tc = _apply(J_misc.ReplaceTransformer(JT.PickList, old_value="a", new_value="z"),
                        T_misc.ReplaceTransformer(TT.PickList, old_value="a", new_value="z"),
                        [("p", "PickList", ["a", "b", None, "a"])])
        _same_col(jc, tc)

    @pytest.mark.parametrize("lower", [True, False])
    def test_substring(self, lower):
        specs = [("s", "Text", ["ab", None, "X", "q", ""]),
                 ("t", "Text", ["xaby", "ab", "xyz", None, "z"])]
        jc, tc = _apply(J_misc.SubstringTransformer(to_lowercase=lower),
                        T_misc.SubstringTransformer(to_lowercase=lower), specs)
        _same_col(jc, tc)

    @pytest.mark.parametrize("tname, vals", [
        ("Real", NUM_A), ("PickList", ["a", None, "", "b"]),
        ("Binary", [True, False, None, True]),
        ("MultiPickList", [["a"], [], None, ["b", "c"]])])
    def test_to_occur_default_match(self, tname, vals):
        jc, tc = _apply(J_misc.ToOccurTransformer(input_type=getattr(JT, tname)),
                        T_misc.ToOccurTransformer(input_type=getattr(TT, tname)),
                        [("a", tname, vals)])
        _same_col(jc, tc)

    def test_to_occur_custom_match(self):
        jc, tc = _apply(J_misc.ToOccurTransformer(is_positive, JT.Real),
                        T_misc.ToOccurTransformer(is_positive, TT.Real),
                        [("a", "Real", NUM_A)])
        _same_col(jc, tc)

    def test_drop_indices_by(self):
        specs = [("p", "PickList", ["a", "b", None, "a", "c"])]
        jf, tf = _raw(J, "p", "PickList"), _raw(T, "p", "PickList")
        jv = jf.pivot(min_support=1)
        tv = tf.pivot(min_support=1)
        jds, tds = _ds(JDs, JT, specs), _ds(TDs, TT, specs)
        jm = jv.origin_stage.fit(jds)
        tm = tv.origin_stage.fit(tds, device="cpu")
        jds, tds = jm.transform(jds), tm.transform(tds)
        drop = lambda cm: cm.is_null_indicator  # noqa: E731
        jd = jv.transform_with(J_misc.DropIndicesByTransformer(drop)).origin_stage
        td = tv.transform_with(T_misc.DropIndicesByTransformer(drop)).origin_stage
        _same_col(jd.transform_columns([jds[jv.name]], jds),
                  td.transform_columns([tds[tv.name]], tds))

    @pytest.mark.parametrize("kind, slope, intercept", [
        ("linear", 2.5, -1.0), ("logarithmic", 1.0, 0.0)])
    def test_scaler_and_descaler(self, kind, slope, intercept):
        vals = [1.5, None, 4.0, 0.0, 1e-3, 250.0]
        out = {}
        for pkg, misc, ds_cls, tmod in ((J, J_misc, JDs, JT), (T, T_misc, TDs, TT)):
            x = _raw(pkg, "x", "Real")
            sc = x.transform_with(misc.ScalerTransformer(
                scaling_type=kind, slope=slope, intercept=intercept))
            de = sc.transform_with(misc.DescalerTransformer(), sc)
            ds = _ds(ds_cls, tmod, [("x", "Real", vals)])
            ds = sc.origin_stage.transform(ds)
            ds = de.origin_stage.transform(ds)
            out[pkg.__name__] = (ds[sc.name], ds[de.name])
        for a, b in zip(out["transmogrifai_tpu"], out["transmogrifai_tpu_torch"]):
            _same_col(a, b)

    def test_dsl_scale_descale_round_trip(self):
        x = _raw(T, "x", "Real")
        sc = x.scale(slope=4.0, intercept=1.0)
        back = sc.descale(sc)
        ds = _ds(TDs, TT, [("x", "Real", [1.0, None, -2.0])])
        ds = back.origin_stage.transform(sc.origin_stage.transform(ds))
        assert ds[back.name].to_values() == [1.0, None, -2.0]


# -- ops/onehot.py: StringIndexer and IndexToString ------------------------------

class TestStringIndexer:
    @pytest.mark.parametrize("handle_invalid", ["error", "keep"])
    def test_fit_order_and_transform(self, handle_invalid):
        rng = np.random.default_rng(5)
        vals = [str(v) for v in rng.choice(["b", "a", "c", "d"], 200, p=[.3, .3, .3, .1])]
        specs = [("y", "PickList", vals)]
        jf, tf = _raw(J, "y", "PickList"), _raw(T, "y", "PickList")
        js = J_onehot.StringIndexer(handle_invalid=handle_invalid)
        ts = T_onehot.StringIndexer(handle_invalid=handle_invalid)
        jf.transform_with(js)
        tf.transform_with(ts)
        jds, tds = _ds(JDs, JT, specs), _ds(TDs, TT, specs)
        jm, tm = js.fit(jds), ts.fit(tds, device="cpu")
        assert tm.labels == jm.labels
        assert len(set(vals)) == 4 and tm.labels[-1] == "d"
        score = [("y", "PickList", ["a", "d", "zz", None] if handle_invalid == "keep"
                  else ["a", "d", "c"])]
        jds, tds = _ds(JDs, JT, score), _ds(TDs, TT, score)
        _same_col(jm.transform_columns([jds["y"]], jds), tm.transform_columns([tds["y"]], tds))

    def test_ties_order_by_value(self):
        specs = [("y", "PickList", ["q", "p", "r", "p", "q", "r"])]
        ts = T_onehot.StringIndexer()
        _raw(T, "y", "PickList").transform_with(ts)
        assert ts.fit(_ds(TDs, TT, specs), device="cpu").labels == ["p", "q", "r"]

    def test_error_mode_refuses_missing_and_unseen(self):
        ts = T_onehot.StringIndexer()
        _raw(T, "y", "PickList").transform_with(ts)
        with pytest.raises(ValueError, match="missing values"):
            ts.fit(_ds(TDs, TT, [("y", "PickList", ["a", None])]), device="cpu")
        m = ts.fit(_ds(TDs, TT, [("y", "PickList", ["a", "b"])]), device="cpu")
        ds = _ds(TDs, TT, [("y", "PickList", ["zz"])])
        with pytest.raises(ValueError, match="unseen label 'zz'"):
            m.transform_columns([ds["y"]], ds)

    def test_index_to_string(self):
        labels = ["x", "y", "z"]
        jc, tc = _apply(J_onehot.IndexToString(labels), T_onehot.IndexToString(labels),
                        [("i", "Real", [0.0, 2.0, None, 3.0, -1.0, 1.0])])
        _same_col(jc, tc)


# -- ops/scalers.py: NumericBucketizer and the left-closed slot -----------------------

rng_splits = np.random.default_rng(11)
BIG = np.sort(rng_splits.normal(size=5000)).astype(np.float32)
SPLIT_CASES = {
    "default_inf": [-INF, 0.0, INF],
    "finite": [-1.0, 0.0, 1.0, 2.0],
    "inf_edges": [-INF, -1.0, 0.5, 3.0, INF],
    "flt_max": [-FLT_MAX, 0.0, FLT_MAX],
    "two": [0.0, 1.0],
    "big_inf": [-INF, *BIG[1:-1].tolist(), INF],
    "big_finite": BIG.tolist(),
}


def _normal(x: np.ndarray) -> np.ndarray:
    """``x`` with subnormal values replaced by 0 (see test_subnormals)."""
    tiny = np.finfo(np.float32).tiny
    return np.where((x != 0) & (np.abs(x) < tiny), np.float32(0), x).astype(np.float32)


def _edge_values(splits, n: int = 600, seed: int = 0) -> np.ndarray:
    """float32-exact values: every split (ties), +-inf, NaN, +-FLT_MAX, -0.0,
    values just outside the range and one ulp past each end, and random ones
    over it; no subnormals (see test_subnormals)."""
    rng = np.random.default_rng(seed)
    s = np.asarray(splits, np.float32)
    fin = s[np.isfinite(s)]
    lo, hi = (float(fin.min()), float(fin.max())) if len(fin) else (-1.0, 1.0)
    x = (rng.uniform(lo - 2, hi + 2, size=n)).astype(np.float32)
    edge = np.concatenate([
        fin[:200], [INF, -INF, np.nan, FLT_MAX, -FLT_MAX, -0.0, 0.0],
        np.float32([lo]) - np.float32(0.5), np.float32([hi]) + np.float32(0.5),
        np.nextafter(np.float32(lo), np.float32(-INF), dtype=np.float32)[None],
        np.nextafter(np.float32(hi), np.float32(INF), dtype=np.float32)[None]])
    x[:len(edge)] = edge.astype(np.float32)
    x[len(edge)::9] = np.nan
    return _normal(x)


class TestNumericBucketizer:
    @pytest.mark.parametrize("case", sorted(SPLIT_CASES))
    @pytest.mark.parametrize("tn, ti", [(True, False), (False, False), (True, True),
                                        (False, True)])
    def test_device_half_bitwise_vs_reference(self, case, tn, ti):
        splits = SPLIT_CASES[case]
        x = _edge_values(splits, seed=len(splits))
        kw = dict(splits=tuple(splits), track_nulls=tn, track_invalid=ti)
        jb, tb = J_scal.NumericBucketizer(**kw), T_scal.NumericBucketizer(**kw)
        ref = _jit(jb, x)
        got = tb.device_transform(torch.from_numpy(x))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == ref.tobytes() and got.shape == ref.shape
        # the float64 host half agrees on float32-exact values
        jf, tf = _raw(J, "x", "Real"), _raw(T, "x", "Real")
        jf.transform_with(jb)
        tf.transform_with(tb)
        vals = [None if np.isnan(v) else float(v) for v in x]
        jds, tds = _ds(JDs, JT, [("x", "Real", vals)]), _ds(TDs, TT, [("x", "Real", vals)])
        jc, tc = jb.transform_columns([jds["x"]], jds), tb.transform_columns([tds["x"]], tds)
        _same_col(jc, tc)
        assert np.asarray(tc.data).tobytes() == ref.tobytes()

    @pytest.mark.parametrize("tn, ti", [(True, False), (True, True)])
    def test_subnormals(self, tn, ti):
        """XLA's CPU flushes subnormal float32 to zero, so the reference's
        device half buckets -1e-45 as 0.0 and its own float64 host half does
        not; the port keeps subnormals (its plain version here, and the CUDA
        kernel, built without flush-to-zero), and equals the host half."""
        tiny = np.finfo(np.float32).tiny
        x = np.float32([-1e-45, 1e-45, -tiny / 2, tiny / 4, -tiny, tiny, 0.0, -0.0])
        splits = (-INF, 0.0, tiny, INF)
        kw = dict(splits=splits, track_nulls=tn, track_invalid=ti)
        tb = T_scal.NumericBucketizer(**kw)
        got = tb.device_transform(torch.from_numpy(x)).numpy()
        _raw(T, "x", "Real").transform_with(tb)
        ds = _ds(TDs, TT, [("x", "Real", [float(v) for v in x])])
        host = tb.transform_columns([ds["x"]], ds).data
        assert got.tobytes() == np.asarray(host).tobytes()
        ref = _jit(J_scal.NumericBucketizer(**kw), x)
        flushed = _jit(J_scal.NumericBucketizer(**kw), _normal(x))
        assert ref.tobytes() == flushed.tobytes() != got.tobytes()

    def test_slot_spec_is_left_closed(self):
        s = T_scal.NumericBucketizer(splits=(0.0, 1.0, 2.0), track_invalid=True)
        [spec] = s.device_slot_specs()
        assert spec.kind == TKE.BUCKETIZE and spec.closed == "left"
        assert spec.width == 2 + 1 + 1

    @pytest.mark.parametrize("n", [1, 37, 1024])
    def test_mixed_table_bitwise(self, n):
        """One-hot, right-closed and left-closed slots in one table: each
        block equal to the reference's formula for it."""
        rng = np.random.default_rng(n)
        specs, ins, refs = [], [], []
        for k, case in enumerate(["inf_edges", "finite", "default_inf", "big_inf",
                                  "flt_max"]):
            splits = SPLIT_CASES[case]
            x = _edge_values(splits, n=max(n, 600), seed=k)[:n]
            for tn, ti in ((True, False), (False, True)):
                specs.append(TKE.bucketize_slot(splits, tn, ti, closed="left"))
                ins.append(x)
                refs.append(_jit(J_scal.NumericBucketizer(
                    splits=tuple(splits), track_nulls=tn, track_invalid=ti), x))
                specs.append(TKE.bucketize_slot(splits, tn, ti))
                ins.append(x)
                refs.append(np.asarray(device_bucketize_right(
                    jnp.asarray(x), jnp.asarray(np.asarray(splits, np.float32)), tn, ti)))
            w = int(rng.integers(1, 9))
            codes = rng.integers(-2, w + 3, n).astype(np.int32)
            specs.append(TKE.onehot_slot(w))
            ins.append(codes)
            refs.append(np.asarray(jax.nn.one_hot(jnp.asarray(codes), w,
                                                  dtype=jnp.float32)))
        table = TKE.plan_slots(specs)
        assert table.n_left == 10 and len(table.chunks) >= 2   # big_inf: its own
        got = TKE.encode_slots([torch.from_numpy(a) for a in ins], table).numpy()
        for k, ref in enumerate(refs):
            block = got[:, table.col[k]:table.col[k] + specs[k].width]
            assert block.tobytes() == np.ascontiguousarray(ref).tobytes(), (k, specs[k].kind)

    def test_closed_defaults_right_and_is_checked(self):
        old = TKE.SlotSpec(TKE.BUCKETIZE, width=2, splits=(0.0, 1.0, 2.0))
        assert old.closed == "right"
        t = TKE.plan_slots([old])
        assert t.rows[0, 2] == 1 and t.n_left == 0
        left = TKE.plan_slots([TKE.bucketize_slot([0, 1, 2], True, True, "left")])
        assert left.rows[0, 2] == 1 | 2 | 4 | 8 and left.n_left == 1
        with pytest.raises(ValueError, match="closed edge"):
            TKE.plan_slots([old._replace(closed="middle")])

    def test_cpu_tensors_launch_nothing(self):
        TKE.reset_launch_counts()
        s = T_scal.NumericBucketizer()
        s.device_transform(torch.zeros(4))
        assert TKE.left_closed_launches == TKE.left_closed_slots == 0
        assert TKE.launch_counts()["encode_slots"] == 0


class TestPercentileCalibrator:
    @pytest.mark.parametrize("buckets", [100, 7])
    def test_fit_and_both_halves(self, buckets):
        rng = np.random.default_rng(buckets)
        vals = rng.normal(size=500).tolist()
        specs = [("s", "RealNN", vals)]
        jf, tf = _raw(J, "s", "RealNN"), _raw(T, "s", "RealNN")
        je, te = J_scal.PercentileCalibrator(buckets=buckets), \
            T_scal.PercentileCalibrator(buckets=buckets)
        jf.transform_with(je)
        tf.transform_with(te)
        jds, tds = _ds(JDs, JT, specs), _ds(TDs, TT, specs)
        jm, tm = je.fit(jds), te.fit(tds, device="cpu")
        np.testing.assert_array_equal(tm.splits, jm.splits)
        _same_col(jm.transform_columns([jds["s"]], jds), tm.transform_columns([tds["s"]], tds))
        x = np.concatenate([np.asarray(vals, np.float32),
                            jm.splits.astype(np.float32), np.float32([INF, -INF])])
        ref = _jit(jm, x)
        got = tm.device_transform(torch.from_numpy(x)).numpy()
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


# -- dsl.py ---------------------------------------------------------------------------

def _stage_of(feature):
    st = feature.origin_stage
    return type(st).__name__, {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
                               for k, v in st.get_params().items()}


#: the reference's text, NER, embedding, time-period, phone, e-mail, URL
#: and MIME shortcuts: name -> the features it builds from raw ones
TEXT_SHORTCUTS = {
    "tokenize": lambda raw: [raw("t", "Text").tokenize(),
                             raw("u", "Text").tokenize(language="en", min_token_length=2)],
    "name_entity_tags": lambda raw: [raw("t", "Text").name_entity_tags()],
    "word2vec": lambda raw: [raw("l", "TextList").word2vec(embedding_dim=8, epochs=1)],
    "lda_topics": lambda raw: [raw("l", "TextList").lda_topics(k=3)],
    "to_time_period": lambda raw: [raw("d", "Date").to_time_period("DayOfWeek"),
                                   raw("dl", "DateList").to_time_period("HourOfDay"),
                                   raw("dm", "DateMap").to_time_period("WeekOfYear")],
    "to_ngram_similarity": lambda raw: [raw("t", "Text").to_ngram_similarity(
        raw("u", "Text"), n=2)],
    "jaccard_similarity": lambda raw: [raw("m", "MultiPickList").jaccard_similarity(
        raw("n", "MultiPickList"))],
    "detect_languages": lambda raw: [raw("t", "Text").detect_languages()],
    "parse_phone": lambda raw: [raw("p", "Phone").parse_phone(),
                                raw("q", "Phone").parse_phone(raw("r", "Text"))],
    "is_valid_phone": lambda raw: [raw("p", "Phone").is_valid_phone(default_region="GB"),
                                   raw("q", "Phone").is_valid_phone(raw("r", "Text"))],
    "to_email_prefix": lambda raw: [raw("e", "Email").to_email_prefix()],
    "to_email_domain": lambda raw: [raw("e", "Email").to_email_domain()],
    "is_valid_email": lambda raw: [raw("e", "Email").is_valid_email()],
    "to_domain": lambda raw: [raw("w", "URL").to_domain()],
    "to_protocol": lambda raw: [raw("w", "URL").to_protocol()],
    "is_valid_url": lambda raw: [raw("w", "URL").is_valid_url()],
    "detect_mime_types": lambda raw: [raw("b", "Base64").detect_mime_types()],
}


class TestDsl:
    @pytest.mark.parametrize("build", [
        lambda p, a, b, s: a + b, lambda p, a, b, s: a - b,
        lambda p, a, b, s: a * b, lambda p, a, b, s: a / b,
        lambda p, a, b, s: a + 1, lambda p, a, b, s: a - 2.5,
        lambda p, a, b, s: a * 3, lambda p, a, b, s: a / 4,
        lambda p, a, b, s: a.bucketize([0.0, 1.0, 5.0], track_nulls=False),
        lambda p, a, b, s: a.alias("aa"),
        lambda p, a, b, s: s.indexed(handle_invalid="keep"),
        lambda p, a, b, s: a.scale(slope=2.0),
        lambda p, a, b, s: a.to_occur(),
        lambda p, a, b, s: s.exists(long_text),
        lambda p, a, b, s: s.filter_values(long_text, "x"),
        lambda p, a, b, s: s.replace_with("a", "b"),
        lambda p, a, b, s: s.pivot(min_support=1),
        lambda p, a, b, s: a.fill_missing_with_mean().z_normalize(),
        lambda p, a, b, s: a.map_to(is_positive, p.types.Binary, name="pos"),
        lambda p, a, b, s: p.dsl.combine([s.pivot(), a.bucketize([0.0, 1.0])]),
    ])
    def test_shortcut_builds_the_reference_stage(self, build):
        got = []
        for pkg in (J, T):
            a, b = _raw(pkg, "a", "Real"), _raw(pkg, "b", "Integral")
            s = _raw(pkg, "s", "PickList")
            out = build(pkg, a, b, s)
            got.append((_stage_of(out), out.ftype.__name__, out.is_response))
        assert got[0] == got[1]

    def test_arithmetic_with_a_non_number_is_refused(self):
        a = _raw(T, "a", "Real")
        with pytest.raises(TypeError):
            a + "x"

    def test_descale(self):
        a = _raw(T, "a", "Real")
        sc = a.scale()
        assert type(a.descale(sc).origin_stage).__name__ == "DescalerTransformer"

    @pytest.mark.parametrize("name", sorted(TEXT_SHORTCUTS))
    def test_text_shortcut_builds_the_reference_stage(self, name):
        assert hasattr(J.features.feature.Feature, name)
        got = []
        for pkg in (J, T):
            outs = TEXT_SHORTCUTS[name](lambda n, t: _raw(pkg, n, t))
            got.append([(_stage_of(o), o.ftype.__name__,
                         getattr(o.origin_stage, "operation_name", None)) for o in outs])
        assert got[0] == got[1]


# -- serde both ways ------------------------------------------------------------------

def _serde_pipeline(pkg, misc, onehot, scal, math_mod, fb_types):
    """A fitted-able DAG over every new class that saves."""
    y = _raw(pkg, "y", "PickList", response=True)
    a, b = _raw(pkg, "a", "Real"), _raw(pkg, "b", "Integral")
    s, r = _raw(pkg, "s", "PickList"), _raw(pkg, "r", "RealNN")
    outs = [
        y.transform_with(onehot.StringIndexer()),
        a.transform_with(math_mod.BinaryMathTransformer(op="divide"), b),
        a.transform_with(math_mod.ScalarMathTransformer(op="minus", scalar=2.0)),
        a.alias("a_alias"),
        a.transform_with(scal.NumericBucketizer(splits=(-INF, -1.0, 0.5, INF),
                                                track_invalid=True)),
        r.transform_with(scal.PercentileCalibrator(buckets=10)),
        s.transform_with(misc.ExistsTransformer(long_text, fb_types.PickList)),
        s.transform_with(misc.FilterTransformer(long_text, "f", fb_types.PickList)),
        s.transform_with(misc.ReplaceTransformer(fb_types.PickList, old_value="ab",
                                                 new_value="z")),
        s.transform_with(misc.SubstringTransformer(), s),
        s.transform_with(misc.ToOccurTransformer(input_type=fb_types.PickList)),
        a.transform_with(misc.ScalerTransformer(slope=3.0)),
    ]
    outs.append(outs[-1].transform_with(misc.DescalerTransformer(), outs[-1]))
    idx = s.transform_with(onehot.StringIndexer())
    outs.append(idx.transform_with(onehot.IndexToString(["ab", "abcd"])))
    return outs


def _serde_table(n=40, seed=2):
    rng = np.random.default_rng(seed)
    return [("y", "PickList", [str(v) for v in rng.choice(["p", "q"], n)]),
            ("a", "Real", [None if v < -1 else float(v) for v in rng.normal(size=n)]),
            ("b", "Integral", [int(v) for v in rng.integers(-2, 3, n)]),
            ("s", "PickList", [str(v) for v in rng.choice(["ab", "abcd", "x"], n)]),
            ("r", "RealNN", rng.normal(size=n).tolist())]


@pytest.fixture(scope="module")
def serde_models(tmp_path_factory):
    J_fn.register_function("dsl_long_text")(long_text)
    T_fn.register_function("dsl_long_text")(long_text)
    specs = _serde_table()
    jouts = _serde_pipeline(J, J_misc, J_onehot, J_scal, J_math, JT)
    touts = _serde_pipeline(T, T_misc, T_onehot, T_scal, T_math, TT)
    jm = J.Workflow().set_input_dataset(_ds(JDs, JT, specs)) \
        .set_result_features(*jouts).train()
    tm = T.Workflow().set_input_dataset(_ds(TDs, TT, specs)) \
        .set_result_features(*touts).train(device="cpu")
    base = tmp_path_factory.mktemp("dsl_serde")
    jm.save(str(base / "jax"))
    tm.save(str(base / "torch"))
    return jm, tm, base


def _scored(model, specs, torch_side):
    ds = _ds(TDs if torch_side else JDs, TT if torch_side else JT, specs)
    out = model.score(ds, True, device="cpu") if torch_side else model.score(ds, True)
    return {f.name: out[f.name] for f in model.result_features}


class TestSerde:
    def test_port_trained_equals_jax_trained(self, serde_models):
        jm, tm, _ = serde_models
        specs = _serde_table(30, seed=9)
        js, ts = _scored(jm, specs, False), _scored(tm, specs, True)
        assert len(js) == len(ts) == 14
        for (jn, jc), (tn, tc) in zip(js.items(), ts.items()):
            _same_col(jc, tc)

    def test_jax_saved_loads_in_port(self, serde_models):
        jm, _, base = serde_models
        loaded = TModel.load(str(base / "jax"))
        specs = _serde_table(30, seed=9)
        for jc, tc in zip(_scored(jm, specs, False).values(),
                          _scored(loaded, specs, True).values()):
            _same_col(jc, tc)

    def test_port_saved_loads_in_jax(self, serde_models):
        _, tm, base = serde_models
        loaded = JModel.load(str(base / "torch"))
        specs = _serde_table(30, seed=9)
        for tc, jc in zip(_scored(tm, specs, True).values(),
                          _scored(loaded, specs, False).values()):
            _same_col(jc, tc)

    def test_types_cross_by_the_reference_path(self):
        d = T_fn.encode_function(TT.MultiPickList)
        assert d == J_fn.encode_function(JT.MultiPickList)
        assert T_fn.decode_function(d) is TT.MultiPickList
        with pytest.raises(ValueError, match="never imports"):
            T_fn.decode_function({"__imported_fn__": "transmogrifai_tpu.dsl:combine"})

    def test_a_lambda_is_refused_at_save(self, tmp_path):
        a = _raw(T, "a", "Real")
        out = a.exists(lambda v: v is not None)
        m = T.Workflow().set_input_dataset(_ds(TDs, TT, [("a", "Real", [1.0])])) \
            .set_result_features(out).train(device="cpu")
        with pytest.raises(ValueError, match="cannot save the function"):
            m.save(str(tmp_path / "m"))


# -- the slice as a whole ---------------------------------------------------------------

import sys  # noqa: E402

from transmogrifai_tpu.perf.kernels import dispatch as KD  # noqa: E402
from transmogrifai_tpu.workflow import fit as JFit  # noqa: E402
from transmogrifai_tpu_torch.workflow import fit as TFit  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__))))
from torch_wide_data import dsl_pipeline, make_data, score_column  # noqa: E402

SLICE_SHAPE = dict(n_real=28, n_bucketized=3, n_pick=5, n_levels=30, n_binary=2)
SLICE_ROWS = 3000


@pytest.fixture(scope="module")
def dsl_both(tmp_path_factory):
    """The wide table plus the DSL's features (``dsl_pipeline``) trained by
    both packages on the same columns; the JAX model also saved."""
    cols, schema = make_data(SLICE_ROWS, seed=4, **SLICE_SHAPE)
    cols["score"] = score_column(SLICE_ROWS, seed=4)
    out = {"cols": cols, "schema": schema}
    for key, pkg, tmod, ds_cls in (("j", J, JT, JDs), ("t", T, TT, TDs)):
        ftypes = {s["name"]: tmod.feature_type_by_name(s["type"]) for s in schema}
        ftypes["score"] = tmod.RealNN
        label, sel, chk, pred = dsl_pipeline(pkg, ftypes, schema)
        ds = ds_cls.from_features(cols, ftypes)
        wf = pkg.Workflow().set_input_dataset(ds).set_result_features(label, pred)
        if key == "j":
            with KD.force_kernel_mode("interpret"):
                model = wf.train()
        else:
            model = wf.train(device="cpu")
        out[key] = dict(model=model, ds=ds, wf=wf, sel=sel, chk=chk, pred=pred)
    path = str(tmp_path_factory.mktemp("dsl_slice") / "jax")
    out["j"]["model"].save(path)
    out["j_path"] = path
    return out


def _records(cols, rows) -> list:
    names = [n for n in cols if n != "label"]
    return [{n: cols[n][i] for n in names} for i in rows]


class TestSlice:
    def test_training_vector_bitwise(self, dsl_both):
        vecs = []
        for key in ("j", "t"):
            side = dsl_both[key]
            vec = side["chk"].inputs[1]
            if key == "j":
                with KD.force_kernel_mode("interpret"):
                    col = JFit.transform_dag(side["ds"], [vec], side["model"].fitted)[vec.name]
            else:
                col = TFit.transform_dag(side["ds"], [vec], side["model"].fitted, "cpu")[vec.name]
            vecs.append(col)
        a, b = np.asarray(vecs[0].data), vecs[1].data
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        assert _meta(vecs[0].meta) == _meta(vecs[1].meta)

    def test_lr_cv_and_winner(self, dsl_both):
        js = dsl_both["j"]["model"].fitted[dsl_both["j"]["sel"].uid].summary
        ts = dsl_both["t"]["model"].fitted[dsl_both["t"]["sel"].uid].summary
        assert (ts.best_model_name, ts.best_grid) == (js.best_model_name, js.best_grid)
        for a, b in zip(js.validation_results, ts.validation_results):
            np.testing.assert_allclose(b.metric_values, a.metric_values, rtol=0, atol=1e-4)

    def test_one_flush_encodes_every_slot(self, dsl_both):
        """The math features flush on the host first; every one-hot and
        bucketize slot (the left-closed ones among them) is in the one
        flush before the SanityChecker: one encode call."""
        flushes = [r for r in dsl_both["t"]["wf"].last_train_profile
                   if r["kind"] == "flush" and r.get("encode_slots")]
        assert len(flushes) == 1
        assert flushes[0]["encode_slots"] == 3 + 8 + 5

    def test_serving_partition_equals_the_reference(self, dsl_both):
        jplan = dsl_both["j"]["model"].serving_plan()
        tplan = dsl_both["t"]["model"].serving_plan(device="cpu")
        for attr in ("_prefix", "_remainder"):
            assert sorted(type(r).__name__ for r in getattr(tplan, attr)) == \
                sorted(type(r).__name__ for r in getattr(jplan, attr)), attr
        assert len(tplan._encode_table) == 16 and tplan._encode_table.n_left == 8

    def test_jax_model_served_by_the_port_equals_the_reference(self, dsl_both):
        recs = _records(dsl_both["cols"], range(0, 256))
        want = dsl_both["j"]["model"].serving_plan().score(recs)
        got = TModel.load(dsl_both["j_path"]).serving_plan(device="cpu").score(recs)
        assert got == want

    def test_port_model_serves_its_own_scores(self, dsl_both):
        side = dsl_both["t"]
        recs = _records(dsl_both["cols"], range(100, 228))
        served = side["model"].serving_plan(device="cpu").score(recs)
        scored = side["model"].score(side["ds"], device="cpu")[side["pred"].name]
        np.testing.assert_allclose([r[side["pred"].name]["probability_1"] for r in served],
                                   scored.prob[100:228, 1], rtol=0, atol=1e-12)
