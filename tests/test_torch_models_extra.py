"""The MLP, the isotonic calibrator, random grids and the model combiner:
the port against the JAX package.

- ``MultilayerPerceptronClassifier``: with the reference's initial draws
  fed to ``models/mlp.py::draw_mlp_init``, the fitted weights within 1e-4
  relative (of each array's largest magnitude; measured 3e-6 .. 3.4e-5 on
  these cases) and the fold-batched CV sweep's metrics within 1e-4 of the
  reference's and of the port's own generic (a fit per grid and fold)
  sweep; the reference's cases (a nonlinear XOR, multiclass shapes, fit /
  copy / transform) on the port.
- ``pav_fit`` and ``IsotonicRegressionCalibrator``: knots and transforms
  bitwise.
- ``RandomParamBuilder``: ``build(n)`` equal for the same seed.
- ``SelectedModelCombiner``: the chosen weights, strategy, metrics and the
  combined predictions of the reference's cases, each strategy.
- Serde: a model holding an MLP, an isotonic calibrator or a combiner saves
  in one package and loads and scores in the other, both ways.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transmogrifai_tpu as J
from transmogrifai_tpu.evaluators.base import BinaryClassificationEvaluator as JBCE
from transmogrifai_tpu.models import combiner as JC
from transmogrifai_tpu.models import isotonic as JI
from transmogrifai_tpu.models import mlp as JM
from transmogrifai_tpu.models import random_param as JRP
from transmogrifai_tpu.models.logistic import LogisticRegression as JLR
from transmogrifai_tpu.models.selector import ModelSelector as JMS
from transmogrifai_tpu.models.tuning import CrossValidator as JCV
from transmogrifai_tpu.perf.kernels import dispatch as KD
from transmogrifai_tpu.workflow.workflow import WorkflowModel as JWM
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.data.dataset import Column
from transmogrifai_tpu_torch.evaluators.base import BinaryClassificationEvaluator as TBCE
from transmogrifai_tpu_torch.models import combiner as TC
from transmogrifai_tpu_torch.models import isotonic as TI
from transmogrifai_tpu_torch.models import mlp as TM
from transmogrifai_tpu_torch.models import random_param as TRP
from transmogrifai_tpu_torch.models.base import PredictionEstimatorBase
from transmogrifai_tpu_torch.models.logistic import LogisticRegression as TLR
from transmogrifai_tpu_torch.models.prediction import PredictionColumn
from transmogrifai_tpu_torch.models.selector import ModelSelector as TMS
from transmogrifai_tpu_torch.models.tuning import CrossValidator as TCV

CPU = torch.device("cpu")


def reference_draws(sizes, seed, device):
    """The reference's ``jax.random`` initial draws, as the port's seam
    returns them."""
    return [(torch.from_numpy(np.array(w)).to(device), torch.from_numpy(np.array(b)).to(device))
            for w, b in JM._init_params(tuple(sizes), jax.random.PRNGKey(seed))]


@pytest.fixture
def fed(monkeypatch):
    monkeypatch.setattr(TM, "draw_mlp_init", reference_draws)


def _xor(n=600, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 2)).astype(np.float32)
    return x, ((x[:, 0] * x[:, 1]) > 0).astype(np.float64)


def _multiclass(n=300, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 4)).astype(np.float32)
    return x, np.argmax(x[:, :3] + rng.normal(0, 0.5, (n, 3)), axis=1).astype(np.float64)


def _rel_weights(jm, tm):
    out = 0.0
    for (a, b), (c, e) in zip(jm.weights, tm.weights):
        assert a.shape == c.shape and b.shape == e.shape
        out = max(out, np.abs(np.asarray(a) - c).max() / np.abs(a).max(),
                  np.abs(np.asarray(b) - e).max() / max(np.abs(b).max(), 1e-12))
    return out


class TestMLP:
    @pytest.mark.parametrize("case", ["xor", "multiclass"])
    def test_weights_match_the_reference(self, fed, case):
        if case == "xor":
            x, y = _xor()
            kw = dict(hidden_layers=(16,), max_iter=400, learning_rate=0.05)
        else:
            x, y = _multiclass()
            kw = dict(hidden_layers=(8,), max_iter=150)
        w = np.ones_like(y, dtype=np.float32)
        jm = JM.MultilayerPerceptronClassifier(**kw)._fit_arrays(x, y, w)
        tm = TM.MultilayerPerceptronClassifier(**kw)._fit_arrays(x, y, w, CPU)
        assert _rel_weights(jm, tm) < 1e-4
        np.testing.assert_array_equal(tm.classes, jm.classes)
        tp = tm.predict_column(Column.vector(x))
        jp = jm.predict_column(J.Column.vector(x))
        np.testing.assert_allclose(tp.prob, jp.prob, rtol=0, atol=1e-4)

    def test_learns_nonlinear(self):
        x, y = _xor()
        m = TM.MultilayerPerceptronClassifier(hidden_layers=(16,), max_iter=400) \
            ._fit_arrays(x, y, np.ones_like(y, dtype=np.float32), CPU)
        assert (m.predict_column(Column.vector(x)).pred == y).mean() > 0.9

    def test_multiclass_shapes(self):
        x, y = _multiclass()
        m = TM.MultilayerPerceptronClassifier(hidden_layers=(8,), max_iter=150) \
            ._fit_arrays(x, y, np.ones_like(y, dtype=np.float32), CPU)
        pc = m.predict_column(Column.vector(x))
        assert pc.prob.shape == (300, 3) and pc.raw.shape == (300, 3)
        np.testing.assert_allclose(pc.prob.sum(axis=1), 1.0)

    def test_fit_copy_transform(self):
        """The estimator's fit through a dataset, its copy and its model's
        transform (the reference's estimator spec, by hand)."""
        x, y = _xor(150)
        ds = T.Dataset({"label": Column(T.types.RealNN, y, np.ones(len(y), bool)),
                        "vec": Column.vector(x)})
        label = T.FeatureBuilder.of("label", T.types.RealNN).extract_field().as_response()
        vec = T.FeatureBuilder.of("vec", T.types.OPVector).extract_field().as_predictor()
        est = TM.MultilayerPerceptronClassifier(hidden_layers=(4,), max_iter=50)
        pred = label.transform_with(est, vec)
        model = est.fit(ds, device="cpu")
        assert model.uid == est.uid and model.get_output() is pred
        clone = est.copy().set_params(max_iter=10)
        assert est.max_iter == 50 and clone.max_iter == 10 and clone.uid == est.uid
        out = model.transform(ds)[pred.name]
        assert isinstance(out, PredictionColumn) and out.prob.shape == (150, 2)

    def _sweep_case(self):
        rng = np.random.default_rng(27)
        n, d = 300, 5
        x = rng.normal(size=(n, d)).astype(np.float32)
        y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)
        folds = rng.integers(0, 2, n)
        tw = np.stack([(folds != f).astype(np.float32) for f in range(2)])
        vw = np.stack([(folds == f).astype(np.float32) for f in range(2)])
        grids = [{"hidden_layers": (4,), "max_iter": 40},
                 {"hidden_layers": (8,), "max_iter": 40}]
        return x, y, tw, vw, grids

    def test_fold_batched_sweep_matches_generic_and_reference(self, fed):
        x, y, tw, vw, grids = self._sweep_case()

        def jmetric(payload, yt, w):
            pred = (payload > 0.5).astype(jnp.float32)
            return (w * (pred == yt)).sum() / jnp.maximum(w.sum(), 1e-12)

        def tmetric(payload, yt, w):
            pred = (payload > 0.5).to(torch.float32)
            return (w * (pred == yt)).sum() / torch.clamp(w.sum(), min=1e-12)

        est = TM.MultilayerPerceptronClassifier()
        fast = est.cv_sweep(x, y, tw, vw, grids, tmetric, CPU)
        slow = PredictionEstimatorBase._cv_sweep_generic(est, x, y, tw, vw, grids,
                                                         tmetric, CPU)
        ref = np.asarray(JM.MultilayerPerceptronClassifier().cv_sweep(
            x, y, tw, vw, grids, jmetric))
        np.testing.assert_allclose(fast, slow, rtol=0, atol=1e-4)
        np.testing.assert_allclose(fast, ref, rtol=0, atol=1e-4)

    def test_selector_cv_with_the_evaluator_metric(self, fed):
        """Through a ModelSelector's CrossValidator (auPR) in both packages."""
        x, y = _xor(400, seed=9)
        grids = [{"hidden_layers": (6,), "max_iter": 60}]
        jv = JCV(JBCE(), num_folds=3).validate(
            [(JM.MultilayerPerceptronClassifier(), grids)], x, y, None)
        tv = TCV(TBCE(), num_folds=3).validate(
            [(TM.MultilayerPerceptronClassifier(), grids)], x, y, None, CPU)
        np.testing.assert_allclose(tv.evaluations[0].metric_values,
                                   jv.evaluations[0].metric_values, rtol=0, atol=1e-4)

    def test_device_payloads_equal_the_host_head(self):
        x, y = _multiclass()
        m = TM.MultilayerPerceptronClassifier(hidden_layers=(8,), max_iter=20) \
            ._fit_arrays(x, y, np.ones_like(y, dtype=np.float32), CPU)
        host = m.predict_column(Column.vector(x))
        np.testing.assert_allclose(m.insight_payload(torch.from_numpy(x)).numpy(),
                                   host.prob, rtol=0, atol=1e-12)
        xb, yb = _xor(200)
        mb = TM.MultilayerPerceptronClassifier(hidden_layers=(4,), max_iter=20) \
            ._fit_arrays(xb, yb, np.ones_like(yb, dtype=np.float32), CPU)
        score, pred = mb.eval_payload_device(xb, CPU)
        hb = mb.predict_column(Column.vector(xb))
        np.testing.assert_array_equal(score.numpy(), hb.prob[:, 1].astype(np.float32))
        np.testing.assert_array_equal(pred.numpy(), hb.pred.astype(np.float32))
        assert m.eval_payload_device(x, CPU) is None


class TestIsotonic:
    def _cases(self):
        rng = np.random.default_rng(5)
        s = rng.uniform(0, 1, 300)
        yield s, (rng.random(300) < s).astype(np.float64), np.ones(300), True
        yield (np.array([0.0, 1.0, 2.0, 3.0]), np.array([3.0, 2.0, 1.0, 0.0]),
               np.ones(4), False)
        yield np.array([0.3, 0.3, 0.7]), np.array([0.0, 1.0, 1.0]), np.ones(3), True
        q = np.round(rng.uniform(0, 1, 500), 2)   # quantized scores: many ties
        yield q, (rng.random(500) < q ** 2).astype(np.float64), rng.uniform(0.5, 2, 500), True

    def test_knots_bitwise(self):
        for s, y, w, inc in self._cases():
            jk = JI.pav_fit(s, y, w, increasing=inc)
            tk = TI.pav_fit(s, y, w, increasing=inc)
            for a, b in zip(jk, tk):
                assert a.tobytes() == b.tobytes()
        kx, ky = TI.pav_fit(np.array([0.3, 0.3, 0.7]), np.array([0.0, 1.0, 1.0]),
                            np.ones(3))
        assert np.interp(0.3, kx, ky) == pytest.approx(0.5)

    def test_calibrator_stage_bitwise(self):
        rng = np.random.default_rng(6)
        n = 300
        score = rng.uniform(0, 1, n)
        y = (rng.random(n) < score ** 2).astype(np.float64)
        outs = []
        for pkg, iso in ((J, JI), (T, TI)):
            ds = pkg.Dataset.from_features({"label": y.tolist(), "score": score.tolist()},
                                           {"label": pkg.types.RealNN,
                                            "score": pkg.types.RealNN})
            label = pkg.FeatureBuilder.of("label", pkg.types.RealNN).extract_field() \
                .as_response()
            sc = pkg.FeatureBuilder.of("score", pkg.types.RealNN).extract_field() \
                .as_predictor()
            est = iso.IsotonicRegressionCalibrator()
            est.set_input(label, sc)
            model = est.fit(ds) if pkg is J else est.fit(ds, device="cpu")
            outs.append((model, np.asarray(model.transform(ds)[model.output_name].data)))
        (jm, jo), (tm, to) = outs
        assert jm.knots_x.tobytes() == tm.knots_x.tobytes()
        assert jm.knots_y.tobytes() == tm.knots_y.tobytes()
        assert jo.tobytes() == to.tobytes()
        assert abs(to.mean() - y.mean()) < abs(score.mean() - y.mean())


class TestRandomParamBuilder:
    def _build(self, mod, seed):
        return (mod.RandomParamBuilder(seed=seed)
                .exponential("reg_param", 1e-4, 1e-1)
                .uniform("max_depth", 2, 8, integer=True)
                .uniform("elastic_net", 0.0, 1.0)
                .subset("hidden_layers", [(4,), (8,), (16, 4)])
                .build(25))

    @pytest.mark.parametrize("seed", [7, 42])
    def test_build_equals_the_reference(self, seed):
        assert self._build(TRP, seed) == self._build(JRP, seed)

    def test_refusals(self):
        with pytest.raises(ValueError, match="min must be less"):
            TRP.RandomParamBuilder().uniform("a", 1, 1)
        with pytest.raises(ValueError, match="0 < min < max"):
            TRP.RandomParamBuilder().exponential("a", 0.0, 1.0)
        with pytest.raises(ValueError, match="at least one"):
            TRP.RandomParamBuilder().subset("a", [])
        with pytest.raises(ValueError, match="no param"):
            TRP.RandomParamBuilder().build(1)


def _combiner_workflow(pkg, strategy, n=200, seed=3):
    """The reference's combiner case in ``pkg``: a strong model on x1 and a
    weak one on x2, combined by ``strategy``."""
    lr, ms, cv, bce, comb = ((JLR, JMS, JCV, JBCE, JC) if pkg is J
                             else (TLR, TMS, TCV, TBCE, TC))
    rng = np.random.default_rng(seed)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    y = ((x1 + 0.3 * rng.normal(size=n)) > 0).astype(float)
    label = pkg.FeatureBuilder.of("y", pkg.types.RealNN).extract_field().as_response()
    f1 = pkg.FeatureBuilder.of("x1", pkg.types.Real).extract_field().as_predictor()
    f2 = pkg.FeatureBuilder.of("x2", pkg.types.Real).extract_field().as_predictor()
    ds = pkg.Dataset.from_features({"y": y.tolist(), "x1": x1.tolist(), "x2": x2.tolist()},
                                   {"y": pkg.types.RealNN, "x1": pkg.types.Real,
                                    "x2": pkg.types.Real})

    def selector(s):
        return ms(models=[(lr(), [{"reg_param": 0.01}])],
                  validator=cv(bce(), num_folds=2, seed=s), splitter=None)

    p1 = selector(1).set_input(label, pkg.transmogrify([f1])).get_output()
    p2 = selector(2).set_input(label, pkg.transmogrify([f2])).get_output()
    c = comb.SelectedModelCombiner(combination_strategy=strategy)
    out = c.set_input(label, p1, p2).get_output()
    wf = pkg.Workflow().set_input_dataset(ds).set_result_features(label, out)
    if pkg is J:
        with KD.force_kernel_mode("interpret"):
            model = wf.train()
        scored = model.score(ds)[out.name]
    else:
        model = wf.train(device="cpu")
        scored = model.score(ds, device="cpu")[out.name]
    return model, model.fitted[c.uid], scored, ds, out


class TestCombiner:
    @pytest.mark.parametrize("strategy", ["best", "weighted", "equal"])
    def test_strategy_equals_the_reference(self, strategy):
        _, jf, jp, _, _ = _combiner_workflow(J, strategy)
        _, tf, tp, _, _ = _combiner_workflow(T, strategy)
        assert (tf.strategy, tf.metric_name) == (jf.strategy, jf.metric_name)
        np.testing.assert_allclose([tf.metric1, tf.metric2], [jf.metric1, jf.metric2],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose([tf.weight1, tf.weight2], [jf.weight1, jf.weight2],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tp.prob, np.asarray(jp.prob), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tp.pred, np.asarray(jp.pred))
        if strategy == "best":
            assert (tf.weight1, tf.weight2) == (1.0, 0.0) and tf.metric1 > tf.metric2
        elif strategy == "weighted":
            assert 0.5 < tf.weight1 < 1.0
            np.testing.assert_allclose(tp.prob.sum(axis=1), 1.0, rtol=1e-6)
        else:
            assert tf.weight1 == tf.weight2 == 0.5

    def test_mismatched_problem_types_raise(self):
        p_cls = PredictionColumn.classification(np.zeros((3, 2)), np.full((3, 2), 0.5))
        p_reg = PredictionColumn.regression(np.zeros(3))
        with pytest.raises(ValueError, match="classifier with a regressor"):
            TC._combine(p_cls, p_reg, 0.5, 0.5)

    def test_bad_strategy_rejected(self):
        with pytest.raises(ValueError, match="combination_strategy"):
            TC.SelectedModelCombiner(combination_strategy="median")


# -- serde both ways -----------------------------------------------------------

def _mlp_workflow(pkg):
    rng = np.random.default_rng(8)
    n = 300
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    y = ((x1 * x2) > 0).astype(float)
    ds = pkg.Dataset.from_features({"y": y.tolist(), "x1": x1.tolist(), "x2": x2.tolist()},
                                   {"y": pkg.types.RealNN, "x1": pkg.types.Real,
                                    "x2": pkg.types.Real})
    label = pkg.FeatureBuilder.of("y", pkg.types.RealNN).extract_field().as_response()
    feats = [pkg.FeatureBuilder.of(c, pkg.types.Real).extract_field().as_predictor()
             for c in ("x1", "x2")]
    mlp = (JM if pkg is J else TM).MultilayerPerceptronClassifier(
        hidden_layers=(8,), max_iter=60)
    pred = label.transform_with(mlp, pkg.transmogrify(feats))
    return ds, (label, pred), pred


def _isotonic_workflow(pkg):
    rng = np.random.default_rng(6)
    n = 300
    score = rng.uniform(0, 1, n)
    y = (rng.random(n) < score ** 2).astype(np.float64)
    ds = pkg.Dataset.from_features({"label": y.tolist(), "score": score.tolist()},
                                   {"label": pkg.types.RealNN, "score": pkg.types.RealNN})
    label = pkg.FeatureBuilder.of("label", pkg.types.RealNN).extract_field().as_response()
    sc = pkg.FeatureBuilder.of("score", pkg.types.RealNN).extract_field().as_predictor()
    cal = label.transform_with((JI if pkg is J else TI).IsotonicRegressionCalibrator(), sc)
    return ds, (label, cal), cal


def _values(col):
    for attr in ("prob", "data"):
        v = getattr(col, attr, None)
        if v is not None:
            return np.asarray(v, np.float64)


@pytest.mark.parametrize("kind", ["mlp", "isotonic", "combiner"])
def test_saves_and_loads_both_ways(kind, tmp_path):
    import transmogrifai_tpu.models.combiner  # noqa: F401  (the reference's loader
    import transmogrifai_tpu.models.isotonic  # noqa: F401   reads a class once its
    import transmogrifai_tpu.models.logistic  # noqa: F401   module is imported)
    import transmogrifai_tpu.models.mlp  # noqa: F401

    got = {}
    for src in (J, T):
        if kind == "combiner":
            model, _, _, ds, out = _combiner_workflow(src, "weighted")
        else:
            ds, results, out = (_mlp_workflow if kind == "mlp" else _isotonic_workflow)(src)
            wf = src.Workflow().set_input_dataset(ds).set_result_features(*results)
            if src is J:
                with KD.force_kernel_mode("interpret"):
                    model = wf.train()
            else:
                model = wf.train(device="cpu")
        path = str(tmp_path / src.__name__)
        model.save(path)
        dst = T if src is J else J
        loaded = (T.WorkflowModel if dst is T else JWM).load(path)
        cls = {"mlp": "MLPClassifierModel", "isotonic": "IsotonicCalibratorModel",
               "combiner": "SelectedCombinerModel"}[kind]
        assert any(type(t).__name__ == cls for t in loaded.fitted.values())
        raw = {n: ds[n] for n in ds.names}
        if dst is T:
            ds_dst = T.Dataset({n: Column(T.types.feature_type_by_name(c.ftype.__name__),
                                          np.asarray(c.data), c.mask, None)
                                for n, c in raw.items()})
            a = loaded.score(ds_dst, device="cpu")[out.name]
            with KD.force_kernel_mode("interpret"):
                b = model.score(ds)[out.name]
        else:
            ds_dst = J.Dataset({n: J.Column(J.types.feature_type_by_name(c.ftype.__name__),
                                            np.asarray(c.data), c.mask, None)
                                for n, c in raw.items()})
            with KD.force_kernel_mode("interpret"):
                a = loaded.score(ds_dst)[out.name]
            b = model.score(ds, device="cpu")[out.name]
        got[src.__name__] = (_values(a), _values(b))
    for a, b in got.values():
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
