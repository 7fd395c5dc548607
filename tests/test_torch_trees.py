"""The port's tree module against the JAX package's, on the CPU.

- quantile edges, host binning and device digitization: bitwise;
- the level-wise grower on the reference's growth fixture
  (``tests/test_kernels.py::_growth_fixture``), int-exact and float: every
  Tree array and the final row->leaf map bitwise;
- RF and GBT ``cv_sweep`` (2 folds, 4 trees / rounds, the reference's
  bootstrap draws fed through ``draw_bootstrap``): CV metrics within 1e-6
  (the metrics' float sums run in another order).  GBT has no int-exact
  path: its float histograms sum in another order than XLA's dot, so a split
  whose gain ties another's to within rounding may go the other way.  On the
  reference's own grids of this fixture none does; a depth-3 grid has one
  such tie at round 0, and there the metrics hold to 1e-3, the tolerance the
  card's GBT parity uses;
- RF refit trees bitwise; GBT refit trees with equal structure and leaf
  values within 1e-6 (sigmoid and the float histograms round differently).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.evaluators.base import BinaryClassificationEvaluator as JEval
from transmogrifai_tpu.models import trees as JT
from transmogrifai_tpu.models.tuning import CrossValidator as JCV
from transmogrifai_tpu.perf.kernels import dispatch as KD
from transmogrifai_tpu_torch.evaluators.base import BinaryClassificationEvaluator as TEval
from transmogrifai_tpu_torch.models import trees as TT

CPU = torch.device("cpu")


def reference_bootstrap(seed, rate, n_trees, n, device):
    """The JAX package's forest draws, for the port's ``draw_bootstrap``."""
    draws = jax.random.poisson(jax.random.PRNGKey(int(seed)), float(rate),
                               (int(n_trees), int(n)))
    return torch.from_numpy(np.asarray(draws).astype(np.float32)).to(device)


@pytest.fixture
def ref_draws(monkeypatch):
    monkeypatch.setattr(TT, "draw_bootstrap", reference_bootstrap)


def _data(n=400, d=6, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[::13, 1] = np.nan
    w = rng.normal(size=d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(np.nan_to_num(x) @ w)))).astype(np.float64)
    return x, y


class TestBinning:
    @pytest.mark.parametrize("n, n_bins", [(500, 8), (70000, 32)])
    def test_edges_and_codes_bitwise(self, n, n_bins):
        rng = np.random.default_rng(n)
        x = rng.normal(size=(n, 3)).astype(np.float32)
        x[::7, 0] = np.nan
        x[1, 1], x[2, 1] = np.inf, -np.inf
        x[:, 2] = np.round(x[:, 2])                 # heavy ties
        np.testing.assert_array_equal(TT.quantile_edges(x, n_bins),
                                      JT.quantile_edges(x, n_bins))
        jb, je = JT.quantile_bin(x, n_bins)
        tb, te = TT.quantile_bin(x, n_bins)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(te, je)
        ref = np.asarray(JT._digitize_device(jnp.asarray(x), jnp.asarray(je), n_bins))
        got = TT.digitize(torch.from_numpy(x), torch.from_numpy(je), n_bins)
        np.testing.assert_array_equal(got.numpy(), ref)


def _growth_fixture(seed=1, n=600, d=7, lanes=4):
    rng = np.random.default_rng(seed)
    n_bins = 8
    binned = rng.integers(0, n_bins + 1, (n, d)).astype(np.int32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    boot = rng.poisson(1.0, (lanes, n)).astype(np.float32)
    grad = -boot[:, :, None] * y[None, :, None]
    hess = boot[:, :, None] * np.ones((1, 1, 1), np.float32)
    masks = np.ones((lanes, d), np.float32)
    return binned, grad, hess, masks, n_bins


class TestGrower:
    @pytest.mark.parametrize("int_exact", [True, False])
    @pytest.mark.parametrize("depth", [1, 3])
    def test_grow_trees_bitwise(self, int_exact, depth):
        binned, grad, hess, masks, n_bins = _growth_fixture()
        with KD.force_kernel_mode("xla"):
            tj, nj = JT._grow_trees(
                jnp.asarray(binned), jnp.asarray(grad), jnp.asarray(hess),
                jnp.asarray(masks), jax.random.PRNGKey(0), depth, n_bins,
                0.0, 0.0, 0.0, 1.0, 1.0, 0.0, int_exact=int_exact)
        tt, nt = TT._grow_trees(
            torch.from_numpy(binned), torch.from_numpy(grad),
            torch.from_numpy(hess), torch.from_numpy(masks), (0,), depth,
            n_bins, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, int_exact=int_exact)
        for name, a, b in zip(tj._fields, tj, tt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"Tree.{name}")
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))

    def test_predict_sum_equals_host_traversal(self):
        x, y = _data()
        m = TT.RandomForestClassifier(num_trees=3, max_depth=3)._fit_arrays(
            x, y.astype(np.float32), np.ones(len(y), np.float32), CPU)
        dev = m._margin_sum(x, CPU).numpy().astype(np.float64)
        np.testing.assert_allclose(dev, m._margin_host(x), rtol=0, atol=1e-6)


def _families():
    return [
        (JT.RandomForestClassifier(num_trees=4, max_depth=2),
         TT.RandomForestClassifier(num_trees=4, max_depth=2),
         [{"max_depth": 2}, {"max_depth": 3}]),
        (JT.GradientBoostedTreesClassifier(num_rounds=4, max_depth=2),
         TT.GradientBoostedTreesClassifier(num_rounds=4, max_depth=2),
         [{"eta": 0.3}, {"eta": 0.1}]),
    ]


class TestSweeps:
    @pytest.mark.parametrize("fam", [0, 1], ids=["rf", "gbt"])
    def test_cv_sweep_metrics_match(self, fam, ref_draws):
        x, y = _data()
        tw, vw = JCV(JEval("auPR"), num_folds=2, seed=3).fold_weights(
            y, np.ones_like(y))
        je, te, grids = _families()[fam]
        ref = np.asarray(je.cv_sweep(x, y, tw, vw, grids, JEval("auPR").metric_fn()))
        got = te.cv_sweep(x, y, tw, vw, grids, TEval("auPR").metric_fn(), CPU)
        assert got.shape == ref.shape == (2, 2)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)

    def test_gbt_near_tie_grid_within_1e3(self):
        x, y = _data()
        tw, vw = JCV(JEval("auPR"), num_folds=2, seed=3).fold_weights(
            y, np.ones_like(y))
        grids = [{"eta": 0.1, "max_depth": 3}]
        ref = np.asarray(JT.GradientBoostedTreesClassifier(num_rounds=4).cv_sweep(
            x, y, tw, vw, grids, JEval("auPR").metric_fn()))
        got = TT.GradientBoostedTreesClassifier(num_rounds=4).cv_sweep(
            x, y, tw, vw, grids, TEval("auPR").metric_fn(), CPU)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)

    @pytest.mark.parametrize("depth", [2, 3])
    def test_rf_refit_trees_bitwise(self, depth, ref_draws):
        x, y = _data()
        w = np.ones(len(y), np.float32)
        jm = JT.RandomForestClassifier(num_trees=4, max_depth=depth)._fit_arrays(
            x, y.astype(np.float32), w)
        tm = TT.RandomForestClassifier(num_trees=4, max_depth=depth)._fit_arrays(
            x, y.astype(np.float32), w, CPU)
        for k in jm.trees:
            np.testing.assert_array_equal(tm.trees[k], jm.trees[k], err_msg=k)
        np.testing.assert_array_equal(tm.edges, jm.edges)

    def test_gbt_refit_trees_close(self):
        x, y = _data()
        w = np.ones(len(y), np.float32)
        jm = JT.GradientBoostedTreesClassifier(num_rounds=4, max_depth=2)._fit_arrays(
            x, y.astype(np.float32), w)
        tm = TT.GradientBoostedTreesClassifier(num_rounds=4, max_depth=2)._fit_arrays(
            x, y.astype(np.float32), w, CPU)
        for k in ("feat", "thr_bin", "miss_left", "is_leaf"):
            np.testing.assert_array_equal(tm.trees[k], jm.trees[k], err_msg=k)
        np.testing.assert_allclose(tm.trees["value"], jm.trees["value"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tm.base_score, jm.base_score)

    def test_rf_masks_are_the_references(self):
        je = JT.RandomForestClassifier(num_trees=5, seed=9)
        te = TT.RandomForestClassifier(num_trees=5, seed=9)
        np.testing.assert_array_equal(te._masks(17), np.asarray(je._masks(17)))

    def test_port_draws_are_poisson_counts(self):
        b = TT.draw_bootstrap(43, 1.0, 50, 2000, CPU)
        assert b.shape == (50, 2000) and b.dtype == torch.float32
        assert torch.equal(b, b.round()) and float(b.min()) >= 0.0
        assert abs(float(b.mean()) - 1.0) < 0.05
        assert torch.equal(b, TT.draw_bootstrap(43, 1.0, 50, 2000, CPU))
