"""The port's tree kernels' plain versions against the JAX package's kernels.

K1 (level histogram), K2 (split scan) and K3 (routing select) of
``transmogrifai_tpu_torch/perf/kernels`` take their plain PyTorch versions on
CPU tensors.  Each is held to the reference's XLA formula and to its Pallas
kernel in interpret mode, on the same seeded inputs:

- K1 int-exact path bitwise (prime row count, negative and out-of-range
  node ids, the missing bin); float path within 1e-5 of each cell's absolute
  sum (the GEMM sums in another order);
- K2 bitwise on integer-valued histograms, K = 1 and 2, a masked feature
  never chosen, empty nodes; on float histograms within
  ``splitscan.float_agreement``'s tolerance, which a wrong choice, gain or
  missing direction fails;
- K3 bitwise, out-of-range indices giving 0.

The launch plans are pure Python and checked here too: K3's path by shape,
its tiles covering every (lane, row) once within the shared-memory budget;
K2's CTA packing covering every (lane, node) and feature once.

On CPU tensors the wrappers must not touch the CUDA build.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.perf.kernels import histogram as JH
from transmogrifai_tpu.perf.kernels import routing as JR
from transmogrifai_tpu.perf.kernels import splitscan as JS
from transmogrifai_tpu_torch.perf.kernels import dispatch as TD
from transmogrifai_tpu_torch.perf.kernels import histogram as TH
from transmogrifai_tpu_torch.perf.kernels import routing as TR
from transmogrifai_tpu_torch.perf.kernels import splitscan as TS


@pytest.fixture(autouse=True)
def _no_build(monkeypatch):
    """CPU tensors take the plain versions: any attempt to build or load
    the CUDA library fails the test."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel library")
    monkeypatch.setattr(TD, "load", refuse)


def _hist_inputs(seed: int, L=3, n=641, d=5, nn=4, n_bins=8, two_k=2,
                 int_exact=True):
    rng = np.random.default_rng(seed)
    local = rng.integers(-2, nn + 2, (L, n)).astype(np.int32)
    if int_exact:
        ghT = rng.integers(-9, 10, (L, two_k, n)).astype(np.int8)
    else:
        ghT = rng.normal(size=(L, two_k, n)).astype(np.float32)
    binned = rng.integers(0, n_bins + 1, (n, d)).astype(np.int32)
    binned[::11, 0] = n_bins                     # the missing bin
    return local, ghT, binned, nn, n_bins


class TestHistogram:
    @pytest.mark.parametrize("seed, n, nn", [(0, 641, 4), (1, 97, 1),
                                             (2, 2053, 2), (3, 5, 8)])
    def test_int_exact_bitwise_vs_xla_and_pallas(self, seed, n, nn):
        local, ghT, binned, nn, n_bins = _hist_inputs(seed, n=n, nn=nn)
        got = TH.hist_level(torch.from_numpy(local), torch.from_numpy(ghT),
                            torch.from_numpy(binned), nn, n_bins, int_exact=True)
        args = (jnp.asarray(local), jnp.asarray(ghT), jnp.asarray(binned), nn,
                n_bins)
        ref_x = np.asarray(JH.hist_level_xla(*args, int_exact=True, chunk=128))
        ref_p = np.asarray(JH.hist_level_pallas(*args, int_exact=True,
                                                interpret=True, chunk=128))
        assert got.dtype == torch.int32
        assert got.shape == (3 * nn * 2, (n_bins + 1) * 5)
        np.testing.assert_array_equal(got.numpy(), ref_x)
        np.testing.assert_array_equal(got.numpy(), ref_p)

    def test_float_path_within_tolerance(self):
        local, ghT, binned, nn, n_bins = _hist_inputs(4, n=700,
                                                      int_exact=False)
        t = [torch.from_numpy(a) for a in (local, ghT, binned)]
        got = TH.hist_level(*t, nn, n_bins)
        ref = np.asarray(JH.hist_level_xla(
            jnp.asarray(local), jnp.asarray(ghT), jnp.asarray(binned), nn,
            n_bins, chunk=256))
        abs_hist = TH.hist_level_torch(t[0], t[1].abs(), t[2], nn, n_bins)
        err = np.abs(got.numpy() - ref)
        assert np.all(err <= TH.f32_tolerance(abs_hist).numpy())
        assert got.dtype == torch.float32

    def test_rows_outside_every_node_add_nothing(self):
        local, ghT, binned, nn, n_bins = _hist_inputs(5)
        local[:] = -1
        got = TH.hist_level(torch.from_numpy(local), torch.from_numpy(ghT),
                            torch.from_numpy(binned), nn, n_bins, int_exact=True)
        assert int(got.abs().sum()) == 0

    def test_plan_fits_shared_memory(self):
        for L, nn, two_k, n_bins in [(150, 16, 2, 32), (3, 1, 2, 32),
                                     (150, 32, 2, 32), (4, 2, 4, 255)]:
            for int_exact in (True, False):
                p = TH.plan(L, 1 << 20, 128, nn, two_k, n_bins, int_exact)
                assert p["smem"] <= 227 * 1024
                assert 1 <= p["NT"] <= nn and 1 <= p["G"] <= L
                assert 32 <= p["FT"] <= 128 and p["threads"] <= 1024
        for int_exact in (True, False):
            # 20 channels x 256 bins do not fit one CTA: the channels tile
            p = TH.plan(4, 1000, 128, 2, 20, 255, int_exact)
            assert p["smem"] <= 227 * 1024 and p["chan_tiles"] > 1
            # one channel of 2001 bins fits no CTA
            with pytest.raises(ValueError, match="shared memory"):
                TH.plan(4, 1000, 128, 2, 2, 2000, int_exact)

    def test_wrong_dtype_raises(self):
        local, ghT, binned, nn, n_bins = _hist_inputs(6)
        with pytest.raises(TypeError):
            TH.hist_level(torch.from_numpy(local), torch.from_numpy(ghT),
                          torch.from_numpy(binned), nn, n_bins, int_exact=False)


#: (L, n, d, nn, two_k, n_bins): the RF-CV levels (150 lanes, nn 1..16), the
#: refit's deepest level (50 lanes), the GBT levels (3 lanes), the library
#: comparison's rows, n_bins 256, two_k 4, nn 32, L 1, n 0, ragged d
_PLAN_SHAPES = [(150, 1 << 20, 128, nn, 2, 32) for nn in (1, 2, 4, 8, 16)] + [
    (50, 1 << 20, 128, 16, 2, 32), (3, 1 << 20, 128, 1, 2, 32),
    (3, 1 << 20, 128, 2, 2, 32), (150, 3495, 128, 16, 2, 32),
    (3, 174762, 128, 2, 2, 32), (2, 30011, 128, 4, 2, 256),
    (4, 70001, 33, 2, 4, 32), (4, 1 << 20, 128, 2, 4, 255),
    (2, 3000, 65, 32, 2, 16), (1, 5, 1, 1, 2, 2), (1, 0, 3, 1, 2, 2),
    (7, 100003, 200, 3, 2, 255)]


def _covered_once(total: int, tile: int, tiles: int) -> bool:
    """Tiles [k*tile, (k+1)*tile) clipped to total, k < tiles: every index
    in exactly one, none empty."""
    count = np.zeros(total, np.int64)
    for k in range(tiles):
        if total and k * tile >= total:
            return False
        count[k * tile:(k + 1) * tile] += 1
    return bool(np.all(count == 1))


def _one_cta_tiles(L, d, nn, two_k, B, int_exact):
    """The tiles of a CTA that holds every channel, as the plan chose them
    before channels were tiled, or None where no such CTA fits."""
    def ft_tiles():
        first = min(128, -(-d // 32) * 32)
        return [first] + [ft for ft in (64, 32) if ft < first]

    def balanced(total, most):
        return -(-total // -(-total // most))

    if int_exact:
        stage = lambda G: 32 * G * 32 * (1 + two_k)  # noqa: E731
        for FT in ft_tiles():
            unit = two_k * B * FT * 4
            units = (220 * 1024 - stage(1)) // unit
            if units >= 1:
                break
        else:
            return None
        NT = balanced(nn, units)
        G = max(1, min(L, units // NT, 8))
        while G > 1 and G * NT * unit + stage(G) > 220 * 1024:
            G -= 1
        return {"G": balanced(L, G), "NT": NT, "FT": FT, "threads": 1024, "R": 32}

    def smem(G, NT, FT, R):
        return 4 * (G * NT * two_k * B * FT + 2 * (R * FT + G * R + G * two_k * R))

    for budget in (112 * 1024, 227 * 1024):
        for R in (32, 16):
            for FT in ft_tiles():
                if L * nn * FT <= 512 and smem(L, nn, FT, R) <= budget:
                    return {"G": L, "NT": nn, "FT": FT, "threads": L * nn * FT, "R": R}
        fits = lambda G, NT: G * NT * 32 <= 512 and smem(G, NT, 32, 16) <= budget  # noqa: E731
        if not fits(1, 1):
            continue
        NT = nn
        while not fits(1, NT):
            NT -= 1
        NT = balanced(nn, NT)
        G = L
        while not fits(G, NT):
            G -= 1
        G = balanced(L, G)
        R = next(r for r in (32, 16) if smem(G, NT, 32, r) <= budget)
        return {"G": G, "NT": NT, "FT": 32, "threads": G * NT * 32, "R": R}
    return None


class TestHistogramPlan:
    @pytest.mark.parametrize("int_exact", [True, False])
    @pytest.mark.parametrize("L, n, d, nn, two_k, n_bins", _PLAN_SHAPES)
    def test_tiles_cover_each_cell_and_row_once(self, L, n, d, nn, two_k,
                                                n_bins, int_exact):
        p = TH.plan(L, n, d, nn, two_k, n_bins, int_exact)
        B = n_bins + 1
        assert _covered_once(L, p["G"], p["lane_groups"])
        assert _covered_once(nn, p["NT"], p["node_tiles"])
        assert _covered_once(d, p["FT"], p["feat_tiles"])
        assert _covered_once(n, p["rows_per_slice"], p["slices"])
        # the shared memory the kernels lay out, within one CTA's 227 KB
        assert p["smem"] <= 227 * 1024
        assert p["threads"] % 32 == 0 and 32 <= p["threads"] <= 1024
        assert p["FT"] % 32 == 0 and p["FT"] <= 128
        if int_exact:
            stage = p["threads"] // 32 * p["G"] * 32 * (1 + two_k)
            assert p["smem"] == p["G"] * p["NT"] * two_k * B * p["FT"] * 4 + stage
        else:
            assert p["threads"] == p["G"] * p["NT"] * p["FT"]
            assert p["threads"] <= TH.F32_MAX_THREADS
            assert p["smem"] == 4 * (p["G"] * p["NT"] * two_k * B * p["FT"]
                                     + 2 * p["R"] * (p["FT"] + p["G"] * (1 + two_k)))
        # direct store exactly where one slice covers every row
        assert (p["merge"] == "direct") == (p["slices"] == 1)
        if p["slices"] > 1:
            assert p["merge"] == ("atomic" if int_exact else "partials")

    @pytest.mark.parametrize("int_exact", [True, False])
    @pytest.mark.parametrize("L", [1, 3, 150])
    @pytest.mark.parametrize("nn", [1, 16])
    def test_every_channel_count_to_200_plans(self, L, nn, int_exact):
        """2K = 2..200 channels (1..100 classes) at 33 bins: every plan fits
        one CTA's shared memory and tiles each channel exactly once; where
        one CTA held every channel before channel tiles existed, the plan is
        that one (one channel tile)."""
        n, d, n_bins = 65536, 128, 32
        B = n_bins + 1
        for two_k in range(2, 202, 2):
            p = TH.plan(L, n, d, nn, two_k, n_bins, int_exact)
            assert p["smem"] <= TH._CTA_SMEM_MAX
            assert _covered_once(two_k, p["CT"], p["chan_tiles"]), two_k
            assert _covered_once(L, p["G"], p["lane_groups"])
            assert _covered_once(nn, p["NT"], p["node_tiles"])
            if int_exact:
                assert p["smem"] == (p["G"] * p["NT"] * p["CT"] * B * p["FT"] * 4
                                     + p["threads"] // 32 * p["G"] * 32 * (1 + p["CT"]))
            else:
                assert p["threads"] == p["G"] * p["NT"] * p["FT"] <= TH.F32_MAX_THREADS
                assert p["smem"] == 4 * (p["G"] * p["NT"] * p["CT"] * B * p["FT"]
                                         + 2 * p["R"] * (p["FT"] + p["G"] * (1 + p["CT"])))
            single = _one_cta_tiles(L, d, nn, two_k, B, int_exact)
            if single is not None:
                assert p["chan_tiles"] == 1 and p == TH.finish_plan(
                    single, L, n, d, nn, two_k, n_bins, int_exact), two_k
        # the widths that do not fit one CTA: 22 classes on the int8 path,
        # 27 on the float one
        first = 44 if int_exact else 54
        assert _one_cta_tiles(L, d, nn, first - 2, B, int_exact) is not None
        assert _one_cta_tiles(L, d, nn, first, B, int_exact) is None
        assert TH.plan(L, n, d, nn, first, n_bins, int_exact)["chan_tiles"] > 1

    def test_gbt_level_holds_every_lane_and_node(self):
        # each row's codes read once per level and feature tile
        for nn in (1, 2):
            p = TH.plan(3, 1 << 20, 128, nn, 2, 32, False)
            assert (p["lane_groups"], p["node_tiles"]) == (1, 1)
            assert p["slices"] > 1 and p["merge"] == "partials"

    def test_rf_deepest_level_fetches_codes_once_per_live_row(self):
        # one lane per CTA, all 128 features, nodes in few tiles, no slices
        p = TH.plan(150, 1 << 20, 128, 16, 2, 32, True)
        assert p["G"] == 1 and p["FT"] == 128 and p["feat_tiles"] == 1
        assert p["node_tiles"] <= 4 and p["merge"] == "direct"

    def test_int_path_refuses_rows_that_could_overflow(self, monkeypatch):
        """No bound is needed while any int8 values fit int32 sums; past
        that the wrapper raises only when the data's (or the caller's)
        bound on a (lane, channel) sum of |gh| passes int32."""
        assert TH.INT_SAFE_ROWS * 128 <= TH.INT32_MAX < (TH.INT_SAFE_ROWS + 1) * 128
        local, ghT, binned, nn, n_bins = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                                          else a for a in _hist_inputs(3, n=64))
        monkeypatch.setattr(TH, "INT_SAFE_ROWS", 8)
        with pytest.raises(ValueError, match="int32"):
            TH.hist_level(local, ghT, binned, nn, n_bins, int_exact=True,
                          abs_sum_bound=TH.INT32_MAX + 1)
        ok = TH.hist_level(local, ghT, binned, nn, n_bins, int_exact=True,
                           abs_sum_bound=TH.INT32_MAX)
        assert torch.equal(ok, TH.hist_level(local, ghT, binned, nn, n_bins,
                                             int_exact=True))

    def test_abs_sum_bound_is_the_largest_lane_channel_sum(self, monkeypatch):
        rng = np.random.default_rng(4)
        gh = rng.integers(-128, 128, (5, 2, 1001)).astype(np.int8)
        gh[2, 1, :400] = -128                      # |-128| does not wrap
        want = int(np.abs(gh.astype(np.int64)).sum(axis=2).max())
        monkeypatch.setattr(TH, "_ABS_SUM_CHUNK", 64)   # several row chunks
        assert TH.int_abs_sum_bound(torch.from_numpy(gh)) == want

    @pytest.mark.parametrize("case", ["fold_weights_01", "all_127"])
    def test_int_path_past_16_9m_rows_follows_the_data(self, case):
        """One row more than 2**31 // 127: 0/1 weights are summed (the
        forest's case), all-127 grad/hess would overflow int32 and raise."""
        n = (2 ** 31 - 1) // 127 + 1
        g = torch.Generator().manual_seed(0)
        binned = torch.randint(0, 3, (n, 1), generator=g, dtype=torch.int32)
        local = torch.zeros((1, n), dtype=torch.int32)
        if case == "all_127":
            gh = torch.full((1, 2, n), 127, dtype=torch.int8)
            with pytest.raises(ValueError, match="int32"):
                TH.hist_level(local, gh, binned, 1, 2, int_exact=True)
            return
        w = torch.randint(0, 2, (n,), generator=g, dtype=torch.int8)
        gh = torch.stack([-w, w])[None].contiguous()
        out = TH.hist_level(local, gh, binned, 1, 2, int_exact=True)
        want = torch.bincount(binned[:, 0].long(), weights=w.double(),
                              minlength=3).to(torch.int32)
        assert torch.equal(out, torch.stack([-want, want]))


def _split_inputs(seed, L=3, nn=4, K=1, d=6, n_bins=8, empty_node=True):
    rng = np.random.default_rng(seed)
    B = n_bins + 1
    hg = rng.integers(-20, 20, (L, nn, K, d, B)).astype(np.float32)
    hh = rng.integers(0, 30, (L, nn, K, d, B)).astype(np.float32)
    if empty_node:
        hg[0, 1] = 0.0
        hh[0, 1] = 0.0
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = np.ones((L, d), np.float32)
    mask[0, 2] = 0.0
    return hg, hh, G, H, mask, n_bins


def _float_split_inputs(seed, L=3, nn=4, d=16, n_bins=32, n=3000):
    """A GBT level's float histograms: logistic grad/hess of n rows binned
    into (L, nn, 1, d, n_bins+1), the node totals from feature 0."""
    rng = np.random.default_rng(seed)
    p = rng.random((L, n)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    g, h = p - y, p * (1 - p)
    node = rng.integers(0, nn, (L, n))
    codes = rng.integers(0, n_bins + 1, (n, d))
    B = n_bins + 1
    hg = np.zeros((L, nn, 1, d, B), np.float32)
    hh = np.zeros((L, nn, 1, d, B), np.float32)
    for lane in range(L):
        for f in range(d):
            np.add.at(hg[lane, :, 0, f], (node[lane], codes[:, f]), g[lane])
            np.add.at(hh[lane, :, 0, f], (node[lane], codes[:, f]), h[lane])
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = np.ones((L, d), np.float32)
    mask[-1, 3] = 0.0
    return hg, hh, G, H, mask, n_bins


class TestSplitScan:
    @pytest.mark.parametrize("K", [1, 2])
    @pytest.mark.parametrize("params", [(1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0),
                                        (2.0, 1.5, 0.0, 0.0)])
    def test_bitwise_on_integer_hists(self, K, params):
        hg, hh, G, H, mask, n_bins = _split_inputs(7 + K, K=K)
        got = TS.split_scan(*[torch.from_numpy(a) for a in (hg, hh, G, H, mask)],
                            n_bins, *params)
        jargs = [jnp.asarray(a) for a in (hg, hh, G, H, mask)]
        jp = [jnp.float32(v) for v in params]
        ref_x = JS.split_scan_xla(*jargs, n_bins, *jp)
        ref_p = JS.split_scan_pallas(*jargs, n_bins, *jp, interpret=True)
        for g, rx, rp in zip(got, ref_x, ref_p):
            np.testing.assert_array_equal(g.numpy(), np.asarray(rx))
            np.testing.assert_array_equal(g.numpy(), np.asarray(rp))
        assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool

    def test_masked_feature_never_selected(self):
        hg, hh, G, H, mask, n_bins = _split_inputs(11)
        best, _, _ = TS.split_scan(
            *[torch.from_numpy(a) for a in (hg, hh, G, H, mask)], n_bins,
            1.0, 0.0, 0.0, 1.0)
        assert not np.any(best.numpy()[0] // (n_bins - 1) == 2)

    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    @pytest.mark.parametrize("params", [(1.0, 0.0, 0.0, 1.0), (1.0, 0.5, 0.1, 1.0)])
    def test_float_hists_agree_with_reference(self, impl, params):
        hg, hh, G, H, mask, n_bins = _float_split_inputs(23)
        t = [torch.from_numpy(a) for a in (hg, hh, G, H, mask)]
        jargs = [jnp.asarray(a) for a in (hg, hh, G, H, mask)]
        jp = [jnp.float32(v) for v in params]
        ref = (JS.split_scan_xla(*jargs, n_bins, *jp) if impl == "xla" else
               JS.split_scan_pallas(*jargs, n_bins, *jp, interpret=True))
        ref = tuple(torch.from_numpy(np.array(r)) for r in ref)
        agree = TS.float_agreement(ref, *t, n_bins, *params)
        assert agree["ok"], agree
        assert agree["max_err_over_tol"] < 0.1

    @pytest.mark.parametrize("fault", ["next_bin", "gain_scaled", "missing_flipped",
                                       "masked_feature"])
    def test_float_agreement_rejects_a_wrong_result(self, fault):
        hg, hh, G, H, mask, n_bins = _float_split_inputs(29)
        t = [torch.from_numpy(a) for a in (hg, hh, G, H, mask)]
        params = (1.0, 0.0, 0.0, 1.0)
        best, gain, bml = TS.split_scan_torch(*t, n_bins, *params)
        assert TS.float_agreement((best, gain, bml), *t, n_bins, *params)["ok"]
        if fault == "next_bin":
            best = (best + 1) % (hg.shape[3] * (n_bins - 1))
        elif fault == "gain_scaled":
            gain = gain * 1.01
        elif fault == "missing_flipped":
            bml = ~bml
        else:
            t[4][:, 0] = 0.0      # feature 0 masked, yet chosen
            best = torch.zeros_like(best)
        assert not TS.float_agreement((best, gain, bml), *t, n_bins, *params)["ok"]

    def test_soft_threshold_matches(self):
        g = np.array([-3.0, -0.5, 0.0, 0.25, 2.0, np.nan], np.float32)
        ref = np.asarray(JS.soft_threshold(jnp.asarray(g), jnp.float32(0.5)))
        got = TS.soft_threshold(torch.from_numpy(g), 0.5).numpy()
        np.testing.assert_array_equal(got, ref)


class TestRouting:
    @pytest.mark.parametrize("L, n, d", [(3, 641, 7), (1, 37, 1), (5, 9000, 4)])
    def test_bitwise_vs_xla_and_pallas(self, L, n, d):
        rng = np.random.default_rng(L * n)
        binned = rng.integers(0, 33, (n, d)).astype(np.int32)
        idx = rng.integers(-2, d + 3, (L, n)).astype(np.int32)
        got = TR.row_select_lanes(torch.from_numpy(binned), torch.from_numpy(idx))
        ref_x = np.asarray(JR.row_select_lanes_xla(jnp.asarray(binned),
                                                   jnp.asarray(idx)))
        ref_p = np.asarray(JR.row_select_lanes_pallas(
            jnp.asarray(binned), jnp.asarray(idx), interpret=True, block=256))
        np.testing.assert_array_equal(got.numpy(), ref_x)
        np.testing.assert_array_equal(got.numpy(), ref_p)
        outside = (idx < 0) | (idx >= d)
        assert np.all(got.numpy()[outside] == 0)


class TestRoutingPlan:
    @pytest.mark.parametrize("L, n, d, path", [
        (150, 1 << 20, 128, "tile"), (50, 1 << 20, 128, "tile"),
        (3, 1 << 20, 128, "direct"), (1, 4099, 128, "direct"),
        (1, 1 << 20, 128, "direct"), (150, 4099, 4096, "direct"),
        (150, 1 << 20, 866, "direct")])
    def test_path_by_shape(self, L, n, d, path):
        assert TR.plan(L, n, d).path == path

    def test_tile_design_bytes_equal_the_bound_at_150_lanes(self):
        p = TR.plan(150, 1 << 20, 128)
        assert TR.design_bytes(p, 150, 1 << 20, 128) == TR.bound_bytes(150, 1 << 20, 128)
        q = TR.plan(3, 1 << 20, 128)
        assert TR.design_bytes(q, 3, 1 << 20, 128) == 3 * (1 << 20) * 40

    @pytest.mark.parametrize("L, n, d", [
        (150, 4099, 128), (50, 4096, 128), (3, 100003, 128), (1, 37, 5),
        (150, 1000, 866), (40, 65, 700), (2, 1, 1), (20, 300, 0)])
    def test_tiles_cover_each_lane_and_row_once(self, L, n, d):
        p = TR.plan(L, n, d)
        count = np.zeros((L, n), np.int64)
        if p.path == "tile":
            # thread t of CTA c: row c*rows + t % rows of lanes t // rows,
            # t // rows + P, ... (P = threads // rows lanes at a time)
            assert p.threads % p.rows == 0 and p.rows >= 32
            assert p.stride >= d and p.stride % 2 == 1
            assert p.smem == p.rows * p.stride * 4 <= TR.TILE_SMEM
            P = p.threads // p.rows
            for c in range(p.ctas):
                rows = c * p.rows + np.arange(p.rows)
                rows = rows[rows < n]
                for q in range(P):
                    count[np.ix_(np.arange(q, L, P), rows)] += 1
        else:
            # thread i of the grid: row i, every lane
            assert p.smem == 0 and p.rows == p.threads
            rows = np.arange(p.ctas * p.threads)
            count[:, rows[rows < n]] += 1
        assert np.all(count == 1)

    def test_wide_rows_take_the_direct_path_for_lack_of_shared_memory(self):
        # 32 rows of 867 words exceed the budget: no tile, whatever L
        assert 32 * (866 | 1) * 4 > TR.TILE_SMEM
        assert TR.plan(10_000, 1 << 20, 866).path == "direct"


class TestScanPlan:
    @pytest.mark.parametrize("d", [1, 6, 128, 1100])
    @pytest.mark.parametrize("n_bins", [32, 33, 255])
    @pytest.mark.parametrize("K", [1, 2, 4])
    @pytest.mark.parametrize("L, nn", [(3, 5), (150, 32), (1, 1)])
    def test_packing_covers_each_block_and_feature_once(self, L, nn, K, d, n_bins):
        p = TS.plan(L, nn, K, d, n_bins)
        B = n_bins + 1
        P, FT, S = p.blocks_per_cta, p.feats, p.groups
        assert p.threads == P * FT * S <= TS.SCAN_MAX_THREADS and FT % 32 == 0
        if L * nn * FT >= TS.SCAN_MIN_THREADS and p.threads < TS.SCAN_MIN_THREADS:
            # fewer threads only where another block's staging would not fit
            assert TS._scan_smem(p.staged, P + 1, FT, K, p.stride, S) > TS.SCAN_SMEM
        blocks = np.zeros(L * nn, np.int64)
        for c in range(p.ctas):
            ln = c * P + np.arange(P)
            blocks[ln[ln < L * nn]] += 1
        assert np.all(blocks == 1)
        feats = np.zeros(d, np.int64)
        for t in range(p.feat_tiles):
            f = t * FT + np.arange(FT)
            feats[f[f < d]] += 1
        assert np.all(feats == 1)
        # the S threads of a feature split its candidates, each taking one
        cands = np.zeros(n_bins - 1, np.int64)
        for g in range(S):
            cands[g * (n_bins - 1) // S:(g + 1) * (n_bins - 1) // S] += 1
        assert np.all(cands == 1)
        assert S == 1 or (n_bins - 1) // S >= 8
        assert p.smem <= TS.SCAN_SMEM_MAX
        if p.staged:
            # odd stride: one bin of 32 features' rows falls in 32 banks
            assert p.stride >= B and p.stride % 2 == 1
            assert p.smem == 4 * (P * 2 * K * (FT * p.stride + 4)
                                  + (2 * K * p.threads if K > 2 else 0))

    @pytest.mark.parametrize("L, nn, groups", [(150, 32, 1), (50, 16, 1), (3, 4, 3),
                                               (3, 1, 3)])
    def test_training_levels_stage_one_block_of_all_features(self, L, nn, groups):
        # the sweep's levels: 128 features x 33 bins staged; a thread a
        # feature where the grid fills the card, three on GBT's few blocks
        p = TS.plan(L, nn, 1, 128, 32)
        assert p.staged and p.stride == 33 and p.feats == 128
        assert p.groups == groups and p.threads == 128 * groups
        assert p.ctas == L * nn and p.feat_tiles == 1
        assert p.smem <= TS.SCAN_SMEM

    def test_histograms_too_wide_to_stage_are_read_where_they_lie(self):
        p = TS.plan(2, 2, 4, 16, 255)
        assert not p.staged and p.smem == 4 * 2 * 4 * p.threads


def test_reference_runs_on_cpu():
    assert jax.default_backend() == "cpu"
