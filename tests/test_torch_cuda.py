"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no card.  The machine with
the card has no JAX, so this file imports torch and the port only; run it
there without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.perf.kernels import encode as TKE

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _codes(n: int, width: int, seed: int) -> np.ndarray:
    codes = np.random.default_rng(seed).integers(-3, width + 7, n).astype(np.int32)
    edge = np.array([-1, width, width + 5, 0], np.int32)[:n]
    codes[:len(edge)] = edge
    return codes


def _values(n: int, splits: np.ndarray, seed: int) -> np.ndarray:
    x = (np.random.default_rng(seed).normal(size=n) * 1.5).astype(np.float32)
    x[::7] = np.nan
    x[1], x[2] = np.inf, -np.inf
    finite = splits[np.isfinite(splits)]
    x[3:3 + len(finite)] = finite
    return x


@pytest.mark.parametrize("n", [1, 37, 1024, 5000])
@pytest.mark.parametrize("width", [1, 22])
def test_onehot_kernel_bitwise_and_counted(n, width):
    c = torch.from_numpy(_codes(n, width, seed=n)).cuda()
    before = TKE.onehot_launches
    got = TKE.onehot_codes(c, width)
    torch.cuda.synchronize()
    assert torch.equal(got, TKE.onehot_codes_torch(c, width))
    assert TKE.onehot_launches == before + 1


@pytest.mark.parametrize("splits", [[-np.inf, -0.5, 0.1, 0.9, np.inf],
                                    [-1.0, 0.0, 0.5, 2.0]])
@pytest.mark.parametrize("track_nulls", [True, False])
@pytest.mark.parametrize("track_invalid", [True, False])
def test_bucketize_kernel_bitwise_and_counted(splits, track_nulls, track_invalid):
    s_np = np.asarray(splits, np.float32)
    x = torch.from_numpy(_values(1024, s_np, seed=5)).cuda()
    s = torch.from_numpy(s_np).cuda()
    before = TKE.bucketize_launches
    got = TKE.bucketize_right_encode(x, s, track_nulls, track_invalid)
    torch.cuda.synchronize()
    assert torch.equal(got, TKE.bucketize_right_encode_torch(
        x, s, track_nulls, track_invalid))
    assert TKE.bucketize_launches == before + 1


# -- tree kernels (K1 histogram, K2 split scan, K3 routing) ---------------------

from transmogrifai_tpu_torch.perf.kernels import histogram as TH  # noqa: E402
from transmogrifai_tpu_torch.perf.kernels import routing as TR  # noqa: E402
from transmogrifai_tpu_torch.perf.kernels import splitscan as TS  # noqa: E402


def _hist_case(L, n, d, nn, n_bins, two_k, int_exact, seed):
    rng = np.random.default_rng(seed)
    local = rng.integers(-2, nn + 1, (L, n)).astype(np.int32)
    if int_exact:
        gh = rng.integers(-9, 10, (L, two_k, n)).astype(np.int8)
        gh[:, :, ::5] = 0                      # zero-weight rows
    else:
        gh = rng.normal(size=(L, two_k, n)).astype(np.float32)
    binned = rng.integers(0, n_bins + 1, (n, d)).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (local, gh, binned)]


# several node tiles (nn 16, 32), several row slices merged with global
# atomics (few lanes and nodes), several lanes per CTA (nn 1), n_bins 256,
# two_k 4, feature tiles that leave threads idle (d 33, 65, 200), row counts
# that are no multiple of any block (primes)
@pytest.mark.parametrize("L, n, d, nn, n_bins, two_k", [
    (3, 641, 7, 4, 8, 2), (150, 20011, 128, 16, 32, 2), (1, 5, 1, 1, 2, 2),
    (4, 70001, 33, 2, 32, 4), (2, 3000, 65, 32, 16, 2),
    (3, 100003, 128, 16, 32, 2), (12, 65537, 128, 1, 32, 2),
    (2, 30011, 128, 4, 256, 2), (5, 40009, 200, 3, 255, 2)])
def test_hist_int_kernel_bitwise_and_counted(L, n, d, nn, n_bins, two_k):
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, two_k, True, seed=n)
    before = TH.launches
    got = TH.hist_level(local, gh, binned, nn, n_bins, int_exact=True)
    torch.cuda.synchronize()
    assert TH.launches == before + 1
    ref = TH.hist_level_torch(local, gh, binned, nn, n_bins, int_exact=True)
    assert got.dtype == torch.int32 and torch.equal(got, ref)


# the GBT levels (3 lanes x 1-2 nodes: every lane and node in one CTA, many
# slices summed in order), a tiled many-lane level (150 lanes x 16 nodes),
# ragged d (no 16-byte code copies), two_k 4 and n_bins 255
@pytest.mark.parametrize("L, n, d, nn, n_bins, two_k", [
    (3, 641, 7, 2, 32, 2), (3, 200003, 128, 1, 32, 2), (12, 50000, 40, 8, 32, 2),
    (3, 262147, 128, 2, 32, 2), (150, 20011, 128, 16, 32, 2),
    (3, 30011, 33, 2, 32, 2), (2, 20011, 64, 2, 255, 4)])
def test_hist_f32_kernel_within_tolerance_and_repeatable(L, n, d, nn, n_bins, two_k):
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, two_k, False, seed=n)
    a = TH.hist_level(local, gh, binned, nn, n_bins)
    b = TH.hist_level(local, gh, binned, nn, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = TH.hist_level_torch(local, gh, binned, nn, n_bins)
    tol = TH.f32_tolerance(TH.hist_level_torch(local, gh.abs(), binned, nn, n_bins))
    assert bool(((a - ref).abs() <= tol).all())


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("L, nn, d, n_bins", [(3, 4, 6, 8), (150, 32, 128, 32),
                                              (2, 1, 1, 2)])
def test_split_scan_kernel_bitwise_on_integer_hists(K, L, nn, d, n_bins):
    rng = np.random.default_rng(L * nn + K)
    B = n_bins + 1
    hg = rng.integers(-20, 20, (L, nn, K, d, B)).astype(np.float32)
    hh = rng.integers(0, 30, (L, nn, K, d, B)).astype(np.float32)
    hg[0, 0] = 0.0
    hh[0, 0] = 0.0                              # an empty node
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = np.ones((L, d), np.float32)
    mask[-1, 0] = 0.0
    args = [torch.from_numpy(a).cuda() for a in (hg, hh, G, H, mask)]
    for params in [(1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0)]:
        before = TS.launches
        got = TS.split_scan(*args, n_bins, *params)
        torch.cuda.synchronize()
        assert TS.launches == before + 1
        ref = TS.split_scan_torch(*args, n_bins, *params)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("params", [(1.0, 0.0, 0.0, 1.0), (1.0, 0.5, 0.1, 1.0)])
def test_split_scan_kernel_on_float_hists_within_tolerance(params):
    L, nn, d, n_bins, n = 3, 4, 128, 32, 200003
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, 2, False, seed=5)
    gh[:, 1] = gh[:, 1].abs()                   # hessians are not negative
    hist = TH.hist_level(local, gh, binned, nn, n_bins).reshape(
        L, nn, 2, n_bins + 1, d).transpose(-1, -2)
    hg, hh = hist[:, :, :1].contiguous(), hist[:, :, 1:].contiguous()
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = torch.ones((L, d), device="cuda")
    mask[-1, 3] = 0.0
    args = (hg, hh, G, H, mask, n_bins, *params)
    got = TS.split_scan(*args)
    again = TS.split_scan(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    agree = TS.float_agreement(got, *args)
    assert agree["ok"], agree


@pytest.mark.parametrize("L, n, d", [(1, 37, 5), (150, 4099, 128), (3, 100003, 7)])
def test_row_select_kernel_bitwise_and_counted(L, n, d):
    rng = np.random.default_rng(n)
    binned = torch.from_numpy(rng.integers(0, 33, (n, d)).astype(np.int32)).cuda()
    idx = torch.from_numpy(rng.integers(-3, d + 3, (L, n)).astype(np.int32)).cuda()
    before = TR.launches
    got = TR.row_select_lanes(binned, idx)
    torch.cuda.synchronize()
    assert TR.launches == before + 1
    assert torch.equal(got, TR.row_select_lanes_torch(binned, idx))
