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
