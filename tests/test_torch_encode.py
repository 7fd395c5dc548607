"""K4/K5 encode kernels of the PyTorch port against the JAX package.

The port's plain PyTorch versions (``onehot_codes_torch``,
``bucketize_right_encode_torch``) must equal, bit for bit, the JAX Pallas
kernels run in interpret mode and the XLA formulas they replace — the same
pins as tests/test_kernels.py, over NaN, +-inf, ties on a split, negative and
out-of-range codes, ragged row counts and all four flag settings.  On the
CPU the wrappers take the plain versions; the CUDA kernels themselves run
only on the card (tests/test_torch_cuda.py, and ``python3 chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.ops.bucketizers import device_bucketize_right
from transmogrifai_tpu.perf.kernels import dispatch as KD
from transmogrifai_tpu.perf.kernels import encode as JKE
from transmogrifai_tpu_torch.perf.kernels import dispatch as TD
from transmogrifai_tpu_torch.perf.kernels import encode as TKE

SPLIT_SETS = {
    "inf_edges": [-np.inf, -0.5, 0.1, 0.9, np.inf],
    "one_split": [-np.inf, 0.25, np.inf],
    "finite_edges": [-1.0, 0.0, 0.5, 2.0],
}


def _codes(n: int, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(-3, width + 7, n).astype(np.int32)
    edge = np.array([-1, width, width + 5, 0, width - 1], np.int32)[:n]
    codes[:len(edge)] = edge
    return codes


def _values(n: int, splits, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 1.5).astype(np.float32)
    x[::7] = np.nan
    x[1 % n] = np.inf
    x[2 % n] = -np.inf
    finite = np.asarray([s for s in splits if np.isfinite(s)], np.float32)
    k = min(len(finite), max(0, n - 3))
    x[3:3 + k] = finite[:k]           # exactly on a split: ties must agree
    return x


class TestOneHotCodes:
    @pytest.mark.parametrize("n", [1, 37, 1024, 1500])
    @pytest.mark.parametrize("width", [1, 9, 22])
    def test_plain_bitwise_vs_pallas_interpret_and_xla(self, n, width):
        codes = _codes(n, width, seed=n * 31 + width)
        got = TKE.onehot_codes_torch(torch.from_numpy(codes), width).numpy()
        jc = jnp.asarray(codes)
        pallas = np.asarray(JKE.onehot_codes(jc, width, interpret=True))
        xla = np.asarray(jax.nn.one_hot(jc, width, dtype=jnp.float32))
        assert got.dtype == np.float32 and got.shape == (n, width)
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, xla)

    def test_out_of_range_codes_give_zero_rows(self):
        codes = torch.tensor([-1, 22, 27, 3], dtype=torch.int32)
        out = TKE.onehot_codes(codes, 22)
        assert out[:3].sum() == 0 and out[3, 3] == 1 and out[3].sum() == 1

    def test_cpu_tensor_takes_plain_path_without_launch(self):
        TKE.reset_launch_counts()
        codes = torch.from_numpy(_codes(64, 22, seed=1))
        out = TKE.onehot_codes(codes, 22)
        assert torch.equal(out, TKE.onehot_codes_torch(codes, 22))
        assert TKE.launch_counts() == {"onehot_codes": 0,
                                       "bucketize_right_encode": 0}

    @pytest.mark.parametrize("bad, exc", [
        (lambda: torch.zeros(4, dtype=torch.int64), TypeError),
        (lambda: torch.zeros((4, 2), dtype=torch.int32), ValueError),
        (lambda: torch.zeros(8, dtype=torch.int32)[::2], ValueError),
        (lambda: torch.zeros(4, dtype=torch.int32, device="meta"), ValueError),
    ], ids=["dtype", "ndim", "strided", "meta_device"])
    def test_wrapper_refuses_what_the_kernel_does_not_take(self, bad, exc):
        with pytest.raises(exc):
            TKE.onehot_codes(bad(), 22)


class TestBucketizeRightEncode:
    @pytest.mark.parametrize("splits_name", sorted(SPLIT_SETS))
    @pytest.mark.parametrize("track_nulls", [True, False])
    @pytest.mark.parametrize("track_invalid", [True, False])
    @pytest.mark.parametrize("n", [37, 1203])
    def test_plain_bitwise_vs_pallas_interpret_and_xla(
            self, splits_name, track_nulls, track_invalid, n):
        splits = np.asarray(SPLIT_SETS[splits_name], np.float32)
        x = _values(n, splits, seed=n)
        got = TKE.bucketize_right_encode_torch(
            torch.from_numpy(x), torch.from_numpy(splits),
            track_nulls, track_invalid).numpy()
        xd, sd = jnp.asarray(x), jnp.asarray(splits)
        with KD.force_kernel_mode("xla"):
            xla = np.asarray(device_bucketize_right(xd, sd, track_nulls,
                                                    track_invalid))
        pallas = np.asarray(JKE.bucketize_right_encode(
            xd, sd, track_nulls, track_invalid, interpret=True))
        assert got.shape == xla.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, xla)
        np.testing.assert_array_equal(got, pallas)

    def test_cpu_tensor_takes_plain_path_without_launch(self):
        TKE.reset_launch_counts()
        splits = torch.tensor(SPLIT_SETS["inf_edges"], dtype=torch.float32)
        x = torch.from_numpy(_values(50, splits.numpy(), seed=3))
        out = TKE.bucketize_right_encode(x, splits, True, True)
        assert torch.equal(out, TKE.bucketize_right_encode_torch(x, splits, True, True))
        assert TKE.bucketize_launches == 0

    @pytest.mark.parametrize("splits", [[0.0], []], ids=["one_edge", "empty"])
    def test_wrapper_needs_two_splits(self, splits):
        with pytest.raises(ValueError):
            TKE.bucketize_right_encode(torch.zeros(4), torch.tensor(splits), True, False)

    def test_wrapper_refuses_float64(self):
        with pytest.raises(TypeError):
            TKE.bucketize_right_encode(torch.zeros(4, dtype=torch.float64),
                                       torch.tensor([0.0, 1.0]), True, False)


class TestBuildLayer:
    def test_module_imports_and_plans_build_without_nvcc(self, monkeypatch,
                                                         tmp_path):
        """Importing the kernels needs no compiler; asking for a build where
        there is none fails loudly instead of falling back."""
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("TMOG_TORCH_BUILD_DIR", str(tmp_path / "build"))
        with pytest.raises(RuntimeError, match="nvcc"):
            TD.build(["encode"])

    def test_library_path_keys_on_source_hash(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TMOG_TORCH_BUILD_DIR", str(tmp_path))
        p = TD.library_path("encode")
        assert p.startswith(str(tmp_path)) and p.endswith(".so")
        assert p == TD.library_path("encode")

    def test_device_default_refuses_missing_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TD.resolve_device(None)
        assert TD.resolve_device("cpu") == torch.device("cpu")
