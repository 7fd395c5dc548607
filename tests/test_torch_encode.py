"""K4/K5 encode slots of the PyTorch port against the JAX package.

The port's plain PyTorch versions (``onehot_codes_torch``,
``bucketize_right_encode_torch``, and ``encode_slots_torch`` over a whole
slot table) must equal, bit for bit, the JAX Pallas kernels run in interpret
mode and the XLA formulas they replace — the same pins as
tests/test_kernels.py, over NaN, +-inf, ties on a split, negative and
out-of-range codes, ragged row counts and all four flag settings.  The slot
planner is pure Python and is tested here whole.  On the CPU the wrappers
take the plain versions; the CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, and ``python3 chip_smoke.py``).
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
from torch_encode_cases import slot_case

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
                                       "bucketize_right_encode": 0,
                                       "encode_slots": 0,
                                       "encode_slots.slots": 0}

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


def _slot_table_case(n: int, seed: int, n_slots: int = 10):
    """A random slot table over every edge case and its numpy inputs
    (``torch_encode_cases.slot_case``: codes -1, width and width+5;
    track_nulls off and all four flag settings; S = 2 and 5; NaN, +-inf and
    values exactly on a split)."""
    specs, inputs = slot_case(n, seed, "cpu", n_slots)
    return specs, [x.numpy() for x in inputs]


class TestEncodeSlots:
    @pytest.mark.parametrize("n", [1, 37, 1024])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_plain_bitwise_vs_pallas_interpret_and_xla_slot_by_slot(self, n, seed):
        specs, inputs = _slot_table_case(n, seed=seed * 100 + n, n_slots=10 + 2 * seed)
        flags = {(s.track_nulls, s.track_invalid) for s in specs if s.kind == "bucketize"}
        assert flags == {(False, False), (True, False), (False, True), (True, True)}
        table = TKE.plan_slots(specs)
        out = TKE.encode_slots([torch.from_numpy(a) for a in inputs], table)
        assert tuple(out.shape) == (n, table.width)
        for k, (s, a) in enumerate(zip(specs, inputs)):
            got = out[:, table.col[k]:table.col[k] + s.width].numpy()
            if s.kind == "onehot":
                jc = jnp.asarray(a)
                refs = [JKE.onehot_codes(jc, s.width, interpret=True),
                        jax.nn.one_hot(jc, s.width, dtype=jnp.float32)]
            else:
                xd, sd = jnp.asarray(a), jnp.asarray(np.asarray(s.splits, np.float32))
                with KD.force_kernel_mode("xla"):
                    xla = device_bucketize_right(xd, sd, s.track_nulls, s.track_invalid)
                refs = [xla, JKE.bucketize_right_encode(
                    xd, sd, s.track_nulls, s.track_invalid, interpret=True)]
            for ref in refs:
                ref = np.asarray(ref)
                assert got.shape == ref.shape and got.dtype == np.float32
                np.testing.assert_array_equal(got, ref)

    def test_cpu_tensors_take_plain_path_without_launch(self):
        specs, inputs = _slot_table_case(64, seed=5)
        table = TKE.plan_slots(specs)
        TKE.reset_launch_counts()
        ins = [torch.from_numpy(a) for a in inputs]
        got = TKE.encode_slots(ins, table)
        assert torch.equal(got, TKE.encode_slots_torch(ins, table))
        assert set(TKE.launch_counts().values()) == {0}

    def test_writes_into_a_strided_view_only(self):
        specs, inputs = _slot_table_case(9, seed=6)
        table = TKE.plan_slots(specs)
        w = table.width
        buf = torch.full((9, w + 5), 7.0)
        TKE.encode_slots([torch.from_numpy(a) for a in inputs], table, buf[:, 2:2 + w])
        ref = TKE.encode_slots_torch([torch.from_numpy(a) for a in inputs], table)
        assert torch.equal(buf[:, 2:2 + w], ref)
        assert bool((buf[:, :2] == 7.0).all() and (buf[:, 2 + w:] == 7.0).all())

    @pytest.mark.parametrize("bad, exc", [
        ("rows", ValueError), ("dtype", TypeError), ("count", ValueError),
        ("out_shape", ValueError), ("out_columns", ValueError),
        ("out_dtype", TypeError), ("out_device", ValueError)])
    def test_wrapper_refuses_what_the_kernel_does_not_take(self, bad, exc):
        specs, inputs = _slot_table_case(8, seed=7, n_slots=4)
        table = TKE.plan_slots(specs)
        ins = [torch.from_numpy(a) for a in inputs]
        out = None
        w = table.width
        if bad == "rows":
            ins[1] = ins[1][:5].contiguous()
        elif bad == "dtype":
            ins[0] = ins[0].to(torch.int64)
        elif bad == "count":
            ins = ins[:-1]
        elif bad == "out_shape":
            out = torch.empty((8, w + 1))
        elif bad == "out_columns":
            out = torch.empty((w, 8)).t()
        elif bad == "out_dtype":
            out = torch.empty((8, w), dtype=torch.float64)
        else:
            out = torch.empty((8, w), device="meta")
        with pytest.raises(exc):
            TKE.encode_slots(ins, table, out)


class TestSlotPlanner:
    def test_offsets_widths_and_packed_splits(self):
        specs = [TKE.onehot_slot(5), TKE.bucketize_slot([-np.inf, 0, 1, np.inf], True, True),
                 TKE.onehot_slot(3), TKE.bucketize_slot([0, 1], False, False)]
        t = TKE.plan_slots(specs)
        assert [s.width for s in t.specs] == [5, 5, 3, 1]
        assert t.col == [0, 5, 10, 13] and t.width == 14
        assert t.split_off == [0, 0, 4, 4]
        np.testing.assert_array_equal(t.splits, np.float32([-np.inf, 0, 1, np.inf, 0, 1]))
        assert t.chunks == [(0, 4)]
        # a table row: col, width, kind (one-hot 0, bucketize 1 | invalid 2
        # | nulls 4), first split, splits
        assert t.rows.tolist() == [[0, 5, 0, 0, 0], [5, 5, 7, 0, 4],
                                   [10, 3, 0, 4, 0], [13, 1, 1, 4, 2]]

    def test_bucket_width_follows_the_flags(self):
        for tn in (False, True):
            for ti in (False, True):
                s = TKE.bucketize_slot([0.0, 1.0, 2.0], tn, ti)
                assert s.width == 2 + tn + ti == TKE.bucket_width(3, tn, ti)

    @pytest.mark.parametrize("n_slots, chunks", [
        (64, 1), (65, 2), (70, 2), (128, 2), (129, 3), (1, 1)])
    def test_chunks_of_at_most_max_slots(self, n_slots, chunks):
        specs = [TKE.onehot_slot(2 + k % 3) if k % 2 else
                 TKE.bucketize_slot([0.0, 1.0, 2.0], True, False) for k in range(n_slots)]
        t = TKE.plan_slots(specs)
        assert len(t.chunks) == chunks
        assert t.chunks[0][0] == 0 and t.chunks[-1][1] == n_slots
        assert all(b - a <= TKE.MAX_SLOTS for a, b in t.chunks)
        assert all(t.chunks[i][1] == t.chunks[i + 1][0] for i in range(chunks - 1))
        for lo, hi in t.chunks:   # split offsets restart at each chunk
            assert t.rows[lo, 3] == 0
            assert t.rows[lo:hi, 3].tolist() == [3 * ((k + 1) // 2) - 3 * ((lo + 1) // 2)
                                                 for k in range(lo, hi)]

    def test_launches_cover_each_chunk(self):
        specs = [TKE.bucketize_slot([0.0, 1.0, 2.0], True, False) if k % 2 else
                 TKE.onehot_slot(3) for k in range(70)]
        t = TKE.plan_slots(specs)
        assert [(lo, count, s0, ns) for lo, count, _, s0, ns in t._launches] == [
            (0, 64, 0, 96), (64, 6, 96, 9)]
        assert [at - t.rows.ctypes.data for _, _, at, _, _ in t._launches] == [
            0, 64 * 5 * 8]

    def test_chunks_keep_splits_within_shared_memory(self):
        big = list(np.linspace(-1, 1, TKE.MAX_SPLITS // 2 + 1))
        t = TKE.plan_slots([TKE.bucketize_slot(big, True, True) for _ in range(3)])
        assert t.chunks == [(0, 1), (1, 2), (2, 3)]

    @pytest.mark.parametrize("specs", [
        [], [TKE.onehot_slot(0)], [TKE.onehot_slot(-2)],
        [TKE.SlotSpec("bucketize", width=1, splits=(0.0,))],
        [TKE.SlotSpec("bucketize", width=0, splits=())],
        [TKE.SlotSpec("bucketize", width=9, splits=(0.0, 1.0))],
        [TKE.SlotSpec("histogram", width=3)],
        [TKE.onehot_slot(TKE.MAX_OUTPUT_WIDTH + 1)],
    ], ids=["empty", "width0", "width_neg", "one_split", "no_splits",
            "width_mismatch", "unknown_kind", "too_wide"])
    def test_planner_refuses(self, specs):
        with pytest.raises(ValueError):
            TKE.plan_slots(specs)

    @pytest.mark.parametrize("where", ["alone", "first", "middle", "last"])
    def test_oversized_bucketize_slot_is_a_launch_of_its_own(self, where):
        """A slot with more splits than shared memory holds is planned, as a
        chunk of one slot (its launch reads the splits from global memory);
        the slots around it keep their shared-memory chunks."""
        big = TKE.bucketize_slot(np.linspace(-3, 3, 5000), True, True)
        small = [TKE.onehot_slot(4), TKE.bucketize_slot([0.0, 1.0, 2.0], True, False)]
        specs = {"alone": [big], "first": [big] + small, "middle": small[:1] + [big]
                 + small[1:], "last": small + [big]}[where]
        t = TKE.plan_slots(specs)
        k = specs.index(big)
        assert (k, k + 1) in t.chunks
        assert t.chunks[0][0] == 0 and t.chunks[-1][1] == len(specs)
        assert all(t.chunks[i][1] == t.chunks[i + 1][0] for i in range(len(t.chunks) - 1))
        assert len(t.chunks) == 1 + (k > 0) + (k < len(specs) - 1)
        launch = t._launches[t.chunks.index((k, k + 1))]
        assert launch[1] == 1 and launch[3:] == (t.split_off[k], 5000)
        assert t.rows[k, 3] == 0 and t.rows[k, 4] == 5000
        assert t.width == sum(s.width for s in specs)

    @pytest.mark.parametrize("n", [37, 1203])
    def test_planner_accepts_5000_splits_and_encodes_the_plain_result(self, n):
        """A 5000-split slot (no limit in the reference) encodes, beside
        other slots, to the reference's XLA formula bit for bit."""
        splits = np.sort(np.random.default_rng(5).normal(size=5000)).astype(np.float32)
        splits[0], splits[-1] = -np.inf, np.inf
        x = _values(n, splits, seed=n + 9)
        codes = _codes(n, 5, seed=n)
        t = TKE.plan_slots([TKE.onehot_slot(5), TKE.bucketize_slot(splits, True, True)])
        out = TKE.encode_slots([torch.from_numpy(codes), torch.from_numpy(x)], t).numpy()
        with KD.force_kernel_mode("xla"):
            ref = np.asarray(device_bucketize_right(jnp.asarray(x), jnp.asarray(splits),
                                                    True, True))
        assert out.shape == (n, 5 + 4999 + 2)
        np.testing.assert_array_equal(out[:, 5:], ref)
        np.testing.assert_array_equal(out[:, :5], np.asarray(
            jax.nn.one_hot(jnp.asarray(codes), 5, dtype=jnp.float32)))
        one = TKE.bucketize_right_encode(torch.from_numpy(x), torch.from_numpy(splits),
                                         True, True)
        np.testing.assert_array_equal(one.numpy(), ref)

    @pytest.mark.parametrize("kind", ["onehot", "bucketize"])
    def test_slot_table_is_planned_once_per_tuple_of_slots(self, kind):
        make = (lambda w: TKE.onehot_slot(w)) if kind == "onehot" else \
            (lambda w: TKE.bucketize_slot(np.arange(w + 1), True, False))
        t = TKE.slot_table((make(3), make(4)))
        assert TKE.slot_table((make(3), make(4))) is t
        assert TKE.slot_table((make(4), make(3))) is not t
        assert t.col == [0, t.specs[0].width]
        assert t.width == sum(s.width for s in t.specs) == 7 + 2 * (kind == "bucketize")

    def test_table_fits_the_kernel_parameter_limit(self):
        # encode.cu: 40 header bytes + MAX_SLOTS entries of 32 bytes <= 4 KB
        assert 40 + 32 * TKE.MAX_SLOTS <= 4096


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
