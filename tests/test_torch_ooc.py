"""Out-of-core training and scoring: the port's chunked store, chunk
prefetcher, chunked epochs, ``Workflow.train(host_budget=, hbm_budget=)``
and ``score_dataset`` against the JAX package.

The reference's ``tests/test_chunked_ingest.py`` runs here test by test with
the import swapped (``transmogrifai_tpu_torch``, on the CPU), and each is
held against the JAX package on the same seeded numpy inputs
(``tests/torch_ooc_data.py``): spill layouts and chunk offsets equal, fitted
states equal, LR CV metrics within 1e-4 (the port's LR fits are not bitwise
the JAX ones), vectors bitwise where the reference pins bitwise.

Where the port departs from the reference by its own rules:

- a chunked epoch always runs the training plan (the reference's
  ``fused=False`` and ``TMOG_FUSED_TRANSFORM=0`` paths are one parametrized
  test holding the port's epoch against both of them);
- "zero compiles across chunk boundaries" is one ``chunk_tile`` allocation
  an epoch, whatever its chunks;
- a ``KernelError`` fails the epoch (no demotion to the host), a transient
  fault under ``resilient_training`` re-runs the chunk;
- a listener keeps the fused epoch and gets the reference's per-stage
  records a chunk.

The static TM607 of ``Workflow.validate`` / ``check_host_residency``,
``cli lint --host-budget`` and the IR corpus pin
(``TestProgramSurfaceUnforked``: the chunk tile's op-graph fingerprint
equals the in-memory transform prefix's in ``tests/goldens/torch_ir``) came
with the port's static analysis.
"""

import glob
import json
import os
import sys
import time

import numpy as np
import pytest

import transmogrifai_tpu as J
from transmogrifai_tpu.data import chunked as JC
from transmogrifai_tpu.data import dataset as JD
from transmogrifai_tpu.models import logistic as JL
from transmogrifai_tpu.perf.kernels import dispatch as JKD
from transmogrifai_tpu.workflow import fit as JFit
from transmogrifai_tpu.workflow import ooc as JOoc
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch import types as TT
from transmogrifai_tpu_torch.checkers.diagnostics import OpCheckError
from transmogrifai_tpu_torch.data.chunked import (
    ChunkedDataset,
    ChunkedDatasetWriter,
    ChunkStore,
    ColumnChunkWriter,
    dataset_nbytes,
    maybe_chunk,
)
from transmogrifai_tpu_torch.data.dataset import Column, Dataset, _gather_rows
from transmogrifai_tpu_torch.perf import measure_compiles
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.readers import OffsetCheckpoint
from transmogrifai_tpu_torch.readers.prefetch import ChunkPrefetcher, PrefetchStats
from transmogrifai_tpu_torch.workflow.fit import transform_dag
from transmogrifai_tpu_torch.workflow.ooc import EpochStats, chunked_transform_epoch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_ooc_data import (features, make_table, namespace,  # noqa: E402
                            port_namespace, runners_of)

TP = port_namespace()
JP = namespace(J, JL, JD, J.types)
#: the LR CV tolerance between the packages (ROADMAP parity rules)
LR_CV_TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _fixture(n=2000, seed=12):
    return make_table(TP, n, seed)


def _features(with_selector=False, folds=2):
    return features(TP, with_selector, folds)


def _train(ds, with_selector=False, **kw):
    label, out = _features(with_selector)
    return (T.Workflow().set_input_dataset(ds)
            .set_result_features(label, out)).train(**kw), out


def _jax_train(n, seed, with_selector=False, **kw):
    ds = make_table(JP, n, seed)
    label, out = features(JP, with_selector)
    with JKD.force_kernel_mode("interpret"):
        m = (J.Workflow().set_input_dataset(ds)
             .set_result_features(label, out)).train(**kw)
    return m, out, ds


def _rss_bytes():
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):  # pragma: no cover — non-linux
        return None


needs_proc = pytest.mark.skipif(_rss_bytes() is None,
                                reason="needs /proc/self/statm")


def _states(model):
    """The fitted states both packages must agree on: fills, vocabularies,
    kept indices, by stage class in topological order."""
    out = []
    for r in runners_of(model):
        cls = type(r).__name__
        if cls == "NumericVectorizerModel":
            out.append((cls, np.asarray(r.fills).tolist()))
        elif cls == "OneHotVectorizerModel":
            out.append((cls, [list(v) for v in r.vocabs]))
        elif cls == "SanityCheckerModel":
            out.append((cls, [int(i) for i in r.kept_indices]))
    return out


def _cv(model):
    return [list(r.metric_values) for r in model.summary().validation_results]


def _npy_tree(root):
    """{relative path: loaded array} of every spill file under ``root``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*.npy"), recursive=True)):
        out[os.path.relpath(path, root)] = np.load(path, allow_pickle=True)
    return out


class TestChunkedStore:
    def test_roundtrip_and_chunk_local_take(self):
        ds = _fixture(1111)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=256)
        assert cds.n_rows == 1111 and cds.n_chunks == 5
        back = cds.materialize()
        for name in ds.names:
            np.testing.assert_array_equal(back[name].data, ds[name].data)
            if ds[name].mask is not None:
                np.testing.assert_array_equal(back[name].mask, ds[name].mask)
        rng = np.random.default_rng(0)
        idx = rng.integers(-1111, 1111, size=400)
        got = cds.take(idx)
        want = ds.take(idx % 1111)
        for name in ds.names:
            np.testing.assert_array_equal(got[name].data, want[name].data)
        assert cds.take(np.zeros(0, np.intp)).n_rows == 0
        with pytest.raises(IndexError):
            cds["num0"].take(np.array([1111]))

    def test_spill_layout_equals_the_reference(self, tmp_path):
        """The same table spilled by both packages: the same files (names,
        arrays, masks) and the same manifest but for the ingest token."""
        stores = {}
        for key, pkg, mod in (("t", TP, None), ("j", JP, JC)):
            ds = make_table(pkg, 1111, 12)
            cls = ChunkedDataset if mod is None else mod.ChunkedDataset
            cds = cls.from_dataset(ds, chunk_rows=256, spill_dir=str(tmp_path / key))
            stores[key] = cds
        t_files, j_files = _npy_tree(str(tmp_path / "t")), _npy_tree(str(tmp_path / "j"))
        assert sorted(t_files) == sorted(j_files) and len(t_files) == 5 * 7 + 5 * 5
        for rel, arr in t_files.items():
            want = j_files[rel]
            assert arr.dtype == want.dtype and arr.shape == want.shape, rel
            assert arr.tolist() == want.tolist(), rel
        with open(tmp_path / "t" / "manifest.json") as fh:
            tm = json.load(fh)
        with open(tmp_path / "j" / "manifest.json") as fh:
            jm = json.load(fh)
        assert tm.pop("data_token") and jm.pop("data_token")
        assert tm == jm

    def test_long_column_names_spill(self, tmp_path):
        """A column name past a file name's length (a combined vector names
        every input) spills under its head and a digest; shorter names keep
        the reference's slug."""
        from transmogrifai_tpu_torch.data.chunked import MAX_SLUG

        for name in ("num0", "x" * MAX_SLUG, "a b/" * 300):
            store = ChunkStore(str(tmp_path / str(len(name))))
            slug = store._slug(name)
            assert len(slug) <= MAX_SLUG
            if len(name) <= MAX_SLUG:
                assert slug == JC.ChunkStore._slug(name)
            col = Column(TT.Real, np.arange(5.0), np.ones(5, np.bool_))
            w = ColumnChunkWriter(store, name, 2)
            for ci, lo in enumerate(range(0, 5, 2)):
                w.write(ci, col.take(np.arange(lo, min(lo + 2, 5))))
            np.testing.assert_array_equal(w.finish().materialize().data, col.data)
        assert ChunkStore._slug("a b/" * 300) != ChunkStore._slug("a b/" * 301)

    def test_select_split_and_resident_columns(self):
        ds = _fixture(600)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=128)
        sub = cds.select(["num0", "label"])
        assert sub.names == ["num0", "label"]
        tr, te = cds.split(0.25, seed=3)
        tr2, te2 = ds.split(0.25, seed=3)
        np.testing.assert_array_equal(tr["num1"].data, tr2["num1"].data)
        np.testing.assert_array_equal(te["cat0"].data, te2["cat0"].data)
        extra = Column(TT.Real, np.arange(600, dtype=np.float64), np.ones(600, np.bool_))
        cds2 = cds.with_resident_column("extra", extra)
        c1 = cds2.chunk(1)
        np.testing.assert_array_equal(c1["extra"].data,
                                      np.arange(128, 256, dtype=np.float64))

    def test_writer_streaming_and_schema_enforcement(self):
        ds = _fixture(500)
        w = ChunkedDatasetWriter(chunk_rows=200)
        for lo in range(0, 500, 200):
            w.append(ds.take(np.arange(lo, min(lo + 200, 500))))
        cds = w.finish()
        np.testing.assert_array_equal(cds.materialize()["num2"].data, ds["num2"].data)
        w2 = ChunkedDatasetWriter(chunk_rows=200)
        w2.append(ds.take(np.arange(100)))  # partial first chunk
        with pytest.raises(ValueError, match="final appended chunk"):
            w2.append(ds.take(np.arange(100, 200)))

    def test_maybe_chunk_budget(self, monkeypatch):
        ds = _fixture(400)
        jds = make_table(JP, 400, 12)
        assert dataset_nbytes(ds) == JC.dataset_nbytes(jds)
        assert maybe_chunk(ds) is ds  # no budget: fast path
        assert maybe_chunk(ds, budget=dataset_nbytes(ds) + 1) is ds
        spilled = maybe_chunk(ds, budget=1024)
        assert isinstance(spilled, ChunkedDataset)
        monkeypatch.setenv("TMOG_HOST_BUDGET", "1024")
        assert isinstance(maybe_chunk(ds), ChunkedDataset)
        monkeypatch.setenv("TMOG_HOST_BUDGET", "16MB")
        with pytest.raises(ValueError, match="TMOG_HOST_BUDGET"):
            maybe_chunk(ds)

    def test_open_restores_store_and_data_token(self, tmp_path):
        ds = _fixture(500)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=128,
                                          spill_dir=str(tmp_path / "s"))
        assert cds.data_token
        back = ChunkedDataset.open(str(tmp_path / "s"))
        assert back.data_token == cds.data_token
        assert back.n_rows == 500 and back.chunk_rows == 128
        np.testing.assert_array_equal(back.materialize()["num1"].data, ds["num1"].data)


class TestChunkLocalGatherRss:
    @needs_proc
    def test_memmap_take_does_not_materialize_column(self, tmp_path):
        n = 6_000_000  # 48 MB of float64
        path = tmp_path / "big.npy"
        np.save(path, np.arange(n, dtype=np.float64))
        mm = np.load(path, mmap_mode="r")
        col = Column(TT.Real, mm, None)
        idx = np.random.default_rng(1).integers(0, n, size=2_000)
        before = _rss_bytes()
        out = col.take(idx)
        delta = _rss_bytes() - before
        np.testing.assert_array_equal(out.data, np.asarray(idx, np.float64))
        assert delta < 24 * 1024 * 1024, f"take materialized the column: RSS grew {delta}"

    @needs_proc
    def test_spilled_column_take_rss_is_chunk_bounded(self, tmp_path):
        chunk_rows = 262_144  # 2 MB float64 chunks
        n = chunk_rows * 24   # 48 MB column
        store = ChunkStore(str(tmp_path / "store"))
        w = ColumnChunkWriter(store, "big", chunk_rows)
        for ci in range(24):
            lo = ci * chunk_rows
            w.write(ci, Column(TT.Real, np.arange(lo, lo + chunk_rows, dtype=np.float64),
                               None))
        col = w.finish()
        idx = np.random.default_rng(2).integers(0, n, size=2_000)
        before = _rss_bytes()
        out = col.take(idx)
        delta = _rss_bytes() - before
        np.testing.assert_array_equal(out.data, np.asarray(idx, np.float64))
        assert delta < 24 * 1024 * 1024, f"spilled take held more than a chunk: {delta}"

    def test_gather_rows_matches_fancy_index(self, tmp_path):
        np.save(tmp_path / "a.npy", np.arange(40_000, dtype=np.float32).reshape(20_000, 2))
        mm = np.load(tmp_path / "a.npy", mmap_mode="r")
        rng = np.random.default_rng(3)
        for idx in (rng.integers(-20_000, 20_000, size=777), np.zeros(0, np.intp),
                    rng.random(20_000) > 0.7):
            got = _gather_rows(mm, np.asarray(idx))
            np.testing.assert_array_equal(got, np.asarray(mm)[np.asarray(idx)])
            np.testing.assert_array_equal(got, JD._gather_rows(mm, np.asarray(idx)))
        for bad in (np.array([-20_005]), np.array([20_000])):
            with pytest.raises(IndexError):
                _gather_rows(mm, bad)


class TestPrefetch:
    def test_overlap_and_order(self):
        def loader(ci):
            time.sleep(0.002)
            return ci * 10

        stats = PrefetchStats()
        got = []
        with ChunkPrefetcher(loader, 8, stats=stats) as it:
            for ci, item in it:
                time.sleep(0.004)  # consumer slower than loader
                got.append((ci, item))
        assert got == [(i, i * 10) for i in range(8)]
        assert stats.chunks == 8
        assert stats.overlap_fraction > 0.5, stats.to_dict()
        assert sorted(stats.to_dict()) == sorted(_jax_prefetch_keys())

    def test_loader_error_propagates_at_position(self):
        def loader(ci):
            if ci == 3:
                raise RuntimeError("disk gone")
            return ci

        seen = []
        with pytest.raises(RuntimeError, match="disk gone"):
            with ChunkPrefetcher(loader, 8) as it:
                for ci, _item in it:
                    seen.append(ci)
        assert seen == [0, 1, 2]

    def test_early_close_stops_worker(self):
        it = ChunkPrefetcher(lambda ci: ci, 1000, depth=2)
        next(it)
        it.close()
        assert list(it) == []


def _jax_prefetch_keys():
    from transmogrifai_tpu.readers.prefetch import PrefetchStats as JPS

    return list(JPS().to_dict())


@pytest.fixture(scope="module")
def trained_pair():
    """The selector pipeline over the same 2000 rows: the port in memory,
    the port chunked (a budget one byte under the table), the JAX package
    chunked the same way."""
    with use_device("cpu"):
        ds = _fixture(2000)
        m1, p1 = _train(ds, True)
        m2, p2 = _train(ds, True, host_budget=dataset_nbytes(ds) - 1)
    mj, pj, jds = _jax_train(2000, 12, True, host_budget=JC.dataset_nbytes(
        make_table(JP, 2000, 12)) - 1)
    return {"ds": ds, "mem": (m1, p1), "chunked": (m2, p2), "jax": (mj, pj)}


class TestChunkedFitParity:
    def test_train_score_evaluate_bitwise(self, trained_pair):
        ds = trained_pair["ds"]
        (m1, p1), (m2, p2) = trained_pair["mem"], trained_pair["chunked"]
        assert m1.summary().best_model_name == m2.summary().best_model_name
        assert _cv(m1) == _cv(m2)
        ev = T.Evaluators.binary_classification()
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=512)
        assert m1.evaluate(ev, ds) == m2.evaluate(ev, cds)
        s1 = m1.score(ds, keep_intermediate=True)
        s2 = m2.score(cds, keep_intermediate=True)
        c1, c2 = s1[p1.name], s2[p2.name]
        if hasattr(c2, "materialize"):
            c2 = c2.materialize()
        np.testing.assert_array_equal(c1.data, c2.data)

    def test_chunked_train_equals_the_jax_chunked_train(self, trained_pair):
        m2, _ = trained_pair["chunked"]
        mj, _ = trained_pair["jax"]
        assert _states(m2) == _states(mj) and len(_states(m2)) == 3
        assert m2.summary().best_model_name == mj.summary().best_model_name
        assert m2.summary().best_grid == mj.summary().best_grid
        dev = max(abs(a - b) for ra, rb in zip(_cv(m2), _cv(mj)) for a, b in zip(ra, rb))
        assert dev <= LR_CV_TOL, dev

    def test_chunked_epochs_run_the_in_memory_slot_tables(self):
        """The chunked train's epochs run the in-memory train's flushes: the
        same device stages and encode slots, flush for flush (the port's
        flush rule: only the pending stages an estimator needs)."""
        ds = _fixture(2000)
        label, pred = _features(True)
        wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
        wf.train()
        flushes = [(r.get("stages", 0), r.get("encode_slots", 0))
                   for r in wf.last_train_profile if r["kind"] == "flush"]
        wf.train(host_budget=dataset_nbytes(ds) - 1)
        epochs = [(r["device_stages"], r["encode_slots"]) for r in wf.last_train_profile
                  if r["kind"] == "epoch"]
        assert epochs == flushes and any(slots for _, slots in epochs)

    def test_workflow_cv_parity(self):
        ds = _fixture(1500, seed=5)
        label1, p1 = _features(True)
        m1 = (T.Workflow().with_workflow_cv().set_input_dataset(ds)
              .set_result_features(label1, p1)).train()
        label2, p2 = _features(True)
        m2 = (T.Workflow().with_workflow_cv().set_input_dataset(ds)
              .set_result_features(label2, p2)).train(host_budget=dataset_nbytes(ds) - 1)
        assert _cv(m1) == _cv(m2)
        jds = make_table(JP, 1500, 5)
        jl, jp = features(JP, True)
        with JKD.force_kernel_mode("interpret"):
            mj = (J.Workflow().with_workflow_cv().set_input_dataset(jds)
                  .set_result_features(jl, jp)).train(
                      host_budget=JC.dataset_nbytes(jds) - 1)
        dev = max(abs(a - b) for ra, rb in zip(_cv(m2), _cv(mj)) for a, b in zip(ra, rb))
        assert dev <= LR_CV_TOL, dev

    def test_transform_parity_including_padded_tail(self, tmp_path):
        """512-row chunks: 3 full tiles + a padded 464-row tail, bitwise the
        in-memory transform, and bitwise the JAX package's chunked
        transform of the same (JAX-trained, saved) model."""
        ds = _fixture(2000)
        mj, jchecked, jds = _jax_train(2000, 12)
        mj.save(str(tmp_path / "m"))
        m = T.WorkflowModel.load(str(tmp_path / "m"))
        ref = transform_dag(ds, m.result_features, m.fitted, "cpu")
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=512)
        out = transform_dag(cds, m.result_features, m.fitted, "cpu")
        name = jchecked.name
        got = out[name].materialize().data
        np.testing.assert_array_equal(ref[name].data, got)
        with JKD.force_kernel_mode("interpret"):
            jout = JFit.transform_dag(JC.ChunkedDataset.from_dataset(jds, chunk_rows=512),
                                      mj.result_features, mj.fitted)
        want = jout[name].materialize().data
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()

    def test_two_epochs_over_one_table_do_not_alias(self):
        ds = _fixture(700, seed=41)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=256)
        m1, checked1 = _train(ds.take(np.arange(400)))
        m2, _ = _train(ds.take(np.arange(400, 700)))
        out1 = transform_dag(cds, m1.result_features, m1.fitted, "cpu")
        v1_before = out1[checked1.name].materialize().data.copy()
        transform_dag(cds, m2.result_features, m2.fitted, "cpu")
        np.testing.assert_array_equal(
            out1[checked1.name].materialize().data, v1_before,
            err_msg="a second epoch clobbered the first epoch's spill files")

    @pytest.mark.parametrize("reference_path", ["fused_false", "fused_env_off"])
    def test_always_fused_epoch_matches_both_reference_paths(
            self, reference_path, tmp_path, monkeypatch):
        """The port's epoch always runs the training plan; the reference's
        ``fused=False`` argument and its ``TMOG_FUSED_TRANSFORM=0`` chunked
        epoch both give the same vector, bitwise."""
        ds = _fixture(900, seed=9)
        mj, jchecked, jds = _jax_train(900, 9)
        mj.save(str(tmp_path / "m"))
        m = T.WorkflowModel.load(str(tmp_path / "m"))
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=256)
        got = transform_dag(cds, m.result_features, m.fitted, "cpu")[
            jchecked.name].materialize().data
        jcds = JC.ChunkedDataset.from_dataset(jds, chunk_rows=256)
        if reference_path == "fused_false":
            jout = JFit.transform_dag(jcds, mj.result_features, mj.fitted, fused=False)
        else:
            monkeypatch.setenv("TMOG_FUSED_TRANSFORM", "0")
            jout = JFit.transform_dag(jcds, mj.result_features, mj.fitted)
        want = jout[jchecked.name].materialize().data
        assert got.tobytes() == want.tobytes()


class TestZeroCompileAcrossChunks:
    def test_chunked_epoch_allocates_one_tile(self):
        """A whole chunked epoch allocates its tile once, whatever its
        chunks (the port's form of the reference's zero compiles across
        chunk boundaries), and the tail runs the same tile."""
        ds = _fixture(2000)
        m, checked = _train(ds)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=512)
        stats = EpochStats()
        with measure_compiles() as c:
            out = chunked_transform_epoch(cds, runners_of(m), stats=stats)
        assert cds.n_chunks == 4 and stats.chunks_processed == 4
        assert c.events == {"chunk_tile": 1} and stats.tile_allocations == 1
        ref = transform_dag(ds, m.result_features, m.fitted, "cpu")
        np.testing.assert_array_equal(out[checked.name].materialize().data,
                                      ref[checked.name].data)


class TestCrashAndResume:
    def _prep(self, tmp_path, n=1500):
        ds = _fixture(n, seed=21)
        m, checked = _train(ds)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=256,
                                          spill_dir=str(tmp_path / "store"))
        return ds, m, runners_of(m), cds, checked

    def test_epoch_resumes_from_committed_chunk(self, tmp_path):
        ds, m, runners, cds, checked = self._prep(tmp_path)
        ckpt = OffsetCheckpoint(str(tmp_path / "offsets.json"))
        store = cds.store
        real_write = store.write_chunk

        def dying_write(name, ci, data, mask):
            if ci >= 2 and name.startswith(checked.name):
                raise OSError("simulated crash during spill")
            return real_write(name, ci, data, mask)

        store.write_chunk = dying_write
        with pytest.raises(OSError, match="simulated crash"):
            chunked_transform_epoch(cds, runners, checkpoint=ckpt)
        store.write_chunk = real_write
        stats = EpochStats()
        with measure_compiles() as c:
            out = chunked_transform_epoch(cds, runners, checkpoint=ckpt, stats=stats)
        assert stats.chunks_skipped == 2, stats
        assert stats.chunks_processed == cds.n_chunks - 2
        assert c.events == {"chunk_tile": 1}
        ref = transform_dag(ds, m.result_features, m.fitted, "cpu")
        np.testing.assert_array_equal(ref[checked.name].data,
                                      out[checked.name].materialize().data)

    def test_chunk_offsets_equal_the_reference(self, tmp_path):
        """The same epoch in both packages commits the same chunk offsets."""
        offsets = {}
        for key, pkg, mod, ooc in (("t", TP, None, None), ("j", JP, JC, JOoc)):
            ds = make_table(pkg, 1500, 21)
            if mod is None:
                m, _ = _train(ds)
                cds = ChunkedDataset.from_dataset(ds, chunk_rows=256)
                ck = OffsetCheckpoint(str(tmp_path / f"{key}.json"))
                chunked_transform_epoch(cds, runners_of(m), checkpoint=ck)
            else:
                from transmogrifai_tpu.readers import OffsetCheckpoint as JOC

                m, _, _ = _jax_train(1500, 21)
                cds = mod.ChunkedDataset.from_dataset(ds, chunk_rows=256)
                ck = JOC(str(tmp_path / f"{key}.json"))
                with JKD.force_kernel_mode("interpret"):
                    ooc.chunked_transform_epoch(cds, runners_of(m), checkpoint=ck)
            with open(tmp_path / f"{key}.json") as fh:
                state = json.load(fh)
            offsets[key] = sorted(state.values())
        assert offsets["t"] == offsets["j"] == [6]

    def test_reingest_invalidates_the_resume_key(self, tmp_path):
        ds, m, runners, cds, checked = self._prep(tmp_path, n=700)
        ckpt = OffsetCheckpoint(str(tmp_path / "offsets.json"))
        chunked_transform_epoch(cds, runners, checkpoint=ckpt)
        cds2 = ChunkedDataset.from_dataset(ds, chunk_rows=256,
                                           spill_dir=str(tmp_path / "store"))
        assert cds2.data_token != cds.data_token
        stats = EpochStats()
        chunked_transform_epoch(cds2, runners, checkpoint=ckpt, stats=stats)
        assert stats.chunks_skipped == 0
        assert stats.chunks_processed == cds2.n_chunks

    def test_missing_spill_files_rewind_the_offset(self, tmp_path):
        ds, m, runners, cds, checked = self._prep(tmp_path, n=700)
        ckpt = OffsetCheckpoint(str(tmp_path / "offsets.json"))
        out1 = chunked_transform_epoch(cds, runners, checkpoint=ckpt)
        hits = glob.glob(os.path.join(cds.store.root, cds.store._slug(checked.name) + "_*",
                                      "c000001.npy"))
        assert hits, "expected a namespaced spill file for chunk 1"
        os.remove(hits[0])
        stats = EpochStats()
        out2 = chunked_transform_epoch(cds, runners, checkpoint=ckpt, stats=stats)
        assert stats.chunks_skipped <= 1
        np.testing.assert_array_equal(out1[checked.name].materialize().data,
                                      out2[checked.name].materialize().data)

    def test_sigkill_mid_epoch_resumes_in_fresh_process(self, tmp_path):
        """A real SIGKILL lands at the start of chunk 2; a fresh process
        reopens the spill store (same data token), skips the two committed
        chunks and completes bitwise-equal to the in-memory transform."""
        import signal
        import subprocess
        import textwrap

        script = tmp_path / "chunk_e2e.py"
        script.write_text(textwrap.dedent("""\
            import json, os, signal, sys

            import numpy as np

            mode, spill, offsets, out = sys.argv[1:5]

            from torch_ooc_data import features, make_table, port_namespace, runners_of
            from transmogrifai_tpu_torch import Workflow
            from transmogrifai_tpu_torch.data.chunked import ChunkedDataset
            from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
            from transmogrifai_tpu_torch.readers import OffsetCheckpoint
            from transmogrifai_tpu_torch.workflow.fit import transform_dag
            from transmogrifai_tpu_torch.workflow.ooc import (
                EpochStats, chunked_transform_epoch)

            TP = port_namespace()
            with use_device("cpu"):
                ds = make_table(TP, 700, 21)
                label, checked = features(TP)
                m = (Workflow().set_input_dataset(ds)
                     .set_result_features(label, checked)).train()
                runners = runners_of(m)
                ckpt = OffsetCheckpoint(offsets)
                if mode == "kill":
                    from transmogrifai_tpu_torch.serve.faults import FaultHarness

                    cds = ChunkedDataset.from_dataset(ds, chunk_rows=256,
                                                      spill_dir=spill)
                    h = FaultHarness()
                    h.script("ingest_chunk", [None, None, lambda ctx: os.kill(
                        os.getpid(), signal.SIGKILL)])
                    with h:
                        chunked_transform_epoch(cds, runners, checkpoint=ckpt)
                    raise SystemExit("unreachable: SIGKILL should have landed")
                cds = ChunkedDataset.open(spill)
                stats = EpochStats()
                out_ds = chunked_transform_epoch(cds, runners, checkpoint=ckpt,
                                                 stats=stats)
                ref = transform_dag(ds, m.result_features, m.fitted, "cpu")
                bitwise = bool(np.array_equal(ref[checked.name].data,
                                              out_ds[checked.name].materialize().data))
            with open(out, "w") as fh:
                json.dump({"skipped": stats.chunks_skipped,
                           "processed": stats.chunks_processed,
                           "n_chunks": cds.n_chunks, "bitwise": bitwise}, fh)
        """))
        env = {**os.environ,
               "PYTHONPATH": os.pathsep.join([REPO, os.path.join(REPO, "tests"),
                                              os.environ.get("PYTHONPATH", "")])}
        spill, offsets, out = tmp_path / "store", tmp_path / "offsets.json", \
            tmp_path / "resume.json"
        killed = subprocess.run([sys.executable, str(script), "kill", str(spill),
                                 str(offsets), str(out)],
                                capture_output=True, text=True, env=env, timeout=300)
        assert killed.returncode == -signal.SIGKILL, killed.stderr
        assert os.path.exists(offsets)
        resumed = subprocess.run([sys.executable, str(script), "run", str(spill),
                                  str(offsets), str(out)],
                                 capture_output=True, text=True, env=env, timeout=300)
        assert resumed.returncode == 0, resumed.stderr
        report = json.loads(out.read_text())
        assert report["skipped"] == 2, report
        assert report["processed"] == report["n_chunks"] - 2
        assert report["bitwise"] is True

    def test_train_resume_writes_chunk_offsets(self, tmp_path):
        """``train(resume=dir)`` over a chunked table: a non-retryable fault
        at ingest_chunk chunk 2 kills the first epoch after 2 commits; the
        re-run with the same dir records ``chunk_resume`` (2 skipped) and
        ends in the model of an uninterrupted chunked train, bitwise."""
        from transmogrifai_tpu_torch.obs import flight as obs_flight
        from transmogrifai_tpu_torch.serve.faults import FaultHarness

        ds = _fixture(1000, seed=4)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=256,
                                          spill_dir=str(tmp_path / "store"))
        label, pred = _features(True)
        wf = T.Workflow().set_input_dataset(cds).set_result_features(label, pred)
        clean = wf.train()
        resume = str(tmp_path / "resume")
        h = FaultHarness()
        h.script("ingest_chunk", [None, None, RuntimeError("killed at chunk 2")])
        with h, pytest.raises(RuntimeError, match="killed at chunk 2"):
            wf.train(resume=resume)
        assert os.path.exists(os.path.join(resume, "chunk_offsets.json"))
        recorder = obs_flight.install_recorder(obs_flight.FlightRecorder())
        try:
            resumed = wf.train(resume=resume)
        finally:
            obs_flight.uninstall_recorder()
        evs = recorder.events("chunk_resume")
        assert [e["data"]["skipped_chunks"] for e in evs] == [2]
        assert evs[0]["data"]["total_chunks"] == cds.n_chunks
        assert _cv(resumed) == _cv(clean)
        sel = pred.origin_stage.uid
        a, b = clean.fitted[sel].model, resumed.fitted[sel].model
        assert np.asarray(a.coef).tobytes() == np.asarray(b.coef).tobytes()
        assert a.intercept == b.intercept


class TestEpochFaults:
    def test_kernel_error_fails_the_epoch(self, monkeypatch):
        """A KernelError in a chunk's device prefix fails the epoch: no
        chunk after it runs, nothing moves to the host path."""
        from transmogrifai_tpu_torch.perf.kernels.dispatch import KernelError
        from transmogrifai_tpu_torch.workflow import plan as TPlan

        ds = _fixture(1000)
        m, _ = _train(ds)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=256)
        calls = []
        real = TPlan.ColumnarTransformPlan.apply_prefix

        def failing(self, dataset, tile=None):
            calls.append(tile)
            if len(calls) == 2:
                raise KernelError("encode_slots: illegal address")
            return real(self, dataset, tile=tile)

        monkeypatch.setattr(TPlan.ColumnarTransformPlan, "apply_prefix", failing)
        host = []
        monkeypatch.setattr(TPlan, "_run_host_stage",
                            lambda r, d, dev, _h=TPlan._run_host_stage:
                            host.append(type(r).__name__) or _h(r, d, dev))
        with pytest.raises(KernelError):
            chunked_transform_epoch(cds, runners_of(m))
        assert calls == [256, 256]
        prefix = {type(r).__name__ for r in runners_of(m)
                  if callable(getattr(r, "device_transform", None))}
        assert not prefix & set(host[len(runners_of(m)):])

    def test_transient_fault_reruns_the_chunk(self):
        from transmogrifai_tpu_torch.serve.faults import FaultHarness, TransientScoringError
        from transmogrifai_tpu_torch.workflow import resilience as R

        ds = _fixture(1000)
        m, checked = _train(ds)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=256)
        h = FaultHarness()
        h.script("ingest_chunk", [None, TransientScoringError("unavailable")])
        with h, R.resilient_training(policy=R.RetryPolicy(sleep=lambda s: None)) as res:
            stats = EpochStats()
            out = chunked_transform_epoch(cds, runners_of(m), stats=stats)
        assert res.retries == 1 and stats.chunks_processed == cds.n_chunks
        assert h.calls["ingest_chunk"] == cds.n_chunks + 1
        ref = transform_dag(ds, m.result_features, m.fitted, "cpu")
        np.testing.assert_array_equal(out[checked.name].materialize().data,
                                      ref[checked.name].data)

    def test_listener_keeps_the_fused_epoch(self):
        """With a listener active the epoch still runs the plan; each chunk
        hands it the reference's per-stage records (stage, rows, columns)."""
        from transmogrifai_tpu.utils import listener as JLs
        from transmogrifai_tpu_torch.utils import listener as TLs

        got = {}
        for key, pkg, mod, ls in (("t", TP, None, TLs), ("j", JP, JC, JLs)):
            ds = make_table(pkg, 600, 3)
            if mod is None:
                m, _ = _train(ds)
                cds = ChunkedDataset.from_dataset(ds, chunk_rows=256)
            else:
                m, _, _ = _jax_train(600, 3)
                cds = mod.ChunkedDataset.from_dataset(ds, chunk_rows=256)
            lst = ls.OpMetricsListener()
            ls.add_listener(lst)
            try:
                if mod is None:
                    chunked_transform_epoch(cds, runners_of(m))
                else:
                    with JKD.force_kernel_mode("interpret"):
                        JOoc.chunked_transform_epoch(cds, runners_of(m))
            finally:
                ls.remove_listener(lst)
            got[key] = [(s.stage_class, s.phase, s.n_rows, s.n_cols_in, s.n_cols_out)
                        for s in lst.metrics.stage_metrics]
        assert got["t"] == got["j"] and len(got["t"]) == 3 * len(runners_of(m))


class TestHostResidencyGate:
    def test_runtime_gate_refuses_oversized_fit_set(self):
        ds = _fixture(1200)
        label, pred = _features(True)
        wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
        with pytest.raises(OpCheckError) as ei:
            wf.train(host_budget=4_096)
        assert any(d.code == "TM607" for d in ei.value.report)
        jl, jp = features(JP, True)
        jwf = J.Workflow().set_input_dataset(make_table(JP, 1200, 12)) \
            .set_result_features(jl, jp)
        with pytest.raises(J.checkers.diagnostics.OpCheckError) as ej:
            jwf.train(host_budget=4_096)
        assert [d.code for d in ei.value.report] == [d.code for d in ej.value.report]

    def test_workflow_cv_materialization_is_gated_too(self):
        ds = _fixture(1200)
        label, pred = _features(True)
        wf = (T.Workflow().with_workflow_cv().set_input_dataset(ds)
              .set_result_features(label, pred))
        with pytest.raises(OpCheckError) as ei:
            wf.train(host_budget=4_096)
        assert any(d.code == "TM607" for d in ei.value.report)

    def test_static_tm607_over_and_under_budget(self):
        ds = _fixture(1200)
        label, pred = _features(with_selector=True)
        m = (T.Workflow().set_input_dataset(ds)
             .set_result_features(label, pred)).train()
        # generous budget: clean, report attached
        rep = m.validate(host_budget=1 << 30, rows=1_000)
        assert not [d for d in rep if d.code in ("TM606", "TM607")]
        assert rep.host_residency is not None
        assert rep.host_residency.peak_chunked_bytes > 0
        assert rep.host_residency.fit_sets  # estimator working sets listed
        # tiny budget at huge rows: TM607 fires (fail closed)
        rep2 = m.validate(host_budget=1_000_000, rows=50_000_000)
        assert [d for d in rep2 if d.code == "TM607"], rep2.pretty()
        # armed without a row count: TM606 (cannot evaluate -> fail closed)
        rep3 = m.validate(host_budget=1_000_000)
        assert [d for d in rep3 if d.code == "TM606"]
        # the JAX package's model of the same table decides the same way
        jm, _jout, _jds = _jax_train(1200, 12, with_selector=True)
        for budget, rows in ((1 << 30, 1_000), (1_000_000, 50_000_000),
                             (1_000_000, None)):
            codes = sorted(d.code for d in m.validate(host_budget=budget, rows=rows)
                           if d.code in ("TM606", "TM607"))
            assert codes == sorted(
                d.code for d in jm.validate(host_budget=budget, rows=rows)
                if d.code in ("TM606", "TM607"))

    def test_unfitted_workflow_fails_closed(self):
        label, pred = _features(with_selector=True)
        wf = T.Workflow().set_result_features(label, pred)
        rep = wf.validate(host_budget=1_000_000, rows=10_000)
        assert [d for d in rep if d.code == "TM606"]

    def test_cli_lint_host_budget(self):
        from transmogrifai_tpu_torch.cli.gen import main

        with pytest.raises(SystemExit):
            # --host-budget without --rows refuses (fail closed)
            main(["lint", "--workflow", "test_torch_ooc:_wf",
                  "--host-budget", "1000000"])


def _wf():
    """cli lint --workflow target used by TestHostResidencyGate."""
    label, pred = _features(with_selector=True)
    return T.Workflow().set_result_features(label, pred)


class TestProgramSurfaceUnforked:
    def test_ir_corpus_chunk_family_dedups_bit_identical(self):
        """The chunked-epoch prefix family of the port's op-graph corpus
        carries the same fingerprint as the in-memory transform_prefix
        family: chunking does not fork the program surface."""
        from transmogrifai_tpu_torch.checkers.irsnap import (build_corpus,
                                                             default_goldens_dir)

        with open(os.path.join(default_goldens_dir(), "index.json")) as fh:
            entries = json.load(fh)["entries"]
        base = entries["workflow.plan.transform_prefix"]
        chunk = entries["workflow.plan.transform_prefix@chunk"]
        assert chunk["irFingerprint"] == base["irFingerprint"]
        # and a fresh build agrees (not just the recorded goldens)
        snaps, _skipped = build_corpus(families=["transform_prefix"])
        fresh = {k: s.ir_fingerprint for k, s in snaps.items()}
        assert fresh["workflow.plan.transform_prefix@chunk"] == \
            fresh["workflow.plan.transform_prefix"]


def _nested_x(r):
    """Module-level custom extract used by the score_dataset refusal test."""
    return r["payload"]["x"]


class TestChunkedReaderAndServe:
    def test_reader_generate_chunked_matches_generate_dataset(self, tmp_path):
        from transmogrifai_tpu.readers.base import CustomReader as JCustomReader
        from transmogrifai_tpu_torch.readers.base import CustomReader

        rng = np.random.default_rng(7)
        records = [{"num0": float(rng.normal()), "label": float(i % 2),
                    "cat0": f"lv{i % 5}"} for i in range(700)]
        layouts = {}
        for key, pkg, reader in (("t", TP, CustomReader), ("j", JP, JCustomReader)):
            t = pkg.types
            raw = [pkg.FeatureBuilder.of("label", t.RealNN).extract_field().as_response(),
                   pkg.FeatureBuilder.of("num0", t.Real).extract_field().as_predictor(),
                   pkg.FeatureBuilder.of("cat0", t.PickList).extract_field().as_predictor()]
            ref = reader(lambda: iter(records)).generate_dataset(raw)
            cds = reader(lambda: iter(records)).generate_chunked(
                raw, chunk_rows=256, spill_dir=str(tmp_path / key))
            assert cds.n_chunks == 3
            got = cds.materialize()
            for f in raw:
                np.testing.assert_array_equal(got[f.name].data, ref[f.name].data)
            layouts[key] = _npy_tree(str(tmp_path / key))
        assert sorted(layouts["t"]) == sorted(layouts["j"])
        for rel, arr in layouts["t"].items():
            assert arr.tolist() == layouts["j"][rel].tolist(), rel

    def test_compiled_plan_score_dataset_chunked(self):
        ds = _fixture(800, seed=31)
        m, _ = _train(ds, True)
        plan = m.serving_plan(min_bucket=8, max_bucket=256, strict=False)
        records = plan._records_of(ds)
        ref = plan.score(records)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=256)
        got = plan.score_dataset(cds)
        assert got == ref
        assert plan.last_prefetch["chunks"] == cds.n_chunks
        sunk = []
        n = plan.score_dataset(cds, sink=sunk.extend)
        assert n == len(ref) and sunk == ref
        assert plan.score_dataset(ds) == ref

    def test_score_dataset_equals_the_reference(self, tmp_path):
        """The JAX package's model, saved and loaded into the port, scores a
        chunked table as the JAX package's plan scores its own, record for
        record."""
        mj, _, jds = _jax_train(800, 31, True)
        mj.save(str(tmp_path / "m"))
        m = T.WorkflowModel.load(str(tmp_path / "m"))
        got = m.serving_plan(8, 256, False).score_dataset(
            ChunkedDataset.from_dataset(_fixture(800, seed=31), chunk_rows=256))
        with JKD.force_kernel_mode("interpret"):
            want = mj.serving_plan(min_bucket=8, max_bucket=256, strict=False) \
                .score_dataset(JC.ChunkedDataset.from_dataset(jds, chunk_rows=256))
        assert len(got) == 800 and got == want

    def test_score_dataset_refuses_custom_extracts(self):
        from transmogrifai_tpu_torch.readers.base import CustomReader, rows_to_dataset

        rng = np.random.default_rng(3)
        records = [{"payload": {"x": float(rng.normal())}, "label": float(i % 2)}
                   for i in range(300)]
        label = T.FeatureBuilder.of("label", TT.RealNN).extract_field().as_response()
        x = T.FeatureBuilder.of("x", TT.Real).extract(_nested_x).as_predictor()
        checked = label.sanity_check(T.transmogrify([x]))
        sel = T.BinaryClassificationModelSelector.with_cross_validation(
            models=[(TP.LogisticRegression(), [{"reg_param": 0.1}])], num_folds=2)
        pred = label.transform_with(sel, checked)
        m = (T.Workflow().set_reader(CustomReader(lambda: iter(records)))
             .set_result_features(label, pred)).train()
        plan = m.serving_plan(min_bucket=8, max_bucket=256, strict=False)
        assert plan.score(records[:4])
        ds = rows_to_dataset(records, [label, x])
        with pytest.raises(ValueError, match="custom extract"):
            plan.score_dataset(ds)

    def test_aggregate_reader_refuses_generate_chunked(self):
        from transmogrifai_tpu_torch.readers.base import AggregateReader, CustomReader

        reader = AggregateReader(CustomReader(lambda: iter([])),
                                 key_fn=lambda r: "k", time_fn=lambda r: 0)
        with pytest.raises(NotImplementedError, match="per-event"):
            reader.generate_chunked([])


class TestHbmBudgetDecisions:
    """TM601 on training plans: the port's meta-tensor estimate and the
    reference's jaxpr estimate are different bytes, so the packages are held
    to the same decisions at budgets far above and far below both."""

    def _plans(self):
        from transmogrifai_tpu.checkers import plancheck as JPC
        from transmogrifai_tpu.workflow import plan as JPlan
        from transmogrifai_tpu_torch.checkers import plancheck as TPC
        from transmogrifai_tpu_torch.workflow import plan as TPlan

        ds = _fixture(2000)
        m, checked = _train(ds)
        jm, _, jds = _jax_train(2000, 12)
        tplan = TPlan.ColumnarTransformPlan(runners_of(m), frozenset(ds.names), "cpu")
        jplan, _ = JPlan.plan_for(runners_of(jm), frozenset(jds.names))
        t_est = TPC.analyze_transform_plan(tplan, ds).peak_hbm_bytes
        j_est = JPC.analyze_transform_plan(jplan, jds).peak_hbm_bytes
        assert t_est > 0 and j_est > 0
        return ds, m, jds, jm, tplan, jplan, min(t_est, j_est), max(t_est, j_est)

    @staticmethod
    def _decision(fn):
        try:
            fn()
        except (OpCheckError, J.checkers.diagnostics.OpCheckError) as e:
            return [d.code for d in e.report]
        return "admitted"

    def test_flush_decisions_equal(self):
        from transmogrifai_tpu.workflow import plan as JPlan
        from transmogrifai_tpu_torch.workflow import plan as TPlan

        ds, m, jds, jm, tplan, jplan, lo, hi = self._plans()
        for budget, want in ((hi * 10, "admitted"), (lo / 10, ["TM601"])):
            t = self._decision(lambda: TPlan.check_plan_hbm_budget(tplan, ds, budget))
            j = self._decision(lambda: JPlan.check_plan_hbm_budget(jplan, jds, budget))
            assert t == j == want, (budget, t, j)

    def test_train_decisions_equal_and_refusal_precedes_any_launch(self, monkeypatch):
        from transmogrifai_tpu_torch.workflow import plan as TPlan

        ds, m, jds, jm, tplan, jplan, lo, hi = self._plans()
        runs = []
        real = TPlan.JointPrefix.apply_prefix
        monkeypatch.setattr(TPlan.JointPrefix, "apply_prefix",
                            lambda self, *a, **k: runs.append(1) or real(self, *a, **k))
        for budget, want in ((hi * 10, "admitted"), (lo / 10, ["TM601"])):
            runs.clear()
            t = self._decision(lambda: _train(ds, True, hbm_budget=budget))
            jl, jp = features(JP, True)
            j = self._decision(lambda: J.Workflow().set_input_dataset(jds)
                               .set_result_features(jl, jp).train(hbm_budget=budget))
            assert t == j == want, (budget, t, j)
            assert bool(runs) == (want == "admitted")

    def test_fold_plan_decisions_equal(self):
        ds, m, jds, jm, tplan, jplan, lo, hi = self._plans()
        for budget, want in ((hi * 100, "admitted"), (lo / 10, ["TM601"])):
            label, pred = _features(True)
            t = self._decision(lambda: T.Workflow().with_workflow_cv().set_input_dataset(ds)
                               .set_result_features(label, pred).train(hbm_budget=budget))
            jl, jp = features(JP, True)
            j = self._decision(lambda: J.Workflow().with_workflow_cv()
                               .set_input_dataset(jds).set_result_features(jl, jp)
                               .train(hbm_budget=budget))
            assert t == j == want, (budget, t, j)

    def test_chunk_tile_decisions_equal(self):
        ds, m, jds, jm, tplan, jplan, lo, hi = self._plans()
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=512)
        jcds = JC.ChunkedDataset.from_dataset(jds, chunk_rows=512)
        for budget, want in ((hi * 10, "admitted"), (lo / 100, ["TM601"])):
            t = self._decision(lambda: chunked_transform_epoch(
                cds, runners_of(m), hbm_budget=budget))
            j = self._decision(lambda: JOoc.chunked_transform_epoch(
                jcds, runners_of(jm), hbm_budget=budget))
            assert t == j == want, (budget, t, j)

    def test_failing_analyzer_fails_closed_as_tm606(self, monkeypatch):
        from transmogrifai_tpu_torch.checkers import plancheck as TPC

        def broken(*a, **k):
            raise RuntimeError("cannot size this plan")

        monkeypatch.setattr(TPC, "analyze_transform_plan", broken)
        with pytest.raises(OpCheckError) as ei:
            _train(_fixture(600), hbm_budget=1e12)
        assert [d.code for d in ei.value.report] == ["TM606"]
