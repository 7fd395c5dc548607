"""The port's mesh in one process: ``parallel/mesh.py``'s API, its content
placement cache, the topology keys, the chunk tile, the column helpers of
``parallel/wide.py`` and the TM603/608/609 static gate.

The reference's single-process meshed tests (``tests/test_use_mesh.py``,
``tests/test_multihost.py``, ``tests/test_wide_sharding.py``) with the
import swapped.  A one-process mesh is 1 x 1 (one rank; every collective the
identity); the reference's 4 x 2 layouts are the port's ``virtual_mesh``
(rank 0's view of eight ranks, tracing meta operands only) where the test
reads static costs or keys.  Meshes of several processes run in
``tests/test_torch_mesh_training.py``.
"""

from functools import partial

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch.parallel.mesh as M
from transmogrifai_tpu_torch.parallel.mesh import (
    current_mesh,
    make_mesh,
    mesh_token,
    pad_rows_for_mesh,
    place_rows,
    use_mesh,
    virtual_mesh,
)
from transmogrifai_tpu_torch.parallel.wide import (pad_cols, shard_cols,
                                                    wide_col_stats, wide_full_corr,
                                                    wide_gram_ring)
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def on_cpu():
    with use_device("cpu"):
        yield


class TestUseMesh:
    def test_context_sets_and_resets(self):
        assert current_mesh() is None
        with use_mesh(make_mesh()) as m:
            assert current_mesh() is m
        assert current_mesh() is None

    def test_make_mesh_shape_and_mismatch(self):
        m = make_mesh()
        assert m.shape == {"data": 1, "model": 1} and m.axis_names == ("data", "model")
        assert m.device_type == "cpu" and m.group("data") is None
        with pytest.raises(ValueError, match="mesh 4x2 != 1 devices"):
            make_mesh(4, 2)

    def test_place_rows_takes_this_ranks_span(self):
        x = np.arange(24 * 3, dtype=np.float32).reshape(24, 3)
        with use_mesh(make_mesh()):
            xd = place_rows(x)
        assert tuple(xd.shape) == (24, 3)   # one rank holds every row
        with use_mesh(virtual_mesh(8, 1)):
            assert M.row_span(24) == slice(0, 3)    # 24 rows / 8 ranks
            assert M.row_span(203) == slice(0, 26)  # uneven: ceil-sized spans

    @pytest.mark.parametrize("mesh, expected", [
        (lambda: virtual_mesh(8, 1), (16, 2)),
        (lambda: virtual_mesh(4, 2), (12, 2)),
        (lambda: None, (10, 2)),
    ], ids=["8x1", "4x2", "none"])
    def test_pad_rows_for_mesh(self, mesh, expected):
        m = mesh()
        a, b, n_valid = pad_rows_for_mesh(np.ones((10, 2)), np.ones(10), mesh=m)
        assert n_valid == 10
        assert a.shape == expected and b.shape == (expected[0],)
        assert (a[10:] == 0).all()

    def test_no_mesh_is_noop(self):
        a, n_valid = pad_rows_for_mesh(np.ones((10, 2)))
        assert n_valid == 10 and a.shape == (10, 2)

    def test_shard_rows_pads_to_an_even_split(self):
        """The reference's even split: 10 rows over 4 ranks pad to 12, rank
        0 holds 3 (the padded rows are zero; callers mask with row_mask)."""
        x = np.arange(10 * 2, dtype=np.float32).reshape(10, 2)
        block, n_valid = M.shard_rows(x, virtual_mesh(4, 1), device=CPU)
        assert n_valid == 10
        np.testing.assert_array_equal(block.numpy(), x[:3])
        whole, n = M.shard_rows(x, None, device=CPU)
        assert n == 10 and tuple(whole.shape) == (10, 2)

    def test_bucket_arithmetic(self):
        assert M.bucket_size(5) == 1024 and M.bucket_size(1025) == 2048
        (a,) = M.pad_rows_to_bucket(1500, np.ones((1500, 2)))
        assert a.shape == (2048, 2)
        with use_mesh(virtual_mesh(4, 2)):
            a, n = M.pad_rows_bucketed_for_mesh(np.ones((1500, 3)))
        assert a.shape == (2048, 3) and n == 1500
        np.testing.assert_array_equal(M.row_mask(6, 4).numpy(), [1, 1, 1, 1, 0, 0])

    def test_model_share_splits_or_replicates(self):
        with use_mesh(virtual_mesh(4, 2)):
            assert M.model_share(4) == [0, 1]        # rank 0's half
            assert M.model_share(3) == [0, 1, 2]     # does not divide: all
        assert M.model_share(4) == [0, 1, 2, 3]

    def test_place_spec_degrades_to_replication(self):
        from transmogrifai_tpu_torch.models.base import place_grid

        with use_mesh(virtual_mesh(4, 2)):
            g = place_grid(np.arange(8, dtype=np.float32), CPU)
            assert g.tolist() == [0.0, 1.0, 2.0, 3.0]   # model axis: rank 0's half
            g3 = place_grid(np.arange(3, dtype=np.float32), CPU)
            assert g3.tolist() == [0.0, 1.0, 2.0]       # 3 % 2 != 0: whole
        g2 = place_grid(np.arange(8, dtype=np.float32), CPU)
        assert tuple(g2.shape) == (8,)

    def test_virtual_mesh_refuses_real_collectives(self):
        with use_mesh(virtual_mesh(2, 1)):
            with pytest.raises(RuntimeError, match="virtual mesh"):
                M.reduce_rows(torch.ones(3))
            out = M.reduce_rows(torch.ones(3, device="meta"))
            assert out.device.type == "meta"


class TestPlacementContentCache:
    """The content-keyed placement caches (stamp memo + freeze semantics)."""

    def test_equal_content_fresh_copy_hits(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(300, 4)).astype(np.float32)
        a1, n1 = M.place_rows_bucketed_cached(x)
        a2, n2 = M.place_rows_bucketed_cached(x.copy())
        assert a1 is a2 and n1 == n2 == 300

    def test_changed_content_misses(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(300, 4)).astype(np.float32)
        a1, _ = M.place_rows_bucketed_cached(x)
        x2 = x.copy()
        x2[7, 1] += 1.0
        a2, _ = M.place_rows_bucketed_cached(x2)
        assert a2 is not a1
        np.testing.assert_allclose(a2.numpy()[7, 1], x2[7, 1])

    def test_memoized_block_is_frozen_and_mutation_raises(self, monkeypatch):
        monkeypatch.setattr(M, "_STAMP_MEMO_MIN_BYTES", 1024)
        rng = np.random.default_rng(2)
        x = rng.normal(size=(256, 8)).astype(np.float32)  # 8 KB >= threshold
        M.place_rows_bucketed_cached(x)
        assert not x.flags.writeable
        with pytest.raises(ValueError):
            x[0, 0] = 99.0
        a1, _ = M.place_rows_bucketed_cached(x)
        a2, _ = M.place_rows_bucketed_cached(x)
        assert a1 is a2

    def test_unfrozen_then_mutated_rehashes(self, monkeypatch):
        monkeypatch.setattr(M, "_STAMP_MEMO_MIN_BYTES", 1024)
        rng = np.random.default_rng(3)
        x = rng.normal(size=(256, 8)).astype(np.float32)
        a1, _ = M.place_rows_bucketed_cached(x)
        x.flags.writeable = True  # deliberate two-step override
        x[10, 2] += 5.0
        a2, _ = M.place_rows_bucketed_cached(x)
        assert a2 is not a1
        np.testing.assert_allclose(a2.numpy()[10, 2], x[10, 2])

    def test_view_never_memoized_narrow_mutation_rehashes(self, monkeypatch):
        monkeypatch.setattr(M, "_STAMP_MEMO_MIN_BYTES", 1024)
        rng = np.random.default_rng(5)
        base = rng.normal(size=(512, 8)).astype(np.float32)
        view = base[:]
        assert view.base is not None
        a1, _ = M.place_rows_bucketed_cached(view)
        assert base.flags.writeable  # views are never frozen
        base[300, 5] += 7.0
        a2, _ = M.place_rows_bucketed_cached(view)
        assert a2 is not a1
        np.testing.assert_allclose(a2.numpy()[300, 5], base[300, 5])

    def test_feature_block_keys_on_identity(self, monkeypatch):
        """The main path's feature block (``models/base.py::place_rows``)
        keys on the array's identity: placing it again hashes no byte of
        it, a fresh equal copy places anew, an in-place change of a sampled
        row misses, and nothing is frozen."""
        from transmogrifai_tpu_torch.models.base import place_rows

        rng = np.random.default_rng(6)
        x = rng.normal(size=(640, 8)).astype(np.float32)
        a1 = place_rows(x, "cpu")
        monkeypatch.setattr(M, "_content_stamp", lambda a: pytest.fail("hashed"))
        assert place_rows(x, "cpu") is a1
        assert place_rows(x, "cpu", insert=False) is a1
        assert x.flags.writeable
        a2 = place_rows(x.copy(), "cpu")
        assert a2 is not a1 and torch.equal(a2, a1)
        x[10 * (640 // 64), 3] += 1.0
        a3 = place_rows(x, "cpu")
        assert a3 is not a1
        np.testing.assert_array_equal(a3.numpy(), x)

    def test_lookup_only_mode_does_not_insert(self):
        rng = np.random.default_rng(4)
        before = dict(M._PLACED_ROWS_CACHE)
        x = rng.normal(size=(700, 3)).astype(np.float32)
        M.place_rows_bucketed_cached(x, insert=False)
        assert dict(M._PLACED_ROWS_CACHE) == before

    def test_replicated_and_sharded_placements_key_apart(self):
        x = np.arange(40, dtype=np.float32).reshape(20, 2)
        mesh = make_mesh()
        with use_mesh(mesh):
            a, _ = M.place_rows_bucketed_cached(x)
            b, _ = M.place_rows_bucketed_cached(x, replicate=True)
        assert a is not b and torch.equal(a, b)   # one rank: the same rows


class TestTopologyKeys:
    """Cache keys and plan fingerprints carry the mesh shape and the process
    topology, so a meshed program never aliases an unmeshed one."""

    def test_mesh_token_carries_process_topology(self, monkeypatch):
        with use_mesh(virtual_mesh(4, 2)) as m:
            t1 = mesh_token()
            monkeypatch.setattr(m, "world_size", 16)
            t2 = mesh_token()
        assert t1 != t2 and t1[:2] == t2[:2]
        assert t1 == (("data", "model"), (4, 2), 8, 8, None)
        assert mesh_token() is None  # no ambient mesh -> no token

    def test_run_cached_fingerprint_differs_by_topology(self, monkeypatch):
        from transmogrifai_tpu_torch.models.logistic import _irls_sweep
        from transmogrifai_tpu_torch.perf.programs import cache_key_fingerprint

        args = (np.zeros((64, 5), np.float32), np.zeros(64, np.float32),
                np.zeros((2, 64), np.float32), np.zeros(2, np.float32))
        statics = dict(max_iter=3, has_intercept=True)
        fp_none = cache_key_fingerprint(_irls_sweep, *args, statics=statics)
        with use_mesh(virtual_mesh(4, 2)) as m:
            fp_mesh = cache_key_fingerprint(_irls_sweep, *args, statics=statics)
            monkeypatch.setattr(m, "world_size", 16)
            fp_pod = cache_key_fingerprint(_irls_sweep, *args, statics=statics)
        assert len({fp_none, fp_mesh, fp_pod}) == 3

    def test_plan_fingerprint_differs_by_topology(self, monkeypatch):
        import transmogrifai_tpu_torch as T
        from transmogrifai_tpu_torch.types import Real, RealNN
        from transmogrifai_tpu_torch.workflow.plan import plan_for_features

        rng = np.random.default_rng(0)
        cols = {"x0": rng.normal(size=64).tolist(), "x1": rng.normal(size=64).tolist(),
                "label": (rng.random(64) < 0.5).astype(float).tolist()}
        ds = T.Dataset.from_features(cols, {"x0": Real, "x1": Real, "label": RealNN})
        label = T.FeatureBuilder.of("label", RealNN).extract_field().as_response()
        vec = T.transmogrify([T.FeatureBuilder.of(k, Real).extract_field().as_predictor()
                              for k in ("x0", "x1")])
        model = T.Workflow().set_input_dataset(ds).set_result_features(label, vec) \
            .train(device="cpu")

        def fp():
            plan = plan_for_features(ds, model.result_features, model.fitted, CPU)
            return plan.prefix_fingerprint(environment=True)

        fp_none = fp()
        with use_mesh(virtual_mesh(4, 2)) as m:
            fp_mesh = fp()
            monkeypatch.setattr(m, "world_size", 16)
            fp_pod = fp()
        assert len({fp_none, fp_mesh, fp_pod}) == 3
        assert fp() == fp_none   # the unmeshed fingerprint is unchanged

    def test_manifest_environment_carries_the_token(self):
        import json

        from transmogrifai_tpu_torch.deploy.bundle import environment_provenance
        from transmogrifai_tpu_torch.deploy.store import artifact_key

        assert environment_provenance(CPU)["meshToken"] == "null"
        with use_mesh(virtual_mesh(4, 2)):
            env = environment_provenance(CPU)
            assert json.loads(env["meshToken"]) == [["data", "model"], [4, 2], 8, 8, None]
            meshed = artifact_key("fp", 8, kernel_token="k")
        assert meshed != artifact_key("fp", 8, kernel_token="k")

    def test_sweep_journal_key_carries_the_token(self):
        from transmogrifai_tpu_torch.workflow import resilience

        args = ("LogisticRegression", [{"reg_param": 0.1}], (3, 42, False), "auPR", "d")
        k_none = resilience.sweep_block_key(*args, None)
        with use_mesh(virtual_mesh(4, 2)):
            k_mesh = resilience.sweep_block_key(*args, mesh_token())
            assert resilience.dp_size(current_mesh()) == 4
        assert k_none != k_mesh and resilience.dp_size(None) == 1


class TestChunkTileMeshDivisibility:
    @pytest.mark.parametrize("mesh, n, tile", [
        (None, 8192, 8192), ((4, 2), 8192, 8192), ((4, 2), 101, 104),
        ((8, 1), 8192, 8192), ((2, 1), 101, 102)])
    def test_mesh_aligned_tile(self, mesh, n, tile):
        from transmogrifai_tpu_torch.workflow.plan import mesh_aligned_tile

        if mesh is None:
            assert mesh_aligned_tile(n) == tile
        else:
            with use_mesh(virtual_mesh(*mesh)):
                assert mesh_aligned_tile(n) == tile


class TestStaticScalabilityGate:
    """TM608 fires on a program whose collective volume scales with the rows
    and stays quiet on the fixed per-rank form; TM609 flags replicated
    operands over the per-host share; TM603 a collective in a plan validated
    as single-host.  Traced under the reference's 4 x 2 layout (a virtual
    mesh: meta operands, no processes)."""

    @staticmethod
    def _specs(buckets, d=8):
        return [(b, [((b, d), "float32"), ((d,), "float32")]) for b in buckets]

    def test_tm608_fires_on_rows_proportional_collectives(self):
        from transmogrifai_tpu_torch.checkers.plancheck import (analyze_program,
                                                                cost_diagnostics)

        def seeded_bad(x, w):
            # every rank's scores gathered to every row: a per-step
            # all-gather of the whole row block
            scores = M.gather_rows(x @ w, 4 * x.shape[0])
            return scores.sum()

        def fixed(x, w):
            return M.reduce_rows((x @ w).sum())   # the sum carries a scalar

        with use_mesh(virtual_mesh(4, 2)):
            r_bad = analyze_program(seeded_bad, self._specs((1024, 8192)),
                                    label="seeded-bad")
            r_fix = analyze_program(fixed, self._specs((1024, 8192)), label="fixed")
            codes_bad = {d_.code for d_ in cost_diagnostics(r_bad)}
            codes_fix = {d_.code for d_ in cost_diagnostics(r_fix)}
        assert "TM608" in codes_bad, codes_bad
        assert "TM608" not in codes_fix, codes_fix
        assert r_bad.collective_bytes_per_step > 0
        assert r_fix.buckets[-1].collective_bytes == 4   # one float32 scalar
        assert r_bad.collectives == {"all_gather": 1}

    def test_tm608_quiet_without_mesh(self):
        from transmogrifai_tpu_torch.checkers.plancheck import (analyze_program,
                                                                cost_diagnostics)

        def prog(x, w):
            return M.reduce_rows((x @ w).sum())

        r = analyze_program(prog, self._specs((1024, 8192)))
        assert r.mesh is None and r.collectives == {}
        assert all(d_.code not in ("TM603", "TM608", "TM609")
                   for d_ in cost_diagnostics(r, hbm_budget=1.0, single_host=True))

    @pytest.mark.parametrize("wrapped", [False, True], ids=["plain", "partial"])
    def test_tm609_fires_on_replicated_operands_over_share(self, wrapped):
        """A host constant copied in, in the program itself or in a wrapper
        around it (the reference's jit-wrapped case)."""
        from transmogrifai_tpu_torch.checkers.plancheck import (analyze_program,
                                                                cost_diagnostics)

        baked = torch.ones((512, 512))  # 1 MiB host constant

        def prog(x, w):
            return (x[:, :1] * baked.to(x.device).sum()).sum() \
                + M.reduce_rows((x @ w).sum())

        fn = partial(prog) if wrapped else prog
        with use_mesh(virtual_mesh(4, 2)):
            r = analyze_program(fn, self._specs((1024,)))
            over = cost_diagnostics(r, hbm_budget=1024 * 1024)
            under = cost_diagnostics(r, hbm_budget=64 * 1024 * 1024)
        assert "TM609" in {d_.code for d_ in over}
        assert "TM609" not in {d_.code for d_ in under}
        assert r.replicated_bytes >= 512 * 512 * 4

    def test_sharded_sweep_program_passes_the_gate(self):
        """The real sharded IRLS sweep: its collectives carry (d)-sized sums,
        flat across the row ladder (no TM608)."""
        from transmogrifai_tpu_torch.checkers.plancheck import (analyze_program,
                                                                cost_diagnostics)
        from transmogrifai_tpu_torch.models.logistic import _irls_sweep

        k, g, d1 = 2, 3, 9

        def specs(b):
            return [((b, d1), "float32"), ((b,), "float32"), ((k, b), "float32"),
                    ((g,), "float32")]

        fn = partial(_irls_sweep, max_iter=3, has_intercept=True)
        with use_mesh(virtual_mesh(4, 2)):
            r = analyze_program(fn, [(b, specs(b)) for b in (1024, 8192)],
                                label="irls_sweep@4x2")
            codes = {d_.code for d_ in cost_diagnostics(r)}
            tm603 = {d_.code for d_ in cost_diagnostics(r, single_host=True)}
        assert "TM608" not in codes, codes
        assert "TM603" in tm603
        assert r.collectives["all_reduce"] > 0
        assert r.buckets[0].collective_bytes == r.buckets[1].collective_bytes > 0


class TestWideOneRank:
    """``parallel/wide.py`` on a one-rank mesh (the ring's arithmetic is
    the identity there; two ranks run in tests/test_torch_mesh_training.py)."""

    @pytest.fixture
    def data(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(256, 40)).astype(np.float32)
        y = (rng.random(256) > 0.5).astype(np.float32)
        return x, y

    def test_col_stats_match_numpy(self, data):
        x, y = data
        mesh = make_mesh()
        xs, d_valid = shard_cols(x, mesh)
        mean, var, xmin, xmax, corr = (v.numpy() for v in
                                       wide_col_stats(xs, torch.from_numpy(y), mesh,
                                                      d_valid))
        np.testing.assert_allclose(mean, x.mean(0), atol=1e-5)
        np.testing.assert_allclose(var, x.var(0), atol=1e-5)
        np.testing.assert_allclose(xmin, x.min(0))
        np.testing.assert_allclose(xmax, x.max(0))
        xc, yc = x - x.mean(0), y - y.mean()
        ref = (xc * yc[:, None]).mean(0) / (xc.std(0) * yc.std())
        np.testing.assert_allclose(corr, ref, atol=1e-4)

    def test_gram_and_full_corr_match_numpy(self, data):
        x, _ = data
        mesh = make_mesh()
        xs, d_valid = shard_cols(x, mesh)
        np.testing.assert_allclose(wide_gram_ring(xs, mesh).numpy(),
                                   x.T @ x / x.shape[0], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(wide_full_corr(xs, mesh, d_valid).numpy(),
                                   np.corrcoef(x.T), atol=1e-4)

    def test_one_card_corr_sums_its_gram_in_row_chunks(self, data, monkeypatch):
        """The checker's one-card product widens the centred block to
        float64 a chunk of rows at a time: any chunking gives the one
        product's matrix, which the ring's equals."""
        from transmogrifai_tpu_torch.checkers import sanity

        x, _ = data
        whole = sanity._device_full_corr(torch.from_numpy(x)).numpy()
        monkeypatch.setattr(sanity, "_GRAM_CHUNK_ROWS", 7)
        chunked = sanity._device_full_corr(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(chunked, whole, rtol=0, atol=1e-6)
        np.testing.assert_allclose(whole, np.corrcoef(x.astype(np.float64).T),
                                   atol=1e-5)
        mesh = make_mesh()
        xs, d_valid = shard_cols(x, mesh)
        np.testing.assert_allclose(wide_full_corr(xs, mesh, d_valid).numpy(), whole,
                                   rtol=0, atol=1e-6)

    def test_col_sharding_splits_columns_over_data(self):
        from transmogrifai_tpu_torch.parallel.wide import col_sharding

        assert col_sharding(virtual_mesh(4, 2)) == (None, "data")

    @pytest.mark.parametrize("d, mult, padded", [(40, 8, 40), (37, 8, 40)])
    def test_pad_cols(self, d, mult, padded):
        x = np.ones((4, d), np.float32)
        p, d_valid = pad_cols(x, mult)
        assert p.shape == (4, padded) and d_valid == d
        assert (p[:, d:] == 0).all()
