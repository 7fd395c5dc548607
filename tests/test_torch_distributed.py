"""Process-group bootstrap and the global mesh (``parallel/distributed.py``)
in one process: the reference's ``tests/test_distributed.py`` and
``tests/test_multihost.py::TestGlobalRowAssembly`` with the import swapped.

The reference mocks ``jax.process_index`` / ``jax.process_count``; the port
mocks its own two seams (``distributed._rank`` and ``device_count``).  The
true multi-process runs (column statistics, the ring and a GBT fit across
two processes) are ``tests/test_torch_mesh_training.py``'s; this file
spawns two gloo ranks once, to see that a rank that fails fails the other.
"""

import logging

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.parallel import distributed as D
from transmogrifai_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, make_mesh,
                                                   use_mesh)
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device

MARKERS = ("TPU_WORKER_HOSTNAMES", "SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE",
           "TPU_WORKER_ID", "CLOUD_TPU_TASK_ID", "MEGASCALE_COORDINATOR_ADDRESS",
           "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in MARKERS:
        monkeypatch.delenv(var, raising=False)
    with use_device("cpu"):
        yield


def mock_processes(monkeypatch, count, index=0):
    monkeypatch.setattr(D, "device_count", lambda: count)
    monkeypatch.setattr(D, "_rank", lambda: index)


class TestDistributed:
    def test_initialize_single_process_noop(self):
        D.initialize()  # must not raise on one process
        assert not D.is_initialized()

    def test_process_info(self):
        info = D.process_info()
        assert info == {"processId": 0, "processCount": 1, "localDevices": 1,
                        "globalDevices": 1, "platform": "cpu"}

    def test_global_mesh_axes(self):
        mesh = D.global_mesh()
        assert mesh.shape[DATA_AXIS] == 1 and mesh.shape[MODEL_AXIS] == 1
        with pytest.raises(ValueError, match="must divide"):
            D.global_mesh(n_model=2)

    def test_host_local_rows_partition(self):
        s = D.host_local_rows(100)
        assert (s.start, s.stop) == (0, 100)  # one process owns every row

    def test_host_local_rows_multiprocess_math(self, monkeypatch):
        spans = []
        for pid in range(3):
            mock_processes(monkeypatch, 3, pid)
            s = D.host_local_rows(10)
            spans.append((s.start, s.stop))
        assert spans == [(0, 4), (4, 8), (8, 10)]
        assert sum(b - a for a, b in spans) == 10


class TestFailHardOnMultiWorkerMarkers:
    """A bootstrap under markers that imply several workers raises rather
    than run N duplicate single-process trains; one worker warns."""

    def test_implied_worker_count(self, monkeypatch):
        assert D._implied_worker_count() == 1
        monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host1,host2,host3")
        assert D._implied_worker_count() == 3
        monkeypatch.setenv("SLURM_JOB_NUM_NODES", "5")
        assert D._implied_worker_count() == 5
        monkeypatch.setenv("WORLD_SIZE", "8")       # torchrun's
        assert D._implied_worker_count() == 8

    @pytest.mark.parametrize("var, value, count", [
        ("TPU_WORKER_ID", "0", 1), ("TPU_WORKER_ID", "3", 4),
        ("CLOUD_TPU_TASK_ID", "2", 3),
        ("MEGASCALE_COORDINATOR_ADDRESS", "10.0.0.1:8476", 2)])
    def test_implied_worker_count_index_and_megascale_markers(self, monkeypatch,
                                                              var, value, count):
        monkeypatch.setenv(var, value)
        assert D._implied_worker_count() == count

    def test_bootstrap_failure_raises_when_multiworker(self, monkeypatch):
        monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b")
        with pytest.raises(RuntimeError, match="imply 2 workers"):
            D.initialize()
        monkeypatch.delenv("TPU_WORKER_HOSTNAMES")
        monkeypatch.setenv("WORLD_SIZE", "4")        # no MASTER_ADDR / RANK
        with pytest.raises(RuntimeError, match="imply 4 workers"):
            D.initialize()
        assert not D.is_initialized()

    def test_bootstrap_failure_warns_when_single(self, monkeypatch, caplog):
        monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "onlyhost")
        with caplog.at_level(logging.WARNING):
            D.initialize()  # must not raise for one worker
        assert "single-process run" in caplog.text
        assert not D.is_initialized()


class TestGlobalRowAssembly:
    """The sharded-ingest seam: each process decodes its own row span and
    the spans compose to the global table."""

    @pytest.mark.parametrize("n, pc", [(10, 3), (8192, 4), (7, 8), (0, 2), (5, 1)])
    def test_spans_partition_exactly(self, n, pc):
        spans = D.host_row_spans(n, pc)
        assert len(spans) == pc
        covered = [i for s in spans for i in range(s.start, s.stop)]
        assert covered == list(range(n))

    def test_single_process_assembly_matches_direct_placement(self):
        rng = np.random.default_rng(3)
        x = rng.normal(size=(64, 4)).astype(np.float32)
        with use_mesh(make_mesh()):
            g = D.global_row_array(x, n_global_rows=64)
        np.testing.assert_array_equal(g.numpy(), x)
        np.testing.assert_array_equal(D.global_row_array(x).numpy(), x)

    def test_single_process_partial_block_refused(self):
        x = np.zeros((10, 2), np.float32)
        with use_mesh(make_mesh()):
            with pytest.raises(ValueError, match="full 16 rows"):
                D.global_row_array(x[:5], n_global_rows=16)

    def test_mocked_two_process_span_decoding(self, monkeypatch):
        n = 100
        rng = np.random.default_rng(0)
        x = rng.normal(size=(n, 3)).astype(np.float32)
        blocks = []
        for pid in range(2):
            mock_processes(monkeypatch, 2, pid)
            blocks.append(x[D.host_local_rows(n)])
        assert blocks[0].shape == (50, 3) and blocks[1].shape == (50, 3)
        np.testing.assert_array_equal(np.vstack(blocks), x)
        assert [(s.start, s.stop) for s in D.host_row_spans(n)] == [(0, 50), (50, 100)]

    def test_mocked_two_process_block_refused(self, monkeypatch):
        mock_processes(monkeypatch, 2, 0)
        mesh = make_mesh()
        with pytest.raises(ValueError, match=r"rows \[0, 50\)"):
            D.global_row_array(np.zeros((49, 3), np.float32), n_global_rows=100,
                               mesh=mesh)

    def test_span_contributions_compose_to_global_fit(self):
        """The reductions a meshed fit crosses the data group with decompose
        over spans: integer-valued inputs make the float sums exact, so the
        per-span Gram and moments sum to the one-process statistics and the
        closed-form fit from them is the global fit."""
        n, d = 96, 4
        rng = np.random.default_rng(7)
        x = rng.integers(-3, 4, size=(n, d)).astype(np.float64)
        y = rng.integers(0, 2, size=n).astype(np.float64)
        w = np.ones(n)
        spans = D.host_row_spans(n, 2)
        gram = sum((w[s, None] * x[s]).T @ x[s] for s in spans)
        xty = sum(x[s].T @ (w[s] * y[s]) for s in spans)
        np.testing.assert_array_equal(gram, (w[:, None] * x).T @ x)
        np.testing.assert_array_equal(xty, x.T @ (w * y))
        beta_spans = np.linalg.solve(gram + np.eye(d), xty)
        beta_global = np.linalg.solve((w[:, None] * x).T @ x + np.eye(d), x.T @ (w * y))
        np.testing.assert_allclose(beta_spans, beta_global, rtol=1e-12)
        total = sum(x[s].sum(axis=0) for s in spans)
        sq = sum((x[s] ** 2).sum(axis=0) for s in spans)
        np.testing.assert_allclose(sq / n - (total / n) ** 2, x.var(axis=0), rtol=1e-12)

    def test_global_mesh_refuses_host_crossing_model_axis(self, monkeypatch, caplog):
        mock_processes(monkeypatch, 8)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")   # 2 hosts x 4 ranks
        with pytest.raises(ValueError, match="span hosts"):
            D.global_mesh(n_model=8)
        # non-strict downgrades to a warning; this one process then cannot
        # make an 8-rank mesh
        with caplog.at_level(logging.WARNING), \
                pytest.raises(ValueError, match="process group"):
            D.global_mesh(n_model=8, strict_topology=False)
        assert "strict_topology=False" in caplog.text

    def test_global_mesh_explicit_devices_checks_process_groups(self):
        class _Dev:
            def __init__(self, pidx):
                self.process_index = pidx

        two_hosts = [_Dev(i // 4) for i in range(8)]  # 2 processes x 4 devices
        with pytest.raises(ValueError, match="span hosts"):
            D.global_mesh(n_model=8, devices=two_hosts)
        with pytest.raises(ValueError, match="process group"):
            D.global_mesh(n_model=4, devices=two_hosts)   # groups fit a host

    def test_mesh_topology_provenance(self):
        with use_mesh(make_mesh()):
            topo = D.mesh_topology()
        assert topo["processCount"] == 1 and topo["platform"] == "cpu"
        assert topo["meshShape"] == {"data": 1, "model": 1}
        assert (topo["dp"], topo["mp"]) == (1, 1)
        assert "meshShape" not in D.mesh_topology()

    def test_make_mesh_without_a_group_refuses_several_ranks(self):
        with pytest.raises(ValueError, match="process group"):
            make_mesh(n_data=2, devices=[0, 1])
        assert torch.device(make_mesh().device).type == "cpu"


class TestRankFailure:
    """No fallback: a rank that dies makes the other's next collective fail
    (the peer gone, or at the latest the group timeout), with a non-zero
    exit, instead of hanging or going on alone."""

    GROUP_TIMEOUT_S = 10.0

    def test_a_dead_rank_fails_the_other(self, tmp_path):
        """The ranks join from torchrun's variables (``MASTER_ADDR`` on
        localhost, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as a user's
        job does; then rank 1 dies."""
        import socket
        import sys

        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from torch_mesh_worker import run_ranks

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ranks = run_ranks(2, {"shape": (2, 1), "scenarios": ["die"], "die_rank": 1,
                              "master_port": port},
                          str(tmp_path), wall_s=90.0,
                          group_timeout_s=self.GROUP_TIMEOUT_S)
        (rc0, t0, err0), (rc1, t1, _) = ranks
        assert rc1 == 3
        assert rc0 not in (0, None) and rc0 > 0, (rc0, err0)
        # the survivor ends within the group timeout of the death (the
        # start-up before it is the same for both ranks)
        assert t0 - t1 <= self.GROUP_TIMEOUT_S + 15.0, (t0, t1, err0)
