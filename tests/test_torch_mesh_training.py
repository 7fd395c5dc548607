"""Data- and model-parallel training over a mesh of CPU processes (gloo).

The reference's meshed tests (``tests/test_use_mesh.py``,
``tests/test_multihost.py``, ``tests/test_distributed.py``'s two-process
run) ported to the port's one-process-per-rank mesh.  One spawn per mesh
shape, (2, 1), (1, 2) and (2, 2) over 217 rows (uneven spans), runs every
scenario of this file (``tests/torch_mesh_worker.py``); each rank runs on
one thread under a 60 s group timeout, and the spawn under a wall limit that
kills every rank.

Rules, per the reference's meshed sweeps (which fail on the reference's own
CPU backend, so the meshed port is held to the UNMESHED reference):

- every rank ends with a bitwise-equal fitted model and summary;
- the meshed train equals the port's unmeshed train: RF CV metrics bitwise
  (int32 histogram sums are exact), GBT within 1e-3, LR CV within 1e-4, the
  same winner and scores within 1e-5, no failed family;
- it equals the JAX package's unmeshed train within the same rules (the
  forest fed the reference's Poisson draws through ``draw_bootstrap``);
- the meshed training flush is bitwise the unmeshed one and its plan
  fingerprint differs; a chunked epoch under the (2, 2) mesh is bitwise the
  in-memory transform;
- two processes' column statistics, ring correlation and GBT fit equal one
  process's (the reference's xfail, run for real);
- the SanityChecker under the (2, 1) mesh, Pearson (rows sharded) and
  Spearman (every row on every rank), keeps the slots and reads the
  statistics the unmeshed port and the JAX package do;
- the mesh token keys the sweep journal, the deploy manifest and the
  programs' cache keys.
"""

import numpy as np
import pytest
import torch

import jax

from torch_mesh_worker import (CHECKER_PARAMS, checker_summary, fit_checker,
                               run_mesh, selector_pipeline, train_selector)
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.models import trees as TT
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device

N_ROWS = 217
#: the reference's bitwise-CV selector table (LinearSVC + RF + GBT)
N_SVC = 211
SHAPES = [(2, 1), (1, 2), (2, 2)]
EXTRA = {(2, 1): ["stats", "checker", "keys"], (2, 2): ["flush", "chunked", "svc"]}
CPU = torch.device("cpu")
#: the forests' draw keys: seed 42 + 1, 6 (5) trees, every row, rate 1.0
RF_DRAW = (43, 6, N_ROWS)
RF_DRAW_SVC = (43, 5, N_SVC)


def selector_cols(n=N_ROWS, seed=11) -> dict:
    """The reference's 4x2 selector table (tests/test_use_mesh.py)."""
    rng = np.random.default_rng(seed)
    cols = {f"x{i}": rng.normal(size=n).tolist() for i in range(4)}
    z = sum((i + 1) * 0.5 * np.asarray(cols[f"x{i}"]) for i in range(4))
    cols["label"] = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(float).tolist()
    return cols


def svc_cols(n=N_SVC, seed=23) -> dict:
    """The reference's bitwise-CV table (tests/test_use_mesh.py)."""
    rng = np.random.default_rng(seed)
    cols = {f"x{i}": rng.normal(size=n).tolist() for i in range(4)}
    z = sum((i + 1) * 0.4 * np.asarray(cols[f"x{i}"]) for i in range(4))
    cols["label"] = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(float).tolist()
    return cols


def stats_cols() -> dict:
    """The reference's two-process table (tests/distributed_worker.py)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1024, 8)).astype(np.float32)
    y = (rng.random(1024) < 0.5).astype(np.float32)
    binned = rng.integers(0, 9, size=(1024, 8)).astype(np.int32)
    return {"x": x, "y": y, "binned": binned}


def checker_block(n=N_ROWS) -> dict:
    """The wide pipeline's transmogrified vector at a cut (reals, buckets,
    picklists and binaries, so the checker's contingencies run) with its
    label and metadata, made from a seed."""
    from torch_wide_data import make_data, wide_pipeline
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    cols, schema = make_data(n, seed=3, n_real=6, n_bucketized=3, n_pick=4,
                             n_levels=30, n_binary=2)
    tf = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    _, _, chk, _ = wide_pipeline(T, tf, schema)
    vec = chk.inputs[1]
    ds = T.Dataset.from_features(cols, tf)
    with use_device("cpu"):
        model = T.Workflow().set_input_dataset(ds).set_result_features(vec) \
            .train(device="cpu")
        col = transform_dag(ds, [vec], model.fitted, "cpu")[vec.name]
    return {"y": np.asarray(cols["label"], np.float64),
            "x": np.asarray(col.data, np.float32), "meta": col.meta.to_dict()}


def reference_draws() -> dict:
    out = {}
    for key in (RF_DRAW, RF_DRAW_SVC):
        seed, trees, n = key
        d = jax.random.poisson(jax.random.PRNGKey(seed), 1.0, (trees, n))
        out[key] = np.asarray(d).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def draws():
    return reference_draws()


def _unmeshed_train(draws, cols, first="lr"):
    """The port's unmeshed train in this process, on the same draws."""
    import torch_mesh_worker as W

    saved = TT.draw_bootstrap
    W.patch_bootstrap(draws)
    try:
        with use_device("cpu"):
            return train_selector(T, cols, CPU, first=first)
    finally:
        TT.draw_bootstrap = saved


@pytest.fixture(scope="module")
def unmeshed(draws):
    return _unmeshed_train(draws, selector_cols())


@pytest.fixture(scope="module")
def svc_unmeshed(draws):
    return _unmeshed_train(draws, svc_cols(), first="svc")


def jax_dataset(cols):
    import transmogrifai_tpu as J
    from transmogrifai_tpu.types import Real, RealNN

    names = sorted(k for k in cols if k != "label")
    return J.Dataset.from_features(cols, {**{k: Real for k in names}, "label": RealNN})


@pytest.fixture(scope="module")
def jax_unmeshed(draws):
    """The JAX package's unmeshed train of the same pipeline."""
    import transmogrifai_tpu as J
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.models.trees import (
        GradientBoostedTreesClassifier, RandomForestClassifier)
    from transmogrifai_tpu.types import Real, RealNN

    cols = selector_cols()
    names = sorted(k for k in cols if k != "label")
    ds = jax_dataset(cols)
    label = J.FeatureBuilder.of("label", RealNN).extract_field().as_response()
    fs = [J.FeatureBuilder.of(k, Real).extract_field().as_predictor() for k in names]
    checked = label.sanity_check(J.transmogrify(fs))
    sel = J.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2,
        models=[(LogisticRegression(),
                 [{"reg_param": r} for r in (0.0, 0.01, 0.1, 1.0)]),
                (RandomForestClassifier(num_trees=6, max_depth=3), [{}]),
                (GradientBoostedTreesClassifier(num_rounds=4, max_depth=2), [{}])])
    pred = label.transform_with(sel, checked)
    model = J.Workflow().set_input_dataset(ds).set_result_features(label, pred).train()
    s = model.summary()
    return {"cv": {(e.model_name, tuple(sorted(e.grid.items()))):
                   [float(v) for v in e.metric_values]
                   for e in s.validation_results},
            "winner": s.best_model_name, "failed": list(s.failed_models),
            "scores": np.asarray(model.score(ds)[pred.name].score, np.float64)}


_RUNS: dict = {}


@pytest.fixture(scope="module")
def meshed(draws, tmp_path_factory):
    """shape -> every rank's results of that shape's one spawn."""
    def get(shape):
        if shape not in _RUNS:
            spec = {"shape": shape, "cols": selector_cols(),
                    "svc_cols": svc_cols(),
                    "stats_cols": stats_cols(), "draws": draws,
                    "checker_block": checker_block(),
                    "scenarios": ["selector"] + EXTRA.get(shape, [])}
            tmp = str(tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}"))
            _RUNS[shape] = run_mesh(shape[0] * shape[1], spec, tmp)
        return _RUNS[shape]
    return get


def _family(key) -> str:
    return key[0]


def assert_cv_within_rules(got: dict, ref: dict) -> None:
    """RF bitwise, GBT within 1e-3, LR within 1e-4 (per fold)."""
    assert set(got) == set(ref)
    for key in ref:
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        fam = _family(key)
        if fam == "RandomForestClassifier":
            assert got[key] == ref[key], (key, got[key], ref[key])
        elif fam == "GradientBoostedTreesClassifier":
            np.testing.assert_allclose(a, b, atol=1e-3, err_msg=str(key))
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=str(key))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
class TestMeshedSelector:
    def test_every_rank_holds_one_model(self, meshed, shape):
        ranks = meshed(shape)
        first = ranks[0]["selector"]
        assert sorted(r["coord"] for r in ranks) == sorted(
            (i, j) for i in range(shape[0]) for j in range(shape[1]))
        for r in ranks[1:]:
            got = r["selector"]
            assert got["digest"] == first["digest"]
            assert got["cv"] == first["cv"]
            assert got["winner"] == first["winner"]
            np.testing.assert_array_equal(got["scores"], first["scores"])

    def test_equals_the_unmeshed_port(self, meshed, unmeshed, shape):
        got = meshed(shape)[0]["selector"]
        assert got["failed"] == [] and unmeshed["failed"] == []
        assert got["winner"] == unmeshed["winner"]
        assert got["kept"] == unmeshed["kept"]
        assert_cv_within_rules(got["cv"], unmeshed["cv"])
        np.testing.assert_allclose(got["scores"], unmeshed["scores"], atol=1e-5)
        for k, v in unmeshed["arrays"].items():
            np.testing.assert_allclose(got["arrays"][k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)

    def test_equals_the_unmeshed_reference(self, meshed, jax_unmeshed, shape):
        got = meshed(shape)[0]["selector"]
        assert jax_unmeshed["failed"] == [] and got["failed"] == []
        assert got["winner"] == jax_unmeshed["winner"]
        assert_cv_within_rules(got["cv"], jax_unmeshed["cv"])
        np.testing.assert_allclose(got["scores"], jax_unmeshed["scores"], atol=1e-5)

    def test_rank0_saved_model_scores_in_the_jax_package(self, meshed, unmeshed,
                                                          shape):
        """A mesh changes no saved format: rank 0's saved model (no other
        rank writes) loads in the JAX package and scores as the port's
        unmeshed model does."""
        from transmogrifai_tpu.models import logistic, trees  # noqa: F401
        from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel

        ranks = meshed(shape)
        assert [r["selector"]["saved"] is not None for r in ranks] == \
            [True] + [False] * (len(ranks) - 1)
        got = ranks[0]["selector"]
        scored = JModel.load(got["saved"]).score(jax_dataset(selector_cols()))
        np.testing.assert_allclose(np.asarray(scored[got["pred_name"]].score, np.float64),
                                   unmeshed["scores"], atol=1e-5)

    def test_collectives_cross_the_mesh(self, meshed, shape):
        counts = meshed(shape)[0]["collectives"]["selector"]
        calls = sum(c["calls"] for by in counts.values() for c in by.values())
        assert calls > 0 and set(be for by in counts.values() for be in by) == {"gloo"}
        if shape[0] > 1:   # rows split: reductions and the metric gathers
            assert counts["all_reduce"]["gloo"]["calls"] > 10
            assert counts["all_gather"]["gloo"]["calls"] > 0


class TestMeshedSvcSelector:
    """The reference's test_svc_rf_gbt_cv_metrics_bitwise_under_4x2_mesh
    under the (2, 2) mesh: the CV metrics read scores gathered back in the
    unmeshed row order.  Held to the unmeshed port within the family rules
    (GBT's float sums take another order under a row split): RF bitwise,
    GBT within 1e-3, LinearSVC within 1e-4; every rank alike."""

    def test_cv_metrics_within_the_rules(self, meshed, svc_unmeshed):
        ranks = meshed((2, 2))
        got = ranks[0]["svc"]
        assert got["failed"] == [] and svc_unmeshed["failed"] == []
        assert got["winner"] == svc_unmeshed["winner"]
        assert_cv_within_rules(got["cv"], svc_unmeshed["cv"])
        for r in ranks[1:]:
            assert r["svc"]["cv"] == got["cv"] and r["svc"]["digest"] == got["digest"]


class TestMeshedFlush:
    """The reference's TestShardedSweepParity.test_fused_prefix_runs_sharded
    and TestChunkTileMeshDivisibility, under the (2, 2) mesh."""

    def test_fused_prefix_bitwise_and_fingerprint_keyed(self, meshed):
        for r in meshed((2, 2)):
            f = r["flush"]
            np.testing.assert_array_equal(f["meshed"], f["plain"])
            assert f["fp_mesh"] != f["fp_plain"]
        assert len({r["flush"]["fp_mesh"] for r in meshed((2, 2))}) == 1
        # each rank copies up its span only: the data ranks' bytes add up
        # to the unmeshed flush's
        by_data = {r["coord"][0]: r["flush"]["h2d_mesh"] for r in meshed((2, 2))}
        assert sum(by_data.values()) == meshed((2, 2))[0]["flush"]["h2d_plain"]
        assert all(0 < b < meshed((2, 2))[0]["flush"]["h2d_plain"]
                   for b in by_data.values())

    def test_chunked_epoch_bitwise_under_2x2(self, meshed):
        for r in meshed((2, 2)):
            c = r["chunked"]
            assert c["tile"] == 102            # 101 rounded up to the data axis
            for epoch in c["epochs"]:
                np.testing.assert_array_equal(epoch, c["in_mem"])
            np.testing.assert_array_equal(c["in_mem"], r["flush"]["plain"])


class TestTwoProcesses:
    """The reference's two-process run (test_distributed.py's xfail: its CPU
    backend has no multiprocess collectives), over gloo: each rank holds its
    span of 1024 rows."""

    def test_column_stats_match_one_process(self, meshed):
        for r in meshed((2, 1)):
            s = r["stats"]
            for a, b, name in zip(s["meshed"], s["full"],
                                  ("mean", "var", "min", "max", "corr")):
                np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
            for a, b in zip(s["col"], s["full"]):
                np.testing.assert_allclose(a, b, atol=1e-5)
        spans = sorted(r["stats"]["span"] for r in meshed((2, 1)))
        assert spans == [(0, 512), (512, 1024)]
        assert [r["stats"]["broadcast"] for r in meshed((2, 1))] == [0.0, 0.0]

    def test_ring_correlation_matches_the_gram(self, meshed):
        for r in meshed((2, 1)):
            s = r["stats"]
            np.testing.assert_allclose(s["ring"], s["gram_full"], atol=1e-5)
            assert s["ring7"].shape == (7, 7)       # uneven columns, padded
            np.testing.assert_allclose(s["ring7"], s["gram7"], atol=1e-5)
            np.testing.assert_allclose(s["gram_mesh"], s["gram_full"], atol=1e-5)

    def test_gbt_fit_matches_one_process(self, meshed):
        for r in meshed((2, 1)):
            (plain, msum_plain), (mesh, msum_mesh) = r["stats"]["gbt_plain"], \
                r["stats"]["gbt_mesh"]
            for k in ("feat", "thr_bin", "is_leaf", "miss_left"):
                np.testing.assert_array_equal(mesh[k], plain[k], err_msg=k)
            np.testing.assert_allclose(mesh["value"], plain["value"], atol=1e-4)
            np.testing.assert_allclose(msum_mesh, msum_plain, rtol=1e-3)

    @pytest.mark.parametrize("fit", ["lr_irls", "lr_fista", "svc", "ridge"])
    def test_linear_fit_matches_one_process(self, meshed, fit):
        """The final fits' row sums cross the ranks before each solve or
        step: the coefficients (and intercept) equal one process's within
        1e-6."""
        for r in meshed((2, 1)):
            s = r["stats"]
            np.testing.assert_allclose(s["linear_mesh"][fit], s["linear_plain"][fit],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("params", sorted(CHECKER_PARAMS))
class TestMeshedChecker:
    """The SanityChecker under the (2, 1) mesh.  Pearson places each rank's
    rows and sums its moments, correlations and contingencies over the
    ``data`` group; Spearman's ranks need every row, so each rank holds the
    whole block and nothing crosses the ranks.  Either way the kept slots
    and drop reasons are the unmeshed port's and the JAX package's, and the
    statistics lie within 1e-5 of both (Spearman's are the unmeshed port's
    bit for bit)."""

    @staticmethod
    def _close(got: dict, want: dict, exact: bool) -> None:
        assert got["kept"] == want["kept"] and got["dropped"] == want["dropped"]
        assert got["corr_idx"] == want["corr_idx"]
        for a, b in zip(got["stats"], want["stats"]):
            assert a["name"] == b["name"]
            for k in ("mean", "variance", "min", "max", "corr_label", "cramers_v",
                      "max_rule_confidence", "support"):
                x, y = a[k], b[k]
                if x is None or y is None:
                    assert x is None and y is None, (a["name"], k)
                elif exact:
                    assert np.array_equal(x, y, equal_nan=True), (a["name"], k, x, y)
                else:
                    np.testing.assert_allclose(x, y, rtol=0, atol=1e-5,
                                               err_msg=f"{a['name']} {k}")
        if want["corr"] is None:
            assert got["corr"] is None
        elif exact:
            np.testing.assert_array_equal(got["corr"], want["corr"])
        else:
            np.testing.assert_allclose(got["corr"], np.asarray(want["corr"]),
                                       rtol=0, atol=1e-5)

    def test_equals_the_unmeshed_port_and_reference(self, meshed, params):
        from transmogrifai_tpu.checkers import sanity as JS
        from transmogrifai_tpu.data.dataset import Column as JCol
        from transmogrifai_tpu.data.dataset import Dataset as JDs
        from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
        from transmogrifai_tpu.types import RealNN as JRealNN
        from transmogrifai_tpu.utils.vector_metadata import VectorMetadata as JMeta

        block = checker_block()
        with use_device("cpu"):
            plain = checker_summary(fit_checker(block, CHECKER_PARAMS[params], CPU))
        jl = JFB.RealNN("label").extract_field().as_response()
        jv = JFB.OPVector("v").extract_field().as_predictor()
        jc = JS.SanityChecker(**CHECKER_PARAMS[params])
        jl.transform_with(jc, jv)
        jds = JDs({"label": JCol.from_values(JRealNN, block["y"].tolist()),
                   "v": JCol.vector(block["x"], JMeta.from_dict(block["meta"]))})
        jm = jc.fit(jds)
        ref = {"kept": list(jm.kept_indices), "dropped": dict(jm.summary.dropped),
               "stats": [dict(vars(c)) for c in jm.summary.stats],
               "corr": jm.summary.correlations_feature,
               "corr_idx": list(jm.summary.correlation_indices)}
        if params == "spearman_max":
            assert plain["dropped"]       # the threshold drops by correlation
        for r in meshed((2, 1)):
            got = r["checker"][params]
            self._close(got, plain, exact=params != "pearson")
            self._close(got, ref, exact=False)


class TestMeshTokens:
    def test_journal_key_carries_the_token(self, meshed):
        for r in meshed((2, 1)):
            k = r["keys"]
            assert k["token"] == (("data", "model"), (2, 1), 2, 2, "gloo")
            assert k["journal_keys"] == [k["expected_key"]]
            assert k["expected_key"] != k["unmeshed_key"]

    def test_manifest_and_program_keys_carry_the_token(self, meshed):
        import json

        for r in meshed((2, 1)):
            k = r["keys"]
            assert k["env_plain"] == "null"
            assert json.loads(k["env_mesh"]) == [["data", "model"], [2, 1], 2, 2, "gloo"]
            assert k["fp_mesh"] != k["fp_plain"]

    def test_meshed_sweep_scores_match_every_rank(self, meshed):
        a, b = (r["keys"]["scores"] for r in meshed((2, 1)))
        np.testing.assert_array_equal(a, b)


def test_selector_pipeline_builds_in_one_process():
    """The worker's pipeline is the reference's (tests/test_use_mesh.py)."""
    ds, label, checked, pred = selector_pipeline(T, selector_cols())
    assert ds.n_rows == N_ROWS
    assert pred.origin_stage.models[0][1] == [{"reg_param": r}
                                              for r in (0.0, 0.01, 0.1, 1.0)]
