"""One rank of a mesh of CPU processes over gloo (the port only: no JAX).

``tests/test_torch_mesh_training.py`` starts one of these per rank with
:func:`run_mesh`; each joins the group through the port's
``distributed.initialize`` with a ``file://`` rendezvous (or, when the spec
names a ``master_port``, from torchrun's environment variables with no
arguments), builds the mesh,
runs the scenarios the spec names and pickles what it saw.  Each runs on one
thread (``OMP_NUM_THREADS=1``) under the group timeout the spec gives, and
the parent kills every rank past its wall limit.

    python tests/torch_mesh_worker.py <rank> <world> <init_file> <spec.pkl> <out.pkl>
"""

from __future__ import annotations

import hashlib
import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

def _spawn(world: int, spec: dict, tmp_dir: str, group_timeout_s: float):
    """Start ``world`` ranks on ``spec``: (processes, their stderr files)."""
    spec_path = os.path.join(tmp_dir, "spec.pkl")
    with open(spec_path, "wb") as fh:
        pickle.dump(spec, fh)
    init = os.path.join(tmp_dir, "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               TMOG_GROUP_TIMEOUT_S=str(group_timeout_s), PYTHONPATH=REPO)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    procs, errs = [], []
    for r in range(world):
        err = open(os.path.join(tmp_dir, f"rank{r}.err"), "w+")
        errs.append(err)
        rank_env = env if "master_port" not in spec else dict(
            env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(spec["master_port"]),
            WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), init,
             spec_path, os.path.join(tmp_dir, f"rank{r}.pkl")],
            env=rank_env, stdout=subprocess.DEVNULL, stderr=err))
    return procs, errs


def run_ranks(world: int, spec: dict, tmp_dir: str, wall_s: float,
              group_timeout_s: float) -> list:
    """Start ``world`` ranks on ``spec`` and let each end on its own:
    [(exit code, seconds from the start, stderr tail)] by rank.  A rank
    still running past ``wall_s`` is killed (its code is then the kill's)."""
    t0 = time.monotonic()
    procs, errs = _spawn(world, spec, tmp_dir, group_timeout_s)
    ended = [None] * world
    try:
        while any(e is None for e in ended) and time.monotonic() - t0 < wall_s:
            for r, p in enumerate(procs):
                if ended[r] is None and p.poll() is not None:
                    ended[r] = time.monotonic() - t0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    out = []
    for r, (p, e) in enumerate(zip(procs, errs)):
        e.seek(0)
        out.append((p.returncode, ended[r] if ended[r] is not None else wall_s,
                    e.read()[-3000:]))
    return out


def run_mesh(world: int, spec: dict, tmp_dir: str, wall_s: float = 240.0,
             group_timeout_s: float = 60.0) -> list:
    """Start ``world`` ranks on ``spec`` and return each rank's result (a
    list by rank).  A rank that exits non-zero, or a run past ``wall_s``,
    kills every rank and raises with the ranks' stderr."""
    procs, errs = _spawn(world, spec, tmp_dir, group_timeout_s)
    deadline = time.monotonic() + wall_s
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks ran past {wall_s} s"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if failed is not None:
        tails = []
        for r, e in enumerate(errs):
            e.seek(0)
            tails.append(f"--- rank {r} ---\n" + e.read()[-3000:])
        raise RuntimeError(failed + "\n" + "\n".join(tails))
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


# ---------------------------------------------------------------------------
# the scenarios (either side: the parent runs them unmeshed for reference)
# ---------------------------------------------------------------------------

def selector_models(T, first: str = "lr") -> list:
    """The reference's meshed selectors (tests/test_use_mesh.py): ``lr`` is
    LR grid of 4, RF 6 x 3, GBT 4 x 2 (the two-dimensional mesh test);
    ``svc`` is LinearSVC grid of 2, RF 5 x 3, GBT 4 x 2 (the bitwise CV
    test)."""
    from transmogrifai_tpu_torch.models.trees import (
        GradientBoostedTreesClassifier, RandomForestClassifier)

    if first == "svc":
        head = [(T.LinearSVC(), [{"reg_param": r} for r in (0.01, 0.1)]),
                (RandomForestClassifier(num_trees=5, max_depth=3), [{}])]
    else:
        head = [(T.LogisticRegression(),
                 [{"reg_param": r} for r in (0.0, 0.01, 0.1, 1.0)]),
                (RandomForestClassifier(num_trees=6, max_depth=3), [{}])]
    return head + [(GradientBoostedTreesClassifier(num_rounds=4, max_depth=2), [{}])]


def selector_pipeline(T, cols: dict, folds: int = 2, first: str = "lr"):
    """Four reals -> transmogrify -> sanity check -> the selector of
    :func:`selector_models`, by ``folds``-fold CV.  Returns (dataset,
    label, checked, prediction)."""
    from transmogrifai_tpu_torch.types import Real, RealNN

    names = sorted(k for k in cols if k != "label")
    ds = T.Dataset.from_features(cols, {**{k: Real for k in names}, "label": RealNN})
    label = T.FeatureBuilder.of("label", RealNN).extract_field().as_response()
    fs = [T.FeatureBuilder.of(k, Real).extract_field().as_predictor() for k in names]
    checked = label.sanity_check(T.transmogrify(fs))
    sel = T.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=folds, models=selector_models(T, first))
    pred = label.transform_with(sel, checked)
    return ds, label, checked, pred


def model_arrays(model) -> dict:
    """The winner's fitted numbers: coefficients, or trees and edges."""
    inner = getattr(model, "model", model)
    out = {}
    for k, v in sorted(vars(inner).items()):
        if k == "trees":
            out.update({f"trees.{a}": b for a, b in sorted(v.items())})
        elif k in ("coef", "intercept", "edges", "base_score"):
            out[k] = v
    import numpy as np

    return {k: np.asarray(v) for k, v in out.items()}


def digest(arrays: dict) -> str:
    import numpy as np

    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(f"{k}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def train_selector(T, cols: dict, device, first: str = "lr",
                   save_to=None) -> dict:
    """Train the selector pipeline and read back what a comparison needs;
    ``save_to``: a directory to save the fitted model in."""
    import numpy as np

    ds, label, checked, pred = selector_pipeline(T, cols, first=first)
    model = T.Workflow().set_input_dataset(ds).set_result_features(label, pred) \
        .train(device=device)
    if save_to is not None:
        model.save(save_to)
    summary = model.summary()
    scored = model.score(ds, device=device)
    arrays = model_arrays(model.selector_model())
    return {
        "cv": {(e.model_name, tuple(sorted(e.grid.items()))):
               [float(v) for v in e.metric_values]
               for e in summary.validation_results},
        "winner": summary.best_model_name,
        "failed": list(summary.failed_models),
        "scores": np.asarray(scored[pred.name].score, np.float64),
        "kept": list(_checker(model).kept_indices),
        "arrays": arrays,
        "digest": digest(arrays),
        "pred_name": pred.name,
        "saved": save_to,
    }


def _checker(model):
    from transmogrifai_tpu_torch.checkers.sanity import SanityCheckerModel

    return next(s for s in model.fitted.values() if isinstance(s, SanityCheckerModel))


def patch_bootstrap(draws):
    """Feed ``draws`` (the reference's Poisson draws by (seed, trees, rows))
    through the forest's draw seam."""
    import torch

    from transmogrifai_tpu_torch.models import trees as TT

    def fed(seed, rate, n_trees, n, device):
        return torch.from_numpy(draws[(int(seed), int(n_trees), int(n))]).to(device)

    TT.draw_bootstrap = fed


def flush_check(T, cols: dict, device, mesh) -> dict:
    """The fused prefix of a fitted pipeline (transmogrify + sanity check)
    under the mesh and without: columns and fingerprints."""
    import numpy as np

    from transmogrifai_tpu_torch.parallel.mesh import use_mesh
    from transmogrifai_tpu_torch.workflow.plan import plan_for_features

    ds, label, checked, _ = selector_pipeline(T, cols)
    m = T.Workflow().set_input_dataset(ds).set_result_features(label, checked) \
        .train(device=device)
    plan_u = plan_for_features(ds, m.result_features, m.fitted, device)
    out_u = plan_u.apply_prefix(ds)
    h2d_u = plan_u.last_timings["h2d_bytes"]
    with use_mesh(mesh):
        plan_m = plan_for_features(ds, m.result_features, m.fitted, device)
        out_m = plan_m.apply_prefix(ds)
        fp_m = plan_m.prefix_fingerprint(environment=True)
        launches = plan_m.last_timings["encode_launches"]
        h2d_m = plan_m.last_timings["h2d_bytes"]
    return {"plain": np.asarray(out_u[checked.name].data),
            "meshed": np.asarray(out_m[checked.name].data),
            "fp_plain": plan_u.prefix_fingerprint(environment=True),
            "fp_mesh": fp_m, "encode_launches": launches,
            "h2d_plain": h2d_u, "h2d_mesh": h2d_m,
            "names": sorted(out_u.names)}


def chunked_check(T, cols: dict, device, mesh) -> dict:
    """A chunked epoch of the fitted prefix under the mesh against the
    in-memory transform (the reference's TestChunkTileMeshDivisibility)."""
    import numpy as np

    from transmogrifai_tpu_torch.data.chunked import ChunkedDataset
    from transmogrifai_tpu_torch.parallel.mesh import use_mesh
    from transmogrifai_tpu_torch.workflow.dag import compute_dag
    from transmogrifai_tpu_torch.workflow.fit import transform_dag
    from transmogrifai_tpu_torch.workflow.ooc import chunked_transform_epoch
    from transmogrifai_tpu_torch.workflow.plan import mesh_aligned_tile

    ds, label, checked, _ = selector_pipeline(T, cols)
    m = T.Workflow().set_input_dataset(ds).set_result_features(label, checked) \
        .train(device=device)
    runners = [m.fitted.get(s.uid, s) for layer in compute_dag(m.result_features)
               for s in layer]
    with use_mesh(mesh):
        in_mem = transform_dag(ds, m.result_features, m.fitted, device)
        cds = ChunkedDataset.from_dataset(ds, chunk_rows=101)
        tile = mesh_aligned_tile(cds.chunk_rows)
        outs = [chunked_transform_epoch(cds, runners, device=device)
                for _ in range(2)]
    idx = np.arange(ds.n_rows, dtype=np.intp)
    return {"in_mem": np.asarray(in_mem[checked.name].data),
            "epochs": [np.asarray(o.take(idx)[checked.name].data) for o in outs],
            "tile": tile}


def stats_check(cols: dict, device, mesh) -> dict:
    """The reference's two-process run (tests/distributed_worker.py) on this
    rank's rows: column statistics, the full correlation (by the gram and
    by the ring) and a GBT of 2 rounds x depth 2 over pre-binned codes,
    each beside one process's result on every row."""
    import numpy as np
    import torch

    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch.checkers.sanity import (_device_full_corr,
                                                         _device_stats)
    from transmogrifai_tpu_torch.models.trees import _fit_gbt_lanes, _stack_rounds
    from transmogrifai_tpu_torch.parallel import collectives as C
    from transmogrifai_tpu_torch.parallel import mesh as PM
    from transmogrifai_tpu_torch.parallel.wide import (shard_cols, wide_col_stats,
                                                        wide_full_corr)

    x = np.asarray(cols["x"], np.float32)
    y = np.asarray(cols["y"], np.float32)
    binned = np.asarray(cols["binned"], np.int32)
    n = x.shape[0]
    t = torch.from_numpy

    def gbt(rows: slice, n_global=None):
        margin, trees = _fit_gbt_lanes(
            t(binned[rows]), t(y[rows]), t(np.ones((1, rows.stop - rows.start),
                                                   np.float32)),
            7, n_rounds=2, max_depth=2, n_bins=8, objective="binary:logistic",
            num_class=1, subsample=1.0, colsample_bytree=1.0,
            colsample_bylevel=1.0, eta=0.3, reg_lambda=1.0, alpha=0.0, gamma=0.0,
            min_child_weight=1.0, scale_pos_weight=1.0, max_delta_step=0.0,
            base_score=torch.zeros((1, 1)), n_global=n_global)
        tree = _stack_rounds(trees, 0)
        msum = PM.reduce_rows(margin.sum().reshape(1)) if n_global else margin.sum()
        return {k: getattr(tree, k).numpy() for k in tree._fields}, float(msum)

    # the linear families' final fits: IRLS, FISTA (elastic net), the SVC's
    # proximal steps and ridge's normal equations
    fits = {"lr_irls": T.LogisticRegression(reg_param=0.01),
            "lr_fista": T.LogisticRegression(reg_param=0.05, elastic_net=0.5),
            "svc": T.LinearSVC(reg_param=0.01),
            "ridge": T.LinearRegression(reg_param=0.1)}
    w = np.linspace(0.5, 1.5, n).astype(np.float32)

    def linear():
        return {k: np.concatenate([np.ravel(m.coef), np.ravel(m.intercept)])
                for k, m in ((k, e._fit_arrays(x, y, w, device))
                             for k, e in fits.items())}

    full = [v.numpy() for v in _device_stats(t(x), t(y))]
    gram_full = _device_full_corr(t(x)).numpy()
    gbt_plain = gbt(slice(0, n))
    linear_plain = linear()
    with PM.use_mesh(mesh):
        span = PM.row_span(n)
        meshed = [v.numpy() for v in _device_stats(t(x[span]), t(y[span]), n, mesh)]
        gram_mesh = _device_full_corr(t(x[span]), n, mesh).numpy()
        xs, d_valid = shard_cols(x, mesh)
        ring = wide_full_corr(xs, mesh, d_valid).numpy()
        # 7 columns over 2 ranks: the shards pad to 8, the result trims
        xs7, d7 = shard_cols(x[:, :7], mesh)
        ring7 = wide_full_corr(xs7, mesh, d7).numpy()
        col = [v.numpy() for v in wide_col_stats(xs, t(y), mesh, d_valid)]
        gbt_mesh = gbt(span, n)
        linear_mesh = linear()
        # rank 0's value on every rank of the data group
        rank0 = C.broadcast(torch.tensor([float(mesh.index(PM.DATA_AXIS))]),
                            mesh.group(PM.DATA_AXIS))
    return {"full": full, "meshed": meshed, "gram_full": gram_full,
            "gram_mesh": gram_mesh, "ring": ring, "col": col,
            "ring7": ring7, "gram7": _device_full_corr(t(x[:, :7])).numpy(),
            "gbt_plain": gbt_plain, "gbt_mesh": gbt_mesh,
            "linear_plain": linear_plain, "linear_mesh": linear_mesh,
            "broadcast": float(rank0[0]),
            "span": (span.start, span.stop)}


#: the SanityChecker settings the meshed checker runs (Pearson shards its
#: rows, Spearman's ranks read every row on every rank)
CHECKER_PARAMS = {
    "pearson": {},
    "spearman": {"correlation_type": "spearman"},
    "spearman_max": {"correlation_type": "spearman", "max_correlation": 0.3},
}


def checker_summary(model) -> dict:
    """What a checker comparison reads of a fitted SanityCheckerModel."""
    s = model.summary
    return {"kept": list(model.kept_indices), "dropped": dict(s.dropped),
            "stats": [dict(vars(c)) for c in s.stats],
            "corr": s.correlations_feature,
            "corr_idx": list(s.correlation_indices or [])}


def fit_checker(block: dict, params: dict, device):
    """The port's SanityChecker with ``params`` fitted on ``block`` (label
    ``y``, vector ``x`` and its metadata's ``to_dict``)."""
    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch.checkers.sanity import SanityChecker
    from transmogrifai_tpu_torch.data.dataset import Column
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.utils.vector_metadata import VectorMetadata

    label = T.FeatureBuilder.RealNN("label").extract_field().as_response()
    vec = T.FeatureBuilder.OPVector("v").extract_field().as_predictor()
    checker = SanityChecker(**params)
    label.transform_with(checker, vec)
    ds = T.Dataset({"label": Column.from_values(RealNN, list(block["y"])),
                    "v": Column.vector(block["x"],
                                       VectorMetadata.from_dict(block["meta"]))})
    return checker.fit(ds, device=device)


def checker_check(block: dict, device, mesh) -> dict:
    """Every :data:`CHECKER_PARAMS` fit of ``block`` under the mesh."""
    from transmogrifai_tpu_torch.parallel.mesh import use_mesh

    with use_mesh(mesh):
        return {k: checker_summary(fit_checker(block, p, device))
                for k, p in CHECKER_PARAMS.items()}


def keys_check(cols: dict, device, mesh, tmp: str) -> dict:
    """The mesh token where the reference keys on it: the sweep journal
    (the selector's block and a workflow-CV fold's go through one call),
    the deploy manifest's environment, a program's cache key."""
    import numpy as np

    from transmogrifai_tpu_torch.deploy.bundle import environment_provenance
    from transmogrifai_tpu_torch.evaluators.base import BinaryClassificationEvaluator
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression, _irls_sweep
    from transmogrifai_tpu_torch.models.tuning import sweep_families
    from transmogrifai_tpu_torch.parallel.mesh import mesh_token, use_mesh
    from transmogrifai_tpu_torch.perf.programs import cache_key_fingerprint
    from transmogrifai_tpu_torch.workflow import resilience

    x = np.asarray(cols["x"], np.float32)
    y = np.asarray(cols["y"], np.float32)
    n = x.shape[0]
    tw = np.stack([np.arange(n) % 2 == 0, np.arange(n) % 2 == 1]).astype(np.float32)
    vw = 1.0 - tw
    metric = BinaryClassificationEvaluator("auPR").metric_fn()
    grids = [{"reg_param": 0.1}]
    args = (np.zeros((64, 5), np.float32), np.zeros(64, np.float32),
            np.zeros((2, 64), np.float32), np.zeros(2, np.float32))
    out = {"fp_plain": cache_key_fingerprint(_irls_sweep, *args,
                                             statics=dict(max_iter=3, has_intercept=True)),
           "env_plain": environment_provenance(device)["meshToken"]}
    with use_mesh(mesh):
        journal = resilience.SweepJournal(os.path.join(tmp, f"journal{mesh.rank}.json"))
        with resilience.resilient_training(journal):
            scores, _ = sweep_families([(LogisticRegression(), grids)], x, y, tw, vw,
                                       metric, device, fold_spec=(2, 0, False),
                                       metric_name="auPR", block="fold1")
        digest_ = resilience.data_digest(x, y, tw, vw)
        out.update(
            token=mesh_token(), scores=scores[0],
            journal_keys=sorted(journal._read()),
            expected_key=resilience.sweep_block_key(
                "LogisticRegression", grids, (2, 0, False), "auPR", digest_,
                mesh_token(), "fold1"),
            unmeshed_key=resilience.sweep_block_key(
                "LogisticRegression", grids, (2, 0, False), "auPR", digest_,
                None, "fold1"),
            env_mesh=environment_provenance(device)["meshToken"],
            fp_mesh=cache_key_fingerprint(_irls_sweep, *args,
                                          statics=dict(max_iter=3, has_intercept=True)))
    return out


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------

def main(argv) -> None:
    rank, world, init, spec_path, out_path = (int(argv[0]), int(argv[1]), argv[2],
                                              argv[3], argv[4])
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import torch

    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch.parallel import collectives as C
    from transmogrifai_tpu_torch.parallel import distributed
    from transmogrifai_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device

    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    cpu = torch.device("cpu")
    out: dict = {"rank": rank}
    with use_device("cpu"):
        if "master_port" in spec:
            distributed.initialize()    # torchrun's variables
        else:
            distributed.initialize(f"file://{init}", world, rank)
        mesh = make_mesh(*spec["shape"])
        out["coord"] = (mesh.index("data"), mesh.index("model"))
        if spec.get("draws") is not None:
            patch_bootstrap(spec["draws"])
        for name in spec["scenarios"]:
            C.reset_collective_counts()
            if name == "die":
                # one rank fails; the others' next collective must fail
                # too (peer gone, or the group timeout), never hang
                if rank == spec["die_rank"]:
                    os._exit(3)
                C.all_reduce(torch.ones(4), mesh.group("data"))
            elif name == "selector":
                # rank 0 alone writes files
                save_to = os.path.join(os.path.dirname(out_path), "model") \
                    if rank == 0 else None
                with use_mesh(mesh):
                    out[name] = train_selector(T, spec["cols"], cpu,
                                               save_to=save_to)
            elif name == "svc":
                with use_mesh(mesh):
                    out[name] = train_selector(T, spec["svc_cols"], cpu, first="svc")
            elif name == "flush":
                out[name] = flush_check(T, spec["cols"], cpu, mesh)
            elif name == "chunked":
                out[name] = chunked_check(T, spec["cols"], cpu, mesh)
            elif name == "stats":
                out[name] = stats_check(spec["stats_cols"], cpu, mesh)
            elif name == "checker":
                out[name] = checker_check(spec["checker_block"], cpu, mesh)
            elif name == "keys":
                out[name] = keys_check(spec["stats_cols"], cpu, mesh,
                                       os.path.dirname(out_path))
            out.setdefault("collectives", {})[name] = C.collective_counts()
    import torch.distributed as dist

    dist.barrier()
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
