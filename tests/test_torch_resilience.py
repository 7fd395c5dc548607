"""Durable training in the port: stage checkpoints (``workflow/checkpoint.py``)
and the sweep journal, retries and bucket ladder (``workflow/resilience.py``),
mirroring ``tests/test_checkpoint.py`` and ``tests/test_resilience.py``
without their mesh and CLI cases.

- ``Workflow.train(checkpointer=...)``: the first run writes every fitted
  stage; a re-run fits nothing and scores alike; a missing checkpoint refits
  that stage only; changed params refit the stage and every estimator
  downstream (through transformers); a transformer parent does not
  invalidate a resume; a torn ``.npz`` or ``.json`` refits that stage only;
- ``SweepJournal``: bitwise round trips with the dtype; zero-byte, torn and
  non-dict files read as empty; a stale ``.tmp`` is dropped; the block key
  and data digest are the JAX package's for the same inputs;
- ``retry_call`` / ``run_sweep_block``: passthrough without a context,
  retries with TM820, exhaustion raises the last error, a non-retryable
  error fails fast once (TM823); "CUDA out of memory" shrinks the row
  bucket (TM822) and the degraded block is not journaled;
- ``Workflow.train(resume=dir)``: a run killed at the third family's
  ``device_sync`` leaves two committed blocks; the re-run replays them
  without launching (journal hits 2) and ends bitwise equal to an
  uninterrupted run; an identical re-run is all hits; workflow CV journals
  one block per (fold, family); the ``stage_fit`` and ``sweep_dispatch``
  fault points fire where the reference's do.
"""

import json
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu.workflow.resilience as JR
from transmogrifai_tpu_torch import (
    BinaryClassificationModelSelector,
    Dataset,
    FeatureBuilder,
    Workflow,
    transmogrify,
)
from transmogrifai_tpu_torch.data.dataset import Column
from transmogrifai_tpu_torch.models.logistic import LogisticRegression
from transmogrifai_tpu_torch.models.svm import LinearSVC
from transmogrifai_tpu_torch.models.trees import (
    GradientBoostedTreesClassifier,
    RandomForestClassifier,
)
from transmogrifai_tpu_torch.serve.faults import FaultHarness, TransientScoringError
from transmogrifai_tpu_torch.types import OPVector, Real, RealNN
from transmogrifai_tpu_torch.workflow import resilience
from transmogrifai_tpu_torch.workflow.checkpoint import StageCheckpointer
from transmogrifai_tpu_torch.workflow.dag import all_stages
from transmogrifai_tpu_torch.workflow.resilience import (
    RetryableTrainingError,
    RetryPolicy,
    SweepJournal,
    resilient_training,
    retry_call,
)

CPU = {"device": "cpu"}
FAST = dict(policy=RetryPolicy(sleep=lambda s: None))


def _pipeline(seed=0):
    rng = np.random.default_rng(seed)
    n = 160
    cols = {f"x{i}": rng.normal(size=n).tolist() for i in range(3)}
    cols["label"] = (rng.random(n) > 0.5).astype(float).tolist()
    ds = Dataset.from_features(
        cols, {**{f"x{i}": Real for i in range(3)}, "label": RealNN})
    label = FeatureBuilder.of("label", RealNN).extract_field().as_response()
    feats = [FeatureBuilder.of(f"x{i}", Real).extract_field().as_predictor()
             for i in range(3)]
    checked = label.sanity_check(transmogrify(feats))
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, models=[(LogisticRegression(), [{"reg_param": 0.01}])])
    pred = label.transform_with(sel, checked)
    return ds, label, pred


def _fits(wf):
    return [r["stage"] for r in wf.last_train_profile if r["kind"] == "fit"]


def _train(tmp_path, seed=0):
    ds, label, pred = _pipeline(seed)
    ckpt = StageCheckpointer(str(tmp_path))
    wf = Workflow().set_input_dataset(ds).set_result_features(label, pred)
    model = wf.train(checkpointer=ckpt, **CPU)
    return ds, label, pred, ckpt, wf, model


class TestStageCheckpointer:
    def test_first_run_writes_stages_and_resume_fits_nothing(self, tmp_path):
        ds, label, pred, ckpt, wf, m1 = _train(tmp_path)
        loaded = ckpt.load_all()
        assert len(loaded) >= 3 and len(_fits(wf)) == len(loaded)
        assert any(type(m).__name__ == "SelectedModel" for m in loaded.values())
        m2 = wf.train(checkpointer=ckpt, **CPU)
        assert _fits(wf) == []
        s1 = np.asarray(m1.score(ds, **CPU)[pred.name].score)
        s2 = np.asarray(m2.score(ds, **CPU)[pred.name].score)
        assert s1.tobytes() == s2.tobytes()

    def test_partial_resume_fits_missing_only(self, tmp_path):
        _, _, pred, ckpt, wf, _ = _train(tmp_path)
        for path in ckpt._paths(pred.origin_stage.uid):
            if os.path.exists(path):
                os.remove(path)
        wf.train(checkpointer=ckpt, **CPU)
        assert _fits(wf) == [type(pred.origin_stage).__name__]

    def test_workflow_cv_resume_skips_the_fold_sweep(self, tmp_path):
        ds, label, pred = _pipeline()
        ckpt = StageCheckpointer(str(tmp_path))
        wf = Workflow().set_input_dataset(ds).set_result_features(label, pred) \
            .with_workflow_cv()
        wf.train(checkpointer=ckpt, **CPU)
        wf.train(checkpointer=ckpt, **CPU)
        assert _fits(wf) == [] and not any(
            r["kind"] == "fold_sweep" for r in wf.last_train_profile)

    def test_changed_params_refit_the_stage_and_downstream(self, tmp_path):
        _, label, pred, ckpt, wf, _ = _train(tmp_path)
        sc = next(s for s in all_stages([label, pred])
                  if type(s).__name__ == "SanityChecker")
        sc.min_variance = 0.123
        wf.train(checkpointer=ckpt, **CPU)
        assert _fits(wf) == ["SanityChecker", type(pred.origin_stage).__name__]

    def test_refit_cascades_through_an_intermediate_transformer(self, tmp_path):
        from transmogrifai_tpu_torch.ops.misc import DropIndicesByTransformer

        ds, label, _ = _pipeline(5)
        feats = [f for f in all_stages([label]) if False]
        del feats
        label = FeatureBuilder.of("label", RealNN).extract_field().as_response()
        xs = [FeatureBuilder.of(f"x{i}", Real).extract_field().as_predictor()
              for i in range(3)]
        checked = label.sanity_check(transmogrify(xs))
        passed = checked.transform_with(DropIndicesByTransformer(match_fn=_keep_all))
        sel = BinaryClassificationModelSelector.with_cross_validation(
            num_folds=2, models=[(LogisticRegression(), [{"reg_param": 0.01}])])
        pred = label.transform_with(sel, passed)
        ckpt = StageCheckpointer(str(tmp_path))
        wf = Workflow().set_input_dataset(ds).set_result_features(label, pred)
        wf.train(checkpointer=ckpt, **CPU)
        sanity = next(s for s in all_stages([label, pred])
                      if type(s).__name__ == "SanityChecker")
        for path in ckpt._paths(sanity.uid):
            if os.path.exists(path):
                os.remove(path)
        wf.train(checkpointer=ckpt, **CPU)
        assert _fits(wf) == ["SanityChecker", type(sel).__name__]

    def _text_pipeline(self):
        from transmogrifai_tpu_torch.ops.text import TextTokenizer
        from transmogrifai_tpu_torch.types import Text

        rng = np.random.default_rng(3)
        n = 120
        words = ["alpha beta", "gamma delta epsilon", "zeta", "eta theta"]
        cols = {"txt": [words[i % 4] for i in range(n)],
                "x0": rng.normal(size=n).tolist(),
                "label": (rng.random(n) > 0.5).astype(float).tolist()}
        ds = Dataset.from_features(cols, {"txt": Text, "x0": Real, "label": RealNN})
        label = FeatureBuilder.of("label", RealNN).extract_field().as_response()
        txt = FeatureBuilder.of("txt", Text).extract_field().as_predictor()
        x0 = FeatureBuilder.of("x0", Real).extract_field().as_predictor()
        toks = txt.transform_with(TextTokenizer(min_token_length=1))
        sel = _selector([(LogisticRegression(), [{"reg_param": 0.01}])])
        pred = label.transform_with(sel, transmogrify([toks, x0]))
        return ds, label, pred

    def test_transformer_parent_resumes_and_its_param_edit_refits(self, tmp_path):
        ds, label, pred = self._text_pipeline()
        ckpt = StageCheckpointer(str(tmp_path))
        wf = Workflow().set_input_dataset(ds).set_result_features(label, pred)
        wf.train(checkpointer=ckpt, **CPU)
        wf.train(checkpointer=ckpt, **CPU)
        assert _fits(wf) == []                     # the tokenizer refits nothing
        tok = next(s for s in all_stages([label, pred])
                   if type(s).__name__ == "TextTokenizer")
        tok.min_token_length = 3
        wf.train(checkpointer=ckpt, **CPU)
        assert _fits(wf) != []                     # its lineage changed

    @pytest.mark.parametrize("damage", ["truncated_npz", "corrupt_json",
                                        "npz_missing"])
    def test_torn_checkpoint_refits_that_stage_only(self, tmp_path, damage):
        ds, _, pred, ckpt, wf, _ = _train(tmp_path)
        jpath, npath = ckpt._paths(pred.origin_stage.uid)
        if damage == "truncated_npz":
            blob = open(npath, "rb").read()
            with open(npath, "wb") as fh:
                fh.write(blob[:max(1, len(blob) // 2)])
        elif damage == "corrupt_json":
            with open(jpath, "w") as fh:
                fh.write('{"className": "SelectedMo')
        else:
            os.remove(npath)
        model = wf.train(checkpointer=ckpt, **CPU)
        assert _fits(wf) == [type(pred.origin_stage).__name__]
        assert np.isfinite(np.asarray(model.score(ds, **CPU)[pred.name].score)).all()

    def test_save_stage_removes_a_stale_npz(self, tmp_path):
        from transmogrifai_tpu_torch.ops.math import AliasTransformer

        ckpt = StageCheckpointer(str(tmp_path))
        stage = AliasTransformer(name="alias")
        _, npath = ckpt._paths(stage.uid)
        with open(npath, "wb") as fh:
            np.savez(fh, junk=np.zeros(3))
        ckpt.save_stage(stage)
        assert not os.path.exists(npath)


def _keep_all(cm):
    return False


# ---------------------------------------------------------------------------
# The sweep journal
# ---------------------------------------------------------------------------

class TestSweepJournal:
    def test_roundtrip_is_bitwise_with_dtype(self, tmp_path):
        j = SweepJournal(str(tmp_path / "j.json"))
        a = np.random.default_rng(0).normal(size=(3, 2)).astype(np.float32)
        b = np.array([[0.1 + 0.2, np.nan], [1e-300, -0.0]])
        j.commit("a", a, family="F")
        j.commit("b", b)
        for key, arr in (("a", a), ("b", b)):
            got = j.load(key)
            assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes()
        assert j.hits == 2 and j.commits == 2 and j.load("c") is None

    @pytest.mark.parametrize("content", [b"", b'{"k": {"scores": [[1', b"[1]"])
    def test_zero_byte_garbage_and_non_dict_read_as_empty(self, tmp_path, content):
        path = tmp_path / "j.json"
        path.write_bytes(content)
        j = SweepJournal(str(path))
        assert j.keys() == [] and j.load("k") is None and j.misses == 1

    def test_stale_tmp_is_dropped_not_adopted(self, tmp_path):
        j = SweepJournal(str(tmp_path / "j.json"))
        (tmp_path / "j.json.tmp").write_text(json.dumps(
            {"k": {"scores": [[1.0]], "dtype": "float64"}}))
        assert j.load("k") is None
        assert not (tmp_path / "j.json.tmp").exists()

    def test_key_and_digest_equal_the_reference(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(20, 3)).astype(np.float32)
        y = (rng.random(20) > 0.5).astype(np.float32)
        w = np.ones((2, 20), np.float32)
        for args in ((x, y, w, w), (x, None), (x.astype(np.float64),)):
            assert resilience.data_digest(*args) == JR.data_digest(*args)
        d = resilience.data_digest(x, y, w, w)
        assert d != resilience.data_digest(x[:, ::-1].copy(), y, w, w)
        grids = [{"reg_param": 0.1, "max_iter": 5}, {}]
        for block in ("all", "fold2"):
            key = resilience.sweep_block_key("LogisticRegression", grids,
                                             (3, 42, False), "auPR", d, None,
                                             block)
            assert key == JR.sweep_block_key("LogisticRegression", grids,
                                             (3, 42, False), "auPR", d, None,
                                             block)
        assert resilience.sweep_block_key("A", grids, (3, 42, False), "auPR", d,
                                          None) != resilience.sweep_block_key(
            "A", grids, (3, 7, False), "auPR", d, None)


# ---------------------------------------------------------------------------
# Retries and the bucket ladder
# ---------------------------------------------------------------------------

class TestRetries:
    def test_passthrough_without_an_active_context(self):
        calls = []
        assert retry_call(lambda: calls.append(1) or 7, "p") == 7
        with pytest.raises(RetryableTrainingError):
            retry_call(lambda: (_ for _ in ()).throw(RetryableTrainingError()), "p")
        assert resilience.active() is None

    def test_retries_then_succeeds_with_tm820(self):
        left = [2]

        def flaky():
            if left[0]:
                left[0] -= 1
                raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")
            return "ok"

        with resilient_training(**FAST) as res:
            assert retry_call(flaky, "stage_fit", stage="s") == "ok"
        assert res.retries == 2
        assert [d.code for d in res.diagnostics] == ["TM820", "TM820"]
        assert resilience.last() is res

    def test_exhaustion_raises_the_last_error(self):
        with resilient_training(policy=RetryPolicy(max_retries=1,
                                                   sleep=lambda s: None)) as res:
            with pytest.raises(TransientScoringError, match="x1"):
                n = iter(range(9))
                retry_call(lambda: (_ for _ in ()).throw(
                    TransientScoringError(f"x{next(n)}")), "p")
        assert res.retries == 1

    def test_non_retryable_fails_fast_once_across_nesting(self):
        err = ValueError("bad input")

        def inner():
            raise err

        with resilient_training(**FAST) as res:
            with pytest.raises(ValueError):
                retry_call(lambda: retry_call(inner, "device_sync"), "stage_fit")
        assert [d.code for d in res.diagnostics] == ["TM823"]
        assert "device_sync" in res.diagnostics[0].message

    def test_kernel_fault_is_never_retried(self):
        from transmogrifai_tpu_torch.perf.kernels.dispatch import KernelError

        with resilient_training(**FAST) as res:
            with pytest.raises(KernelError):
                retry_call(lambda: (_ for _ in ()).throw(KernelError("launch")), "p")
        assert res.retries == 0 and [d.code for d in res.diagnostics] == ["TM823"]

    def test_context_stack_is_nested_lifo(self):
        with resilient_training() as outer:
            with resilient_training() as inner:
                assert resilience.active() is inner
            assert resilience.active() is outer
        assert resilience.active() is None and resilience.last() is outer

    def test_row_cap_ladder_equals_the_reference(self):
        rows = list(range(1, 3000)) + [262144, 262145, 1 << 20]
        assert [resilience._next_row_cap(n) for n in rows] == \
            [JR._next_row_cap(n) for n in rows]

    def test_oom_shrinks_to_the_next_bucket_and_is_not_journaled(self, tmp_path):
        rows = []

        def attempt(row_cap, i):
            n = 1000 if row_cap is None else row_cap
            rows.append(n)
            if n > 512:
                raise TransientScoringError("CUDA out of memory")
            return np.ones((1, 2))

        with resilient_training(**FAST) as res:
            out = resilience.run_sweep_block(attempt, "F", rows=1000)
        assert rows == [1000, 512] and out.shape == (1, 2)
        assert res.degradations == [{"kind": "bucket_shrink", "family": "F",
                                     "rows_from": 1000, "row_cap": 512}]
        assert [d.code for d in res.diagnostics] == ["TM822"]

        ds, label, vec = _binary_ds(n=1000, seed=4)
        sel = _selector([(LogisticRegression(), [{"reg_param": 0.01}])])
        journal = SweepJournal(str(tmp_path / "j.json"))
        harness = FaultHarness().fail_when(
            "sweep_dispatch", lambda ctx: ctx.get("rows", 0) > 512,
            lambda: torch.OutOfMemoryError("CUDA out of memory"))
        with harness, resilient_training(journal=journal, **FAST) as res:
            label.transform_with(sel, vec)
            model = sel.fit(ds, **CPU)
        assert res.degradations[0]["row_cap"] == 512
        assert journal.keys() == []
        vals = [v for ev in model.summary.validation_results
                for v in ev.metric_values]
        assert vals and np.isfinite(vals).all()


def _binary_ds(n=400, d=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ rng.normal(size=d))))) \
        .astype(np.float64)
    label = FeatureBuilder.of("label", RealNN).extract_field().as_response()
    vec = FeatureBuilder.of("v", OPVector).extract_field().as_predictor()
    ds = Dataset({"label": Column.from_values(RealNN, y.tolist()),
                  "v": Column.vector(x)})
    return ds, label, vec


def _selector(models, folds=2):
    return BinaryClassificationModelSelector.with_cross_validation(
        num_folds=folds, models=models)


FOUR = lambda: [  # noqa: E731 — bench.py's four families, small grids
    (LogisticRegression(), [{"reg_param": 0.01}, {"reg_param": 0.1}]),
    (RandomForestClassifier(), [{"num_trees": 5, "max_depth": 3}]),
    (GradientBoostedTreesClassifier(), [{"num_rounds": 5, "max_depth": 2}]),
    (LinearSVC(), [{"reg_param": 0.1}])]


# ---------------------------------------------------------------------------
# Killed and resumed sweeps
# ---------------------------------------------------------------------------

class TestSweepResume:
    def _build(self, x, y, models, wcv=False):
        label = FeatureBuilder.of("label", RealNN).extract_field().as_response()
        vec = FeatureBuilder.of("v", OPVector).extract_field().as_predictor()
        pred = label.transform_with(_selector(models, folds=3), vec)
        ds = Dataset({"label": Column.from_values(RealNN, y.tolist()),
                      "v": Column.vector(x)})
        wf = Workflow().set_result_features(label, pred).set_input_dataset(ds)
        if wcv:
            wf.with_workflow_cv()
        return wf, ds, pred

    def test_killed_sweep_resumes_bitwise_without_relaunching(self, tmp_path,
                                                              monkeypatch):
        from transmogrifai_tpu_torch.models import base as MB

        rng = np.random.default_rng(0)
        x = rng.normal(size=(300, 4)).astype(np.float32)
        y = (rng.random(300) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float64)
        wf_ref, ds_ref, pred_ref = self._build(x, y, FOUR())
        model_ref = wf_ref.train(**CPU)

        resume = str(tmp_path / "ckpt")
        harness = FaultHarness().script(
            "device_sync", [None, None, RuntimeError("killed mid-sweep")])
        wf1, _, _ = self._build(x, y, FOUR())
        with harness, pytest.raises(RuntimeError, match="killed mid-sweep"):
            wf1.train(resume=resume, **CPU)
        assert len(SweepJournal(os.path.join(resume, "sweep_journal.json")).keys()) == 2

        launched = []
        real = MB.PredictionEstimatorBase.cv_sweep_async
        monkeypatch.setattr(MB.PredictionEstimatorBase, "cv_sweep_async",
                            lambda self, *a, **k: launched.append(type(self).__name__)
                            or real(self, *a, **k))
        wf2, ds2, pred2 = self._build(x, y, FOUR())
        model = wf2.train(resume=resume, **CPU)
        res = resilience.last()
        assert res.journal.hits == 2 and res.journal.commits == 2
        assert launched == ["GradientBoostedTreesClassifier", "LinearSVC"]
        s_ref, s = model_ref.summary(), model.summary()
        assert s.best_model_name == s_ref.best_model_name
        assert [e.metric_values for e in s.validation_results] == \
            [e.metric_values for e in s_ref.validation_results]
        got = model.score(ds2, **CPU)[pred2.name]
        want = model_ref.score(ds_ref, **CPU)[pred_ref.name]
        assert np.asarray(got.prob).tobytes() == np.asarray(want.prob).tobytes()

    def test_identical_rerun_replays_every_block(self, tmp_path):
        ds, label, vec = _binary_ds(n=300, seed=6)
        path = str(tmp_path / "j.json")

        def sweep_once():
            _, label, vec = _binary_ds(n=300, seed=6)
            sel = _selector([(LogisticRegression(), [{"reg_param": 0.001},
                                                     {"reg_param": 0.01}]),
                             (LogisticRegression(), [{"reg_param": 0.1}])])
            with resilient_training(journal=SweepJournal(path)):
                label.transform_with(sel, vec)
                sel.fit(ds, **CPU)
            return resilience.last().journal

        j1 = sweep_once()
        assert j1.commits == 2 and j1.hits == 0
        j2 = sweep_once()
        assert j2.hits == 2 and j2.commits == 0

    def test_workflow_cv_blocks_journal_per_fold(self, tmp_path):
        rng = np.random.default_rng(7)
        x = rng.normal(size=(240, 4)).astype(np.float32)
        y = (rng.random(240) > 0.5).astype(np.float64)
        path = str(tmp_path / "j.json")

        def run_cv():
            wf, _, _ = self._build(x, y, [(LogisticRegression(),
                                           [{"reg_param": 0.01}])], wcv=True)
            with resilient_training(journal=SweepJournal(path)):
                wf.train(**CPU)
            return resilience.last().journal

        j1 = run_cv()
        assert (j1.commits, j1.hits) == (3, 0)
        j2 = run_cv()
        assert (j2.hits, j2.commits) == (3, 0)

    def test_stage_fit_and_sweep_dispatch_fault_points_fire(self, tmp_path):
        ds, label, pred = _pipeline()
        wf = Workflow().set_input_dataset(ds).set_result_features(label, pred)
        harness = FaultHarness().script(
            "stage_fit", [TransientScoringError("preempted")])
        with harness:
            wf.train(resume=str(tmp_path / "r"), **CPU)
        res = resilience.last()
        assert [d.code for d in res.diagnostics] == ["TM820"]
        assert harness.calls["stage_fit"] == len(_fits(wf)) + 1
        assert harness.calls["sweep_dispatch"] == 1
        assert harness.calls["device_sync"] == 1
