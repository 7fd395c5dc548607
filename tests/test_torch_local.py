"""Local scoring and the standalone export of the port against the JAX
package.

- ``local/scoring.py``: ``score_function(model)`` on the committed
  ``fixtures/serving_wide`` model (loaded by both packages) gives the JAX
  package's ``score_function`` records, and the port's own
  ``WorkflowModel.score`` values, for batches with and without the label and
  for one record; it binds the transform plan once (one plan per column
  set); no tensor reaches the caller; with no card it raises;
- ``local/export.py``: the port's export of the JAX-saved
  ``fixtures/training_families`` model (text, dates, geolocations) is the JAX
  package's bundle (``fixtures/streaming/bundle_families``): ``program.json``
  equal, every ``arrays.npz`` array bitwise with the same dtype,
  ``scorer.py`` the same text, the text runtime vendored from the port's own
  ``utils/`` under its own header; the bundle, run in a process where torch
  and jax cannot be imported, scores within 1e-6 of ``LocalScorer``;
  ``fixtures/serving_wide``'s decision-tree bucketizers raise at export time
  with the JAX package's message, naming the stage.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from transmogrifai_tpu.local import score_function as j_score_function
from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel
from transmogrifai_tpu_torch import WorkflowModel as TModel
from transmogrifai_tpu_torch.local import LocalScorer, export_standalone, score_function
from transmogrifai_tpu_torch.local import scoring as local_scoring
from transmogrifai_tpu_torch.perf.kernels import encode as KE
from transmogrifai_tpu_torch.readers.base import rows_to_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures")
sys.path.insert(0, os.path.join(REPO, "tests"))

import torch_stream_data as S  # noqa: E402
from test_torch_streaming import _records  # noqa: E402


@pytest.fixture(scope="module")
def wide():
    return JModel.load(os.path.join(FIXTURES, "serving_wide")), \
        TModel.load(os.path.join(FIXTURES, "serving_wide"))


@pytest.fixture(scope="module")
def families():
    import transmogrifai_tpu.models.logistic  # noqa: F401  (registers the head)

    with open(os.path.join(FIXTURES, "training_families", "records.json")) as fh:
        recs = json.load(fh)["batches"][0]["records"][:64]
    return TModel.load(os.path.join(FIXTURES, "training_families")), recs


class TestLocalScorer:
    @pytest.mark.parametrize("n, seed, label", [(64, 0, False), (1, 1, False),
                                                (40, 2, True)])
    def test_records_equal_jax_score_function(self, wide, n, seed, label):
        jm, tm = wide
        recs = _records(n, seed)
        if label:
            for i, r in enumerate(recs):
                r["label"] = float(i % 2)
        got = score_function(tm, device="cpu").batch(recs)
        assert got == j_score_function(jm).batch(recs)
        if n == 1:
            assert score_function(tm, device="cpu")(recs[0]) == got[0]

    def test_equals_the_port_model_score(self, wide):
        _, tm = wide
        recs = _records(50, 3)
        scorer = LocalScorer(tm, device="cpu")
        got = scorer.batch(recs)
        pred = next(f for f in tm.result_features if f.ftype.__name__ == "Prediction")
        ref = tm.score(rows_to_dataset(recs, _raws(tm), allow_missing_response=True),
                       device="cpu")
        want = [local_scoring._plain(v) for v in ref[pred.name].to_values()]
        assert [r[pred.name] for r in got] == want

    def test_plan_bound_once_one_encode_call_a_batch(self, wide, monkeypatch):
        _, tm = wide
        scorer = LocalScorer(tm, device="cpu")
        (plan, joint, _), = scorer._plans.values()
        assert len(plan._encode_table) == 40
        calls = []
        real = KE.encode_slots
        monkeypatch.setattr(KE, "encode_slots",
                            lambda ops, table, out: calls.append(len(table))
                            or real(ops, table, out))
        scorer.batch(_records(20, 4))
        scorer.batch(_records(3, 5))
        assert len(scorer._plans) == 1 and scorer._plans[
            next(iter(scorer._plans))][1] is joint
        assert calls == [40, 40]

    def test_no_tensor_reaches_the_caller(self):
        t = torch.tensor([1.5, 2.0])
        out = local_scoring._plain({"a": torch.tensor(3.0), "b": np.float32(2),
                                    "c": np.arange(2)})
        assert out == {"a": 3.0, "b": 2.0, "c": [0, 1]}
        assert type(out["a"]) is float and type(out["b"]) is float
        assert local_scoring._plain(t) == [1.5, 2.0]

    def test_no_card_raises(self, wide, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            score_function(wide[1])


def _raws(model):
    from transmogrifai_tpu_torch.workflow.workflow import dedup_raw_features

    return dedup_raw_features(model.result_features)


class TestExport:
    def test_families_bundle_is_the_jax_bundle(self, families, tmp_path):
        tm, _ = families
        export_standalone(tm, str(tmp_path))
        ref = os.path.join(FIXTURES, "streaming", "bundle_families")
        with open(tmp_path / "program.json") as a, \
                open(os.path.join(ref, "program.json")) as b:
            assert json.load(a) == json.load(b)
        with np.load(tmp_path / "arrays.npz") as got, \
                np.load(os.path.join(ref, "arrays.npz")) as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].shape == want[k].shape, k
                assert got[k].tobytes() == want[k].tobytes(), k
        with open(tmp_path / "scorer.py") as a, open(os.path.join(ref, "scorer.py")) as b:
            assert a.read() == b.read()
        for src, dst in (("text", "_tl_text"), ("lang", "_tl_lang"),
                         ("hashing", "_tl_hashing")):
            with open(tmp_path / f"{dst}.py") as fh:
                head = fh.readline()
                body = fh.read()
            assert head.startswith("# VENDORED at export time from "
                                   f"transmogrifai_tpu_torch/utils/{src}.py")
            assert "import torch" not in body and "jax" not in body

    def test_bundle_scores_within_1e6_of_local_scorer(self, families, tmp_path):
        tm, recs = families
        export_standalone(tm, str(tmp_path))
        out = S.run_bundle(str(tmp_path), recs, batch=32)
        assert out["loaded"] == []
        pred = next(f.name for f in tm.result_features
                    if f.ftype.__name__ == "Prediction")
        local = LocalScorer(tm, device="cpu").batch(recs)
        assert S.bundle_deviation(out["rows"], local, pred) <= 1e-6

    def test_unsupported_stage_raises_naming_it(self, wide, tmp_path):
        with open(os.path.join(FIXTURES, "streaming", "export_refusals.json")) as fh:
            want = json.load(fh)["serving_wide"]
        with pytest.raises(ValueError) as e:
            export_standalone(wide[1], str(tmp_path))
        assert str(e.value) == want
        assert "DecisionTreeNumericBucketizer" in want
