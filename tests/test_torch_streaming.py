"""The streaming reader and the runner's STREAMING_SCORE run of the port
against the JAX package, on the same files (in ``tmp_path``).

- ``readers/streaming.py`` (host code, copied): ``JsonlTailSource`` polls the
  same records and byte offsets (a partial trailing line waits, a malformed
  line raises or is skipped and counted, truncation and rotation to a larger
  file restart at the head, the rotation pins survive a restart through the
  checkpoint), ``OffsetCheckpoint`` reads a zero-byte, torn or non-dict file
  as "no checkpoint" and drops a stale ``.tmp``, and
  ``MicroBatchStreamingReader`` yields the same batches with the same
  backpressure targets on a scripted clock;
- ``WorkflowRunner.run(RunType.STREAMING_SCORE)`` on the committed
  ``fixtures/serving_wide`` model: every micro-batch's scores bitwise the
  JAX package's, the committed offset the file's byte length only after each
  batch's output is written, a restarted reader replaying and skipping
  nothing; with no ``write_location`` nothing is committed; with no card
  the run raises instead of running on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu.readers.streaming as JS
import transmogrifai_tpu.workflow.runner as J_run
import transmogrifai_tpu_torch.readers.streaming as TS
import transmogrifai_tpu_torch.workflow.runner as T_run
from transmogrifai_tpu.params import OpParams as JParams
from transmogrifai_tpu.types import Real as JReal
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.workflow.workflow import Workflow as JWorkflow
from transmogrifai_tpu_torch import FeatureBuilder as TFB
from transmogrifai_tpu_torch import Workflow as TWorkflow
from transmogrifai_tpu_torch.params import OpParams as TParams
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.types import Real as TReal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "serving_wide")
MODS = {"j": JS, "t": TS}


def _write(path, lines, mode="w"):
    with open(path, mode) as fh:
        fh.write("".join(lines))


def _poll_all(mod, path, sizes, offset=0, **kw):
    src = mod.JsonlTailSource(path, **kw)
    src.seek(offset)
    out = []
    for n in sizes:
        recs, off = src.poll(n)
        out.append((recs, off))
    return out, src


class TestJsonlTailSource:
    def test_polls_records_and_byte_offsets_like_reference(self, tmp_path):
        path = str(tmp_path / "e.jsonl")
        _write(path, [json.dumps({"x": i, "s": "é" * i}) + "\n" for i in range(7)]
               + ["\n", '{"x": 99'])                 # blank line, partial tail
        got = {k: _poll_all(m, path, [3, 3, 5, 5])[0] for k, m in MODS.items()}
        assert got["t"] == got["j"]
        assert got["t"][-1][0] == [] and got["t"][2][0] == [{"x": 6, "s": "é" * 6}]
        _write(path, ["}\n"], mode="a")              # the writer finishes the line
        tail = {k: _poll_all(m, path, [5], offset=got[k][-1][1])[0]
                for k, m in MODS.items()}
        assert tail["t"] == tail["j"] and tail["t"][0][0] == [{"x": 99}]
        assert tail["t"][0][1] == os.path.getsize(path)

    def test_malformed_line_raises_or_is_skipped_and_counted(self, tmp_path):
        path = str(tmp_path / "e.jsonl")
        _write(path, ['{"a": 1}\n', "not json\n", '{"a": 2}\n'])
        for m in MODS.values():
            src = m.JsonlTailSource(path)
            assert src.poll(10) == ([{"a": 1}], 9)    # the good prefix first
            with pytest.raises(ValueError, match="malformed JSONL at byte 9"):
                src.poll(10)
        got = {k: _poll_all(m, path, [10, 10], skip_malformed=True)
               for k, m in MODS.items()}
        assert got["t"][0] == got["j"][0] == [([{"a": 1}], 9), ([{"a": 2}], 27)]
        assert got["t"][1].skipped_malformed == got["j"][1].skipped_malformed == 1

    @pytest.mark.parametrize("how", ["truncate", "copytruncate_larger",
                                     "rename_larger"])
    def test_rotation_restarts_at_the_head(self, tmp_path, how):
        got = {}
        for k, m in MODS.items():
            path = str(tmp_path / f"{k}.jsonl")
            _write(path, [json.dumps({"old": i}) + "\n" for i in range(4)])
            src = m.JsonlTailSource(path)
            first = src.poll(10)
            new = [json.dumps({"new": i}) + "\n" for i in
                   range(2 if how == "truncate" else 12)]
            if how == "rename_larger":
                _write(path + ".next", new)
                os.replace(path + ".next", path)
            else:
                _write(path, new)                     # same inode, rewritten
            got[k] = (first, src.poll(20))
        assert got["t"] == got["j"]
        assert got["t"][1][0][0] == {"new": 0}

    def test_rotation_while_down_is_seen_through_the_checkpoint(self, tmp_path):
        got = {}
        for k, m in MODS.items():
            path = str(tmp_path / f"{k}.jsonl")
            _write(path, [json.dumps({"old": i}) + "\n" for i in range(4)])
            ck = m.OffsetCheckpoint(str(tmp_path / f"{k}.offsets"))
            r = m.MicroBatchStreamingReader(m.JsonlTailSource(path, "s"), ck,
                                            batch_interval=0.0,
                                            max_empty_polls=0,
                                            sleep=lambda s: None)
            for _ in r.stream_datasets([]):
                r.commit()
            _write(path, [json.dumps({"new": i}) + "\n" for i in range(9)])
            r2 = m.MicroBatchStreamingReader(m.JsonlTailSource(path, "s"), ck,
                                             batch_interval=0.0,
                                             max_empty_polls=0,
                                             sleep=lambda s: None)
            list(r2.stream_datasets([]))
            got[k] = (ck.load("s"), ck.load_meta("s")["head"], r2.last_records)
        assert got["t"] == got["j"]
        assert got["t"][2][0] == {"new": 0}


class TestOffsetCheckpoint:
    @pytest.mark.parametrize("content", [b"", b'{"s": 1', b"[1, 2]", b'{"s": "x"}'])
    def test_zero_byte_torn_or_foreign_file_is_no_checkpoint(self, tmp_path, content):
        for k, m in MODS.items():
            path = str(tmp_path / f"{k}.json")
            with open(path, "wb") as fh:
                fh.write(content)
            ck = m.OffsetCheckpoint(path)
            assert ck.load("s", default=5) == 5 and ck.load_meta("s") is None
            ck.commit("s", 42, meta={"ino": 1, "head": None})
            assert ck.load("s") == 42

    def test_stale_tmp_is_dropped_and_commit_is_atomic(self, tmp_path):
        out = {}
        for k, m in MODS.items():
            path = str(tmp_path / f"{k}.json")
            ck = m.OffsetCheckpoint(path)
            ck.commit("a", 7)
            with open(path + ".tmp", "w") as fh:
                fh.write('{"a": 999}')
            out[k] = (ck.load("a"), os.path.exists(path + ".tmp"))
            ck.commit("b", 3)
            with open(path) as fh:
                out[k] += (json.load(fh),)
        assert out["t"] == out["j"] == (7, False, {"a": 7, "b": 3})


class TestMicroBatchReader:
    def test_batches_and_backpressure_targets_equal_reference(self):
        def run(m, fb, real):
            clock = iter(np.arange(0.0, 100.0, 0.7)).__next__
            feats = [fb.of("x", real).extract_field().as_predictor()]
            r = m.MicroBatchStreamingReader(
                m.ListSource([{"x": float(i)} for i in range(300)]),
                batch_interval=1.0, max_batch_records=64, min_batch_records=8,
                max_empty_polls=1, clock=clock, sleep=lambda s: None)
            out = []
            for ds in r.stream_datasets(feats):
                out.append((ds.n_rows, list(ds["x"].to_values())[:2],
                            r.progress["target_records"]))
            return out, r.progress

        assert run(TS, TFB, TReal) == run(JS, JFB, JReal)

    def test_commit_only_after_the_consumer_says_so(self):
        for m in MODS.values():
            src = m.ListSource([{"x": 1.0}] * 10)
            ck = {}

            class Mem:
                def load(self, sid, default=0):
                    return ck.get(sid, default)

                def load_meta(self, sid):
                    return None

                def commit(self, sid, off, meta=None):
                    ck[sid] = off

            r = m.MicroBatchStreamingReader(src, Mem(), batch_interval=0.0,
                                            max_batch_records=4,
                                            max_empty_polls=0,
                                            sleep=lambda s: None)
            seen = []
            for ds in r.stream_datasets([]):
                seen.append(dict(ck))
                if len(seen) == 2:
                    r.commit()
            assert seen == [{}, {}, {"list": 8}] and ck == {"list": 8}


# ---------------------------------------------------------------------------
# STREAMING_SCORE over the committed wide model
# ---------------------------------------------------------------------------

def _records(n, seed):
    import chip_smoke  # the serving phases' record maker (imports no JAX)

    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    return chip_smoke.make_records(schema, n, np.random.default_rng(seed))


def _stream(kind, events, offsets, out, batch=128):
    m, run, params, wf = (JS, J_run, JParams, JWorkflow) if kind == "j" \
        else (TS, T_run, TParams, TWorkflow)
    reader = m.MicroBatchStreamingReader(
        m.JsonlTailSource(events), checkpoint=m.OffsetCheckpoint(offsets),
        batch_interval=0.0, max_batch_records=batch, min_batch_records=batch,
        max_empty_polls=0, sleep=lambda s: None)
    runner = run.WorkflowRunner(workflow=wf(), streaming_reader=reader)
    return runner.run(run.RunType.STREAMING_SCORE, params(
        model_location=FIXTURE, write_location=out)), reader


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    events = str(d / "events.jsonl")
    _write(events, [json.dumps(r) + "\n" for r in _records(300, 5)])
    out = {"j": _stream("j", events, str(d / "j.offsets"), str(d / "j" / "s.csv"))}
    with use_device("cpu"):
        out["t"] = _stream("t", events, str(d / "t.offsets"), str(d / "t" / "s.csv"))
    return d, events, out


class TestStreamingScore:
    def test_batches_score_bitwise_like_the_jax_package(self, streamed):
        _, _, out = streamed
        (jres, _), (tres, _) = out["j"], out["t"]
        assert jres.metrics == tres.metrics == {"batches": 3}
        assert [b.n_rows for b in tres.scores] == [128, 128, 44]
        for jb, tb in zip(jres.scores, tres.scores):
            assert tb.names == jb.names
            pred = tb.names[-1]
            for part in ("pred", "raw", "prob"):
                a = np.asarray(getattr(jb[pred], part))
                b = np.asarray(getattr(tb[pred], part))
                assert b.tobytes() == a.tobytes(), part

    def test_offsets_commit_after_each_written_batch(self, streamed):
        d, events, out = streamed
        size = os.path.getsize(events)
        assert json.load(open(d / "t.offsets"))["jsonl:events.jsonl"] == size
        assert sorted(os.listdir(d / "t")) == [f"s_{i}.csv" for i in range(3)]
        _, reader = out["t"]
        assert reader.progress["records"] == 300
        # a restarted reader resumes at the file's end: nothing replayed
        r2 = TS.MicroBatchStreamingReader(
            TS.JsonlTailSource(events), TS.OffsetCheckpoint(str(d / "t.offsets")),
            batch_interval=0.0, max_empty_polls=0, sleep=lambda s: None)
        assert list(r2.stream_datasets([])) == []
        # appended records are the only ones a resumed run scores
        _write(events, [json.dumps(r) + "\n" for r in _records(5, 6)], mode="a")
        with use_device("cpu"):
            res, _ = _stream("t", events, str(d / "t.offsets"), str(d / "t2" / "s.csv"))
        assert [b.n_rows for b in res.scores] == [5]

    def test_written_batches_equal_the_jax_packages_files(self, tmp_path, streamed):
        d, _, out = streamed
        for i in range(3):
            assert (d / "t" / f"s_{i}.csv").read_bytes() \
                == (d / "j" / f"s_{i}.csv").read_bytes(), i
        (jres, _), (tres, _) = out["j"], out["t"]
        for m, res, name in ((J_run, jres, "j.json"), (T_run, tres, "t.json")):
            m._write_dataset(str(tmp_path / name), res.scores[0])
        assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()

    def test_no_write_location_commits_nothing(self, tmp_path, streamed):
        _, events, _ = streamed
        offsets = str(tmp_path / "o.json")
        reader = TS.MicroBatchStreamingReader(
            TS.JsonlTailSource(events), TS.OffsetCheckpoint(offsets),
            batch_interval=0.0, max_batch_records=512, max_empty_polls=0,
            sleep=lambda s: None)
        runner = T_run.WorkflowRunner(workflow=TWorkflow(), streaming_reader=reader)
        with use_device("cpu"):
            res = runner.run(T_run.RunType.STREAMING_SCORE,
                             TParams(model_location=FIXTURE))
        assert res.metrics["batches"] == 1 and not os.path.exists(offsets)

    def test_no_card_raises_instead_of_the_cpu(self, tmp_path, monkeypatch, streamed):
        _, events, _ = streamed
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        reader = TS.MicroBatchStreamingReader(
            TS.JsonlTailSource(events), batch_interval=0.0, max_empty_polls=0,
            sleep=lambda s: None)
        runner = T_run.WorkflowRunner(workflow=TWorkflow(), streaming_reader=reader)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runner.run(T_run.RunType.STREAMING_SCORE, TParams(model_location=FIXTURE))
