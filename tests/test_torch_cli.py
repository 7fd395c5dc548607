"""The port's operator CLI (``python -m transmogrifai_tpu_torch.cli``) against
the JAX package's, on the CPU and on the same files.

The reference's CLI tests, each run by both packages' ``cli`` (the port's
with ``--device cpu``) on the same inputs: ``gen`` (``test_runner_cli.py::
TestCliGen``, ``test_avro.py``'s gen tests: the generated files byte-equal
once the package name is swapped, the same schema and problem kind, the
port's project trained on the CPU), ``serve`` (``test_serve.py::
TestCliServe``, ``test_serve_faults.py::TestCliServeHardening``,
``test_runner_cli.py::TestCliServeFleet``, ``test_continual.py::
TestCliFollow``, ``test_obs.py::TestCliTelemetry``: served rows ``==`` the
JAX CLI's), ``top`` (``test_obs_requests.py``'s statusz stream,
``test_precision.py``'s precision column, ``test_serve_pipeline.py``'s
pipeline column: frames equal to the JAX console's on the same statusz) and
``train`` (``test_resilience.py::TestCliTrain``, plus a resumed run).  The
models are trained by the JAX package and loaded by both.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from transmogrifai_tpu import FeatureBuilder, Workflow, transmogrify
from transmogrifai_tpu.cli import gen as J_gen
from transmogrifai_tpu.cli import top as J_top
from transmogrifai_tpu.models.logistic import LogisticRegression
from transmogrifai_tpu.models.selector import BinaryClassificationModelSelector
from transmogrifai_tpu.readers.files import DataReaders
from transmogrifai_tpu.workflow.workflow import dedup_raw_features
from transmogrifai_tpu_torch import WorkflowModel as TModel
from transmogrifai_tpu_torch.cli import gen as T_gen
from transmogrifai_tpu_torch.cli import top as T_top
from transmogrifai_tpu_torch.workflow.continual import RefitController

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_stream_data as S  # noqa: E402

CPU = ["--device", "cpu"]
GEN = {"jax": J_gen, "torch": T_gen}

#: runs a generated project's main.py on the CPU (the port's entry points
#: otherwise run on the card), its arguments after ``--``
_RUN_ON_CPU = ("import runpy, sys; sys.argv = ['main.py'] + sys.argv[1:]; "
               "from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device\n"
               "with use_device('cpu'):\n"
               "    runpy.run_path('main.py', run_name='__main__')")


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _rows(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def _df(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n)
    c = rng.choice(["a", "b"], n)
    y = (rng.random(n) < 1 / (1 + np.exp(-(2 * x + (c == "a"))))).astype(float)
    return pd.DataFrame({"label": y, "x": x, "c": c})


def _project_files(out):
    return sorted(f for f in os.listdir(out) if not f.startswith("__"))


def _assert_projects_equal(j_out, t_out):
    """Every generated file of the port's project is the JAX package's with
    the package name swapped (the data file copied as is)."""
    assert _project_files(j_out) == _project_files(t_out)
    for name in _project_files(j_out):
        with open(os.path.join(j_out, name), "rb") as fh:
            want = fh.read()
        if not name.endswith((".csv", ".avro")):
            want = want.replace(b"transmogrifai_tpu", b"transmogrifai_tpu_torch")
        with open(os.path.join(t_out, name), "rb") as fh:
            assert fh.read() == want, name


def _generate_both(tmp_path, data, response="label", **kw):
    out = {}
    for pkg, mod in GEN.items():
        proj, kind = mod.generate_project(data, response, str(tmp_path / f"proj_{pkg}"),
                                          **kw)
        out[pkg] = (proj, kind.value)
    assert out["jax"][1] == out["torch"][1]
    _assert_projects_equal(out["jax"][0], out["torch"][0])
    return out["torch"][0], out["torch"][1]


def _train_project_on_cpu(proj, tmp_path):
    r = subprocess.run(
        [sys.executable, "-c", _RUN_ON_CPU, "--run-type", "train",
         "--model-location", str(tmp_path / "m"),
         "--metrics-location", str(tmp_path / "metrics.json")],
        cwd=proj, env=_env(), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(str(tmp_path / "metrics.json"))


class TestCliGen:
    def test_generate_and_run_project(self, tmp_path):
        csv = str(tmp_path / "data.csv")
        _df(150, seed=3).to_csv(csv, index=False)
        for mod in GEN.values():
            assert mod.detect_problem_kind(csv, "label").value == "binary"
        assert T_gen.infer_schema(csv) == J_gen.infer_schema(csv)
        proj, kind = _generate_both(tmp_path, csv, name="my-test-app")
        assert kind == "binary"
        for f in ("main.py", "README.md", "test_project.py"):
            assert os.path.exists(os.path.join(proj, f))
        # the generated project trains end to end (on the CPU here)
        _train_project_on_cpu(proj, tmp_path)

    def test_regression_detection(self, tmp_path):
        csv = str(tmp_path / "r.csv")
        pd.DataFrame({"y": np.random.default_rng(0).normal(0, 1, 100),
                      "x": range(100)}).to_csv(csv, index=False)
        assert [m.detect_problem_kind(csv, "y").value for m in GEN.values()] \
            == ["regression"] * 2

    def test_multiclass_detection(self, tmp_path):
        csv = str(tmp_path / "m.csv")
        pd.DataFrame({"y": [0, 1, 2] * 30, "x": range(90)}).to_csv(csv, index=False)
        assert [m.detect_problem_kind(csv, "y").value for m in GEN.values()] \
            == ["multiclass"] * 2

    def test_string_label_detection(self, tmp_path):
        csv = str(tmp_path / "s.csv")
        pd.DataFrame({"y": ["cat", "dog", "bird"] * 30,
                      "x": range(90)}).to_csv(csv, index=False)
        assert [m.detect_problem_kind(csv, "y").value for m in GEN.values()] \
            == ["multiclass"] * 2

    def test_string_label_project_trains(self, tmp_path):
        """String-labeled response: the generator label-encodes (the same
        LABELS as the JAX package's project), and the project trains."""
        rng = np.random.default_rng(7)
        x = rng.normal(size=120)
        df = pd.DataFrame({
            "x": x,
            "z": rng.normal(size=120),
            "label": np.where(x + 0.3 * rng.normal(size=120) > 0, "yes", "no"),
        })
        csv = str(tmp_path / "s.csv")
        df.to_csv(csv, index=False)
        proj, kind = _generate_both(tmp_path, csv)
        assert kind == "binary"
        assert "LABELS = {'no': 0.0, 'yes': 1.0}" in open(
            os.path.join(proj, "main.py")).read()
        _train_project_on_cpu(proj, tmp_path)

    def test_bad_response_rejected(self, tmp_path):
        csv = str(tmp_path / "d.csv")
        _df(50).to_csv(csv, index=False)
        for pkg, mod in GEN.items():
            with pytest.raises(ValueError, match="response"):
                mod.generate_project(csv, "nope", str(tmp_path / f"p_{pkg}"))

    def test_cli_gen_subcommand(self, tmp_path, capsys):
        csv = str(tmp_path / "data.csv")
        _df(60, seed=1).to_csv(csv, index=False)
        for pkg, mod in GEN.items():
            assert mod.main(["gen", "--input", csv, "--response", "label",
                             "--output", str(tmp_path / f"cli_{pkg}"),
                             "--name", "CliApp", "--id", "c"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out == [f"Generated binary project at {tmp_path / 'cli_jax'}",
                       f"Generated binary project at {tmp_path / 'cli_torch'}"]
        _assert_projects_equal(str(tmp_path / "cli_jax"), str(tmp_path / "cli_torch"))


class TestAvscCli:
    AVSC = """{
      "type": "record", "name": "Passenger", "fields": [
        {"name": "id", "type": "string"},
        {"name": "label", "type": "double"},
        {"name": "x", "type": ["null", "double"]},
        {"name": "c", "type": ["null", "string"]}
      ]
    }"""

    def _data(self, n=150, seed=3):
        rng = np.random.default_rng(seed)
        x = rng.normal(0, 1, n)
        c = rng.choice(["a", "b"], n)
        y = (rng.random(n) < 1 / (1 + np.exp(-(2 * x + (c == "a"))))
             ).astype(float)
        return pd.DataFrame({"id": [f"r{i}" for i in range(n)],
                             "label": y, "x": x, "c": c})

    def test_gen_from_avsc_produces_typed_project(self, tmp_path):
        df = self._data()
        csv = str(tmp_path / "d.csv")
        df.to_csv(csv, index=False)
        avsc = str(tmp_path / "d.avsc")
        with open(avsc, "w") as fh:
            fh.write(self.AVSC)
        proj, kind = _generate_both(tmp_path, csv, name="avsc-app", id_column="id",
                                    schema_path=avsc)
        assert kind == "binary"
        main_py = open(os.path.join(proj, "main.py")).read()
        # types came from the .avsc (x typed Real via the union), not inference
        assert '"x": "Real"' in main_py
        assert '"id": "ID"' in main_py

    def test_gen_from_avro_input(self, tmp_path):
        """gen --input data.avro: the generated project reads Avro through
        DataReaders.Simple.avro, as the JAX package's does."""
        from transmogrifai_tpu_torch.readers.avro import dataframe_to_avro

        df = self._data()
        avro = str(tmp_path / "data.avro")
        dataframe_to_avro(df.drop(columns=["id"]), avro)
        proj, kind = _generate_both(tmp_path, avro, name="avro-app")
        assert "DataReaders.Simple.avro(DATA)" in open(
            os.path.join(proj, "main.py")).read()

    def test_avsc_missing_field_rejected(self, tmp_path):
        df = self._data().drop(columns=["c"])
        csv = str(tmp_path / "d.csv")
        df.to_csv(csv, index=False)
        avsc = str(tmp_path / "d.avsc")
        with open(avsc, "w") as fh:
            fh.write(self.AVSC)
        for pkg, mod in GEN.items():
            with pytest.raises(ValueError, match="absent"):
                mod.generate_project(csv, "label", str(tmp_path / f"p_{pkg}"),
                                     schema_path=avsc)


# ---------------------------------------------------------------------------
# serve: one model, a fleet, follow mode, telemetry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX-trained LR model (``test_serve_faults.py``'s) saved once, and
    its label-free records."""
    rng = np.random.default_rng(17)
    n = 240
    x1 = rng.normal(0, 1, n)
    color = rng.choice(["red", "green", "blue"], n)
    age = np.where(rng.random(n) < 0.15, None, rng.normal(40, 10, n))
    y = (rng.random(n) < 1 / (1 + np.exp(-(1.5 * x1 + (color == "red"))))).astype(float)
    records = [{"label": float(y[i]), "x1": float(x1[i]), "color": str(color[i]),
                "age": None if age[i] is None else float(age[i])} for i in range(n)]
    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    feats = [FeatureBuilder.Real("x1").extract_field().as_predictor(),
             FeatureBuilder.PickList("color").extract_field().as_predictor(),
             FeatureBuilder.Real("age").extract_field().as_predictor()]
    checked = label.sanity_check(transmogrify(feats))
    sel = BinaryClassificationModelSelector.with_train_validation_split(
        models=[(LogisticRegression(), [{"reg_param": 0.01}])])
    pred = label.transform_with(sel, checked)
    model = (Workflow().set_result_features(label, pred)
             .set_reader(DataReaders.Simple.dataframe(pd.DataFrame(records)))).train()
    root = tmp_path_factory.mktemp("served")
    model_dir = str(root / "model")
    model.save(model_dir)
    models = root / "models"
    for tenant in ("acme", "globex"):
        model.save(str(models / tenant))
    nolabel = [{k: v for k, v in r.items() if k != "label"} for r in records]
    return model_dir, models, nolabel


def _write_jsonl(path, lines):
    path.write_text("".join((ln if isinstance(ln, str) else json.dumps(ln)) + "\n"
                            for ln in lines))


def _serve_both(tmp_path, extra, records_file):
    """``cli serve`` of both packages on one records file; returns {pkg:
    (rc, rows, metrics)}."""
    got = {}
    for pkg, mod in GEN.items():
        out = tmp_path / f"scores_{pkg}.jsonl"
        metrics = tmp_path / f"metrics_{pkg}.json"
        rc = mod.main(["serve", "--records", str(records_file), "--output", str(out),
                       "--metrics-out", str(metrics), *extra]
                      + (CPU if pkg == "torch" else []))
        got[pkg] = (rc, _rows(out), json.loads(metrics.read_text()))
    return got


class TestCliServe:
    def test_cli_serve_smoke(self, served, tmp_path):
        model_dir, _, records = served
        rec_file = tmp_path / "records.jsonl"
        _write_jsonl(rec_file, records[:20])
        got = _serve_both(tmp_path, ["--model", model_dir, "--max-batch", "8",
                                     "--max-wait-ms", "1", "--min-bucket", "8",
                                     "--no-warm"], rec_file)
        rc, rows, metrics = got["torch"]
        assert rc == 0 and got["jax"][0] == 0
        assert len(rows) == 20
        plan = TModel.load(model_dir).serving_plan(device="cpu")
        assert rows == json.loads(json.dumps(plan.score(records[:20])))
        assert rows == got["jax"][1]
        assert metrics["batcher"]["completed"] == 20
        assert metrics["plan"]["scored_records"] >= 20

    def test_malformed_lines_and_poison_records(self, served, tmp_path, capsys):
        """Malformed JSONL lines are skipped-and-counted; a poison record
        emits an {"error": ...} line in its position; the replay finishes
        with a nonzero exit code, in both packages alike."""
        model_dir, _, records = served
        good = records[:5]
        lines = [json.dumps(r) for r in good[:3]]
        lines.append("{ this is not json")                    # malformed
        lines.append(json.dumps({"x1": "not-a-number", "color": "red", "age": 1.0}))
        lines.extend(json.dumps(r) for r in good[3:])
        rec_file = tmp_path / "records.jsonl"
        _write_jsonl(rec_file, lines)
        got = _serve_both(tmp_path, ["--model", model_dir, "--max-batch", "8",
                                     "--max-wait-ms", "1", "--min-bucket", "8",
                                     "--no-warm"], rec_file)
        rc, rows, metrics = got["torch"]
        assert rc != 0 and got["jax"][0] != 0
        assert len(rows) == 6  # 5 good + 1 error row; malformed line skipped
        err_rows = [r for r in rows if "error" in r]
        assert len(err_rows) == 1
        assert err_rows[0]["error_type"] == "PoisonRecordError"
        plan = TModel.load(model_dir).serving_plan(device="cpu")
        ok_rows = [r for r in rows if "error" not in r]
        assert ok_rows == json.loads(json.dumps(plan.score(good)))
        assert ok_rows == [r for r in got["jax"][1] if "error" not in r]
        assert [r.get("error_type") for r in rows] \
            == [r.get("error_type") for r in got["jax"][1]]
        for m in (metrics, got["jax"][2]):
            assert m["replay"]["skipped_malformed"] == 1
            assert m["replay"]["record_errors"] == 1
            assert m["resilience"]["quarantined"] == 1
        assert capsys.readouterr().err.count(
            "serve: skipping malformed JSONL line 4") == 2

    def test_clean_replay_exit_zero(self, served, tmp_path):
        model_dir, _, records = served
        rec_file = tmp_path / "records.jsonl"
        _write_jsonl(rec_file, records[:6])
        got = _serve_both(tmp_path, ["--model", model_dir, "--max-batch", "8",
                                     "--max-wait-ms", "1", "--no-warm"], rec_file)
        assert got["torch"][0] == got["jax"][0] == 0
        assert len(got["torch"][1]) == 6
        assert got["torch"][1] == got["jax"][1]


class TestCliServeFleet:
    """``cli serve --models DIR``: multi-model replay with a tenant column
    in the JSONL in/out contract."""

    def test_models_dir_round_trip(self, served, tmp_path):
        """Records route by their tenant column; every output row echoes
        the tenant back and per-tenant scores match the single-model
        serving plan."""
        _, models, records = served
        recs = records[:12]
        rec_file = tmp_path / "records.jsonl"
        _write_jsonl(rec_file, [{"tenant": ("acme" if i % 2 else "globex"), **r}
                                for i, r in enumerate(recs)])
        # warm stays ON: the second tenant shares the first's prefix
        got = _serve_both(tmp_path, ["--models", str(models), "--max-batch", "8",
                                     "--max-wait-ms", "1", "--min-bucket", "8"],
                          rec_file)
        rc, rows, metrics = got["torch"]
        assert rc == 0 and got["jax"][0] == 0
        assert len(rows) == 12
        assert [r["tenant"] for r in rows] == \
            [("acme" if i % 2 else "globex") for i in range(12)]
        plan = TModel.load(str(models / "acme")).serving_plan(device="cpu")
        expected = json.loads(json.dumps(plan.score(recs)))
        assert [{k: v for k, v in r.items() if k != "tenant"} for r in rows] == expected
        assert rows == got["jax"][1]
        for m in (metrics, got["jax"][2]):
            assert sorted(m["tenants"]) == ["acme", "globex"]
            assert m["replay"]["tenants"] == ["acme", "globex"]
            assert m["replay"]["record_errors"] == 0
            assert m["tenants"]["acme"]["scored_records"] == 6
            assert m["tenants"]["globex"]["scored_records"] == 6
            assert m["fleet"]["shared_prefix_registrations"] == 1

    def test_models_dir_unknown_tenant_is_error_row(self, served, tmp_path):
        _, models, _ = served
        rec_file = tmp_path / "records.jsonl"
        _write_jsonl(rec_file, [{"tenant": "acme", "x1": 0.5, "color": "red"},
                                {"x1": 0.5, "color": "red"},            # no tenant
                                {"tenant": "nope", "x1": 0.5, "color": "red"}])
        got = _serve_both(tmp_path, ["--models", str(models), "--max-batch", "4",
                                     "--max-wait-ms", "1", "--no-warm"], rec_file)
        rc, rows, _ = got["torch"]
        assert rc != 0 and got["jax"][0] != 0
        assert len(rows) == 3
        assert "error" not in rows[0] and rows[0]["tenant"] == "acme"
        assert rows[1]["error_type"] == "UnknownTenantError"
        assert rows[2]["error_type"] == "UnknownTenantError"
        assert rows[2]["tenant"] == "nope"
        assert rows[0] == got["jax"][1][0]
        assert [r.get("error_type") for r in rows] \
            == [r.get("error_type") for r in got["jax"][1]]

    def test_model_and_models_are_mutually_exclusive(self, served, tmp_path):
        _, models, _ = served
        rec_file = tmp_path / "r.jsonl"
        _write_jsonl(rec_file, [{"tenant": "acme", "x1": 1.0, "color": "red"}])
        for mod in GEN.values():
            with pytest.raises(SystemExit, match="mutually exclusive"):
                mod.main(["serve", "--model", str(models / "acme"),
                          "--models", str(models), "--records", str(rec_file)])
            with pytest.raises(SystemExit, match="one of --model or --models"):
                mod.main(["serve", "--records", str(rec_file)])
            with pytest.raises(SystemExit, match="single-model only"):
                mod.main(["serve", "--models", str(models), "--follow",
                          "--records", str(rec_file)])


@pytest.fixture(scope="module")
def stream_base(tmp_path_factory):
    """``test_continual.py``'s base model (trained by the JAX package) and
    its train-time snapshot, saved once."""
    import types

    from transmogrifai_tpu.workflow import continual as J_continual
    from transmogrifai_tpu.readers.base import rows_to_dataset

    pkg = types.SimpleNamespace(
        FeatureBuilder=FeatureBuilder, transmogrify=transmogrify,
        BinaryClassificationModelSelector=BinaryClassificationModelSelector,
        LogisticRegression=LogisticRegression, Workflow=Workflow,
        rows_to_dataset=rows_to_dataset, dedup_raw_features=dedup_raw_features,
        continual=J_continual)
    model, _raws, _train_ds, snap = S.continual_base(pkg, {})
    root = tmp_path_factory.mktemp("stream")
    model_dir = str(root / "model")
    model.save(model_dir)
    baseline = str(root / "baseline.json")
    snap.save(baseline)
    return model_dir, baseline


class TestCliFollow:
    def test_follow_refit_end_to_end(self, stream_base, tmp_path):
        """`cli serve --follow --refit` drives the streaming reader end to
        end: tailed JSONL in, scored JSONL out, offsets committed, drift ->
        refit -> promotion recorded, checkpoint CURRENT written; the refit
        runs on the CPU with no kernel build."""
        model_dir, baseline = stream_base
        # two drift segments (+3 then -3): the post-promotion rebase must
        # re-arm the detector AND the rebased RefitController must keep its
        # checkpoint_dir across generations
        records = S.make_records(512, 51, shift=3.0) + S.make_records(512, 53, shift=-3.0)
        stream = tmp_path / "stream.jsonl"
        _write_jsonl(stream, records)
        out_file = tmp_path / "scores.jsonl"
        metrics_file = tmp_path / "metrics.json"
        offsets = str(tmp_path / "offsets.json")
        ckpt_dir = str(tmp_path / "ckpts")
        rc = T_gen.main(["serve", "--model", model_dir,
                         "--records", str(stream),
                         "--output", str(out_file),
                         "--metrics-out", str(metrics_file),
                         "--follow", "--refit",
                         "--offsets", offsets,
                         "--baseline", baseline,
                         "--batch-interval", "0",
                         "--max-empty-polls", "1",
                         "--max-batch-records", "128",
                         "--drift-min-records", "128",
                         "--window-records", str(S.N_TRAIN),
                         "--shadow-records", "64",
                         "--probation-batches", "2",
                         "--checkpoint-dir", ckpt_dir,
                         "--max-wait-ms", "1", *CPU])
        assert rc == 0
        rows = _rows(out_file)
        assert len(rows) == len(records)
        assert not any("error" in r for r in rows)
        metrics = json.loads(metrics_file.read_text())
        assert metrics["refits"] >= 2
        assert metrics["promotions"] >= 2
        assert metrics["last_refit"]["backend_compiles"] == 0
        assert metrics["server"]["swap"]["swaps"] >= 2
        committed = json.load(open(offsets))
        assert committed["jsonl:stream.jsonl"] == stream.stat().st_size
        with open(os.path.join(ckpt_dir, "CURRENT")) as fh:
            current = fh.read().strip()
        assert current.startswith("model-")
        assert int(current.split("-")[1]) <= metrics["refits"]
        assert os.path.isdir(os.path.join(ckpt_dir, "model-0001"))
        RefitController.load_checkpoint(ckpt_dir)
        # the first drift segment's head, before any refit, scored by the
        # base model: the rows the JAX package's plan gives those records
        from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel

        head = [{k: v for k, v in r.items()} for r in records[:128]]
        want = JModel.load(model_dir).serving_plan().score(head)
        assert rows[:128] == json.loads(json.dumps(want, default=str))

    def test_follow_without_refit_streams_and_commits(self, stream_base, tmp_path):
        model_dir, _ = stream_base
        records = S.make_records(64, 52)
        got = {}
        for pkg, mod in GEN.items():
            stream = tmp_path / f"s2_{pkg}.jsonl"
            _write_jsonl(stream, records)
            out_file = tmp_path / f"o2_{pkg}.jsonl"
            offsets = str(tmp_path / f"off2_{pkg}.json")
            args = ["serve", "--model", model_dir, "--records", str(stream),
                    "--output", str(out_file), "--metrics-out",
                    str(tmp_path / f"m2_{pkg}.json"), "--follow",
                    "--offsets", offsets, "--batch-interval", "0",
                    "--max-empty-polls", "1", "--max-wait-ms", "1"] \
                + (CPU if pkg == "torch" else [])
            assert mod.main(args) == 0
            assert len(out_file.read_text().splitlines()) == len(records)
            assert json.load(open(offsets))[f"jsonl:s2_{pkg}.jsonl"] \
                == stream.stat().st_size
            # resume: a second run with committed offsets scores nothing new
            # and must NOT truncate the already-written output
            assert mod.main(args) == 0
            got[pkg] = _rows(out_file)
            assert len(got[pkg]) == len(records)
        assert got["torch"] == got["jax"]


class TestCliTelemetry:
    def test_cli_serve_telemetry_artifacts(self, stream_base, tmp_path):
        """The Chrome-trace export of a ``cli serve`` replay is structurally
        valid, spans nest across batcher worker threads, and the artifacts
        are the JAX CLI's."""
        from test_torch_obs import nesting_violations

        model_dir, _ = stream_base
        records = [{k: v for k, v in r.items() if k != "label"}
                   for r in S.make_records(48, 7)]
        stream = tmp_path / "r.jsonl"
        _write_jsonl(stream, records)
        outs = {}
        for pkg, mod in GEN.items():
            teldir = tmp_path / f"tel_{pkg}"
            rc = mod.main(["serve", "--model", model_dir, "--records", str(stream),
                           "--output", str(tmp_path / f"out_{pkg}.jsonl"),
                           "--metrics-out", str(tmp_path / f"m_{pkg}.json"),
                           "--min-bucket", "1", "--telemetry", str(teldir)]
                          + (CPU if pkg == "torch" else []))
            assert rc == 0
            assert sorted(os.listdir(teldir)) == [
                "flight.json", "metrics.jsonl", "metrics.prom", "trace.json"]
            outs[pkg] = _rows(tmp_path / f"out_{pkg}.jsonl")
        teldir = tmp_path / "tel_torch"
        evs = json.load(open(teldir / "trace.json"))["traceEvents"]
        xs = [e for e in evs if e.get("ph") == "X"]
        assert xs, "no complete events in the trace"
        for e in xs:
            assert e["ts"] >= 0 and e["dur"] >= 0
            assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert {"serve.flush", "serve.encode", "serve.device",
                "serve.host"} <= {e["name"] for e in xs}
        names = {m["args"]["name"] for m in evs if m.get("ph") == "M"
                 and m["name"] == "thread_name"}
        assert any("microbatcher" in n for n in names), names
        assert nesting_violations(evs) == []
        fl = json.load(open(teldir / "flight.json"))
        assert fl["unexpected_compiles"] == 0
        prom = (teldir / "metrics.prom").read_text()
        assert "tmog_serve_batcher_submitted_total" in prom
        line = json.loads((teldir / "metrics.jsonl").read_text().splitlines()[-1])
        assert line["source"] == "cli serve"
        # scores are unaffected by telemetry, and are the JAX CLI's
        assert len(outs["torch"]) == len(records)
        assert outs["torch"] == outs["jax"]

    def test_follow_snapshot_lines(self, stream_base, tmp_path):
        """``--follow --snapshot-interval`` emits periodic metrics-snapshot
        JSONL lines while scores and offsets stay as without them."""
        model_dir, _ = stream_base
        records = S.make_records(64, 9)
        stream = tmp_path / "s.jsonl"
        _write_jsonl(stream, records)
        snaps = tmp_path / "snapshots.jsonl"
        offsets = str(tmp_path / "off.json")
        out_file = tmp_path / "o.jsonl"
        rc = T_gen.main(["serve", "--model", model_dir, "--records", str(stream),
                         "--output", str(out_file),
                         "--metrics-out", str(tmp_path / "m.json"),
                         "--follow", "--offsets", offsets,
                         "--batch-interval", "0", "--max-empty-polls", "1",
                         "--max-batch-records", "16", "--max-wait-ms", "1",
                         "--snapshot-interval", "0",
                         "--snapshots-out", str(snaps), *CPU])
        assert rc == 0
        lines = [json.loads(ln) for ln in snaps.read_text().splitlines()]
        assert len(lines) >= 4  # one per 16-record batch
        for ln in lines:
            assert ln["type"] == "metrics_snapshot"
            assert "tmog_serve_batcher_submitted_total" in ln["metrics"]
            assert "continual" in ln
        assert len(out_file.read_text().splitlines()) == len(records)
        committed = json.load(open(offsets))
        assert committed["jsonl:s.jsonl"] == stream.stat().st_size
        metrics = json.loads((tmp_path / "m.json").read_text())
        assert metrics["metrics_snapshots_emitted"] == len(lines)

    def test_tmog_telemetry_env_switch(self, stream_base, tmp_path, monkeypatch):
        """The TMOG_TELEMETRY env var enables the same artifacts with no CLI
        flag (and resolve_telemetry defers when already active)."""
        from transmogrifai_tpu_torch.obs import Telemetry, resolve_telemetry

        model_dir, _ = stream_base
        records = [{k: v for k, v in r.items() if k != "label"}
                   for r in S.make_records(8, 11)]
        stream = tmp_path / "e.jsonl"
        _write_jsonl(stream, records)
        teldir = tmp_path / "envtel"
        monkeypatch.setenv("TMOG_TELEMETRY", str(teldir))
        rc = T_gen.main(["serve", "--model", model_dir, "--records", str(stream),
                         "--output", str(tmp_path / "eo.jsonl"),
                         "--metrics-out", str(tmp_path / "em.json"), *CPU])
        assert rc == 0
        assert (teldir / "trace.json").exists()
        assert (teldir / "flight.json").exists()
        tel = Telemetry().start()
        try:
            assert resolve_telemetry(None) is None
        finally:
            tel.stop()


# ---------------------------------------------------------------------------
# top
# ---------------------------------------------------------------------------

class TestCliTop:
    def test_statusz_stream_and_cli_top(self, served, tmp_path, capsys):
        """``cli serve --models --statusz-out`` writes the stream ``cli top``
        renders; the port's frame is the JAX console's on the same line."""
        _, models, records = served
        rec_file = tmp_path / "records.jsonl"
        _write_jsonl(rec_file, [{"tenant": ("acme" if i % 2 else "globex"), **r}
                                for i, r in enumerate(records[:48])])
        statusz = tmp_path / "status.jsonl"
        rc = T_gen.main(["serve", "--models", str(models), "--records", str(rec_file),
                         "--output", str(tmp_path / "o.jsonl"),
                         "--metrics-out", str(tmp_path / "m.json"),
                         "--max-batch", "8", "--max-wait-ms", "1", "--no-warm",
                         "--statusz-out", str(statusz), *CPU])
        assert rc == 0
        lines = [json.loads(ln) for ln in statusz.read_text().splitlines() if ln.strip()]
        assert lines, "the replay emitted no statusz lines"
        last = lines[-1]
        assert set(last["tenants"]) == {"acme", "globex"}
        assert last["fleet"]["slo_monitor_armed"] is True
        row = last["tenants"]["acme"]
        assert row["completed"] == 24
        assert row["device_seconds"] > 0
        assert row["budget_remaining"] is not None
        capsys.readouterr()
        frames = {}
        for pkg, mod in GEN.items():
            assert mod.main(["top", "--statusz", str(statusz), "--once",
                             "--no-clear"]) == 0
            frames[pkg] = capsys.readouterr().out
        assert frames["torch"] == frames["jax"]
        assert frames["torch"].rstrip("\n") == T_top.format_statusz(last)
        assert "acme" in frames["torch"] and "globex" in frames["torch"]
        assert "TENANT" in frames["torch"] and "BUDGET" in frames["torch"]

    def test_top_renders_precision_column(self):
        status = {"ts": 0, "fleet": {"tenants": 2},
                  "tenants": {
                      "full": {"slo": "gold", "precision": "f32", "rps": 10.0,
                               "device_seconds": 0.0},
                      "quant": {"slo": "bronze", "precision": "bf16", "rps": 9.0,
                                "device_seconds": 0.0}}}
        frame = T_top.format_statusz(status)
        assert frame == J_top.format_statusz(status)
        header, full_row, quant_row = frame.splitlines()[1:4]
        assert "PREC" in header
        assert "f32" in full_row and "bf16" in quant_row
        # a pre-precision statusz stream still renders (defaults to f32)
        legacy = {"ts": 0, "fleet": {},
                  "tenants": {"old": {"slo": "gold", "device_seconds": 0.0}}}
        assert "f32" in T_top.format_statusz(legacy).splitlines()[2]
        assert T_top.format_statusz(legacy) == J_top.format_statusz(legacy)

    def test_fleet_statusz_and_top_render_pipeline(self, served):
        from transmogrifai_tpu_torch.serve import FleetServer

        model_dir, _, records = served
        model = TModel.load(model_dir)
        ref = model.serving_plan(device="cpu").score(records[:32])
        with FleetServer(max_batch=32, max_wait_ms=1.0, min_bucket=8, max_bucket=32,
                         pipeline_depth=2, device="cpu") as fleet:
            fleet.register("t", model)
            futs = [fleet.submit("t", r) for r in records[:32]]
            out = [f.result(timeout=60) for f in futs]
            status = fleet.statusz()
        assert out == ref
        assert status["fleet"]["pipeline_depth"] == 2
        assert 0.0 <= status["fleet"]["pipeline_overlap"] <= 1.0
        assert status["fleet"]["pipeline_stalls"] >= 0
        frame = T_top.format_statusz(status)
        assert "pipe=2@" in frame
        assert frame == J_top.format_statusz(status)

    def test_top_waits_for_a_stream_and_bounds_its_frames(self, tmp_path, capsys):
        missing = str(tmp_path / "none.jsonl")
        assert T_gen.main(["top", "--statusz", missing, "--frames", "2",
                           "--interval", "0.01", "--no-clear"]) == 0
        out = capsys.readouterr().out
        assert out.count("top: waiting for statusz lines") == 2


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

#: ``cli train`` (its arguments after ``-c``) SIGKILLed at the second
#: gather of its sweep, after the first family's journal commit
_KILLED_TRAIN = (
    "import os, signal, sys\n"
    "from transmogrifai_tpu_torch.serve.faults import FaultHarness\n"
    "from transmogrifai_tpu_torch.cli import main\n"
    "kill = lambda ctx: os.kill(os.getpid(), signal.SIGKILL)\n"
    "with FaultHarness(seed=0).script('device_sync', [None, kill]):\n"
    "    main(sys.argv[1:])\n"
    "raise SystemExit('unreachable: SIGKILL should have landed')\n")


def _cli_train(pkg, csv, model_dir, ckpt):
    module = "transmogrifai_tpu_torch.cli" if pkg == "torch" else "transmogrifai_tpu.cli"
    proc = subprocess.run(
        [sys.executable, "-m", module, "train", "--input", str(csv),
         "--response", "label", "--model-location", str(model_dir),
         "--resume", str(ckpt), "--format", "json"]
        + (CPU if pkg == "torch" else []),
        capture_output=True, text=True, env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


class TestCliTrain:
    @pytest.fixture(scope="class")
    def csv(self, tmp_path_factory):
        rng = np.random.default_rng(0)
        n = 200
        x = rng.normal(0, 1, n)
        y = (rng.random(n) < 1 / (1 + np.exp(-2 * x))).astype(float)
        path = tmp_path_factory.mktemp("train") / "data.csv"
        pd.DataFrame({"label": y, "x": x}).to_csv(path, index=False)
        return path

    def test_cli_train_resume_reports_journal_counters(self, csv, tmp_path):
        got = {pkg: _cli_train(pkg, csv, tmp_path / f"model_{pkg}", tmp_path / f"ckpt_{pkg}")
               for pkg in ("jax", "torch")}
        payload = got["torch"]
        assert payload["kind"] == "binary" == got["jax"]["kind"]
        assert payload["journal"]["commits"] >= 1
        assert payload["journal"]["entries"] >= 1
        assert payload["journal"]["entries"] == got["jax"]["journal"]["entries"]
        assert payload["bestModel"] == got["jax"]["bestModel"]
        assert os.path.isdir(tmp_path / "model_torch")
        assert os.path.exists(tmp_path / "ckpt_torch" / "sweep_journal.json")
        # the port's saved model loads in both packages
        from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel

        JModel.load(str(tmp_path / "model_torch"))

    def test_killed_train_resumes_from_the_journal(self, csv, tmp_path):
        """A ``cli train --resume`` SIGKILLed at its second gather (after its
        first journal commit), run again with the same dir, replays the
        committed block from the journal and ends with the uninterrupted
        run's model: winner and CV metrics bitwise."""
        import signal

        from transmogrifai_tpu_torch.cli.train import build_auto_workflow

        whole = _cli_train("torch", csv, tmp_path / "m0", tmp_path / "ckpt0")
        killed = subprocess.run(
            [sys.executable, "-c", _KILLED_TRAIN, "train", "--input", str(csv),
             "--response", "label", "--model-location", str(tmp_path / "m1"),
             "--resume", str(tmp_path / "ckpt1"), *CPU],
            capture_output=True, text=True, env=_env(), timeout=600)
        assert killed.returncode == -signal.SIGKILL, killed.stderr[-3000:]
        with open(tmp_path / "ckpt1" / "sweep_journal.json") as fh:
            assert json.load(fh)
        again = _cli_train("torch", csv, tmp_path / "m1", tmp_path / "ckpt1")
        assert again["journal"]["hits"] >= 1
        assert again["bestModel"] == whole["bestModel"]
        s0 = TModel.load(str(tmp_path / "m0")).summary()
        s1 = TModel.load(str(tmp_path / "m1")).summary()
        assert s1.to_dict() == s0.to_dict()
        _wf, kind = build_auto_workflow(str(csv), "label")
        assert kind.value == "binary"
