"""``python -m transmogrifai_tpu_torch.cli lint`` and the port's lint gate:
the JAX package's ``tests/test_runner_cli.py::TestCliLintJsonRoundTrip``
and ``TestLintGate`` on the port, every flag of the reference's parser, and
the runs the card repeats (the port's own sources with the widest rule set;
the committed serving model under an HBM budget).

The lint runs in this process through ``cli.gen.main`` (the command's one
entry point); the gate runs ``cli lint`` as its child process, as its
contract has it.  Hazard sources are written for torch (``torch.sum`` where
the reference's use ``jnp.sum``).
"""

import argparse
import json
import os
import sys

import pytest

from transmogrifai_tpu_torch.cli import UNPORTED
from transmogrifai_tpu_torch.cli.gen import main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING_WIDE = os.path.join(REPO_ROOT, "transmogrifai_tpu_torch", "fixtures",
                            "serving_wide")

_HAZARD_SOURCE = '''\
import torch


class Sneaky:
    def transform_columns(self, cols, dataset):
        x = torch.as_tensor(cols[0].data)
        return float(torch.sum(x))  # blocking host sync -> TM301
'''

_JSONL_DIAGNOSTIC_KEYS = {"code", "severity", "stageUid", "location",
                          "message", "fixHint"}
_JSONL_PLAN_COST_KEYS = {"plan", "totalFlops", "totalBytes", "peakHbmBytes",
                         "buckets", "segments", "recompileHazards",
                         "collectives", "orderSensitiveOps", "mesh", "notes"}
_JSONL_IR_DIFF_KEYS = {"compared", "changed", "skipped", "counts",
                       "goldenTorchVersion", "currentTorchVersion",
                       "goldenPlatform", "currentPlatform"}


def code_paths():
    """``--path`` arguments for the package's code: every entry holding
    Python source but ``fixtures/``."""
    pkg = os.path.join(REPO_ROOT, "transmogrifai_tpu_torch")
    out = []
    for name in sorted(os.listdir(pkg)):
        p = os.path.join(pkg, name)
        if name == "fixtures" or name == "__pycache__":
            continue
        if name.endswith(".py") or (os.path.isdir(p) and any(
                f.endswith(".py") for _r, _d, fs in os.walk(p) for f in fs)):
            out += ["--path", p]
    return out


def _lint(capsys, *args):
    capsys.readouterr()
    rc = main(["lint", *args])
    return rc, capsys.readouterr().out


class TestCliLintJsonRoundTrip:
    """Every ``--format json`` line — diagnostic, planCostReport and
    irDiff — parses as one JSON object and carries its documented keys."""

    def test_all_three_line_types_round_trip(self, tmp_path, capsys):
        p = tmp_path / "sneaky.py"
        p.write_text(_HAZARD_SOURCE)
        rc, out = _lint(capsys, "--path", str(p), "--ir", "--ir-family",
                        "models.linear", "--format", "json")
        assert rc == 1, out  # TM301 >= warning
        lines = out.strip().splitlines()
        kinds = {"diagnostic": 0, "planCostReport": 0, "irDiff": 0}
        for ln in lines:
            obj = json.loads(ln)
            assert isinstance(obj, dict)
            if "planCostReport" in obj:
                kinds["planCostReport"] += 1
                assert _JSONL_PLAN_COST_KEYS <= set(obj["planCostReport"])
            elif "irDiff" in obj:
                kinds["irDiff"] += 1
                assert _JSONL_IR_DIFF_KEYS <= set(obj["irDiff"])
            else:
                kinds["diagnostic"] += 1
                assert _JSONL_DIAGNOSTIC_KEYS <= set(obj), obj
        assert kinds["irDiff"] == 1 and kinds["diagnostic"] >= 1
        assert "TM301" in [json.loads(ln).get("code") for ln in lines]

    def test_ir_diff_line_reports_clean_corpus(self, capsys):
        rc, out = _lint(capsys, "--ir", "--ir-family", "models.linear",
                        "--format", "json")
        assert rc == 0, out
        lines = [json.loads(ln) for ln in out.strip().splitlines()]
        ir = [ln["irDiff"] for ln in lines if "irDiff" in ln]
        assert len(ir) == 1
        assert ir[0]["compared"] == 1 and ir[0]["changed"] == []
        assert not [ln for ln in lines if "code" in ln]

    def test_legacy_json_array_carries_ir_diff_element(self, capsys):
        rc, out = _lint(capsys, "--ir", "--ir-family", "models.linear", "--json")
        assert rc == 0, out
        blob = json.loads(out)
        assert isinstance(blob, list)
        ir = [el["irDiff"] for el in blob if "irDiff" in el]
        assert len(ir) == 1 and _JSONL_IR_DIFF_KEYS <= set(ir[0])

    def test_plan_cost_line_keys(self, tmp_path, capsys, monkeypatch):
        (tmp_path / "jsondemo.py").write_text(
            "from transmogrifai_tpu_torch import FeatureBuilder, Workflow, transmogrify\n"
            "\n\ndef build():\n"
            "    a = FeatureBuilder.Real('a').extract_field().as_predictor()\n"
            "    return Workflow().set_result_features(transmogrify([a]))\n")
        monkeypatch.syspath_prepend(str(tmp_path))
        rc, out = _lint(capsys, "--workflow", "jsondemo:build", "--cost",
                        "--format", "json", "--fail-on", "error")
        assert rc == 0, out
        lines = [json.loads(ln) for ln in out.strip().splitlines()]
        reports = [ln["planCostReport"] for ln in lines if "planCostReport" in ln]
        assert len(reports) == 1 and _JSONL_PLAN_COST_KEYS <= set(reports[0])


class TestLintGate:
    """tools/torch_lint_gate.py: rc flips only on NEW errors — infos and
    warnings never gate; baselined errors pass; --update-baseline."""

    @pytest.fixture(autouse=True)
    def _env(self, monkeypatch, capsys):
        monkeypatch.setenv("PYTHONPATH", REPO_ROOT)
        monkeypatch.syspath_prepend(os.path.join(REPO_ROOT, "tools"))
        import torch_lint_gate

        self.gate, self.capsys = torch_lint_gate, capsys

    def _run(self, *args):
        self.capsys.readouterr()
        try:
            rc = self.gate.main(list(args))
            msg = ""
        except SystemExit as e:
            rc, msg = 1, str(e)
        out = self.capsys.readouterr()
        return rc, out.out, out.err + msg

    def test_warnings_never_flip_rc(self, tmp_path):
        p = tmp_path / "warn.py"
        p.write_text(_HAZARD_SOURCE)  # TM301 warning
        rc, out, err = self._run("--baseline", str(tmp_path / "b.json"),
                                 "--", "--path", str(p))
        assert rc == 0, out + err
        assert "never gates" in out

    def test_lint_crash_is_not_green(self, tmp_path):
        rc, out, err = self._run("--baseline", str(tmp_path / "b.json"),
                                 "--", "--model", str(tmp_path / "nope"))
        assert rc != 0, out + err
        assert "refusing to report OK" in err

    def test_new_error_fails_then_baseline_passes(self, tmp_path):
        (tmp_path / "bad.py").write_text("def broken(:\n")  # TM305 error
        baseline = str(tmp_path / "b.json")
        rc, out, err = self._run("--baseline", baseline, "--", "--path", str(tmp_path))
        assert rc == 1 and "NEW error" in out, out + err
        rc, out, err = self._run("--baseline", baseline, "--update-baseline",
                                 "--", "--path", str(tmp_path))
        assert rc == 0, out + err
        rc, out, err = self._run("--baseline", baseline, "--", "--path", str(tmp_path))
        assert rc == 0 and "known error" in out, out + err


def _lint_options(parser_adder) -> dict:
    ap = argparse.ArgumentParser()
    parser_adder(ap.add_subparsers(dest="command"))
    lint = ap._subparsers._group_actions[0].choices["lint"]
    return {tuple(a.option_strings): (a.dest, a.default, type(a).__name__)
            for a in lint._actions if a.option_strings}


class TestCommand:
    def test_every_flag_of_the_reference_parser(self):
        from transmogrifai_tpu.cli.lint import add_lint_parser as j_add
        from transmogrifai_tpu_torch.cli.lint import add_lint_parser as t_add

        assert _lint_options(t_add) == _lint_options(j_add)
        assert UNPORTED == ()

    def test_no_target_refuses(self, capsys):
        with pytest.raises(SystemExit, match="nothing to lint"):
            main(["lint"])

    def test_the_port_s_own_sources_lint_clean_with_every_rule(self, capsys):
        """The card's first lint child: every function of the package's
        code, the TM306 rule and the whole-program TM31x analyzer, exit 0.
        ``fixtures/`` is data, not the port's code: the JAX package's
        committed outputs, among them the standalone bundle's generated
        numpy scorer, which must stay byte-equal to the reference's."""
        rc, out = _lint(capsys, *code_paths(), "--all-functions", "--concurrency",
                        "--threads")
        assert rc == 0, out
        assert "Thread model:" in out and "MicroBatcher._run" in out

    def test_serving_model_hbm_budget(self, capsys):
        """The card's second lint child: the committed serving model under
        a generous budget exits 0 with its plan cost; under half its own
        static estimate it exits 1 with TM601."""
        rc, out = _lint(capsys, "--model", SERVING_WIDE, "--serving", "--cost",
                        "--hbm-budget", str(80e9), "--format", "json")
        assert rc == 0, out
        lines = [json.loads(ln) for ln in out.strip().splitlines()]
        cost = next(ln["planCostReport"] for ln in lines if "planCostReport" in ln)
        half = cost["peakHbmBytes"] / 2
        rc, out = _lint(capsys, "--model", SERVING_WIDE, "--serving", "--cost",
                        "--hbm-budget", str(half), "--format", "json")
        assert rc == 1
        assert "TM601" in [json.loads(ln).get("code") for ln in out.strip().splitlines()]

    def test_host_budget_needs_rows(self, capsys):
        with pytest.raises(SystemExit, match="--rows"):
            main(["lint", "--model", SERVING_WIDE, "--host-budget", "1000000"])

    def test_update_goldens_refreshes_a_corpus_copy(self, tmp_path, capsys):
        import shutil

        from transmogrifai_tpu_torch.checkers.irsnap import default_goldens_dir

        dst = tmp_path / "ir"
        shutil.copytree(default_goldens_dir(), dst)
        ridge = dst / "models.linear.ridge_sweep.aten.txt"
        ridge.write_text(ridge.read_text().replace("f32[", "f64["))
        rc, out = _lint(capsys, "--ir", "--goldens", str(dst), "--ir-family",
                        "models.linear")
        assert rc == 1 and "TM704" in out
        rc, out = _lint(capsys, "--ir", "--update-goldens", "--goldens", str(dst),
                        "--ir-family", "models.linear")
        assert rc == 0 and "golden corpus updated" in out
        # the other families' goldens were kept, the refreshed one is clean
        assert len(json.loads((dst / "index.json").read_text())["entries"]) == 19
        rc, out = _lint(capsys, "--ir", "--goldens", str(dst))
        assert rc == 0, out


def test_module_entry_point_runs_lint(tmp_path):
    """``python -m transmogrifai_tpu_torch.cli lint`` is a command of its
    own (it refused by name before the port's static analysis)."""
    import subprocess

    p = tmp_path / "sneaky.py"
    p.write_text(_HAZARD_SOURCE)
    r = subprocess.run([sys.executable, "-m", "transmogrifai_tpu_torch.cli", "lint",
                        "--path", str(p)], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": REPO_ROOT}, timeout=300)
    assert r.returncode == 1 and "TM301" in r.stdout, r.stdout + r.stderr


def test_lint_of_a_model_s_cost_is_zero_cost(capsys):
    """``cli lint --model --cost`` makes meta tensors only and counts no
    compile event (the card repeats it and reads its memory)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from transmogrifai_tpu_torch.perf.timers import measure_compiles

    class Spy(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.devices = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ != "lift_fresh":
                # (``torch.from_numpy`` of a stage constant wraps host memory,
                # and a 0-dim CPU tensor is a host scalar)
                self.devices.update(t.device.type for t in tree_leaves(out)
                                    if isinstance(t, torch.Tensor)
                                    and (t.dim() or t.device.type != "cpu"))
            return out

    with measure_compiles() as probe, Spy() as spy:
        rc, out = _lint(capsys, "--model", SERVING_WIDE, "--serving", "--cost",
                        "--format", "json", "--fail-on", "error")
    assert rc == 0, out
    assert spy.devices <= {"meta"} and probe.events == {}
