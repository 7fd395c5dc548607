"""The port's op-graph golden corpus and its semantic differ: the JAX
package's ``tests/test_irsnap.py`` translated from StableHLO text to the
port's canonical aten-op graphs (``checkers/irsnap.py``).

Every differ class has a seeded fixture that fires it exactly as
classified; the whole capture + diff pass runs on meta tensors (no compile
event, nothing made on a device); and the committed goldens under
``tests/goldens/torch_ir`` match a fresh capture exactly, so a kernel or
stage edit (or a torch upgrade) cannot land without a reviewed, classified
graph diff.

Translations: "locations stripped" becomes "the text does not depend on
where the program was written"; the metadata-only tamper of TM701 changes a
scalar literal (every op, dtype and collective unchanged); the TM703 tamper
adds a ``_c10d_functional.all_reduce`` line; the content fingerprint of a
program family names its program and operand specs (the reference's
executable-cache key).

Not translated: the TM705 cases that lower a sweep under a 4x2 mesh
(``test_fires_on_pre_pr4_pattern``, ``test_quiet_on_fixed_per_mesh_closure``)
and the StableHLO printer-form case
(``test_sharding_resolves_through_generic_printer_form``): the port's corpus
captures programs without a mesh until its sharded families are ported, and
it has no StableHLO printer.  The differ's own
TM705 logic is held on synthetic sort signatures here.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from transmogrifai_tpu_torch.checkers import irsnap
from transmogrifai_tpu_torch.checkers.diagnostics import Severity
from transmogrifai_tpu_torch.checkers.irsnap import (
    IRSnapshot,
    SortSignature,
    build_corpus,
    capture,
    default_goldens_dir,
    diff_corpus,
    diff_snapshots,
    ir_fingerprint,
    load_corpus,
    save_corpus,
)
from transmogrifai_tpu_torch.perf.kernels import encode as KE
from transmogrifai_tpu_torch.perf.kernels import histogram as KH
from transmogrifai_tpu_torch.perf.kernels import routing as KR
from transmogrifai_tpu_torch.perf.kernels import splitscan as KS
from transmogrifai_tpu_torch.perf.timers import measure_compiles

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _snap_of(fn, *ops, key="prog"):
    return IRSnapshot.from_text(key, capture(fn, *ops))


class _DeviceSpy(TorchDispatchMode):
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


# ---------------------------------------------------------------------------
# canonical form
# ---------------------------------------------------------------------------

class TestCanonicalize:
    def test_ssa_renumbering_is_alpha_equivalence(self):
        a = capture(lambda x: x + x, _meta(4))
        b = capture(lambda other: other + other, _meta(4))
        assert a == b and ir_fingerprint(a) == ir_fingerprint(b)
        assert "%a0" in a and "%v0" in a

    def test_locations_stripped(self):
        def f(x):
            return x.abs()

        def g(x):
            return x.abs()  # another function, another line, one program

        assert capture(f, _meta(2)) == capture(g, _meta(2))

    def test_large_constants_hash_small_ones_survive(self):
        import numpy as np

        def with_const(value):
            def f(x):
                return x * torch.from_numpy(np.asarray(value, np.float32)).to(x.device)
            return f

        t1 = capture(with_const([1.25] * 64), _meta(64))
        t2 = capture(with_const([1.5] * 64), _meta(64))
        assert "#blake2b:" in t1 and "1.25" not in t1
        assert t1 != t2                      # the payload's hash differs
        small = capture(lambda x: x * 2.5, _meta(3))
        assert "2.5" in small                # a scalar survives by value

    def test_dtype_semantics_not_stripped(self):
        a = capture(lambda x: x.abs(), _meta(2))
        b = capture(lambda x: x.abs(), _meta(2, dtype=torch.float64))
        assert a != b and "f64[2]" in b

    def test_real_lowering_canonicalizes_deterministically(self):
        t1 = capture(lambda x: (x * 2.0).sum(), _meta(32))
        t2 = capture(lambda x: (x * 2.0).sum(), _meta(32))
        assert t1 == t2

    def test_placement_does_not_enter_the_text(self):
        """Device arguments are dropped, so a graph captured with operands
        on the card reads as the meta capture (the card's corpus is held
        to the meta goldens)."""
        text = capture(lambda x: x + torch.zeros(8, device=x.device), _meta(8))
        assert "device" not in text and "meta" not in text
        assert "aten.zeros.default([8])" in text


# ---------------------------------------------------------------------------
# the differ: one seeded fixture per TM70x class
# ---------------------------------------------------------------------------

class TestDiffer:
    def test_identical_snapshots_are_clean(self):
        s1 = _snap_of(lambda x: x * 2.0, _meta(16))
        s2 = _snap_of(lambda x: x * 2.0, _meta(16))
        assert diff_snapshots(s1, s2) == []

    def test_tm700_missing_and_extra_golden(self):
        s = _snap_of(lambda x: x + 1.0, _meta(8))
        new = diff_snapshots(None, s)
        gone = diff_snapshots(s, None)
        assert [d.code for d in new] == ["TM700"]
        assert [d.code for d in gone] == ["TM700"]
        assert all(d.severity == Severity.INFO for d in new + gone)

    def test_tm701_benign_text_drift(self):
        s = _snap_of(lambda x: x * 3.0, _meta(8))
        tampered = IRSnapshot.from_text(s.key, s.text.replace("3.0", "3.5"))
        assert tampered.ir_fingerprint != s.ir_fingerprint
        diags = diff_snapshots(s, tampered)
        assert [d.code for d in diags] == ["TM701"]
        assert diags[0].severity == Severity.INFO
        assert diags[0].location == s.key

    def test_tm702_fusion_layout_change(self):
        old = _snap_of(lambda x: (x * 2.0).sum(), _meta(32))
        new = _snap_of(lambda x: (x * 2.0 + 1.0).sum(), _meta(32))
        diags = diff_snapshots(old, new)
        assert [d.code for d in diags] == ["TM702"]
        assert diags[0].severity == Severity.WARNING
        assert "op histogram" in diags[0].message

    def test_tm703_collective_drift(self):
        old = _snap_of(lambda x: x * 2.0, _meta(16))
        lines = old.text.splitlines()
        lines.insert(-1, "%v9 = _c10d_functional.all_reduce.default(%v0, 'sum', '0')"
                         " : f32[16] -> f32[16]")
        new = IRSnapshot.from_text(old.key, "\n".join(lines))
        codes = [d.code for d in diff_snapshots(old, new)]
        assert "TM703" in codes
        assert "TM704" not in codes and "TM705" not in codes

    def test_tm704_dtype_drift(self):
        old = _snap_of(lambda x: x * 2.0, _meta(16))
        new = IRSnapshot.from_text(old.key, old.text.replace("f32[", "f64["))
        diags = diff_snapshots(old, new)
        tm704 = [d for d in diags if d.code == "TM704"]
        assert tm704 and tm704[0].severity == Severity.ERROR
        assert "f64" in tm704[0].message

    def test_tm704_float_width_migration(self):
        def mixed(x):
            return x.to(torch.bfloat16).sum().to(torch.float32) + x.sum()

        old = _snap_of(mixed, _meta(16))
        assert {"f32", "bf16"} <= set(old.dtype_counts)
        new = IRSnapshot.from_text(old.key, old.text.replace("f32[16]", "bf16[16]", 1))
        assert old.dtype_counts.keys() == new.dtype_counts.keys()
        assert "TM704" in [d.code for d in diff_snapshots(old, new)]


class TestTm705Regression:
    """Without a mesh no sort is sharded, so TM705 stays quiet on every
    family; the differ's rules are held on synthetic signatures."""

    def _hazard(self, key="fam"):
        snap = _snap_of(lambda x: torch.sort(x, dim=1).values, _meta(4, 8), key=key)
        assert snap.sorts and not snap.sharded_sort_hazards()
        snap.sorts = [SortSignature(dimension=1, rank=2, shape="f32[4,8]",
                                    sharding="{devices=[1,4]<=[4]}",
                                    sharded_sort_dim=True)]
        return snap

    def test_quiet_without_a_mesh(self):
        snaps, _ = build_corpus(families=["svc_cv_program"])
        snap = snaps["models.svm.svc_cv_program"]
        assert snap.sorts, "the metric's sort must be seen"
        assert diff_snapshots(None, snap) == diff_snapshots(None, snap)
        assert "TM705" not in [d.code for d in diff_snapshots(None, snap)]

    def test_fires_on_brand_new_family_without_golden(self):
        codes = [d.code for d in diff_snapshots(None, self._hazard())]
        assert codes == ["TM700", "TM705"]

    def test_hazard_present_in_both_does_not_refire(self):
        old, new = self._hazard(), self._hazard()
        new.ir_fingerprint = "changed"
        assert "TM705" not in [d.code for d in diff_snapshots(old, new)]


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------

FAMILIES = (
    "models.logistic.irls_sweep", "models.logistic.fista_sweep",
    "models.linear.ridge_sweep", "models.svm.svc_cv_program",
    "models.base.eval_linear_sweep", "models.base.eval_softmax_sweep",
    "models.trees.grow_level@int8", "models.trees.grow_level@f32",
    "workflow.plan.transform_prefix", "workflow.plan.transform_prefix@chunk",
    "workflow.plan.fold_prefix", "serve.plan.scoring_prefix",
    "serve.plan.scoring_prefix@bf16", "serve.plan.scoring_prefix@int8",
    "perf.kernels.encode", "perf.kernels.hist@int8", "perf.kernels.hist@f32",
    "perf.kernels.split_scan", "perf.kernels.route")


@pytest.fixture(scope="module")
def corpus():
    counts = lambda: (KE.launch_counts()["encode_slots"], KH.launches,  # noqa: E731
                      KS.launches, KR.launches)
    before = counts()
    with measure_compiles() as c, _DeviceSpy() as spy:
        snaps, skipped = build_corpus()
    return snaps, skipped, c.events, spy.devices, counts() == before


class TestCorpus:
    def test_snapshot_all_families_zero_compiles(self, corpus):
        snaps, skipped, events, devices, no_launch = corpus
        assert events == {}, "the capture must build, load and allocate nothing"
        assert devices <= {"meta"}, devices
        assert no_launch, "the capture must launch no kernel"
        assert skipped == []
        assert set(snaps) == set(FAMILIES)
        for snap in snaps.values():
            assert snap.op_counts and snap.dtype_counts
            assert snap.ir_fingerprint == ir_fingerprint(snap.text)
            assert snap.content_fingerprint

    def test_diff_against_checked_in_goldens_is_clean(self, corpus):
        snaps, skipped, *_ = corpus
        goldens, index = load_corpus(default_goldens_dir())
        assert index["version"] == irsnap.CORPUS_VERSION
        assert index["torchVersion"] and index["platform"]
        diags = diff_corpus(goldens, snaps, skipped=skipped)
        assert diags == [], (
            "the op-graph corpus drifted from tests/goldens/torch_ir — review "
            "the diff classes, then re-golden with `cli lint --ir "
            "--update-goldens`:\n" + "\n".join(d.pretty() for d in diags))

    def test_corpus_roundtrips_through_disk(self, corpus, tmp_path):
        snaps, *_ = corpus
        save_corpus(snaps, str(tmp_path))
        loaded, index = load_corpus(str(tmp_path))
        assert set(loaded) == set(snaps)
        for key, snap in snaps.items():
            assert loaded[key].ir_fingerprint == snap.ir_fingerprint
            assert loaded[key].op_counts == snap.op_counts
            assert loaded[key].sorts == snap.sorts
            assert index["entries"][key]["irFingerprint"] == snap.ir_fingerprint
        assert diff_corpus(loaded, snaps) == []

    def test_save_corpus_drops_stale_files(self, corpus, tmp_path):
        snaps, *_ = corpus
        stale = tmp_path / "gone.family.aten.txt"
        stale.write_text("return\n")
        save_corpus(snaps, str(tmp_path))
        assert not stale.exists()

    def test_family_filter(self):
        snaps, skipped = build_corpus(families=["models.linear"])
        assert list(snaps) == ["models.linear.ridge_sweep"]
        assert "models.trees.grow_level@f32" in skipped

    def test_content_fingerprints_match_executable_cache_keys(self, corpus):
        """A program family's content fingerprint names its program and
        operand specs; a plan family's is the plan's fingerprint."""
        import hashlib

        from transmogrifai_tpu_torch.models.linear import _ridge_sweep

        snaps, *_ = corpus
        n, d, k, g = 64, 4, 2, 2
        want = hashlib.sha256(json.dumps(
            [f"{_ridge_sweep.__module__}.{_ridge_sweep.__qualname__}",
             [[[n, d + 1], "float32"], [[n], "float32"], [[k, n], "float32"],
              [[g], "float32"]],
             [["has_intercept", "True"]]]).encode()).hexdigest()
        assert snaps["models.linear.ridge_sweep"].content_fingerprint == want

    def test_every_kernel_is_a_node_of_the_families_that_launch_it(self, corpus):
        snaps, *_ = corpus
        kernels = {k: s.kernels() for k, s in snaps.items()}
        for key in ("perf.kernels.hist@int8", "perf.kernels.hist@f32"):
            assert kernels[key] == {"hist_level": 1}
        assert kernels["perf.kernels.split_scan"] == {"split_scan": 1}
        assert kernels["perf.kernels.route"] == {"row_select_lanes": 1}
        assert kernels["perf.kernels.encode"] == {"encode_slots": 1}
        for key in ("models.trees.grow_level@int8", "models.trees.grow_level@f32"):
            assert kernels[key] == {"hist_level": 1, "split_scan": 1,
                                    "row_select_lanes": 1}
        for key in ("workflow.plan.transform_prefix", "workflow.plan.fold_prefix",
                    "serve.plan.scoring_prefix", "serve.plan.scoring_prefix@bf16",
                    "serve.plan.scoring_prefix@int8"):
            assert kernels[key] == {"encode_slots": 1}, key
        # K4 and K5 are slot kinds of the one encode kernel: the family's
        # table holds both
        text = snaps["perf.kernels.encode"].text
        assert '"slots": 2' in text
        # the int8 path's host decision is recorded on its node
        assert '"int_exact": true' in snaps["perf.kernels.hist@int8"].text

    def test_host_decision_families_snapshot_one_iteration(self):
        with open(os.path.join(default_goldens_dir(), "index.json")) as fh:
            entries = json.load(fh)["entries"]
        once = {k for k, v in entries.items() if v["oneIteration"]}
        assert once == {"models.logistic.irls_sweep", "models.trees.grow_level@int8",
                        "models.trees.grow_level@f32"}


# ---------------------------------------------------------------------------
# gates: torch_ir_gate + torch_static_gate exit-code contracts
# ---------------------------------------------------------------------------

def _run(cmd, **kw):
    env = {**os.environ, "PYTHONPATH": REPO_ROOT}
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=REPO_ROOT, timeout=300, **kw)


class _Result:
    def __init__(self, returncode, out):
        self.returncode, self.stdout, self.stderr = returncode, out, ""


def _gate_main(script, argv, capsys, monkeypatch):
    """A gate's ``main`` in this process (its ``cli lint`` stays a child
    process, as the contract has it); SystemExit is its refusal."""
    import importlib

    monkeypatch.chdir(REPO_ROOT)
    monkeypatch.setenv("PYTHONPATH", REPO_ROOT)
    monkeypatch.syspath_prepend(os.path.join(REPO_ROOT, "tools"))
    mod = importlib.import_module(script)
    capsys.readouterr()
    try:
        rc = mod.main(argv)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
        out = capsys.readouterr()
        return _Result(rc, out.out + out.err + str(e))
    out = capsys.readouterr()
    return _Result(rc, out.out + out.err)


RIDGE = "models.linear.ridge_sweep.aten.txt"


@pytest.fixture()
def goldens_copy(tmp_path):
    dst = tmp_path / "ir"
    shutil.copytree(default_goldens_dir(), dst)
    return str(dst)


def _tamper(goldens_dir, old, new):
    p = os.path.join(goldens_dir, RIDGE)
    with open(p) as fh:
        src = fh.read()
    assert old in src
    with open(p, "w") as fh:
        fh.write(src.replace(old, new))


class TestIrGate:
    """The rc contract on a tampered corpus copy: flips on an injected
    TM704, stays green on TM701 text drift; one cheap family a call."""

    @pytest.fixture(autouse=True)
    def _gate_env(self, capsys, monkeypatch):
        self._capsys, self._mp = capsys, monkeypatch

    def _gate(self, goldens_dir, *extra):
        return _gate_main("torch_ir_gate", [
            "--baseline", os.path.join(goldens_dir, "_baseline.json"), "--",
            "--goldens", goldens_dir, "--ir-family", "models.linear", *extra],
            self._capsys, self._mp)

    def test_green_on_clean_corpus(self, goldens_copy):
        r = self._gate(goldens_copy)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "OK" in r.stdout

    def test_rc_flips_on_injected_tm704(self, goldens_copy):
        _tamper(goldens_copy, "f32[", "f64[")
        r = self._gate(goldens_copy)
        assert r.returncode == 1, r.stdout + r.stderr
        assert "TM704" in r.stdout and "NEW error" in r.stdout

    def test_rc_stays_green_on_tm701_text_drift(self, goldens_copy):
        _tamper(goldens_copy, "1e-12", "1e-11")
        r = self._gate(goldens_copy)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "TM701" in r.stdout and "never gates" in r.stdout

    def test_baselined_error_keeps_rc_zero(self, goldens_copy):
        _tamper(goldens_copy, "f32[", "f64[")
        r1 = _gate_main("torch_ir_gate", [
            "--baseline", os.path.join(goldens_copy, "_baseline.json"),
            "--update-baseline", "--", "--goldens", goldens_copy,
            "--ir-family", "models.linear"], self._capsys, self._mp)
        assert r1.returncode == 0
        r2 = self._gate(goldens_copy)
        assert r2.returncode == 0, r2.stdout + r2.stderr
        assert "known error" in r2.stdout

    def test_missing_corpus_is_fatal_not_green(self, tmp_path):
        r = self._gate(str(tmp_path / "nowhere"))
        assert r.returncode != 0
        assert "refusing to report OK" in r.stderr + r.stdout

    def test_nonmatching_family_filter_is_fatal_not_green(self):
        r = _run([sys.executable, "-m", "transmogrifai_tpu_torch.cli", "lint",
                  "--ir", "--ir-family", "models.liner"])  # typo
        assert r.returncode != 0
        assert "0 program families compared" in r.stderr + r.stdout
        g = _gate_main("torch_ir_gate", ["--", "--ir-family", "models.liner"],
                       self._capsys, self._mp)
        assert g.returncode != 0
        assert "refusing to report OK" in g.stderr + g.stdout


class TestStaticGate:
    @pytest.fixture(autouse=True)
    def _gate_env(self, capsys, monkeypatch):
        self._capsys, self._mp = capsys, monkeypatch

    def _static(self, argv):
        return _gate_main("torch_static_gate", argv, self._capsys, self._mp)

    def test_green_ir_only(self, tmp_path, goldens_copy):
        r = self._static(["--ir-baseline", str(tmp_path / "irb.json"),
                          "--goldens", goldens_copy])
        assert r.returncode == 0, r.stdout + r.stderr
        assert "torch_static_gate: OK" in r.stdout
        assert "lint_gate skipped" in r.stdout

    def test_new_error_in_either_half_flips_rc(self, tmp_path, goldens_copy):
        _tamper(goldens_copy, "f32[", "f64[")
        r = self._static(["--ir-baseline", str(tmp_path / "irb.json"),
                          "--goldens", goldens_copy])
        assert r.returncode == 1
        assert "torch_static_gate: FAIL" in r.stdout
        bad = tmp_path / "bad.py"
        bad.write_text("def transform_columns(x):\n    retur x\n")  # syntax
        dst2 = tmp_path / "ir2"
        shutil.copytree(default_goldens_dir(), dst2)
        r2 = self._static(["--skip-ir", "--lint-baseline", str(tmp_path / "lb.json"),
                           "--goldens", str(dst2), "--", "--path", str(bad)])
        assert r2.returncode == 1, r2.stdout + r2.stderr
        assert "lint_gate" in r2.stdout

    def test_skip_ir_without_lint_args_refuses(self):
        r = self._static(["--skip-ir"])
        assert r.returncode != 0
        assert "refusing" in r.stderr + r.stdout


class TestShadowPrefixFamily:
    def test_swap_candidate_dedups_to_scoring_prefix_golden(self):
        """The swap path's shadow-scoring prefix needs no family of its own:
        a candidate staged and promoted through the server for the corpus
        fixture model captures the exact graph pinned as
        ``serve.plan.scoring_prefix``."""
        from transmogrifai_tpu_torch.checkers.irsnap import (
            _plan_fixture_runners,
            _Shim,
            snapshot_scoring_plan,
        )
        from transmogrifai_tpu_torch.serve import ScoringServer

        goldens, _index = load_corpus(default_goldens_dir())
        golden = goldens["serve.plan.scoring_prefix"]
        features, _runners = _plan_fixture_runners()
        shim = _Shim(features, {})
        with ScoringServer(shim, max_batch=64, min_bucket=8, warm=False,
                           device="cpu") as server:
            server.stage_candidate(shim, warm=False)
            active_fp = server.plan.fingerprint
            server.promote(probation_batches=0)
            candidate_plan = server.plan
        assert candidate_plan.fingerprint == active_fp
        snap = snapshot_scoring_plan(candidate_plan, bucket=64)
        assert snap.ir_fingerprint == golden.ir_fingerprint
        assert snap.text == golden.text
