"""The training programs' cache in the port (``perf/programs.py``), on the
CPU: the reference's ``tests/test_perf.py::TestExecutableCache`` and
``TestSweepCacheOnSelector::test_second_fit_zero_compiles_and_once_per_family_bucket``
with the import swapped, plus the port's own counterparts of the
persistent cache (the kernel build directory) and of a first call's compile
cost (the compile events its launches cause).

The port compiles no program: a key's first call is its compile, counted
with the kernel builds and loads it caused (none on the CPU), and every
later call is a hit.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.evaluators.base import BinaryClassificationEvaluator
from transmogrifai_tpu_torch.models.logistic import LogisticRegression
from transmogrifai_tpu_torch.models.svm import LinearSVC
from transmogrifai_tpu_torch.models.trees import (
    GradientBoostedTreesClassifier,
    RandomForestClassifier,
)
from transmogrifai_tpu_torch.models.tuning import CrossValidator
from transmogrifai_tpu_torch.perf import (
    cache_key_fingerprint,
    enable_persistent_cache,
    measure_compiles,
    program_cache_stats,
    run_cached,
)
from transmogrifai_tpu_torch.perf.kernels import dispatch
from transmogrifai_tpu_torch.perf.programs import (
    evict_program_entries,
    program_cache_entries,
)
from transmogrifai_tpu_torch.perf.timers import note_compile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _binary(n=500, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(np.float32)
    return x, y


def _small_models():
    """The default 4-family shape at test scale (small trees/rounds)."""
    return [
        (LogisticRegression(), [{"reg_param": 0.01},
                                {"reg_param": 0.1, "elastic_net": 0.5}]),
        (LinearSVC(), [{"reg_param": 0.01}]),
        (RandomForestClassifier(num_trees=6, max_depth=3), [{"max_depth": 3}]),
        (GradientBoostedTreesClassifier(num_rounds=5, max_depth=2),
         [{"num_rounds": 5}]),
    ]


class TestExecutableCache:
    def test_compile_once_then_hits(self):
        salt = time.time_ns()

        def g(v):
            return (v * 2).sum() + salt % 5

        v = torch.ones(16)
        run_cached(g, v, label="t/compile_once")
        before = {k: s.compiles for k, s in program_cache_entries().items()
                  if s.label == "t/compile_once"}
        assert sum(before.values()) == 1
        with measure_compiles() as c:
            out = run_cached(g, v, label="t/compile_once")
        assert c.backend_compiles == 0
        assert float(out) == 32 + salt % 5
        entry = [s for s in program_cache_entries().values()
                 if s.label == "t/compile_once"]
        assert len(entry) == 1 and entry[0].compiles == 1 \
            and entry[0].hits == 1

    def test_invalidation_on_statics_shapes_and_layout(self):
        """New statics, a new lane layout (fold-weight shape), or a flipped
        key_extras layout knob each get their own entry; repeats hit."""
        salt = time.time_ns()

        def h(v, w, scale=2):
            return (v[None, :] * w).sum() * scale + salt % 3

        def n_entries():
            return sum(1 for s in program_cache_entries().values()
                       if s.label == "t/invalidation")

        v = torch.ones(32) * (salt % 3 + 1)
        w2 = torch.ones((2, 32))
        w3 = torch.ones((3, 32))
        run_cached(h, v, w2, statics=dict(scale=2), label="t/invalidation")
        base = n_entries()
        run_cached(h, v, w2, statics=dict(scale=2), label="t/invalidation")
        assert n_entries() == base                      # repeat: pure hit
        run_cached(h, v, w2, statics=dict(scale=3), label="t/invalidation")
        assert n_entries() == base + 1                  # grid/static change
        run_cached(h, v, w3, statics=dict(scale=2), label="t/invalidation")
        assert n_entries() == base + 2                  # lane-layout change
        run_cached(h, v, w2, statics=dict(scale=2),
                   key_extras=dict(fold_vmap=True), label="t/invalidation")
        assert n_entries() == base + 3                  # layout knob change
        run_cached(h, v.double(), w2, statics=dict(scale=2), label="t/invalidation")
        assert n_entries() == base + 4                  # dtype change

    def test_key_fingerprint_stable_across_processes(self):
        """The content-addressed key must be identical in a fresh
        interpreter — shapes + statics + program source, no id()s."""
        script = (
            "import numpy as np, torch\n"
            "from transmogrifai_tpu_torch.models.logistic import _irls_sweep\n"
            "from transmogrifai_tpu_torch.perf import cache_key_fingerprint\n"
            "x=torch.zeros((1024,9)); y=torch.zeros(1024)\n"
            "tw=torch.zeros((3,1024)); r=torch.zeros(4)\n"
            "print(cache_key_fingerprint(_irls_sweep, x, y, tw, r,"
            " statics=dict(max_iter=30, has_intercept=True)))\n"
        )
        fps = []
        for _ in range(2):
            out = subprocess.run(
                [sys.executable, "-c", script], cwd=REPO,
                env={**os.environ, "PYTHONPATH": REPO},
                capture_output=True, text=True, timeout=180)
            assert out.returncode == 0, out.stderr[-2000:]
            fps.append(out.stdout.strip().splitlines()[-1])
        assert fps[0] == fps[1]
        from transmogrifai_tpu_torch.models.logistic import _irls_sweep

        local = cache_key_fingerprint(
            _irls_sweep, torch.zeros((1024, 9)), torch.zeros(1024),
            torch.zeros((3, 1024)), torch.zeros(4),
            statics=dict(max_iter=30, has_intercept=True))
        assert local == fps[0]
        # the kernel token keys every program: another build of the kernels
        # is another key
        with dispatch.force_serve_donation(True):
            donated = cache_key_fingerprint(
                _irls_sweep, torch.zeros((1024, 9)), torch.zeros(1024),
                torch.zeros((3, 1024)), torch.zeros(4),
                statics=dict(max_iter=30, has_intercept=True))
        assert donated != local

    def test_first_call_counts_the_compile_events_it_caused(self):
        """A key's compile is what its first call really cost: the kernel
        builds and loads (here one simulated build event) its launches
        caused; later calls cause none and count as hits."""
        salt = time.time_ns()
        state = {"built": False}

        def launch(v):
            if not state["built"]:
                note_compile("nvcc_build", 0.25, cache_hit=False, library="t")
                state["built"] = True
            return v + salt % 7

        run_cached(launch, torch.ones(4), label="t/first_call")
        run_cached(launch, torch.ones(4), label="t/first_call")
        (s,) = [s for s in program_cache_entries().values() if s.label == "t/first_call"]
        assert (s.compiles, s.hits, s.backend_compiles) == (1, 1, 1)
        assert s.compile_seconds == pytest.approx(0.25)
        stats = program_cache_stats()
        assert {"programs_compiled", "cache_hits", "compile_seconds", "fallbacks",
                "programs"} == set(stats)
        assert evict_program_entries([launch]) == 1
        assert not [s for s in program_cache_entries().values()
                    if s.label == "t/first_call"]

    def test_failed_first_call_leaves_the_key_uncounted(self):
        salt = time.time_ns()
        calls = []

        def flaky(v):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("boom")
            return v * (salt % 3)

        with pytest.raises(RuntimeError):
            run_cached(flaky, torch.ones(2), label="t/flaky")
        run_cached(flaky, torch.ones(2), label="t/flaky")
        (s,) = [s for s in program_cache_entries().values() if s.label == "t/flaky"]
        assert (s.compiles, s.hits) == (1, 0)

    def test_persistent_cache_is_the_kernel_build_dir(self, tmp_path, monkeypatch):
        """The port's persistent compile cache is the kernel build
        directory: enabling it at a dir points every library there; with no
        dir, the directory in use stays."""
        monkeypatch.setattr(dispatch, "_BUILD_DIR", None)
        default = dispatch.build_dir()
        assert enable_persistent_cache() == default == dispatch.build_dir()
        got = enable_persistent_cache(str(tmp_path / "cache"))
        assert got == str(tmp_path / "cache") == dispatch.build_dir()
        assert os.path.isdir(got)
        assert dispatch.library_path("encode").startswith(got + os.sep)


class TestSweepCacheOnSelector:
    def test_second_fit_zero_compiles_and_once_per_family_bucket(self):
        """A second fit of the (4-family shape) selector sweep in the same
        process causes 0 compile events, every sweep program was first
        called at most once per key, and the programs carry the reference's
        labels."""
        import transmogrifai_tpu_torch as T
        from transmogrifai_tpu_torch import FeatureBuilder
        from transmogrifai_tpu_torch.data.dataset import Column, Dataset
        from transmogrifai_tpu_torch.models.selector import ModelSelector
        from transmogrifai_tpu_torch.models.tuning import DataBalancer
        from transmogrifai_tpu_torch.types import OPVector, RealNN

        x, y = _binary(n=700)
        ds = Dataset({"label": Column.from_values(T.types.RealNN, list(y.astype(float))),
                      "v": Column.vector(x)})
        label = FeatureBuilder.of("label", RealNN).extract_field().as_response()
        vec = FeatureBuilder.of("v", OPVector).extract_field().as_predictor()
        ev = BinaryClassificationEvaluator("auPR")
        sel = ModelSelector(models=_small_models(),
                            validator=CrossValidator(ev, num_folds=2, seed=3),
                            splitter=DataBalancer())
        label.transform_with(sel, vec)
        seen = set(program_cache_entries())
        m1 = sel.fit(ds, device="cpu")
        new = set(program_cache_entries()) - seen
        with measure_compiles() as c:
            m2 = sel.fit(ds, device="cpu")
        assert c.backend_compiles == 0, \
            f"warm selector fit caused {c.backend_compiles} compile events"
        assert m1.summary.best_model_name == m2.summary.best_model_name
        for key, s in program_cache_entries().items():
            assert s.compiles <= 1, (s.label, s.shapes, s.compiles)
        entries = program_cache_entries()
        assert {entries[k].label for k in new} == {
            "LogisticRegression/irls_sweep", "LogisticRegression/fista_sweep",
            "LogisticRegression/eval_sweep", "LinearSVC/cv_program",
            "RandomForestClassifier/cv_program",
            "GradientBoostedTreesClassifier/cv_program"}
        # every program of the first fit was called again by the second
        assert all(entries[k].compiles == 1 and entries[k].hits >= 1 for k in new)
        # the phase profile of the fit is recorded
        assert sel.last_fit_profile["validate"] > 0
        assert "refit" in sel.last_fit_profile
