"""Style/hygiene validation of the port (the reference's
``tests/test_style_validation.py`` pointed at ``transmogrifai_tpu_torch``).

Every module must import cleanly (the registry serde depends on import-time
class registration), the stage registry must stay large, and the docstrings of
``ops/``, ``checkers/``, ``filters/`` and ``models/`` must cite their reference
counterpart for parity auditing.  The reference's self-hosted gates run over
the port's own sources: the device-hazard lint (TM3xx) of every hot path, the
full-function lint with the TM306 rule over the layers that hold hot paths
and shared state, the TM31x threads gate over the port's threaded surface,
and the stale-marker guard holding every ``# opcheck: allow`` marker to a
finding.
"""

import ast
import importlib
import os
import pkgutil

import transmogrifai_tpu_torch

PKG_ROOT = os.path.dirname(transmogrifai_tpu_torch.__file__)


def _all_modules():
    out = []
    walk_errors = []
    for info in pkgutil.walk_packages([PKG_ROOT], prefix="transmogrifai_tpu_torch.",
                                      onerror=walk_errors.append):
        if info.name.endswith("__main__"):
            continue  # executing entry points under pytest argv is not the goal
        out.append(info.name)
    assert not walk_errors, walk_errors  # a subpackage failed during the walk
    return out


class TestStyleValidation:
    def test_every_module_imports(self):
        failures = {}
        for name in _all_modules():
            try:
                importlib.import_module(name)
            except Exception as e:  # noqa: BLE001 - collecting all failures
                failures[name] = repr(e)
        assert not failures, failures
        assert "transmogrifai_tpu_torch.testkit.specs" in _all_modules()

    def test_no_syntax_errors_anywhere(self):
        for root, _dirs, files in os.walk(PKG_ROOT):
            for f in files:
                if f.endswith(".py"):
                    path = os.path.join(root, f)
                    with open(path) as fh:
                        ast.parse(fh.read(), filename=path)

    def test_stage_registry_covers_fitted_models(self):
        """Every registered stage class must be reachable by the model loader:
        the class registry is populated at import time, so the package __init__
        must import every module defining stages used in saved pipelines."""
        from transmogrifai_tpu_torch.stages.base import STAGE_REGISTRY

        # a healthy registry is large; a sudden drop means a module stopped
        # importing (and saved models referencing its stages stop loading)
        assert len(STAGE_REGISTRY) > 80, len(STAGE_REGISTRY)

    def test_self_hosted_jax_hazard_lint(self):
        """The port must be clean of its own TM3xx device hazards: the
        opcheck AST lint over every transform_columns/fit_columns/
        device_transform body in the package.  Intentional host syncs are
        allowlisted inline with ``# opcheck: allow(TM301) <reason>`` (the
        SanityChecker's end-of-fit fetches); anything unmarked fails here."""
        from transmogrifai_tpu_torch.checkers.opcheck import lint_file

        findings = []
        for root, _dirs, files in os.walk(PKG_ROOT):
            for f in sorted(files):
                if not f.endswith(".py"):
                    continue
                path = os.path.join(root, f)
                for fi in lint_file(path):
                    rel = os.path.relpath(path, PKG_ROOT)
                    findings.append(
                        f"{rel}:{fi.lineno} {fi.code} {fi.qualname}: {fi.message}")
        assert not findings, (
            "unallowlisted device hazards in the package (fix them, or mark "
            "intentional ones inline with '# opcheck: allow(TMxxx) reason'):\n"
            + "\n".join(findings))

    def test_serve_perf_full_function_lint(self):
        """serve/, perf/, perf/kernels/, checkers/, cli/, workflow/,
        readers/, obs/, data/ and deploy/ hold hot paths not named
        transform_columns/fit_columns/device_transform: lint every function
        there (``only_names=None``) plus the TM306 concurrency rule, so the
        module-level caches (the kernel-source digests, the cache tokens,
        the autotuner's memo, the plans' shared prefixes) are mutated only
        under their locks or carry a marker saying why not."""
        from transmogrifai_tpu_torch.checkers.opcheck import (
            lint_file,
            lint_file_concurrency,
        )

        findings = []
        linted = []
        for sub in ("serve", "perf", "perf/kernels", "checkers", "cli",
                    "workflow", "readers", "obs", "data", "deploy"):
            d = os.path.join(PKG_ROOT, sub)
            for f in sorted(os.listdir(d)):
                if not f.endswith(".py"):
                    continue
                path = os.path.join(d, f)
                rel = os.path.relpath(path, PKG_ROOT)
                linted.append(rel)
                for fi in list(lint_file(path, only_names=None)) \
                        + list(lint_file_concurrency(path)):
                    findings.append(
                        f"{rel}:{fi.lineno} {fi.code} {fi.qualname}: {fi.message}")
        for mod in (os.path.join("serve", "registry.py"),
                    os.path.join("data", "chunked.py"),
                    os.path.join("readers", "prefetch.py"),
                    os.path.join("workflow", "ooc.py"),
                    os.path.join("perf", "kernels", "routing.py"),
                    os.path.join("perf", "kernels", "trace.py"),
                    os.path.join("deploy", "store.py"),
                    os.path.join("deploy", "bundle.py"),
                    os.path.join("perf", "autotune.py"),
                    os.path.join("cli", "tune.py"),
                    os.path.join("cli", "lint.py")):
            assert mod in linted, f"the module {mod} left the lint gate"
        assert not findings, (
            "unallowlisted hazards (fix them, or mark intentional ones inline "
            "with '# opcheck: allow(TMxxx) reason'):\n" + "\n".join(findings))

    def test_self_hosted_threads_gate(self):
        """The TM31x whole-program concurrency analyzer over the port's
        threaded surface: every finding fixed or suppressed inline with a
        justified marker.  The thread-model assertions keep the gate honest:
        a discovery regression that stopped seeing the background threads
        would otherwise turn this into a green nothing."""
        from transmogrifai_tpu_torch.checkers.threadcheck import analyze_files

        paths = []
        for sub in ("serve", "obs", "perf", "perf/kernels", "checkers", "deploy"):
            d = os.path.join(PKG_ROOT, sub)
            paths += sorted(os.path.join(d, f) for f in os.listdir(d)
                            if f.endswith(".py"))
        paths += [os.path.join(PKG_ROOT, "workflow", "continual.py"),
                  os.path.join(PKG_ROOT, "workflow", "resilience.py"),
                  os.path.join(PKG_ROOT, "readers", "prefetch.py"),
                  os.path.join(PKG_ROOT, "data", "chunked.py")]
        analysis = analyze_files(paths)
        findings = [f"{os.path.relpath(f.filename, PKG_ROOT)}:{f.lineno} "
                    f"{f.code} {f.qualname}: {f.message}"
                    for f in analysis.findings]
        assert not findings, (
            "unallowlisted TM31x concurrency findings (fix them, or mark "
            "justified ones inline with '# opcheck: allow(TM31x) reason'):\n"
            + "\n".join(findings))
        model = analysis.model.to_dict()
        targets = {t["target"] for t in model["threads"]}
        assert {"MicroBatcher._run", "SwappableScorer._shadow_worker",
                "ChunkPrefetcher._run"} <= targets, targets
        assert len(model["lockOrderEdges"]) >= 3, model["lockOrderEdges"]

    def test_concurrency_rule_sees_through_the_caches(self):
        """The TM306 heuristic itself must keep working: stripping the lock
        from a known-locked mutation makes it fire."""
        from transmogrifai_tpu_torch.checkers.opcheck import lint_module_concurrency

        src = (
            "_CACHE = {}\n"
            "_CACHE_LOCK = __import__('threading').Lock()\n"
            "def locked(k, v):\n"
            "    with _CACHE_LOCK:\n"
            "        _CACHE[k] = v\n"
            "def racy(k, v):\n"
            "    _CACHE[k] = v\n"
            "def racy_method(k):\n"
            "    _CACHE.pop(k, None)\n"
            "def allowed(k, v):\n"
            "    _CACHE[k] = v  # opcheck: allow(TM306) import-time only\n")
        found = lint_module_concurrency(src)
        assert sorted((f.qualname, f.code) for f in found) == [
            ("racy", "TM306"), ("racy_method", "TM306")]

    def test_inline_allow_markers_still_needed(self):
        """Stale-marker guard: every inline ``opcheck: allow`` marker must
        sit on a line whose unsuppressed lint fires — with the widest rule
        set (every function, the TM306 rule, the TM31x analyzer)."""
        import re

        from transmogrifai_tpu_torch.checkers.opcheck import (
            lint_module_concurrency,
            lint_source,
        )
        from transmogrifai_tpu_torch.checkers.threadcheck import analyze_source

        marker = re.compile(r"opcheck:\s*allow\(TM\d{3}")
        n_markers = 0
        for root, _dirs, files in os.walk(PKG_ROOT):
            for f in sorted(files):
                if not f.endswith(".py"):
                    continue
                path = os.path.join(root, f)
                with open(path) as fh:
                    src = fh.read()
                marked = [i + 1 for i, line in enumerate(src.splitlines())
                          if marker.search(line)
                          and not line.lstrip().startswith("#")]
                if not marked:
                    continue
                n_markers += len(marked)
                stripped = "\n".join(
                    re.sub(r"#\s*opcheck:\s*allow\([^)]*\).*", "", line)
                    for line in src.splitlines())
                tree = ast.parse(stripped, filename=path)
                fired = {fi.lineno for fi in
                         lint_source(stripped, filename=path, only_names=None,
                                     tree=tree)}
                fired |= {fi.lineno for fi in
                          lint_module_concurrency(stripped, filename=path, tree=tree)}
                fired |= {fi.lineno for fi in
                          analyze_source(stripped, filename=path, tree=tree).findings}
                stale = [ln for ln in marked if ln not in fired]
                assert not stale, f"{path}: stale opcheck allow markers at lines {stale}"
        assert n_markers > 0

    def test_ops_modules_cite_reference(self):
        """Parity auditability: ops/checkers/filters/models module docstrings
        must cite the reference implementation (file or SURVEY pointer)."""
        uncited = []
        for sub in ("ops", "checkers", "filters", "models"):
            d = os.path.join(PKG_ROOT, sub)
            for f in sorted(os.listdir(d)):
                if not f.endswith(".py") or f == "__init__.py":
                    continue
                with open(os.path.join(d, f)) as fh:
                    head = fh.read(2000)
                if "Reference" not in head and "reference" not in head \
                        and "SURVEY" not in head:
                    uncited.append(f"{sub}/{f}")
        assert not uncited, uncited
