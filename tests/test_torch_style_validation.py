"""Style/hygiene validation of the port (the reference's
``tests/test_style_validation.py`` pointed at ``transmogrifai_tpu_torch``).

Every module must import cleanly (the registry serde depends on import-time
class registration), the stage registry must stay large, and the docstrings of
``ops/``, ``checkers/``, ``filters/`` and ``models/`` must cite their reference
counterpart for parity auditing.  The reference's lint gates over its own
sources (``checkers/opcheck.py``, ``checkers/threadcheck.py``) come with the
port's static analysis (ROADMAP.md, Queue 1 item 2).
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
