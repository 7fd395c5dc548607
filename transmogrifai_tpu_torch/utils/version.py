"""Build/version metadata stamped into saved models.

Counterpart of ``transmogrifai_tpu/utils/version.py`` (the reference's
VersionInfo, ``utils/.../version/VersionInfo.scala``): every saved model
records what built it, so production scoring can trace a model file back to
the code that produced it.  The port records the torch version where the
reference records jax's.
"""

from __future__ import annotations

import os
import subprocess
from functools import lru_cache


@lru_cache(maxsize=1)
def version_info() -> dict:
    """Framework + runtime + (best-effort) git provenance: ``version``,
    ``torch``, and ``gitCommit`` where the package lies in a git checkout."""
    import torch

    from .. import __version__

    info = {"version": __version__, "torch": torch.__version__}
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", repo_root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0:
            info["gitCommit"] = out.stdout.strip()
    except Exception:  # noqa: BLE001 — provenance is best-effort
        pass
    return dict(info)
