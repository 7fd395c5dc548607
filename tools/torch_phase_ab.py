"""Time chip_smoke.py phases of one checkout of the port, and the autotuner's
lookup on the launch path, on the card.

    python3 tools/torch_phase_ab.py --repo build/ab/parent --phases maps,text \
        --out chiprun_out/ab_parent.json

Imports ``chip_smoke.py`` from ``--repo`` (default: this checkout), builds
its kernels, then runs each named phase (``phase_<name>(torch, KE, dev)``)
once, its stdout sent to ``<out>.log``, and writes the wall seconds of each.
Where the checkout has ``perf/autotune.py``, it also counts the launchers'
winner lookups (``autotune.launch_params``) in each phase and times one
lookup on the untuned path and on the tuned path (a store holding one
non-default winner of another class).  Run parent, change, change, parent
in one call to compare two checkouts on one card.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

LOOKUPS = 200_000


def _time_lookups(torch, autotune, dev) -> dict:
    """Seconds of one ``launch_params`` call: untuned (an empty store), then
    tuned (one non-default winner of another class adopted)."""
    dims = {"rows": 1 << 16, "features": 128, "bins": 32, "lanes": 100,
            "nodes": 8, "classes": 1, "int_exact": 1}
    out = {}
    saved = os.environ.get("TMOG_AUTOTUNE_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("untuned", "tuned"):
            store = os.path.join(tmp, name)
            os.environ["TMOG_AUTOTUNE_DIR"] = store
            if name == "tuned":
                other = dict(dims, nodes=16)
                cls = autotune.shape_class("hist", dev, **other)
                kind = autotune.device_kind(dev)
                autotune._write_atomic(autotune._entry_path(kind, "hist", cls, store), {
                    "schema": autotune.SCHEMA_VERSION, "device_kind": kind,
                    "family": "hist", "shape_class": cls, "verified": True,
                    "params": {"warps": 16, "min_slice_rows": 4096}})
            autotune.reset()
            autotune.launch_params("hist", dev, **dims)
            t = time.perf_counter()
            for _ in range(LOOKUPS):
                autotune.launch_params("hist", dev, **dims)
            out[f"{name}_us"] = (time.perf_counter() - t) / LOOKUPS * 1e6
            out[f"{name}_token"] = autotune.tuning_token()
    if saved is None:
        os.environ.pop("TMOG_AUTOTUNE_DIR", None)
    else:
        os.environ["TMOG_AUTOTUNE_DIR"] = saved
    autotune.reset()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--phases", default="maps,text")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    out_path = os.path.abspath(args.out)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    sys.path.insert(1, os.path.join(repo, "tests"))
    os.chdir(repo)
    import torch

    import chip_smoke as C
    from transmogrifai_tpu_torch.perf.kernels import dispatch
    from transmogrifai_tpu_torch.perf.kernels import encode as KE
    try:
        from transmogrifai_tpu_torch.perf import autotune
    except ImportError:
        autotune = None

    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    dispatch.build(["encode", "trees"])
    KE._lib()
    for m in C._tree_modules():
        m._lib()
    result = {"repo": repo, "build_s": time.perf_counter() - t,
              "gpu": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True).stdout.strip(),
              "phases": {}}
    if autotune is not None:
        result["lookup"] = _time_lookups(torch, autotune, dev)
    with open(out_path + ".log", "w") as log:
        for name in args.phases.split(","):
            calls = [0]
            if autotune is not None:
                lookup = autotune.launch_params

                def counting(*a, **k):
                    calls[0] += 1
                    return lookup(*a, **k)
                autotune.launch_params = counting
            t = time.perf_counter()
            try:
                with contextlib.redirect_stdout(log):
                    getattr(C, f"phase_{name}")(torch, KE, dev)
            finally:
                if autotune is not None:
                    autotune.launch_params = lookup
            result["phases"][name] = {
                "seconds": time.perf_counter() - t,
                "lookups": calls[0] if autotune is not None else None}
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
