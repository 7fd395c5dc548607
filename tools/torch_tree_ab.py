"""Compare the split scan (K2) and the routing select (K3) of two checkouts of
the port on one CUDA card, in turns, and check that both fit alike and
equally fast.

    python3 tools/torch_tree_ab.py --base DIR [--out ab.json]

DIR holds another checkout's ``transmogrifai_tpu_torch`` (for example a
``git archive`` of an earlier commit, unpacked into a gitignored directory
of this one).  The runs go A, B, B, A — A: DIR, B: this checkout — each in a
process of its own that imports the port from its tree and builds that
tree's kernels into the tree's own ``build/torch_kernels/``.  Each run:

- times K3 at 150, 50 and 3 lanes x 1 048 576 rows x 128 features, and K2
  at the RF-CV deepest level and at a GBT level, with the missing-value bin
  empty (as in the sweep) and filled (chip_smoke's inputs, the device alone:
  chip_smoke.time_device_ms), and hashes each output;
- fits bench.py's tree sweep at full width twice through Workflow.train and
  reports the second fit's seconds, launches and chip_smoke.fit_digest;
- fits bench.py's 4-family sweep (the default selector: chip_smoke's
  ``training_default``) twice the same way and reports the second fit's
  seconds and its families' seconds.

Prints one JSON line: each time per run and per tree, whether every output
hash and every fit digest agrees across the four runs (B bitwise equal to
A), and the card's name and power limit.  Needs a CUDA card and nvcc;
imports torch and the port only.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py (the other tree may carry its own)."""
    spec = importlib.util.spec_from_file_location(
        "tree_ab_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    C = _smoke()
    import torch

    import transmogrifai_tpu_torch as port
    from transmogrifai_tpu_torch.perf.kernels import dispatch
    from transmogrifai_tpu_torch.perf.kernels import histogram as KH
    from transmogrifai_tpu_torch.perf.kernels import routing as KR
    from transmogrifai_tpu_torch.perf.kernels import splitscan as KS

    here = os.path.realpath(os.path.dirname(port.__file__))
    if not here.startswith(os.path.realpath(root) + os.sep):
        raise RuntimeError(f"imported the port from {here}, not from {root}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    dispatch.build(["trees"])
    for m in (KH, KS, KR):
        m._lib()
    out = {"root": root, "build_s": time.perf_counter() - t0, "ms": {}, "hash": {}}

    for L in (C.FOLDS * 50, 50, C.FOLDS):
        g = torch.Generator(device=dev).manual_seed(13 + L)
        binned = torch.randint(0, C.N_BINS + 1, (C.FULL_ROWS, C.D), generator=g,
                               device=dev, dtype=torch.int32)
        idx = torch.randint(0, C.D, (L, C.FULL_ROWS), generator=g, device=dev,
                            dtype=torch.int32)
        key = f"row_select_lanes_{L}"
        out["ms"][key] = C.time_device_ms(lambda: KR.row_select_lanes(binned, idx))
        out["hash"][key] = _digest(KR.row_select_lanes(binned, idx))
        del binned, idx
        torch.cuda.empty_cache()
    for key, gbt, seed, missing in (
            ("split_scan_rf_deepest", False, 12, False),
            ("split_scan_gbt_level", True, 14, False),
            ("split_scan_rf_deepest_missing", False, 12, True),
            ("split_scan_gbt_level_missing", True, 14, True)):
        args = C._scan_inputs(torch, KH, dev, gbt, seed, missing)
        out["ms"][key] = C.time_device_ms(lambda: KS.split_scan(*args))
        out["hash"][key] = _digest(*KS.split_scan(*args))
        del args
        torch.cuda.empty_cache()

    x, y = C.synth(C.FULL_ROWS, C.D, 0)
    mods = (KH, KS, KR)
    for key, default in (("fit", False), ("fit_default", True)):
        for _ in range(2):                      # warm-up, then the measured fit
            for m in mods:
                m.reset_launch_counts()
            model, selector, _, seconds = C.train_selector(torch, x, y, dev,
                                                           default=default)
            launches = {}
            for m in mods:
                launches.update(m.launch_counts())
            fitted = model.fitted[selector.uid]
            out[key] = {"train_s": seconds, "launches": launches,
                        "winner": fitted.summary.best_model_name,
                        "phase_seconds": selector.last_fit_profile,
                        "digest": C.fit_digest(fitted.summary, fitted.model)
                        if hasattr(fitted.model, "trees") else None}
            del model, selector, fitted
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="the other checkout's root (A)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if args.worker:
        res = worker(os.path.abspath(args.worker))
        with open(args.worker_out, "w") as fh:
            json.dump(res, fh)
        return 0
    if not args.base:
        ap.error("--base is required")
    base = os.path.abspath(args.base)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (tag, root) in enumerate((("A", base), ("B", REPO), ("B", REPO),
                                         ("A", base))):
            path = os.path.join(tmp, f"{i}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", root, "--worker-out", path],
                           check=True, cwd=REPO)
            with open(path) as fh:
                runs.append({"tree": tag, **json.load(fh)})
    keys = list(runs[0]["ms"])
    times = {k: {t: [r["ms"][k] for r in runs if r["tree"] == t] for t in "AB"}
             for k in keys}
    summary = {
        k: {"A_ms": v["A"], "B_ms": v["B"], "A_mean": statistics.mean(v["A"]),
            "B_mean": statistics.mean(v["B"]),
            "B_over_A": statistics.mean(v["B"]) / statistics.mean(v["A"]),
            "B_faster_in_every_pair": max(v["B"]) < min(v["A"])}
        for k, v in times.items()}
    train = {t: [r["fit"]["train_s"] for r in runs if r["tree"] == t] for t in "AB"}
    train_default = {t: [r["fit_default"]["train_s"] for r in runs if r["tree"] == t]
                     for t in "AB"}
    line = {
        "nvidia_smi": _smoke().gpu_line(), "device": torch.cuda.get_device_name(0),
        "order": [r["tree"] for r in runs], "kernels": summary,
        "outputs_equal": {k: len({r["hash"][k] for r in runs}) == 1 for k in keys},
        "fit_digests_equal": len({r["fit"]["digest"] for r in runs}) == 1,
        "train_s": train, "train_default_s": train_default,
        "default_winners_equal": len({r["fit_default"]["winner"] for r in runs}) == 1,
        "runs": runs}
    text = json.dumps(line)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
