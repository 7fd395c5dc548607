"""Where K1's float kernel spends its time: the kernel as it is, with its
row staging only, with its adds only, and with its channel loop not
unrolled, at the GBT levels on a CUDA card.

Each ablation is a copy of the port under ``build/hist_ablate/<name>/`` whose
``csrc/trees.cu`` has one edit (asserted to apply):

- ``kernel``    — no edit;
- ``stage_only`` — the adds are skipped (each block is still copied in and
  waited for);
- ``adds_only``  — only the first block is copied in, and every block adds
  the rows of that one (no copy is waited for after the first).
- ``runtime_channels`` — the kernel for any channel count (its channel
  loop not unrolled) also for two channels.

The first two ablations compute wrong histograms, so nothing is checked; each
copy builds its own kernels and times ``histogram.launch`` under ``plan()``
at 3 lanes x the root, 1 and 2 nodes x 1 048 576 rows x 128 features (CUDA
events, median of 9).  Prints one JSON line.

    python3 tools/torch_hist_ablate.py [--out a.json]

Needs a CUDA card and nvcc; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = os.path.join("transmogrifai_tpu_torch", "perf", "kernels", "csrc", "trees.cu")
ABLATIONS = {
    "kernel": [],
    "stage_only": [("    if (unit_live) {\n      const int* sc",
                    "    if (unit_live && nblocks < 0) {\n      const int* sc")],
    "adds_only": [("    if (blk + 1 < nblocks) {\n      const int nx",
                   "    if (blk + 1 < nblocks && nblocks < 0) {\n      const int nx"),
                  ("    const int st = blk & 1;", "    const int st = 0;")],
    "runtime_channels": [("two_k == 2 ? hist_f32_kernel<2> : hist_f32_kernel<0>",
                          "hist_f32_kernel<0>")],
}
#: (nodes, root) of the GBT levels timed
LEVELS = ((1, True), (1, False), (2, False))


def _copy(name: str) -> str:
    dst = os.path.join(REPO, "build", "hist_ablate", name)
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    shutil.copytree(os.path.join(REPO, "transmogrifai_tpu_torch"),
                    os.path.join(dst, "transmogrifai_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dst)
    path = os.path.join(dst, KERNEL)
    with open(path) as fh:
        src = fh.read()
    for old, new in ABLATIONS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation {name}: its edit no longer applies")
        src = src.replace(old, new)
    with open(path, "w") as fh:
        fh.write(src)
    return dst


def _time_here() -> list:
    """In a copy: the float kernel under plan() at LEVELS."""
    import torch

    import chip_smoke as C
    from transmogrifai_tpu_torch.perf.kernels import histogram as KH

    if not os.path.abspath(KH.__file__).startswith(os.getcwd() + os.sep):
        raise RuntimeError(f"imported {KH.__file__}, not the copy's kernel")
    dev = torch.device("cuda", 0)
    out = []
    for nn, root in LEVELS:
        local, gh, binned = C._hist_inputs(torch, dev, C.FOLDS, C.FULL_ROWS, nn,
                                           False, 20 + nn, root=root)
        p = KH.plan(C.FOLDS, C.FULL_ROWS, C.D, nn, 2, C.N_BINS, False)
        ms = C.time_big_ms(lambda: KH.launch(local, gh, binned, nn, C.N_BINS,
                                             False, p), runs=9)
        out.append({"nodes": nn, "root": root, "ms": ms,
                    "plan": {k: p[k] for k in ("G", "NT", "FT", "threads", "R",
                                               "slices", "smem")}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--here", action="store_true",
                    help="time the kernel of this checkout (used in each copy)")
    args = ap.parse_args(argv)
    if args.here:
        sys.path.insert(0, os.getcwd())
        print(json.dumps(_time_here()))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as C

    results = {}
    for name in ABLATIONS:
        dst = _copy(name)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--here"],
                              cwd=dst, capture_output=True, text=True, check=True)
        results[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    line = json.dumps({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": C.gpu_line(), "rows": C.FULL_ROWS,
                       "features": C.D, "results": results})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
