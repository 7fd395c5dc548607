"""Where the port's training time goes, on a CUDA card.

Runs bench.py's 4-family sweep (synth data, 128 features, 3 folds, seed 7;
LogisticRegression {reg 0.001|0.01|0.1} x {elastic net 0|0.5}, RF {50
trees, depth 3|6}, GBT {50 rounds, depth 3}, LinearSVC {reg 0.01|0.1})
through the pieces the selector runs — the placement and binning of the
rows, each family's CV sweep, the refit of the GBT grid point (the tree
sweep's winner at full width) and of LR {0.1, 0} (the 4-family winner) —
once to warm up, then once under torch.profiler, and reports as one JSON
line, per part:

- host-clock seconds (each part ends in a synchronise);
- device-busy seconds (the union of the kernels' and copies' intervals) and
  the device idle share of the part (1 - busy / wall);
- the device time of the port's three tree kernels (K1, K2, K3, by the
  kernels of each), of cuBLAS's matrix products, of the batched LU solves,
  of sorts, and of everything else.

    python3 tools/torch_training_profile.py [--rows 1048576] [--out p.json]

Needs a CUDA card; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: device kernel name -> the port's kernel it belongs to (K1's float path
#: counts its slice-sum kernel with it)
TREE_KERNELS = {"hist_int8_kernel": "hist_level", "hist_f32_kernel": "hist_level",
                "sum_slices_kernel": "hist_level", "split_scan_kernel": "split_scan",
                "row_select_tile_kernel": "row_select_lanes",
                "row_select_direct_kernel": "row_select_lanes"}
#: substrings of library kernels' names -> what they do in the linear fits
LIBRARY_KERNELS = {"gemm": "matmul", "gemv": "matmul", "xmma": "matmul",
                   "cutlass": "matmul", "getrf": "solve", "getrs": "solve",
                   "trsm": "solve", "lu_": "solve", "Sort": "sort", "sort": "sort"}


def _busy(events) -> float:
    busy, last_end = 0.0, -1.0
    for s, e in sorted(events):
        s = max(s, last_end)
        if e > s:
            busy += e - s
            last_end = e
    return busy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from transmogrifai_tpu_torch import LinearSVC, LogisticRegression
    from transmogrifai_tpu_torch.evaluators.base import BinaryClassificationEvaluator
    from transmogrifai_tpu_torch.models import trees as TT
    from transmogrifai_tpu_torch.models.tuning import CrossValidator

    dev = torch.device("cuda", 0)
    x, y = C.synth(args.rows, C.D, 0)
    ev = BinaryClassificationEvaluator("auPR")
    cv = CrossValidator(ev, num_folds=C.FOLDS, seed=C.SELECTOR_SEED)
    tw, vw = cv.fold_weights(y, np.ones(len(y), np.float32))
    metric = ev.metric_fn()
    lr_grids = [{"reg_param": r, "elastic_net": e} for r in (0.001, 0.01, 0.1)
                for e in (0.0, 0.5)]
    fams = [("LogisticRegression", LogisticRegression(), lr_grids),
            ("RandomForestClassifier", TT.RandomForestClassifier(), C.RF_GRIDS),
            ("GradientBoostedTreesClassifier", TT.GradientBoostedTreesClassifier(),
             C.GBT_GRIDS),
            ("LinearSVC", LinearSVC(), [{"reg_param": r} for r in (0.01, 0.1)])]

    def parts():
        """(name, thunk) of the selector's parts, each ending synchronised."""
        out = [("bin", lambda: TT.RandomForestClassifier()._binned(x, dev))]
        for name, est, grids in fams:
            out.append((f"cv.{name}", lambda est=est, grids=grids: est.cv_sweep(
                x, y, tw, vw, grids, metric, dev)))
        gbt = TT.GradientBoostedTreesClassifier(**C.GBT_GRIDS[0])
        out.append(("refit.GradientBoostedTreesClassifier", lambda: gbt._fit_arrays(
            x, y.astype(np.float32), np.ones(len(y), np.float32), dev)))
        lr = LogisticRegression(reg_param=0.1)
        out.append(("refit.LogisticRegression", lambda: lr._fit_arrays(
            x, y.astype(np.float32), np.ones(len(y), np.float32), dev)))
        return out

    results = {}
    for _ in range(2):                        # warm-up, then the measured pass
        TT._BIN_CACHE.clear()
        from torch.profiler import ProfilerActivity, profile

        for name, thunk in parts():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                value = thunk()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            dev_events = [e for e in prof.events()
                          if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
            busy = _busy([(e.time_range.start, e.time_range.end) for e in dev_events])
            by_kernel = {}
            for e in dev_events:
                key = next((v for k, v in {**TREE_KERNELS, **LIBRARY_KERNELS}.items()
                            if k in e.name), "other")
                d = by_kernel.setdefault(key, [0.0, 0])
                d[0] += (e.time_range.end - e.time_range.start) / 1e6
                d[1] += 1
            if isinstance(value, np.ndarray):
                value = value.tolist()
            results[name] = {
                "wall_s": wall, "device_busy_s": busy / 1e6,
                "device_idle_share": 1.0 - busy / 1e6 / wall if wall else None,
                "device_events": len(dev_events),
                "device_s_by_kernel": {k: {"s": v[0], "count": v[1]}
                                       for k, v in by_kernel.items()},
                "result": value if name.startswith("cv.") else None,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    line = json.dumps({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": C.gpu_line(), "rows": args.rows,
                       "features": C.D, "parts": results})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
