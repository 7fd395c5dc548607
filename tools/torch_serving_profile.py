"""Where the port's serving time goes, on a CUDA card.

Serves the committed wide fixture (transmogrifai_tpu_torch/fixtures/serving_wide)
in batches of 1024 records and reports, as one JSON line:

- per-part host-clock milliseconds of each batch (host encode, device prefix
  incl. its copies, host head), medians over the batches;
- a torch.profiler trace of a few steady batches: device time per kernel
  name (top entries), the total device-busy time, and the device idle share
  of the profiled window (1 - busy / window).

    python3 tools/torch_serving_profile.py [--batches 8] [--out profile.json]

Needs a CUDA card; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from transmogrifai_tpu_torch import WorkflowModel

    fixture = os.path.join(REPO, chip_smoke.FIXTURE)
    with open(os.path.join(fixture, "schema.json")) as fh:
        schema = json.load(fh)
    plan = WorkflowModel.load(fixture).serving_plan()
    rng = np.random.default_rng(2)
    batches = [chip_smoke.make_records(schema, args.batch, rng)
               for _ in range(args.batches + 2)]
    for b in batches[:2]:
        plan.score(b)                                 # warm-up
    torch.cuda.synchronize()
    parts = []
    for b in batches[2:]:
        plan.score(b)
        parts.append(dict(plan.last_timings))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[2:5]:
            plan.score(b)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: kernels and copies, not the host ops around them
    kernels = []
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.append((evt.name, evt.time_range.start, evt.time_range.end))
    busy = 0.0
    last_end = -1.0
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        s = max(s, last_end)
        if e > s:
            busy += e - s
            last_end = e
    by_name = {}
    for name, s, e in kernels:
        d = by_name.setdefault(name, [0.0, 0])
        d[0] += e - s
        d[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.gpu_line(),
        "batch": args.batch, "batches": args.batches,
        "encode_ms_median": statistics.median(p["encode_ms"] for p in parts),
        "device_prefix_ms_median": statistics.median(p["device_ms"] for p in parts),
        "host_head_ms_median": statistics.median(p["host_ms"] for p in parts),
        "profiled_batches": 3,
        "profiled_window_us": window_us,
        "device_busy_us": busy,
        "device_idle_share": 1.0 - busy / window_us if window_us else None,
        "device_events": len(kernels),
        "top_device_time_us": [{"name": n[:90], "us": v[0], "count": v[1]}
                               for n, v in top],
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
