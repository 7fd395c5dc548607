"""Where the port's serving time goes, on a CUDA card.

Serves the committed wide fixture (transmogrifai_tpu_torch/fixtures/serving_wide)
in batches of 1024 records and reports, as one JSON line:

- records/s over the timed batches (host clock, each batch ending in the
  device->host copy that synchronises) and per-part host-clock milliseconds
  of each batch (host encode, device prefix incl. its copies, host head),
  medians over the batches;
- the encode kernel's launches and slots per batch and the plan's
  host->device copies per batch, from the port's own counters (null where
  the port has no such counter);
- a torch.profiler trace of a few steady batches: device time per kernel
  name (top entries), the count of host->device copies the trace saw, the
  total device-busy time, and the device idle share of the profiled window
  (1 - busy / window);
- the one-slot wrappers ``onehot_codes`` and ``bucketize_right_encode``
  timed host-inclusive (``chip_smoke.time_ms``: back-to-back calls between
  CUDA events) at a slot's serving shape: the fixture's first one-hot slot
  and first bucketizer with splits, on a 1024-row batch.

    python3 tools/torch_serving_profile.py [--batches 8] [--out profile.json]
    python3 tools/torch_serving_profile.py --repo build/ab/OTHER   # another checkout's port

``--repo`` serves the port of another checkout (unpacked with ``git
archive``), so two versions can be compared in one call on one card, in
turns.  Needs a CUDA card; imports torch and the port only.
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
    ap.add_argument("--repo", default=REPO, help="checkout whose port is served")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, REPO)
    import chip_smoke
    sys.path.insert(0, repo)
    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.perf.kernels import encode as KE

    fixture = os.path.join(repo, chip_smoke.FIXTURE)
    with open(os.path.join(fixture, "schema.json")) as fh:
        schema = json.load(fh)
    plan = WorkflowModel.load(fixture).serving_plan()
    rng = np.random.default_rng(2)
    batches = [chip_smoke.make_records(schema, args.batch, rng)
               for _ in range(args.batches + 2)]
    for b in batches[:2]:
        plan.score(b)                                 # warm-up
    torch.cuda.synchronize()
    KE.reset_launch_counts()
    copies0 = plan.metrics().get("h2d_copies")
    parts = []
    t0 = time.perf_counter()
    for b in batches[2:]:
        plan.score(b)
        parts.append(dict(plan.last_timings))
    wall = time.perf_counter() - t0
    counts = KE.launch_counts()
    copies = plan.metrics().get("h2d_copies")

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
    n = args.batches

    def per_batch(key):
        return counts[key] / n if key in counts else None

    out = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.gpu_line(),
        "repo": os.path.relpath(repo, REPO),
        "batch": args.batch, "batches": n,
        "records_per_s": n * args.batch / wall,
        "encode_ms_median": statistics.median(p["encode_ms"] for p in parts),
        "device_prefix_ms_median": statistics.median(p["device_ms"] for p in parts),
        "host_head_ms_median": statistics.median(p["host_ms"] for p in parts),
        "device_prefix_ms": [p["device_ms"] for p in parts],
        "encode_launches_per_batch": per_batch("encode_slots"),
        "slots_per_batch": per_batch("encode_slots.slots"),
        "one_slot_launches_per_batch": (counts.get("onehot_codes", 0)
                                        + counts.get("bucketize_right_encode", 0)) / n,
        "h2d_copies_per_batch": (copies - copies0) / n if copies is not None else None,
        "profiled_batches": 3,
        "profiled_window_us": window_us,
        "device_busy_us": busy,
        "device_idle_share": 1.0 - busy / window_us if window_us else None,
        "device_events": len(kernels),
        "profiled_h2d_copies": sum(c for name, (_, c) in by_name.items()
                                   if "HtoD" in name),
        "top_device_time_us": [{"name": n[:90], "us": v[0], "count": v[1]}
                               for n, v in top],
    }
    from transmogrifai_tpu_torch.ops.bucketizers import DecisionTreeNumericBucketizerModel
    from transmogrifai_tpu_torch.ops.onehot import OneHotVectorizerModel

    onehot = next(r for r in plan._prefix if isinstance(r, OneHotVectorizerModel))
    bucket = next(r for r in plan._prefix
                  if isinstance(r, DecisionTreeNumericBucketizerModel) and r.should_split)
    width = onehot.slot_width(0)
    rng = np.random.default_rng(4)
    codes = torch.from_numpy(rng.integers(-1, width + 1, args.batch).astype(np.int32)).cuda()
    vals = torch.from_numpy(rng.normal(size=args.batch).astype(np.float32)).cuda()
    splits = torch.tensor(bucket.splits, dtype=torch.float32, device="cuda")
    out["one_slot_ms"] = {
        "onehot_codes": chip_smoke.time_ms(lambda: KE.onehot_codes(codes, width)),
        "bucketize_right_encode": chip_smoke.time_ms(lambda: KE.bucketize_right_encode(
            vals, splits, bucket.track_nulls, bucket.track_invalid)),
        "shape": {"rows": args.batch, "onehot_width": width,
                  "splits": len(bucket.splits)}}
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
