"""Which ``torch.profiler`` captures of one served batch lose GPU events, on a CUDA card.

Serves ``serving_wide`` (``transmogrifai_tpu_torch/fixtures/serving_wide``)
through its plan, 1024 records a batch, and captures single batches with
``torch.profiler`` as ``TMOG_PROFILE`` does (``obs/profile.py``), counting
in each exported Chrome trace the device's kernel, copy and set events
(17 for a complete batch) and whether ``encode_slots_kernel`` is among
them.  Fifteen times it serves for ``--gap`` seconds, then takes two
captures back to back, in turn: plain CPU + CUDA, each after a throwaway
session of 100 ms, CUDA-only, with the window padded by 200 ms on each
side of the batch, and through ``TMOG_PROFILE`` itself (with
``last_capture()``'s launch and kernel counts); one JSON line each time.  Each capture also gives the
spread of its device events' start minus their launch's (``d_min_us``,
``d_med_us``, joined on the correlation id).

    python3 tools/torch_profile_age.py [--gap 30] [--out o.json]

Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace(prof) -> list:
    d = tempfile.mkdtemp()
    p = os.path.join(d, "t.json")
    prof.export_chrome_trace(p)
    with open(p) as fh:
        return json.load(fh)["traceEvents"]


def _gpu(evs) -> list:
    return [e for e in evs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gap", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from transmogrifai_tpu_torch import WorkflowModel

    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cuda = [ProfilerActivity.CUDA]
    fixture = os.path.join(REPO, chip_smoke.FIXTURE)
    with open(os.path.join(fixture, "schema.json")) as fh:
        schema = json.load(fh)
    recs = chip_smoke.make_records(schema, 1024, np.random.default_rng(0))
    plan = WorkflowModel.load(fixture).serving_plan().warm()

    def score():
        plan.score(recs)

    def capture(pad_s=0.0, acts=both, throw_s=None):
        torch.cuda.synchronize()
        if throw_s is not None:
            p0 = profile(activities=both)
            p0.start()
            time.sleep(throw_s)
            p0.stop()
        prof = profile(activities=acts)
        prof.start()
        if pad_s:
            time.sleep(pad_s)
        score()
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
        prof.stop()
        evs = _trace(prof)
        gpu = _gpu(evs)
        rt = {e["args"]["correlation"]: e for e in evs
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        deltas = [e["ts"] - rt[e["args"]["correlation"]]["ts"] for e in gpu
                  if e.get("args", {}).get("correlation") in rt]
        return {"gpu": len(gpu),
                "enc": any("encode_slots" in e.get("name", "") for e in gpu),
                "d_min_us": round(min(deltas), 1) if deltas else None,
                "d_med_us": round(statistics.median(deltas), 1) if deltas else None}

    from transmogrifai_tpu_torch.obs.profile import last_capture

    prof_dir = tempfile.mkdtemp(prefix="tmog_profile_age_")

    def tmog_capture():
        os.environ["TMOG_PROFILE"] = prof_dir
        try:
            score()
        finally:
            del os.environ["TMOG_PROFILE"]
        cap = last_capture()
        with open(cap["path"]) as fh:
            gpu = _gpu(json.load(fh)["traceEvents"])
        return {"gpu": len(gpu),
                "enc": any("encode_slots" in e.get("name", "") for e in gpu),
                "launches": cap["launches"], "kernels": cap["kernels"],
                "complete": cap["complete"]}

    def serve_for(seconds):
        t = time.monotonic()
        while time.monotonic() - t < seconds:
            score()

    t0 = time.monotonic()
    rows = []

    def emit(row):
        row = {"age_s": round(time.monotonic() - t0, 1), **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    kinds = {"plain": capture, "throw100ms": lambda: capture(throw_s=0.1),
             "cuda_only": lambda: capture(acts=cuda),
             "pad200ms": lambda: capture(pad_s=0.2), "tmog_profile": tmog_capture}
    for i in range(15):
        serve_for(args.gap)
        kind = list(kinds)[i % len(kinds)]
        emit({"kind": kind, "first": kinds[kind](), "second": kinds[kind]()})
    out = {"gap_s": args.gap, "torch": torch.__version__, "rows": rows}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
