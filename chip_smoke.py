#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device   — a CUDA card must be present (else exit 1 before any result);
              its name and power limit as nvidia-smi reports them.
2. build    — nvcc builds every kernel of the serving path from the sources
              in this checkout (perf/kernels/csrc/), with ptxas's report.
3. kernels  — K4 (one-hot of level codes) and K5 (bucketize one-hot) on the
              card, held bitwise against their plain PyTorch versions on the
              same card: ragged and full row counts, codes out of range, the
              fixture's real splits with NaN, +-inf and values on a split,
              all four track_nulls x track_invalid settings.  Then each is
              timed (CUDA events around runs of 20 launches, median of 50 runs) at
              the serving shape beside its plain version, one PyTorch call
              as a yardstick, and the card's bound for the bytes it moves.
4. serving  — the committed full-width fixture (trained by the JAX package,
              saved in its format) loads through the port's load_model and
              serves 16 batches of 1024 records and one of 37 on the card.
              The launch counters are zeroed just before and read just after;
              every kernel of the path must have launched, batches x slots
              times.  The same records through the plan on the CPU (the plain
              versions) must give bitwise-equal prefix vectors and equal
              output records.
5. summary  — nvidia-smi's line, then one {"kernels": [...]} line, then the
              last line {"ok": true, "device": {...}}.

Any failure raises: the script exits non-zero and prints no last line.
It imports torch and the port only, never JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
BATCH = 1024
N_BATCHES = 16
RAGGED = 37
RUNS = 50
PER_RUN = 20
FIXTURE = os.path.join("transmogrifai_tpu_torch", "fixtures", "serving_wide")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = RUNS, per_run: int = PER_RUN,
            warmup: int = 20) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around each run
    of ``per_run`` back-to-back calls, the median over ``runs`` runs after
    warm-up.  For a kernel this small, back-to-back launches measure the
    launch rate the host sustains, which is what bounds it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_run):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / per_run for a, b in pairs)


def make_records(schema: dict, n: int, rng) -> list:
    """Requests from the fixture's schema: ~10 % missing values, ~5 % unseen
    levels, some fields absent altogether."""
    out = []
    for _ in range(n):
        r = {}
        for f in schema["features"]:
            if f.get("response"):
                continue
            u = rng.random()
            if u < 0.02:
                continue                      # field absent from the record
            if u < 0.1:
                r[f["name"]] = None
            elif f["type"] == "Real":
                r[f["name"]] = float(rng.normal())
            elif f["type"] == "Binary":
                r[f["name"]] = bool(rng.random() < 0.3)
            elif u < 0.15:
                r[f["name"]] = f"unseen{int(rng.integers(1000))}"
            else:
                r[f["name"]] = str(rng.choice(f["levels"]))
        out.append(r)
    return out


def phase_kernels(torch, KE, bucketizer_models, dev) -> dict:
    import numpy as np

    rng = np.random.default_rng(0)
    width = 22
    err = {"onehot_codes": 0.0, "bucketize_right_encode": 0.0}
    checked = {"onehot_codes": 0, "bucketize_right_encode": 0}
    for n in (BATCH, RAGGED):
        codes = rng.integers(-1, width + 6, n).astype(np.int32)
        codes[:4] = [-1, width, width + 5, 0]
        c = torch.from_numpy(codes).to(dev)
        got = KE.onehot_codes(c, width)
        ref = KE.onehot_codes_torch(c, width)
        torch.cuda.synchronize()
        check(got.shape == (n, width) and torch.equal(got, ref),
              f"K4 bitwise at n={n}")
        err["onehot_codes"] = max(err["onehot_codes"],
                                  float((got - ref).abs().max()))
        checked["onehot_codes"] += 1
    for m in bucketizer_models:
        splits = np.asarray(m.splits, np.float32)
        s = torch.from_numpy(splits).to(dev)
        for n in (BATCH, RAGGED):
            x = rng.normal(size=n).astype(np.float32)
            x[::7] = np.nan
            x[1], x[2] = np.inf, -np.inf
            finite = splits[np.isfinite(splits)]
            x[3:3 + len(finite)] = finite      # exactly on a split
            xt = torch.from_numpy(x).to(dev)
            for tn in (True, False):
                for ti in (True, False):
                    got = KE.bucketize_right_encode(xt, s, tn, ti)
                    ref = KE.bucketize_right_encode_torch(xt, s, tn, ti)
                    torch.cuda.synchronize()
                    check(got.shape == ref.shape and torch.equal(got, ref),
                          f"K5 bitwise splits={splits.tolist()} n={n} "
                          f"track_nulls={tn} track_invalid={ti}")
                    err["bucketize_right_encode"] = max(
                        err["bucketize_right_encode"],
                        float((got - ref).abs().max()))
                    checked["bucketize_right_encode"] += 1

    # timings at the serving shape: one bucket of 1024 rows, a PickList
    # slot's 22 columns, the fixture's first bucketizer with its flags
    F = torch.nn.functional
    codes = torch.from_numpy(rng.integers(0, width, BATCH).astype(np.int32)).to(dev)
    codes64 = codes.long()
    m = bucketizer_models[0]
    s = torch.from_numpy(np.asarray(m.splits, np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=BATCH).astype(np.float32)).to(dev)
    nb = int(s.shape[0]) - 1
    bw = KE.bucket_width(int(s.shape[0]), m.track_nulls, m.track_invalid)
    t = {
        "onehot_codes": dict(
            ms=time_ms(lambda: KE.onehot_codes(codes, width)),
            plain_ms=time_ms(lambda: KE.onehot_codes_torch(codes, width)),
            library_ms=time_ms(lambda: F.one_hot(codes64, width).float()),
            library="torch.nn.functional.one_hot(codes, width).float()",
            bytes=BATCH * 4 + BATCH * width * 4, shape=[BATCH, width]),
        "bucketize_right_encode": dict(
            ms=time_ms(lambda: KE.bucketize_right_encode(
                x, s, m.track_nulls, m.track_invalid)),
            plain_ms=time_ms(lambda: KE.bucketize_right_encode_torch(
                x, s, m.track_nulls, m.track_invalid)),
            library_ms=time_ms(lambda: F.one_hot(
                (torch.bucketize(x, s) - 1).clamp(0, nb - 1), nb).float()),
            library="composite: torch.bucketize + one_hot (buckets only, "
                    "no invalid/null columns)",
            bytes=BATCH * 4 + int(s.shape[0]) * 4 + BATCH * bw * 4,
            shape=[BATCH, bw], splits=int(s.shape[0])),
    }
    for k, v in t.items():
        v["bound_ms"] = v["bytes"] / HBM_BYTES_PER_S * 1e3
        v["max_abs_err"] = err[k]
        v["parity_cases"] = checked[k]
    emit({"phase": "kernels", **{k: v for k, v in t.items()}})
    return t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    os.chdir(here)
    import numpy as np

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.ops.bucketizers import DecisionTreeNumericBucketizerModel
    from transmogrifai_tpu_torch.ops.onehot import OneHotVectorizerModel
    from transmogrifai_tpu_torch.perf.kernels import dispatch
    from transmogrifai_tpu_torch.perf.kernels import encode as KE

    # 1. device
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = gpu_line()
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    dispatch.build(["encode"])
    KE._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": dispatch.BUILD_INFO["encode"]["seconds"],
          "ptxas": [ln for ln in str(dispatch.BUILD_INFO["encode"]["log"]).splitlines()
                    if "Used" in ln or "spill" in ln]})

    # 3. kernels
    model = WorkflowModel.load(FIXTURE)
    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    buckets = [t for t in model.fitted.values()
               if isinstance(t, DecisionTreeNumericBucketizerModel) and t.should_split]
    check(len(buckets) > 0, "fixture has a bucketizer with real splits")
    timings = phase_kernels(torch, KE, buckets, dev)

    # 4. serving
    plan = model.serving_plan()
    check(plan.device.type == "cuda", "serving_plan() defaults to the card")
    cpu_plan = model.serving_plan(device="cpu")
    onehot_slots = sum(len(r.vocabs) for r in plan._prefix
                       if isinstance(r, OneHotVectorizerModel))
    bucket_slots = sum(1 for r in plan._prefix
                       if isinstance(r, DecisionTreeNumericBucketizerModel)
                       and r.should_split)
    rng = np.random.default_rng(1)
    batches = [make_records(schema, BATCH, rng) for _ in range(N_BATCHES)]
    batches.append(make_records(schema, RAGGED, rng))
    plan.score(make_records(schema, BATCH, rng))   # warm-up (allocator, consts)
    torch.cuda.synchronize()

    KE.reset_launch_counts()
    rows, parts = [], []
    t0 = time.perf_counter()
    for b in batches[:N_BATCHES]:
        rows.append(plan.score(b))
        parts.append(dict(plan.last_timings))
    wall_full = time.perf_counter() - t0
    rows.append(plan.score(batches[-1]))
    parts.append(dict(plan.last_timings))
    launches = KE.launch_counts()

    n_batches = len(batches)
    check(launches["onehot_codes"] == n_batches * onehot_slots > 0,
          f"K4 launches {launches['onehot_codes']} == {n_batches} x {onehot_slots}")
    check(launches["bucketize_right_encode"] == n_batches * bucket_slots > 0,
          f"K5 launches {launches['bucketize_right_encode']} == "
          f"{n_batches} x {bucket_slots}")

    pred_name = next(f.name for f in model.result_features
                     if f.ftype.__name__ == "Prediction")
    for b, got in zip(batches, rows):
        check(len(got) == len(b), "one output record per request")
        for r in got:
            p = r[pred_name]
            check(all(np.isfinite(v) for v in p.values())
                  and 0.0 <= p["probability_1"] <= 1.0, f"finite prediction {p}")
        check(cpu_plan.score(b) == got, "card records == CPU plan records")
        dev_vec = plan.prefix_outputs(b)
        cpu_vec = cpu_plan.prefix_outputs(b)
        check(all(a.shape == c.shape and a.dtype == c.dtype
                  and a.tobytes() == c.tobytes() for a, c in zip(dev_vec, cpu_vec)),
              "prefix vectors bitwise equal on card and CPU")

    def med(key):
        return statistics.median(p[key] for p in parts[:N_BATCHES])

    emit({"phase": "serving", "batches": n_batches, "batch": BATCH,
          "ragged": RAGGED, "records_per_s": N_BATCHES * BATCH / wall_full,
          "encode_ms_median": med("encode_ms"),
          "device_prefix_ms_median": med("device_ms"),
          "host_head_ms_median": med("host_ms"),
          "device_prefix_ms": [p["device_ms"] for p in parts],
          "vector_width": int(cpu_vec[0].shape[1]),
          "launches": launches, "onehot_slots": onehot_slots,
          "bucketize_slots": bucket_slots,
          "records_equal_cpu": True, "prefix_bitwise_cpu": True})

    # 5. summary
    kernels = []
    for kname, replaces in (("onehot_codes", "transmogrifai_tpu/perf/kernels/encode.py:76"),
                            ("bucketize_right_encode",
                             "transmogrifai_tpu/perf/kernels/encode.py:105")):
        t = timings[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "transmogrifai_tpu_torch/perf/kernels/csrc/encode.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": t["max_abs_err"], "parity": "bitwise",
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
            "library": t["library"], "shape": t["shape"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
