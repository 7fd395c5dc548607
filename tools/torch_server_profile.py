"""Where the scoring server's time goes, on a CUDA card.

Serves the committed wide fixture (transmogrifai_tpu_torch/fixtures/serving_wide)
through ``ScoringServer`` the way ``chip_smoke.py``'s phase 4b does — client
threads each submitting one record a request, each keeping at most a window
of requests outstanding — once per configuration of (pipeline depth,
max_wait_ms, client threads), and reports one JSON object per
configuration:

- records/s (host clock from the first submit to the last result), the
  flushed batches and their sizes (mean, median, the largest), latency
  p50/p95/p99 (the batcher's histogram);
- the pipeline's producer time (the flusher's encode and dispatch) and the
  finalizer's waits on an empty ring, per batch, and the overlap fraction;
- the plan's median host encode, device prefix (CUDA events) and host head
  milliseconds per batch;
- the queue's depth, sampled every millisecond by a thread of its own
  (median and mean): how many requests were waiting when batches formed.

``chip_smoke.py``'s configuration (depth 2, 2 ms, 8 clients) runs three
times, each from a fresh server; four last runs put a bare MicroBatcher
over a scorer that returns its records, so the clients' and the batcher's
own per-request cost shows without the plan: 8 client threads and 1, at
depths 2 and 0.  ``--switch`` runs the whole set
again with a tenth of the interpreter's thread switch interval: the
clients, the flusher and the finalizer share one interpreter lock.

    python3 tools/torch_server_profile.py [--records 16384] [--switch] [--out server.json]

Needs a CUDA card; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (pipeline depth, max_wait_ms, client threads, window per client);
#: chip_smoke.py's configuration first, three times from a fresh server
CONFIGS = [(2, 2.0, 8, 256)] * 3 + [(0, 2.0, 8, 256)] * 2 + [
    (2, 20.0, 8, 256), (0, 20.0, 8, 256), (2, 2.0, 1, 2048), (0, 2.0, 1, 2048)]
#: the interpreter's thread switch interval (seconds) of a ``--switch``
#: run: how long a thread holding the GIL keeps it while others wait
SHORT_SWITCH_S = 0.0005


class _Null:
    """A scorer that returns its records: the batcher and the clients alone."""

    def __init__(self):
        self.batch_timings = []

    def begin_score(self, records):
        return lambda: list(records)

    def __call__(self, records):
        return list(records)


def run(model, records, depth, max_wait_ms, clients, window, null=False) -> dict:
    """One configuration from a fresh server (``null``: a bare MicroBatcher
    over a scorer that returns its records)."""
    import chip_smoke
    import torch
    from transmogrifai_tpu_torch.serve import MicroBatcher, ScoringServer

    if null:
        plan = _Null()
        mb = MicroBatcher(plan, max_batch=chip_smoke.BATCH, max_wait_ms=max_wait_ms,
                          pipeline_depth=depth)
        server = SimpleNamespace(batcher=mb, plan=plan, submit=mb.submit,
                                 close=mb.shutdown)
    else:
        server = ScoringServer(model, max_batch=chip_smoke.BATCH,
                               max_wait_ms=max_wait_ms, pipeline_depth=depth)
    depths, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            depths.append(server.batcher.queue_depth)
            time.sleep(0.001)

    try:
        plan = server.plan
        torch.cuda.synchronize()
        n0 = len(plan.batch_timings)
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        _, wall = chip_smoke._drive_clients(server, records, clients, window)
        stop.set()
        sampler.join(10)
        bat = server.batcher.metrics()
        timings = list(plan.batch_timings)[n0:]
    finally:
        stop.set()
        server.close()
    sizes = [int(k) for k, c in bat["batch_size_hist"].items() for _ in range(c)]
    pipe = bat["pipeline"]
    n = bat["batches"]

    def med(key):
        return statistics.median(t[key] for t in timings) if timings else None

    return {"scorer": "null" if null else "plan", "pipeline_depth": depth,
            "max_wait_ms": max_wait_ms, "clients": clients, "window": window, "records": len(records),
            "records_per_s": len(records) / wall, "seconds": wall, "batches": n,
            "mean_batch": statistics.fmean(sizes), "median_batch": statistics.median(sizes),
            "max_batch_seen": max(sizes),
            "batches_under_128": sum(1 for x in sizes if x < 128),
            **{k: bat[k] for k in ("latency_p50_ms", "latency_p95_ms", "latency_p99_ms")},
            "flusher_load_ms_per_batch": pipe["load_seconds"] * 1e3 / n if depth else None,
            "finalizer_wait_ms_per_batch": pipe["wait_seconds"] * 1e3 / n if depth else None,
            "overlap_fraction": pipe["overlap_fraction"], "stalls": pipe["stalls"],
            "encode_ms_median": med("encode_ms"), "device_ms_median": med("device_ms"),
            "host_ms_median": med("host_ms"),
            "queue_depth_median": statistics.median(depths) if depths else None,
            "queue_depth_mean": statistics.fmean(depths) if depths else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=16384)
    ap.add_argument("--out", default=None)
    ap.add_argument("--switch", action="store_true",
                    help=f"run every configuration again with sys.setswitchinterval"
                         f"({SHORT_SWITCH_S}) (default 0.005)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import chip_smoke
    from transmogrifai_tpu_torch import WorkflowModel

    with open(os.path.join(chip_smoke.FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    model = WorkflowModel.load(chip_smoke.FIXTURE)
    records = chip_smoke.make_records(schema, args.records, np.random.default_rng(1))
    runs = []
    for switch in ((None, SHORT_SWITCH_S) if args.switch else (None,)):
        default = sys.getswitchinterval()
        if switch is not None:
            sys.setswitchinterval(switch)
        try:
            part = [run(model, records, *c) for c in CONFIGS]
            part += [run(model, records, d, 2.0, clients, window, null=True)
                     for clients, window in ((8, 256), (1, 2048)) for d in (2, 0)]
        finally:
            sys.setswitchinterval(default)
        runs += [{**r, "switch_interval_s": switch or default} for r in part]
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke.gpu_line(),
           "runs": runs}
    for r in out["runs"]:
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
