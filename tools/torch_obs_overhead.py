"""What the serving path's telemetry hooks cost with telemetry off, on a CUDA card.

With telemetry off every flushed batch still carries a ``BatchTrace``
(``obs/reqtrace.py``: the per-tenant device-second counters need it), and
the hooks around it (spans, phase marks, ``maybe_profile``) reduce to a
global or contextvar read each.  This script times the host work a batch
costs on the tree at ``--repo`` (this checkout by default; another
checkout's port for an A/B, its parent say), with telemetry off:

- ``null_ms``: a bare ``MicroBatcher`` over a scorer that returns its
  records, lockstep (depth 0) and pipelined (depth 2): one thread submits
  ``--batch`` records and waits for their results, a round a batch; the
  median round in milliseconds.  Only the batcher's own per-request and
  per-flush work is in it, so a hook's cost shows here undiluted.
- ``plan_ms``: ``serving_wide``'s plan scoring ``--batch`` records
  (``plan.score``: encode, the card's prefix, the host head), the median.
- ``server_records_per_s``: ``ScoringServer`` at ``chip_smoke.py`` phase
  4b's configuration (depth 2, 2 ms, 8 client threads), once.

Run parent and change alternately, each in a fresh process, and compare
the medians of each within one call:

    python3 tools/torch_obs_overhead.py [--repo CHECKOUT] [--rounds 300] [--out o.json]

The host's speed drifts between processes, so ``--batcher-ab OTHER`` times
the bare batcher of this checkout and of ``OTHER`` in ONE process instead
(``OTHER``'s port imported under another name): rounds alternate between
the two batchers, the order flipping each pair, and the report gives each
side's median round and the median of the paired ratios, other / this.
It needs no card:

    python3 tools/torch_obs_overhead.py --batcher-ab build/ab/parent [--rounds 2000]

Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Null:
    """A scorer that returns its records: the batcher alone."""

    def __init__(self):
        self.batch_timings = []

    def begin_score(self, records):
        return lambda: list(records)

    def __call__(self, records):
        return list(records)


def _rounds(fn, rounds: int, warmup: int) -> list:
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _summary(ms: list) -> dict:
    q = statistics.quantiles(ms, n=10)
    return {"median": statistics.median(ms), "p10": q[0], "p90": q[-1]}


def _port_as(repo: str, name: str):
    """``repo``'s port package imported under the top-level name ``name``
    (its modules import each other relatively)."""
    import importlib.util

    root = os.path.join(repo, "transmogrifai_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "__init__.py"), submodule_search_locations=[root])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def batcher_ab(other: str, batch: int, rounds: int, warmup: int) -> dict:
    """This checkout's bare batcher against ``other``'s, rounds alternating
    in one process (see the module docstring)."""
    import importlib

    sys.path.insert(0, REPO)
    import transmogrifai_tpu_torch.serve as this_serve

    _port_as(os.path.abspath(other), "_other_port")
    other_serve = importlib.import_module("_other_port.serve")
    records = [{"x": float(i)} for i in range(batch)]
    out = {"other": os.path.relpath(os.path.abspath(other), REPO), "batch": batch,
           "rounds": rounds}
    for depth in (0, 2):
        mbs = [mod.MicroBatcher(_Null(), max_batch=batch, max_wait_ms=1000.0,
                                pipeline_depth=depth)
               for mod in (this_serve, other_serve)]
        try:
            def one(mb):
                t0 = time.perf_counter()
                futs = [mb.submit(r) for r in records]
                for f in futs:
                    f.result(timeout=60)
                return (time.perf_counter() - t0) * 1e3

            for _ in range(warmup):
                one(mbs[0])
                one(mbs[1])
            this_ms, other_ms = [], []
            for i in range(rounds):
                if i % 2:
                    other_ms.append(one(mbs[1]))
                    this_ms.append(one(mbs[0]))
                else:
                    this_ms.append(one(mbs[0]))
                    other_ms.append(one(mbs[1]))
        finally:
            for mb in mbs:
                mb.shutdown()
        out[f"depth{depth}"] = {
            "this_ms": _summary(this_ms), "other_ms": _summary(other_ms),
            "ratio_other_over_this": statistics.median(
                o / t for o, t in zip(other_ms, this_ms))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--server-records", type=int, default=16384)
    ap.add_argument("--batcher-ab", default=None, metavar="OTHER",
                    help="time this checkout's bare batcher against OTHER's in one process")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.batcher_ab:
        line = json.dumps(batcher_ab(args.batcher_ab, args.batch, args.rounds,
                                     args.warmup))
        print(line)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
        return 0
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke  # this checkout's records and clients, for both sides

    sys.path.insert(0, repo)
    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.serve import MicroBatcher, ScoringServer

    fixture = os.path.join(repo, chip_smoke.FIXTURE)
    with open(os.path.join(fixture, "schema.json")) as fh:
        schema = json.load(fh)
    records = chip_smoke.make_records(schema, args.batch, np.random.default_rng(0))
    out = {"repo": os.path.relpath(repo, REPO), "batch": args.batch,
           "rounds": args.rounds}

    for depth in (0, 2):
        mb = MicroBatcher(_Null(), max_batch=args.batch, max_wait_ms=1000.0,
                          pipeline_depth=depth)
        try:
            def batch_round():
                futs = [mb.submit(r) for r in records]
                for f in futs:
                    f.result(timeout=60)
            ms = _rounds(batch_round, args.rounds, args.warmup)
            assert mb.metrics()["batches"] == args.rounds + args.warmup
        finally:
            mb.shutdown()
        out[f"null_ms_depth{depth}"] = _summary(ms)

    model = WorkflowModel.load(fixture)
    plan = model.serving_plan().warm()
    out["plan_ms"] = _summary(_rounds(lambda: plan.score(records),
                                      args.rounds, args.warmup))

    server_records = chip_smoke.make_records(schema, args.server_records,
                                             np.random.default_rng(1))
    server = ScoringServer(model, max_batch=args.batch, max_wait_ms=2.0,
                           pipeline_depth=2)
    try:
        _, wall = chip_smoke._drive_clients(server, server_records, 8, 256)
    finally:
        server.close()
    out["server_records_per_s"] = len(server_records) / wall
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
