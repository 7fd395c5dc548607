"""What the card's torch.distributed backends take, in child processes of
their own on one card (the facts phase 29 of chip_smoke.py is built on).

- NCCL with two ranks on one device: the collective's outcome (NCCL refuses
  a duplicate GPU) and its words;
- gloo with two ranks on one device: all_reduce, broadcast, all_gather and
  all_gather_into_tensor of CUDA tensors, each ok or its error's words.

    python3 tools/torch_mesh_probe.py --out chiprun_out/mesh_probe.json

Each rank has a 60 s process-group timeout and the probe kills both ranks
past 120 s.  Prints one JSON object; writes it to ``--out`` too.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def rank(argv) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    backend, r, init, out = argv[0], int(argv[1]), argv[2], argv[3]
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{init}", world_size=2,
                            rank=r, timeout=datetime.timedelta(seconds=60))
    res = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:  # the words are the finding
            res[name] = f"{type(e).__name__}: {e}"[:600]

    t = torch.full((4,), float(r + 1), device="cuda")
    attempt("all_reduce", lambda: dist.all_reduce(t))
    res["all_reduce_value"] = t.tolist() if res["all_reduce"] == "ok" else None
    if backend == "gloo":
        b = torch.full((4,), float(r), device="cuda")
        attempt("broadcast", lambda: dist.broadcast(b, src=0))
        parts = [torch.empty(4, device="cuda") for _ in range(2)]
        attempt("all_gather", lambda: dist.all_gather(parts, t))
        big = torch.empty(8, device="cuda")
        attempt("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(big, t))
    with open(out, "w") as fh:
        json.dump(res, fh)
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        rank(sys.argv[2:])
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_probe: no CUDA device", file=sys.stderr)
        return 1
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0),
              "device_count": torch.cuda.device_count()}
    for backend in ("nccl", "gloo"):
        tmp = tempfile.mkdtemp()
        init = os.path.join(tmp, "rdv")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                                   backend, str(r), init, os.path.join(tmp, f"{r}.json")],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        t0 = time.monotonic()
        outs = []
        for p in procs:
            try:
                o, e = p.communicate(timeout=max(1.0, 120 - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                o, e = p.communicate()
                e = (e or "") + "\n[killed at the probe's 120 s limit]"
            outs.append((p.returncode, e))
        ranks = []
        for r in range(2):
            path = os.path.join(tmp, f"{r}.json")
            got = json.load(open(path)) if os.path.exists(path) else None
            ranks.append({"rc": outs[r][0], "result": got,
                          "stderr_tail": outs[r][1][-1500:]})
        report[backend] = {"ranks": ranks, "seconds": time.monotonic() - t0}
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
