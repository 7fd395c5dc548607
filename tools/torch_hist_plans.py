"""K1, the level histogram, on a CUDA card under ``histogram.plan()`` and
under other tilings, at the training path's levels.

For the int8 path (RF CV, 150 lanes: the root, 4 and 16 nodes) and the
float path (GBT, 3 lanes: the root and 2 nodes) at 1 048 576 rows x 128
features, each tiling is held against the plain version (int8 bitwise,
float within ``f32_tolerance`` and bitwise run to run) and timed (CUDA
events, median of 5 launches).  Prints one JSON line; the tilings that
``plan()`` does not choose show what its choice is worth.

    python3 tools/torch_hist_plans.py [--out p.json]

Needs a CUDA card; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variants(C, KH, L: int, nn: int, int_exact: bool) -> dict:
    """name -> tiles: plan()'s and a few others of the same kernel."""
    base = KH.plan(L, C.FULL_ROWS, C.D, nn, 2, C.N_BINS, int_exact)
    tiles = {k: base[k] for k in ("G", "NT", "FT", "threads", "R")}
    out = {"plan": tiles}
    if int_exact:
        out["512 threads"] = {**tiles, "threads": 512}
        half_nt = -(-tiles["NT"] // 2)
        half_g = -(-tiles["G"] // 2)
        out["512 threads, half the units (2 CTAs/SM)"] = {
            **tiles, "threads": 512, "NT": half_nt if tiles["NT"] > 1 else 1,
            "G": half_g if tiles["NT"] == 1 else tiles["G"]}
    else:
        for name, over in (("R 16", {"R": 16}), ("FT 64", {"FT": 64}),
                           ("FT 64, R 16", {"FT": 64, "R": 16})):
            t = {**tiles, **over,
                 "threads": tiles["threads"] * over.get("FT", tiles["FT"]) // tiles["FT"]}
            if t not in out.values():
                out[name] = t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from transmogrifai_tpu_torch.perf.kernels import histogram as KH

    dev = torch.device("cuda", 0)
    results = []
    for L, nn, root, int_exact in ((C.FOLDS * 50, 16, False, True),
                                   (C.FOLDS * 50, 4, False, True),
                                   (C.FOLDS * 50, 1, True, True),
                                   (C.FOLDS, 2, False, False),
                                   (C.FOLDS, 1, True, False)):
        local, gh, binned = C._hist_inputs(torch, dev, L, C.FULL_ROWS, nn,
                                           int_exact, 20 + nn, root=root)
        n = C.FULL_ROWS
        ref = KH.hist_level_torch(local, gh, binned, nn, C.N_BINS,
                                  int_exact=int_exact)
        tol = None if int_exact else KH.f32_tolerance(KH.hist_level_torch(
            local, gh.abs(), binned, nn, C.N_BINS))
        for name, tiles in _variants(C, KH, L, nn, int_exact).items():
            p = KH.finish_plan(tiles, L, n, C.D, nn, 2, C.N_BINS, int_exact)
            most = 1024 if int_exact else KH.F32_MAX_THREADS
            if p["smem"] > 227 * 1024 or p["threads"] > most:
                continue
            run = lambda: KH.launch(local, gh, binned, nn, C.N_BINS,  # noqa: E731
                                    int_exact, p)
            got, again = run(), run()
            torch.cuda.synchronize()
            if int_exact:
                ok = torch.equal(got, ref)
            else:
                ok = torch.equal(got, again) and bool(((got - ref).abs() <= tol).all())
            C.check(ok, f"K1 {name} at L={L} nn={nn} root={root} agrees")
            results.append({"path": "int8" if int_exact else "float32",
                            "lanes": L, "nodes": nn, "root": root,
                            "variant": name, "ms": C.time_big_ms(run),
                            "plan": {k: p[k] for k in ("G", "NT", "FT", "threads",
                                                       "R", "slices", "merge",
                                                       "smem")}})
            del got, again
        del local, gh, binned, ref, tol
        torch.cuda.empty_cache()
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
