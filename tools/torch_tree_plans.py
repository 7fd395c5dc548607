"""The split scan (K2) and the routing select (K3) under their plans and
under other launch shapes, at the tree sweep's shapes, on a CUDA card.

    python3 tools/torch_tree_plans.py [--out plans.json]

Every variant is held bitwise against the planned launch on the same inputs
(the variants compute the same function) and timed on the device alone
(chip_smoke.time_device_ms):

- K2 at the RF-CV deepest level (150 lanes x 32 nodes, integer histograms)
  and at a GBT level (3 lanes x 4 nodes, float histograms built by K1), the
  missing-value bin empty (as in the sweep) and filled:
  plan(), 1-4 threads sharing each feature's candidates, the histograms
  read where they lie; and, timed only (other bits), alpha not 0 (the soft
  threshold evaluated);
- K3 at 150, 50 and 3 lanes x 1 048 576 rows x 128 features: plan(), the
  other path, 32 staged rows a tile; at 3 lanes also every lane selecting
  the same feature of a row (their gathers share a sector), and the direct
  path with the L2 fetch granularity set to 32 bytes (a limit of the CUDA
  context, restored after).

Prints one JSON line with the card's name and power limit.  Needs a CUDA
card and nvcc; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: CU_LIMIT_MAX_L2_FETCH_GRANULARITY of libcuda
_L2_FETCH_LIMIT = 0x05


def _l2_fetch(value=None):
    """The current context's L2 fetch granularity; sets it first when
    ``value`` is given.  None where libcuda refuses."""
    try:
        cu = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    cu.cuCtxSetLimit.argtypes = [ctypes.c_int, ctypes.c_size_t]
    cu.cuCtxGetLimit.argtypes = [ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
    cu.cuCtxSetLimit.restype = cu.cuCtxGetLimit.restype = ctypes.c_int
    if value is not None and cu.cuCtxSetLimit(_L2_FETCH_LIMIT, value):
        return None
    out = ctypes.c_size_t()
    if cu.cuCtxGetLimit(ctypes.byref(out), _L2_FETCH_LIMIT):
        return None
    return out.value


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
    from transmogrifai_tpu_torch.perf.kernels import routing as KR
    from transmogrifai_tpu_torch.perf.kernels import splitscan as KS

    dev = torch.device("cuda", 0)
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": C.gpu_line(),
           "split_scan": {}, "row_select_lanes": {}}

    for name, gbt, seed, missing in (
            ("rf_deepest", False, 12, False), ("gbt_level", True, 14, False),
            ("rf_deepest_missing", False, 12, True),
            ("gbt_level_missing", True, 14, True)):
        a = C._scan_inputs(torch, KH, dev, gbt, seed, missing)
        L, nn, K, d, _ = a[0].shape
        p = KS.plan(L, nn, K, d, C.N_BINS)
        P, FT = p.blocks_per_cta, p.feats
        variants = {"plan": p, "unstaged": p._replace(
            staged=False, stride=0, smem=KS._scan_smem(False, P, FT, K, 0, p.groups))}
        for S in (1, 2, 3, 4):
            variants[f"groups{S}"] = p._replace(
                groups=S, threads=P * FT * S,
                smem=KS._scan_smem(True, P, FT, K, p.stride, S))
        ref = KS.launch(*a, p)
        rows = {}
        for vname, q in variants.items():
            got = KS.launch(*a, q)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                raise RuntimeError(f"K2 {vname} at {name} differs from plan()")
            rows[vname] = {"ms": C.time_device_ms(lambda q=q: KS.launch(*a, q)),
                           "plan": q._asdict()}
        alpha = a[:7] + (1e-3,) + a[8:]
        rows["alpha_not_0"] = {"ms": C.time_device_ms(lambda: KS.launch(*alpha, p)),
                               "plan": p._asdict(), "checked": False}
        res["split_scan"][name] = rows
        del a, alpha, ref
        torch.cuda.empty_cache()

    for L in (C.FOLDS * 50, 50, C.FOLDS):
        g = torch.Generator(device=dev).manual_seed(13 + L)
        binned = torch.randint(0, C.N_BINS + 1, (C.FULL_ROWS, C.D), generator=g,
                               device=dev, dtype=torch.int32)
        idx = torch.randint(0, C.D, (L, C.FULL_ROWS), generator=g, device=dev,
                            dtype=torch.int32)
        p = KR.plan(L, C.FULL_ROWS, C.D)
        stride = C.D | 1
        variants = {
            "plan": p,
            "tile64": KR.RoutePlan("tile", 64, stride, KR.THREADS,
                                   -(-C.FULL_ROWS // 64), 64 * stride * 4),
            "tile32": KR.RoutePlan("tile", 32, stride, KR.THREADS,
                                   -(-C.FULL_ROWS // 32), 32 * stride * 4),
            "direct": KR.RoutePlan("direct", KR.THREADS, 0, KR.THREADS,
                                   -(-C.FULL_ROWS // KR.THREADS), 0)}
        ref = KR.launch(binned, idx, p)
        rows = {}
        for vname, q in variants.items():
            got = KR.launch(binned, idx, q)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise RuntimeError(f"K3 {vname} at {L} lanes differs from plan()")
            rows[vname] = {"ms": C.time_device_ms(lambda q=q: KR.launch(binned, idx, q)),
                           "plan": q._asdict()}
        if L == C.FOLDS:
            same = idx[:1].expand(L, -1).contiguous()
            rows["plan_lanes_share_feature"] = {
                "ms": C.time_device_ms(lambda: KR.launch(binned, same, p)),
                "plan": p._asdict()}
            before = _l2_fetch()
            if before is not None and _l2_fetch(32) == 32:
                try:
                    rows["plan_l2_fetch_32"] = {
                        "ms": C.time_device_ms(lambda: KR.launch(binned, idx, p)),
                        "plan": p._asdict(), "l2_fetch_default": before}
                finally:
                    _l2_fetch(before)
            else:
                rows["plan_l2_fetch_32"] = {"ms": None, "l2_fetch_default": before}
        res["row_select_lanes"][L] = rows
        del binned, idx, ref
        torch.cuda.empty_cache()

    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
