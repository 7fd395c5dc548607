"""Level histogram of tree growth (K1): CUDA kernel, plain version, counter.

Counterpart of ``transmogrifai_tpu/perf/kernels/histogram.py``.

    out[(l, node, c), b*d + f] = sum_i [local[l, i] == node] * ghT[l, c, i]
                                       * [binned[i, f] == b]

for lanes ``l``, nodes ``node < nn``, grad/hess channels ``c < 2K``, bins
``b <= n_bins`` (``n_bins`` is the missing-value bin) and features ``f``.
A row whose ``local`` is negative (or >= nn), or whose code is outside
[0, n_bins], adds nothing.

- :func:`hist_level` — the wrapper: checks, allocates, launches
  ``tmog_hist_level`` of ``csrc/trees.cu`` on the current stream without
  synchronising, and counts the launch.  A CPU tensor takes the plain version.
- :func:`hist_level_torch` — the plain version, the reference's one-hot GEMM
  (``hist_level_xla``) row chunk by row chunk.  The int-exact path multiplies
  in float64 (torch has no int8 GEMM), which is exact for these integer
  operands, and returns int32; the float path multiplies in float32.
- ``launches`` — the launch counter (``chan_tiled_launches``: of them, the
  launches that tiled the channels).

Two paths, as in the reference, each its own kernel over the tiling that
:func:`plan` chooses by shape: ``int_exact`` (``ghT`` int8, int32 out —
exact under any order, so many warps add into one accumulator set with
shared-memory atomics) and float32 (``ghT`` float32, float32 out: each
thread owns its accumulator column and adds rows in order, so two launches
on the same inputs give the same bits; against the plain version they agree
to rounding, see :func:`f32_tolerance`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import dispatch

launches = 0
#: of them, launches whose plan tiles the channels (more than one channel tile)
chan_tiled_launches = 0

#: rows per chunk of the plain version's one-hot GEMM (bounds its temporaries)
PLAIN_CHUNK = 2048

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tmog_hist_level": (_VP, _VP, _VP, _VP, _VP) + (_INT,) * 15 + (_VP,),
}

#: the H100: SMs, shared memory per SM and the most one CTA may take, threads
_SMS = 132
_SM_SMEM = 228 * 1024
_CTA_SMEM_MAX = 227 * 1024
_MAX_THREADS = 1024
#: int8 path: warps sharing one accumulator set, the shared memory it aims
#: for (one CTA per SM), the most lanes a CTA stages, fewest rows per slice
_INT_WARPS = 32
_INT_SMEM = 220 * 1024
_INT_MAX_LANES = 8
_INT_MIN_SLICE_ROWS = 8192
#: the int8 path's int32 accumulators hold sums up to this
INT32_MAX = 2 ** 31 - 1
#: rows whose int8 sums stay within int32 whatever the values (|v| <= 128);
#: past it the wrapper bounds the sums from the data (:func:`int_abs_sum_bound`)
INT_SAFE_ROWS = INT32_MAX // 128
#: lane-channel-rows an int64 reduction of :func:`int_abs_sum_bound` takes at once
_ABS_SUM_CHUNK = 1 << 26
#: float path: the most threads of a CTA (the kernel's launch bound), the
#: shared memory that lets two CTAs share an SM (tried first), staged rows per
#: block, fewest rows per slice, and the most bytes the slice partials may take
F32_MAX_THREADS = 512
_F32_SMEM = 112 * 1024
_F32_STAGE_ROWS = (32, 16)
_F32_MIN_SLICE_ROWS = 2048
_MAX_PARTIAL_BYTES = 512 * 1024 * 1024


def reset_launch_counts() -> None:
    global launches, chan_tiled_launches
    launches = chan_tiled_launches = 0


def launch_counts() -> dict:
    return {"hist_level": launches, "hist_level.chan_tiled": chan_tiled_launches}


def _lib():
    return dispatch.load("trees", _SIGNATURES)


def out_width(n_bins: int, d: int) -> int:
    return (int(n_bins) + 1) * int(d)


def hist_level_torch(local: torch.Tensor, ghT: torch.Tensor,
                     binned: torch.Tensor, nn: int, n_bins: int, *,
                     int_exact: bool = False) -> torch.Tensor:
    """(L*nn*2K, (n_bins+1)*d) histograms by the reference's one-hot GEMM:
    node one-hot x gh channels contracted with the joint (bin, feature)
    one-hot, accumulated chunk by chunk in row order."""
    L, n = local.shape
    two_k = ghT.shape[1]
    d = binned.shape[1]
    B = n_bins + 1
    M = L * nn * two_k
    mm_t = torch.float64 if int_exact else torch.float32
    dev = local.device
    node_ids = torch.arange(nn, dtype=torch.int32, device=dev)
    bin_ids = torch.arange(B, dtype=torch.int32, device=dev)
    hist = torch.zeros((M, B * d), dtype=mm_t, device=dev)
    for lo in range(0, n, PLAIN_CHUNK):
        hi = min(n, lo + PLAIN_CHUNK)
        lb = local[:, lo:hi]
        gb = ghT[:, :, lo:hi].to(mm_t)
        node_oh = (lb[:, None, :] == node_ids[None, :, None]).to(mm_t)
        acc = (node_oh[:, :, None, :] * gb[:, None, :, :]).reshape(M, hi - lo)
        bin_oh = (binned[lo:hi, None, :] == bin_ids[None, :, None]) \
            .to(mm_t).reshape(hi - lo, B * d)
        hist += acc @ bin_oh
    return hist.to(torch.int32) if int_exact else hist


def f32_tolerance(abs_hist: torch.Tensor) -> torch.Tensor:
    """Per-cell bound on |kernel - plain| for the float path: the two sum the
    same terms in different orders, so each may be off by a few roundings of
    the cell's absolute sum (``abs_hist``: the plain histogram of |gh|)."""
    return 1e-5 * abs_hist + 1e-6


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on unsupported device {t.device}")


def _feature_tiles(d: int) -> list:
    """Feature tiles a CTA may take, widest first: all of d (rounded up to
    32, at most 128), then 64 and 32."""
    first = min(128, -(-d // 32) * 32)
    return [first] + [ft for ft in (64, 32) if ft < first]


def _balanced(total: int, most: int) -> int:
    """The even tile size of ``total`` items in tiles of at most ``most``."""
    return -(-total // -(-total // most))


def _too_big(two_k: int, B: int) -> ValueError:
    return ValueError(
        f"histogram of one channel of {two_k} x {B} bins does not fit one "
        f"CTA's shared memory ({B * 32 * 4} bytes per 32 features)")


def _int8_tiles(L: int, d: int, nn: int, two_k: int, B: int) -> dict:
    """int8 path: the widest feature tile of which one (lane, node) with
    all its channels fits, then as many nodes as fit, then lanes (a row's
    codes are fetched once for all lanes of a CTA in which it is live).
    Where no feature tile holds all channels, the widest feature tile that
    holds one channel holds as many as fit (``CT``, even tiles), one (lane,
    node) a CTA."""
    warps = _INT_WARPS
    stage = lambda G, CT: warps * G * 32 * (1 + CT)  # noqa: E731
    for FT in _feature_tiles(d):
        CT = two_k
        unit = CT * B * FT * 4
        units = (_INT_SMEM - stage(1, CT)) // unit
        if units >= 1:
            break
    else:
        for FT in _feature_tiles(d):
            most = (_INT_SMEM - stage(1, 0)) // (B * FT * 4 + stage(1, 1) - stage(1, 0))
            if most >= 1:
                break
        else:
            raise _too_big(two_k, B)
        CT = _balanced(two_k, most)
        unit = CT * B * FT * 4
        units = (_INT_SMEM - stage(1, CT)) // unit
    NT = _balanced(nn, units)
    G = max(1, min(L, units // NT, _INT_MAX_LANES))
    while G > 1 and G * NT * unit + stage(G, CT) > _INT_SMEM:
        G -= 1
    G = _balanced(L, G)
    return {"G": G, "CT": CT, "NT": NT, "FT": FT, "threads": 32 * warps, "R": 32}


def _f32_smem(G: int, NT: int, FT: int, R: int, CT: int, B: int) -> int:
    """Bytes of the float kernel's shared memory: accumulators of G lanes x
    NT nodes x CT channels x B bins x FT features, and two stages of R rows
    (codes, node ids, the CT channels' grad/hess)."""
    return 4 * (G * NT * CT * B * FT + 2 * (R * FT + G * R + G * CT * R))


def _f32_tiles(L: int, d: int, nn: int, two_k: int, B: int) -> dict:
    """float path: every lane and node of the level in one CTA where they
    fit (each row's codes then read once per feature tile), with the most
    staged rows (a block's syncs and ballots then serve more rows), then the
    widest feature tile; else tiles of 32 features, as many nodes as fit,
    then lanes.  A thread owns one (lane, node, feature) column.  A CTA small
    enough that two share an SM is tried first."""
    for budget in (_F32_SMEM, _CTA_SMEM_MAX):
        for R in _F32_STAGE_ROWS:
            for FT in _feature_tiles(d):
                if L * nn * FT > F32_MAX_THREADS:
                    continue
                if _f32_smem(L, nn, FT, R, two_k, B) <= budget:
                    return {"G": L, "CT": two_k, "NT": nn, "FT": FT,
                            "threads": L * nn * FT, "R": R}
        R = _F32_STAGE_ROWS[-1]
        fits = lambda G, NT: (G * NT * 32 <= F32_MAX_THREADS  # noqa: E731
                              and _f32_smem(G, NT, 32, R, two_k, B) <= budget)
        if not fits(1, 1):
            continue
        NT = nn
        while not fits(1, NT):
            NT -= 1
        NT = _balanced(nn, NT)
        G = L
        while not fits(G, NT):
            G -= 1
        G = _balanced(L, G)
        R = next(r for r in _F32_STAGE_ROWS
                 if _f32_smem(G, NT, 32, r, two_k, B) <= budget)
        return {"G": G, "CT": two_k, "NT": NT, "FT": 32, "threads": G * NT * 32,
                "R": R}
    return _f32_chan_tiles(L, nn, two_k, B)


def _f32_chan_tiles(L: int, nn: int, two_k: int, B: int) -> dict:
    """float path where one CTA cannot hold every channel of a (lane, node):
    tiles of 32 features, the level's nodes and then lanes up to
    ``F32_MAX_THREADS`` threads, and as many channels as then fit a CTA's
    shared memory (even tiles); fewer lanes, then nodes, where not one
    channel fits."""
    FT, R = 32, _F32_STAGE_ROWS[-1]
    NT = _balanced(nn, min(nn, F32_MAX_THREADS // FT))
    G = _balanced(L, min(L, F32_MAX_THREADS // (FT * NT)))

    def most(G: int, NT: int) -> int:
        fixed = _f32_smem(G, NT, FT, R, 0, B)
        per = _f32_smem(G, NT, FT, R, 1, B) - fixed
        return (_CTA_SMEM_MAX - fixed) // per

    while most(G, NT) < 1 and (G > 1 or NT > 1):
        if G > 1:
            G = _balanced(L, G - 1)
        else:
            NT = _balanced(nn, NT - 1)
    if most(G, NT) < 1:
        raise _too_big(two_k, B)
    CT = _balanced(two_k, most(G, NT))
    return {"G": G, "CT": CT, "NT": NT, "FT": FT, "threads": G * NT * FT, "R": R}


def plan(L: int, n: int, d: int, nn: int, two_k: int, n_bins: int,
         int_exact: bool) -> dict:
    """Launch shape of the kernel.  A CTA holds the accumulators of ``G``
    lanes x ``CT`` grad/hess channels x ``NT`` nodes x ``FT`` features with
    ``threads`` threads and walks one of ``slices`` row slices of
    ``rows_per_slice`` rows; the float kernel stages ``R`` rows per block.
    The widest tiling that fits is chosen first, so a level whose channels
    fit one CTA has one channel tile (``CT`` = 2K); past that the channels
    are tiled (``chan_tiles``), each tile reading its rows again.  Row slices are added until the
    launch fills the card (two waves of the int8 kernel, one of the float
    kernel).  ``merge``: ``direct`` where one slice covers every row (each
    CTA stores its own cells), else ``atomic`` (int8: global atomicAdd after
    a memset) or ``partials`` (float: per-slice partials summed in slice
    order)."""
    B = n_bins + 1
    tiles = (_int8_tiles if int_exact else _f32_tiles)(L, d, nn, two_k, B)
    return finish_plan(tiles, L, n, d, nn, two_k, n_bins, int_exact)


def finish_plan(tiles: dict, L: int, n: int, d: int, nn: int, two_k: int,
                n_bins: int, int_exact: bool) -> dict:
    """:func:`plan`'s dict from a CTA's tiles (``G``, ``NT``, ``FT``,
    ``threads``, ``R`` and ``CT``, 2K where absent): its shared memory, tile
    counts and row slices."""
    B = n_bins + 1
    p = dict(tiles)
    p.setdefault("CT", two_k)
    if int_exact:
        p["smem"] = (p["G"] * p["NT"] * p["CT"] * B * p["FT"] * 4
                     + p["threads"] // 32 * p["G"] * 32 * (1 + p["CT"]))
        waves, min_rows = 2, _INT_MIN_SLICE_ROWS
    else:
        p["smem"] = _f32_smem(p["G"], p["NT"], p["FT"], p["R"], p["CT"], B)
        waves, min_rows = 1, _F32_MIN_SLICE_ROWS
    lane_groups = -(-L // p["G"])
    chan_tiles = -(-two_k // p["CT"])
    node_tiles = -(-nn // p["NT"])
    feat_tiles = -(-d // p["FT"])
    base = lane_groups * chan_tiles * node_tiles * feat_tiles
    per_sm = max(1, min(_SM_SMEM // (p["smem"] + 1024),
                        2 * _MAX_THREADS // p["threads"]))
    slices = max(1, min(-(-_SMS * per_sm * waves // base), -(-n // min_rows)))
    if not int_exact:
        per_slice = L * nn * two_k * out_width(n_bins, d) * 4
        slices = max(1, min(slices, _MAX_PARTIAL_BYTES // per_slice))
    rows = -(-n // slices) if n else 1
    slices = -(-n // rows) if n else 1
    merge = "direct" if slices == 1 else ("atomic" if int_exact else "partials")
    return {**p, "slices": slices, "rows_per_slice": rows,
            "lane_groups": lane_groups, "chan_tiles": chan_tiles,
            "node_tiles": node_tiles, "feat_tiles": feat_tiles, "merge": merge}


def int_abs_sum_bound(ghT: torch.Tensor) -> int:
    """The largest sum of |ghT| over the rows of one (lane, channel), by one
    int64 reduction (row chunks).  Every cell of the int8 path's histogram
    sums a subset of one such sum's terms, so its int32 accumulators do not
    overflow when this is at most ``INT32_MAX``.  Waits for the device."""
    L, two_k, n = ghT.shape
    step = max(1, _ABS_SUM_CHUNK // max(1, L * two_k))
    acc = torch.zeros((L, two_k), dtype=torch.int64, device=ghT.device)
    for lo in range(0, n, step):
        acc += ghT[:, :, lo:lo + step].to(torch.int32).abs().sum(dim=2, dtype=torch.int64)
    return int(acc.max()) if acc.numel() else 0


def hist_level(local: torch.Tensor, ghT: torch.Tensor, binned: torch.Tensor,
               nn: int, n_bins: int, *, int_exact: bool = False,
               abs_sum_bound: Optional[int] = None) -> torch.Tensor:
    """Level histograms: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors.  local (L, n) int32; ghT (L, 2K, n) int8 when
    ``int_exact`` else float32; binned (n, d) int32 in [0, n_bins].
    Returns (L*nn*2K, (n_bins+1)*d), int32 or float32.

    The int8 path sums in int32.  Up to ``INT_SAFE_ROWS`` rows no sum can
    overflow; past that the sums are bounded by ``abs_sum_bound`` (the
    caller's bound on any (lane, channel)'s sum of |ghT|, e.g.
    :func:`int_abs_sum_bound` computed once for a grower's levels) or, when
    it is None, by :func:`int_abs_sum_bound` of ``ghT``; a bound past
    ``INT32_MAX`` raises."""
    _check(local, "local", torch.int32, 2)
    _check(ghT, "ghT", torch.int8 if int_exact else torch.float32, 3)
    _check(binned, "binned", torch.int32, 2)
    L, n = local.shape
    two_k = ghT.shape[1]
    d = binned.shape[1]
    nn, n_bins = int(nn), int(n_bins)
    if ghT.shape[0] != L or ghT.shape[2] != n or binned.shape[0] != n:
        raise ValueError(f"shapes disagree: local {tuple(local.shape)}, ghT "
                         f"{tuple(ghT.shape)}, binned {tuple(binned.shape)}")
    if nn < 1 or n_bins < 2:
        raise ValueError(f"need nn >= 1 and n_bins >= 2, got {nn}, {n_bins}")
    if int_exact and n > INT_SAFE_ROWS:
        bound = int_abs_sum_bound(ghT) if abs_sum_bound is None else int(abs_sum_bound)
        if bound > INT32_MAX:
            raise ValueError(f"the int8 path sums in int32: a (lane, channel) "
                             f"sums |grad/hess| up to {bound} over {n} rows, "
                             f"past {INT32_MAX}")
    if not (local.device == ghT.device == binned.device):
        raise ValueError("local, ghT and binned must lie on one device")
    if local.device.type == "cpu":
        return hist_level_torch(local, ghT, binned, nn, n_bins,
                                int_exact=int_exact)
    return launch(local, ghT, binned, nn, n_bins, int_exact,
                  plan(L, n, d, nn, two_k, n_bins, int_exact))


def launch(local: torch.Tensor, ghT: torch.Tensor, binned: torch.Tensor,
           nn: int, n_bins: int, int_exact: bool, p: dict) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors with launch shape
    ``p`` (:func:`plan`'s dict; ``tools/torch_hist_plans.py`` times others)."""
    global launches, chan_tiled_launches
    L, n = local.shape
    two_k = ghT.shape[1]
    d = binned.shape[1]
    acc_t = torch.int32 if int_exact else torch.float32
    M = L * nn * two_k
    out = torch.empty((M, out_width(n_bins, d)), dtype=acc_t, device=local.device)
    partial = None
    if p["merge"] == "partials":
        partial = torch.empty((p["slices"], M, out_width(n_bins, d)),
                              dtype=torch.float32, device=local.device)
    err = _lib().tmog_hist_level(
        local.data_ptr(), ghT.data_ptr(), binned.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        L, n, d, nn, two_k, n_bins, int(bool(int_exact)), p["G"],
        p["CT"], p["NT"], p["FT"], p["threads"], p["R"], p["slices"],
        p["rows_per_slice"],
        dispatch.stream_handle(local.device))
    dispatch.check_launch(err, "hist_level")
    launches += 1
    chan_tiled_launches += p["chan_tiles"] > 1
    return out


def bound_bytes(L: int, n: int, d: int, nn: int, two_k: int, n_bins: int,
                int_exact: bool) -> int:
    """Bytes the function must move: local, gh and codes read once, the
    histograms written once."""
    gh_b = 1 if int_exact else 4
    return (L * n * 4 + L * two_k * n * gh_b + n * d * 4
            + L * nn * two_k * out_width(n_bins, d) * 4)

