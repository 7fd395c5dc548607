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
- ``launches`` — the launch counter.

Two paths, as in the reference: ``int_exact`` (``ghT`` int8, int32 out —
exact under any order) and float32 (``ghT`` float32, float32 out).  The
kernel's float sums run in a fixed order, so two launches on the same inputs
give the same bits; against the plain version they agree to rounding (see
:func:`f32_tolerance`).
"""

from __future__ import annotations

import ctypes

import torch

from . import dispatch

launches = 0

#: rows per chunk of the plain version's one-hot GEMM (bounds its temporaries)
PLAIN_CHUNK = 2048

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tmog_hist_level": (_VP, _VP, _VP, _VP, _VP) + (_INT,) * 11 + (_VP,),
}

#: shared memory a histogram CTA aims for (several CTAs per SM), and the most
#: one may take (the H100's 227 KB, less the stage buffers)
_SMEM_TARGET = 64 * 1024
_SMEM_MAX = 200 * 1024
#: CTAs a launch aims for (8 per SM); row slices are added until it has them
_TARGET_CTAS = 132 * 8
#: fewest rows a slice keeps, and the most bytes the float partials may take
_MIN_SLICE_ROWS = 4096
_MAX_PARTIAL_BYTES = 512 * 1024 * 1024


def reset_launch_counts() -> None:
    global launches
    launches = 0


def launch_counts() -> dict:
    return {"hist_level": launches}


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


def plan(L: int, n: int, d: int, nn: int, two_k: int, n_bins: int,
         int_exact: bool) -> dict:
    """Launch shape of the kernel: lanes per CTA ``G``, nodes per CTA ``NT``,
    warps per CTA (32 features each) and row slices ``S``.  One accumulator
    unit is (one lane, one node, 32 features): 2K x (n_bins+1) x 32 words.
    A CTA holds every node of the level if it can (each of its rows is then
    read once per lane group), then as many feature warps, then lanes."""
    B = n_bins + 1
    unit = two_k * B * 32 * 4
    stage = lambda g: g * 128 * 4 * (1 + two_k)  # noqa: E731
    if unit + stage(1) > _SMEM_MAX:
        raise ValueError(
            f"histogram of {two_k} channels x {B} bins does not fit one CTA's "
            f"shared memory ({unit} bytes per 32 features)")
    units = max(1, _SMEM_TARGET // unit)
    NT = min(nn, units)
    warps = max(1, min(-(-d // 32), units // NT, 4))
    G = max(1, min(L, units // (NT * warps), 8))
    base = -(-L // G) * -(-nn // NT) * -(-d // (32 * warps))
    slices = max(1, min(-(-_TARGET_CTAS // base), -(-n // _MIN_SLICE_ROWS)))
    if not int_exact and slices > 1:
        per_slice = L * nn * two_k * B * d * 4
        slices = max(1, min(slices, _MAX_PARTIAL_BYTES // per_slice))
    rows = -(-n // slices) if n else 1
    slices = max(1, -(-n // rows)) if n else 1
    return {"G": G, "NT": NT, "warps": warps, "slices": slices,
            "smem": G * NT * warps * unit + stage(G)}


def hist_level(local: torch.Tensor, ghT: torch.Tensor, binned: torch.Tensor,
               nn: int, n_bins: int, *, int_exact: bool = False) -> torch.Tensor:
    """Level histograms: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors.  local (L, n) int32; ghT (L, 2K, n) int8 when
    ``int_exact`` else float32; binned (n, d) int32 in [0, n_bins].
    Returns (L*nn*2K, (n_bins+1)*d), int32 or float32."""
    global launches
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
    if not (local.device == ghT.device == binned.device):
        raise ValueError("local, ghT and binned must lie on one device")
    if local.device.type == "cpu":
        return hist_level_torch(local, ghT, binned, nn, n_bins,
                                int_exact=int_exact)
    acc_t = torch.int32 if int_exact else torch.float32
    M = L * nn * two_k
    out = torch.empty((M, out_width(n_bins, d)), dtype=acc_t, device=local.device)
    p = plan(L, n, d, nn, two_k, n_bins, int_exact)
    partial = None
    if not int_exact and p["slices"] > 1:
        partial = torch.empty((p["slices"], M, out_width(n_bins, d)),
                              dtype=torch.float32, device=local.device)
    err = _lib().tmog_hist_level(
        local.data_ptr(), ghT.data_ptr(), binned.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        L, n, d, nn, two_k, n_bins, int(bool(int_exact)), p["G"], p["NT"],
        p["warps"], p["slices"], dispatch.stream_handle(local.device))
    dispatch.check_launch(err, "hist_level")
    launches += 1
    return out


def bound_bytes(L: int, n: int, d: int, nn: int, two_k: int, n_bins: int,
                int_exact: bool) -> int:
    """Bytes the function must move: local, gh and codes read once, the
    histograms written once."""
    gh_b = 1 if int_exact else 4
    return (L * n * 4 + L * two_k * n * gh_b + n * d * 4
            + L * nn * two_k * out_width(n_bins, d) * 4)

