"""Split scan of tree growth (K2): CUDA kernel, plain version, counter.

Counterpart of ``transmogrifai_tpu/perf/kernels/splitscan.py``: XGBoost's
split enumeration over built histograms — prefix sums of the per-bin
grad/hess, the second-order gain of every (feature, bin) candidate with L2
``reg_lambda``, L1 ``alpha`` (soft threshold), complexity ``gamma`` and
``min_child_weight`` on the class-mean hessian, missing values tried on both
sides, masked features at -inf, and the argmax (first maximum).

- :func:`split_scan` — the wrapper: launches ``tmog_split_scan`` of
  ``csrc/trees.cu`` on CUDA tensors (one thread per (lane, node, feature),
  walking the bins in order); a CPU tensor takes the plain version.
- :func:`plan` — the launch: how many (lane, node) blocks a CTA holds, the
  features each block's threads take at a time, and the shared-memory
  stride of the staged histograms.
- :func:`split_scan_torch` — the plain version: ``split_scan_xla``'s formula
  (:func:`split_gains_torch` gives its gain of every candidate).
- ``launches`` — the launch counter (``unstaged_launches``: of them, the
  launches that read the histograms where they lie).

On integer-valued histograms (the int-exact path) every operand of the gain
is an integer-valued float32, and the kernel's arithmetic follows the
reference's order without FMA contraction, so kernel and plain version agree
bit for bit.  On float histograms (GBT) their prefix sums round differently;
:func:`float_agreement` states how far they may differ.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import autotune
from . import dispatch
from . import trace as _trace

launches = 0
#: of them, launches that read the histograms where they lie (not staged)
unstaged_launches = 0

_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "tmog_split_scan": (_VP,) * 5 + (_INT,) * 5 + (_F,) * 4 + (_VP,) * 3
    + (_INT,) * 5 + (_VP,),
}

#: the most threads of a CTA (the kernel's launch bound), the fewest it aims
#: for, the most features a block's threads take at a time
SCAN_MAX_THREADS = 512
SCAN_MIN_THREADS = 128
SCAN_MAX_FEATS = 256
#: shared memory a CTA's staged histograms may take: two CTAs to an SM, else
#: one; beyond that the kernel reads the histograms where they lie
SCAN_SMEM = 100 * 1024
SCAN_SMEM_MAX = 200 * 1024
#: the card's SMs; candidates a thread scores at the fewest
_SMS = 132
_MIN_CANDIDATES = 8


class ScanPlan(NamedTuple):
    """One launch of the scan: CTAs of ``blocks_per_cta`` (lane, node)
    blocks of ``feats`` x ``groups`` threads (``threads`` in all): ``groups``
    threads share each feature of a tile of ``feats``, each scoring its
    share of the candidates, ``feat_tiles`` tiles in turn.  Where
    ``staged``, a tile's histograms are copied to shared memory first, each
    (channel, class) run at a row stride of ``stride`` words (odd)."""
    staged: bool
    feats: int
    groups: int
    blocks_per_cta: int
    threads: int
    stride: int
    smem: int
    ctas: int
    feat_tiles: int

_EPS = 1e-12


def reset_launch_counts() -> None:
    global launches, unstaged_launches
    launches = unstaged_launches = 0


def launch_counts() -> dict:
    return {"split_scan": launches, "split_scan.unstaged": unstaged_launches}


def _lib():
    return dispatch.load("trees", _SIGNATURES)


def soft_threshold(g: torch.Tensor, alpha) -> torch.Tensor:
    """XGBoost L1 shrinkage on the gradient sum (shared with the trees' leaf
    values)."""
    return torch.sign(g) * torch.clamp_min(torch.abs(g) - alpha, 0.0)


def _sq(t: torch.Tensor) -> torch.Tensor:
    return t * t


def _in_class_order(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over the class axis one class after another, as the kernel does
    (and XLA's reduction up to 32 classes; ``torch.sum`` takes another
    order on the CPU, which moves near-tie splits)."""
    t = t.movedim(dim, 0)
    acc = t[0]
    for k in range(1, t.shape[0]):
        acc = acc + t[k]
    return acc


def _gain_terms(gl, hl, Gt, Ht, reg_lambda, alpha, gamma, min_child_weight,
                class_axis: int) -> torch.Tensor:
    """Gain of every (feature, bin) candidate given left sums ``gl``/``hl``
    (``splitscan.py::_gain_terms`` of the reference)."""
    gr, hr = Gt - gl, Ht - hl
    K = gl.shape[class_axis]
    ok = (_in_class_order(hl, class_axis) / K >= min_child_weight) \
        & (_in_class_order(hr, class_axis) / K >= min_child_weight)
    raw = (_sq(soft_threshold(gl, alpha)) / (hl + reg_lambda + _EPS)
           + _sq(soft_threshold(gr, alpha)) / (hr + reg_lambda + _EPS)
           - _sq(soft_threshold(Gt, alpha)) / (Ht + reg_lambda + _EPS))
    raw = _in_class_order(raw, class_axis)
    return torch.where(ok, 0.5 * raw - gamma,
                       torch.full_like(raw, float("-inf")))


def split_gains_torch(hist_g, hist_h, G, H, level_mask, n_bins: int,
                      reg_lambda, alpha, gamma, min_child_weight
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gain of every candidate, (L, nn, d*(n_bins-1)) in the flat (feature,
    bin) order: the better of the two missing directions (masked features
    at -inf), missing-left's and missing-right's."""
    L, nn = hist_g.shape[:2]
    gl = torch.cumsum(hist_g[..., :n_bins], dim=-1)[..., :-1]
    hl = torch.cumsum(hist_h[..., :n_bins], dim=-1)[..., :-1]
    g_miss = hist_g[..., n_bins][..., None]
    h_miss = hist_h[..., n_bins][..., None]
    Gt = G[..., None, None]
    Ht = H[..., None, None]
    args = (reg_lambda, alpha, gamma, min_child_weight)
    gain_mr = _gain_terms(gl, hl, Gt, Ht, *args, class_axis=2)
    gain_ml = _gain_terms(gl + g_miss, hl + h_miss, Gt, Ht, *args, class_axis=2)
    gain = torch.maximum(gain_mr, gain_ml)
    gain = torch.where(level_mask[:, None, :, None] > 0, gain,
                       torch.full_like(gain, float("-inf")))
    return (gain.reshape(L, nn, -1), gain_ml.reshape(L, nn, -1),
            gain_mr.reshape(L, nn, -1))


def split_scan_torch(hist_g, hist_h, G, H, level_mask, n_bins: int,
                     reg_lambda, alpha, gamma, min_child_weight
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best flat (feature, bin) index (L, nn) int32, its gain (L, nn) f32 and
    missing-goes-left (L, nn) bool over (L, nn, K, d, B) histograms."""
    flat, gain_ml, gain_mr = split_gains_torch(
        hist_g, hist_h, G, H, level_mask, n_bins, reg_lambda, alpha, gamma,
        min_child_weight)
    best = flat.argmax(dim=-1)
    best_gain = torch.gather(flat, -1, best[..., None])[..., 0]
    ml = torch.gather(gain_ml, -1, best[..., None])[..., 0]
    mr = torch.gather(gain_mr, -1, best[..., None])[..., 0]
    return best.to(torch.int32), best_gain, ml >= mr


def float_agreement(got, hist_g, hist_h, G, H, level_mask, n_bins: int,
                    reg_lambda, alpha, gamma, min_child_weight) -> dict:
    """How the kernel's ``got`` = (best, gain, missing-left) agrees with the
    plain version on float histograms.  The two sum a node's bins in other
    orders, so a gain may be off by roundings of the terms it is a
    difference of: the tolerance is 1e-4 of the node's parent score plus
    the best gain's magnitude, plus 1e-6.  Within it the kernel must report
    the best gain, choose a candidate whose plain gain is the best, and
    agree on missing-left wherever the two chose alike and its two
    directions are not tied.  Nodes with no finite gain must agree exactly."""
    best_k, gain_k, bml_k = got
    flat, gain_ml, gain_mr = split_gains_torch(
        hist_g, hist_h, G, H, level_mask, n_bins, reg_lambda, alpha, gamma,
        min_child_weight)
    best_p = flat.argmax(dim=-1)
    gain_p = torch.gather(flat, -1, best_p[..., None])[..., 0]
    parent = (_sq(soft_threshold(G, alpha)) / (H + reg_lambda + _EPS)).sum(-1)
    fin = torch.isfinite(gain_p)
    tol = 1e-4 * (parent + torch.where(fin, gain_p.abs(), 0.0)) + 1e-6
    at_k = torch.gather(flat, -1, best_k.long()[..., None])[..., 0]
    err = torch.where(fin, (gain_k - gain_p).abs(), 0.0)
    pick = torch.where(fin, (gain_p - at_k).abs(), 0.0)
    same = best_k.long() == best_p
    gap = torch.gather(gain_ml - gain_mr, -1, best_p[..., None])[..., 0].abs()
    bml_p = torch.gather(gain_ml >= gain_mr, -1, best_p[..., None])[..., 0]
    ok = (torch.equal(fin, torch.isfinite(gain_k))
          and bool(same[~fin].all())  # opcheck: allow(TM301) a parity check's verdict (chip_smoke, tests), not a launch path
          and bool((err <= tol).all()) and bool((pick <= tol).all())  # opcheck: allow(TM301) a parity check's verdict (chip_smoke, tests), not a launch path
          and bool(((bml_k == bml_p) | ~same | (gap <= tol)).all()))  # opcheck: allow(TM301) a parity check's verdict (chip_smoke, tests), not a launch path
    over = torch.maximum(err, pick) / tol
    return {"ok": ok, "index_mismatches": int((~same).sum()),
            "max_abs_err": float(err.max()), "max_err_over_tol": float(over.max())}  # opcheck: allow(TM301) a parity check's errors (chip_smoke, tests), not a launch path


def _check(t: torch.Tensor, name: str, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _scan_smem(staged: bool, P: int, FT: int, K: int, stride: int,
               S: int = 1) -> int:
    """Bytes of the kernel's dynamic shared memory: the staged runs (each
    with 4 words of alignment slack) and, where K > 2, the running sums."""
    run = 2 * K * P * FT * S if K > 2 else 0
    return 4 * ((P * 2 * K * (FT * stride + 4) if staged else 0) + run)


def plan(L: int, nn: int, K: int, d: int, n_bins: int,
         params: Optional[dict] = None) -> ScanPlan:
    """A block's threads take all of d (rounded up to 32), at most
    ``SCAN_MAX_FEATS``, else tiles of it in turn; the widest tile whose
    staged histograms fit ``SCAN_SMEM`` (else ``SCAN_SMEM_MAX``), else the
    histograms are read where they lie.  A CTA holds enough blocks to have
    ``SCAN_MIN_THREADS`` threads, where there are as many blocks.  Where
    the grid has fewer CTAs than the card has SMs (GBT's levels), each
    thread's serial walk over its candidates sets the launch's time, so up
    to four threads share a feature's candidates (each scoring at least
    ``_MIN_CANDIDATES``, at most ``SCAN_MAX_THREADS`` a CTA).

    ``params`` (an autotuner candidate; None: the rules above) sets
    ``staged``, the feature tile ``FT`` and the sharers ``S``; the blocks a
    CTA then follow the rules.  Raises ValueError where they do not fit
    (the launcher's fit check)."""
    B = n_bins + 1
    stride = B | 1                       # odd: one bin of 32 features, 32 banks
    first = min(SCAN_MAX_FEATS, -(-max(d, 1) // 32) * 32)
    tiles = [first] + [ft for ft in (128, 64, 32) if ft < first]
    blocks = L * nn

    def make(staged: bool, FT: int, budget: int, S: Optional[int] = None) -> ScanPlan:
        P = max(1, min(SCAN_MIN_THREADS // FT, blocks))
        while P > 1 and _scan_smem(staged, P, FT, K, stride) > budget:
            P -= 1
        if S is None:
            S = 1 if -(-blocks // P) >= _SMS else max(1, min(
                4, SCAN_MAX_THREADS // (P * FT), (n_bins - 1) // _MIN_CANDIDATES))
            while S > 1 and _scan_smem(staged, P, FT, K, stride, S) > budget:
                S -= 1
        while P > 1 and P * FT * S > SCAN_MAX_THREADS:
            P -= 1
        return ScanPlan(staged, FT, S, P, P * FT * S, stride if staged else 0,
                        _scan_smem(staged, P, FT, K, stride, S), -(-blocks // P),
                        -(-d // FT))

    if params is not None:
        return _forced(make, params, K, stride, B)

    for budget in (SCAN_SMEM, SCAN_SMEM_MAX):
        for FT in tiles:
            if _scan_smem(True, 1, FT, K, stride) <= budget:
                return make(True, FT, budget)
    p = make(False, first, SCAN_SMEM_MAX)
    if p.smem > SCAN_SMEM_MAX:
        raise ValueError(f"split scan of {K} classes does not fit one CTA's "
                         f"shared memory ({p.smem} bytes)")
    return p


def _forced(make, params: dict, K: int, stride: int, B: int) -> ScanPlan:
    """The plan of an autotuner candidate ``params`` (``staged``, ``FT``,
    ``S``): staged at the first budget its tile fits, as the rules do."""
    knobs = dict(params)
    staged = bool(knobs.pop("staged"))
    FT, S = int(knobs.pop("FT")), int(knobs.pop("S"))
    if knobs:
        raise ValueError(f"unknown scan plan knobs {sorted(knobs)}")
    if FT % 32 or not 32 <= FT <= SCAN_MAX_FEATS or S < 1:
        raise ValueError(f"scan plan: FT {FT}, S {S}")
    budgets = [b for b in (SCAN_SMEM, SCAN_SMEM_MAX)
               if not staged or _scan_smem(True, 1, FT, K, stride) <= b]
    if not budgets:
        raise ValueError(f"a staged tile of {FT} features does not fit")
    p = make(staged, FT, budgets[0] if staged else SCAN_SMEM_MAX, S)
    if p.threads > SCAN_MAX_THREADS or p.smem > SCAN_SMEM_MAX \
            or (p.staged and p.stride < B):
        raise ValueError(f"scan plan {p} does not fit")
    return p


def tuned_plan(device: torch.device, L: int, nn: int, K: int, d: int,
               n_bins: int) -> ScanPlan:
    """The plan a launch on ``device`` runs: the autotuner's adopted winner
    for its shape class where it fits the shape (a misfit is logged), else
    :func:`plan`'s rules."""
    won = autotune.launch_params("split", device, lanes=L, nodes=nn,
                                 classes=K, features=d, bins=n_bins)
    if won is not None:
        try:
            p = plan(L, nn, K, d, n_bins, params=won)
            autotune.applied("split")
            return p
        except (ValueError, TypeError, KeyError) as exc:
            autotune.misfit("split", won, (L, nn, K, d, n_bins), exc)
    return plan(L, nn, K, d, n_bins)


def split_scan(hist_g, hist_h, G, H, level_mask, n_bins: int,
               reg_lambda, alpha, gamma, min_child_weight
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split scan: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors.  hist_g/hist_h (L, nn, K, d, n_bins+1), G/H (L, nn, K),
    level_mask (L, d), all float32; the four scalars are the XGBoost
    regularisers.  The launch plan is :func:`tuned_plan`'s."""
    global launches
    if hist_g.dim() != 5:
        raise ValueError(f"hist_g must be 5-D, got shape {tuple(hist_g.shape)}")
    L, nn, K, d, B = hist_g.shape
    n_bins = int(n_bins)
    if B != n_bins + 1 or n_bins < 2:
        raise ValueError(f"histograms carry {B} bins, expected n_bins + 1 = {n_bins + 1}")
    _check(hist_g, "hist_g", (L, nn, K, d, B))
    _check(hist_h, "hist_h", (L, nn, K, d, B))
    _check(G, "G", (L, nn, K))
    _check(H, "H", (L, nn, K))
    _check(level_mask, "level_mask", (L, d))
    devs = {t.device for t in (hist_g, hist_h, G, H, level_mask)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = hist_g.device
    if dev.type == "cpu":
        return split_scan_torch(hist_g, hist_h, G, H, level_mask, n_bins,
                                reg_lambda, alpha, gamma, min_child_weight)
    if dev.type == "meta":
        return _meta_node(hist_g, hist_h, G, H, level_mask, n_bins)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    outs = launch(hist_g, hist_h, G, H, level_mask, n_bins, reg_lambda, alpha,
                  gamma, min_child_weight, tuned_plan(dev, L, nn, K, d, n_bins))
    if _trace.active:
        _record((hist_g, hist_h, G, H, level_mask), outs, n_bins)
    return outs


def _meta_node(hist_g, hist_h, G, H, level_mask, n_bins: int):
    """A run on meta operands: the outputs' shapes and a node of the static
    trace (``trace.py``)."""
    L, nn = hist_g.shape[:2]
    outs = (torch.empty((L, nn), dtype=torch.int32, device="meta"),
            torch.empty((L, nn), dtype=torch.float32, device="meta"),
            torch.empty((L, nn), dtype=torch.bool, device="meta"))
    _record((hist_g, hist_h, G, H, level_mask), outs, n_bins)
    return outs


def _record(ins, outs, n_bins: int) -> None:
    """The run's node: the default plan and the bounds."""
    L, nn, K, d, _B = ins[0].shape
    _trace.record("split_scan", list(ins), list(outs),
                  plan(L, nn, K, d, n_bins)._asdict(), bound_ops(L, nn, K, d, n_bins),
                  bound_bytes(L, nn, K, d, n_bins))


def launch(hist_g, hist_h, G, H, level_mask, n_bins: int, reg_lambda, alpha,
           gamma, min_child_weight, p: ScanPlan
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the kernel on checked CUDA tensors by plan ``p`` (the
    card tests run a plan that reads the histograms where they lie)."""
    global launches, unstaged_launches
    L, nn, K, d, B = hist_g.shape
    if p.threads != p.feats * p.groups * p.blocks_per_cta or p.feats % 32 \
            or p.threads > SCAN_MAX_THREADS or (p.staged and p.stride < B):
        raise ValueError(f"scan plan {p} does not fit {tuple(hist_g.shape)}")
    dev = hist_g.device
    best = torch.empty((L, nn), dtype=torch.int32, device=dev)
    gain = torch.empty((L, nn), dtype=torch.float32, device=dev)
    bml = torch.empty((L, nn), dtype=torch.bool, device=dev)
    err = _lib().tmog_split_scan(
        hist_g.data_ptr(), hist_h.data_ptr(), G.data_ptr(), H.data_ptr(),
        level_mask.data_ptr(), L, nn, K, d, int(n_bins), float(reg_lambda),
        float(alpha), float(gamma), float(min_child_weight), best.data_ptr(),
        gain.data_ptr(), bml.data_ptr(), int(p.staged), p.feats, p.groups,
        p.blocks_per_cta, p.stride, dispatch.stream_handle(dev))
    dispatch.check_launch(err, "split_scan")
    launches += 1
    unstaged_launches += not p.staged
    return best, gain, bml


def bound_ops(L: int, nn: int, K: int, d: int, n_bins: int) -> int:
    """Float operations of the scan: per candidate and class, two prefix sums
    and the gain terms of both missing directions (~40 operations)."""
    return L * nn * d * (n_bins - 1) * K * 40


def bound_bytes(L: int, nn: int, K: int, d: int, n_bins: int) -> int:
    """Bytes the scan must move: both histograms read once, totals, mask,
    and the three (L, nn) outputs written once."""
    return 2 * L * nn * K * d * (n_bins + 1) * 4 + 2 * L * nn * K * 4 \
        + L * d * 4 + L * nn * 9
