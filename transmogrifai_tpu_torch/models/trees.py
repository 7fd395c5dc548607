"""Histogram-based tree ensembles on torch tensors — GBT and random forests.

Counterpart of ``transmogrifai_tpu/models/trees.py``.  The design is the
reference's:

- features are quantile-binned into small integer codes (edges on the host,
  codes counted on the device), with bin ``n_bins`` reserved for missing
  values and a learned default direction per split;
- trees are multi-output (leaves carry a (K,) value vector) and grow
  level-wise over a dense complete binary tree of ``2^(depth+1)-1`` nodes;
  every lane of a call — the (fold x tree) lanes of a CV sweep — grows in one
  pass, so each level is one histogram launch (K1), one split-scan launch (K2)
  and one routing launch (K3) for all lanes;
- sibling subtraction (right child = parent - left) and leaf values of the
  deepest level taken from the last split's sums, as in the reference.

What changes: the histogram is the port's shared-memory CUDA kernel, not the
TPU's one-hot GEMM; per-node table lookups are ``torch.gather`` (the TPU
avoided gathers; the values are identical); boosting is a Python loop over
rounds, launched asynchronously.  Random draws (bootstrap, colsample,
subsample) use torch generators: the forest's Poisson bootstrap goes through
one seam, :func:`draw_bootstrap`, which tests replace with the reference's
draws.  Mask draws (``_masks``) and fold weights are numpy, copied from the
reference, and equal there.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..data.dataset import Column
from ..perf.kernels import histogram as _khist
from ..perf.kernels import routing as _krout
from ..perf.kernels import splitscan as _ksplit
from ..perf.programs import run_cached
from ..stages.base import Param
from ..utils.reduce import window_sum
from .base import PredictionEstimatorBase, PredictionModelBase, place_rows
from .prediction import PredictionColumn

#: default histogram resolution (the reference's Spark tree default maxBins)
DEFAULT_BINS = 32

#: rows used for quantile-edge estimation on large tables (fixed-seed sample)
_QUANTILE_SAMPLE = 65536


def _f32(v) -> float:
    """A hyperparameter as the float32 value the reference computes with."""
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# Quantile binning
# ---------------------------------------------------------------------------

def quantile_bin(x: np.ndarray, n_bins: int = DEFAULT_BINS
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Bin (n, d) float features into int32 codes; NaN -> reserved bin ``n_bins``.

    Returns (binned (n, d) int32 in [0, n_bins], edges (d, n_bins-1) float32).
    Value v falls in bin ``searchsorted(edges, v, side='right')``.
    """
    n, d = x.shape
    edges = quantile_edges(x, n_bins)
    xt = np.ascontiguousarray(x.T)
    binned_t = np.full((d, n), n_bins, dtype=np.int32)
    for j in range(d):
        col = xt[j]
        idx_j = np.searchsorted(edges[j], col, side="right").astype(np.int32)
        binned_t[j] = np.where(np.isfinite(col), idx_j, n_bins)
    return np.ascontiguousarray(binned_t.T), edges


def quantile_edges(x: np.ndarray, n_bins: int = DEFAULT_BINS) -> np.ndarray:
    """Per-feature quantile edges (d, n_bins-1) (sampled above
    ``_QUANTILE_SAMPLE`` rows, fixed seed)."""
    n, d = x.shape
    if n > _QUANTILE_SAMPLE:
        idx = np.random.default_rng(0).choice(n, _QUANTILE_SAMPLE,
                                              replace=False)
        idx.sort()
        xt_q = np.ascontiguousarray(x[idx].T)
    else:
        xt_q = np.ascontiguousarray(x.T)
    edges = np.zeros((d, n_bins - 1), dtype=np.float32)
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    for j in range(d):
        colq = xt_q[j]
        okq = np.isfinite(colq)
        if okq.sum() == 0:
            continue
        e = np.quantile(colq[okq], qs).astype(np.float32)
        edges[j] = np.maximum.accumulate(e)
    return edges


def digitize(x: torch.Tensor, edges: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Bin codes on x's device: the count of edges <= x (searchsorted
    side='right' on monotone edges), non-finite -> ``n_bins``."""
    binned = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for e in range(edges.shape[1]):
        binned += (edges[None, :, e] <= x).to(torch.int32)
    return torch.where(torch.isfinite(x), binned,
                       torch.full_like(binned, int(n_bins)))


#: (placed x identity, n_bins) -> (x, edges, codes): every tree family of a
#: selector fit, and the refit, bin the same block once
_BIN_CACHE: Dict[tuple, tuple] = {}
_BIN_CACHE_MAX = 4


def shared_binned(x32: np.ndarray, xd: torch.Tensor, n_bins: int
                  ) -> Tuple[torch.Tensor, np.ndarray]:
    """(codes on xd's device, host edges) of ``x32`` at ``n_bins``."""
    key = (id(xd), int(n_bins))
    hit = _BIN_CACHE.get(key)
    if hit is not None and hit[0] is xd:
        return hit[2], hit[1]
    edges = quantile_edges(x32, int(n_bins))
    binned = digitize(xd, torch.from_numpy(edges).to(xd.device), int(n_bins))
    _BIN_CACHE[key] = (xd, edges, binned)
    while len(_BIN_CACHE) > _BIN_CACHE_MAX:
        _BIN_CACHE.pop(next(iter(_BIN_CACHE)))
    return binned, edges


# ---------------------------------------------------------------------------
# Tree grower (multi-output, all lanes jointly)
# ---------------------------------------------------------------------------

class Tree(NamedTuple):
    """Dense complete binary tree, node i has children 2i+1 / 2i+2."""

    feat: torch.Tensor          # (m,) int32 split feature (0 when leaf)
    thr_bin: torch.Tensor       # (m,) int32 split bin: go left if bin <= thr_bin
    miss_left: torch.Tensor     # (m,) bool missing-value default direction
    is_leaf: torch.Tensor       # (m,) bool
    value: torch.Tensor         # (m, K) float32 leaf value vector (eta-scaled)


_soft_threshold = _ksplit.soft_threshold


def _lookup_l(tbl: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """tbl[l, node[l, i]] per lane; tbl (L, m) or (L, m, K), node (L, n)."""
    idx = node.long()
    if tbl.dim() == 2:
        return torch.gather(tbl, 1, idx)
    K = tbl.shape[2]
    return torch.gather(tbl, 1, idx[..., None].expand(-1, -1, K))


def _leaf_value(G, H, reg_lambda, alpha, eta, max_delta_step):
    raw = -_soft_threshold(G, alpha) / (H + reg_lambda + 1e-12)
    if max_delta_step > 0.0:
        raw = torch.clamp(raw, -max_delta_step, max_delta_step)
    return raw * eta


def _colsample_mask(seed: Tuple[int, ...], d: int, frac: float) -> torch.Tensor:
    """Exact-k column mask by rank of uniforms, drawn from a CPU generator
    seeded by ``seed`` (the same on every device)."""
    k_keep = max(1, int(round(frac * d)))
    g = torch.Generator().manual_seed(_mix(seed))
    u = torch.rand(d, generator=g)
    rank = torch.argsort(torch.argsort(u))
    return (rank < k_keep).to(torch.float32)


def _mix(seed: Tuple[int, ...]) -> int:
    h = 0x9E3779B97F4A7C15
    for s in seed:
        h = (h ^ (int(s) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9
        h &= 0xFFFFFFFFFFFFFFFF
    return h >> 1


def _grow_trees(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                feat_mask: torch.Tensor, seed: Tuple[int, ...], max_depth: int,
                n_bins: int, reg_lambda, alpha, gamma, min_child_weight, eta,
                max_delta_step, colsample_bylevel: float = 1.0,
                int_exact: bool = False):
    """Level-wise histogram growth of L trees jointly.

    binned (n, d) int32 codes in [0, n_bins] shared by the lanes; grad/hess
    (L, n, K); feat_mask (L, d) 1/0.  ``int_exact`` runs the histograms on
    int8 grad/hess with int32 sums — exact when grad/hess are integers in
    [-127, 127], the forest-CV case with 0/1 fold weights (callers check),
    and the sums stay within int32 (bounded from the data past
    ``histogram.INT_SAFE_ROWS`` rows).
    Returns (Tree with a leading L axis, node (L, n)): each row's final leaf.
    """
    L, n, K = grad.shape
    d = binned.shape[1]
    m = 2 ** (max_depth + 1) - 1
    B = n_bins + 1
    dev = grad.device
    reg_lambda, alpha, gamma = _f32(reg_lambda), _f32(alpha), _f32(gamma)
    min_child_weight, eta = _f32(min_child_weight), _f32(eta)
    max_delta_step = _f32(max_delta_step)

    feat = torch.zeros((L, m), dtype=torch.int32, device=dev)
    thr_bin = torch.full((L, m), n_bins, dtype=torch.int32, device=dev)
    miss_left = torch.zeros((L, m), dtype=torch.bool, device=dev)
    is_leaf = torch.zeros((L, m), dtype=torch.bool, device=dev)
    value = torch.zeros((L, m, K), dtype=torch.float32, device=dev)
    node = torch.zeros((L, n), dtype=torch.int32, device=dev)

    ghT = torch.cat([grad, hess], dim=-1).transpose(1, 2)
    ghT = ghT.to(torch.int8).contiguous() if int_exact \
        else ghT.to(torch.float32).contiguous()
    feat_mask = feat_mask.to(torch.float32).contiguous()

    # past INT_SAFE_ROWS rows the int8 sums are bounded from the data, once
    # for every level (one reduction)
    abs_bound = _khist.int_abs_sum_bound(ghT) \
        if int_exact and n > _khist.INT_SAFE_ROWS else None

    def level_hist(local: torch.Tensor, nn: int) -> torch.Tensor:
        """(L, nn, 2K, d, B) histograms; rows with negative local add 0."""
        hist = _khist.hist_level(local.contiguous(), ghT, binned, nn, n_bins,
                                 int_exact=int_exact,
                                 abs_sum_bound=abs_bound).to(torch.float32)
        return hist.reshape(L, nn, 2 * K, B, d).transpose(-1, -2)

    def leaf_all(G, H):
        return _leaf_value(G, H, reg_lambda, alpha, eta, max_delta_step)

    if max_depth == 0:
        hist = level_hist(node, 1)
        G = window_sum(hist[:, :, :K, 0, :])
        H = window_sum(hist[:, :, K:, 0, :])
        value[:, 0:1] = leaf_all(G, H)
        is_leaf[:, 0] = True
        return Tree(feat, thr_bin, miss_left, is_leaf, value), node

    prev_hist = None
    for depth in range(max_depth):
        first = 2 ** depth - 1
        n_nodes = 2 ** depth
        local = node - first
        if depth == 0:
            hist = level_hist(local, 1)
        else:
            is_left = (local % 2 == 0) & (local >= 0)
            left_local = torch.where(is_left, local // 2,
                                     torch.full_like(local, -1))
            left = level_hist(left_local, n_nodes // 2)
            hist = torch.stack([left, prev_hist - left], dim=2).reshape(
                L, n_nodes, 2 * K, d, B)
            del left, prev_hist
        prev_hist = hist
        hist_g = hist[:, :, :K].contiguous()
        hist_h = hist[:, :, K:].contiguous()

        # node totals: the bins of feature 0 cover every row
        G = window_sum(hist_g[:, :, :, 0, :])
        H = window_sum(hist_h[:, :, :, 0, :])
        node_val = leaf_all(G, H)

        level_mask = feat_mask
        if colsample_bylevel < 1.0:
            level_mask = feat_mask * _colsample_mask(
                seed + (3, depth), d, colsample_bylevel).to(dev)[None, :]
        best, best_gain, bml = _ksplit.split_scan(
            hist_g, hist_h, G, H, level_mask.contiguous(), n_bins,
            reg_lambda, alpha, gamma, min_child_weight)
        bf = best // (n_bins - 1)
        bb = best % (n_bins - 1)

        leaf_now = (best_gain <= 0.0) | (H.mean(-1) <= 0.0)
        sl = slice(first, first + n_nodes)
        feat[:, sl] = torch.where(leaf_now, torch.zeros_like(bf), bf)
        thr_bin[:, sl] = torch.where(leaf_now, torch.full_like(bb, n_bins), bb)
        miss_left[:, sl] = bml & ~leaf_now
        is_leaf[:, sl] = leaf_now
        value[:, sl] = node_val

        if depth == max_depth - 1:
            # the children's totals are the chosen split's left/right sums:
            # the chosen feature's bins, summed in order up to the chosen bin
            # (the same chain of adds as the cumsum over every feature)
            fidx = bf.long()[:, :, None, None, None].expand(L, n_nodes, K, 1, B)
            hg_f = torch.gather(hist_g, 3, fidx)[:, :, :, 0]   # (L, nodes, K, B)
            hh_f = torch.gather(hist_h, 3, fidx)[:, :, :, 0]
            bidx = bb.long()[:, :, None, None].expand(L, n_nodes, K, 1)
            gl_best = torch.gather(torch.cumsum(hg_f[..., :n_bins], dim=-1), -1,
                                   bidx)[..., 0]
            hl_best = torch.gather(torch.cumsum(hh_f[..., :n_bins], dim=-1), -1,
                                   bidx)[..., 0]
            gm_best = hg_f[..., n_bins]
            hm_best = hh_f[..., n_bins]
            zero = torch.zeros_like(gm_best)
            G_l = gl_best + torch.where(bml[..., None], gm_best, zero)
            H_l = hl_best + torch.where(bml[..., None], hm_best, zero)
            lv = leaf_all(G_l, H_l)
            rv = leaf_all(G - G_l, H - H_l)
            child_vals = torch.stack([lv, rv], dim=2).reshape(L, 2 * n_nodes, K)
            csl = slice(first + n_nodes, first + 3 * n_nodes)
            value[:, csl] = child_vals
            is_leaf[:, csl] = True
        del hist_g, hist_h

        # route rows: rows at leaf nodes stay put
        nf = _lookup_l(feat, node)
        nb = _krout.row_select_lanes(binned, nf)
        go_left = torch.where(nb == n_bins, _lookup_l(miss_left, node),
                              nb <= _lookup_l(thr_bin, node))
        child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(_lookup_l(is_leaf, node), node, child)

    return Tree(feat, thr_bin, miss_left, is_leaf, value), node


def _predict_trees_sum(trees: Tree, binned: torch.Tensor, max_depth: int,
                       n_bins: int) -> torch.Tensor:
    """(n, K) sum of leaf value vectors over a stacked batch of T trees:
    fixed-depth traversal by gathers."""
    T = trees.feat.shape[0]
    n = binned.shape[0]
    K = trees.value.shape[-1]
    node = torch.zeros((T, n), dtype=torch.int64, device=binned.device)
    for _ in range(max_depth):
        nf = torch.gather(trees.feat.long(), 1, node)
        nb = torch.gather(binned, 1, nf.t()).t()
        go_left = torch.where(nb == n_bins, torch.gather(trees.miss_left, 1, node),
                              nb <= torch.gather(trees.thr_bin, 1, node))
        child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(torch.gather(trees.is_leaf, 1, node), node, child)
    vals = torch.gather(trees.value, 1, node[..., None].expand(T, n, K))
    return window_sum(vals, dim=0)


# ---------------------------------------------------------------------------
# Ensemble fitters
# ---------------------------------------------------------------------------

def _base_score_device(y, w, objective: str, num_class: int, scale_pos_weight):
    """(K,) prior margin from the training weights (the host ``_resolved``
    formula, on the device)."""
    if objective == "binary:logistic":
        we = w * torch.where(y == 1.0, _f32(scale_pos_weight), 1.0)
        p = torch.clamp(window_sum(we * (y == 1.0))
                        / torch.clamp_min(window_sum(we), 1e-12), 1e-6, 1 - 1e-6)
        return torch.log(p / (1 - p))[None]
    if objective == "multi:softmax":
        oh = torch.nn.functional.one_hot(y.long(), num_class).to(torch.float32)
        counts = window_sum(w[:, None] * oh, dim=0)
        p = torch.clamp(counts / torch.clamp_min(window_sum(counts), 1e-12), 1e-6, 1.0)
        return torch.log(p)
    return (window_sum(w * y) / torch.clamp_min(window_sum(w), 1e-12))[None]


def _fit_gbt_lanes(binned, y, w_lanes, seed: int, n_rounds: int, max_depth: int,
                   n_bins: int, objective: str, num_class: int,
                   subsample: float, colsample_bytree: float,
                   colsample_bylevel: float, eta, reg_lambda, alpha, gamma,
                   min_child_weight, scale_pos_weight, max_delta_step,
                   base_score) -> Tuple[torch.Tensor, List[Tree]]:
    """Boosting of L lanes jointly, one round at a time; returns (final
    margins (L, n, K), one Tree of L lanes per round)."""
    L, n = w_lanes.shape
    d = binned.shape[1]
    K = num_class
    dev = binned.device
    spw = _f32(scale_pos_weight)
    y_onehot = torch.nn.functional.one_hot(y.long(), K).to(torch.float32) \
        if objective == "multi:softmax" else None
    margin = base_score.to(torch.float32)[:, None, :].expand(L, n, K).clone()
    trees: List[Tree] = []
    for r in range(n_rounds):
        wt = w_lanes
        if subsample < 1.0:
            g = torch.Generator().manual_seed(_mix((seed, r, 1)))
            keep = (torch.rand(n, generator=g) < subsample).to(torch.float32)
            wt = wt * keep.to(dev)[None, :]
        feat_mask = torch.ones(d, dtype=torch.float32)
        if colsample_bytree < 1.0:
            feat_mask = _colsample_mask((seed, r, 2), d, colsample_bytree)
        fm_l = feat_mask.to(dev)[None, :].expand(L, d).contiguous()
        if objective == "binary:logistic":
            wp = wt * torch.where(y == 1.0, spw, 1.0)[None, :]
            p = torch.sigmoid(margin[..., 0])
            grad = (wp * (p - y[None, :]))[..., None]
            hess = (wp * torch.clamp_min(p * (1 - p), 1e-16))[..., None]
        elif objective == "multi:softmax":
            p = torch.softmax(margin, dim=-1)
            grad = wt[..., None] * (p - y_onehot[None])
            hess = wt[..., None] * torch.clamp_min(p * (1 - p), 1e-16)
        else:
            grad = (wt * (margin[..., 0] - y[None, :]))[..., None]
            hess = wt[..., None].expand(L, n, 1)
        tree, node = _grow_trees(binned, grad, hess, fm_l, (seed, r), max_depth,
                                 n_bins, reg_lambda, alpha, gamma,
                                 min_child_weight, eta, max_delta_step,
                                 colsample_bylevel)
        margin = margin + _lookup_l(tree.value, node)
        trees.append(tree)
    return margin, trees


def _stack_rounds(trees: List[Tree], lane: int) -> Tree:
    """(rounds, ...) Tree of one lane of a boosting run."""
    return Tree(*(torch.stack([getattr(t, f)[lane] for t in trees])
                  for f in Tree._fields))


def _forest_lanes(binned, y_cols, wt, feat_masks, max_depth, n_bins,
                  reg_lambda, min_child_weight, int_exact):
    grad = -wt[:, :, None] * y_cols[None]
    hess = wt[:, :, None] * torch.ones((1, 1, y_cols.shape[1]),
                                       dtype=torch.float32, device=wt.device)
    return _grow_trees(binned, grad, hess, feat_masks, (0,), max_depth, n_bins,
                       reg_lambda, 0.0, 0.0, min_child_weight, 1.0, 0.0,
                       int_exact=int_exact)


def _gbt_cv(binned, y, train_w, val_w, seed, metric_fn, **cfg) -> torch.Tensor:
    """All folds of one GBT grid point as lanes of one boosting run; the
    margins over the full row block carry the validation predictions.
    Returns the (k,) metric per fold."""
    base = torch.stack([_base_score_device(y, w_, cfg["objective"],
                                           cfg["num_class"],
                                           cfg["scale_pos_weight"])
                        for w_ in train_w])
    margin, _ = _fit_gbt_lanes(binned, y, train_w, seed, base_score=base, **cfg)
    if cfg["objective"] == "binary:logistic":
        payload = torch.sigmoid(margin[..., 0])
    elif cfg["objective"] == "multi:softmax":
        payload = torch.softmax(margin, dim=-1)
    else:
        payload = margin[..., 0]
    return torch.stack([metric_fn(payload[f], y, val_w[f])
                        for f in range(train_w.shape[0])])


def _forest_cv(binned, y, y_cols, train_w, val_w, feat_masks, boot_w,
               max_depth, n_bins, reg_lambda, min_child_weight,
               classification, metric_fn, int_exact=False) -> torch.Tensor:
    """All folds of one forest grid point: the (fold x tree) grid as k*T
    lanes of one grower call; in-sample votes read each lane's final leaf."""
    k, n = train_w.shape
    T = feat_masks.shape[0]
    K = y_cols.shape[1]
    wt = (train_w[:, None, :] * boot_w[None, :, :]).reshape(k * T, n)
    masks = feat_masks.repeat(k, 1)
    trees, nodes = _forest_lanes(binned, y_cols, wt, masks, max_depth, n_bins,
                                 reg_lambda, min_child_weight, int_exact)
    vals = _lookup_l(trees.value, nodes).reshape(k, T, n, K)
    # the reference divides by the tree count inside a compiled program,
    # where XLA turns x / T into x * (1 / T)
    mean = window_sum(vals, dim=1) * float(np.float32(1.0) / np.float32(T))
    if classification and K > 1:
        cl = torch.clamp(mean, 0.0, 1.0)
        payload = cl / torch.clamp_min(window_sum(cl)[..., None], 1e-12)
    else:
        payload = mean[..., 0]
    return torch.stack([metric_fn(payload[f], y, val_w[f]) for f in range(k)])


# ---------------------------------------------------------------------------
# Model stages
# ---------------------------------------------------------------------------

class _TreeEnsembleModelBase(PredictionModelBase):
    def __init__(self, trees, edges: np.ndarray, max_depth: int, n_bins: int,
                 base_score=0.0, **kw):
        super().__init__(**kw)
        items = trees._asdict().items() if isinstance(trees, Tree) else trees.items()
        self.trees = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v)) for k, v in items}
        self.edges = np.asarray(edges, dtype=np.float32)
        self.max_depth = int(max_depth)
        self.n_bins = int(n_bins)
        self.base_score = np.asarray(base_score, dtype=np.float64).reshape(-1)

    #: batches at or below this row count predict on the host in numpy
    _HOST_PREDICT_MAX_ROWS = 512

    def _tree_batch(self, device) -> Tree:
        return Tree(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                       for k, v in self.trees.items()})

    def _margin(self, x: np.ndarray, device=None) -> np.ndarray:
        """(n, K) summed leaf values + base score."""
        base = np.asarray(self.base_score, dtype=np.float64).reshape(-1)
        x = np.asarray(x, dtype=np.float32)
        if x.shape[0] <= self._HOST_PREDICT_MAX_ROWS:
            return self._margin_host(x) + base[None, :]
        from ..perf.kernels.dispatch import resolve_device

        m = self._margin_sum(x, resolve_device(device))
        return m.cpu().numpy().astype(np.float64) + base[None, :]

    def _margin_sum(self, x32: np.ndarray, device) -> torch.Tensor:
        return self._margin_sum_rows(place_rows(np.asarray(x32, np.float32), device))

    def _margin_sum_rows(self, xd: torch.Tensor) -> torch.Tensor:
        """(n, K) float32 summed leaf values of float32 rows on a device."""
        binned = digitize(xd, torch.from_numpy(self.edges).to(xd.device), self.n_bins)
        return _predict_trees_sum(self._tree_batch(xd.device), binned,
                                  self.max_depth, self.n_bins)

    def _margin64(self, x: torch.Tensor) -> torch.Tensor:
        """(n, K) float64 margins (summed leaves + base score) of rows on
        their device: the device path of :meth:`_margin`."""
        m = self._margin_sum_rows(x.to(torch.float32).contiguous()).to(torch.float64)
        return m + torch.from_numpy(self.base_score).to(x.device)[None, :]

    def feature_importances(self, d: int) -> np.ndarray:
        """Split-count importances per feature (XGBoost's 'weight' type)."""
        feats = np.asarray(self.trees["feat"]).ravel()
        leaves = np.asarray(self.trees["is_leaf"]).ravel()
        counts = np.bincount(feats[~leaves], minlength=d).astype(np.float64)
        tot = counts.sum()
        return counts / tot if tot > 0 else counts

    def _margin_host(self, x: np.ndarray) -> np.ndarray:
        """Pure-numpy traversal over flat tree arrays (the reference's host
        serving path, verbatim)."""
        n, d = x.shape
        binned = np.empty((n, d), np.int32)
        for j in range(d):
            binned[:, j] = np.searchsorted(self.edges[j], x[:, j], side="right")
        binned[~np.isfinite(x)] = self.n_bins
        feat = self.trees["feat"]
        T, m = feat.shape
        featf = np.ascontiguousarray(feat).ravel()
        thrf = np.ascontiguousarray(self.trees["thr_bin"]).ravel()
        missf = np.ascontiguousarray(self.trees["miss_left"]).ravel()
        leaff = np.ascontiguousarray(self.trees["is_leaf"]).ravel()
        value = self.trees["value"]
        valuef = np.ascontiguousarray(value).reshape(T * m, -1)
        off = (np.arange(T, dtype=np.int32) * m)[:, None]
        binnedf = binned.ravel()
        rowsd = np.arange(n, dtype=np.int32) * d
        node = np.zeros((T, n), np.int32)
        for _ in range(self.max_depth):
            g = off + node
            nb = binnedf[rowsd + featf[g]]
            go_left = np.where(nb == self.n_bins, missf[g], nb <= thrf[g])
            node = np.where(leaff[g], node,
                            np.where(go_left, 2 * node + 1, 2 * node + 2))
        vals = valuef[off + node]
        return vals.sum(axis=0).astype(np.float64)

    @property
    def n_trees(self) -> int:
        return int(self.trees["feat"].shape[0])

    @property
    def n_outputs(self) -> int:
        return int(self.trees["value"].shape[-1])


class GBTClassifierModel(_TreeEnsembleModelBase):
    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        m = self._margin(vec.data, device)
        if m.shape[1] == 1:
            z = m[:, 0]
            p1 = 1.0 / (1.0 + np.exp(-z))
            return PredictionColumn.classification(
                np.column_stack([-z, z]), np.column_stack([1 - p1, p1]))
        e = np.exp(m - m.max(axis=1, keepdims=True))
        return PredictionColumn.classification(m, e / e.sum(axis=1, keepdims=True))

    def insight_payload(self, x):
        m = self._margin64(x)
        if m.shape[1] == 1:
            p1 = 1.0 / (1.0 + torch.exp(-m[:, 0]))
            return torch.stack([1 - p1, p1], dim=1)
        return torch.softmax(m, dim=1)

    def eval_payload_device(self, x32, device):
        if self.n_outputs != 1:
            return None
        z = self._margin_sum(x32, device)[:, 0] + float(np.float32(self.base_score[0]))
        return torch.sigmoid(z), (z > 0).to(torch.float32)


class GBTRegressorModel(_TreeEnsembleModelBase):
    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        return PredictionColumn(self._margin(vec.data, device)[:, 0])

    def insight_payload(self, x):
        return self._margin64(x)[:, :1]


class ForestClassifierModel(_TreeEnsembleModelBase):
    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        mean = self._margin(vec.data, device) / self.n_trees
        if mean.shape[1] == 1:
            p1 = np.clip(mean[:, 0], 0.0, 1.0)
            prob = np.column_stack([1 - p1, p1])
        else:
            prob = np.clip(mean, 0.0, 1.0)
            prob = prob / np.maximum(prob.sum(axis=1, keepdims=True), 1e-12)
        return PredictionColumn.classification(prob * self.n_trees, prob)

    def insight_payload(self, x):
        mean = self._margin64(x) / self.n_trees
        if mean.shape[1] == 1:
            p1 = torch.clamp(mean[:, 0], 0.0, 1.0)
            return torch.stack([1 - p1, p1], dim=1)
        prob = torch.clamp(mean, 0.0, 1.0)
        return prob / torch.clamp(prob.sum(dim=1, keepdim=True), min=1e-12)

    def eval_payload_device(self, x32, device):
        if self.n_outputs != 1:
            return None
        b = float(np.float32(self.base_score[0] if len(self.base_score) else 0.0))
        p1 = torch.clamp((self._margin_sum(x32, device)[:, 0] + b) / self.n_trees,
                         0.0, 1.0)
        return p1, (p1 > 0.5).to(torch.float32)


class ForestRegressorModel(_TreeEnsembleModelBase):
    def predict_column(self, vec: Column, device=None) -> PredictionColumn:
        return PredictionColumn(self._margin(vec.data, device)[:, 0] / self.n_trees)

    def insight_payload(self, x):
        return self._margin64(x)[:, :1] / self.n_trees


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------

def draw_bootstrap(seed: int, rate: float, n_trees: int, n: int,
                   device) -> torch.Tensor:
    """(n_trees, n) float32 Poisson(rate) bootstrap counts from a generator
    seeded ``seed`` on ``device``.  The one seam for the forest's draws:
    parity runs replace it with the reference's draws."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    rates = torch.full((int(n_trees), int(n)), float(rate), dtype=torch.float32,
                       device=device)
    return torch.poisson(rates, generator=g)


class _TreeEstimatorBase(PredictionEstimatorBase):
    max_depth = Param(default=5)
    n_bins = Param(default=DEFAULT_BINS)
    reg_lambda = Param(default=1.0)
    min_child_weight = Param(default=1.0)
    seed = Param(default=42)

    def _binned(self, x: np.ndarray, device):
        """(codes on the device, edges): binned once per placed block and
        shared by every family of a selector fit and its refit."""
        x32 = np.asarray(x, np.float32)
        xd = place_rows(x32, device)
        binned, edges = shared_binned(x32, xd, int(self.n_bins))
        return binned, edges

    def _cv_sweep_device(self, x, y, train_w, val_w,
                         grids: List[Dict[str, Any]], metric_fn, device):
        x32 = np.asarray(x, np.float32)
        # 0/1 fold weights let forests take the exact int8 histogram path
        int01 = bool(np.all((train_w == 0.0) | (train_w == 1.0)))
        xd = place_rows(x32, device)
        binned, _ = shared_binned(x32, xd, int(self.n_bins))
        tw = torch.from_numpy(np.asarray(train_w, np.float32)).to(device)
        vw = torch.from_numpy(np.asarray(val_w, np.float32)).to(device)
        pending = []
        for grid in grids:
            est = self.copy().set_params(**grid)
            b = binned if int(est.n_bins) == int(self.n_bins) else \
                shared_binned(x32, xd, int(est.n_bins))[0]
            pending.append(est._sweep_folds(b, x, y, tw, vw, metric_fn,
                                            weights01=int01))
        return pending

    def _sweep_folds(self, binned, x, y, train_w, val_w, metric_fn,
                     weights01=False):
        raise NotImplementedError


#: the GBT hyperparameters the sweep program takes as dynamic operands
_GBT_DYNAMICS = ("eta", "reg_lambda", "alpha", "gamma", "min_child_weight",
                 "scale_pos_weight", "max_delta_step")


class _GBTBase(_TreeEstimatorBase):
    """Shared GBT/XGBoost fitting (objective set by subclass)."""

    num_rounds = Param(default=100)
    eta = Param(default=0.3)
    gamma = Param(default=0.0)
    alpha = Param(default=0.0)
    subsample = Param(default=1.0)
    colsample_bytree = Param(default=1.0)
    colsample_bylevel = Param(default=1.0)
    scale_pos_weight = Param(default=1.0)
    max_delta_step = Param(default=0.0)
    objective: str = "binary:logistic"

    def _resolved(self, y, w):
        return self.objective, 1, np.zeros(1)

    def _fit_config(self) -> dict:
        return dict(
            n_rounds=int(self.num_rounds), max_depth=int(self.max_depth),
            n_bins=int(self.n_bins), subsample=float(self.subsample),
            colsample_bytree=float(self.colsample_bytree),
            colsample_bylevel=float(self.colsample_bylevel),
            eta=self.eta, reg_lambda=self.reg_lambda, alpha=self.alpha,
            gamma=self.gamma, min_child_weight=self.min_child_weight,
            scale_pos_weight=self.scale_pos_weight,
            max_delta_step=self.max_delta_step)

    def _fit_arrays(self, x, y, w, device):
        binned, edges = self._binned(x, device)
        objective, num_class, base = self._resolved(y, w)
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(device)
        wd = torch.from_numpy(np.asarray(w, np.float32)).to(device)
        _, trees = _fit_gbt_lanes(
            binned, yd, wd[None, :], int(self.seed), objective=objective,
            num_class=num_class,
            base_score=torch.from_numpy(np.asarray(base, np.float32)).to(device)[None],
            **self._fit_config())
        cls = GBTRegressorModel if objective == "reg:squarederror" \
            else GBTClassifierModel
        return cls(trees=_stack_rounds(trees, 0), edges=edges,
                   max_depth=self.max_depth, n_bins=self.n_bins, base_score=base)

    def _sweep_folds(self, binned, x, y, train_w, val_w, metric_fn,
                     weights01=False):
        objective, num_class, _ = self._resolved(y, np.ones_like(y))
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(binned.device)
        cfg = self._fit_config()
        # the reference's split: the float hyperparameters are the program's
        # dynamic operands, the rest its configuration
        dynamics = {k: cfg.pop(k) for k in _GBT_DYNAMICS}
        return run_cached(_gbt_cv, binned, yd, train_w, val_w, int(self.seed),
                          kwargs=dynamics,
                          statics=dict(metric_fn=metric_fn, objective=objective,
                                       num_class=num_class, **cfg),
                          label=f"{type(self).__name__}/cv_program")


def _class_count(y: np.ndarray, declared) -> int:
    if declared:
        return int(declared)
    return max(2, int(y.max()) + 1) if len(y) else 2


def _log_priors(y: np.ndarray, w: np.ndarray, k: int) -> np.ndarray:
    counts = np.zeros(k)
    for c in range(k):
        counts[c] = float(w[y == c].sum())
    p = np.clip(counts / max(counts.sum(), 1e-12), 1e-6, 1.0)
    return np.log(p)


class GradientBoostedTreesClassifier(_GBTBase):
    """OpGBTClassifier / OpXGBoostClassifier capability: binary labels boost
    one logistic margin, K>2 labels the multi:softmax objective."""

    num_class = Param(default=None)

    def _resolved(self, y, w):
        k = _class_count(y, self.num_class)
        if k <= 2:
            we = w * np.where(y == 1.0, float(self.scale_pos_weight), 1.0)
            sw = max(float(we.sum()), 1e-12)
            p = float(np.clip((we * (y == 1.0)).sum() / sw, 1e-6, 1 - 1e-6))
            return "binary:logistic", 1, np.array([np.log(p / (1 - p))])
        return "multi:softmax", k, _log_priors(y, w, k)


class GradientBoostedTreesRegressor(_GBTBase):
    """OpGBTRegressor capability (squared-error boosting)."""

    objective = "reg:squarederror"

    def _resolved(self, y, w):
        sw = max(float(w.sum()), 1e-12)
        return "reg:squarederror", 1, np.array([float((w * y).sum() / sw)])


class _ForestBase(_TreeEstimatorBase):
    num_trees = Param(default=50)
    reg_lambda = Param(default=0.0)
    subsample = Param(default=1.0)
    feature_subset = Param(default="sqrt")
    classification: bool = True

    def _masks(self, d: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        fs = self.feature_subset
        if fs == "all":
            k = d
        elif fs == "sqrt":
            k = max(1, int(np.sqrt(d)))
        elif fs == "onethird":
            k = max(1, d // 3)
        else:
            k = max(1, int(float(fs) * d))
        masks = np.zeros((self.num_trees, d), dtype=np.float32)
        for t in range(self.num_trees):
            masks[t, rng.choice(d, size=k, replace=False)] = 1.0
        return masks

    def _boot(self, n: int, device) -> torch.Tensor:
        """Poisson bootstrap counts, keyed on the estimator seed so the sweep
        and the refit draw the same trees."""
        return draw_bootstrap(int(self.seed) + 1, float(self.subsample),
                              int(self.num_trees), n, device)

    def _y_cols(self, y: np.ndarray) -> np.ndarray:
        if not self.classification:
            return y[:, None].astype(np.float32)
        k = _class_count(y, getattr(self, "num_class", None))
        if k <= 2:
            return y[:, None].astype(np.float32)
        return np.eye(k, dtype=np.float32)[y.astype(np.int32)]

    def _fit_forest_trees(self, x, y, w, device):
        binned, edges = self._binned(x, device)
        wd = torch.from_numpy(np.asarray(w, np.float32)).to(device)
        boot = self._boot(x.shape[0], device).to(torch.float32)
        int_exact = bool(self.classification and np.all(
            (np.asarray(w) == 0.0) | (np.asarray(w) == 1.0)))
        trees, _ = _forest_lanes(
            binned, torch.from_numpy(self._y_cols(y)).to(device),
            wd[None, :] * boot,
            torch.from_numpy(self._masks(x.shape[1])).to(device),
            int(self.max_depth), int(self.n_bins), self.reg_lambda,
            self.min_child_weight, int_exact)
        return trees, edges

    def _sweep_folds(self, binned, x, y, train_w, val_w, metric_fn,
                     weights01=False):
        dev = binned.device
        boot = self._boot(int(x.shape[0]), dev).to(torch.float32)
        return run_cached(
            _forest_cv,
            binned, torch.from_numpy(np.asarray(y, np.float32)).to(dev),
            torch.from_numpy(self._y_cols(y)).to(dev), train_w, val_w,
            torch.from_numpy(self._masks(x.shape[1])).to(dev), boot,
            kwargs=dict(reg_lambda=self.reg_lambda,
                        min_child_weight=self.min_child_weight),
            statics=dict(max_depth=int(self.max_depth), n_bins=int(self.n_bins),
                         classification=self.classification, metric_fn=metric_fn,
                         # grad/hess = fold_w x poisson counts x one-hot
                         # targets: exact int8 when fold weights are 0/1 and
                         # targets are class indicators
                         int_exact=weights01 and self.classification),
            label=f"{type(self).__name__}/cv_program")


class RandomForestClassifier(_ForestBase):
    """OpRandomForestClassifier capability (leaves carry class distributions)."""

    num_class = Param(default=None)
    classification = True

    def _fit_arrays(self, x, y, w, device):
        trees, edges = self._fit_forest_trees(x, y, w, device)
        return ForestClassifierModel(trees=trees, edges=edges,
                                     max_depth=self.max_depth, n_bins=self.n_bins)


class RandomForestRegressor(_ForestBase):
    """OpRandomForestRegressor capability (one-third feature subset)."""

    feature_subset = Param(default="onethird")
    classification = False

    def _fit_arrays(self, x, y, w, device):
        trees, edges = self._fit_forest_trees(x, y, w, device)
        return ForestRegressorModel(trees=trees, edges=edges,
                                    max_depth=self.max_depth, n_bins=self.n_bins)


class DecisionTreeClassifier(RandomForestClassifier):
    """OpDecisionTreeClassifier capability: a 1-tree forest on all rows and
    features."""

    def __init__(self, **kw):
        kw.setdefault("num_trees", 1)
        kw.setdefault("feature_subset", "all")
        kw.setdefault("subsample", 1.0)
        super().__init__(**kw)

    def _boot(self, n: int, device) -> torch.Tensor:
        return torch.ones((self.num_trees, n), dtype=torch.float32, device=device)


class DecisionTreeRegressor(RandomForestRegressor):
    """OpDecisionTreeRegressor capability: a 1-tree forest on all rows and
    features."""

    def __init__(self, **kw):
        kw.setdefault("num_trees", 1)
        kw.setdefault("feature_subset", "all")
        kw.setdefault("subsample", 1.0)
        super().__init__(**kw)

    def _boot(self, n: int, device) -> torch.Tensor:
        return torch.ones((self.num_trees, n), dtype=torch.float32, device=device)


class XGBoostClassifier(GradientBoostedTreesClassifier):
    """OpXGBoostClassifier's name for the GBT classifier."""


class XGBoostRegressor(GradientBoostedTreesRegressor):
    """OpXGBoostRegressor's name for the GBT regressor."""
