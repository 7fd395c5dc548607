"""Record-level insights: leave-one-covariate-out and correlation variants
(counterpart of ``transmogrifai_tpu/insights/loco.py``).

:class:`RecordInsightsLOCO` computes the reference's function with the
re-scoring on a device (the CUDA card unless the caller names another).
A row's entry for a slot group is the SUM of its single-slot diffs (the
payload of the row minus the payload of the row with that one slot
zeroed) over the group's active slots; groups rank by the strategy's value
with a stable sort, and the top K become JSON lists rounded to 10 decimals.
Zeroing an inactive slot (``x[i, j] == 0``) changes nothing and the
reference never reads its diff, so only the active (row, slot) pairs are
tiled: the tiles are built on the device, chunked by
``max_rows_per_batch`` pairs, and scored by the model's float64 device
scorer (``insight_payload``: the linear families and the MLP in float64,
tree ensembles through their summed-leaf traversal); each group's sum adds
its diffs in slot order, as the reference's does (:func:`group_sums`: no
two additions race, so a run gives the same sums every time), and the
ranking is one ``torch.sort(stable=True)``, Python's stable sort's order.
Only the JSON formatting runs on the host.

:class:`RecordInsightsCorr` stays on the host, as in the reference.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.dataset import Column, Dataset
from ..stages.base import Param, UnaryTransformer
from ..types import OPVector, TextMap
from ..utils.vector_metadata import VectorMetadata

#: bytes of float64 tiles one re-scoring call may hold
_TILE_BYTES = 1 << 30


def _payload(pred_col) -> np.ndarray:
    """(n, k) insight payload: class probabilities, else the prediction."""
    if pred_col.prob is not None:
        return np.asarray(pred_col.prob, dtype=np.float64)
    return np.asarray(pred_col.pred, dtype=np.float64)[:, None]


def group_sums(key: torch.Tensor, diffs: torch.Tensor, size: int) -> torch.Tensor:
    """(size, k) sums of the rows of ``diffs`` (P, k) by ``key`` (P,): each
    key's rows added one after another in their order in ``diffs``, from 0.
    The pairs are sorted by key (stably) and summed in passes, pass p adding
    every key's p-th row: a key appears at most once in a pass, so the sums
    are the same on every run and device (a scatter-add of repeated keys
    adds in whatever order its atomics land)."""
    sums = torch.zeros((size, diffs.shape[1]), dtype=diffs.dtype, device=diffs.device)
    if key.numel() == 0:
        return sums
    order = torch.sort(key, stable=True).indices
    key, diffs = key[order], diffs[order]
    at = torch.arange(key.numel(), device=key.device)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    pos = at - torch.cummax(torch.where(first, at, 0), dim=0).values
    for p in range(int(pos.max()) + 1):  # opcheck: allow(TM301) the loop's bound (the most duplicate keys), read once a call
        m = pos == p
        sums[key[m]] += diffs[m]
    return sums


class RecordInsightsLOCO(UnaryTransformer):
    """Per-row leave-one-covariate-out insights: OPVector -> TextMap.

    Output map: slot (or aggregated group) name -> JSON list of per-class
    score diffs (base minus zeroed), the top-K strongest entries per row.
    ``device`` (keyword only): where the re-scoring runs (the CUDA card
    unless it names another).  ``last_profile`` holds the last transform's
    active pairs and its device and host milliseconds."""

    input_types = (OPVector,)
    output_type = TextMap

    top_k = Param(default=20, doc="entries kept per record")
    strategy = Param(default="abs",
                     validator=lambda v: v in ("abs", "positive", "negative"),
                     doc="rank by |diff|, most-positive, or most-negative")
    max_rows_per_batch = Param(default=65536,
                               doc="cap on rows*slots per model call (memory bound)")

    def __init__(self, model, meta: Optional[VectorMetadata] = None, *,
                 device=None, **kw):
        super().__init__(**kw)
        self.model = model
        self._meta_override = meta
        self._device = device
        self.last_profile: Dict[str, float] = {}

    @staticmethod
    def _groups(meta: Optional[VectorMetadata], d: int
                ) -> List[Tuple[str, List[int]]]:
        """Aggregation plan: hashed-text / date-circle slots collapse into one
        entry per (parent, grouping); indicator and plain numeric slots stay
        per slot; without matching metadata every slot is ``slot_{j}``."""
        if meta is None or len(meta.columns) != d:
            return [(f"slot_{j}", [j]) for j in range(d)]
        grouped: Dict[str, List[int]] = {}
        order: List[str] = []
        for c in meta.columns:
            if c.indicator_value is None and (c.grouping or c.descriptor_value):
                key = f"{c.parent_feature}_{c.grouping or c.descriptor_value}"
            else:
                key = c.make_name()
            if key not in grouped:
                grouped[key] = []
                order.append(key)
            grouped[key].append(c.index)
        return [(k, grouped[k]) for k in order]

    def _rank(self, sums: torch.Tensor) -> torch.Tensor:
        if self.strategy == "positive":
            return sums[..., -1]
        if self.strategy == "negative":
            return -sums[..., -1]
        return sums.abs().amax(dim=-1)

    def _top(self, x: torch.Tensor, gid: torch.Tensor, n_groups: int):
        """(order (n, K) group indices, values (n, K, k), kept (n,)) of the
        rows ``x`` (float64 on the device): each row's present groups by
        rank, best first, at most ``top_k``."""
        n, d = x.shape
        base = self.model.insight_payload(x)
        k = base.shape[1]
        rows, cols = torch.nonzero(x != 0, as_tuple=True)
        chunk = max(1, min(int(self.max_rows_per_batch), _TILE_BYTES // (8 * max(d, 1))))
        diffs = []
        for s in range(0, rows.numel(), chunk):
            r, c = rows[s:s + chunk], cols[s:s + chunk]
            tiles = x[r]
            tiles[torch.arange(r.numel(), device=x.device), c] = 0.0
            diffs.append(base[r] - self.model.insight_payload(tiles))
        key = rows * n_groups + gid[cols]
        sums = group_sums(key, torch.cat(diffs) if diffs else base[:0], n * n_groups)
        present = torch.zeros(n * n_groups, dtype=torch.bool, device=x.device)
        present[key] = True
        sums = sums.view(n, n_groups, k)
        present = present.view(n, n_groups)
        rank = torch.where(present, self._rank(sums),
                           torch.full((), -np.inf, dtype=torch.float64, device=x.device))
        top = min(int(self.top_k), n_groups)
        order = torch.sort(-rank, dim=1, stable=True).indices[:, :top]
        vals = torch.gather(sums, 1, order[..., None].expand(-1, -1, k))
        kept = torch.clamp(present.sum(dim=1), max=top)
        return order, vals, kept, int(rows.numel())

    def transform_columns(self, cols: List[Column], dataset: Dataset) -> Column:
        from ..perf.kernels.dispatch import resolve_device

        dev = resolve_device(self._device)
        vec = cols[0]
        x = np.asarray(vec.data, dtype=np.float64)
        n, d = x.shape
        plan = self._groups(self._meta_override or vec.meta, d)
        gid = np.empty(d, np.int64)
        for g, (_, idxs) in enumerate(plan):
            gid[idxs] = g
        on_card = dev.type == "cuda"
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        xd = torch.from_numpy(x).to(dev)
        order, vals, kept, pairs = self._top(
            xd, torch.from_numpy(gid).to(dev), len(plan))
        if on_card:
            end.record()
        order, vals, kept = order.cpu().numpy(), vals.cpu().numpy(), kept.cpu().numpy()
        t0 = time.perf_counter()
        names = [name for name, _ in plan]
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = {names[g]: json.dumps([round(float(c), 10) for c in v])
                      for g, v in zip(order[i, :kept[i]], vals[i, :kept[i]])}
        self.last_profile = {
            "rows": n, "slots": d, "pairs": pairs,
            "device_ms": start.elapsed_time(end) if on_card else None,
            "host_ms": 1e3 * (time.perf_counter() - t0)}
        return Column(TextMap, out)

    @staticmethod
    def parse(insight_map: Dict[str, str]) -> Dict[str, List[float]]:
        """Decode one record's insights back to {name: per-class diffs}."""
        return {k: json.loads(v) for k, v in insight_map.items()}


class RecordInsightsCorr(UnaryTransformer):
    """Correlation-based record insights (the older variant): ranks slots by
    |slot value x corr(slot, model score)| over the batch, on the host."""

    input_types = (OPVector,)
    output_type = TextMap

    top_k = Param(default=20)

    def __init__(self, model, meta: Optional[VectorMetadata] = None, **kw):
        super().__init__(**kw)
        self.model = model
        self._meta_override = meta

    def transform_columns(self, cols: List[Column], dataset: Dataset) -> Column:
        from ..utils.stats import pearson_with_label

        vec = cols[0]
        x = np.asarray(vec.data, dtype=np.float64)
        n, d = x.shape
        meta = self._meta_override or vec.meta
        score = _payload(self.model.predict_column(Column.vector(x)))[:, -1]
        corr = np.nan_to_num(pearson_with_label(x, score))
        names = (meta.column_names() if meta is not None and len(meta.columns) == d
                 else [f"slot_{j}" for j in range(d)])
        contrib = x * corr[None, :]
        out = np.empty(n, dtype=object)
        top_k = int(self.top_k)
        for i in range(n):
            order = np.argsort(-np.abs(contrib[i]))[:top_k]
            out[i] = {names[j]: json.dumps([round(float(contrib[i, j]), 10)])
                      for j in order if contrib[i, j] != 0.0}
        return Column(TextMap, out)
