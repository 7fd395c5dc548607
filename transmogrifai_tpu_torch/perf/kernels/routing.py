"""Lane routing select of tree growth (K3): CUDA kernel, plain version, counter.

Counterpart of ``transmogrifai_tpu/perf/kernels/routing.py``: after a level's
splits are chosen every row reads the bin code of its node's split feature,
``out[l, i] = binned[i, idx[l, i]]``, and 0 where ``idx`` lies outside
[0, d) — the reference's one-hot compare-reduce semantics.

- :func:`row_select_lanes` — the wrapper: launches
  ``tmog_row_select_lanes`` of ``csrc/trees.cu`` on CUDA tensors, by the
  path :func:`plan` picks; a CPU tensor takes the plain version.
- :func:`plan` — the launch: the tile path (a CTA stages R rows of codes in
  shared memory once and serves every lane from them) where many lanes share
  each row, the direct path (one thread per row gathers its lanes' codes)
  where few do, whichever moves fewer bytes (:func:`design_bytes`).
- :func:`row_select_lanes_torch` — the plain version, the reference's
  compare-multiply-reduce (``row_select_lanes_xla``).  It materialises
  (L, rows, d) one chunk of rows at a time.
- ``launches`` — the launch counter; ``path_launches`` splits it by path.

Prediction traversal reads codes with ``torch.gather`` (a plain gather, as
the reference's ``_row_select`` of ``_predict_tree`` is not a kernel), so
this kernel launches once per grown level and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import dispatch

launches = 0
path_launches = {"tile": 0, "direct": 0}

#: rows per chunk of the plain version (bounds its (L, rows, d) temporary)
PLAIN_CHUNK = 4096

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"tmog_row_select_lanes": (_VP, _VP, _VP) + (_INT,) * 7 + (_VP,)}

#: threads of a CTA of either kernel
THREADS = 256
#: rows a tile CTA stages, most first, and the shared memory they may take
TILE_ROWS = (64, 32)
TILE_SMEM = 100 * 1024
#: bytes a gather of the direct path fetches: one 32-byte sector
SECTOR = 32


class RoutePlan(NamedTuple):
    """One launch of the select.  ``path`` "tile": CTAs of ``threads``
    threads each stage ``rows`` rows of codes at a stride of ``stride``
    words (``smem`` bytes) and serve every lane from them; "direct": one
    thread per row (``rows`` = ``threads`` rows a CTA, no shared memory)."""
    path: str
    rows: int
    stride: int
    threads: int
    ctas: int
    smem: int


def reset_launch_counts() -> None:
    global launches
    launches = 0
    path_launches.update(tile=0, direct=0)


def launch_counts() -> dict:
    return {"row_select_lanes": launches,
            **{f"row_select_lanes.{k}": v for k, v in path_launches.items()}}


def _lib():
    return dispatch.load("trees", _SIGNATURES)


def row_select_lanes_torch(binned: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``binned[i, idx[l, i]]`` as a compare against a feature iota fused
    into a multiply-reduce (exact for codes below 2**24)."""
    n, d = binned.shape
    ids = torch.arange(d, dtype=torch.int32, device=binned.device)
    parts = []
    for lo in range(0, n, PLAIN_CHUNK):
        hi = min(n, lo + PLAIN_CHUNK)
        oh = ids[None, None, :] == idx[:, lo:hi, None]
        parts.append((binned[lo:hi].to(torch.float32)[None] * oh)
                     .sum(dim=-1).to(torch.int32))
    if not parts:
        return torch.zeros_like(idx)
    return torch.cat(parts, dim=1)


def plan(L: int, n: int, d: int) -> RoutePlan:
    """The path that moves fewer bytes (:func:`design_bytes`): the tile path
    where it fits — R >= 32 staged rows at an odd stride within
    ``TILE_SMEM`` — and many lanes share each row (roughly L > d / 8), else
    the direct path."""
    direct = RoutePlan("direct", THREADS, 0, THREADS, -(-n // THREADS), 0)
    stride = d | 1                      # odd: one feature of 32 rows, 32 banks
    rows = next((r for r in TILE_ROWS if r * stride * 4 <= TILE_SMEM), None)
    if rows is None:
        return direct
    tile = RoutePlan("tile", rows, stride, THREADS, -(-n // rows), rows * stride * 4)
    if design_bytes(tile, L, n, d) < design_bytes(direct, L, n, d):
        return tile
    return direct


def design_bytes(p: RoutePlan, L: int, n: int, d: int) -> int:
    """Bytes the plan's design moves: the tile path reads the table once
    and idx once and writes out once; the direct path reads idx and writes
    out once and fetches a 32-byte sector for each (lane, row)'s code."""
    if p.path == "tile":
        return n * d * 4 + 2 * L * n * 4
    return L * n * (8 + SECTOR)


def row_select_lanes(binned: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Routing select: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors.  binned (n, d) int32, idx (L, n) int32 -> (L, n) int32."""
    for t, name, nd in ((binned, "binned", 2), (idx, "idx", 2)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != nd:
            raise ValueError(f"{name} must be {nd}-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, d = binned.shape
    L = idx.shape[0]
    if idx.shape[1] != n:
        raise ValueError(f"idx {tuple(idx.shape)} does not match {n} rows")
    if binned.device != idx.device:
        raise ValueError(f"binned on {binned.device}, idx on {idx.device}")
    if binned.device.type == "cpu":
        return row_select_lanes_torch(binned, idx)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    return launch(binned, idx, plan(L, n, d))


def launch(binned: torch.Tensor, idx: torch.Tensor, p: RoutePlan) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors by plan ``p`` (the
    card tests run both paths on the same inputs)."""
    global launches
    n, d = binned.shape
    L = idx.shape[0]
    if p.path == "tile" and (p.threads % p.rows or p.stride < d):
        raise ValueError(f"tile plan {p} does not fit d={d}")
    out = torch.empty((L, n), dtype=torch.int32, device=binned.device)
    err = _lib().tmog_row_select_lanes(
        binned.data_ptr(), idx.data_ptr(), out.data_ptr(), n, d, L,
        int(p.path == "tile"), p.rows, p.stride, p.threads,
        dispatch.stream_handle(binned.device))
    dispatch.check_launch(err, "row_select_lanes")
    launches += 1
    path_launches[p.path] += 1
    return out


def bound_bytes(L: int, n: int, d: int) -> int:
    """Bytes the select must move: idx read and the output written once, and
    the codes it needs — one per (lane, row), at most the whole table."""
    return L * n * 4 * 2 + min(L * n, n * d) * 4
