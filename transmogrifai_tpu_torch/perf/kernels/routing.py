"""Lane routing select of tree growth (K3): CUDA kernel, plain version, counter.

Counterpart of ``transmogrifai_tpu/perf/kernels/routing.py``: after a level's
splits are chosen every row reads the bin code of its node's split feature,
``out[l, i] = binned[i, idx[l, i]]``, and 0 where ``idx`` lies outside
[0, d) — the reference's one-hot compare-reduce semantics.

- :func:`row_select_lanes` — the wrapper: launches
  ``tmog_row_select_lanes`` of ``csrc/trees.cu`` (one thread per (lane, row))
  on CUDA tensors; a CPU tensor takes the plain version.
- :func:`row_select_lanes_torch` — the plain version, the reference's
  compare-multiply-reduce (``row_select_lanes_xla``).  It materialises
  (L, rows, d) one chunk of rows at a time.
- ``launches`` — the launch counter.

Prediction traversal reads codes with ``torch.gather`` (a plain gather, as
the reference's ``_row_select`` of ``_predict_tree`` is not a kernel), so
this kernel launches once per grown level and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from . import dispatch

launches = 0

#: rows per chunk of the plain version (bounds its (L, rows, d) temporary)
PLAIN_CHUNK = 4096

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"tmog_row_select_lanes": (_VP, _VP, _VP, _INT, _INT, _INT, _VP)}


def reset_launch_counts() -> None:
    global launches
    launches = 0


def launch_counts() -> dict:
    return {"row_select_lanes": launches}


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


def row_select_lanes(binned: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Routing select: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors.  binned (n, d) int32, idx (L, n) int32 -> (L, n) int32."""
    global launches
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
    out = torch.empty((L, n), dtype=torch.int32, device=binned.device)
    err = _lib().tmog_row_select_lanes(binned.data_ptr(), idx.data_ptr(),
                                       out.data_ptr(), n, d, L,
                                       dispatch.stream_handle(binned.device))
    dispatch.check_launch(err, "row_select_lanes")
    launches += 1
    return out


def bound_bytes(L: int, n: int, d: int) -> int:
    """Bytes the select must move: idx read and the output written once, and
    the codes it needs — one per (lane, row), at most the whole table."""
    return L * n * 4 * 2 + min(L * n, n * d) * 4
