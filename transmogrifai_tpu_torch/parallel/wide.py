"""Column-sharded statistics for wide feature matrices (counterpart of
``transmogrifai_tpu/parallel/wide.py``).

The widest dense object of a train is the SanityChecker's (d, d) correlation
matrix.  Past ``max_features_for_full_corr`` columns under a mesh the
reference shards the FEATURE dimension over the mesh's ``data`` axis:

- per-column moments and label correlations need no collective (each rank
  owns whole columns over every row; the label is replicated);
- the full correlation builds block by block around a ring: each rank holds
  its (n, d/k) column shard, computes one (d/k, d/k) gram block a step
  against the shard passing through, and hands that shard to the next rank
  (``collectives.ring_exchange``, the reference's ``ppermute``), so no rank
  multiplies the whole (n, d) block.

The block product is a plain ``torch.matmul``, as the reference's is a plain
XLA dot outside any Pallas kernel.  The block rows are gathered at the end,
so every rank holds the whole matrix.

The SanityChecker's wide path (``checkers/sanity.py``) calls
:func:`shard_cols` and :func:`wide_full_corr`; :func:`col_sharding` and
:func:`wide_col_stats` are kept as the reference's public names, so a script
written against the reference runs them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import collectives as C
from .mesh import DATA_AXIS, Mesh, pad_axis


def col_sharding(mesh: Mesh) -> Tuple[Optional[str], str]:
    """The partition of an (n, d) block: rows whole, columns over data."""
    return (None, DATA_AXIS)


def pad_cols(arr: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the feature axis to a multiple (even shards); returns (padded, d_valid)."""
    return pad_axis(arr, 1, multiple)


def shard_cols(arr, mesh: Mesh, device=None):
    """This rank's column shard of (n, d), zero-padded to the data-axis
    multiple, on its device; returns (shard, d_valid).  A tensor input is
    split on its own device (no host round trip)."""
    k = mesh.shape[DATA_AXIS]
    i = mesh.index(DATA_AXIS)
    if isinstance(arr, torch.Tensor):
        d_valid = int(arr.shape[1])
        pad_c = (-d_valid) % k
        padded = torch.nn.functional.pad(arr, (0, pad_c)) if pad_c else arr
        dev = arr.device if device is None else torch.device(device)
    else:
        padded_np, d_valid = pad_cols(np.asarray(arr), k)
        padded = torch.from_numpy(np.ascontiguousarray(padded_np))
        dev = mesh.device if device is None else torch.device(device)
    per = padded.shape[1] // k
    return padded[:, i * per:(i + 1) * per].contiguous().to(dev), d_valid


def _gather_cols(v: torch.Tensor, mesh: Mesh, d_valid: Optional[int]) -> torch.Tensor:
    """Every rank's slice of a per-column vector, in column order."""
    per = v.shape[0]
    full = C.all_gather_rows(v, mesh.group(DATA_AXIS), per,
                             per * mesh.shape[DATA_AXIS])
    return full if d_valid is None else full[:d_valid]


def wide_col_stats(x: torch.Tensor, y: torch.Tensor, mesh: Mesh,
                   d_valid: Optional[int] = None):
    """(mean, var, min, max, corr-with-label) per column of a column shard
    ``x`` (n, d/k) against the replicated label ``y``: local reductions over
    rows, no collective for the statistics; the shards' vectors are then
    gathered in column order (trimmed to ``d_valid``)."""
    n = x.shape[0]
    mean = x.mean(dim=0)
    var = x.var(dim=0, unbiased=False)
    xmin = x.amin(dim=0)
    xmax = x.amax(dim=0)
    xc = x - mean
    yc = y - y.mean()
    cov = xc.T @ yc / n
    sx = torch.sqrt((xc ** 2).mean(dim=0))
    sy = torch.sqrt((yc ** 2).mean())
    corr = cov / torch.clamp(sx * sy, min=1e-12)
    return tuple(_gather_cols(v, mesh, d_valid)
                 for v in (mean, var, xmin, xmax, corr))


def wide_gram_ring(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """X^T X / n of a column-sharded X by a ring: this rank's (d/k, d)
    block row, one (d/k, d/k) block a step against the shard passing
    through (float32 in transit, each product accumulated in float64),
    then the block rows of every rank gathered: (d, d)."""
    k = mesh.shape[DATA_AXIS]
    me = mesh.index(DATA_AXIS)
    group = mesh.group(DATA_AXIS)
    n, d_local = x.shape
    blocks = x.new_zeros((k, d_local, d_local))
    passing, src = x, me
    xd = x.to(torch.float64)
    for step in range(k):
        # each block accumulates in float64 and rounds once, as the one-card
        # product does (``checkers/sanity.py::_device_full_corr``)
        blocks[src] = (xd.T @ passing.to(torch.float64) / float(n)).to(x.dtype)
        if step < k - 1:
            passing = C.ring_exchange(passing, group)
            src = (src - 1) % k  # we now hold the previous rank's shard
    row = torch.cat([blocks[j] for j in range(k)], dim=1)  # (d/k, d)
    return C.all_gather_rows(row, group, d_local, d_local * k)


def wide_full_corr(x: torch.Tensor, mesh: Mesh,
                   d_valid: Optional[int] = None) -> torch.Tensor:
    """Full (d, d) Pearson correlation of a column-sharded X: the ring's
    gram of the centred shard, normalised by the outer product of its
    diagonal's square roots floored at 1e-12 (trimmed to ``d_valid``)."""
    # centred as the one-card product centres (``checkers/sanity.py::
    # _device_full_corr``: the column sum over a float32 row count)
    tot = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=x.device)
    xc = x - x.sum(dim=0) / tot
    gram = wide_gram_ring(xc, mesh)
    sd = torch.sqrt(torch.diagonal(gram))
    corr = gram / torch.clamp(sd[:, None] * sd[None, :], min=1e-12)
    if d_valid is not None:
        corr = corr[:d_valid, :d_valid]
    return corr
