"""Serving-prefix encode kernels: level-code one-hot (K4) and bucketize (K5).

Counterpart of ``transmogrifai_tpu/perf/kernels/encode.py``.  Each kernel has
three pieces here:

- the wrapper (:func:`onehot_codes`, :func:`bucketize_right_encode`): checks
  device, dtype, shape and contiguity, allocates its output with
  ``torch.empty``, launches the CUDA kernel of ``csrc/encode.cu`` on the
  current stream without synchronising, and adds one to its launch counter.
  A CPU tensor takes the plain version instead; any other device raises;
- the plain PyTorch version (:func:`onehot_codes_torch`,
  :func:`bucketize_right_encode_torch`), written with the reference's XLA
  formulas, so it is bitwise equal to the JAX kernels.  The CPU plan and the
  tests use it, and ``chip_smoke.py`` holds each kernel against it on the card;
- the launch counter (``onehot_launches``, ``bucketize_launches``), a plain
  integer that only the wrapper's kernel launch increments.
"""

from __future__ import annotations

import ctypes

import torch

from . import dispatch

onehot_launches = 0
bucketize_launches = 0

#: dynamic shared memory the bucketize kernel may take for its splits
_MAX_SPLITS = 48 * 1024 // 4

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tmog_onehot_codes": (_VP, _VP, _INT, _INT, _VP),
    "tmog_bucketize_right": (_VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP),
}


def reset_launch_counts() -> None:
    global onehot_launches, bucketize_launches
    onehot_launches = 0
    bucketize_launches = 0


def launch_counts() -> dict:
    return {"onehot_codes": onehot_launches,
            "bucketize_right_encode": bucketize_launches}


def _lib():
    return dispatch.load("encode", _SIGNATURES)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on unsupported device {t.device}")


# -- K4: level-code one-hot ---------------------------------------------------

def onehot_codes_torch(codes: torch.Tensor, width: int) -> torch.Tensor:
    """(n, width) float32 one-hot of int32 codes with ``jax.nn.one_hot``
    semantics: a negative or out-of-range code gives an all-zero row."""
    ids = torch.arange(width, dtype=torch.int32, device=codes.device)
    return (codes.to(torch.int32)[:, None] == ids).to(torch.float32)


def onehot_codes(codes: torch.Tensor, width: int) -> torch.Tensor:
    """One-hot of int32 level codes: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    global onehot_launches
    _check(codes, "codes", torch.int32, 1)
    width = int(width)
    if width <= 0:
        raise ValueError(f"width must be positive, got {width}")
    if codes.device.type == "cpu":
        return onehot_codes_torch(codes, width)
    n = int(codes.shape[0])
    out = torch.empty((n, width), dtype=torch.float32, device=codes.device)
    if n == 0:
        return out
    err = _lib().tmog_onehot_codes(codes.data_ptr(), out.data_ptr(), n, width,
                                   dispatch.stream_handle(codes.device))
    dispatch.check_launch(err, "onehot_codes")
    onehot_launches += 1
    return out


# -- K5: right-inclusive bucketize one-hot --------------------------------------

def bucket_width(n_splits: int, track_nulls: bool, track_invalid: bool) -> int:
    return n_splits - 1 + int(bool(track_invalid)) + int(bool(track_nulls))


def bucketize_right_encode_torch(x: torch.Tensor, splits: torch.Tensor,
                                 track_nulls: bool,
                                 track_invalid: bool) -> torch.Tensor:
    """Right-inclusive bucketize one-hot of ``x`` (float32, NaN = missing)
    over ``splits`` (S >= 2 sorted edges): buckets ``(s[i], s[i+1]]``, then
    the optional invalid and null columns — the reference's XLA formula
    (``ops/bucketizers.py:183-194``)."""
    n_buckets = int(splits.shape[0]) - 1
    present = ~torch.isnan(x)
    finite = present & torch.isfinite(x)
    v0 = torch.nan_to_num(x)
    idx = torch.clamp(torch.searchsorted(splits, v0, side="left") - 1,
                      0, n_buckets - 1)
    in_range = finite & (x > splits[0]) & (x <= splits[-1])
    ids = torch.arange(n_buckets, device=x.device)
    parts = [(idx[:, None] == ids).to(torch.float32)
             * in_range.to(torch.float32)[:, None]]
    if track_invalid:
        parts.append((present & ~in_range).to(torch.float32)[:, None])
    if track_nulls:
        parts.append((~present).to(torch.float32)[:, None])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def bucketize_right_encode(x: torch.Tensor, splits: torch.Tensor,
                           track_nulls: bool, track_invalid: bool) -> torch.Tensor:
    """Bucketize one-hot: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor.  ``splits`` lies on the same device as ``x``."""
    global bucketize_launches
    _check(x, "x", torch.float32, 1)
    _check(splits, "splits", torch.float32, 1)
    if splits.device != x.device:
        raise ValueError(f"splits on {splits.device}, x on {x.device}")
    n_splits = int(splits.shape[0])
    if not 2 <= n_splits <= _MAX_SPLITS:
        raise ValueError(f"need 2..{_MAX_SPLITS} splits, got {n_splits}")
    if x.device.type == "cpu":
        return bucketize_right_encode_torch(x, splits, track_nulls, track_invalid)
    n = int(x.shape[0])
    width = bucket_width(n_splits, track_nulls, track_invalid)
    out = torch.empty((n, width), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    err = _lib().tmog_bucketize_right(
        x.data_ptr(), splits.data_ptr(), out.data_ptr(), n, n_splits,
        int(bool(track_invalid)), int(bool(track_nulls)),
        dispatch.stream_handle(x.device))
    dispatch.check_launch(err, "bucketize_right_encode")
    bucketize_launches += 1
    return out
