"""Host kernels of the hashing trick, built with g++ at first use (counterpart
of ``transmogrifai_tpu/native/__init__.py``).

``fasthost.cpp`` (the port's own copy of the reference's source) compiles
with ``g++ -O3`` into ``build/native/`` at the repo root
(``TMOG_TORCH_NATIVE_DIR`` overrides it), keyed by a hash of the source, and
loads with ``ctypes``.  The build writes a temporary file and renames it into
place, so parallel processes that build at once agree on one library.  Each
function has a pure-Python path beside the native one that gives the same
bits: as in the reference, the library is built only once a call passes
:data:`_BUILD_THRESHOLD` strings (or after :func:`warmup`), and a failed
build leaves the Python path in use.  :func:`path_counts` says which path
each call took (``<function>.native`` / ``<function>.python``, and
``tokenize_hash_count.unicode_rows`` for the non-ASCII rows the fused kernel
hands back to the exact Unicode tokenizer), so a machine where g++ failed
cannot pass for one where it built; :data:`BUILD_ERROR` keeps the failure.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fasthost.cpp")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()
#: why the build or load failed (None while it has not failed)
BUILD_ERROR: Optional[str] = None
#: {"seconds": g++ seconds (0.0 when the library was already built), "path": ...}
BUILD_INFO: Dict[str, object] = {}

#: below this many strings the Python path is faster than a cold g++ build
#: inside the first transform: the build only starts past it (or at warmup())
_BUILD_THRESHOLD = 2048

_COUNTS: Dict[str, int] = {}


def _count(key: str, n: int = 1) -> None:
    _COUNTS[key] = _COUNTS.get(key, 0) + n  # opcheck: allow(TM306) path counters, read around one caller's run


def path_counts() -> Dict[str, int]:
    """Calls by path since the last :func:`reset_path_counts`."""
    return dict(_COUNTS)


def reset_path_counts() -> None:
    _COUNTS.clear()  # opcheck: allow(TM306) path counters, reset between runs by their one reader


def build_dir() -> str:
    return os.environ.get("TMOG_TORCH_NATIVE_DIR") or os.path.join(
        _REPO, "build", "native")


def library_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(build_dir(), f"fasthost-{digest.hexdigest()[:16]}.so")


def _build_and_load() -> ctypes.CDLL:
    path = library_path()
    t0 = time.perf_counter()
    if not os.path.exists(path):
        os.makedirs(build_dir(), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic: concurrent builders agree on the file
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=path)  # opcheck: allow(TM306) its one caller, library(), holds _LOCK
    lib = ctypes.CDLL(path)
    lib.murmur3_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32)]
    lib.murmur3_batch.restype = None
    lib.hash_count_block.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_int32, ctypes.POINTER(ctypes.c_float)]
    lib.hash_count_block.restype = None
    lib.tokenize_hash_count.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64)]
    lib.tokenize_hash_count.restype = None
    return lib


def _lib(force: bool = False) -> Optional[ctypes.CDLL]:
    """The loaded library; with ``force`` the first call builds it (once per
    process: a failed build is not retried)."""
    global _LIB, _TRIED, BUILD_ERROR
    if force and not _TRIED:
        with _LOCK:
            if not _TRIED:
                try:
                    _LIB = _build_and_load()
                except Exception as e:  # noqa: BLE001 — the Python path stays
                    err = getattr(e, "stderr", None)
                    BUILD_ERROR = f"{type(e).__name__}: {e}" + (
                        f"\n{err.decode(errors='replace')}" if err else "")
                _TRIED = True
    return _LIB


def warmup() -> bool:
    """Build and load the library now; True if the native path is active."""
    return _lib(force=True) is not None


#: the reference's name for :func:`warmup`
available = warmup


def _pack(tokens: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    """Strings -> one UTF-8 buffer + int64 offsets (n + 1)."""
    encoded = [t.encode("utf-8") for t in tokens]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def murmur3_batch(tokens: Sequence[str], seed: int = 42) -> np.ndarray:
    """uint32 murmur3 of each token."""
    lib = _lib(force=len(tokens) >= _BUILD_THRESHOLD)
    if lib is None or not tokens:
        from ..utils.hashing import murmur3_32

        _count("murmur3_batch.python")
        return np.array([murmur3_32(t, seed) for t in tokens], np.uint32)
    _count("murmur3_batch.native")
    buf, offsets = _pack(tokens)
    out = np.empty(len(tokens), np.uint32)
    lib.murmur3_batch(buf, _i64p(offsets), len(tokens), seed,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def hash_count_block(docs: Sequence[Optional[Sequence[str]]], width: int,
                     binary: bool = False, seed: int = 42) -> np.ndarray:
    """(n_docs, width) float32 hashed token counts — the HashingTF fill."""
    n_rows = len(docs)
    out = np.zeros((n_rows, width), np.float32)
    tokens: List[str] = []
    row_ids: List[int] = []
    for i, toks in enumerate(docs):
        for t in toks or ():
            tokens.append(t)
            row_ids.append(i)
    if not tokens:
        return out
    lib = _lib(force=len(tokens) >= _BUILD_THRESHOLD)
    if lib is None:
        from ..utils.hashing import hash_to_bucket

        _count("hash_count_block.python")
        for t, i in zip(tokens, row_ids):
            j = hash_to_bucket(t, width, seed)
            if binary:
                out[i, j] = 1.0
            else:
                out[i, j] += 1.0
        return out
    _count("hash_count_block.native")
    buf, offsets = _pack(tokens)
    rows = np.asarray(row_ids, np.int32)
    lib.hash_count_block(
        buf, _i64p(offsets), rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(tokens), width, seed, 1 if binary else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def tokenize_hash_count(texts: Sequence[Optional[str]], width: int,
                        lowercase: bool = True, min_token_length: int = 1,
                        binary: bool = False, seed: int = 42
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Text -> hashed-count block in one pass: tokenize + murmur3 + bucket
    count with no token strings built on the native path.

    Returns ((n, width) float32 block, (n,) int64 token counts).  Rows the
    native tokenizer cannot take exactly (a byte >= 0x80, a token over 4 KB)
    come back flagged and are redone by the exact Unicode tokenizer, so the
    result equals ``tokenize`` + :func:`hash_count_block` on every row.
    """
    from ..utils.text import tokenize

    n = len(texts)
    vals = ["" if t is None else str(t) for t in texts]

    def python_row(v):
        return tokenize(v, to_lowercase=lowercase, min_token_length=min_token_length)

    lib = _lib(force=n >= _BUILD_THRESHOLD)
    if lib is None:
        _count("tokenize_hash_count.python")
        docs = [python_row(v) for v in vals]
        counts = np.array([len(d) for d in docs], np.int64)
        return hash_count_block(docs, width, binary=binary, seed=seed), counts
    _count("tokenize_hash_count.native")
    buf, offsets = _pack(vals)
    out = np.zeros((n, width), np.float32)
    counts = np.zeros(n, np.int64)
    lib.tokenize_hash_count(
        buf, _i64p(offsets), n, width, seed, 1 if lowercase else 0,
        int(min_token_length), 1 if binary else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _i64p(counts))
    redo = np.nonzero(counts < 0)[0]
    if redo.size:
        _count("tokenize_hash_count.unicode_rows", int(redo.size))
    for i in redo:
        out[i] = 0.0
        toks = python_row(vals[i])
        counts[i] = len(toks)
        if toks:
            out[i:i + 1] = hash_count_block([toks], width, binary=binary, seed=seed)
    return out, counts
