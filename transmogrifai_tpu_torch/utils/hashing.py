"""MurmurHash3 (x86 32-bit) — the hashing-trick hash (counterpart of
``transmogrifai_tpu/utils/hashing.py``).

The reference Transmogrifier's hashing trick uses MurMur3, as Spark's
HashingTF does.  A pure-Python scalar implementation with a process-wide memo
table: token vocabularies are small beside row counts, so lookups amortize to
dict hits.  ``native/fasthost.cpp`` computes the same bits in C++.
"""

from __future__ import annotations

from typing import Dict

_MEMO: Dict[str, int] = {}
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MASK = 0xFFFFFFFF


def murmur3_32(key: str, seed: int = 42) -> int:
    """32-bit MurmurHash3 of a UTF-8 string."""
    memo_key = key if seed == 42 else f"{seed}\x00{key}"
    h = _MEMO.get(memo_key)
    if h is not None:
        return h
    data = key.encode("utf-8")
    n = len(data)
    h1 = seed & _MASK
    rounded = n - (n % 4)
    for i in range(0, rounded, 4):
        k1 = int.from_bytes(data[i:i + 4], "little")
        k1 = (k1 * _C1) & _MASK
        k1 = ((k1 << 15) | (k1 >> 17)) & _MASK
        k1 = (k1 * _C2) & _MASK
        h1 ^= k1
        h1 = ((h1 << 13) | (h1 >> 19)) & _MASK
        h1 = (h1 * 5 + 0xE6546B64) & _MASK
    k1 = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k1 ^= tail[2] << 16
    if len(tail) >= 2:
        k1 ^= tail[1] << 8
    if len(tail) >= 1:
        k1 ^= tail[0]
        k1 = (k1 * _C1) & _MASK
        k1 = ((k1 << 15) | (k1 >> 17)) & _MASK
        k1 = (k1 * _C2) & _MASK
        h1 ^= k1
    h1 ^= n
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _MASK
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _MASK
    h1 ^= h1 >> 16
    if len(_MEMO) < 1_000_000:
        _MEMO[memo_key] = h1
    return h1


def hash_to_bucket(token: str, num_buckets: int, seed: int = 42) -> int:
    return murmur3_32(token, seed) % num_buckets
