"""Bloom filter — counterpart of ``rocksplicator_tpu/storage/bloom.py``.

The hash is an FNV-1a fold over a 24-byte zero-padded key prefix (six
little-endian u32 words) and the key length, then murmur3 fmix32; each key
sets ``K_BITS`` bits of one 32-bit word chosen by the first hash.
``BloomFilter`` writes and reads the bitmap in the SST format, so a bitmap
that kernel K3 built (ops/bloom.py) is written as the reference writes
its own; ``BloomFilter.build`` is the host build from key bytes.
"""

from __future__ import annotations

import struct
from typing import Iterable, List, Tuple

import numpy as np

PREFIX_BYTES = 24
_PREFIX_WORDS = PREFIX_BYTES // 4
K_BITS = 6
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_H2_MUL = 0x9E3779B1


def num_words_for(num_keys: int, bits_per_key: int = 10) -> int:
    return max(1, (num_keys * bits_per_key + 31) // 32)


def _avalanche_np(h: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 over a u32 lane (wrapping multiplies)."""
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def hash_words(words_le: np.ndarray,
               lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(h1, mask) u32 lanes for keys given as (n, 6) little-endian u32
    words of their zero-padded 24-byte prefix and their lengths."""
    words_le = np.asarray(words_le, dtype=np.uint32)
    lens = np.asarray(lens, dtype=np.uint32)
    n = lens.shape[0]
    with np.errstate(over="ignore"):
        h = np.full(n, _FNV_OFFSET, dtype=np.uint32)
        for w in range(_PREFIX_WORDS):
            h = (h ^ words_le[:, w]) * np.uint32(_FNV_PRIME)
        h = (h ^ lens) * np.uint32(_FNV_PRIME)
        h1 = _avalanche_np(h)
        h2 = _avalanche_np(h * np.uint32(_H2_MUL) + np.uint32(1))
        mask = np.zeros(n, dtype=np.uint32)
        for j in range(K_BITS):
            mask |= np.uint32(1) << ((h2 >> np.uint32(5 * j))
                                     & np.uint32(31))
    return h1, mask


def hash_many(keys: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """(h1, mask) u32 lanes for ``keys``: the word is ``h1 % num_words``
    of a filter, ``mask`` the K_BITS bits the key sets in it."""
    n = len(keys)
    if n == 0:
        z = np.zeros(0, dtype=np.uint32)
        return z, z
    mat = np.frombuffer(
        b"".join(k[:PREFIX_BYTES].ljust(PREFIX_BYTES, b"\x00")
                 for k in keys),
        dtype=np.uint8).reshape(n, PREFIX_BYTES)
    lens = np.fromiter((len(k) for k in keys), dtype=np.uint32, count=n)
    return hash_words(mat.view("<u4"), lens)


class BloomFilter:
    def __init__(self, num_words: int, words: np.ndarray | None = None):
        self.num_words = num_words
        self.words = (words if words is not None
                      else np.zeros(num_words, dtype=np.uint32))

    @classmethod
    def build(cls, keys: Iterable[bytes],
              bits_per_key: int = 10) -> "BloomFilter":
        keys = list(keys)
        bf = cls(num_words_for(len(keys), bits_per_key))
        h1, mask = hash_many(keys)
        np.bitwise_or.at(bf.words, h1 % np.uint32(bf.num_words), mask)
        return bf

    def to_bytes(self) -> bytes:
        return struct.pack("<I", self.num_words) + self.words.astype(
            "<u4").tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "BloomFilter":
        (num_words,) = struct.unpack_from("<I", data, 0)
        words = np.frombuffer(data, dtype="<u4", count=num_words,
                              offset=4).copy()
        return cls(num_words, words)
