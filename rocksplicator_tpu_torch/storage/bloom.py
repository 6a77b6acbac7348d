"""Bloom filter — counterpart of ``rocksplicator_tpu/storage/bloom.py``.

The hash is an FNV-1a fold over a 24-byte zero-padded key prefix (six
little-endian u32 words) and the key length, then murmur3 fmix32; each key
sets ``K_BITS`` bits of one 32-bit word chosen by the first hash.
``BloomFilter`` writes and reads the bitmap in the SST format, so a bitmap
that kernel K3 built (ops/bloom.py) is written as the reference writes
its own; ``BloomFilter.build`` is the host build from key bytes, through
the native library where it is loaded (the same bits), as in the
reference. Probes: ``may_contain`` per key, ``may_contain_many`` and
``may_contain_hashed`` over a key batch hashed once by ``hash_many``.
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
_MASK32 = 0xFFFFFFFF


def key_words(key: bytes) -> List[int]:
    """The 7 u32 lanes hashed for ``key`` (6 prefix words + length)."""
    prefix = key[:PREFIX_BYTES].ljust(PREFIX_BYTES, b"\x00")
    words = list(struct.unpack(f"<{_PREFIX_WORDS}I", prefix))
    words.append(len(key) & _MASK32)
    return words


def _avalanche(h: int) -> int:
    """murmur3 fmix32 on a Python int."""
    h &= _MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK32
    h ^= h >> 16
    return h


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


def hash_pair(key: bytes) -> tuple:
    h = _FNV_OFFSET
    for w in key_words(key):
        h = ((h ^ w) * _FNV_PRIME) & _MASK32
    h1 = _avalanche(h)
    h2 = _avalanche((h * _H2_MUL + 1) & _MASK32)
    return h1, h2


def word_mask(key: bytes, num_words: int) -> tuple:
    """(word_index, 32-bit mask) for ``key``: each of the K bits comes
    from an independent 5-bit slice of h2."""
    h1, h2 = hash_pair(key)
    mask = 0
    for j in range(K_BITS):
        mask |= 1 << ((h2 >> (5 * j)) & 31)
    return h1 % num_words, mask


def _native():
    """The native hash/build path (the same bits)."""
    from .native.binding import NATIVE

    return NATIVE


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
        native = _native()
        if native is not None and keys:
            native.bloom_add_many(bf.words, keys)
            return bf
        h1, mask = hash_many(keys)
        np.bitwise_or.at(bf.words, h1 % np.uint32(bf.num_words), mask)
        return bf

    @classmethod
    def build_from_arrays(cls, key_bytes_matrix, key_lens,
                          bits_per_key: int = 10) -> "BloomFilter":
        """Bulk build from an (n, width) u8 key matrix and per-row lengths
        (clipped to the width): the key of row i is its first len bytes.
        No per-key Python objects; the same bits as ``build``."""
        n = int(len(key_lens))
        bf = cls(num_words_for(n, bits_per_key))
        if n == 0:
            return bf
        mat = np.ascontiguousarray(key_bytes_matrix,
                                   dtype=np.uint8).reshape(n, -1)
        lens64 = np.minimum(np.asarray(key_lens, dtype=np.uint64),
                            np.uint64(mat.shape[1]))
        native = _native()
        if native is not None:
            keep = (np.arange(mat.shape[1], dtype=np.uint64)[None, :]
                    < lens64[:, None])
            offsets = np.zeros(n + 1, dtype=np.uint64)
            np.cumsum(lens64, out=offsets[1:])
            # row-major: the keys stay in order in the buffer
            native.bloom_add_concat(bf.words, mat[keep], offsets, n)
            return bf
        lens = lens64.astype(np.uint32)
        width = min(mat.shape[1], PREFIX_BYTES)
        prefix = np.zeros((n, PREFIX_BYTES), dtype=np.uint8)
        prefix[:, :width] = np.where(
            np.arange(width, dtype=np.uint32)[None, :] < lens[:, None],
            mat[:, :width], 0)
        h1, mask = hash_words(prefix.view("<u4"), lens)
        np.bitwise_or.at(bf.words, h1 % np.uint32(bf.num_words), mask)
        return bf

    def add(self, key: bytes) -> None:
        idx, mask = word_mask(key, self.num_words)
        self.words[idx] |= np.uint32(mask)

    def may_contain(self, key: bytes) -> bool:
        # pure Python: per-probe ctypes marshalling costs more than the
        # hash itself
        idx, mask = word_mask(key, self.num_words)
        return (int(self.words[idx]) & mask) == mask

    def may_contain_many(self, keys: List[bytes]) -> np.ndarray:
        """(n,) bool — the batch probe, bit-exact with ``may_contain``."""
        h1, mask = hash_many(keys)
        return self.may_contain_hashed(h1, mask)

    def may_contain_hashed(self, h1: np.ndarray,
                           mask: np.ndarray) -> np.ndarray:
        """Probe with hashes from :func:`hash_many`: a multi-SST read
        hashes its key set once and pays a modulo and a gather a filter."""
        with np.errstate(over="ignore"):
            idx = h1 % np.uint32(self.num_words)
        return (self.words[idx] & mask) == mask

    def to_bytes(self) -> bytes:
        return struct.pack("<I", self.num_words) + self.words.astype(
            "<u4").tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "BloomFilter":
        (num_words,) = struct.unpack_from("<I", data, 0)
        words = np.frombuffer(data, dtype="<u4", count=num_words,
                              offset=4).copy()
        return cls(num_words, words)
