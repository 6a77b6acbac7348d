"""Bloom-filter hash constants — counterpart of
``rocksplicator_tpu/storage/bloom.py``.

The hash is an FNV-1a fold over a 24-byte zero-padded key prefix (six
little-endian u32 words) and the key length, then murmur3 fmix32; each key
sets ``K_BITS`` bits of one 32-bit word chosen by the first hash.
"""

from __future__ import annotations

PREFIX_BYTES = 24
K_BITS = 6
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_H2_MUL = 0x9E3779B1


def num_words_for(num_keys: int, bits_per_key: int = 10) -> int:
    return max(1, (num_keys * bits_per_key + 31) // 32)
