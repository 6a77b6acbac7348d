"""Bloom-filter construction — counterpart of
``rocksplicator_tpu/ops/bloom_tpu.py``; byte-identical to
``storage/bloom.BloomFilter`` of the JAX package.

``bloom_build`` is the entry point: on CPU tensors it runs
``bloom_build_plain``; on CUDA tensors it launches kernel K3
(ops/bloom_kernel.py), which fuses the hash, the word mask and the bitmap
build. The plain version hashes with widened int64 lanes (each u32 product
taken mod 2^32 without overflowing int64, ops/lanes.mul32) and ORs the
masks through a bit plane, since torch has no scatter-OR.

``bloom_build_batched`` is the shard axis (the counterpart of the bloom
build under ``jax.vmap``): S shards' bitmaps, each shard's rows valid
below its count. CUDA tensors take one K3 launch for all of them; CPU
tensors loop ``bloom_build_plain`` over the shards.
"""

from __future__ import annotations

import torch

from ..storage.bloom import K_BITS, _FNV_OFFSET, _FNV_PRIME, _H2_MUL
from .kv_format import KEY_WORDS
from .lanes import MASK32, mul32, narrow, widen


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 lanes holding u32 values."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hash_pair64(key_words_le, key_len):
    h = torch.full(key_len.shape, _FNV_OFFSET, dtype=torch.int64,
                   device=key_len.device)
    for w in range(KEY_WORDS):
        h = mul32(h ^ widen(key_words_le[:, w]), _FNV_PRIME)
    h = mul32(h ^ widen(key_len), _FNV_PRIME)
    h1 = _avalanche(h)
    h2 = _avalanche((mul32(h, _H2_MUL) + 1) & MASK32)
    return h1, h2


def bloom_hash_pair(key_words_le: torch.Tensor, key_len: torch.Tensor):
    """(h1, h2) per row as int32 lanes — the vectorized hash_pair."""
    h1, h2 = _hash_pair64(key_words_le, key_len)
    return narrow(h1), narrow(h2)


def _word_mask64(key_words_le, key_len, num_words: int):
    h1, h2 = _hash_pair64(key_words_le, key_len)
    bits = torch.stack([(h2 >> (5 * j)) & 31 for j in range(K_BITS)], dim=1)
    return h1 % num_words, bits


def bloom_word_mask(key_words_le: torch.Tensor, key_len: torch.Tensor,
                    num_words: int):
    """(word_idx int64, 32-bit mask as an int32 lane) per row."""
    word_idx, bits = _word_mask64(key_words_le, key_len, num_words)
    mask = torch.zeros_like(word_idx)
    one = torch.ones_like(word_idx)
    for j in range(K_BITS):
        mask = mask | (one << bits[:, j])
    return word_idx, narrow(mask)


def bloom_build_plain(key_words_le: torch.Tensor, key_len: torch.Tensor,
                      valid: torch.Tensor, *, num_words: int
                      ) -> torch.Tensor:
    """The plain PyTorch version of K3, on any device: the (num_words,)
    bitmap as an int32 lane. Invalid rows set no bits."""
    word_idx, bits = _word_mask64(key_words_le, key_len, num_words)
    plane = torch.zeros(num_words * 32, dtype=torch.bool,
                        device=key_len.device)
    plane[(word_idx[:, None] * 32 + bits)[valid].reshape(-1)] = True
    weights = torch.ones(32, dtype=torch.int64, device=key_len.device) << \
        torch.arange(32, device=key_len.device)
    return narrow((plane.view(num_words, 32).long() * weights).sum(1))


def bloom_build(key_words_le: torch.Tensor, key_len: torch.Tensor,
                valid: torch.Tensor, *, num_words: int) -> torch.Tensor:
    """The (num_words,) bloom bitmap (int32 lane) of the valid rows.
    CPU tensors: the plain version; CUDA tensors: kernel K3."""
    dev = key_len.device
    if dev.type == "cpu":
        return bloom_build_plain(key_words_le, key_len, valid,
                                 num_words=num_words)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .bloom_kernel import launch_bloom_build

    return launch_bloom_build(key_words_le, key_len, valid,
                              num_words=num_words)


def bloom_build_batched(key_words_le: torch.Tensor, key_len: torch.Tensor,
                        count: torch.Tensor, *, num_words: int
                        ) -> torch.Tensor:
    """The (S, num_words) bloom bitmaps (int32 lanes) of S shards:
    key_words_le (S, C, 6), key_len (S, C), count (S,) int32, row r of
    shard s valid when r < count[s]. CPU tensors: ``bloom_build_plain``
    per shard; CUDA tensors: one K3 launch, the counts read on the device."""
    dev = key_len.device
    if dev.type == "cpu":
        rows = torch.arange(key_len.shape[1], device=dev)
        return torch.stack([
            bloom_build_plain(key_words_le[s], key_len[s], rows < count[s],
                              num_words=num_words)
            for s in range(key_len.shape[0])]) if key_len.shape[0] else (
            torch.zeros((0, num_words), dtype=torch.int32, device=dev))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .bloom_kernel import launch_bloom_build_batched

    return launch_bloom_build_batched(key_words_le, key_len, count,
                                      num_words=num_words)
