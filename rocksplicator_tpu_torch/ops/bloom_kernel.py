"""Kernel K3: bloom hash, word mask and bitmap build in one launch —
counterpart of ``rocksplicator_tpu/ops/pallas_kernels.py``
(``bloom_hash_pallas``).

``launch_bloom_build`` runs ``csrc/bloom_build.cu`` on CUDA tensors: one
thread per row, ``atomicOr`` of its mask into a zeroed bitmap. It raises
for tensors on any other device; ``ops/bloom.bloom_build`` is the entry
point that sends CPU tensors to the plain version, ``bloom_build_plain``.
``launch_bloom_build_batched`` builds S shards' bitmaps in one launch, a
row valid when it lies below its shard's count, which the kernel reads on
the device (``ops/bloom.bloom_build_batched`` is its entry point).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .kv_format import KEY_WORDS

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"rs_bloom_build": (_P, _P, _P, _I, _I, _P, _P),
               "rs_bloom_build_batched": (_P, _P, _P, _I, _I, _I, _P, _P)}


def launch_bloom_build(key_words_le: torch.Tensor, key_len: torch.Tensor,
                       valid: torch.Tensor, *, num_words: int
                       ) -> torch.Tensor:
    """The (num_words,) bitmap (int32 lane) built by K3 on the card."""
    n = key_len.shape[0]
    dev = key_len.device
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {dev}")
    if (key_words_le.dtype != torch.int32
            or tuple(key_words_le.shape) != (n, KEY_WORDS)
            or key_len.dtype != torch.int32 or key_len.dim() != 1
            or valid.dtype != torch.bool or tuple(valid.shape) != (n,)):
        raise TypeError("K3 takes (N, 6) int32 LE key words, (N,) int32 "
                        "lengths and an (N,) bool mask")
    if key_words_le.device != dev or valid.device != dev:
        raise ValueError("K3 inputs on different devices")
    if num_words < 1:
        raise ValueError(f"num_words must be >= 1, got {num_words}")
    kw = key_words_le.contiguous()
    kl = key_len.contiguous()
    vd = valid.contiguous()
    bitmap = torch.zeros(num_words, dtype=torch.int32, device=dev)
    lib = _build.load("bloom_build", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.rs_bloom_build(kw.data_ptr(), kl.data_ptr(), vd.data_ptr(),
                                n, num_words, bitmap.data_ptr(),
                                _build.stream_ptr(dev))
    _build.check(lib, rc, "bloom_build")
    _build.count_launch("bloom_build")
    return bitmap


def launch_bloom_build_batched(key_words_le: torch.Tensor,
                               key_len: torch.Tensor, count: torch.Tensor, *,
                               num_words: int) -> torch.Tensor:
    """The (S, num_words) bitmaps (int32 lanes) of S shards, built by K3 on
    the card in one launch: key_words_le (S, C, 6) and key_len (S, C)
    int32, count (S,) int32; row r of shard s is valid when r < count[s]."""
    dev = key_len.device
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {dev}")
    if key_len.dim() != 2:
        raise TypeError("batched K3 takes (S, C) key lengths")
    shards, seg = key_len.shape
    if (key_words_le.dtype != torch.int32
            or tuple(key_words_le.shape) != (shards, seg, KEY_WORDS)
            or key_len.dtype != torch.int32
            or count.dtype != torch.int32 or tuple(count.shape) != (shards,)):
        raise TypeError("batched K3 takes (S, C, 6) int32 LE key words, "
                        "(S, C) int32 lengths and (S,) int32 counts")
    if key_words_le.device != dev or count.device != dev:
        raise ValueError("K3 inputs on different devices")
    if num_words < 1:
        raise ValueError(f"num_words must be >= 1, got {num_words}")
    kw = key_words_le.contiguous()
    kl = key_len.contiguous()
    cnt = count.contiguous()
    bitmap = torch.zeros((shards, num_words), dtype=torch.int32, device=dev)
    lib = _build.load("bloom_build", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.rs_bloom_build_batched(
            kw.data_ptr(), kl.data_ptr(), cnt.data_ptr(), shards, seg,
            num_words, bitmap.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, rc, "bloom_build_batched")
    _build.count_launch("bloom_build")
    return bitmap
