"""Kernel K3: bloom hash, word mask and bitmap build —
counterpart of ``rocksplicator_tpu/ops/pallas_kernels.py``
(``bloom_hash_pallas``).

``launch_bloom_build`` runs ``csrc/bloom_build.cu`` on CUDA tensors and
raises for tensors on any other device; ``ops/bloom.bloom_build`` is the
entry point that sends CPU tensors to the plain version,
``bloom_build_plain``. ``launch_bloom_build_batched`` builds S shards'
bitmaps in one launch, a row live when it lies below its shard's count,
which the kernel reads on the device (``ops/bloom.bloom_build_batched`` is
its entry point).

``plan_bloom`` plans one of two routes by shape (see the source's
header): S bitmaps take a cooperative grid that zeroes them, syncs and ORs
every live row into device memory, the shards' live rows as one range
(``global``, one CUDA launch); one bitmap takes a memset and one thread per
row (``rowwise``, two). Both write the bitmaps whole, with no fill
beforehand.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .kv_format import KEY_WORDS

_P = ctypes.c_void_p
_I = ctypes.c_int
_LAUNCHES = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "rs_bloom_build": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _LAUNCHES, _P),
    "rs_bloom_build_batched": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                               _LAUNCHES, _P)}

# Streaming multiprocessors of an H100 SXM: the cooperative grid is sized
# by them.
NUM_SMS = 132
# The plan's grids. chip_smoke.py's k3_sweep phase times them against the
# other routes, thread counts and grid sizes at the shapes K3 meets
# (PERF.md, "K3 route sweep").
GLOBAL_THREADS = 512
GLOBAL_BLOCKS_PER_SM = 2
ROWWISE_THREADS = 256
# Calls over at most this many bitmaps take the rowwise route: with no
# padded shards to skip, its memset costs less than the global grid's sync.
ROWWISE_MAX_SHARDS = 1
# the global route keeps the shards' prefix sums in 48 KB of shared memory
MAX_GLOBAL_SHARDS = 48 * 1024 // 8 - 1
_ROUTE_CODE = {"global": 0, "rowwise": 1}  # the C entries' route argument


@dataclass(frozen=True)
class BloomPlan:
    """How one K3 call runs: ``route``, the grid's ``blocks`` and
    ``threads``, and its CUDA ``launches``."""

    route: str
    blocks: int
    threads: int
    launches: int


def plan_bloom(shards: int, rows: int, num_words: int) -> BloomPlan:
    """The plan of one K3 call over ``shards`` bitmaps of ``num_words``,
    each from up to ``rows`` rows: ``rowwise`` (a memset and one thread a
    row) for up to ROWWISE_MAX_SHARDS bitmaps, else ``global`` (one
    cooperative grid of up to GLOBAL_BLOCKS_PER_SM blocks an SM). Raises
    ValueError for an empty shape, and for more than MAX_GLOBAL_SHARDS
    shards."""
    if shards < 1 or rows < 1 or num_words < 1:
        raise ValueError(f"K3 shape refused: {shards} x {rows} rows, "
                         f"{num_words} words")
    if shards <= ROWWISE_MAX_SHARDS:
        return BloomPlan("rowwise", -(-(shards * rows) // ROWWISE_THREADS),
                         ROWWISE_THREADS, 2)
    if shards > MAX_GLOBAL_SHARDS:
        raise ValueError(f"the global route takes at most "
                         f"{MAX_GLOBAL_SHARDS} shards, got {shards}")
    blocks = min(-(-(shards * rows) // GLOBAL_THREADS),
                 NUM_SMS * GLOBAL_BLOCKS_PER_SM)
    return BloomPlan("global", blocks, GLOBAL_THREADS, 1)


def _launch(fn: str, args: tuple, plan: BloomPlan, bitmap: torch.Tensor,
            dev: torch.device) -> None:
    lib = _build.load("bloom_build", _SIGNATURES)
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(
            *args, _ROUTE_CODE[plan.route], plan.blocks, plan.threads,
            bitmap.data_ptr(), ctypes.byref(launches),
            _build.stream_ptr(dev))
    _build.check(lib, rc, fn)
    _build.count_launch("bloom_build", launches.value)


def launch_bloom_build(key_words_le: torch.Tensor, key_len: torch.Tensor,
                       valid: torch.Tensor, *, num_words: int
                       ) -> torch.Tensor:
    """The (num_words,) bitmap (int32 lane) built by K3 on the card."""
    n = key_len.shape[0]
    dev = key_len.device
    if (key_words_le.dtype != torch.int32
            or tuple(key_words_le.shape) != (n, KEY_WORDS)
            or key_len.dtype != torch.int32 or key_len.dim() != 1
            or valid.dtype != torch.bool or tuple(valid.shape) != (n,)):
        raise TypeError("K3 takes (N, 6) int32 LE key words, (N,) int32 "
                        "lengths and an (N,) bool mask")
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {dev}")
    if key_words_le.device != dev or valid.device != dev:
        raise ValueError("K3 inputs on different devices")
    plan = plan_bloom(1, max(1, n), num_words)
    bitmap = torch.empty(num_words, dtype=torch.int32, device=dev)
    if n == 0:
        return bitmap.zero_()
    kw = key_words_le.contiguous()
    kl = key_len.contiguous()
    vd = valid.contiguous()
    _launch("rs_bloom_build", (kw.data_ptr(), kl.data_ptr(), vd.data_ptr(),
                               n, num_words), plan, bitmap, dev)
    return bitmap


def launch_bloom_build_batched(key_words_le: torch.Tensor,
                               key_len: torch.Tensor, count: torch.Tensor, *,
                               num_words: int) -> torch.Tensor:
    """The (S, num_words) bitmaps (int32 lanes) of S shards, built by K3 on
    the card in one launch: key_words_le (S, C, 6) and key_len (S, C)
    int32, count (S,) int32; row r of shard s is live when r < count[s]."""
    dev = key_len.device
    if key_len.dim() != 2:
        raise TypeError("batched K3 takes (S, C) key lengths")
    shards, seg = key_len.shape
    if (key_words_le.dtype != torch.int32
            or tuple(key_words_le.shape) != (shards, seg, KEY_WORDS)
            or key_len.dtype != torch.int32
            or count.dtype != torch.int32 or tuple(count.shape) != (shards,)):
        raise TypeError("batched K3 takes (S, C, 6) int32 LE key words, "
                        "(S, C) int32 lengths and (S,) int32 counts")
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {dev}")
    if key_words_le.device != dev or count.device != dev:
        raise ValueError("K3 inputs on different devices")
    bitmap = torch.empty((shards, num_words), dtype=torch.int32, device=dev)
    if shards == 0 or seg == 0:
        plan_bloom(1, 1, num_words)  # refuses num_words < 1
        return bitmap.zero_()
    plan = plan_bloom(shards, seg, num_words)
    kw = key_words_le.contiguous()
    kl = key_len.contiguous()
    cnt = count.contiguous()
    _launch("rs_bloom_build_batched", (kw.data_ptr(), kl.data_ptr(),
                                       cnt.data_ptr(), shards, seg,
                                       num_words), plan, bitmap, dev)
    return bitmap
