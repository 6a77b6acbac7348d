"""Kernel K2: the whole merge-resolve on the card as one op — counterpart
of ``rocksplicator_tpu/ops/pallas_resolve.py``.

``fused_merge_resolve`` launches ``csrc/fused_resolve.cu``: one memset of
its status words, the composite key lanes built on the device, the K1
merge sort over those keys and a row index (the payload gathered once by
its last launch), and one resolve-and-compact pass whose two scans (the
segmented LSM totals, the keep ranks) are single-pass scans with
decoupled look-back. That pass writes every output row, the zero rows
at and past ``count`` included, so the outputs are allocated empty. It
returns the same dict as ``merge_resolve_kernel``. Its plain PyTorch
version is ``compaction_kernel.merge_resolve_plain``;
``merge_resolve_kernel`` is the entry point that sends CPU tensors there.

It takes CUDA tensors with N a power of two >= 256, at most 16 key lanes
(1 + key_words + [klen] + [seq_hi] + 1: always true) and values of any
width W >= 1 (the sort gathers 2 + W payload lanes, 16 at a time), and
raises for anything else. With ``segment`` the N rows are N / segment
shards of ``segment`` rows, each merged and resolved on its own in the
same launches (the counterpart of ``jax.vmap(merge_resolve_kernel)``);
``count`` and ``needs_cpu_fallback`` are then (S,). ``plan_fused``
computes the launch plan, the scratch size and the launch count; the C
entry point checks the plan and counts its launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from . import _build
from .bitonic_sort import SortPlan, plan_sort
from .compaction_kernel import MergeKind
from .kv_format import KEY_WORDS

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rs_fused_merge_resolve": (_P,) * 8 + (_I,) * 12 + (ctypes.c_int64,)
    + (_P,) * 9 + (ctypes.POINTER(_I), _P),
}
RESOLVE_ROWS = 2048    # rows of a resolve_compact block (256 threads x 8)
SEG_WORDS = 9          # look-back state of the segmented scan
STATUS_HEAD = 4        # the tile counter, then padding
META_WORDS = 4         # per shard: count, overflow flag, klen, unused


@dataclass(frozen=True)
class FusedPlan:
    """Launch plan of K2: the sort's plan, the resolve pass's tiles, the
    scratch words of the C entry point's layout and its CUDA launches
    (memset, build, sort, resolve)."""
    sort: SortPlan
    lanes: int
    shards: int
    resolve_rows: int   # rows of one resolve tile: min(segment, 2048)
    resolve_tiles: int
    status_words: int
    scratch_words: int
    launches: int


def sort_lane_count(n_val_words: int, key_words: int, uniform_klen: bool,
                    seq32: bool) -> int:
    return (1 + key_words + (not uniform_klen) + (not seq32) + 1 + 2
            + n_val_words)


def _pow2(x: int) -> bool:
    return x >= 256 and not (x & (x - 1))


def fused_supported(n: int, n_val_words: int = 2,
                    segment: Optional[int] = None) -> bool:
    """True when K2 takes the shape: power-of-two N >= 256, W >= 1, and
    a power-of-two segment >= 256 of at most N rows."""
    segment = n if segment is None else segment
    return (_pow2(n) and _pow2(segment) and segment <= n
            and n_val_words >= 1)


def _round4(words: int) -> int:
    return -(-words // 4) * 4


def plan_fused(n: int, n_val_words: int, key_words: int = KEY_WORDS,
               uniform_klen: bool = False, seq32: bool = False,
               segment: Optional[int] = None) -> FusedPlan:
    """K2's plan for N rows in shards of ``segment`` rows (default: one
    shard); raises ``ValueError`` for a shape it cannot take."""
    segment = n if segment is None else segment
    lanes = sort_lane_count(n_val_words, key_words, uniform_klen, seq32)
    if not fused_supported(n, n_val_words, segment):
        raise ValueError(
            f"fused merge-resolve needs power-of-two N and segment >= 256 "
            f"(segment <= N) and W >= 1, got N={n}, segment={segment}, "
            f"W={n_val_words}")
    num_keys = lanes - 2 - n_val_words
    sort = plan_sort(n, num_keys, lanes - num_keys, segment)
    shards = n // segment
    rows = min(segment, RESOLVE_ROWS)
    tiles = n // rows
    status = _round4(STATUS_HEAD + META_WORDS * shards + 2 * tiles)
    looks = _round4(2 * tiles * (SEG_WORDS + 1))
    scratch = (status + looks + lanes * n + 2 * (num_keys + 1) * n
               + (n if sort.gathers else 0))
    return FusedPlan(sort=sort, lanes=lanes, shards=shards,
                     resolve_rows=rows, resolve_tiles=tiles,
                     status_words=status, scratch_words=scratch,
                     launches=3 + sort.launches)


def fused_merge_resolve(key_words_be, key_len, seq_hi, seq_lo, vtype,
                        val_words, val_len, valid, *,
                        merge_kind: MergeKind = MergeKind.UINT64_ADD,
                        drop_tombstones: bool = True,
                        uniform_klen: bool = False, seq32: bool = False,
                        key_words: int = KEY_WORDS,
                        segment: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """Merge-resolve in kernel K2 on CUDA tensors; raises for any other
    device. Same output dict as ``merge_resolve_kernel``, which checks the
    lanes and sends CPU tensors to the plain version. With ``segment`` the
    rows are shards of ``segment`` rows, each resolved on its own (shard s
    at rows [s * segment, + count[s])), and ``count`` and
    ``needs_cpu_fallback`` are (S,) tensors."""
    dev = seq_lo.device
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors, got {dev}")
    n, w = val_words.shape
    plan = plan_fused(n, w, key_words, uniform_klen, seq32, segment)
    sp = plan.sort
    lib = _build.load("fused_resolve", _SIGNATURES)
    ins = [x.contiguous() for x in (key_words_be, key_len, seq_hi, seq_lo,
                                    vtype, val_words, val_len, valid)]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    out = {"key_words_be": empty(n, KEY_WORDS),
           "key_words_le": empty(n, KEY_WORDS), "key_len": empty(n),
           "seq_hi": empty(n), "seq_lo": empty(n), "vtype": empty(n),
           "val_words": empty(n, w), "val_len": empty(n)}
    scratch = empty(plan.scratch_words)
    launches = _I(0)
    with torch.cuda.device(dev):
        rc = lib.rs_fused_merge_resolve(
            *[x.data_ptr() for x in ins], n, w, key_words,
            int(uniform_klen), int(seq32),
            int(merge_kind is MergeKind.UINT64_ADD), int(drop_tombstones),
            sp.segment, sp.tile, sp.chunk, sp.passes, sp.smem_bytes,
            plan.scratch_words,
            *[t.data_ptr() for t in out.values()], scratch.data_ptr(),
            ctypes.byref(launches), _build.stream_ptr(dev))
    _build.check(lib, rc, f"fused_merge_resolve {plan}")
    _build.count_launch("fused_resolve", launches.value)
    meta = scratch[STATUS_HEAD:STATUS_HEAD + META_WORDS * plan.shards].view(
        plan.shards, META_WORDS)
    if segment is None:
        meta = meta[0]
    out["count"] = meta[..., 0].clone()
    out["needs_cpu_fallback"] = meta[..., 1] != 0
    return out
