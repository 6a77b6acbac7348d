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

It takes CUDA tensors with N a power of two >= 256 and at most 16 lanes
through the sort (1 + key_words + [klen] + [seq_hi] + 1 + 2 + W) and raises
for anything else. ``plan_fused`` computes the launch plan, the scratch
size and the launch count; the C entry point checks the plan and counts
its launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict

import torch

from . import _build
from .bitonic_sort import SortPlan, plan_sort
from .compaction_kernel import MergeKind
from .kv_format import KEY_WORDS

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rs_fused_merge_resolve": (_P,) * 8 + (_I,) * 11 + (ctypes.c_int64,)
    + (_P,) * 9 + (ctypes.POINTER(_I), _P),
}
MAX_LANES = 16
RESOLVE_ROWS = 2048    # rows of one resolve_compact block (256 threads x 8)
SEG_WORDS = 9          # look-back state of the segmented scan


@dataclass(frozen=True)
class FusedPlan:
    """Launch plan of K2: the sort's plan, the resolve pass's tiles, the
    scratch words of the C entry point's layout and its CUDA launches
    (memset, build, sort, resolve)."""
    sort: SortPlan
    lanes: int
    resolve_tiles: int
    status_words: int
    scratch_words: int
    launches: int


def sort_lane_count(n_val_words: int, key_words: int, uniform_klen: bool,
                    seq32: bool) -> int:
    return (1 + key_words + (not uniform_klen) + (not seq32) + 1 + 2
            + n_val_words)


def fused_supported(n: int, n_val_words: int = 2,
                    key_words: int = KEY_WORDS, uniform_klen: bool = False,
                    seq32: bool = False) -> bool:
    """True when K2 takes the shape: power-of-two N >= 256, lanes <= 16."""
    return (n >= 256 and not (n & (n - 1)) and sort_lane_count(
        n_val_words, key_words, uniform_klen, seq32) <= MAX_LANES)


def _round4(words: int) -> int:
    return -(-words // 4) * 4


def plan_fused(n: int, n_val_words: int, key_words: int = KEY_WORDS,
               uniform_klen: bool = False, seq32: bool = False) -> FusedPlan:
    """K2's plan for N rows; raises ``ValueError`` for a shape it cannot
    take."""
    lanes = sort_lane_count(n_val_words, key_words, uniform_klen, seq32)
    if not fused_supported(n, n_val_words, key_words, uniform_klen, seq32):
        raise ValueError(
            f"fused merge-resolve needs power-of-two N >= 256 and at most "
            f"{MAX_LANES} sort lanes, got N={n}, {lanes} lanes")
    num_keys = lanes - 2 - n_val_words
    sort = plan_sort(n, num_keys, lanes - num_keys)
    tiles = -(-n // RESOLVE_ROWS)
    status = _round4(8 + 2 * tiles)
    looks = _round4(2 * tiles * (SEG_WORDS + 1))
    scratch = status + looks + lanes * n + 2 * (num_keys + 1) * n
    return FusedPlan(sort=sort, lanes=lanes, resolve_tiles=tiles,
                     status_words=status, scratch_words=scratch,
                     launches=3 + sort.launches)


def fused_merge_resolve(key_words_be, key_len, seq_hi, seq_lo, vtype,
                        val_words, val_len, valid, *,
                        merge_kind: MergeKind = MergeKind.UINT64_ADD,
                        drop_tombstones: bool = True,
                        uniform_klen: bool = False, seq32: bool = False,
                        key_words: int = KEY_WORDS
                        ) -> Dict[str, torch.Tensor]:
    """Merge-resolve in kernel K2 on CUDA tensors; raises for any other
    device. Same output dict as ``merge_resolve_kernel``, which checks the
    lanes and sends CPU tensors to the plain version."""
    dev = seq_lo.device
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors, got {dev}")
    n, w = val_words.shape
    plan = plan_fused(n, w, key_words, uniform_klen, seq32)
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
            sp.tile, sp.chunk, sp.passes, sp.smem_bytes, plan.scratch_words,
            *[t.data_ptr() for t in out.values()], scratch.data_ptr(),
            ctypes.byref(launches), _build.stream_ptr(dev))
    _build.check(lib, rc, f"fused_merge_resolve {plan}")
    _build.count_launch("fused_resolve", launches.value)
    out["count"] = scratch[0].clone()
    out["needs_cpu_fallback"] = scratch[1] != 0
    return out
