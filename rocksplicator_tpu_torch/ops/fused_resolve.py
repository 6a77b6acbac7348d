"""Kernel K2: the whole merge-resolve on the card as one op — counterpart
of ``rocksplicator_tpu/ops/pallas_resolve.py``.

``fused_merge_resolve`` launches ``csrc/fused_resolve.cu``: composite lanes
built on the device, the K1 bitonic network, a boundary pass, block scans
for the segmented LSM resolution, and stream compaction as an exclusive
prefix sum of ``keep`` plus a scatter. It returns the same dict as
``merge_resolve_kernel``. Its plain PyTorch version is
``compaction_kernel.merge_resolve_plain``; ``merge_resolve_kernel`` is the
entry point that sends CPU tensors there.

It takes CUDA tensors with N a power of two >= 256 and at most 16 lanes
through the sort (1 + key_words + [klen] + [seq_hi] + 1 + 2 + W) and raises
for anything else.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .compaction_kernel import MergeKind
from .kv_format import KEY_WORDS

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rs_fused_scratch_words": (_I, _I, _I, _I, _I,
                               ctypes.POINTER(ctypes.c_int64)),
    "rs_fused_merge_resolve": (_P,) * 8 + (_I,) * 7 + (_P,) * 11,
}
MAX_LANES = 16


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
    if not fused_supported(n, w, key_words, uniform_klen, seq32):
        raise ValueError(
            f"fused merge-resolve needs power-of-two N >= 256 and at most "
            f"{MAX_LANES} sort lanes, got N={n}, "
            f"{sort_lane_count(w, key_words, uniform_klen, seq32)} lanes")
    lib = _build.load("fused_resolve", _SIGNATURES)
    ins = [x.contiguous() for x in (key_words_be, key_len, seq_hi, seq_lo,
                                    vtype, val_words, val_len, valid)]
    out = {
        "key_words_be": torch.zeros((n, KEY_WORDS), dtype=torch.int32,
                                    device=dev),
        "key_words_le": torch.zeros((n, KEY_WORDS), dtype=torch.int32,
                                    device=dev),
        "key_len": torch.zeros(n, dtype=torch.int32, device=dev),
        "seq_hi": torch.zeros(n, dtype=torch.int32, device=dev),
        "seq_lo": torch.zeros(n, dtype=torch.int32, device=dev),
        "vtype": torch.zeros(n, dtype=torch.int32, device=dev),
        "val_words": torch.zeros((n, w), dtype=torch.int32, device=dev),
        "val_len": torch.zeros(n, dtype=torch.int32, device=dev),
    }
    meta = torch.zeros(4, dtype=torch.int32, device=dev)
    words = ctypes.c_int64()
    lib.rs_fused_scratch_words(n, w, key_words, int(uniform_klen),
                               int(seq32), ctypes.byref(words))
    scratch = torch.empty(words.value, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.rs_fused_merge_resolve(
            *[x.data_ptr() for x in ins], n, w, key_words,
            int(uniform_klen), int(seq32),
            int(merge_kind is MergeKind.UINT64_ADD), int(drop_tombstones),
            *[t.data_ptr() for t in out.values()], meta.data_ptr(),
            scratch.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, rc, "fused_merge_resolve")
    _build.count_launch("fused_resolve")
    out["count"] = meta[0].clone()
    out["needs_cpu_fallback"] = meta[1] != 0
    return out
