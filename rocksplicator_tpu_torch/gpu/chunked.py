"""Chunked hierarchical merges for batches beyond one launch — counterpart
of ``rocksplicator_tpu/tpu/chunked.py``, on torch tensors.

Correctness rests on the engine's run invariant: for any key, two input
runs' entries occupy disjoint, ordered sequence ranges. Under it LSM
resolution is associative: a chunk of one run folds to a resolved base
or a partial-merge summary strictly newer than the rest of its run, and
two run summaries compose the same way.

Pipeline: fold each run's chunks bottom-up, then sort the summaries by
max seq and greedily group them into launches of one fixed shape, with
tombstones kept until the final pass. Lanes are uploaded once; between
launches they stay on the launch device, and each launch reads back only
its ``count`` and ``needs_cpu_fallback`` scalars.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.compaction_kernel import (MergeKind, deployment_sort_backend,
                                     merge_resolve_kernel)
from ..ops.kv_format import KVBatch
from ..ops.kv_format import LANE_FIELDS as FIELDS
from ..ops.lanes import u32_numpy, u32_tensor, widen

# kernel input lanes: the outputs carry key_words_le for the sinks, but a
# launch derives it from key_words_be
INPUT_FIELDS = tuple(f for f in FIELDS if f != "key_words_le")
# K1 and K2 take a power-of-two row count of at least this
MIN_LAUNCH_ROWS = 256


def launch_rows(n: int) -> int:
    """The row count a launch over ``n`` rows runs at."""
    p = MIN_LAUNCH_ROWS
    while p < n:
        p <<= 1
    return p


def _lane(x, device: torch.device) -> torch.Tensor:
    """A numpy u32 lane uploaded to ``device``; a tensor as it is."""
    return x if isinstance(x, torch.Tensor) else u32_tensor(x, device)


def run_kernel_arrays(
    batch_arrays: dict, n_valid: int, merge_kind: MergeKind,
    drop_tombstones: bool, pad_to: Optional[int] = None,
    uniform_klen: bool = False, seq32: bool = False,
    key_words: Optional[int] = None, to_host: bool = True, *,
    device: torch.device,
) -> Tuple[Optional[dict], int]:
    """One merge-resolve launch over lane arrays (numpy u32 or int32
    tensors on ``device``) whose first ``n_valid`` rows are live. Returns
    (outputs trimmed to count, count), or (None, 0) when the kernel flags
    the CPU fallback. The launch runs at ``launch_rows(max(rows,
    pad_to))`` rows, padded with zero rows on the device. ``to_host``
    gives numpy u32 outputs; otherwise they stay tensors on ``device``."""
    lanes = {f: _lane(batch_arrays[f], device) for f in INPUT_FIELDS}
    n_rows = lanes["key_len"].shape[0]
    rows = launch_rows(max(n_rows, pad_to or 0))
    if rows > n_rows:
        lanes = {f: torch.cat([x, x.new_zeros((rows - n_rows,)
                                               + x.shape[1:])])
                 for f, x in lanes.items()}
    valid = torch.arange(rows, device=device) < n_valid
    kw = (key_words if key_words is not None
          else lanes["key_words_be"].shape[1])
    out = merge_resolve_kernel(
        *(lanes[f] for f in INPUT_FIELDS), valid,
        merge_kind=merge_kind, drop_tombstones=drop_tombstones,
        uniform_klen=uniform_klen, seq32=seq32, key_words=kw,
        sort_backend=deployment_sort_backend())
    # the launch's one readback: both scalars in one transfer
    count, fallback = torch.stack([
        out["count"].to(torch.int64),
        out["needs_cpu_fallback"].to(torch.int64)]).tolist()
    if fallback:
        return None, 0
    if to_host:
        return {f: u32_numpy(out[f][:count]) for f in FIELDS}, count
    return {f: out[f][:count] for f in FIELDS}, count


def _concat(parts: List[dict], device: torch.device) -> Tuple[dict, int]:
    merged = {f: torch.cat([_lane(p[f], device) for p in parts])
              for f in FIELDS}
    return merged, merged["key_len"].shape[0]


def _batch_to_arrays(batch: KVBatch) -> Tuple[dict, int]:
    n = batch.num_valid()
    return {f: getattr(batch, f)[:n] for f in FIELDS}, n


def _fold_groups(
    parts: List[Tuple[dict, int]], merge_kind: MergeKind,
    launch_entries: int, device: torch.device,
) -> Optional[List[Tuple[dict, int]]]:
    """One greedy pass: group consecutive parts up to the launch size and
    fold each group (tombstones kept — not the final pass)."""
    next_level: List[Tuple[dict, int]] = []
    group: List[dict] = []
    group_n = 0

    def flush() -> bool:
        nonlocal group, group_n
        if not group:
            return True
        merged, total = _concat(group, device)
        out = run_kernel_arrays(merged, total, merge_kind, False,
                                pad_to=launch_entries, to_host=False,
                                device=device)
        if out[0] is None:
            return False
        next_level.append(out)
        group, group_n = [], 0
        return True

    for part, pn in parts:
        if group and group_n + pn > launch_entries:
            if not flush():
                return None
        group.append(part)
        group_n += pn
    if not flush():
        return None
    return next_level


def _max_seq(part_n: Tuple[dict, int]) -> int:
    """The largest seq of a part, compared as unsigned 64-bit."""
    part, n = part_n
    if n == 0:
        return 0
    hi_lane, lo_lane = part["seq_hi"][:n], part["seq_lo"][:n]
    if isinstance(hi_lane, np.ndarray):
        # a host part (single-chunk pass-through): numpy, no upload
        hi64 = hi_lane.astype(np.uint64) << np.uint64(32)
        return int((hi64 | lo_lane.astype(np.uint64)).max())
    # a device part: two scalar reductions read back, never the lanes
    hi_w = widen(hi_lane)
    hi = int(hi_w.max())
    lo_at = int(torch.where(hi_w == hi, widen(lo_lane), 0).max())
    return (hi << 32) | lo_at


def chunked_merge(
    run_batches: List[KVBatch],
    merge_kind: MergeKind,
    drop_tombstones: bool,
    chunk_entries: int,
    launch_entries: int,
    device: torch.device,
) -> Optional[Tuple[dict, int]]:
    """Merge packed per-run batches hierarchically on ``device``. Returns
    (final output arrays as numpy, count), or None when a launch flags
    the CPU fallback or the passes cannot converge."""
    chunk_entries = min(chunk_entries, launch_entries)
    # 1) per run: a multi-chunk run folds to one summary; a single-chunk
    #    run passes through raw (already sorted by the run contract)
    summaries: List[Tuple[dict, int]] = []
    for batch in run_batches:
        arrays, n = _batch_to_arrays(batch)
        pieces: List[Tuple[dict, int]] = [
            ({f: arrays[f][i:i + chunk_entries] for f in FIELDS},
             min(chunk_entries, n - i))
            for i in range(0, n, chunk_entries)
        ] or [(arrays, 0)]
        while len(pieces) > 1:
            folded = _fold_groups(pieces, merge_kind, launch_entries, device)
            if folded is None or len(folded) >= len(pieces):
                return None
            pieces = folded
        summaries.append(pieces[0])

    # 2) merge the run summaries; the final pass applies the real
    #    tombstone policy. Grouping folds CONSECUTIVE summaries, which is
    #    associative only for adjacent seq intervals, and engine run
    #    lists arrive level-ordered, so sort by max seq first.
    summaries.sort(key=_max_seq)
    while True:
        total = sum(n for _p, n in summaries)
        if total <= launch_entries:
            merged, _n = _concat([p for p, _ in summaries], device)
            arrays, count = run_kernel_arrays(
                merged, total, merge_kind, drop_tombstones,
                pad_to=launch_entries, device=device)
            return None if arrays is None else (arrays, count)
        folded = _fold_groups(summaries, merge_kind, launch_entries, device)
        if folded is None or len(folded) >= len(summaries):
            return None  # too many distinct keys to converge
        summaries = folded
