"""Key-range subcompaction helpers and the CPU chunk resolve — the port's
copy of the parts of ``rocksplicator_tpu/storage/native_compaction.py``
that the engine seam and the streaming merge use.

One large compaction splits into disjoint KEY-RANGE slices. Boundaries
are chosen from the input runs' own key distribution (evenly spaced rows
of each decoded SST) and are plain KEYS, so a key's whole entry group —
MERGE operand chains, duplicate seqs, tombstone stacks — lands in exactly
one slice, and the per-slice resolve equals the unsliced single pass.
Slice outputs concatenate in boundary order. The port resolves every
slice of a job in one batched launch
(``gpu/compaction_service.resolve_slices_batched``).

``cpu_chunk_resolve`` resolves one chunk of the streaming merge on the
host and ``bulk_bloom`` builds an output file's bloom from its lanes
(``storage/stream_merge.py``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# The in-RAM direct path's entry cap: a larger compaction streams.
MAX_DIRECT_ENTRIES = 1 << 22

# Subcompactions engage only when every slice would carry at least this
# many entries (tests lower it to force slicing on small fixtures).
MIN_SLICE_ENTRIES = 1 << 15


def _run_is_sorted(part: dict) -> bool:
    """True when the run is sorted by the merge comparator: (key words
    asc, key length asc, seq desc), compared as unsigned."""
    kw = np.asarray(part["key_words_be"], dtype=np.uint32)
    n = kw.shape[0]
    if n <= 1:
        return True
    cols = [kw[:, w] for w in range(kw.shape[1])]
    cols += [np.asarray(part["key_len"], dtype=np.uint32),
             ~np.asarray(part["seq_hi"], dtype=np.uint32),
             ~np.asarray(part["seq_lo"], dtype=np.uint32)]
    gt = np.zeros(n - 1, dtype=bool)
    eq = np.ones(n - 1, dtype=bool)
    for col in cols:
        x, y = col[:-1], col[1:]
        gt |= eq & (y > x)
        eq &= y == x
    return bool((gt | eq).all())


def _part_key(part: dict, i: int, klen: int) -> bytes:
    """Key bytes of row ``i`` (uniform width ``klen``)."""
    return part["key_words_be"][i].astype(">u4").tobytes()[:klen]


def _first_row_ge(part: dict, key: bytes, klen: int) -> int:
    """First row index with key >= ``key`` in a (key asc)-sorted run."""
    lo, hi = 0, part["key_len"].shape[0]
    while lo < hi:
        mid = (lo + hi) // 2
        if _part_key(part, mid, klen) < key:
            lo = mid + 1
        else:
            hi = mid
    return lo


def choose_slice_boundaries(parts: List[dict], nslices: int,
                            klen: int) -> List[bytes]:
    """Up to ``nslices - 1`` boundary KEYS approximating equal-weight
    quantiles of the merged key distribution: each run contributes evenly
    spaced sample rows in proportion to its size, the pooled samples sort,
    and the quantile points dedupe. May return fewer boundaries than asked
    (skewed or tiny key sets)."""
    total = sum(p["key_len"].shape[0] for p in parts)
    if total == 0 or nslices <= 1:
        return []
    per_total = max(nslices * 8, 64)
    samples: List[bytes] = []
    for part in parts:
        n = part["key_len"].shape[0]
        if n == 0:
            continue
        take = max(1, min(n, (per_total * n + total - 1) // total))
        idx = np.linspace(0, n - 1, take).astype(int)
        samples.extend(_part_key(part, int(i), klen) for i in idx)
    samples.sort()
    bounds: List[bytes] = []
    lo_key = samples[0]
    for s in range(1, nslices):
        b = samples[(s * len(samples)) // nslices]
        if b > lo_key and (not bounds or b > bounds[-1]):
            bounds.append(b)
    return bounds


def plan_subcompactions(parts: List[dict], total: int,
                        max_subcompactions: int, klen: int) -> List[bytes]:
    """Boundary keys for this compaction, or [] to run unsliced. Slices
    only when the parallelism is asked for, every slice would clear
    MIN_SLICE_ENTRIES, and every run is (key, seq)-sorted — the bisect cut
    is only meaningful on sorted runs."""
    nslices = min(int(max_subcompactions), total // max(1, MIN_SLICE_ENTRIES))
    if nslices <= 1:
        return []
    if not all(_run_is_sorted(p) for p in parts):
        return []
    return choose_slice_boundaries(parts, nslices, klen)


def slice_parts(parts: List[dict], bounds: List[bytes], si: int,
                klen: int, cuts: List[List[int]],
                fields: Optional[Tuple[str, ...]] = None) -> List[dict]:
    """Slice ``si``'s row ranges of every part (``cuts[p]`` = the per-part
    boundary row indices from _first_row_ge)."""
    if fields is None:
        fields = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
                  "val_words", "val_len")
    out: List[dict] = []
    for p, c in zip(parts, cuts):
        lo = c[si - 1] if si > 0 else 0
        hi = c[si] if si < len(bounds) else p["key_len"].shape[0]
        if hi > lo:
            out.append({f: p[f][lo:hi] for f in fields})
    return out


def cpu_chunk_resolve(lanes: dict, total: int, vw: int, merge_op,
                      drop_tombstones: bool) -> Tuple[dict, int]:
    """The merge-resolve of one chunk on the host: (the kept rows' lanes
    without ``key_words_le``, count). The reference runs its native k-way
    merge where it is built and numpy otherwise, with the same output;
    the port runs numpy (``gpu/backend.numpy_merge_resolve``)."""
    from ..gpu.backend import numpy_merge_resolve
    from ..ops.kv_format import KVBatch

    batch = KVBatch(
        key_words_be=lanes["key_words_be"],
        # the resolve reads no LE key words; the bloom derives its bytes
        # from the BE lanes
        key_words_le=lanes["key_words_be"],
        key_len=lanes["key_len"], seq_hi=lanes["seq_hi"],
        seq_lo=lanes["seq_lo"], vtype=lanes["vtype"],
        val_words=lanes["val_words"], val_len=lanes["val_len"],
        valid=np.ones(total, dtype=bool), val_bytes=vw * 4)
    out, count = numpy_merge_resolve(
        batch, uint64_add=merge_op is not None,
        drop_tombstones=drop_tombstones)
    fields = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
              "val_words", "val_len")
    return dict(zip(fields, out)), count


def bulk_bloom(sub: dict, n: int, klen0: int, bits_per_key: int):
    """The bloom of the first ``n`` rows' keys (their first ``klen0``
    bytes), built in bulk on the host."""
    from .bloom import BloomFilter

    kb = (np.ascontiguousarray(sub["key_words_be"][:n].astype(">u4"))
          .view(np.uint8).reshape(n, -1)[:, :klen0])
    return BloomFilter.build_from_arrays(kb, sub["key_len"][:n],
                                         bits_per_key)
