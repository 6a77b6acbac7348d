"""NativeCompactionBackend — array-path compaction on the CPU; the port's
copy of ``rocksplicator_tpu/storage/native_compaction.py``.

Two faces:

- ``merge_runs`` (inherited from CpuCompactionBackend): the streaming
  heap-merge of entry tuples.
- ``merge_runs_to_files``: the DIRECT sink. When every input run reads
  as lanes (sink-written planar/uniform TSSTs decode straight to
  arrays) and widths are uniform, the merge runs as the native C
  resolve (``storage/native``, numpy where the library is not loaded),
  blooms build in bulk with no per-key Python, and outputs write as
  PLANAR files through the array writer. Returns None for anything the
  lane representation can't express; the engine then takes the tuple
  path.

It is the host backend of the port's engine, asked for by name
(``DBOptions(compaction_backend=NativeCompactionBackend())``): the port's
``DB`` defaults to ``gpu.GpuCompactionBackend`` on the card. The
key-range subcompaction helpers below are shared with the card's
backend, which resolves every slice of a job in one batched launch
(``gpu/compaction_service.resolve_slices_batched``).

One large compaction splits into disjoint KEY-RANGE slices. Boundaries
are chosen from the input runs' own key distribution (evenly spaced rows
of each decoded SST) and are plain KEYS, so a key's whole entry group —
MERGE operand chains, duplicate seqs, tombstone stacks — lands in exactly
one slice, and the per-slice resolve equals the unsliced single pass.
Slice outputs concatenate in boundary order.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .compaction import CpuCompactionBackend
from .merge import is_uint64_add

_PUT, _DELETE, _MERGE = 1, 2, 3

# The in-RAM direct path's entry cap (~48 B/entry of lanes): a larger
# compaction streams.
MAX_DIRECT_ENTRIES = 1 << 22

# Subcompactions engage only when every slice would carry at least this
# many entries (tests lower it to force slicing on small fixtures).
MIN_SLICE_ENTRIES = 1 << 15


class NativeCompactionBackend(CpuCompactionBackend):
    name = "native"

    def merge_runs_to_files(
        self,
        runs: List,
        merge_op,
        drop_tombstones: bool,
        path_factory,
        block_bytes: int,
        compression: int,
        bits_per_key: int,
        target_file_bytes: int,
        max_subcompactions: int = 1,
        io_budget=None,
        mem_tracker=None,
        memory_budget_bytes: int = 0,
    ) -> Optional[List[Tuple[str, dict]]]:
        """[(path, props)], [] for an all-tombstoned result, or None →
        the engine's tuple path (see direct_merge_runs_to_files)."""
        return direct_merge_runs_to_files(
            runs, merge_op, drop_tombstones, path_factory, block_bytes,
            compression, bits_per_key, target_file_bytes,
            max_subcompactions=max_subcompactions, io_budget=io_budget,
            mem_tracker=mem_tracker,
            memory_budget_bytes=memory_budget_bytes,
        )

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _arrays_from_entries(entries, pack_entries) -> Optional[dict]:
        if not entries:
            return None
        b = pack_entries(entries)
        n = b.num_valid()
        return {
            "key_words_be": b.key_words_be[:n], "key_len": b.key_len[:n],
            "seq_hi": b.seq_hi[:n], "seq_lo": b.seq_lo[:n],
            "vtype": b.vtype[:n], "val_words": b.val_words[:n],
            "val_len": b.val_len[:n],
        }

    @staticmethod
    def _resolve(parts: List[dict], lanes: dict, total: int, vw: int,
                 merge_op, drop_tombstones: bool):
        from ..gpu.backend import cpu_merge_resolve
        from ..ops.kv_format import KVBatch
        from .native.binding import get_native

        lib = get_native()
        if (lib is not None
                and getattr(lib, "has_merge_resolve_runs", False)
                and lanes["key_words_be"].shape[1] == 6
                and all(_run_is_sorted(p) for p in parts)):
            # pre-sorted runs (the normal compaction case): O(n log k)
            # k-way merge instead of the O(n log n) full re-sort
            offsets = np.zeros(len(parts) + 1, dtype=np.uint64)
            np.cumsum([p["key_len"].shape[0] for p in parts],
                      out=offsets[1:])
            seq = (lanes["seq_hi"].astype(np.uint64) << np.uint64(32)) \
                | lanes["seq_lo"].astype(np.uint64)
            out = lib.merge_resolve_runs(
                lanes["key_words_be"], lanes["key_len"], seq,
                lanes["vtype"], lanes["val_words"], lanes["val_len"],
                offsets, merge_op is not None, drop_tombstones,
            )
            count = out[6]
            arrays = {
                "key_words_be": out[0][:count], "key_len": out[1][:count],
                "seq_hi": (out[2][:count] >> np.uint64(32)).astype(
                    np.uint32),
                "seq_lo": (out[2][:count]
                           & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                "vtype": out[3][:count].astype(lanes["vtype"].dtype),
                "val_words": out[4][:count], "val_len": out[5][:count],
            }
            return arrays, count

        batch = KVBatch(
            key_words_be=lanes["key_words_be"],
            # the resolve reads no LE key words; the bulk bloom derives
            # its bytes from the BE lanes
            key_words_le=lanes["key_words_be"],
            key_len=lanes["key_len"],
            seq_hi=lanes["seq_hi"], seq_lo=lanes["seq_lo"],
            vtype=lanes["vtype"], val_words=lanes["val_words"],
            val_len=lanes["val_len"],
            valid=np.ones(total, dtype=bool),
            val_bytes=vw * 4,
        )
        out, count = cpu_merge_resolve(
            batch, uint64_add=merge_op is not None,
            drop_tombstones=drop_tombstones,
        )
        arrays = {
            "key_words_be": out[0], "key_len": out[1],
            "seq_hi": out[2], "seq_lo": out[3], "vtype": out[4],
            "val_words": out[5], "val_len": out[6],
        }
        return arrays, count


def read_runs_as_lanes(
    runs: List, merge_op,
    max_entries: int = MAX_DIRECT_ENTRIES,
) -> Optional[Tuple[List[dict], dict, int, int]]:
    """Decode input runs (SSTReaders or entry iterables) straight into
    concatenated lane arrays. Returns (parts, lanes, total, vw) or None
    when the lane representation can't express the inputs (per-run
    checks bail early, before materializing the rest). Shared by the
    direct compaction sink and the batched cross-shard service.

    Deliberately single-threaded: the per-block Python between the
    GIL-releasing zlib/numpy stretches convoys badly under a thread
    fan-out."""
    from ..ops.kv_format import UnsupportedBatch, pack_entries
    from ..gpu.format import read_sst_arrays

    def decode_one(run) -> Optional[dict]:
        if hasattr(run, "iterate"):  # an SSTReader
            arr = read_sst_arrays(run)
            if arr is None:
                arr = NativeCompactionBackend._arrays_from_entries(
                    list(run.iterate()), pack_entries)
        else:
            arr = NativeCompactionBackend._arrays_from_entries(
                list(run), pack_entries)
        return arr

    parts: List[dict] = []
    total = 0
    try:
        for arr in (decode_one(run) for run in runs):
            if arr is not None:
                if merge_op is not None:
                    # uint64-add fold semantics require 8-byte values
                    # (see the precondition comment in
                    # direct_merge_runs_to_files); checked PER RUN so a
                    # disqualifying workload bails after one run, not a
                    # full assembly
                    nd = arr["val_len"][arr["vtype"] != _DELETE]
                    if len(nd) and not (nd == 8).all():
                        return None
                parts.append(arr)
                total += arr["key_len"].shape[0]
                if total > max_entries:
                    # bail BEFORE materializing the rest — the cap
                    # exists to bound host memory, not to be checked
                    # after the allocation it should have prevented
                    return None
    except UnsupportedBatch:
        return None
    if total == 0:
        return None
    vw = max(p["val_words"].shape[1] for p in parts)
    for p in parts:
        w = p["val_words"].shape[1]
        if w < vw:
            p["val_words"] = np.pad(p["val_words"], [(0, 0), (0, vw - w)])
    fields = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
              "val_words", "val_len")
    lanes = {f: np.concatenate([p[f] for p in parts]) for f in fields}
    return parts, lanes, total, vw


def lanes_resolvable(lanes: dict, merge_op) -> bool:
    """True when the array merge-resolve can express these lanes' MERGE
    semantics (the PLANAR-sink preconditions shared by every array
    compaction path)."""
    if merge_op is None and bool((lanes["vtype"] == _MERGE).any()):
        return False
    # PLANAR sink preconditions (same as the card's sink): uniform keys,
    # uniform non-delete value widths
    kl = lanes["key_len"]
    if len(kl) and not (kl == kl[0]).all():
        return False
    is_del = lanes["vtype"] == _DELETE
    non_del_vlens = lanes["val_len"][~is_del]
    if len(non_del_vlens) and not (
            non_del_vlens == non_del_vlens[0]).all():
        return False
    # uint64-add RESOLUTION assumes 8-byte values: the fold rewrites
    # every PUT segment to the operand sum, and a non-8-byte PUT
    # parses as 0 (stream semantics only invoke the operator when
    # operands exist, so a lone non-8-byte PUT must stay verbatim —
    # which the array fold cannot express). Route such shapes to the
    # tuple path.
    if (merge_op is not None and len(non_del_vlens)
            and not (non_del_vlens == 8).all()):
        return False
    return True


def write_resolved_lanes(
    arrays: dict, count: int, path_factory, block_bytes: int,
    compression: int, bits_per_key: int, target_file_bytes: int,
    io_budget=None,
) -> Optional[List[Tuple[str, dict]]]:
    """Write resolved lanes as PLANAR SSTs split at target_file_bytes
    with bulk-built blooms — the shared array file sink. None when the
    planar layout can't express the rows; a mid-loop failure cleans up
    every file already written (nothing would ever GC the orphans).
    ``io_budget`` (compaction callers only) throttles after each output
    file so compaction IO yields to foreground fsyncs."""
    from ..gpu.format import planar_stride, planar_widths, \
        write_sst_from_arrays

    widths = planar_widths(arrays, count)
    if widths is None:
        return None
    klen0, vlen0 = widths
    stride = planar_stride(klen0, vlen0)
    entries_per_file = max(1024, target_file_bytes // max(1, stride))
    block_entries = max(64, block_bytes // max(1, stride))
    outputs: List[Tuple[str, dict]] = []

    def cleanup():
        for p, _ in outputs:
            try:
                os.remove(p)
            except OSError:
                pass

    try:
        for start in range(0, count, entries_per_file):
            end = min(start + entries_per_file, count)
            sub = {f: arrays[f][start:end] for f in arrays}
            bloom = bulk_bloom(sub, end - start, klen0, bits_per_key)
            path = path_factory()
            props = write_sst_from_arrays(
                sub, end - start, path,
                bloom_words=bloom.words,
                block_entries=block_entries,
                compression=compression,
                bits_per_key=bits_per_key,
                planar=True,
            )
            if props is None:  # should not happen after width checks
                cleanup()
                return None
            outputs.append((path, props))
            if io_budget is not None:
                try:
                    size = os.path.getsize(path)
                except OSError:
                    size = (end - start) * stride
                io_budget.throttle(size)
    except BaseException:
        # a mid-loop failure (disk full on file 2 of 3) must not
        # leak file 1: the engine falls back to the tuple path and
        # nothing would ever reference or GC the orphan
        cleanup()
        raise
    return outputs



# ---------------------------------------------------------------------------
# key-range subcompactions (rocksdb max_subcompactions analog)
# ---------------------------------------------------------------------------


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


def bulk_bloom(sub: dict, n: int, klen0: int, bits_per_key: int):
    """The bloom of the first ``n`` rows' keys (their first ``klen0``
    bytes), built in bulk on the host."""
    from .bloom import BloomFilter

    kb = (np.ascontiguousarray(sub["key_words_be"][:n].astype(">u4"))
          .view(np.uint8).reshape(n, -1)[:, :klen0])
    lens = np.minimum(np.asarray(sub["key_len"][:n], dtype=np.uint64),
                      np.uint64(kb.shape[1]))
    return BloomFilter.build_from_arrays(kb, lens, bits_per_key)


def _subcompact_to_files(
    parts: List[dict], bounds: List[bytes], klen: int, vw: int,
    merge_op, drop_tombstones: bool,
    path_factory, block_bytes: int, compression: int, bits_per_key: int,
    target_file_bytes: int, io_budget,
) -> List[Tuple[str, dict]]:
    """Resolve + write every key-range slice in parallel; outputs
    concatenate in boundary order (still globally key-sorted and
    non-overlapping). Any slice failure sweeps every file already
    written by every slice and re-raises — the caller falls back to the
    unsliced/tuple path, and nothing would ever GC the orphans."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from ..observability.span import start_span
    from ..testing import failpoints as fp
    from ..utils.stats import Stats

    cuts = [[_first_row_ge(p, b, klen) for b in bounds] for p in parts]
    nsl = len(bounds) + 1
    results: List[Optional[List[Tuple[str, dict]]]] = [None] * nsl
    written_lock = threading.Lock()
    written_paths: List[str] = []

    def tracking_factory() -> str:
        path = path_factory()
        with written_lock:
            written_paths.append(path)
        return path

    def run_slice(si: int) -> None:
        fp.hit("compact.subcompact")
        Stats.get().incr("compaction.subcompactions")
        sub_parts = slice_parts(parts, bounds, si, klen, cuts)
        if not sub_parts:
            results[si] = []
            return
        fields = sub_parts[0].keys()
        sub_lanes = {f: np.concatenate([p[f] for p in sub_parts])
                     for f in fields}
        sub_total = sub_lanes["key_len"].shape[0]
        arrays, count = NativeCompactionBackend._resolve(
            sub_parts, sub_lanes, sub_total, vw, merge_op,
            drop_tombstones)
        if count == 0:
            results[si] = []
            return
        outs = write_resolved_lanes(
            arrays, count, tracking_factory, block_bytes, compression,
            bits_per_key, target_file_bytes, io_budget=io_budget)
        if outs is None:  # cannot happen after the global width checks
            raise RuntimeError(f"slice {si}: planar sink declined")
        results[si] = outs

    with start_span("compact.subcompactions", slices=nsl):
        with ThreadPoolExecutor(
            max_workers=min(nsl, os.cpu_count() or 2),
            thread_name_prefix="subcompact",
        ) as pool:
            futs = [pool.submit(run_slice, si) for si in range(nsl)]
            errs = []
            for f in futs:
                try:
                    f.result()
                except BaseException as e:
                    errs.append(e)
        if errs:
            with written_lock:
                for p in written_paths:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
            raise errs[0]
    return [o for outs in results for o in (outs or [])]


def direct_merge_runs_to_files(
    runs: List,
    merge_op,
    drop_tombstones: bool,
    path_factory,
    block_bytes: int,
    compression: int,
    bits_per_key: int,
    target_file_bytes: int,
    max_subcompactions: int = 1,
    io_budget=None,
    mem_tracker=None,
    memory_budget_bytes: int = 0,
) -> Optional[List[Tuple[str, dict]]]:
    """The CPU array compaction pipeline: runs → lanes → merge-resolve
    (native C when loaded, numpy lexsort+reduceat otherwise) → PLANAR
    files. [(path, props)], [] for an all-tombstoned result, or None →
    the engine's tuple path. Shared by CpuCompactionBackend and
    NativeCompactionBackend so every CPU-configured engine compacts
    array-to-array when the inputs allow it.

    Inputs whose projected lane image exceeds the compaction memory
    budget (or the MAX_DIRECT_ENTRIES cap) stream through the chunked
    bounded-memory merge instead of materializing here — byte-identical
    output, working set fixed by RSTPU_COMPACT_MEM_BUDGET
    (storage/stream_merge.py). Smaller compactions keep the in-RAM
    path: it already fits the ceiling, and key-range subcompactions
    (``max_subcompactions > 1``) can then resolve+write disjoint slices
    in parallel across cores. ``io_budget`` paces the output writes so
    compaction IO yields to foreground fsyncs; ``mem_tracker`` records
    the materialized-bytes high-water for the
    ``compaction.peak_bytes_materialized`` gauge on both paths."""
    from ..observability.span import start_span
    from .stream_merge import maybe_stream_merge

    if merge_op is not None and not is_uint64_add(merge_op):
        return None
    streamed = maybe_stream_merge(
        runs, merge_op, drop_tombstones, path_factory, block_bytes,
        compression, bits_per_key, target_file_bytes,
        io_budget=io_budget, mem_tracker=mem_tracker,
        memory_budget_bytes=memory_budget_bytes,
    )
    if streamed is not None:
        return streamed
    read = read_runs_as_lanes(runs, merge_op)
    if read is None:
        return None
    parts, lanes, total, vw = read
    if not lanes_resolvable(lanes, merge_op):
        return None
    # in-RAM accounting for the peak gauge: per-run parts plus their
    # concatenation are live together right now
    inram_bytes = 2 * int(sum(a.nbytes for a in lanes.values()))
    if mem_tracker is not None:
        mem_tracker.add(inram_bytes)
    try:
        if max_subcompactions > 1:
            kl = lanes["key_len"]
            klen = int(kl[0]) if len(kl) else 0
            bounds = plan_subcompactions(
                parts, total, max_subcompactions, klen)
            if bounds:
                return _subcompact_to_files(
                    parts, bounds, klen, vw, merge_op, drop_tombstones,
                    path_factory, block_bytes, compression, bits_per_key,
                    target_file_bytes, io_budget)
        with start_span("compact.resolve", entries=total):
            arrays, count = NativeCompactionBackend._resolve(
                parts, lanes, total, vw, merge_op, drop_tombstones)
        if count == 0:
            return []  # fully compacted away — nothing to write
        return write_resolved_lanes(
            arrays, count, path_factory, block_bytes, compression,
            bits_per_key, target_file_bytes, io_budget=io_budget,
        )
    finally:
        if mem_tracker is not None:
            mem_tracker.sub(inram_bytes)
