"""Compaction backends of the storage engine's ``CompactionBackend`` seam —
counterpart of ``rocksplicator_tpu/tpu/backend.py``.

``GpuCompactionBackend`` runs a compaction's merge-resolve on the card:
kernel K2 (or K1 and the torch resolve, under the ``bitonic`` sort
backend, see ``ops/compaction_kernel.deployment_sort_backend``), and, in
its direct file sink, every output file's bloom in kernel K3. It writes
the same SST files as the JAX package's ``TpuCompactionBackend``. The
engine finds a backend by duck typing (``merge_runs``,
``merge_runs_to_files``, ``supports_subcompactions``,
``supports_memory_budget``), so a reference ``DB`` takes it as its
``DBOptions.compaction_backend``.

It gives work to the CPU only where the reference does by design: a
custom merge operator, entries the lanes cannot hold (keys over 24 bytes,
values over 8 bytes on the tuple path), MERGE records without an
operator, values that are not 8 bytes long under uint64-add, and a
launch that raises ``needs_cpu_fallback``. A kernel that does not build
or launch raises. Key-range subcompactions (``max_subcompactions > 1``)
resolve every slice of a job in ONE batched launch
(``gpu/compaction_service.resolve_slices_batched``); the memory-budget
streaming merge is not ported yet.

``NumpyCompactionBackend`` is the vectorized CPU implementation of the
same algorithm (lexsort + reduceat), and the default fallback.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bloom import bloom_build
from ..ops.compaction_kernel import MergeKind
from ..ops.kv_format import (KVBatch, UnsupportedBatch, fast_flags,
                             pack_entries, unpack_entries)
from ..ops.lanes import u32_numpy, u32_tensor
from ..storage.bloom import num_words_for
from ..storage.compaction import CpuCompactionBackend, Entry
from ..storage.merge import is_uint64_add, uint64add_segment_sums
from .chunked import (FIELDS, INPUT_FIELDS, _batch_to_arrays, chunked_merge,
                      run_kernel_arrays)
from .format import (planar_stride, planar_widths, read_sst_arrays,
                     write_sst_from_arrays)

_PUT, _DELETE, _MERGE = 1, 2, 3

# The largest batch one launch merges (the reference's MAX_TPU_ENTRIES):
# larger ones fold per-run chunks, then summaries, at this launch shape.
MAX_LAUNCH_ENTRIES = 1 << 22


def _merge_kind(merge_op) -> MergeKind:
    return MergeKind.UINT64_ADD if is_uint64_add(merge_op) else MergeKind.NONE


def _arrays_from_entries(entries: List[Entry]) -> Optional[dict]:
    """Entry tuples → lane arrays (the tuple source of the file sink)."""
    if not entries:
        return None
    return _batch_to_arrays(pack_entries(entries))[0]


class GpuCompactionBackend:
    name = "gpu"
    supports_subcompactions = True
    # the memory-budget streaming merge is not ported yet: the engine
    # passes no budget to a backend that does not declare it
    supports_memory_budget = False

    def __init__(self, device=None, fallback=None):
        """``device``: where the merge runs (None means ``cuda``; raises
        without CUDA). ``fallback``: the CPU backend of the by-design
        routes (default ``NumpyCompactionBackend``)."""
        self.device = resolve_device(device)
        self._fallback = fallback or NumpyCompactionBackend()
        # host-clock seconds of the last merge_runs_to_files, by stage
        self.last_stage_seconds: dict = {}

    def merge_runs(self, runs: List[Iterable[Entry]], merge_op,
                   drop_tombstones: bool) -> Iterator[Entry]:
        if merge_op is not None and not is_uint64_add(merge_op):
            # custom operators run arbitrary Python
            return self._fallback.merge_runs(runs, merge_op, drop_tombstones)
        run_lists: List[List[Entry]] = [list(run) for run in runs]
        total = sum(len(r) for r in run_lists)
        if total == 0:
            return iter(())
        if merge_op is not None and any(
                vtype != _DELETE and len(value) != 8
                for run in run_lists for _k, _s, vtype, value in run):
            # the uint64-add fold would rewrite a lone non-8-byte PUT
            return self._fallback.merge_runs(run_lists, merge_op,
                                             drop_tombstones)

        def cpu():
            entries = [e for run in run_lists for e in run]
            return self._fallback.merge_runs(
                [sorted(entries, key=lambda e: (e[0], -e[1]))],
                merge_op, drop_tombstones)

        if total > MAX_LAUNCH_ENTRIES:
            result = self._chunked(run_lists, merge_op, drop_tombstones)
            return cpu() if result is None else iter(result)
        try:
            batch = pack_entries([e for run in run_lists for e in run])
        except UnsupportedBatch:
            return cpu()
        if merge_op is None and bool((batch.vtype == _MERGE).any()):
            # MERGE without an operator keeps its operand chain: CPU only
            return cpu()
        result = self._run_batch(batch, merge_op, drop_tombstones)
        return cpu() if result is None else iter(result)

    def _chunked(self, runs, merge_op,
                 drop_tombstones) -> Optional[List[Entry]]:
        kind = _merge_kind(merge_op)
        try:
            run_batches = [pack_entries(run) for run in runs]
        except UnsupportedBatch:
            return None
        if kind is MergeKind.NONE and any(
                bool((b.vtype[:b.num_valid()] == _MERGE).any())
                for b in run_batches):
            return None
        result = chunked_merge(
            run_batches, kind, drop_tombstones,
            chunk_entries=MAX_LAUNCH_ENTRIES // 4,
            launch_entries=MAX_LAUNCH_ENTRIES, device=self.device)
        if result is None:
            return None
        arrays, count = result
        return unpack_entries(
            arrays["key_words_be"], arrays["key_len"], arrays["seq_hi"],
            arrays["seq_lo"], arrays["vtype"], arrays["val_words"],
            arrays["val_len"], count)

    def _run_batch(self, batch: KVBatch, merge_op,
                   drop_tombstones: bool) -> Optional[List[Entry]]:
        """None when the launch flags the CPU fallback."""
        uniform_klen, seq32, key_words = fast_flags(
            batch.key_len, batch.seq_hi, batch.valid)
        arrays, n = _batch_to_arrays(batch)
        out, count = run_kernel_arrays(
            arrays, n, _merge_kind(merge_op), drop_tombstones,
            uniform_klen=uniform_klen, seq32=seq32, key_words=key_words,
            device=self.device)
        if out is None:
            return None
        return unpack_entries(
            out["key_words_be"], out["key_len"], out["seq_hi"],
            out["seq_lo"], out["vtype"], out["val_words"], out["val_len"],
            count)

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
        """Merge the runs on the device and write PLANAR output files with
        K3-built blooms, splitting at ``target_file_bytes``. Runs are SST
        readers (sink-written and uniform files decode straight to lanes)
        or entry iterables. Returns [(path, props)], [] for an
        all-tombstoned result, or None → the engine's tuple path.
        ``max_subcompactions > 1``: the job splits into key-range slices
        resolved as ONE batched launch (the same files as unsliced).
        ``io_budget`` paces the file writes. Raises TypeError when asked
        for a memory budget, which this backend does not have yet."""
        if mem_tracker is not None or memory_budget_bytes:
            raise TypeError(
                "GpuCompactionBackend has no compaction memory budget: "
                "mem_tracker must be None and memory_budget_bytes 0")
        if merge_op is not None and not is_uint64_add(merge_op):
            return None
        stages = {}
        t0 = time.perf_counter()
        parts: List[dict] = []
        try:
            for run in runs:
                if hasattr(run, "iterate"):  # an SST reader
                    arr = read_sst_arrays(run)
                    if arr is None:
                        arr = _arrays_from_entries(list(run.iterate()))
                else:
                    arr = _arrays_from_entries(list(run))
                if arr is not None:
                    parts.append(arr)
        except UnsupportedBatch:
            return None
        total = sum(p["key_len"].shape[0] for p in parts)
        if total == 0 or total > MAX_LAUNCH_ENTRIES:
            return None  # the chunked and CPU paths return entries
        # sources may pad their value lanes to different widths
        vw = max(p["val_words"].shape[1] for p in parts)
        for p in parts:
            w = p["val_words"].shape[1]
            if w < vw:
                p["val_words"] = np.pad(p["val_words"], [(0, 0), (0, vw - w)])
        lanes = {f: np.concatenate([p[f] for p in parts]) for f in FIELDS}
        if merge_op is None and bool((lanes["vtype"] == _MERGE).any()):
            return None
        # the PLANAR sink needs uniform keys and uniform non-delete value
        # widths; uint64-add needs 8-byte values
        kl = lanes["key_len"]
        if not (kl == kl[0]).all():
            return None
        non_del_vlens = lanes["val_len"][lanes["vtype"] != _DELETE]
        if len(non_del_vlens) and not (
                non_del_vlens == non_del_vlens[0]).all():
            return None
        if (merge_op is not None and len(non_del_vlens)
                and not (non_del_vlens == 8).all()):
            return None
        kind = _merge_kind(merge_op)
        t1 = time.perf_counter()
        stages["source_decode"] = t1 - t0
        sliced = None
        if max_subcompactions > 1:
            sliced = self._subcompact_arrays(parts, total, int(kl[0]), kind,
                                             drop_tombstones,
                                             max_subcompactions)
        if sliced is not None:
            # upload and the batched launch in one stage
            out, count = sliced
            t3 = time.perf_counter()
            stages["subcompact"] = t3 - t1
        else:
            uniform_klen, seq32, key_words = fast_flags(
                kl, lanes["seq_hi"], np.ones(total, dtype=bool))
            dev_lanes = {f: u32_tensor(lanes[f], self.device)
                         for f in INPUT_FIELDS}
            t2 = time.perf_counter()
            stages["upload"] = t2 - t1
            out, count = run_kernel_arrays(
                dev_lanes, total, kind, drop_tombstones,
                uniform_klen=uniform_klen, seq32=seq32, key_words=key_words,
                to_host=False, device=self.device)
            t3 = time.perf_counter()
            stages["merge"] = t3 - t2
        if out is None or count == 0:
            self.last_stage_seconds = stages
            return None if out is None else []
        arrays = {f: u32_numpy(out[f]) for f in FIELDS}
        t4 = time.perf_counter()
        stages["readback"] = t4 - t3
        widths = planar_widths(arrays, count)
        if widths is None:
            return None
        stride = planar_stride(*widths)
        entries_per_file = max(1024, target_file_bytes // max(1, stride))
        block_entries = max(64, block_bytes // max(1, stride))
        spans = [(s, min(s + entries_per_file, count))
                 for s in range(0, count, entries_per_file)]
        blooms = [
            u32_numpy(bloom_build(
                out["key_words_le"][s:e], out["key_len"][s:e],
                torch.ones(e - s, dtype=torch.bool, device=self.device),
                num_words=num_words_for(e - s, bits_per_key)))
            for s, e in spans]
        t5 = time.perf_counter()
        stages["bloom"] = t5 - t4
        outputs: List[Tuple[str, dict]] = []
        for (start, end), bloom in zip(spans, blooms):
            path = path_factory()
            props = write_sst_from_arrays(
                {f: arrays[f][start:end] for f in arrays}, end - start, path,
                bloom_words=bloom, block_entries=block_entries,
                compression=compression, bits_per_key=bits_per_key,
                planar=True)
            outputs.append((path, props))
            if io_budget is not None:
                io_budget.throttle(os.path.getsize(path))
        stages["encode_write"] = time.perf_counter() - t5
        self.last_stage_seconds = stages
        return outputs

    def _subcompact_arrays(self, parts, total, klen, kind, drop_tombstones,
                           max_subcompactions):
        """Key-range subcompactions on the device: boundary keys from the
        runs' key distribution, every run sliced at them, ALL slices
        resolved as one batched launch from the runs' row ranges. Returns
        (device lanes, count) of the kept rows in boundary order — the
        unsliced launch's output — or None to take the unsliced path."""
        from ..storage.native_compaction import (_first_row_ge,
                                                 plan_subcompactions,
                                                 slice_parts)
        from .compaction_service import resolve_slices_on_device

        bounds = plan_subcompactions(parts, total, max_subcompactions, klen)
        if not bounds:
            return None
        cuts = [[_first_row_ge(p, b, klen) for b in bounds] for p in parts]
        slices = [slice_parts(parts, bounds, si, klen, cuts, fields=FIELDS)
                  for si in range(len(bounds) + 1)]
        return resolve_slices_on_device(slices, kind, drop_tombstones,
                                        device=self.device)


class NumpyCompactionBackend:
    """Vectorized CPU implementation of the same algorithm (lexsort +
    reduceat), uint64-add and no-operator semantics; anything else goes to
    the heap merge."""

    name = "numpy"

    def __init__(self, fallback=None):
        self._fallback = fallback or CpuCompactionBackend()

    def merge_runs(self, runs, merge_op, drop_tombstones):
        if merge_op is not None and not is_uint64_add(merge_op):
            return self._fallback.merge_runs(runs, merge_op, drop_tombstones)
        entries = [e for run in runs for e in run]
        if not entries:
            return iter(())

        def cpu():
            return self._fallback.merge_runs(
                [sorted(entries, key=lambda e: (e[0], -e[1]))],
                merge_op, drop_tombstones)

        if merge_op is not None and any(
                vtype != _DELETE and len(value) != 8
                for _k, _s, vtype, value in entries):
            return cpu()
        try:
            batch = pack_entries(entries)
        except UnsupportedBatch:
            return cpu()
        if merge_op is None and bool((batch.vtype == _MERGE).any()):
            return cpu()
        arrays, count = cpu_merge_resolve(
            batch, uint64_add=merge_op is not None,
            drop_tombstones=drop_tombstones)
        return iter(unpack_entries(*arrays, count))


def numpy_merge_resolve(batch: KVBatch, uint64_add: bool,
                        drop_tombstones: bool) -> Tuple[tuple, int]:
    """The merge-resolve in numpy: ((key_words_be, key_len, seq_hi,
    seq_lo, vtype, val_words, val_len) of the kept rows, count)."""
    valid_n = batch.num_valid()
    kw = batch.key_words_be[:valid_n]
    klen = batch.key_len[:valid_n]
    seq = (batch.seq_hi[:valid_n].astype(np.uint64) << np.uint64(32)) | (
        batch.seq_lo[:valid_n].astype(np.uint64))
    vtype = batch.vtype[:valid_n]
    vw = batch.val_words[:valid_n]
    vlen = batch.val_len[:valid_n]

    # lexsort: the last key has the highest priority → (key words asc..,
    # len, seq desc)
    order = np.lexsort(
        (~seq, klen) + tuple(kw[:, w] for w in range(kw.shape[1] - 1, -1, -1)))
    kw, klen, seq, vtype, vw, vlen = (
        kw[order], klen[order], seq[order], vtype[order], vw[order],
        vlen[order])
    n = valid_n
    if n == 0:
        return (batch.key_words_be[:0], batch.key_len[:0], batch.seq_hi[:0],
                batch.seq_lo[:0], batch.vtype[:0], batch.val_words[:0],
                batch.val_len[:0]), 0

    new_key = np.ones(n, dtype=bool)
    if n > 1:
        same = np.all(kw[1:] == kw[:-1], axis=1) & (klen[1:] == klen[:-1])
        new_key[1:] = ~same
    bounds = np.flatnonzero(new_key)
    seg_ids = np.cumsum(new_key) - 1
    pos = np.arange(n)

    is_put = vtype == _PUT
    is_del = vtype == _DELETE
    is_merge = vtype == _MERGE
    is_base = is_put | is_del

    first_base_pos = np.minimum.reduceat(np.where(is_base, pos, n), bounds)
    fb = first_base_pos[seg_ids]
    operand_mask = is_merge & (pos < fb)
    has_op = np.maximum.reduceat(operand_mask.astype(np.int8),
                                 bounds).astype(bool)
    base_exists = first_base_pos < n
    base_is_put = np.zeros(len(bounds), dtype=bool)
    base_is_put[base_exists] = is_put[first_base_pos[base_exists]]
    base_is_del = np.zeros(len(bounds), dtype=bool)
    base_is_del[base_exists] = is_del[first_base_pos[base_exists]]

    sums = None
    if uint64_add:
        if vw.shape[1] > 1:
            vals = vw[:, 0].astype(np.int64) | (
                vw[:, 1].astype(np.int64) << 32)
        else:
            vals = vw[:, 0].astype(np.int64)
        # values that are not 8 bytes long parse as 0
        contrib = (operand_mask | (is_base & (pos == fb) & is_put)) & (
            vlen == 8)
        sums = uint64add_segment_sums(vals, contrib, bounds)

    # the representative is the first row of each segment
    rep_idx = bounds
    out_kw = kw[rep_idx]
    out_klen = klen[rep_idx]
    out_seq = seq[rep_idx]
    out_vtype = vtype[rep_idx].copy()
    out_vw = vw[rep_idx].copy()
    out_vlen = vlen[rep_idx].copy()

    if uint64_add:
        pure_operands = has_op & ~base_is_put & ~base_is_del
        resolved_put = base_is_put | (has_op & base_is_del)
        fold_mask = resolved_put | pure_operands
        out_vw[fold_mask, 0] = (sums[fold_mask] & 0xFFFFFFFF).astype(
            np.uint32)
        if out_vw.shape[1] > 1:
            out_vw[fold_mask, 1] = (
                (sums[fold_mask] >> 32) & 0xFFFFFFFF).astype(np.uint32)
        out_vlen[fold_mask] = 8
        out_vtype[resolved_put] = _PUT
        out_vtype[pure_operands] = _PUT if drop_tombstones else _MERGE
        dropped = base_is_del & ~has_op
    else:
        dropped = out_vtype == _DELETE

    keep = ~dropped if drop_tombstones else np.ones(len(bounds), dtype=bool)
    out = (
        out_kw[keep], out_klen[keep],
        (out_seq[keep] >> np.uint64(32)).astype(np.uint32),
        (out_seq[keep] & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        out_vtype[keep], out_vw[keep], out_vlen[keep],
    )
    return out, int(keep.sum())


# The port's best CPU merge-resolve is the numpy one: it does not load the
# reference's native library, whose resolve is element-exact with numpy.
cpu_merge_resolve = numpy_merge_resolve
