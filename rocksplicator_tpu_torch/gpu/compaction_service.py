"""GpuCompactionService: shard-batched compaction jobs on the card —
counterpart of ``rocksplicator_tpu/tpu/compaction_service.py``.

Two integration levels, as in the JAX package:
- ``install_on_options(options)`` — per DB: plugs a ``GpuCompactionBackend``
  into the engine's ``CompactionBackend`` seam.
- ``compact_shard_batch(batches)`` — job level: many shards' runs compact
  in ONE batched launch (the counterpart of ``jax.vmap`` over the
  pipeline): each shard is padded to a common capacity, the S shards go
  through one K2 call (``ops/compaction_kernel.merge_resolve_batched``, or
  one segmented K1 sort under the ``pallas`` sort backend) and one K3 call
  (``ops/bloom.bloom_build_batched``), and come back as per-shard merged
  entries, bloom words and counts. ``compact_shard_stream`` runs many
  groups of such launches double-buffered on CUDA streams.

Built on them: ``resolve_slices_batched`` (one compaction's key-range
slices as one batch; ``resolve_slices_on_device`` keeps its result on the
card for the engine seam's subcompactions) and
``compact_dbs_batched`` (many DBs' full compactions after a bulk ingest).
A shard the kernel flags (``needs_cpu_fallback``: a key with 2^16 operands
or more) is recomputed on the host, as the JAX package does by design, and
counted in ``last_host_recomputes``; nothing else leaves the card, and a
kernel that fails raises. CPU tensors (``device="cpu"``) run every
kernel's plain version. The JAX package's spans, failpoints and Stats
counters around these calls have no counterpart in the port yet.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bloom import bloom_build, bloom_build_batched
from ..ops.compaction_kernel import (MergeKind, deployment_sort_backend,
                                     merge_resolve_batched)
from ..ops.kv_format import (UnsupportedBatch, fast_flags, unpack_entries)
from ..ops.lanes import u32_numpy, u32_tensor
from ..storage.bloom import BloomFilter, hash_words, num_words_for
from ..storage.merge import is_uint64_add
from .backend import GpuCompactionBackend, cpu_merge_resolve
from .chunked import FIELDS, INPUT_FIELDS, launch_rows

log = logging.getLogger(__name__)

# the lanes one launch takes, in merge_resolve_batched's argument order
_INPUTS = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
           "val_words", "val_len", "valid")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class GpuCompactionService:
    _instances: Dict[torch.device, "GpuCompactionService"] = {}
    _instance_lock = threading.Lock()

    def __init__(self, bits_per_key: int = 10, sort_backend: str = None,
                 device=None):
        """``sort_backend``: ``"fused"`` (K2) or ``"bitonic"`` (K1 and the
        torch resolve); None reads the ``sort_backend`` flag at each
        launch. ``device``: None means ``cuda`` (raises without it)."""
        self.device = resolve_device(device)
        self._bits_per_key = bits_per_key
        self._sort_backend = sort_backend
        self._streams = None  # (copy, readback) streams, made on first use
        # host-clock seconds of the last compact_shard_batch, by stage
        self.last_stage_seconds: dict = {}
        # shards the last call recomputed on the host (flagged by K2)
        self.last_host_recomputes = 0

    @classmethod
    def instance(cls, device=None) -> "GpuCompactionService":
        """The process-wide service of ``device`` (None: ``cuda``)."""
        dev = resolve_device(device)
        svc = cls._instances.get(dev)
        if svc is None:
            with cls._instance_lock:
                svc = cls._instances.get(dev)
                if svc is None:
                    svc = cls._instances[dev] = cls(device=dev)
        return svc

    # ------------------------------------------------------------------
    # per-DB integration (engine CompactionBackend seam)
    # ------------------------------------------------------------------

    @staticmethod
    def install_on_options(options, device=None):
        """Route this DB's compactions through the card's backend."""
        options.compaction_backend = GpuCompactionBackend(device=device)
        return options

    # ------------------------------------------------------------------
    # job-level batched API
    # ------------------------------------------------------------------

    def _shape(self, batches):
        """(capacity, launch rows, bloom words, static flags) of a job:
        the bloom is sized by the padded capacity as in the JAX package;
        a launch runs at least 256 rows, the kernels' smallest."""
        capacity = _next_pow2(max(b.capacity for b in batches))
        num_words = num_words_for(capacity, self._bits_per_key)
        static = _pooled_flags(
            [fast_flags(b.key_len, b.seq_hi, b.valid) for b in batches])
        return capacity, launch_rows(capacity), num_words, static

    def _stage(self, batches, rows: int, shards: int) -> Dict[str, np.ndarray]:
        """The group's lanes stacked on the host, each shard padded to
        ``rows`` and the group to ``shards`` with empty shards."""
        stacked = {}
        for name in _INPUTS:
            arr = np.stack([_pad_to(getattr(b, name), rows)
                            for b in batches])
            if shards > len(batches):
                arr = np.pad(arr, [(0, shards - len(batches))]
                             + [(0, 0)] * (arr.ndim - 1))
            stacked[name] = arr
        return stacked

    def _upload(self, stacked: Dict[str, np.ndarray]):
        """(device lanes, ready event). On the card the copies come from
        pinned staging on the copy stream, so a group's upload overlaps
        the kernels of the group before it."""
        if self.device.type != "cuda":
            return {k: u32_tensor(v, self.device)
                    for k, v in stacked.items()}, None
        copy_stream, _ = self._cuda_streams()
        with torch.cuda.stream(copy_stream):
            lanes = {}
            for k, v in stacked.items():
                host = torch.from_numpy(
                    v if v.dtype == np.bool_ else v.view(np.int32))
                lanes[k] = host.pin_memory().to(self.device,
                                                non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return lanes, ready

    def _launch(self, lanes, ready, merge_kind: MergeKind,
                drop_tombstones: bool, num_words: Optional[int],
                static: dict):
        """One batched merge-resolve (one K2 call, or one segmented K1
        sort) and, unless ``num_words`` is None, one batched bloom (one K3
        call) over the group."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in lanes.values():
                t.record_stream(stream)
        out = merge_resolve_batched(
            *(lanes[k] for k in _INPUTS), merge_kind=merge_kind,
            drop_tombstones=drop_tombstones,
            sort_backend=self._sort_backend or deployment_sort_backend(),
            **static)
        if num_words is not None:
            out["bloom"] = bloom_build_batched(
                out["key_words_le"], out["key_len"], out["count"],
                num_words=num_words)
        return out

    def _readback(self, out) -> Tuple[dict, Optional[object]]:
        """Start the copy of a group's outputs to the host: on the card
        into pinned buffers on the readback stream, behind the group's
        kernels; (host tensors, done event)."""
        if self.device.type != "cuda":
            return out, None
        _, read_stream = self._cuda_streams()
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(read_stream):
            read_stream.wait_event(done)
            host = {}
            for k, v in out.items():
                v.record_stream(read_stream)
                host[k] = torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(read_stream)
        return host, copied

    def _cuda_streams(self):
        if self._streams is None:
            self._streams = (torch.cuda.Stream(self.device),
                             torch.cuda.Stream(self.device))
        return self._streams

    @staticmethod
    def _host(pending) -> Dict[str, np.ndarray]:
        """Wait for a started readback; lanes as numpy uint32, ``count``
        as ints and ``needs_cpu_fallback`` as bools."""
        host, copied = pending
        if copied is not None:
            copied.synchronize()
        res = {k: u32_numpy(v) for k, v in host.items()}
        res["count"] = host["count"].cpu().numpy().astype(np.int64)
        return res

    def compact_shard_batch(
        self,
        batches: Sequence,
        merge_kind: MergeKind = MergeKind.UINT64_ADD,
        drop_tombstones: bool = True,
        return_arrays: bool = False,
    ) -> List[dict]:
        """Compact many shards in one launch of each kernel. Returns, per
        shard: {"entries": [(key, seq, vtype, value)], "bloom_words":
        np.ndarray, "count": int} — or, with ``return_arrays``,
        {"arrays": lane dict, "bloom_words", "count"} with no per-entry
        unpacking (the array-native sink path)."""
        self.last_host_recomputes = 0
        if not batches:
            return []
        t0 = time.perf_counter()
        _cap, rows, num_words, static = self._shape(batches)
        stacked = self._stage(batches, rows, len(batches))
        t1 = time.perf_counter()
        lanes, ready = self._upload(stacked)
        out = self._launch(lanes, ready, merge_kind, drop_tombstones,
                           num_words, static)
        pending = self._readback(out)
        t2 = time.perf_counter()
        host = self._host(pending)
        t3 = time.perf_counter()
        results = self._unpack(0, host, batches, merge_kind, drop_tombstones,
                               num_words, return_arrays)
        self.last_stage_seconds = {
            # stacking and padding on the host
            "stage": t1 - t0,
            # pinned staging, and issuing the copies and launches
            "issue": t2 - t1,
            # the device: upload, kernels, readback
            "device_wait": t3 - t2,
            # per-shard results (and any host recompute)
            "unpack": time.perf_counter() - t3}
        return results

    def compact_shard_stream(
        self,
        batches: Sequence,
        merge_kind: MergeKind = MergeKind.UINT64_ADD,
        drop_tombstones: bool = True,
        group_size: int = 8,
        return_arrays: bool = False,
    ) -> List[dict]:
        """Pipelined ``compact_shard_batch`` for big shard counts: shards
        run in groups of ``group_size`` on one padded shape (the last
        group padded with empty shards). On the card group i+1's upload
        (pinned staging, copy stream) is issued while group i's kernels
        run, and group i's readback (readback stream) runs under group
        i+1's kernels."""
        self.last_host_recomputes = 0
        if not batches:
            return []
        _cap, rows, num_words, static = self._shape(batches)
        groups = list(range(0, len(batches), group_size))

        def stage(lo: int):
            return self._upload(self._stage(
                batches[lo:lo + group_size], rows, group_size))

        results: List[dict] = []
        pending: List[Tuple[int, tuple]] = []  # (group_lo, readback)
        staged = stage(groups[0])
        for gi, lo in enumerate(groups):
            out = self._launch(*staged, merge_kind, drop_tombstones,
                               num_words, static)
            if gi + 1 < len(groups):
                staged = stage(groups[gi + 1])  # upload under the kernels
            pending.append((lo, self._readback(out)))
            # drain the PREVIOUS group while this one computes
            if len(pending) > 1:
                results.extend(self._drain(
                    *pending.pop(0), batches, merge_kind, drop_tombstones,
                    num_words, return_arrays))
        while pending:
            results.extend(self._drain(
                *pending.pop(0), batches, merge_kind, drop_tombstones,
                num_words, return_arrays))
        return results

    def _drain(self, lo: int, pending, batches, merge_kind, drop_tombstones,
               num_words, return_arrays=False) -> List[dict]:
        """Wait for one group's readback and unpack it."""
        return self._unpack(lo, self._host(pending), batches, merge_kind,
                            drop_tombstones, num_words, return_arrays)

    def _unpack(self, lo: int, host, batches, merge_kind, drop_tombstones,
                num_words, return_arrays) -> List[dict]:
        group = batches[lo:lo + len(host["count"])]
        results = []
        for s in range(min(len(group), len(host["count"]))):
            if bool(host["needs_cpu_fallback"][s]):
                results.append(self._cpu_recompute(
                    group[s], merge_kind, drop_tombstones, num_words,
                    return_arrays=return_arrays))
                continue
            results.append(_shard_result(
                host, s, int(host["count"][s]), return_arrays))
        return results

    def compact_on_device(self, shards: Sequence[List[dict]],
                          merge_kind: MergeKind,
                          drop_tombstones: bool) -> Tuple[dict, int]:
        """The shards of ONE output in one batched merge-resolve, the
        result left on the device: every shard's kept rows concatenated in
        shard order, as (lanes of ``FIELDS`` on the device, count). A
        shard comes as its pieces (lane dicts, one per input run), copied
        straight into its rows of a zero-filled device batch: no host
        concatenation, padding or pinned staging. Only the (S,) counts and
        flags are read back, and no bloom is built; a flagged shard is
        recomputed on the host and uploaded."""
        self.last_host_recomputes = 0
        dev = self.device
        sizes = [sum(p["key_len"].shape[0] for p in pieces)
                 for pieces in shards]
        rows = launch_rows(_next_pow2(max(sizes)))
        static = _pooled_flags([fast_flags(
            *(np.concatenate([p[f] for p in pieces])
              for f in ("key_len", "seq_hi")), np.ones(n, dtype=bool))
            for pieces, n in zip(shards, sizes)])
        lanes = {}
        for f in INPUT_FIELDS:
            lane = torch.zeros((len(shards), rows) + shards[0][0][f].shape[1:],
                               dtype=torch.int32, device=dev)
            for s, pieces in enumerate(shards):
                at = 0
                for p in pieces:
                    n = p[f].shape[0]
                    lane[s, at:at + n].copy_(torch.from_numpy(
                        np.ascontiguousarray(p[f]).view(np.int32)))
                    at += n
            lanes[f] = lane
        lanes["valid"] = (torch.arange(rows, device=dev)[None, :]
                          < torch.tensor(sizes, device=dev)[:, None])
        out = self._launch(lanes, None, merge_kind, drop_tombstones, None,
                           static)
        counts, flagged = torch.stack([
            out["count"].to(torch.int64),
            out["needs_cpu_fallback"].to(torch.int64)]).tolist()
        kept = []
        for s, pieces in enumerate(shards):
            if flagged[s]:
                host, counts[s] = self._host_lanes(_LaneBatch({
                    f: np.concatenate([p[f] for p in pieces])
                    for f in FIELDS}), merge_kind, drop_tombstones)
                kept.append({f: u32_tensor(host[f], dev) for f in FIELDS})
            else:
                kept.append({f: out[f][s, :counts[s]] for f in FIELDS})
        return ({f: torch.cat([k[f] for k in kept]) for f in FIELDS},
                int(sum(counts)))

    def _host_lanes(self, batch, merge_kind: MergeKind,
                    drop_tombstones: bool) -> Tuple[dict, int]:
        """Host recompute of a shard the kernel flagged (a key with 2^16
        operands or more, beyond the limb sums): its kept rows as lanes of
        ``FIELDS``, and their count."""
        self.last_host_recomputes += 1
        arrays, count = cpu_merge_resolve(
            batch, uint64_add=merge_kind is MergeKind.UINT64_ADD,
            drop_tombstones=drop_tombstones)
        kw_be, klen, seq_hi, seq_lo, vtype, vw, vlen = (
            a[:count] for a in arrays)
        return {
            "key_words_be": kw_be,
            # the LE words are the same key bytes read little-endian
            "key_words_le": kw_be.byteswap(),
            "key_len": klen, "seq_hi": seq_hi, "seq_lo": seq_lo,
            "vtype": vtype, "val_words": vw, "val_len": vlen,
        }, count

    def _cpu_recompute(self, batch, merge_kind: MergeKind,
                       drop_tombstones: bool, num_words: int,
                       return_arrays: bool = False) -> dict:
        """A flagged shard's result from the host. ``num_words`` is the
        job-wide bloom size, so the bitmap is interchangeable with the
        card-built ones."""
        lanes, count = self._host_lanes(batch, merge_kind, drop_tombstones)
        bf = BloomFilter(num_words)
        if count:
            h1, mask = hash_words(lanes["key_words_le"], lanes["key_len"])
            np.bitwise_or.at(bf.words, h1 % np.uint32(num_words), mask)
        if return_arrays:
            return {"arrays": lanes, "bloom_words": bf.words, "count": count}
        return {"entries": unpack_entries(*(
            lanes[f] for f in ("key_words_be", "key_len", "seq_hi", "seq_lo",
                               "vtype", "val_words", "val_len")), count),
                "bloom_words": bf.words, "count": count}


def _pooled_flags(flags: List[tuple]) -> dict:
    """The static flags of one launch over shards with these
    ``fast_flags``: each holds only if it holds for every shard."""
    return dict(uniform_klen=all(u for u, _, _ in flags),
                seq32=all(s for _, s, _ in flags),
                key_words=max(k for _, _, k in flags))


def _pad_to(arr: np.ndarray, capacity: int) -> np.ndarray:
    if arr.shape[0] == capacity:
        return arr
    pad = [(0, capacity - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _shard_result(host: Dict[str, np.ndarray], s: int, count: int,
                  return_arrays: bool) -> dict:
    """One shard's result from a group's host outputs: lane views (no
    per-entry work) or unpacked tuples."""
    if return_arrays:
        return {
            "arrays": {f: host[f][s][:count] for f in FIELDS},
            "bloom_words": host["bloom"][s],
            "count": count,
        }
    return {
        "entries": unpack_entries(
            host["key_words_be"][s], host["key_len"][s],
            host["seq_hi"][s], host["seq_lo"][s],
            host["vtype"][s], host["val_words"][s],
            host["val_len"][s], count,
        ),
        "bloom_words": host["bloom"][s],
        "count": count,
    }


# ---------------------------------------------------------------------------
# key-range subcompactions as one device batch
# ---------------------------------------------------------------------------


def resolve_slices_batched(
    slice_lanes: List[Dict[str, np.ndarray]],
    merge_kind: MergeKind,
    drop_tombstones: bool,
    device=None,
) -> List[Tuple[dict, int]]:
    """ONE compaction's key-range slices resolved as ONE batched launch:
    each slice is a "shard" of the job, padded to the common power-of-two
    capacity as in ``compact_shard_batch``. Returns per-slice
    ``(lane_arrays, count)`` in input order (empty slices come back as
    ``({}, 0)``). Slice boundaries are keys, so MERGE operand groups are
    never split across slices."""
    out: List[Tuple[dict, int]] = [({}, 0)] * len(slice_lanes)
    batches: List[_LaneBatch] = []
    index: List[int] = []
    for i, lanes in enumerate(slice_lanes):
        if lanes["key_len"].shape[0] == 0:
            continue
        batches.append(_LaneBatch(lanes))
        index.append(i)
    if batches:
        svc = GpuCompactionService.instance(device)
        results = svc.compact_shard_batch(
            batches, merge_kind=merge_kind,
            drop_tombstones=drop_tombstones, return_arrays=True)
        for i, res in zip(index, results):
            out[i] = (res["arrays"], int(res["count"]))
    return out


def resolve_slices_on_device(
    slices: List[List[Dict[str, np.ndarray]]],
    merge_kind: MergeKind,
    drop_tombstones: bool,
    device=None,
) -> Tuple[dict, int]:
    """``resolve_slices_batched`` for a caller that writes the slices as
    one output: the same ONE batched launch over the slices, each given as
    its pieces (one lane dict per input run), its result left on the
    device as every slice's kept rows concatenated in slice order — the
    unsliced launch's output — with their count. Empty slices are
    skipped."""
    shards = [pieces for pieces in slices
              if sum(p["key_len"].shape[0] for p in pieces)]
    if not shards:
        return {}, 0
    return GpuCompactionService.instance(device).compact_on_device(
        shards, merge_kind, drop_tombstones)


# ---------------------------------------------------------------------------
# cross-DB batched full compaction (the post-ingest path)
# ---------------------------------------------------------------------------

_PUT, _DELETE, _MERGE = 1, 2, 3

# One shard above this entry count would inflate the whole padded launch
# (every shard pays the largest shard's capacity); such shards compact
# per DB.
MAX_BATCHED_DB_ENTRIES = 1 << 20


class _LaneBatch:
    """A KVBatch by duck typing over lane arrays already read — the
    array-native input of compact_shard_batch/stream."""

    __slots__ = ("key_words_be", "key_words_le", "key_len", "seq_hi",
                 "seq_lo", "vtype", "val_words", "val_len", "valid")

    def __init__(self, lanes: Dict[str, np.ndarray]):
        for f in FIELDS:
            setattr(self, f, lanes[f])
        self.valid = np.ones(lanes["key_len"].shape[0], dtype=bool)

    @property
    def capacity(self) -> int:
        return self.key_len.shape[0]

    def num_valid(self) -> int:
        return self.capacity  # every row is live


def _db_lanes(plan: dict) -> Optional[Dict[str, np.ndarray]]:
    """A plan's input runs as one concatenated lane dict (planar and
    uniform files decode straight to lanes; row-format files pay one
    pack). None when the lanes cannot express a run."""
    from .backend import _arrays_from_entries
    from .format import read_sst_arrays

    parts: List[dict] = []
    try:
        for r in plan["runs"]:
            arr = read_sst_arrays(r)
            if arr is None:
                arr = _arrays_from_entries(list(r.iterate()))
            if arr is not None:
                parts.append(arr)
    except UnsupportedBatch as e:
        log.debug("batched compaction lane read declined: %s", e)
        return None
    if not parts:
        return None
    vw = max(p["val_words"].shape[1] for p in parts)
    for p in parts:
        w = p["val_words"].shape[1]
        if w < vw:
            p["val_words"] = np.pad(p["val_words"], [(0, 0), (0, vw - w)])
    return {f: np.concatenate([p[f] for p in parts]) for f in FIELDS}


def _file_blooms(db, res: dict, device) -> Optional[tuple]:
    """One shard's planar output layout: (entries per block, [(start,
    end, bloom words)] per file), each file's bloom built by K3 from its
    own count and the DB's ``bits_per_key`` (not from the group's padded
    capacity); None when the planar layout cannot express the result."""
    from .format import planar_stride, planar_widths

    arrays, count = res["arrays"], int(res["count"])
    widths = planar_widths(arrays, count) if count else None
    if widths is None:
        return None
    opts = db.options
    stride = max(1, planar_stride(*widths))
    entries_per_file = max(1024, opts.target_file_bytes // stride)
    files = []
    for start in range(0, count, entries_per_file):
        end = min(start + entries_per_file, count)
        files.append((start, end, u32_numpy(bloom_build(
            u32_tensor(arrays["key_words_le"][start:end], device),
            u32_tensor(arrays["key_len"][start:end], device),
            torch.ones(end - start, dtype=torch.bool, device=device),
            num_words=num_words_for(end - start, opts.bits_per_key)))))
    return max(64, opts.block_bytes // stride), files


def _install_arrays(db, res: dict, layout: Optional[tuple],
                    install) -> None:
    """Write one shard's resolved lanes as PLANAR SSTs in ``layout``
    (``_file_blooms``) and install them through ``install(files=...)``;
    the entry-tuple sink (``install(entries=...)``) when the planar layout
    cannot express the result."""
    from .format import write_sst_from_arrays

    arrays, count = res["arrays"], int(res["count"])
    if count == 0:
        install(entries=[])
        return
    if layout is not None:
        opts = db.options
        block_entries, files = layout
        names: List[str] = []
        paths: List[str] = []
        for start, end, bloom in files:
            name, path = db.allocate_sst()
            props = write_sst_from_arrays(
                {f: arrays[f][start:end] for f in arrays}, end - start, path,
                bloom_words=bloom, block_entries=block_entries,
                compression=opts.compression,
                bits_per_key=opts.bits_per_key, planar=True,
            )
            if props is None:
                for p in paths:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                break
            names.append(name)
            paths.append(path)
        else:
            install(files=names)
            return
    # tuple fallback (non-uniform keys or values)
    install(entries=unpack_entries(
        arrays["key_words_be"], arrays["key_len"], arrays["seq_hi"],
        arrays["seq_lo"], arrays["vtype"], arrays["val_words"],
        arrays["val_len"], count,
    ))


def compact_dbs_batched(dbs, group_size: int = 8, pool=None, device=None):
    """Fully compact many DBs' key spaces with batched launches on
    ``device`` (None: ``cuda``) — the cross-shard post-ingest compaction:
    N shards' merge-resolve runs as groups over one padded shape, arrays
    end to end (runs decode to lanes, the resolved lanes write through the
    PLANAR sink). The per-DB host stages (plan + lane read, then SST write
    + install) fan out over ``pool`` (any Executor) when given; only the
    launches are centralized.

    Per DB: plan (the engine's ``plan_full_compaction``: flush + snapshot
    under the compaction mutex), read its runs as lanes, launch the group,
    install each shard's output files (``install_full_compaction``). DBs
    the lanes cannot express (custom merge operators, keys over 24 bytes,
    values that are not 8 bytes under uint64-add, MERGE records with no
    operator, shards over MAX_BATCHED_DB_ENTRIES) are declined untouched.

    Returns ``(handled, remaining)``: the DB names compacted here, and the
    (name, db) pairs the caller must compact per DB (compact_range). A
    launch or a bloom kernel that fails raises, after every plan still
    held is released; a host failure to write or install a DB's files
    declines that DB to ``remaining``.
    """
    dev = resolve_device(device)
    dbs = list(dbs)
    handled: List[str] = []
    remaining: List[tuple] = []
    groups: Dict[tuple, List[tuple]] = {}  # (kind, drop) -> items
    # every plan not yet consumed holds its DB's compaction mutex; the
    # finally below releases any an unexpected raise leaks, so the
    # caller's per-DB fallback can never deadlock
    pending: Dict[int, tuple] = {}
    pending_lock = threading.Lock()

    def _track(db, plan):
        with pending_lock:
            pending[id(plan)] = (db, plan)

    def _untrack(plan):
        with pending_lock:
            pending.pop(id(plan), None)

    def _abort(db, plan):
        _untrack(plan)
        db.abort_full_compaction(plan)

    def _pmap(fn, items):
        if pool is None or len(items) <= 1:
            return [fn(it) for it in items]
        # every task ends before a raise reaches the finally below, so no
        # task still holds a plan the sweep releases
        futures = [pool.submit(fn, it) for it in items]
        concurrent.futures.wait(futures)
        return [f.result() for f in futures]

    def _stage(item):
        """(name, db) → ("handled"|"remaining"|"grouped", name, db,
        payload). Never raises: any failure declines the DB to the per-DB
        fallback, so no sibling stage can leak a plan's mutex."""
        name, db = item
        merge_op = db.options.merge_operator
        if merge_op is not None and not is_uint64_add(merge_op):
            return ("remaining", name, db, None)
        try:
            plan = db.plan_full_compaction()
        except BaseException:
            log.exception("plan failed for %s; declining to per-db", name)
            return ("remaining", name, db, None)
        if plan is None:
            return ("handled", name, db, None)  # nothing to compact
        _track(db, plan)
        try:
            lanes = _db_lanes(plan)
        except BaseException:
            log.exception(
                "lane read failed for %s; declining to per-db", name)
            _abort(db, plan)
            return ("remaining", name, db, None)
        total = lanes["key_len"].shape[0] if lanes is not None else 0
        if (
            lanes is None
            or total == 0
            or total > MAX_BATCHED_DB_ENTRIES
            # the uint64-add fold needs 8-byte values
            or (merge_op is not None and bool(
                ((lanes["vtype"] != _DELETE)
                 & (lanes["val_len"] != 8)).any()))
            # MERGE records without an operator: CPU path only
            or (merge_op is None and bool((lanes["vtype"] == _MERGE).any()))
        ):
            _abort(db, plan)
            return ("remaining", name, db, None)
        kind = (MergeKind.UINT64_ADD if merge_op is not None
                else MergeKind.NONE)
        key = (kind, plan["drop_tombstones"])
        return ("grouped", name, db, (key, plan, _LaneBatch(lanes)))

    def _install(args):
        """Build the shard's file blooms (K3: a failure raises), then
        write and install its files on the host; a host failure declines
        the DB to the per-DB fallback with its plan released."""
        name, db, plan, res = args
        layout = _file_blooms(db, res, dev)

        def install(**outputs):
            _untrack(plan)  # install consumes the plan either way
            db.install_full_compaction(plan, **outputs)

        try:
            _install_arrays(db, res, layout, install)
            return ("handled", name, db)
        except Exception:
            log.exception("batched compaction install failed for %s; "
                          "will re-compact per-db", name)
            with pending_lock:
                held = pending.pop(id(plan), None) is not None
            if held:
                db.abort_full_compaction(plan)
            return ("remaining", name, db)

    try:
        staged = _pmap(_stage, dbs)
        for verdict, name, db, payload in staged:
            if verdict == "handled":
                handled.append(name)
            elif verdict == "remaining":
                remaining.append((name, db))
            else:
                key, plan, batch = payload
                groups.setdefault(key, []).append((name, db, plan, batch))

        svc = GpuCompactionService.instance(dev)
        for (kind, drop), items in groups.items():
            batches = [b for _n, _d, _p, b in items]
            vw = max(b.val_words.shape[1] for b in batches)
            for b in batches:  # group-uniform value lanes for the stack
                w = b.val_words.shape[1]
                if w < vw:
                    b.val_words = np.pad(
                        b.val_words, [(0, 0), (0, vw - w)])
            # a launch that fails raises: the finally releases the plans
            if len(batches) > group_size:
                # one padded (group_size, capacity) shape serves every
                # group; group i+1's upload overlaps group i's kernels
                results = svc.compact_shard_stream(
                    batches, merge_kind=kind, drop_tombstones=drop,
                    group_size=group_size, return_arrays=True)
            else:
                results = svc.compact_shard_batch(
                    batches, merge_kind=kind, drop_tombstones=drop,
                    return_arrays=True)
            installs = [(name, db, plan, res) for (name, db, plan, _b), res
                        in zip(items, results)]
            for verdict, name, db in _pmap(_install, installs):
                if verdict == "handled":
                    handled.append(name)
                else:
                    remaining.append((name, db))
        return handled, remaining
    finally:
        with pending_lock:
            leaked = list(pending.values())
            pending.clear()
        for db, plan in leaked:
            try:
                db.abort_full_compaction(plan)
            except Exception:
                pass
