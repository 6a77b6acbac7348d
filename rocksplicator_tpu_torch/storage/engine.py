"""DB: the LSM engine tying WAL, memtable, SSTs, and compaction together —
the port's copy of ``rocksplicator_tpu/storage/engine.py``.

It writes the same files, WAL segments and MANIFEST as the JAX package's
``DB`` (only the random per-DB incarnation in file names differs), and a
directory either engine wrote opens in the other. It differs in one
default: with ``DBOptions.compaction_backend`` None, the port's engine
compacts on the card (``gpu.GpuCompactionBackend()``, which raises
without CUDA), where the JAX package's uses the host's
``NativeCompactionBackend``; the host backend is asked for by name. And
where the backend runs on a CUDA device, a failure of its direct file
sink raises out of the compaction instead of being retried on the host's
tuple path, so a failed kernel is never hidden.

API parity targets (what the upper layers use of rocksdb::DB — SURVEY.md):
- ``write(batch)`` / ``get`` / ``multi_get`` / ``new_iterator``
  (application_db.cpp delegates these)
- ``latest_sequence_number`` / ``get_updates_since`` (db_wrapper.h seam)
- ``checkpoint`` (admin_handler.cpp:996-1129 checkpoint backup)
- ``ingest_external_file`` with ``allow_global_seqno`` / ``ingest_behind``
  (admin_handler.cpp:1819-1827)
- ``compact_range`` (async_tm_compactDB) with a pluggable backend — the
  device offload seam
- ``get_property`` incl. ``num-levels`` / ``highest-empty-level``
  (application_db.cpp:183-225 DBLmaxEmpty ingest-behind safety check)
- ``destroy_db`` (clearDB path: removeDB → DestroyDB → reopen)
- ``set_options`` (async_tm_setDBOptions)

Directory layout: ``<path>/MANIFEST`` (JSON, atomic rewrite),
``<path>/wal/wal-*.log``, ``<path>/sst-*.tsst``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from ..observability.span import start_span
from ..testing import failpoints as fp
from ..utils.misc import write_file_atomic
from ..utils.stats import Stats
from . import wal as wal_mod
from .compaction import CompactionBackend, CpuCompactionBackend, resolve_stream
from .errors import Corruption, InvalidArgument, StorageError
from .memtable import MemTable
from .merge import MERGE_OPERATORS, MergeOperator
from .records import OpType, WriteBatch, decode_batch
from .sst import COMPRESSION_NONE, COMPRESSION_ZLIB, SSTReader, SSTWriter

import bisect
import heapq
import itertools
import logging

log = logging.getLogger(__name__)

_MANIFEST = "MANIFEST"


@dataclass
class DBOptions:
    create_if_missing: bool = True
    error_if_exists: bool = False
    merge_operator: Optional[MergeOperator] = None
    num_levels: int = 7
    allow_ingest_behind: bool = False
    memtable_bytes: int = 8 * 1024 * 1024
    block_bytes: int = 32 * 1024
    compression: int = COMPRESSION_ZLIB
    bits_per_key: int = 10
    wal_segment_bytes: int = 16 * 1024 * 1024
    wal_ttl_seconds: float = 3600.0
    sync_writes: bool = False
    level0_compaction_trigger: int = 4
    target_file_bytes: int = 64 * 1024 * 1024
    compaction_backend: Optional[CompactionBackend] = None
    disable_auto_compaction: bool = False
    # Background flush/compaction: writes swap a full memtable into the
    # immutable queue and return immediately (stalling only when the queue
    # is full) — the BASELINE write-stall target depends on this.
    # Off by default so single-threaded callers stay deterministic.
    background_compaction: bool = False
    # Total memtables (1 active + up to N-1 immutable awaiting flush) —
    # RocksDB's max_write_buffer_number. A burst that fills one memtable
    # while another flushes no longer stalls the writer; only a sustained
    # rate above flush throughput fills the queue and stalls.
    max_write_buffers: int = 4
    # After this many CONSECUTIVE background-flush failures, writes raise
    # instead of queueing data the flusher can't persist. The earlier
    # failure mode was the opposite: retry-forever while the DB silently
    # accepted writes it would never flush. RocksDB's
    # analog: bg_error_ puts the DB in read-only mode.
    max_flush_failures: int = 3
    # Delayed-write controller (rocksdb WriteController analog): once
    # flush/compaction debt builds — imm queue one short of full, or L0
    # at the slowdown trigger — each admission pays a delay proportional
    # to its bytes (batch_bytes / delayed_write_rate, the rocksdb
    # delayed_write_rate knob) instead of eventually hitting a hard
    # multi-flush-length stop. Hard stops (queue completely full + active
    # memtable full) still happen but become rare, which is what keeps
    # write-stall p99 in the single-digit milliseconds under a storm.
    # 0 disables the soft tier. Triggers mirror rocksdb's
    # level0_slowdown/stop_writes_trigger (defaults 20/36 there; lower
    # here because L0 files are smaller).
    delayed_write_rate: int = 16 * 1024 * 1024  # bytes/s, rocksdb default
    level0_slowdown_writes_trigger: int = 12
    level0_stop_writes_trigger: int = 24
    # Per-level byte targets for the compaction-debt gauges (rocksdb's
    # max_bytes_for_level_base/_multiplier): level L>=1 target is
    # base * multiplier^(L-1); bytes above target are "debt" — the
    # foreground-pressure signal a workload-adaptive compaction
    # scheduler prioritizes by (RESYSTANCE, arxiv 2603.05162). L0 debt
    # is files beyond the compaction trigger, expressed in bytes.
    max_bytes_for_level_base: int = 256 * 1024 * 1024
    max_bytes_for_level_multiplier: int = 10
    # WAL archival (storage.archive.WalArchiver.sink, or any
    # callable(path)): sealed WAL segments are shipped here before TTL
    # deletion, enabling point-in-time restore (restore_db(..., to_seq))
    # — the BackupEngine-incremental-chain analog. None = segments are
    # simply deleted at TTL, as before.
    wal_archive_sink: Optional[object] = None
    # Workload-adaptive compaction scheduling (compaction_scheduler.py):
    # the background compaction thread picks work by PRESSURE (L0 file
    # count vs triggers, per-level debt vs targets, windowed read-amp,
    # delayed-write stall boost) and re-ranks on every flush/install
    # instead of waiting on the fixed L0 trigger. RSTPU_COMPACTION_SCHED=0
    # reverts every DB in the process to the legacy trigger loop (the
    # scheduler A/B's off arm).
    compaction_scheduler: bool = field(
        default_factory=lambda: os.environ.get(
            "RSTPU_COMPACTION_SCHED", "1") not in ("0", "false"))
    # Key-range subcompactions (rocksdb max_subcompactions): one large
    # compaction splits into disjoint key-range slices executed in
    # parallel across cores (one batched launch on the card's
    # backend). 0 = auto (min(4, cores)), 1 = off.
    max_subcompactions: int = field(
        default_factory=lambda: int(os.environ.get(
            "RSTPU_MAX_SUBCOMPACTIONS", "0")))
    # Compaction output IO budget (bytes/s) shared with the delayed-
    # write controller: compaction file writes consume tokens and yield
    # to in-flight foreground WAL fsyncs; admission stalls OPEN the
    # budget (debt drain is what un-delays writes), as does a
    # read-heavy mix. 0 = unmetered (yield-to-foreground only).
    compaction_budget_bytes_per_sec: int = field(
        default_factory=lambda: int(os.environ.get(
            "RSTPU_COMPACT_BUDGET_BYTES", "0")))
    # Hard ceiling on compaction lane bytes materialized in RAM
    # (storage/stream_merge.py): full compactions whose projected
    # working set exceeds it run as a streaming chunked k-way merge
    # with fixed windows per input run instead of decoding every run at
    # once — unlocking levels >> RAM. 0 = the process-wide default
    # (RSTPU_COMPACT_MEM_BUDGET, 256 MiB). The per-compaction
    # high-water feeds the compaction.peak_bytes_materialized gauge.
    compaction_memory_budget_bytes: int = 0
    # Retained key range [retain_lo, retain_hi) as hex strings (the
    # SplitRecord split_key encoding): compactions DROP user keys
    # outside the range — the range-split child's garbage trim. A child
    # born by renaming a full parent copy serves only its half; its
    # first scheduled compaction rewrites inputs without the other
    # half's bytes instead of carrying them to the bottom level
    # forever. Keys in the reserved internal namespace (leading NUL —
    # CDC watermarks/applies counters, storage/…/checkpoint.py) are
    # ALWAYS retained regardless of the range. None/"" = no bound.
    retain_lo: Optional[str] = None
    retain_hi: Optional[str] = None

    # Mutable at runtime via DB.set_options (reference setDBOptions RPC).
    MUTABLE = {
        "memtable_bytes", "wal_ttl_seconds", "level0_compaction_trigger",
        "target_file_bytes", "disable_auto_compaction", "sync_writes",
        "delayed_write_rate", "level0_slowdown_writes_trigger",
        "level0_stop_writes_trigger", "max_subcompactions",
        "compaction_budget_bytes_per_sec",
        "compaction_memory_budget_bytes", "retain_lo", "retain_hi",
    }

    def retain_bounds(self) -> Optional[Tuple[Optional[bytes],
                                              Optional[bytes]]]:
        """Decoded (lo, hi) byte bounds, or None when no trim is
        configured. Malformed hex disables the trim (never drop data on
        a bad knob) rather than raising mid-compaction."""
        if not self.retain_lo and not self.retain_hi:
            return None
        try:
            lo = bytes.fromhex(self.retain_lo) if self.retain_lo else None
            hi = bytes.fromhex(self.retain_hi) if self.retain_hi else None
        except ValueError:
            return None
        return (lo, hi)


class _MergedMemView:
    """Read view over several immutable memtables as one sorted entry
    stream — the source handed to the SST sinks when a flush drains a
    multi-memtable backlog in one file. Each memtable's entries() is
    (key asc, seq desc); the heap-merge preserves that order globally
    (distinct memtables never share a seq)."""

    def __init__(self, imms: List[MemTable]):
        self._imms = imms
        self.max_seq = max(m.max_seq for m in imms)

    def entries(self) -> Iterator[Tuple[bytes, int, int, bytes]]:
        return heapq.merge(
            *(m.entries() for m in self._imms),
            key=lambda e: (e[0], -e[1]),
        )

    def drain_lanes(self):
        """Concatenated unsorted lanes across every memtable (see
        MemTable.drain_lanes) — the caller's single lexsort restores the
        global (key asc, seq desc) order. None when any memtable can't
        express its entries as lanes; cross-memtable width mismatches
        are caught by the caller's planar_widths check."""
        import numpy as np

        parts = [m.drain_lanes() for m in self._imms]
        if any(p is None for p in parts):
            return None
        # Cross-memtable width checks BEFORE any pad/concat — scalar
        # reads off each part's lanes, so a mismatched burst bails in
        # O(parts) instead of after a giant transient concatenation
        # (the same lesson MemTable.drain_lanes applies within
        # one memtable).
        if len({km.shape[1] for _l, km in parts}) != 1:
            return None  # mixed key widths across memtables
        part_vlens = set()
        for lanes, _km in parts:
            live = lanes["val_len"][lanes["vtype"] != 2]
            if len(live):  # all-DELETE parts constrain nothing
                part_vlens.add(int(live[0]))
        if len(part_vlens) > 1:
            return None  # mixed value widths across memtables
        vw = max(p[0]["val_words"].shape[1] for p in parts)
        for lanes, _km in parts:
            w = lanes["val_words"].shape[1]
            if w < vw:
                lanes["val_words"] = np.pad(
                    lanes["val_words"], [(0, 0), (0, vw - w)])
        lanes = {
            f: np.concatenate([l[f] for l, _km in parts])
            for f in parts[0][0]
        }
        return lanes, np.concatenate([km for _l, km in parts])


def _on_card(backend) -> bool:
    """True for a backend whose merge runs on a CUDA device."""
    device = getattr(backend, "device", None)
    return str(getattr(device, "type", device) or "").startswith("cuda")


class DB:
    """One LSM database (one shard in the sharded deployment)."""

    def __init__(self, path: str, options: Optional[DBOptions] = None):
        self.path = os.path.abspath(path)
        self.options = options or DBOptions()
        self._lock = threading.RLock()
        self._mem = MemTable()
        self._imms: List[MemTable] = []  # immutable queue, oldest first
        self._last_seq = 0
        self._persisted_seq = 0  # highest seq durable in SSTs
        self._next_file_id = 1
        # levels[0] may overlap; levels[1:] sorted non-overlapping by range
        self._levels: List[List[str]] = []
        self._readers: Dict[str, SSTReader] = {}
        # per-level key-fence arrays (sorted min_keys, parallel max_keys +
        # names) for bisect file lookup on levels >= 1; built lazily and
        # dropped whenever a compaction/ingest rewrites a level's file set
        self._fences: Dict[int, Tuple[List[bytes], List[bytes], List[str]]] = {}
        self._wal: Optional[wal_mod.WalWriter] = None
        self._closed = False
        if self.options.compaction_backend is not None:
            self._backend = self.options.compaction_backend
        else:
            # default: the card (K2 or K1, and K3, through the direct
            # file sink); the host's NativeCompactionBackend is asked for
            # by name
            from ..gpu.backend import GpuCompactionBackend

            self._backend = GpuCompactionBackend()
        # background machinery: cond signals imm-slot changes; compaction
        # mutex serializes compactions (bg + manual) so only one remover of
        # files runs at a time (flushes only ever add files)
        self._cond = threading.Condition(self._lock)
        self._compaction_mutex = threading.Lock()
        # Manifest writes are versioned so the two fsyncs in
        # write_file_atomic can run OUTSIDE self._lock (they were the
        # dominant write-stall tail: every flush/compaction install held
        # the DB lock across file+dir fsync). Snapshots are taken under
        # self._lock (monotonic version); the writer mutex drops any
        # snapshot older than what is already durable.
        self._manifest_mutex = threading.Lock()  # rstpu-check: io-mutex versioned manifest writer — exists precisely to take the fsyncs OFF self._lock
        self._manifest_version = 0
        self._manifest_written_version = 0
        self._bg_stop = False
        self._bg_flush_error: Optional[BaseException] = None
        self._bg_flush_failures = 0
        # Measured flush throughput (bytes/s, EWMA over recent flushes).
        # The delayed-write controller paces admissions to THIS, not the
        # static delayed_write_rate knob, when the host flushes slower
        # than the knob assumes (rocksdb's WriteController does the same:
        # the delay rate tracks flush bandwidth). 0 = no flush measured.
        self._flush_rate_ewma = 0.0
        self._bg_compaction_error: Optional[BaseException] = None
        self._bg_compaction_failures = 0
        self._bg_thread: Optional[threading.Thread] = None
        self._compaction_thread: Optional[threading.Thread] = None
        # Introspection counters (all mutated under self._lock): the
        # cumulative inputs of the pull-model gauges. read-amp = files
        # consulted per get (fence/bloom path); write-amp = bytes
        # written by compaction / bytes flushed (rocksdb's definition,
        # measured at the flush/compaction install sinks).
        self._gets_total = 0
        self._files_consulted_total = 0
        self._bytes_flushed_total = 0
        self._bytes_compacted_total = 0
        # split of bytes_compacted_total by WHERE the merge ran: bytes a
        # remote worker produced (the disaggregated tier) vs bytes
        # this serving node's own compactions wrote. local = total -
        # remote; the macro-bench acceptance drives local → ~0 tier-on.
        self._remote_offloaded_bytes_total = 0
        # when set (set_remote_compactor), non-manual picks
        # offer themselves to the disaggregated worker tier before the
        # local compaction dispatch
        self._remote_compactor = None
        # high-water of live compaction lane bytes during the most
        # recent direct/streaming merge (stream_merge.MemTracker) —
        # the compaction.peak_bytes_materialized gauge the memory
        # budget's acceptance test asserts against
        self._compaction_peak_bytes = 0
        # last foreground write (monotonic): the scheduler defers batch
        # level-debt work while the foreground is live and drains it in
        # valleys (compaction_scheduler.IDLE_DRAIN_SEC). 0 = never
        # written this process ⇒ idle, so a reopened db with standing
        # debt drains immediately.
        self._last_write_mono = 0.0
        # short-lived cache so one /stats or /metrics dump evaluating a
        # dozen per-db gauges pays ONE lock pass, not one per gauge
        self._metrics_cache: Tuple[float, Optional[Dict]] = (0.0, None)
        # Workload-adaptive compaction scheduling: priority
        # picks from the pressure gauges + the foreground-yielding IO
        # budget. The budget exists whenever the scheduler does — even
        # at rate 0 its yield-to-foreground tier is active.
        self._sched = None
        self._io_budget = None
        if self.options.background_compaction and \
                self.options.compaction_scheduler:
            from .compaction_scheduler import CompactionScheduler, IoBudget

            self._sched = CompactionScheduler(self)
            self._io_budget = IoBudget(
                self.options.compaction_budget_bytes_per_sec)
        self._open()
        if self.options.background_compaction:
            # Separate flush and compaction threads (as RocksDB separates
            # its pools): a running compaction must never block the imm
            # slot, or writers inherit the compaction's latency.
            self._bg_thread = threading.Thread(
                target=self._flush_loop,
                name=f"lsm-flush-{os.path.basename(self.path)}", daemon=True,
            )
            self._bg_thread.start()
            self._compaction_thread = threading.Thread(
                target=self._compaction_loop,
                name=f"lsm-compact-{os.path.basename(self.path)}", daemon=True,
            )
            self._compaction_thread.start()

    # ------------------------------------------------------------------
    # open / recovery
    # ------------------------------------------------------------------

    def _open(self) -> None:
        manifest_path = os.path.join(self.path, _MANIFEST)
        exists = os.path.isfile(manifest_path)
        if exists and self.options.error_if_exists:
            raise InvalidArgument(f"db exists: {self.path}")
        if not exists and not self.options.create_if_missing:
            raise InvalidArgument(f"db missing: {self.path}")
        os.makedirs(self.path, exist_ok=True)
        os.makedirs(self._wal_dir, exist_ok=True)
        if exists:
            with open(manifest_path, "r") as f:
                manifest = json.load(f)
            self._persisted_seq = manifest["persisted_seq"]
            self._next_file_id = manifest["next_file_id"]
            self._levels = [list(files) for files in manifest["levels"]]
            self._incarnation = manifest.get("incarnation", "00000000")
        else:
            self._levels = [[] for _ in range(self.options.num_levels)]
            # Unique per DB creation: file names can never collide across a
            # destroy+recreate, so name-based incremental backup skipping is
            # safe (a recreated db's sst-...-00000001 is a different name).
            self._incarnation = uuid.uuid4().hex[:8]
            self._persist_manifest()
        while len(self._levels) < self.options.num_levels:
            self._levels.append([])
        for level_files in self._levels:
            for name in level_files:
                self._readers[name] = SSTReader(os.path.join(self.path, name))
        # Recover: last_seq from SSTs, then WAL replay beyond persisted_seq.
        self._last_seq = self._persisted_seq
        for start_seq, body in wal_mod.iter_updates(
            self._wal_dir, 0, truncate_torn=True
        ):
            batch = decode_batch(body)
            end_seq = start_seq + batch.count() - 1
            if end_seq <= self._persisted_seq:
                continue
            self._apply_to_memtable(batch, start_seq)
            self._last_seq = max(self._last_seq, end_seq)
        self._wal = wal_mod.WalWriter(
            self._wal_dir, self.options.wal_segment_bytes
        )
        if self._io_budget is not None:
            # foreground WAL fsyncs register in-flight so compaction
            # output writes yield to them (compaction_scheduler.IoBudget)
            self._wal.io_budget = self._io_budget

    @property
    def _wal_dir(self) -> str:
        return os.path.join(self.path, "wal")

    def _manifest_dict(self) -> Dict:
        return {
            "persisted_seq": self._persisted_seq,
            "next_file_id": self._next_file_id,
            "levels": self._levels,
            "incarnation": self._incarnation,
        }

    def _persist_manifest(self, target_dir: Optional[str] = None) -> None:
        """Synchronous manifest write (durable on return). For another
        directory (checkpoint/backup) it is a plain unversioned copy; for
        the live DB it participates in the versioned ordering so it can
        never be overwritten by a stale concurrent snapshot."""
        if target_dir is not None:
            fp.hit("manifest.persist")
            write_file_atomic(
                os.path.join(target_dir, _MANIFEST),
                json.dumps(self._manifest_dict()).encode("utf-8"),
            )
            return
        self._write_manifest_payload(*self._manifest_snapshot_locked())

    def _manifest_snapshot_locked(self) -> Tuple[int, bytes]:
        """Capture manifest content + version under self._lock; pair with
        _write_manifest_payload AFTER releasing the lock."""
        self._manifest_version += 1
        return (self._manifest_version,
                json.dumps(self._manifest_dict()).encode("utf-8"))

    def _write_manifest_payload(self, version: int, payload: bytes) -> None:
        """Durably write a manifest snapshot unless a newer one already
        landed. Holds only _manifest_mutex — never self._lock — so the
        fsyncs don't stall writers."""
        with self._manifest_mutex:
            if version <= self._manifest_written_version:
                return
            fp.hit("manifest.persist")
            write_file_atomic(
                os.path.join(self.path, _MANIFEST), payload)
            self._manifest_written_version = version

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------

    def write(self, batch: WriteBatch, sync: bool = False,
              encoded: Optional[bytes] = None) -> int:
        """Apply a batch atomically; returns the batch's start seq.

        ``encoded`` lets a caller that already HOLDS the batch's encoded
        bytes (a follower applying a replicated update ships the raw
        leader bytes) skip the re-encode — the bytes must be exactly
        ``batch.encode()``.

        Sync durability is GROUP-COMMITTED: the fsync runs OUTSIDE the
        DB lock (readers and other writers never block on the disk) and
        one leader's fsync covers every concurrently-waiting sync
        writer (WalWriter.sync_to). As in rocksdb's pipelined-write
        mode, a concurrent reader may observe a sync write in the
        memtable shortly before its fsync returns; write() itself does
        not return until the batch is durable."""
        count = batch.count()
        with self._lock:
            self._check_open()
            self._check_flush_health_locked()
            self._admission_stall_locked(batch.byte_size())
            self._check_open()
            self._check_flush_health_locked()
            start_seq = self._last_seq + 1
            self._last_write_mono = time.monotonic()
            if encoded is None:
                encoded = batch.encode()
            assert self._wal is not None
            token = self._wal.append(start_seq, encoded)
            self._apply_to_memtable(batch, start_seq)
            self._last_seq += count
            if self._mem.approximate_bytes() >= self.options.memtable_bytes:
                if self._bg_thread is not None:
                    self._swap_to_imm_locked()
                else:
                    self._flush_locked()
            wal = self._wal
        if sync or self.options.sync_writes:
            wal.sync_to(token)
        return start_seq

    def write_many(
        self,
        items: List[Tuple[WriteBatch, Optional[bytes]]],
        sync: bool = False,
    ) -> int:
        """Apply a GROUP of batches in order with one lock pass and one
        WAL flush — the follower apply path commits a whole replication
        pull response per call instead of paying the per-record flush
        syscall and lock round-trip 50+ times per response. Each batch
        still gets its own sequence range (identical numbering to N
        ``write`` calls — replication continuity depends on it); the
        group is NOT atomic against a crash mid-flush, which matches N
        separate non-sync writes. Returns the FIRST batch's start seq.

        ``items`` pairs each batch with its encoded bytes when the
        caller already holds them (replicated updates ship the leader's
        raw bytes), else None to encode here."""
        if not items:
            raise ValueError("write_many: empty group")
        total_bytes = sum(
            len(enc) if enc is not None else b.byte_size()
            for b, enc in items
        )
        with self._lock:
            self._check_open()
            self._check_flush_health_locked()
            self._admission_stall_locked(total_bytes)
            self._check_open()
            self._check_flush_health_locked()
            assert self._wal is not None
            first_seq = self._last_seq + 1
            self._last_write_mono = time.monotonic()
            records = []
            seq = first_seq
            for batch, encoded in items:
                if encoded is None:
                    encoded = batch.encode()
                records.append((seq, encoded))
                seq += batch.count()
            token = self._wal.append_many(records)
            seq = first_seq
            for batch, _ in items:
                self._apply_to_memtable(batch, seq)
                seq += batch.count()
                self._last_seq = seq - 1
            if self._mem.approximate_bytes() >= self.options.memtable_bytes:
                if self._bg_thread is not None:
                    self._swap_to_imm_locked()
                else:
                    self._flush_locked()
            wal = self._wal
        if sync or self.options.sync_writes:
            wal.sync_to(token)
        return first_seq

    def _admission_stall_locked(self, batch_bytes: int) -> None:
        """Write-stall at ADMISSION (rocksdb WriteController analog):
        stalling here — before seq assignment and the WAL append — means
        a flush-gate trip raises for a write that has NOT committed (safe
        to retry), and admission is fair: late arrivals cannot refill a
        fresh memtable under a writer already waiting in the swap loop,
        which starved it through multiple flush cycles.

        Two tiers, as in rocksdb:
        - SOFT (delayed write): imm queue one short of full, or L0 at the
          slowdown trigger → this admission pays one short bounded delay.
          The flusher/compactor runs during the delay (the wait releases
          the lock), so debt drains before the hard condition is reached.
        - HARD (stop): no imm slot AND the active memtable is full, or L0
          at the stop trigger → wait for a flush/compaction to complete.
        Both tiers record storage.write_stall_ms."""
        if self._bg_thread is None:
            return  # inline-flush mode: writes flush synchronously
        opts = self.options

        def l0_managed():
            # re-evaluated each pass: disable_auto_compaction is MUTABLE,
            # and a writer parked on the stop trigger must not keep
            # waiting for a compactor the operator just switched off
            return (self._compaction_thread is not None
                    and not opts.disable_auto_compaction)

        cap = max(1, opts.max_write_buffers - 1)
        stall_start = None
        if opts.delayed_write_rate > 0 and (
            (cap > 1 and len(self._imms) >= cap - 1)
            or (l0_managed() and len(self._levels[0])
                >= opts.level0_slowdown_writes_trigger)
        ):
            # Pace to the MEASURED flush rate when it is below the
            # configured delayed_write_rate (rocksdb WriteController
            # semantics: delay rate follows flush bandwidth). On a
            # contended host flushes run slower, so static pacing admits
            # faster than the flusher drains and writers pile into the
            # hard tier — which is where double-digit p99 comes from.
            # One delay stays capped (8ms) so the soft tier itself can't
            # produce double-digit stalls.
            rate = float(opts.delayed_write_rate)
            if self._flush_rate_ewma > 0.0:
                rate = min(rate, max(self._flush_rate_ewma, 256.0 * 1024))
            delay = min(0.008, max(batch_bytes, 64) / rate)
            stall_start = time.monotonic()
            self._cond.wait(delay)
        while (
            (
                len(self._imms) >= cap
                and self._mem.approximate_bytes() >= opts.memtable_bytes
            )
            or (l0_managed() and len(self._levels[0])
                >= opts.level0_stop_writes_trigger)
        ) and not self._closed and not self._bg_stop:
            self._check_flush_health_locked()  # pre-admission: may raise
            self._check_compaction_health_locked()  # ditto for the L0 gate
            if stall_start is None:
                stall_start = time.monotonic()
            self._cond.wait(0.05)
        self._record_stall(stall_start)

    def _swap_to_imm_locked(self, force: bool = False) -> None:
        """Hand the full memtable to the background flusher. Stalls only
        while the immutable QUEUE is full AND this writer's swap is still
        needed — once a peer writer swapped, the fresh memtable is below
        threshold and waiters exit immediately. Never exceeds the queue
        bound (bails instead on stop/close)."""
        cap = max(1, self.options.max_write_buffers - 1)
        stall_start = None
        while (
            len(self._imms) >= cap
            and not self._closed
            and not self._bg_stop
            and (force or self._mem.approximate_bytes()
                 >= self.options.memtable_bytes)
        ):
            # A failing flusher never drains the queue. This writer's
            # batch is already WAL-appended and applied, so raising here
            # would report failure for a committed write (a retry would
            # double-apply MERGE). Bail without swapping instead — the
            # NEXT write is rejected pre-admission by the health check at
            # the top of write(), matching rocksdb's bg_error
            # reject-before-admit semantics.
            if self._flush_gate_tripped_locked():
                self._record_stall(stall_start)
                return
            if stall_start is None:
                stall_start = time.monotonic()
            self._cond.wait(0.05)
        self._record_stall(stall_start)
        if (
            len(self._imms) >= cap  # stop/close exit: leave the queue alone
            or self._closed
            or self._bg_stop
            or len(self._mem) == 0
            or not (force or self._mem.approximate_bytes()
                    >= self.options.memtable_bytes)
        ):
            return
        self._imms.append(self._mem)
        self._mem = MemTable()
        self._cond.notify_all()

    def _record_stall(self, stall_start: Optional[float]) -> None:
        if stall_start is not None:
            stall_ms = (time.monotonic() - stall_start) * 1000.0
            Stats.get().add_metric("storage.write_stall_ms", stall_ms)
            if self._io_budget is not None:
                # the delayed-write controller's stall signal feeds the
                # scheduler's priority boost AND opens the IO budget:
                # debt drain accelerates precisely when writes are
                # being delayed
                self._io_budget.note_stall(stall_ms)

    def _flush_gate_tripped_locked(self) -> bool:
        """One source of truth for 'the background flusher is dead enough
        to refuse admission' — shared by the pre-admission raise and the
        stall-loop bail so the thresholds can't drift."""
        return (
            self._bg_flush_error is not None
            and self._bg_flush_failures >= self.options.max_flush_failures
        )

    def _check_compaction_health_locked(self) -> None:
        """Raise once the background compactor has failed enough
        consecutive times: a writer parked on the L0 stop trigger would
        otherwise wait forever for a drain that cannot happen (same
        loud-failure requirement as the flush gate)."""
        if (
            self._bg_compaction_error is not None
            and self._bg_compaction_failures
            >= self.options.max_flush_failures
        ):
            raise StorageError(
                f"background compaction failed "
                f"{self._bg_compaction_failures}x consecutively; refusing "
                f"writes at L0 stop trigger: {self._bg_compaction_error!r}"
            )

    def _check_flush_health_locked(self) -> None:
        """Raise once the background flusher has failed enough consecutive
        times that accepting more writes would just grow an unpersistable
        backlog (loud-failure requirement)."""
        if self._flush_gate_tripped_locked():
            raise StorageError(
                f"background flush failed {self._bg_flush_failures}x "
                f"consecutively; refusing writes: {self._bg_flush_error!r}"
            )

    def _drain_imm_locked(self) -> None:
        """Wait until no immutable memtable is pending. Raises if the DB
        closed underneath us or the background flusher is failing (matching
        inline mode, where the flush error reached the caller)."""
        while self._imms and not self._closed:
            if self._bg_flush_error is not None:
                raise StorageError(
                    f"background flush failing: {self._bg_flush_error!r}"
                )
            self._cond.wait(0.05)
        self._check_open()

    def _apply_to_memtable(self, batch: WriteBatch, start_seq: int) -> None:
        seq = start_seq
        for op, key, value in batch.ops():
            if op is OpType.LOG_DATA:
                continue
            self._mem.apply(key, seq, op, value)
            seq += 1

    def put(self, key: bytes, value: bytes) -> int:
        return self.write(WriteBatch().put(key, value))

    def delete(self, key: bytes) -> int:
        return self.write(WriteBatch().delete(key))

    def merge(self, key: bytes, operand: bytes) -> int:
        return self.write(WriteBatch().merge(key, operand))

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        key = bytes(key)
        with self._lock:
            self._check_open()
            # read-amp accounting: every SST actually consulted (bloom/
            # fence survivors) counts; the gauge reports the cumulative
            # files-consulted-per-get ratio
            self._gets_total += 1
            consulted = 0
            try:
                merge_op = self.options.merge_operator
                operands: List[bytes] = []
                # newest first: active memtable, then immutables newest->oldest
                for mem in (self._mem, *reversed(self._imms)):
                    resolved, value, pending = mem.get(key, merge_op)
                    if resolved and not operands:
                        return value
                    if resolved:
                        base = value
                        return merge_op.merge(key, base, operands[::-1]) if merge_op else base
                    operands.extend(pending[::-1])  # newest-first accumulation
                # L0 newest-first, then deeper levels. Fold through every entry
                # of each file's per-key stack (MERGE operands stack within one
                # SST after a flush).
                for name in reversed(self._levels[0]):
                    consulted += 1
                    for result in self._readers[name].get_entries(key):
                        done, value = self._fold(key, result, operands, merge_op)
                        if done:
                            return value
                for level in range(1, len(self._levels)):
                    reader = self._find_file_for_key(level, key)
                    if reader is None:
                        continue
                    consulted += 1
                    for result in reader.get_entries(key):
                        done, value = self._fold(key, result, operands, merge_op)
                        if done:
                            return value
                if operands and merge_op:
                    return merge_op.merge(key, None, operands[::-1])
                return None
            finally:
                self._files_consulted_total += consulted

    def _fold(
        self,
        key: bytes,
        result: Tuple[int, int, bytes],
        operands: List[bytes],
        merge_op: Optional[MergeOperator],
    ) -> Tuple[bool, Optional[bytes]]:
        _seq, vtype, value = result
        if vtype == OpType.PUT:
            if operands and merge_op:
                return True, merge_op.merge(key, value, operands[::-1])
            return True, value
        if vtype == OpType.DELETE:
            if operands and merge_op:
                return True, merge_op.merge(key, None, operands[::-1])
            return True, None
        operands.append(value)  # MERGE operand, keep descending
        return False, None

    def _level_fences_locked(
        self, level: int
    ) -> Tuple[List[bytes], List[bytes], List[str]]:
        """(sorted min_keys, parallel max_keys, names) for a level —
        built once per file-set generation (install/GC/ingest clear the
        cache), replacing the per-get linear min_key()/max_key() scan."""
        fences = self._fences.get(level)
        if fences is None:
            recs = []
            for name in self._levels[level]:
                reader = self._readers[name]
                mn, mx = reader.min_key(), reader.max_key()
                if mn is not None and mx is not None:
                    recs.append((mn, mx, name))
            recs.sort()
            fences = ([r[0] for r in recs], [r[1] for r in recs],
                      [r[2] for r in recs])
            self._fences[level] = fences
        return fences

    def _find_file_for_key(self, level: int, key: bytes) -> Optional[SSTReader]:
        """Bisect the level's fence arrays (levels >= 1 are sorted and
        non-overlapping): the candidate file is the one with the greatest
        min_key <= key, live iff key <= its max_key."""
        mins, maxs, names = self._level_fences_locked(level)
        i = bisect.bisect_right(mins, key) - 1
        if i >= 0 and key <= maxs[i]:
            return self._readers[names[i]]
        return None

    def multi_get(self, keys: List[bytes]) -> List[Optional[bytes]]:
        """Point lookups for many keys with ONE lock pass over the
        memtable/file-set snapshot (``[self.get(k) for k in keys]``
        re-took the DB lock per key), blooms checked in batch, and keys
        grouped per SST so each touched block decodes (or cache-hits)
        once. Result order matches ``keys``; semantics are entry-exact
        with per-key ``get`` (the parity test pins it)."""
        from .bloom import hash_many

        keys_b = [bytes(k) for k in keys]
        with self._lock:
            self._check_open()
            self._gets_total += len(keys_b)
            merge_op = self.options.merge_operator
            results: Dict[bytes, Optional[bytes]] = {}
            operands: Dict[bytes, List[bytes]] = {}
            pending: List[bytes] = []
            for k in keys_b:
                if k not in operands:
                    operands[k] = []
                    pending.append(k)
            # bloom hashes are filter-independent: compute ONCE for the
            # unique key set, probe per SST with a modulo + gather
            h1_all, mask_all = hash_many(pending)
            hashes = ({k: i for i, k in enumerate(pending)},
                      h1_all, mask_all)
            # newest first: active memtable, then immutables newest->oldest
            for mem in (self._mem, *reversed(self._imms)):
                if not pending:
                    break
                still: List[bytes] = []
                for k in pending:
                    resolved, value, pend = mem.get(k, merge_op)
                    ops = operands[k]
                    if resolved:
                        results[k] = (
                            merge_op.merge(k, value, ops[::-1])
                            if ops and merge_op else value
                        )
                    else:
                        ops.extend(pend[::-1])  # newest-first accumulation
                        still.append(k)
                pending = still
            # L0 newest-first: every file may contain any key
            for name in reversed(self._levels[0]):
                if not pending:
                    break
                pending = self._fold_reader_many(
                    self._readers[name], pending, operands, results,
                    merge_op, hashes)
            # deeper levels: group pending keys per fenced file
            for level in range(1, len(self._levels)):
                if not pending:
                    break
                groups: Dict[str, List[bytes]] = {}
                skipped: List[bytes] = []
                mins, maxs, names = self._level_fences_locked(level)
                for k in pending:
                    i = bisect.bisect_right(mins, k) - 1
                    if i >= 0 and k <= maxs[i]:
                        groups.setdefault(names[i], []).append(k)
                    else:
                        skipped.append(k)
                still = skipped
                for name, group in groups.items():
                    still.extend(self._fold_reader_many(
                        self._readers[name], group, operands, results,
                        merge_op, hashes))
                pending = still
            for k in pending:
                ops = operands[k]
                results[k] = (
                    merge_op.merge(k, None, ops[::-1])
                    if ops and merge_op else None
                )
            return [results[k] for k in keys_b]

    def _fold_reader_many(
        self,
        reader: SSTReader,
        pending: List[bytes],
        operands: Dict[bytes, List[bytes]],
        results: Dict[bytes, Optional[bytes]],
        merge_op: Optional[MergeOperator],
        hashes=None,
    ) -> List[bytes]:
        """Fold one SST's entry stacks into the per-key resolution state;
        returns the keys still unresolved after this file."""
        self._files_consulted_total += len(pending)  # read-amp accounting
        found = reader.get_entries_many(pending, hashes=hashes)
        still: List[bytes] = []
        for k in pending:
            entries = found.get(k)
            done = False
            if entries:
                for result in entries:
                    done, value = self._fold(k, result, operands[k],
                                             merge_op)
                    if done:
                        results[k] = value
                        break
            if not done:
                still.append(k)
        return still

    def new_iterator(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Live (key, value) pairs in key order over a point-in-time view.

        The view is materialized under the DB lock so concurrent flush/
        compaction file GC cannot invalidate it (the native engine will use
        refcounted file snapshots instead)."""
        out: List[Tuple[bytes, bytes]] = []
        with self._lock:
            self._check_open()
            runs: List[Iterator] = []
            mems = [self._mem, *self._imms]
            for mem in mems:
                runs.append(iter(list(mem.entries())))
            for name in self._levels[0]:
                runs.append(self._readers[name].iterate())
            for level_files in self._levels[1:]:
                for name in level_files:
                    runs.append(self._readers[name].iterate())
            merge_op = self.options.merge_operator
            merged = heapq.merge(*runs, key=lambda e: (e[0], -e[1]))
            resolved = resolve_stream(merged, merge_op, False)
            # resolve_stream emits one entry per key except for unresolved
            # MERGE chains (no partial-merge operator), which must be folded
            # here as a group — newest first in the stream.
            for key, group in itertools.groupby(resolved, key=lambda e: e[0]):
                entries = list(group)
                if start is not None and key < start:
                    continue
                if end is not None and key >= end:
                    break
                vtype = entries[0][2]
                if vtype == OpType.DELETE:
                    continue
                if vtype == OpType.MERGE:
                    operands = [e[3] for e in reversed(entries)]  # oldest first
                    value = (
                        merge_op.merge(key, None, operands)
                        if merge_op else entries[0][3]
                    )
                else:
                    value = entries[0][3]
                out.append((key, value))
        return iter(out)

    # ------------------------------------------------------------------
    # sequence numbers / replication shipping (db_wrapper.h seam)
    # ------------------------------------------------------------------

    def latest_sequence_number(self) -> int:
        with self._lock:
            return self._last_seq

    def latest_sequence_number_relaxed(self) -> int:
        """Lock-free (possibly slightly stale) seq read for status/
        introspection paths: flush/compaction can hold self._lock for
        seconds, and a status scrape must never hang behind it. The GIL
        makes the bare int read atomic; it simply may miss a write that
        is committing concurrently."""
        return self._last_seq

    def get_updates_since(self, seq: int) -> Iterator[Tuple[int, bytes]]:
        """(start_seq, raw_batch_bytes) for every batch whose start_seq >=
        ``seq``. Followers pass latest_local+1 (replicated_db.cpp:486-505)."""
        return wal_mod.iter_updates(self._wal_dir, seq)

    def oldest_wal_seq(self) -> Optional[int]:
        """First seq the WAL can still serve (None = empty WAL). A
        peer below this cannot WAL-catch-up from us — it must rebuild
        from a snapshot (needRebuildDB's WAL-availability check)."""
        return wal_mod.oldest_seq(self._wal_dir)

    def get_updates_cursor(self, seq: int) -> "wal_mod.WalTailCursor":
        """Resumable tail cursor over the same records as
        ``get_updates_since`` — survives reaching the live tail, so the
        replication serve path can cache it across pulls instead of
        re-scanning the active segment per response."""
        return wal_mod.WalTailCursor(
            self._wal_dir, seq,
            segment_bytes=self.options.wal_segment_bytes)

    # ------------------------------------------------------------------
    # flush / compaction
    # ------------------------------------------------------------------

    def flush(self) -> None:
        """Synchronous flush: on return, everything written before the call
        is durable in SSTs (in background mode this drains the imm slot)."""
        with self._lock:
            self._check_open()
            if self._bg_thread is None:
                self._flush_locked()
            else:
                if len(self._mem):
                    self._swap_to_imm_locked(force=True)
                self._drain_imm_locked()
            persisted = self._persisted_seq
        if self.options.wal_archive_sink is not None:
            # archive + purge OFF the DB lock (the sink is network IO)
            wal_mod.purge_obsolete(
                self._wal_dir, persisted, self.options.wal_ttl_seconds,
                archive_sink=self.options.wal_archive_sink,
            )

    # ------------------------------------------------------------------
    # background thread
    # ------------------------------------------------------------------

    def _flush_loop(self) -> None:
        while True:
            with self._lock:
                while not self._bg_stop and not self._imms:
                    # every wake source notifies (_swap_to_imm_locked,
                    # close); the long timeout is only a missed-notify
                    # safety net — at 1000+ shards per host, per-DB
                    # 0.2s polling burned a measurable core fraction
                    self._cond.wait(10.0)
                if self._bg_stop and not self._imms:
                    return
                # Take EVERY pending immutable memtable: one SST per
                # burst instead of one per memtable (rocksdb's
                # flush-multiple-memtables behavior) — fewer flushes,
                # fewer/larger L0 files, less compaction pressure, and
                # the queue drains in one pass so stalled writers wake
                # after ONE flush latency however deep the backlog.
                imms = list(self._imms)
            if imms:
                try:
                    self._flush_imms(imms)
                    # drop the last reference so the flushed memtables
                    # free before the next idle wait, not on the next
                    # burst
                    imms = None
                    with self._lock:
                        self._bg_flush_error = None
                        self._bg_flush_failures = 0
                except Exception as e:
                    with self._lock:
                        self._bg_flush_error = e
                        self._bg_flush_failures += 1
                        # wake stalled writers/drainers so they observe the
                        # failure instead of waiting on a drain that won't
                        # happen
                        self._cond.notify_all()
                    log.exception("%s: background flush failed (%d); "
                                  "retrying", self.path,
                                  self._bg_flush_failures)
                    time.sleep(1.0)

    def _pick_compaction_locked(self):
        """The compaction thread's work selector. With the adaptive
        scheduler: rank candidates by pressure (compaction_scheduler.py)
        — re-ranked on every wake, and every flush install/compaction
        install/ingest/set_options notifies the condition, so ranking
        is event-driven rather than a timer scan. Without it: the
        legacy fixed L0-trigger predicate."""
        if self._sched is not None:
            return self._sched.pick_locked()
        from .compaction_scheduler import Pick

        if (not self.options.disable_auto_compaction
                and len(self._levels[0])
                >= self.options.level0_compaction_trigger):
            return Pick("l0", 0, 1.0, "legacy trigger")
        return None

    def schedule_compaction(self):
        """Queue a manual FULL compaction on the scheduler's priority
        queue and return a Future resolved when it completes — the
        post-ingest path (admin BatchCompactor) submits through this so
        its compactions obey the same priority order as background
        picks. Returns None when no adaptive compaction thread is
        running (caller falls back to a direct compact_range)."""
        with self._lock:
            self._check_open()
            if (self._sched is None or self._compaction_thread is None
                    or self._bg_stop):
                return None
            from concurrent.futures import Future

            fut: Future = Future()
            self._sched.submit_manual_locked(fut)
            self._cond.notify_all()
            return fut

    def _compaction_loop(self) -> None:
        from ..utils.stats import tagged

        while True:
            with self._lock:
                pick = None
                while not self._bg_stop:
                    pick = self._pick_compaction_locked()
                    if pick is not None:
                        break
                    # wake sources all notify: flush install, compaction
                    # install, ingest, manual submission, close, and
                    # set_options (the ranking reads MUTABLE options)
                    self._cond.wait(10.0)
                if self._bg_stop:
                    if self._sched is not None:
                        self._sched.fail_pending_locked(
                            StorageError("db closing"))
                    return
                if self._sched is not None:
                    self._sched.note_picked_locked()
            manual_futs = []
            try:
                if self._sched is not None:
                    # before dequeuing manual futures: a fault injected
                    # at the pick seam is retried by this loop (registry
                    # contract), so it must not permanently fail waiters
                    # whose compaction was never attempted
                    fp.hit("compact.pick")
                    Stats.get().incr(
                        tagged("compaction.sched_picks", kind=pick.kind))
                if pick.kind == "manual":
                    with self._lock:
                        manual_futs = self._sched.take_manual_locked()
                    # one full compaction satisfies every queued waiter
                    # (the same coalescing as BatchCompactor's dedupe)
                    self.compact_range()
                    for f in manual_futs:
                        if not f.done():
                            f.set_result(None)
                else:
                    # offer non-manual picks to the
                    # disaggregated worker tier first. "installed" — the
                    # pick is satisfied remotely; "fenced" — this leader
                    # was deposed mid-job, so neither the remote result
                    # nor a local merge may run (surfaced as a bg error,
                    # same backoff as any failed compaction); "declined"
                    # — the unchanged local path below is the fallback.
                    handled = "declined"
                    if self._remote_compactor is not None:
                        handled = self._remote_compactor.maybe_offload(pick)
                    if handled == "fenced":
                        raise StorageError(
                            "remote compaction fenced: leader epoch "
                            "stale — refusing local fallback")
                    if handled != "installed":
                        if pick.kind == "level":
                            self._compact_level_bg(pick.level)
                        else:
                            self._compact_level0_bg()
                with self._lock:
                    self._bg_compaction_error = None
                    self._bg_compaction_failures = 0
            except Exception as e:
                for f in manual_futs:
                    if not f.done():
                        f.set_exception(e)
                with self._lock:
                    self._bg_compaction_error = e
                    self._bg_compaction_failures += 1
                    # wake writers parked on the L0 stop trigger so they
                    # observe the failure instead of waiting on a drain
                    # that won't happen
                    self._cond.notify_all()
                log.exception("%s: background compaction failed (%d)",
                              self.path, self._bg_compaction_failures)
                time.sleep(1.0)

    def _write_mem_sst(self, path: str, mem: MemTable) -> None:
        """Write a memtable's entries as one SST. Fixed-width workloads
        take the ARRAY drain path (lanes collected as byte joins, one
        lexsort over key words with seq-desc tiebreak, planar sink with
        bulk bloom — no per-entry Python and array-decodable for the
        first-level compaction); anything else falls back cleanly to the
        per-entry SSTWriter sink."""
        if self._try_array_flush(path, mem):
            return
        writer = SSTWriter(
            path,
            self.options.block_bytes,
            self.options.compression,
            self.options.bits_per_key,
        )
        try:
            for key, seq, vtype, value in mem.entries():
                writer.add(key, seq, vtype, value)
            writer.finish()
        except BaseException:
            writer.abandon()
            raise

    def _try_array_flush(self, path: str, mem) -> bool:
        """True when the vectorized drain→lexsort→planar pipeline handled
        the flush. ``mem`` is a MemTable or _MergedMemView; both expose
        drain_lanes() (width checks bail inline, before any large buffer
        — one oversized value among a million small
        ones must not cost a giant transient allocation)."""
        import numpy as np

        from ..gpu.format import planar_stride, planar_widths, \
            write_sst_from_arrays
        from .bloom import BloomFilter

        with start_span("flush.drain"):
            drained = mem.drain_lanes()
        if drained is None:
            return False
        lanes, key_mat = drained
        n = key_mat.shape[0]
        widths = planar_widths(lanes, n)
        if widths is None:
            return False  # cross-memtable width mismatch
        klen, vlen = widths
        with start_span("flush.sort", entries=n):
            # np.lexsort: last column has highest priority → key words
            # ascending (uniform klen ⇒ BE word order == byte order),
            # inverted seq as the descending tiebreak
            seq = (
                lanes["seq_hi"].astype(np.uint64) << np.uint64(32)
            ) | lanes["seq_lo"].astype(np.uint64)
            kw = lanes["key_words_be"]
            kwc = (klen + 3) // 4
            order = np.lexsort(
                (~seq,) + tuple(kw[:, w] for w in range(kwc - 1, -1, -1)))
            if not np.array_equal(order, np.arange(n)):
                lanes = {f: a[order] for f, a in lanes.items()}
        with start_span("flush.encode", entries=n):
            # bulk bloom (order-independent — built from the pre-sort key
            # matrix) instead of a per-key Python loop
            bloom = BloomFilter.build_from_arrays(
                key_mat, np.full(n, klen, dtype=np.uint64),
                self.options.bits_per_key,
            )
            stride = planar_stride(klen, vlen)
            props = write_sst_from_arrays(
                lanes, n, path,
                bloom_words=bloom.words,
                block_entries=max(64, self.options.block_bytes // stride),
                compression=self.options.compression,
                bits_per_key=self.options.bits_per_key,
                planar=True,
            )
        return props is not None

    def _flush_imms(self, imms: List[MemTable]) -> None:
        """Write the pending immutable memtables (oldest first) as ONE
        L0 SST — ALL file IO outside the lock (writes keep flowing): the
        SST write, the reader open (footer+index read), and the manifest
        fsyncs. Only the in-memory installation runs under the lock.
        Crash between install and the manifest write is covered by the
        WAL (purged strictly after the manifest is durable)."""
        with self._lock:
            name = self._new_file_name()
        path = os.path.join(self.path, name)
        source = imms[0] if len(imms) == 1 else _MergedMemView(imms)
        flushed_bytes = sum(m.approximate_bytes() for m in imms)
        # Always-sampled flush trace: the sst-write vs install vs purge
        # split is what write-stall attribution needs (BASELINE p99 <10 ms
        # under compaction storm). ONE span with phase annotations, not
        # child spans: under a storm the flusher is the writers' critical
        # path, and per-flush overhead amplifies through the GIL on small
        # hosts — phase timings are raw perf_counter deltas instead.
        with start_span("storage.flush", always=True, memtables=len(imms),
                        bytes=flushed_bytes) as fsp:
            t0 = time.monotonic()
            self._write_mem_sst(path, source)
            flush_sec = max(time.monotonic() - t0, 1e-6)
            reader = SSTReader(path)
            max_seq = source.max_seq
            t1 = time.monotonic()
            with self._lock:
                rate = flushed_bytes / flush_sec
                self._flush_rate_ewma = (
                    rate if self._flush_rate_ewma == 0.0
                    else 0.5 * self._flush_rate_ewma + 0.5 * rate
                )
                self._readers[name] = reader
                self._levels[0].append(name)
                self._bytes_flushed_total += reader.file_size
                self._persisted_seq = max(self._persisted_seq, max_seq)
                snapshot = self._manifest_snapshot_locked()
                for m in imms:
                    if self._imms and self._imms[0] is m:
                        self._imms.pop(0)
                self._cond.notify_all()
            self._write_manifest_payload(*snapshot)
            t2 = time.monotonic()
            wal_mod.purge_obsolete(
                self._wal_dir, self._persisted_seq,
                self.options.wal_ttl_seconds,
                archive_sink=self.options.wal_archive_sink,
            )
            if fsp.sampled:
                t3 = time.monotonic()
                fsp.annotate(
                    seq=max_seq,
                    sst_write_ms=round(flush_sec * 1e3, 3),
                    install_ms=round((t2 - t1) * 1e3, 3),
                    wal_purge_ms=round((t3 - t2) * 1e3, 3),
                )

    def _note_compacted_locked(self, out_names: List[str],
                               remote: bool = False) -> None:
        """Write-amp accounting at a compaction install sink: bytes
        WRITTEN by the compaction (its outputs). Caller holds self._lock
        and has already registered readers for ``out_names``. ``remote``
        marks bytes a disaggregated worker produced, which count toward
        write-amp (the generation exists either way) but not toward the
        serving node's local compaction output gauge."""
        out_bytes = sum(
            self._readers[n].file_size for n in out_names
            if n in self._readers)
        self._bytes_compacted_total += out_bytes
        if remote:
            self._remote_offloaded_bytes_total += out_bytes

    def _compact_level0_bg(self) -> None:
        """L0→L1 compaction with the merge OUTSIDE the DB lock. Safe
        because compactions (the only file removers) are serialized by
        _compaction_mutex and flushes only add files."""
        # Always-sampled compaction trace: plan → merge (kernel or heap) →
        # install → gc, the RESYSTANCE-style per-phase view of where a
        # compaction's seconds go. Child spans are fine here: compactions
        # are long relative to span cost (unlike the flush hot path).
        with self._compaction_mutex, \
                start_span("storage.compaction", always=True) as csp:
            with start_span("compaction.plan"):
                with self._lock:
                    if self._closed:
                        return
                    inputs_l0 = list(self._levels[0])
                    inputs_l1 = list(self._levels[1])
                    inputs = inputs_l0 + inputs_l1
                    if not inputs:
                        return
                    drop = (
                        all(not files for files in self._levels[2:])
                        and not self.options.allow_ingest_behind
                    )
                    runs = [self._readers[n] for n in inputs]
            csp.annotate(inputs=len(inputs), backend=self._backend.name)
            with start_span("compaction.merge"):
                out_names = self._write_merged(runs, drop_tombstones=drop)
            csp.annotate(outputs=len(out_names))
            with start_span("compaction.install"):
                # crash-at-install atomicity: a fault here (before any
                # in-memory mutation or manifest write) leaves the DB
                # exactly pre-compaction — outputs are swept, inputs
                # stay live (tested by the subcompaction crash matrix)
                try:
                    fp.hit("compact.install")
                except BaseException:
                    self._discard_outputs(out_names)
                    raise
                with self._lock:
                    if self._closed:
                        return
                    # newer L0 files may have arrived during the merge —
                    # keep them
                    self._levels[0] = [
                        n for n in self._levels[0] if n not in inputs_l0
                    ]
                    self._levels[1] = out_names
                    self._note_compacted_locked(out_names)
                    self._fences.clear()
                    snapshot = self._manifest_snapshot_locked()
                    dead = [(n, self._readers.pop(n, None)) for n in inputs]
                    # L0 just shrank: wake writers parked on the stop
                    # trigger
                    self._cond.notify_all()
                # Durable manifest first, THEN delete the files it stopped
                # referencing — all outside self._lock (the fsyncs + a few
                # hundred unlinks under the lock were a write-stall tail).
                self._write_manifest_payload(*snapshot)
            with start_span("compaction.gc", files=len(dead)):
                self._remove_dead_files(dead)

    def _compact_level_bg(self, level: int) -> None:
        """Debt-driven level→level+1 compaction (scheduler "level"
        pick): merge all of ``level`` with the OVERLAPPING files of
        ``level+1``, install into ``level+1``. Same off-lock merge and
        manifest-before-GC ordering as the L0 path; safe because
        compactions are serialized by _compaction_mutex and nothing
        else adds files to levels >= 1."""
        with self._compaction_mutex, \
                start_span("storage.compaction", always=True) as csp:
            with start_span("compaction.plan"):
                with self._lock:
                    if self._closed:
                        return
                    top = len(self._levels) - 1
                    if self.options.allow_ingest_behind:
                        # the true bottom level is reserved for
                        # ingested-behind files (compact_range makes the
                        # same reservation) — never install into it
                        top -= 1
                    if not (1 <= level < top):
                        return
                    inputs_src = list(self._levels[level])
                    if not inputs_src:
                        return
                    # overlap against the source files' overall range
                    lo = hi = None
                    for n in inputs_src:
                        r = self._readers[n]
                        mn, mx = r.min_key(), r.max_key()
                        if mn is None:
                            continue
                        lo = mn if lo is None else min(lo, mn)
                        hi = mx if hi is None else max(hi, mx)
                    inputs_dst = []
                    for n in self._levels[level + 1]:
                        r = self._readers[n]
                        mn, mx = r.min_key(), r.max_key()
                        if mn is None or lo is None or (
                                mx >= lo and mn <= hi):
                            inputs_dst.append(n)
                    inputs = inputs_src + inputs_dst
                    # tombstones survive unless level+1 is the deepest
                    # data-bearing level (same rule as the L0 path)
                    drop = (
                        all(not self._levels[i]
                            for i in range(level + 2, len(self._levels)))
                        and not self.options.allow_ingest_behind
                    )
                    runs = [self._readers[n] for n in inputs]
            csp.annotate(inputs=len(inputs), backend=self._backend.name,
                         level=level)
            with start_span("compaction.merge"):
                out_names = self._write_merged(runs, drop_tombstones=drop)
            csp.annotate(outputs=len(out_names))
            with start_span("compaction.install"):
                try:
                    fp.hit("compact.install")
                except BaseException:
                    self._discard_outputs(out_names)
                    raise
                with self._lock:
                    if self._closed:
                        return
                    src_set = set(inputs_src)
                    dst_set = set(inputs_dst)
                    self._levels[level] = [
                        n for n in self._levels[level] if n not in src_set]
                    self._levels[level + 1] = [
                        n for n in self._levels[level + 1]
                        if n not in dst_set
                    ] + out_names
                    self._note_compacted_locked(out_names)
                    self._fences.clear()
                    snapshot = self._manifest_snapshot_locked()
                    dead = [(n, self._readers.pop(n, None)) for n in inputs]
                    self._cond.notify_all()
                self._write_manifest_payload(*snapshot)
            with start_span("compaction.gc", files=len(dead)):
                self._remove_dead_files(dead)

    def _flush_locked(self, defer_manifest: bool = False) -> None:
        """``defer_manifest=True`` (ingest_external_file's internal flush
        only) skips the manifest persist + WAL purge + compaction-trigger
        tail: the caller persists a manifest that covers this flush
        moments later, halving the flush's fsync bill. Crash-safe — until
        that manifest lands the flushed SST is an orphan file and the WAL
        still holds every entry, so recovery replays as if the flush
        never happened."""
        if self._imms:
            # callers must drain first (would flush out of queue order and
            # inflate persisted_seq past unflushed sequence numbers)
            raise StorageError("flush with immutable memtables pending")
        if len(self._mem) == 0:
            return
        mem = self._mem
        self._imms.append(mem)
        self._mem = MemTable()
        try:
            name = self._new_file_name()
            self._write_mem_sst(os.path.join(self.path, name), mem)
            self._readers[name] = SSTReader(os.path.join(self.path, name))
            self._levels[0].append(name)
            self._bytes_flushed_total += self._readers[name].file_size
            self._persisted_seq = max(self._persisted_seq, mem.max_seq)
            if not defer_manifest:
                self._persist_manifest()
        except BaseException:
            # Keep read-your-writes: fold the unflushed entries back under
            # any writes that raced in. (Both sinks abandon their partial
            # file on failure.)
            self._mem.absorb_older(mem)
            raise
        finally:
            if mem in self._imms:
                self._imms.remove(mem)
        if defer_manifest:
            return
        if self.options.wal_archive_sink is None:
            # cheap unlink-only purge. With an archive sink the purge
            # does network IO and _flush_locked runs UNDER the DB lock —
            # the off-lock purgers (_flush_imms in bg mode, flush() after
            # it releases the lock) handle archival instead.
            wal_mod.purge_obsolete(
                self._wal_dir, self._persisted_seq,
                self.options.wal_ttl_seconds,
            )
        if (
            self._bg_thread is None  # bg mode compacts on its own thread
            and not self.options.disable_auto_compaction
            and len(self._levels[0]) >= self.options.level0_compaction_trigger
            # A full compaction (compact_range, a batched plan) merges off
            # this lock holding the mutex and installs at the bottom level.
            # An L0 compaction beside it would see no level below L1, drop
            # tombstones, and leave the older versions it is about to
            # install there live again. L0 waits for the next flush.
            and not self._compaction_mutex.locked()
        ):
            self._compact_level0_locked()

    def _new_file_name(self) -> str:
        # self-locking (RLock): callers run both inside and outside the
        # DB lock (background merges allocate names off-lock)
        with self._lock:
            name = f"sst-{self._incarnation}-{self._next_file_id:08d}.tsst"
            self._next_file_id += 1
            return name

    def compact_range(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> None:
        """Full compaction: merge everything into the bottom level (the
        reference's CompactRange(full) after ingest, admin_handler.cpp:1845).
        ``start``/``end`` accepted for API parity; the merge is whole-range.
        The merge itself runs OUTSIDE the DB lock (writes keep flowing);
        _compaction_mutex serializes against background compaction."""
        self.flush()
        with self._compaction_mutex, \
                start_span("storage.compact_range", always=True) as csp:
            with start_span("compaction.plan"):
                with self._lock:
                    self._check_open()
                    # allow_ingest_behind reserves the true bottom level for
                    # ingested-behind data (RocksDB does the same), so full
                    # compaction targets num_levels-2 there.
                    bottom = self.options.num_levels - 1
                    if self.options.allow_ingest_behind:
                        bottom -= 1
                    inputs: List[str] = [
                        n for files in self._levels for n in files
                    ]
                    if not inputs:
                        return
                    runs = [self._readers[n] for n in inputs]
            csp.annotate(inputs=len(inputs), backend=self._backend.name)
            # Tombstones must survive when data can later be ingested BEHIND
            # this level — dropping them would resurrect deleted keys.
            with start_span("compaction.merge"):
                out_names = self._write_merged(
                    runs,
                    drop_tombstones=not self.options.allow_ingest_behind,
                )
            csp.annotate(outputs=len(out_names))
            with start_span("compaction.install"):
                try:
                    fp.hit("compact.install")
                except BaseException:
                    self._discard_outputs(out_names)
                    raise
                with self._lock:
                    self._check_open()
                    input_set = set(inputs)
                    # new L0 flushes may have landed during the merge: keep
                    # them
                    for files in self._levels:
                        files[:] = [n for n in files if n not in input_set]
                    self._levels[bottom] = out_names + self._levels[bottom]
                    self._note_compacted_locked(out_names)
                    self._fences.clear()
                    # Manifest first, THEN delete inputs — a crash in
                    # between leaves orphan files (harmless), never a
                    # manifest pointing at deleted ones (unopenable DB).
                    self._persist_manifest()
                    self._gc_files(inputs)
                    # L0 drained: re-rank the scheduler / wake stalled
                    # writers parked on the stop trigger
                    self._cond.notify_all()

    def _compact_level0_locked(self) -> None:
        """L0 → L1 compaction (tombstones kept; not bottom level).
        Runs UNDER the DB lock (inline mode), so subcompactions are
        forced off: a slice worker allocating an output name would
        block on the lock this thread holds — and with writers parked
        on the same lock there is no latency to win anyway."""
        inputs = list(self._levels[0]) + list(self._levels[1])
        if not inputs:
            return
        runs = [self._readers[n] for n in inputs]
        drop = (
            all(not files for files in self._levels[2:])
            and not self.options.allow_ingest_behind
        )
        out_names = self._write_merged(runs, drop_tombstones=drop,
                                       subcompactions=1)
        self._levels[0] = []
        self._levels[1] = out_names
        self._note_compacted_locked(out_names)
        self._fences.clear()
        self._persist_manifest()  # before GC — see compact_range
        self._gc_files(inputs)

    def _effective_subcompactions(self) -> int:
        """max_subcompactions with 0 = auto (min(4, cores))."""
        n = self.options.max_subcompactions
        if n <= 0:
            n = min(4, os.cpu_count() or 1)
        return max(1, n)

    @staticmethod
    def _retain_filter(stream, lo: Optional[bytes], hi: Optional[bytes]):
        """Drop entries whose user key falls outside [lo, hi) — the
        split-child garbage trim. The reserved internal namespace
        (leading NUL: CDC watermarks + applies counters) is ALWAYS
        retained: that state belongs to the db, not to the key range it
        serves, and must survive the trim."""
        for entry in stream:
            key = entry[0]
            if not key.startswith(b"\x00"):
                if lo is not None and key < lo:
                    continue
                if hi is not None and key >= hi:
                    continue
            yield entry

    def _write_merged(self, runs: List, drop_tombstones: bool,
                      subcompactions: Optional[int] = None) -> List[str]:
        retain = self.options.retain_bounds()
        # Backends with a direct file sink (the card's pipeline: kernel output
        # arrays → vectorized block assembly + kernel-built bloom) skip the
        # per-entry tuple path entirely, splitting at target_file_bytes.
        # A retain trim forces the tuple path: the direct sinks consume
        # whole runs and have no per-entry seam to drop out-of-range keys
        # at (only split children pay this, and only until their trim-
        # triggering compactions have rewritten the inherited files).
        direct = getattr(self._backend, "merge_runs_to_files", None)
        if retain is not None:
            direct = None
        if direct is not None:
            # readers are re-iterable; materialize only raw iterables so a
            # failed direct attempt can still fall back to the tuple path
            runs = [
                r if hasattr(r, "iterate") else list(r) for r in runs
            ]
            allocated: List[str] = []

            def path_factory() -> str:
                name = self._new_file_name()
                allocated.append(name)
                return os.path.join(self.path, name)

            # subcompaction + IO-budget + memory-budget plumbing only
            # for backends that declare support (keeps third-party
            # backend signatures unchanged)
            kwargs = {}
            tracker = None
            if getattr(self._backend, "supports_subcompactions", False):
                kwargs["max_subcompactions"] = (
                    subcompactions if subcompactions is not None
                    else self._effective_subcompactions())
                kwargs["io_budget"] = self._io_budget
            if getattr(self._backend, "supports_memory_budget", False):
                from .stream_merge import CompactionMemoryBudget

                tracker = CompactionMemoryBudget.get().tracker()
                kwargs["mem_tracker"] = tracker
                kwargs["memory_budget_bytes"] = (
                    self.options.compaction_memory_budget_bytes)
            try:
                outputs = direct(
                    runs, self.options.merge_operator, drop_tombstones,
                    path_factory, self.options.block_bytes,
                    self.options.compression, self.options.bits_per_key,
                    self.options.target_file_bytes, **kwargs,
                )
            except Exception:
                if _on_card(self._backend):
                    # the tuple path would build blooms on the host and
                    # hide a failed kernel: a card's failure is the
                    # compaction's
                    raise
                log.exception("direct merge sink failed; using tuple path")
                outputs = None
            finally:
                if tracker is not None:
                    tracker.close()
                    if tracker.peak:
                        # the peak_bytes_materialized gauge: high-water
                        # of live lane bytes during this compaction
                        self._compaction_peak_bytes = tracker.peak
            if outputs is not None:
                names: List[str] = []
                for path, _props in outputs:
                    name = os.path.basename(path)
                    self._readers[name] = SSTReader(path)
                    names.append(name)
                return names
        streams = [r.iterate() if hasattr(r, "iterate") else r for r in runs]
        stream = self._backend.merge_runs(
            streams, self.options.merge_operator, drop_tombstones
        )
        if retain is not None:
            stream = self._retain_filter(stream, *retain)
            Stats.get().incr("compaction.retain_trims")
        return self._write_entry_stream(stream, io_budget=self._io_budget)

    def _write_entry_stream(self, stream, io_budget=None) -> List[str]:
        """Write an already-merged (key asc, seq desc) entry stream into
        output SSTs, splitting at target_file_bytes. Shared by the tuple
        merge path and the cross-db batched-compaction install.
        ``io_budget`` (compaction callers only) throttles after each
        finished output file so background IO yields to foreground
        fsyncs."""
        out_names: List[str] = []
        writer: Optional[SSTWriter] = None
        written = 0
        for key, seq, vtype, value in stream:
            if writer is None:
                name = self._new_file_name()
                out_names.append(name)
                writer = SSTWriter(
                    os.path.join(self.path, name),
                    self.options.block_bytes,
                    self.options.compression,
                    self.options.bits_per_key,
                )
                written = 0
            writer.add(key, seq, vtype, value)
            written += len(key) + len(value)
            if written >= self.options.target_file_bytes:
                writer.finish()
                writer = None
                if io_budget is not None:
                    io_budget.throttle(written)
        if writer is not None:
            writer.finish()
            if io_budget is not None:
                io_budget.throttle(written)
        for name in out_names:
            self._readers[name] = SSTReader(os.path.join(self.path, name))
        return out_names

    # ------------------------------------------------------------------
    # batched full compaction (plan / install seam)
    # ------------------------------------------------------------------
    #
    # compact_range does plan → merge → install in one call, holding the
    # compaction mutex throughout. The cross-shard batched post-load
    # compaction (gpu/compaction_service.compact_dbs_batched) needs the
    # MERGE stage lifted out so many DBs' merges run in one padded device
    # call; these three methods expose exactly the plan/install halves
    # with the same locking discipline. A plan holds this DB's compaction
    # mutex until exactly one of install_full_compaction /
    # abort_full_compaction consumes it.

    def plan_full_compaction(self) -> Optional[dict]:
        """Flush, then snapshot a full-compaction plan (inputs + readers +
        target level). Returns None — and retains nothing — when there is
        nothing to compact. On a non-None return the caller OWNS the
        compaction mutex via the plan."""
        self.flush()
        self._compaction_mutex.acquire()
        try:
            with self._lock:
                self._check_open()
                bottom = self.options.num_levels - 1
                if self.options.allow_ingest_behind:
                    bottom -= 1
                inputs: List[str] = [
                    n for files in self._levels for n in files
                ]
                if not inputs:
                    self._compaction_mutex.release()
                    return None
                runs = [self._readers[n] for n in inputs]
            return {
                "inputs": inputs,
                "runs": runs,
                "bottom": bottom,
                "drop_tombstones": not self.options.allow_ingest_behind,
            }
        except BaseException:
            self._compaction_mutex.release()
            raise

    def snapshot_full_compaction(self) -> Optional[dict]:
        """Mutex-FREE sibling of :meth:`plan_full_compaction` for the
        disaggregated tier: flush, then snapshot the live
        input set WITHOUT taking the compaction mutex, so local L0
        picks and manual compact_range keep running while a worker
        merges off-node. The snapshot is only a CANDIDATE — before
        installing, the caller must win the mutex and revalidate via
        :meth:`begin_full_install`; a concurrent local compaction may
        have consumed (and GC'd) any of these inputs, in which case the
        remote result is discarded and the local outcome stands."""
        self.flush()
        with self._lock:
            self._check_open()
            bottom = self.options.num_levels - 1
            if self.options.allow_ingest_behind:
                bottom -= 1
            inputs: List[str] = [
                n for files in self._levels for n in files
            ]
            if not inputs:
                return None
            runs = [self._readers[n] for n in inputs]
        return {
            "inputs": inputs,
            "runs": runs,
            "bottom": bottom,
            "drop_tombstones": not self.options.allow_ingest_behind,
            "snapshot": True,
        }

    def begin_full_install(self, plan: dict) -> bool:
        """Win the compaction mutex for a SNAPSHOT plan's install and
        revalidate every input is still live (no local compaction
        consumed one while the remote merge ran). True: the caller now
        owns the mutex exactly as after :meth:`plan_full_compaction` —
        exactly one of install_full_compaction / abort_full_compaction
        must consume it. False: the snapshot is stale and NOTHING is
        held — the caller discards the remote outputs."""
        self._compaction_mutex.acquire()
        try:
            with self._lock:
                self._check_open()
                live = {n for files in self._levels for n in files}
                if not set(plan["inputs"]) <= live:
                    self._compaction_mutex.release()
                    return False
            return True
        except BaseException:
            self._compaction_mutex.release()
            raise

    def allocate_sst(self) -> Tuple[str, str]:
        """Reserve an SST file name for an external compaction sink;
        returns (name, absolute path). The file only becomes live when a
        later install names it (orphaned allocations are harmless)."""
        name = self._new_file_name()
        return name, os.path.join(self.path, name)

    def install_full_compaction(self, plan: dict, entries=None,
                                files: Optional[List[str]] = None,
                                arrays: Optional[Tuple[dict, int]] = None,
                                remote: bool = False,
                                ) -> None:
        """Swap in a plan's externally-merged outputs (manifest first,
        then input GC — the compact_range crash-safety order). Outputs
        come as merged ``entries`` tuples written here, as ``files``:
        names from :meth:`allocate_sst` whose SSTs the caller already
        wrote durably (the array-native batched sink), or as ``arrays``:
        a resolved ``(lanes, count)`` pair written here through the
        vectorized PLANAR sink with bulk blooms — no per-entry Python.
        An ``arrays`` install the planar layout can't express raises
        InvalidArgument (callers with mixed-width results unpack to
        ``entries`` instead). Consumes the plan's mutex."""
        try:
            fp.hit("compact.install")
            if files is not None:
                out_names = list(files)
                for name in out_names:
                    self._readers[name] = SSTReader(
                        os.path.join(self.path, name))
            elif arrays is not None:
                out_names = self._write_resolved_arrays(*arrays)
                if out_names is None:
                    raise InvalidArgument(
                        "install_full_compaction: arrays not planar-"
                        "expressible (non-uniform widths) — unpack to "
                        "entries for the tuple sink")
            else:
                out_names = self._write_entry_stream(
                    iter(entries), io_budget=self._io_budget)
            with self._lock:
                self._check_open()
                input_set = set(plan["inputs"])
                # L0 flushes that landed during the external merge stay
                for level_files in self._levels:
                    level_files[:] = [
                        n for n in level_files if n not in input_set]
                bottom = plan["bottom"]
                self._levels[bottom] = out_names + self._levels[bottom]
                self._note_compacted_locked(out_names, remote=remote)
                self._fences.clear()
                self._persist_manifest()
                self._gc_files(plan["inputs"])
        finally:
            self._compaction_mutex.release()

    def _write_resolved_arrays(self, lanes: dict,
                               count: int) -> Optional[List[str]]:
        """Write already-resolved lane arrays as PLANAR SSTs (split at
        target_file_bytes, bulk blooms) and register readers — the
        array-native install sink shared with the compaction backends.
        None when the planar layout can't express the rows."""
        from .native_compaction import write_resolved_lanes

        if count == 0:
            return []
        outputs = write_resolved_lanes(
            lanes, count, self.allocate_sst_path,
            self.options.block_bytes, self.options.compression,
            self.options.bits_per_key, self.options.target_file_bytes,
            io_budget=self._io_budget,
        )
        if outputs is None:
            return None
        names: List[str] = []
        for path, _props in outputs:
            name = os.path.basename(path)
            self._readers[name] = SSTReader(path)
            names.append(name)
        return names

    def allocate_sst_path(self) -> str:
        """path_factory form of :meth:`allocate_sst` (the array sinks
        take a zero-arg callable returning an absolute path)."""
        return self.allocate_sst()[1]

    def abort_full_compaction(self, plan: dict) -> None:
        """Release a plan without installing (external merge declined or
        failed); the DB is untouched and compact_range remains safe."""
        self._compaction_mutex.release()

    def set_remote_compactor(self, manager) -> None:
        """Attach (or detach with None) a disaggregated-compaction
        manager (compaction_remote.RemoteCompactionManager). Non-manual
        background picks then publish to the worker tier before falling
        back to the local merge — see _compaction_loop."""
        with self._lock:
            self._remote_compactor = manager

    def _remove_dead_files(
        self, dead: List[Tuple[str, Optional[SSTReader]]]
    ) -> None:
        """Close + unlink files already dropped from self._readers. Needs
        no lock — callers pop the readers under self._lock first."""
        for name, reader in dead:
            if reader is not None:
                reader.close()
            try:
                os.remove(os.path.join(self.path, name))
            except OSError:
                pass

    def _gc_files(self, names: List[str]) -> None:
        self._remove_dead_files(
            [(name, self._readers.pop(name, None)) for name in names])

    def _discard_outputs(self, out_names: List[str]) -> None:
        """Sweep never-installed compaction outputs after an install-
        phase fault: close + drop their readers and unlink the files
        (nothing references them — the manifest was never written)."""
        with self._lock:
            dead = [(n, self._readers.pop(n, None)) for n in out_names]
        self._remove_dead_files(dead)

    # ------------------------------------------------------------------
    # properties (application_db.cpp:183-225)
    # ------------------------------------------------------------------

    def get_property(self, name: str) -> Optional[str]:
        # accept rocksdb's property namespace ("rocksdb.num-files-at-
        # level0") so reference callers port unchanged
        if name.startswith("rocksdb."):
            name = name[len("rocksdb."):]
        with self._lock:
            if name == "num-levels":
                return str(self.options.num_levels)
            if name == "highest-empty-level":
                # Highest (deepest) level index that is empty along with all
                # levels above... reference semantics: the highest level L
                # such that levels L..Lmax hold no files ⇒ safe ingest-behind.
                highest = -1
                for i in range(self.options.num_levels - 1, -1, -1):
                    if not self._levels[i]:
                        highest = i
                    else:
                        break
                return str(highest)
            if name.startswith("num-files-at-level"):
                level = int(name[len("num-files-at-level"):])
                if 0 <= level < len(self._levels):
                    return str(len(self._levels[level]))
                return "0"
            if name == "estimate-num-keys":
                total = len(self._mem) + sum(
                    r.props.get("num_keys", 0) for r in self._readers.values()
                )
                return str(total)
            if name == "total-sst-bytes":
                total = 0
                for files in self._levels:
                    for n in files:
                        try:
                            total += os.path.getsize(os.path.join(self.path, n))
                        except OSError:
                            pass
                return str(total)
            return None

    def approximate_disk_size(self) -> int:
        return int(self.get_property("total-sst-bytes") or 0)

    # ------------------------------------------------------------------
    # introspection gauges (the observability plane's inputs)
    # ------------------------------------------------------------------

    def metrics_snapshot(self, max_age: float = 0.5) -> Dict:
        """One consistent cut of the engine's pull-model gauge inputs,
        computed in ONE pass under the DB lock (file sizes are cached on
        the readers — no filesystem IO under the lock) and cached for
        ``max_age`` seconds so a /metrics dump evaluating a dozen per-db
        gauges pays one lock pass, not one per gauge. These are the
        foreground-pressure signals the workload-adaptive compaction
        scheduler and the per-shard rebalancer consume (ROADMAP)."""
        now = time.monotonic()
        cached_at, cached = self._metrics_cache
        if cached is not None and now - cached_at < max_age:
            return cached
        opts = self.options
        with self._lock:
            if self._closed:
                return cached or {}
            level_files = [len(files) for files in self._levels]
            level_bytes = [
                sum(self._readers[n].file_size for n in files
                    if n in self._readers)
                for files in self._levels
            ]
            # compaction debt: bytes above each level's target. L0's
            # target is the compaction trigger expressed in bytes (files
            # beyond the trigger, at the level's mean file size); deeper
            # levels use the rocksdb-style base * multiplier^(L-1).
            debt = [0] * len(self._levels)
            if level_files[0] > opts.level0_compaction_trigger:
                mean = level_bytes[0] / max(1, level_files[0])
                debt[0] = int(
                    (level_files[0] - opts.level0_compaction_trigger) * mean)
            target = opts.max_bytes_for_level_base
            for lvl in range(1, len(self._levels)):
                debt[lvl] = max(0, level_bytes[lvl] - target)
                target *= opts.max_bytes_for_level_multiplier
            mem_bytes = self._mem.approximate_bytes() + sum(
                m.approximate_bytes() for m in self._imms)
            unflushed_seqs = max(0, self._last_seq - self._persisted_seq)
            gets = self._gets_total
            consulted = self._files_consulted_total
            flushed = self._bytes_flushed_total
            compacted = self._bytes_compacted_total
            remote_offloaded = self._remote_offloaded_bytes_total
            compaction_peak = self._compaction_peak_bytes
        # WAL backlog sized OUTSIDE the lock (directory listing is IO);
        # the segment set is append/purge-only so a racing purge at
        # worst under-counts one segment
        wal_bytes = 0
        try:
            with os.scandir(self._wal_dir) as it:
                for entry in it:
                    try:
                        wal_bytes += entry.stat().st_size
                    except OSError:
                        continue
        except OSError:
            pass
        snap = {
            "level_files": level_files,
            "level_bytes": level_bytes,
            "compaction_debt_bytes": debt,
            "memtable_bytes": mem_bytes,
            "wal_backlog_bytes": wal_bytes,
            "unflushed_seqs": unflushed_seqs,
            "read_amp": (consulted / gets) if gets else 0.0,
            "write_amp": (compacted / flushed) if flushed else 0.0,
            "gets_total": gets,
            "files_consulted_total": consulted,
            "bytes_flushed_total": flushed,
            "bytes_compacted_total": compacted,
            "bytes_compacted_local_total": compacted - remote_offloaded,
            "remote_offloaded_bytes_total": remote_offloaded,
            "compaction_peak_bytes_materialized": compaction_peak,
        }
        self._metrics_cache = (now, snap)
        return snap

    def set_options(self, updates: Dict[str, object]) -> None:
        """Runtime-mutable options (reference setDBOptions,
        admin_handler.cpp:2134-2158)."""
        from ..utils.flags import _coerce

        with self._lock:
            # validate EVERY key before applying ANY: a partial apply
            # followed by InvalidArgument would mutate predicates the
            # parked background loops never get notified about
            for k in updates:
                if k not in DBOptions.MUTABLE:
                    raise InvalidArgument(f"option not mutable: {k}")
            for k, v in updates.items():
                current = getattr(self.options, k)
                if current is None or v is None:
                    # Optional[str] knobs (retain_lo/retain_hi): no
                    # current type to coerce to; "" clears the bound
                    setattr(self.options, k,
                            None if v in (None, "") else str(v))
                else:
                    # _coerce handles "false"→False etc. (same class of
                    # bug as flags string coercion).
                    setattr(self.options, k, _coerce(v, type(current)))
            if ("compaction_budget_bytes_per_sec" in updates
                    and self._io_budget is not None):
                self._io_budget.set_rate(
                    self.options.compaction_budget_bytes_per_sec)
            # wake the background loops: their wait predicates read
            # mutable options (e.g. disable_auto_compaction toggled off
            # must start the parked compactor now, not on the next write)
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # checkpoint / ingest / destroy
    # ------------------------------------------------------------------

    def checkpoint(self, checkpoint_dir: str) -> int:
        """Consistent on-disk snapshot via hardlinks (rocksdb::Checkpoint).
        Flushes first so the checkpoint is WAL-free, like the reference's
        checkpoint-backup path (admin_handler.cpp:996-1129). Returns the
        sequence number the snapshot actually contains, captured under the
        DB lock — writes landing after this call are not in the snapshot."""
        with start_span("storage.checkpoint") as sp, self._lock:
            self._check_open()
            # drain any in-flight background flush, then flush synchronously
            with start_span("checkpoint.flush"):
                self._drain_imm_locked()
                self._flush_locked()
            if os.path.exists(checkpoint_dir):
                raise InvalidArgument(f"checkpoint dir exists: {checkpoint_dir}")
            os.makedirs(checkpoint_dir)
            nfiles = 0
            with start_span("checkpoint.link"):
                for files in self._levels:
                    for name in files:
                        src = os.path.join(self.path, name)
                        dst = os.path.join(checkpoint_dir, name)
                        try:
                            os.link(src, dst)
                        except OSError:
                            # rstpu-check: allow(blocking-under-lock) cross-device fallback only; the checkpoint's file set + manifest must be one consistent cut under the lock
                            shutil.copyfile(src, dst)
                        nfiles += 1
                self._persist_manifest(target_dir=checkpoint_dir)
            sp.annotate(files=nfiles, seq=self._last_seq)
            return self._last_seq

    def ingest_external_file(
        self,
        sst_paths: List[str],
        move_files: bool = False,
        allow_global_seqno: bool = True,
        ingest_behind: bool = False,
        validated: bool = False,
    ) -> None:
        """IngestExternalFile parity (admin_handler.cpp:1819-1827).

        Normal ingest: file gets global_seqno = last_seq+1 and lands in L0.
        ingest_behind: file lands in the bottom level with global_seqno 0
        (older than everything); requires ``allow_ingest_behind`` and an
        empty bottom level (the DBLmaxEmpty check).

        ``validated=True``: the caller already format/checksum-probed every
        file (the admin handler's pre-lock validate stage) — skip the
        per-file SSTReader probe here so it doesn't run under the DB lock.
        """
        with self._lock:
            self._check_open()
            if ingest_behind:
                if not self.options.allow_ingest_behind:
                    raise InvalidArgument("db not opened with allow_ingest_behind")
                if self._levels[-1]:
                    raise InvalidArgument("bottom level not empty")
            new_names: List[str] = []
            # Both ingest modes rewrite the adopted file's footer in place
            # (global seqno). A multiply-linked source (the object store's
            # zero-copy download path hands out hardlinks to the bucket
            # object) must therefore be adopted by COPY, or the rewrite
            # would mutate the shared inode — i.e. corrupt the bucket.
            will_rewrite = ingest_behind or allow_global_seqno
            try:
                fp.hit("engine.ingest")
                for src in sst_paths:
                    if not validated:
                        probe = SSTReader(src)  # validates format
                        probe.close()
                    name = self._new_file_name()
                    dst = os.path.join(self.path, name)
                    if move_files:
                        if will_rewrite and os.stat(src).st_nlink > 1:
                            # copy-or-fail: a rename fallback would keep
                            # the shared inode and re-open the bucket-
                            # corruption hole this branch exists to close
                            # rstpu-check: allow(blocking-under-lock) rare nlink>1 fallback; admin pre-breaks links outside every lock (handler.validate), so this copy under the db lock is the last-resort safety net
                            shutil.copyfile(src, dst)
                            os.remove(src)
                        else:
                            try:
                                os.link(src, dst)
                                os.remove(src)
                            except OSError:
                                shutil.move(src, dst)
                    else:
                        # rstpu-check: allow(blocking-under-lock) ingest file materialization must be atomic vs readers/seq allocation; per-shard only, so other dbs are unaffected
                        shutil.copyfile(src, dst)
                    new_names.append(name)
            except (OSError, Corruption) as e:
                self._gc_files(new_names)
                raise StorageError(f"ingest failed: {e}") from e
            if ingest_behind:
                # rstpu-check: allow(blocking-under-lock) footer rewrite+fsync must complete before the file set becomes visible; crash matrix (test_failpoints) pins the pre/post-ingest atomicity this ordering provides
                self._set_global_seqnos(new_names, 0)
                # Bottom level must stay sorted & non-overlapping.
                readers = [self._readers_open(n) for n in new_names]
                readers.sort(key=lambda r: r.min_key() or b"")
                ordered = [os.path.basename(r._path) for r in readers]
                for a, b in zip(readers, readers[1:]):
                    if a.max_key() and b.min_key() and a.max_key() >= b.min_key():
                        self._gc_files(new_names)
                        raise InvalidArgument("ingest_behind files overlap")
                self._levels[-1] = ordered
                self._fences.clear()
            else:
                # The ingested file is newer than everything current, so the
                # memtable — and any in-flight background flush, which would
                # otherwise land in L0 ABOVE the ingested file — must be
                # flushed below it first (RocksDB flushes on overlapping
                # ingest for the same reason). The manifest persist is
                # deferred to THIS method's final persist (one durable
                # manifest write covers flush + ingest), with the WAL purge
                # re-run below once that manifest is down.
                self._drain_imm_locked()
                if len(self._mem):
                    self._flush_locked(defer_manifest=True)
                if allow_global_seqno:
                    self._last_seq += 1
                    # rstpu-check: allow(blocking-under-lock) the global seqno is allocated from _last_seq under the lock and must be durable in the footer before install — releasing mid-rewrite would let a racing write reuse the seq
                    self._set_global_seqnos(new_names, self._last_seq)
                    self._persisted_seq = max(self._persisted_seq, self._last_seq)
                else:
                    for name in new_names:
                        # no footer rewrite on this branch — fsync the
                        # copied pages before the manifest names the file
                        # (ingested data has no WAL to replay)
                        with open(os.path.join(self.path, name), "rb") as f:
                            # rstpu-check: allow(blocking-under-lock) ingested pages must be durable before the manifest names the file (no WAL covers them); ingest is rare and per-shard
                            os.fsync(f.fileno())
                        self._readers_open(name)
                self._levels[0].extend(new_names)
                # the parked compactor's predicate reads len(levels[0])
                self._cond.notify_all()
            self._persist_manifest()
            if not ingest_behind and self.options.wal_archive_sink is None:
                # the deferred flush's purge: only now that the manifest
                # naming the flushed SST is durable is dropping the WAL
                # entries it covers safe
                wal_mod.purge_obsolete(
                    self._wal_dir, self._persisted_seq,
                    self.options.wal_ttl_seconds,
                )

    def _readers_open(self, name: str) -> SSTReader:
        if name not in self._readers:
            self._readers[name] = SSTReader(os.path.join(self.path, name))
        return self._readers[name]

    def _set_global_seqnos(self, names: List[str], seqno: int) -> None:
        """Rewrite the footer global_seqno in place (RocksDB does exactly
        this — a pwrite into the ingested file's seqno slot)."""
        from .sst import _FOOTER, FLAG_HAS_GLOBAL_SEQNO, MAGIC

        for name in names:
            fp.hit("sst.ingest_footer")
            path = os.path.join(self.path, name)
            with open(path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(size - _FOOTER.size)
                fields = list(_FOOTER.unpack(f.read(_FOOTER.size)))
                fields[3] = seqno
                fields[6] |= FLAG_HAS_GLOBAL_SEQNO
                f.seek(size - _FOOTER.size)
                f.write(_FOOTER.pack(*fields))
                # ingested data was never in the WAL: the copy AND this
                # footer rewrite must be durable before the manifest
                # references the file (same invariant as SSTWriter.finish)
                f.flush()
                os.fsync(f.fileno())
            old = self._readers.pop(name, None)
            if old is not None:
                old.close()
            self._readers[name] = SSTReader(path)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def close(self) -> None:
        # Stop the background thread first (it drains a pending imm before
        # exiting), then tear down under the lock.
        with self._lock:
            if self._closed:
                return
            self._bg_stop = True
            self._cond.notify_all()
        if self._bg_thread is not None:
            self._bg_thread.join(timeout=30.0)
            self._bg_thread = None
        if self._compaction_thread is not None:
            self._compaction_thread.join(timeout=60.0)
            self._compaction_thread = None
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
            if self._wal is not None:
                self._wal.close()
            for reader in self._readers.values():
                reader.close()
            self._readers.clear()

    def _check_open(self) -> None:
        if self._closed:
            raise StorageError("db is closed")

    def __enter__(self) -> "DB":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def destroy_db(path: str) -> None:
    """DestroyDB parity (clearDB path, admin_handler.cpp:1774-1817)."""
    if os.path.isdir(path):
        shutil.rmtree(path)


# ---------------------------------------------------------------------------
# pull-model gauge registration (reference stats.h pull gauges)
# ---------------------------------------------------------------------------

# per-level families (tagged db=<name> level=<L>)
DB_LEVEL_GAUGES = (
    "storage.level_files",
    "storage.level_bytes",
    "storage.compaction_debt_bytes",
)
# scalar families (tagged db=<name>)
DB_SCALAR_GAUGES = {
    "storage.memtable_bytes": "memtable_bytes",
    "storage.wal_backlog_bytes": "wal_backlog_bytes",
    "storage.unflushed_seqs": "unflushed_seqs",
    "storage.read_amp": "read_amp",
    "storage.write_amp": "write_amp",
    # high-water of live lane bytes during the most recent compaction
    # merge — the streaming bounded-memory pipeline's load-bearing
    # ceiling proof (stream_merge.CompactionMemoryBudget)
    "compaction.peak_bytes_materialized":
        "compaction_peak_bytes_materialized",
    # disaggregated tier: the serving-shaped pair — output
    # bytes this node's own compactions wrote vs bytes workers produced.
    # Tier-on acceptance drives local_output_bytes → ~0.
    "compaction.local_output_bytes": "bytes_compacted_local_total",
    "compaction.remote_offloaded_bytes": "remote_offloaded_bytes_total",
}
_LEVEL_GAUGE_KEYS = {
    "storage.level_files": "level_files",
    "storage.level_bytes": "level_bytes",
    "storage.compaction_debt_bytes": "compaction_debt_bytes",
}


def register_db_gauges(name: str, db: DB,
                       stats: Optional[Stats] = None,
                       **extra_tags: str) -> List[str]:
    """Register this shard's engine gauges on the process Stats registry
    (pull-model: each callback reads the db's cached metrics_snapshot).
    ``extra_tags`` (e.g. port=...) disambiguate multi-replicator test
    processes where several engines carry the same shard name. Returns
    the registered gauge names for :func:`unregister_db_gauges`."""
    from ..utils.stats import tagged

    stats = stats or Stats.get()
    names: List[str] = []

    def add(gname: str, cb) -> None:
        stats.add_gauge(gname, cb)
        names.append(gname)

    for family in DB_LEVEL_GAUGES:
        key = _LEVEL_GAUGE_KEYS[family]
        for lvl in range(db.options.num_levels):
            def cb(key=key, lvl=lvl) -> float:
                vals = db.metrics_snapshot().get(key) or []
                return float(vals[lvl]) if lvl < len(vals) else 0.0
            add(tagged(family, db=name, level=str(lvl), **extra_tags), cb)
    for family, key in DB_SCALAR_GAUGES.items():
        def cb(key=key) -> float:
            return float(db.metrics_snapshot().get(key) or 0.0)
        add(tagged(family, db=name, **extra_tags), cb)
    # process-global: registered idempotently alongside any db (the
    # decoded-block cache is process-wide)
    stats.add_gauge("storage.block_cache.hit_rate", _block_cache_hit_rate)
    return names


def unregister_db_gauges(names: List[str],
                         stats: Optional[Stats] = None) -> None:
    stats = stats or Stats.get()
    for gname in names:
        stats.remove_gauge(gname)


def _block_cache_hit_rate() -> float:
    s = Stats.get()
    hits = s.get_counter("storage.block_cache.hit")
    misses = s.get_counter("storage.block_cache.miss")
    total = hits + misses
    return hits / total if total else 0.0
