"""The memory-budget streaming merge — counterpart of
``rocksplicator_tpu/storage/stream_merge.py``.

The in-RAM compaction route decodes every input run before it resolves.
This pipeline holds a fixed budget whatever the level's size:

- each input run is read through a lane *window*
  (``gpu/format.SstBlockLaneSource``: block-granular decode on demand);
- the merge advances in *chunks*: the cut key is the least loaded frontier
  over runs with undecoded blocks, so every key strictly below it is fully
  loaded in every run and one resolve sees each key's whole entry stack;
  each key resolves as it would in one pass;
- a key group that spans a window end (a long MERGE-operand chain, a
  stack of one key at many seqs) is CARRIED raw across the chunk boundary
  and resolved with the rest of its group once the cut passes the key;
- resolved chunks stream into a per-file buffer that splits files where
  the in-RAM sink does (the same lazy width derivation and entries per
  file), so the files are the same bytes;
- a chunk resolver runs the resolve: ``CpuChunkResolver`` on the host,
  ``gpu/compaction_service.GpuChunkResolver`` on the card, one chunk
  behind the decode.

The ceiling holds: ``CompactionMemoryBudget`` (``RSTPU_COMPACT_MEM_BUDGET``,
or a DB's ``compaction_memory_budget_bytes``) sizes the windows, windows
shrink while the process is over budget (they degrade to one block, never
abort), and a ``MemTracker`` records the compaction's high-water mark.
Every output is swept when the pipeline raises or declines, so nothing is
installed unless the whole merge finishes.

The span ``compact.stream``, the failpoints ``compact.stream.chunk`` and
``compact.stream.refill`` and the Stats counters
``compaction.stream_chunks``, ``stream_merges``, ``stream_refills`` and
``stream_declines`` are the JAX package's, at its sites, in the port's own
collector, registry and Stats.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ..observability.span import start_span
from ..ops.kv_format import LANE_FIELDS as FIELDS
from ..ops.kv_format import UnsupportedBatch
from ..testing import failpoints as fp
from ..utils.stats import Stats

_PUT, _DELETE, _MERGE = 1, 2, 3

# window and chunk lanes carry both key byte orders (the card's resolver
# returns LE words for bloom hashing); the CPU resolver concatenates only
# CPU_FIELDS
CPU_FIELDS = tuple(f for f in FIELDS if f != "key_words_le")

# --- knobs ---------------------------------------------------------------
# per-refill window target in entries; the chunk the resolver sees is
# roughly nruns windows
ENV_CHUNK_ENTRIES = "RSTPU_COMPACT_CHUNK_ENTRIES"
DEFAULT_CHUNK_ENTRIES = 1 << 16
# process-wide hard ceiling on live compaction lane bytes
ENV_MEM_BUDGET = "RSTPU_COMPACT_MEM_BUDGET"
DEFAULT_MEM_BUDGET = 256 << 20
# "auto" streams when the projected in-RAM working set exceeds the budget
# (or the direct path's entry cap); "1"/"always" streams every streamable
# full compaction; "0"/"never" disables streaming
ENV_STREAM_MODE = "RSTPU_COMPACT_STREAM"
# window degradation floor (block granularity still applies above it)
MIN_WINDOW_ENTRIES = 256

# test overrides of the env knobs
STREAM_MODE_OVERRIDE: Optional[str] = None
CHUNK_ENTRIES_OVERRIDE: Optional[int] = None


def stream_mode() -> str:
    if STREAM_MODE_OVERRIDE is not None:
        return STREAM_MODE_OVERRIDE
    raw = os.environ.get(ENV_STREAM_MODE, "auto").lower()
    if raw in ("0", "never", "false"):
        return "never"
    if raw in ("1", "always", "true"):
        return "always"
    return "auto"


def default_chunk_entries() -> int:
    if CHUNK_ENTRIES_OVERRIDE is not None:
        return int(CHUNK_ENTRIES_OVERRIDE)
    try:
        return max(MIN_WINDOW_ENTRIES,
                   int(os.environ.get(ENV_CHUNK_ENTRIES,
                                      DEFAULT_CHUNK_ENTRIES)))
    except ValueError:
        return DEFAULT_CHUNK_ENTRIES


class _StreamDecline(Exception):
    """The inputs turned out inexpressible mid-stream (width drift, a
    MERGE record without an operator, a chunk the kernel flags for the
    CPU): every written output is swept and the caller takes the in-RAM
    route."""


class CompactionMemoryBudget:
    """Process-wide ceiling on live compaction lane bytes. One instance
    serves every compaction in the process; per-compaction accounting
    hangs off :meth:`tracker`."""

    _instance: Optional["CompactionMemoryBudget"] = None
    _instance_lock = threading.Lock()

    def __init__(self, budget_bytes: int):
        self.budget_bytes = max(1, int(budget_bytes))
        self._lock = threading.Lock()
        self._live = 0

    @classmethod
    def get(cls) -> "CompactionMemoryBudget":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    try:
                        cap = int(os.environ.get(
                            ENV_MEM_BUDGET, DEFAULT_MEM_BUDGET))
                    except ValueError:
                        cap = DEFAULT_MEM_BUDGET
                    cls._instance = cls(cap)
        return cls._instance

    @classmethod
    def reset_for_test(cls, budget_bytes: Optional[int] = None) -> None:
        with cls._instance_lock:
            cls._instance = (
                cls(budget_bytes) if budget_bytes is not None else None)

    def _add(self, nbytes: int) -> None:
        with self._lock:
            self._live += nbytes

    def _sub(self, nbytes: int) -> None:
        with self._lock:
            self._live -= nbytes

    def live_bytes(self) -> int:
        with self._lock:
            return self._live

    def tracker(self) -> "MemTracker":
        return MemTracker(self)


class MemTracker:
    """Per-compaction view of the process budget: live bytes, the
    high-water mark, and release back to the process counter on close().
    The pipeline takes either package's tracker (``add``, ``sub``,
    ``process_live``, ``budget_bytes``, ``close``, ``peak``)."""

    def __init__(self, budget: CompactionMemoryBudget):
        self._budget = budget
        self._lock = threading.Lock()
        self.live = 0
        self.peak = 0

    def add(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._lock:
            self.live += nbytes
            if self.live > self.peak:
                self.peak = self.live
        self._budget._add(nbytes)

    def sub(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._lock:
            self.live -= nbytes
        self._budget._sub(nbytes)

    def process_live(self) -> int:
        return self._budget.live_bytes()

    @property
    def budget_bytes(self) -> int:
        return self._budget.budget_bytes

    def close(self) -> None:
        """Release any residual accounting (windows alive at pipeline
        exit) back to the process counter; the peak stays."""
        with self._lock:
            residual, self.live = self.live, 0
        if residual:
            self._budget._sub(residual)


def _lanes_nbytes(lanes: dict) -> int:
    return int(sum(np.asarray(a).nbytes for a in lanes.values()))


def _lanes_nbytes_list(parts: List[dict]) -> int:
    return int(sum(_lanes_nbytes(p) for p in parts))


def _row_key(win: dict, i: int, klen: int) -> bytes:
    return win["key_words_be"][i].astype(">u4").tobytes()[:klen]


def _first_ge(win: dict, lo: int, hi: int, key: bytes, klen: int) -> int:
    while lo < hi:
        mid = (lo + hi) // 2
        if _row_key(win, mid, klen) < key:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _first_gt(win: dict, lo: int, hi: int, key: bytes, klen: int) -> int:
    while lo < hi:
        mid = (lo + hi) // 2
        if _row_key(win, mid, klen) <= key:
            lo = mid + 1
        else:
            hi = mid
    return lo


class _RunCursor:
    """One input run's decode window: a block-granular slice of its lanes,
    refilled as the merge frontier drains it."""

    def __init__(self, source, vw: int, klen: int, tracker):
        self._src = source
        self._vw = vw
        self._klen = klen
        self._tracker = tracker
        self._next_block = 0
        self._win: Optional[dict] = None
        self._pos = 0
        self._n = 0
        self.win_bytes = 0

    @property
    def file_done(self) -> bool:
        return self._next_block >= self._src.num_blocks

    @property
    def empty(self) -> bool:
        return self._pos >= self._n

    def refill(self, target_entries: int) -> int:
        """Replace the drained window with >= target_entries fresh rows
        (whole blocks; only called on an EMPTY cursor). Returns the byte
        count of the RETIRED window: the pipeline releases it once the
        in-flight chunk holding views of it has been collected."""
        fp.hit("compact.stream.refill")
        Stats.get().incr("compaction.stream_refills")
        parts: List[dict] = []
        rows = 0
        while self._next_block < self._src.num_blocks \
                and rows < target_entries:
            lanes = self._src.decode_blocks(
                self._next_block, self._next_block + 1)
            self._next_block += 1
            w = lanes["val_words"].shape[1]
            if w < self._vw:
                lanes["val_words"] = np.pad(
                    lanes["val_words"], [(0, 0), (0, self._vw - w)])
            rows += lanes["key_len"].shape[0]
            parts.append(lanes)
        retired = self.win_bytes
        if len(parts) == 1:
            self._win = parts[0]
        else:
            self._win = {f: np.concatenate([p[f] for p in parts])
                         for f in FIELDS}
        self._pos = 0
        self._n = self._win["key_len"].shape[0]
        self.win_bytes = _lanes_nbytes(self._win)
        self._tracker.add(self.win_bytes)
        return retired

    def frontier_key(self) -> bytes:
        """Last loaded key: every undecoded row of this run is >= it."""
        return _row_key(self._win, self._n - 1, self._klen)

    def take_lt(self, cut: Optional[bytes]) -> Optional[dict]:
        """Consume rows with key < cut (all remaining rows when cut is
        None) as views of the window, or None."""
        if self.empty:
            return None
        hi = self._n if cut is None else _first_ge(
            self._win, self._pos, self._n, cut, self._klen)
        if hi <= self._pos:
            return None
        sl = {f: self._win[f][self._pos:hi] for f in FIELDS}
        self._pos = hi
        return sl

    def take_eq(self, cut: bytes) -> Optional[dict]:
        """Consume rows with key == cut as a COPY (carried rows must not
        pin a window the next refill retires)."""
        if self.empty:
            return None
        lo = _first_ge(self._win, self._pos, self._n, cut, self._klen)
        hi = _first_gt(self._win, lo, self._n, cut, self._klen)
        if hi <= lo:
            return None
        sl = {f: self._win[f][lo:hi].copy() for f in FIELDS}
        self._pos = hi
        return sl

    def release(self) -> None:
        self._tracker.sub(self.win_bytes)
        self.win_bytes = 0
        self._win = None


class CpuChunkResolver:
    """The host merge-resolve (the native library's where it is loaded,
    numpy's otherwise), run synchronously: one chunk in flight at a
    time (``pipelined = False``: the pipeline collects each chunk at once,
    so consumed windows release before the next refill)."""

    fields = CPU_FIELDS
    pipelined = False

    def submit(self, parts: List[dict], lanes: dict, total: int, vw: int,
               merge_op, drop_tombstones: bool):
        from .native_compaction import NativeCompactionBackend

        return NativeCompactionBackend._resolve(
            parts, lanes, total, vw, merge_op, drop_tombstones)

    def collect(self, handle) -> Tuple[dict, int]:
        return handle


class _FileBufferSink:
    """Streaming output sink with the in-RAM sink's bytes: resolved chunks
    buffer per OUTPUT FILE (bounded by target_file_bytes, not by the
    dataset) and each file writes through the same planar writer and bulk
    bloom with the same width derivation — klen from the first resolved
    row, vlen from the first non-delete resolved row — so file splits and
    bytes match the unsliced pass."""

    def __init__(self, path_factory, block_bytes: int, compression: int,
                 bits_per_key: int, target_file_bytes: int, tracker,
                 io_budget=None, plan_klen: int = 0, plan_vlen: int = 0):
        self._pf = path_factory
        self._block_bytes = block_bytes
        self._compression = compression
        self._bits_per_key = bits_per_key
        self._target_file_bytes = target_file_bytes
        self._tracker = tracker
        self._io_budget = io_budget
        self._plan_klen = plan_klen
        self._plan_vlen = plan_vlen
        self._buf: List[dict] = []
        self._buf_rows = 0
        self._buf_bytes = 0
        self._klen: Optional[int] = None
        self._vlen: Optional[int] = None
        self._epf = 0  # entries per file, once widths are known
        self._block_entries = 0
        self.outputs: List[Tuple[str, dict]] = []

    def _derive_widths(self, arrays: dict, count: int) -> None:
        from ..gpu.format import planar_stride

        if self._klen is None and count:
            self._klen = int(arrays["key_len"][0])
        if self._vlen is None:
            non_del = np.flatnonzero(arrays["vtype"][:count] != _DELETE)
            if len(non_del):
                self._vlen = int(arrays["val_len"][int(non_del[0])])
        if self._klen is not None and self._vlen is not None \
                and not self._epf:
            stride = planar_stride(self._klen, self._vlen)
            self._epf = max(
                1024, self._target_file_bytes // max(1, stride))
            self._block_entries = max(
                64, self._block_bytes // max(1, stride))

    def append(self, arrays: dict, count: int) -> None:
        if count == 0:
            return
        # trimmed rows COPY out of the resolver's chunk-sized output: a
        # [:count] view would pin the whole (padded) base allocation while
        # the tracker counted only the view. count == base rows keeps the
        # whole array.
        sub = {}
        for f in CPU_FIELDS:
            a = np.asarray(arrays[f])
            sub[f] = a if a.shape[0] == count else a[:count].copy()
        self._buf.append(sub)
        self._buf_rows += count
        nb = _lanes_nbytes(sub)
        self._buf_bytes += nb
        self._tracker.add(nb)
        self._derive_widths(sub, count)
        # vlen stays unknown while the resolved stream is all tombstones
        # (drop_tombstones=False): buffer until a value appears, as the
        # unsliced pass derives vlen from the SAME first non-delete row.
        # Once a full file's worth is buffered (by the PLANNED value width,
        # which every later non-delete row is checked to match), seed vlen
        # from the plan, so the wait cannot defeat the ceiling. A stream
        # with a value anywhere keeps its bytes; only an all-tombstone
        # output larger than one file splits by the planned width.
        if not self._epf and self._vlen is None:
            from ..gpu.format import planar_stride

            stride = planar_stride(self._plan_klen, self._plan_vlen)
            plan_epf = max(1024,
                           self._target_file_bytes // max(1, stride))
            if self._buf_rows >= plan_epf:
                self._vlen = self._plan_vlen
                self._derive_widths(sub, count)
        while self._epf and self._buf_rows >= self._epf:
            self._flush_file(self._epf)

    def _pop_rows(self, n: int) -> dict:
        taken: List[dict] = []
        need = n
        while need > 0:
            head = self._buf[0]
            hn = head["key_len"].shape[0]
            if hn <= need:
                taken.append(self._buf.pop(0))
                need -= hn
            else:
                taken.append({f: head[f][:need] for f in CPU_FIELDS})
                self._buf[0] = {f: head[f][need:] for f in CPU_FIELDS}
                need = 0
        self._buf_rows -= n
        if len(taken) == 1:
            return taken[0]
        return {f: np.concatenate([p[f] for p in taken])
                for f in CPU_FIELDS}

    def _flush_file(self, n: int) -> None:
        from ..gpu.format import write_sst_from_arrays
        from .native_compaction import bulk_bloom

        sub = self._pop_rows(n)
        bloom = bulk_bloom(sub, n, self._klen, self._bits_per_key)
        path = self._pf()
        props = write_sst_from_arrays(
            sub, n, path, bloom_words=bloom.words,
            block_entries=self._block_entries,
            compression=self._compression,
            bits_per_key=self._bits_per_key, planar=True)
        if props is None:
            # widths the planar layout cannot hold slipped past the window
            # checks: decline, the caller takes the in-RAM route
            raise _StreamDecline("planar sink declined a file slice")
        self.outputs.append((path, props))
        # written rows leave the buffer
        remaining = _lanes_nbytes_list(self._buf)
        self._tracker.sub(self._buf_bytes - remaining)
        self._buf_bytes = remaining
        if self._io_budget is not None:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            if size:
                self._io_budget.throttle(size)

    def finish(self) -> List[Tuple[str, dict]]:
        if self._buf_rows:
            if not self._epf:
                # an all-tombstone resolved stream (kept tombstones, no
                # values): vlen degenerates to 0, as in the unsliced pass
                self._vlen = 0 if self._vlen is None else self._vlen
                self._klen = (int(self._buf[0]["key_len"][0])
                              if self._klen is None else self._klen)
                self._derive_widths(self._buf[0],
                                    self._buf[0]["key_len"].shape[0])
            while self._buf_rows > self._epf:
                self._flush_file(self._epf)
            if self._buf_rows:
                self._flush_file(self._buf_rows)
        return self.outputs

    def abandon(self) -> None:
        """Sweep every written output (nothing else would remove them)."""
        self._tracker.sub(self._buf_bytes)
        self._buf = []
        self._buf_bytes = 0
        self._buf_rows = 0
        for p, _ in self.outputs:
            try:
                os.remove(p)
            except OSError:
                pass
        self.outputs = []


def _check_chunk_semantics(lanes: dict, merge_op) -> None:
    """The in-RAM route's resolvability checks, per chunk (probes promise
    widths; vtypes can only be checked once decoded)."""
    if merge_op is None:
        if bool((lanes["vtype"] == _MERGE).any()):
            raise _StreamDecline("MERGE records without an operator")
    else:
        is_del = lanes["vtype"] == _DELETE
        vl = lanes["val_len"][~is_del]
        if len(vl) and not (vl == 8).all():
            raise _StreamDecline("uint64add needs 8-byte values")


def plan_stream(runs, merge_op):
    """Probe every run for block-granular streamability. Returns
    (sources, total, klen, vlen, vw), or None when a run cannot stream or
    the runs' widths differ (the in-RAM route decides for itself)."""
    from ..gpu.format import SstBlockLaneSource

    sources = []
    for run in runs:
        if not hasattr(run, "iterate"):
            return None
        src = SstBlockLaneSource.probe(run)
        if src is None:
            return None
        sources.append(src)
    if not sources:
        return None
    klens = {s.klen for s in sources}
    vlens = {s.vlen for s in sources}
    if len(klens) != 1 or len(vlens) != 1:
        return None
    klen, vlen = klens.pop(), vlens.pop()
    if merge_op is not None and vlen != 8:
        return None
    total = sum(s.num_entries for s in sources)
    if total == 0:
        return None
    vw = max(2, (vlen + 3) // 4)
    return sources, total, klen, vlen, vw


def est_row_bytes(vw: int) -> int:
    """Lane bytes per decoded window row (both key byte orders, the scalar
    lanes and the value words)."""
    return 68 + 4 * vw


def maybe_stream_merge(
    runs: List,
    merge_op,
    drop_tombstones: bool,
    path_factory,
    block_bytes: int,
    compression: int,
    bits_per_key: int,
    target_file_bytes: int,
    io_budget=None,
    mem_tracker=None,
    memory_budget_bytes: int = 0,
    resolver=None,
    report: Optional[dict] = None,
) -> Optional[List[Tuple[str, dict]]]:
    """Run the streaming pipeline when the mode and the inputs call for
    it. Returns [(path, props)] (possibly []) on success, None when the
    caller should take the in-RAM route (not streamable, below the auto
    threshold, mode off, or declined mid-stream: written outputs are
    swept first).

    The budget is ``memory_budget_bytes``, else the tracker's (a tracker
    handed in, the JAX package's included, belongs to the process budget
    that bounds this compaction), else the port's process budget.
    ``report``, when given, receives a streamed run's host-clock seconds
    by stage (``window_decode``, ``submit``, ``collect``, ``sink``) and
    its number of ``chunks``."""
    mode = stream_mode()
    if mode == "never":
        return None
    plan = plan_stream(runs, merge_op)
    if plan is None:
        return None
    sources, total, klen, vlen, vw = plan
    if mem_tracker is not None:
        budget_bytes = int(memory_budget_bytes) or mem_tracker.budget_bytes
    else:
        budget_bytes = (int(memory_budget_bytes)
                        or CompactionMemoryBudget.get().budget_bytes)
    if mode == "auto":
        from .native_compaction import MAX_DIRECT_ENTRIES

        # the in-RAM route holds per-run parts PLUS their concatenation
        projected = 2 * total * est_row_bytes(vw)
        if projected <= budget_bytes and total <= MAX_DIRECT_ENTRIES:
            return None
    tracker = mem_tracker or CompactionMemoryBudget.get().tracker()
    try:
        return _run_pipeline(
            sources, total, klen, vlen, vw, merge_op, drop_tombstones,
            path_factory, block_bytes, compression, bits_per_key,
            target_file_bytes, io_budget, tracker, budget_bytes,
            resolver or CpuChunkResolver(),
            {} if report is None else report)
    except (UnsupportedBatch, _StreamDecline) as e:
        Stats.get().incr("compaction.stream_declines")
        logging.getLogger(__name__).info(
            "streaming merge declined (%s); using the in-RAM route", e)
        return None
    finally:
        tracker.close()


def _run_pipeline(
    sources, total: int, klen: int, vlen: int, vw: int, merge_op,
    drop_tombstones: bool, path_factory, block_bytes: int,
    compression: int, bits_per_key: int, target_file_bytes: int,
    io_budget, tracker, budget_bytes: int, resolver, stages: dict,
) -> List[Tuple[str, dict]]:
    from .compaction_scheduler import adaptive_chunk_entries

    nruns = len(sources)
    row_bytes = est_row_bytes(vw)
    chunk_target = default_chunk_entries()
    sink = _FileBufferSink(
        path_factory, block_bytes, compression, bits_per_key,
        target_file_bytes, tracker, io_budget=io_budget,
        plan_klen=klen, plan_vlen=vlen)
    cursors = [_RunCursor(s, vw, klen, tracker) for s in sources]
    carry_parts: List[dict] = []
    carry_key: Optional[bytes] = None
    pending = None           # in-flight resolver handle (double buffer)
    pending_release = 0      # retired window bytes pinned by `pending`
    retired_bytes = 0        # retired windows the NEXT submit will pin
    stages.update(window_decode=0.0, submit=0.0, collect=0.0, sink=0.0,
                  chunks=0)

    def collect_pending() -> None:
        nonlocal pending, pending_release
        t0 = time.perf_counter()
        arrays, count = resolver.collect(pending)
        t1 = time.perf_counter()
        sink.append(arrays, count)
        stages["collect"] += t1 - t0
        stages["sink"] += time.perf_counter() - t1
        tracker.sub(pending_release)
        pending, pending_release = None, 0

    try:
        with start_span("compact.stream", runs=nruns, entries=total,
                        budget_bytes=budget_bytes):
            while True:
                t0 = time.perf_counter()
                # window sizing from the ACTUAL headroom under the ceiling:
                # live bytes already count the sink's file buffer, the
                # in-flight chunk and the windows the double buffer pins, so
                # refills shrink as any of them grow (degrade, never abort: the
                # floor is one block). Stall pressure shrinks the chunk too.
                eff_chunk = adaptive_chunk_entries(chunk_target, io_budget)
                headroom = budget_bytes - tracker.process_live()
                # /5: a window generation coexists with its chunk concatenation
                # (same size), the resolved chunk, the sink's file buffer and
                # (pipelined) the previous generation the double buffer pins,
                # plus block rounding on every refill
                w_budget = (headroom // 5) // max(1, nruns * row_bytes)
                w = max(MIN_WINDOW_ENTRIES,
                        min(eff_chunk // max(1, nruns), w_budget))
                for c in cursors:
                    if c.empty and not c.file_done:
                        retired_bytes += c.refill(w)
                cut: Optional[bytes] = None
                for c in cursors:
                    if not c.empty and not c.file_done:
                        k = c.frontier_key()
                        if cut is None or k < cut:
                            cut = k
                parts: List[dict] = []
                if carry_key is not None and (cut is None or carry_key < cut):
                    parts.extend(carry_parts)
                    retired_bytes += _lanes_nbytes_list(carry_parts)
                    carry_parts, carry_key = [], None
                for c in cursors:
                    sl = c.take_lt(cut)
                    if sl is not None:
                        parts.append(sl)
                if not parts:
                    stages["window_decode"] += time.perf_counter() - t0
                    if cut is None:
                        break  # every run exhausted, no carry left
                    # stall: the cut key's group spans the bounding run's
                    # window end — carry its loaded rows raw and refill
                    # before cutting again
                    for c in cursors:
                        sl = c.take_eq(cut)
                        if sl is not None:
                            carry_parts.append(sl)
                            tracker.add(_lanes_nbytes(sl))
                    carry_key = cut
                    continue
                fp.hit("compact.stream.chunk")
                Stats.get().incr("compaction.stream_chunks")
                lanes = {
                    f: np.concatenate([p[f] for p in parts])
                    if len(parts) > 1 else parts[0][f]
                    for f in resolver.fields
                }
                # the multi-part concatenation is a real second copy of the
                # consumed window rows; it lives through submit() and is
                # accounted for that span
                concat_bytes = _lanes_nbytes(lanes) if len(parts) > 1 else 0
                tracker.add(concat_bytes)
                chunk_n = int(lanes["key_len"].shape[0])
                _check_chunk_semantics(lanes, merge_op)
                stages["window_decode"] += time.perf_counter() - t0
                if pending is not None:
                    collect_pending()
                t0 = time.perf_counter()
                pending = resolver.submit(
                    parts, lanes, chunk_n, vw, merge_op, drop_tombstones)
                stages["submit"] += time.perf_counter() - t0
                stages["chunks"] += 1
                # both resolvers consume the concatenation inside submit()
                # (the CPU one resolves it, the card's uploads it): drop it
                # WITH its accounting, so freed bytes and tracker agree before
                # the next window sizing
                tracker.sub(concat_bytes)
                del parts, lanes
                # windows retired before this submit stay pinned by the
                # chunk's views until it is collected
                pending_release, retired_bytes = retired_bytes, 0
                if not getattr(resolver, "pipelined", True):
                    # synchronous resolver: nothing overlaps, release the
                    # consumed windows before the next refill
                    collect_pending()
            if pending is not None:
                collect_pending()
            t0 = time.perf_counter()
            outputs = sink.finish()
            stages["sink"] += time.perf_counter() - t0
            Stats.get().incr("compaction.stream_merges")
            return outputs
    except BaseException:
        sink.abandon()
        raise
    finally:
        for c in cursors:
            c.release()
