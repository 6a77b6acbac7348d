"""The port's storage engine against the JAX package's: the same scripted
operations on a reference ``DB`` and a port ``DB`` give the same ``.tsst``
bytes (matched by file number: names carry a random per-DB incarnation),
the same WAL segments, the same MANIFEST with the incarnation masked, the
same reads (``get``, ``multi_get``, a full iterator scan,
``get_updates_since``), the same spans, counters and failpoint trips.
Tolerance 0.

Backend pairs: the reference's default (its native host backend) against
the port's ``NativeCompactionBackend()``; the reference's
``TpuCompactionBackend`` (jax on the CPU, its lax sort) against the port's
``GpuCompactionBackend(device="cpu")`` (the kernels' plain versions)
under both of the port's sort flags. The tests always name the port's
backend: the port's default is the card.
"""

import json
import os
import shutil
import struct
import threading

import numpy as np
import pytest

import rocksplicator_tpu
import rocksplicator_tpu.observability.collector as jax_collector
import rocksplicator_tpu.storage as jax_storage
import rocksplicator_tpu.storage.native_compaction as jax_native
import rocksplicator_tpu.storage.stream_merge as jax_stream_merge
import rocksplicator_tpu.testing.failpoints as jax_fp
import rocksplicator_tpu.utils.stats as jax_stats
from rocksplicator_tpu.storage.sst import COMPRESSION_RLZ as JAX_RLZ
from rocksplicator_tpu.tpu import TpuCompactionBackend
from rocksplicator_tpu.tpu.compaction_service import \
    compact_dbs_batched as jax_compact_dbs_batched
from rocksplicator_tpu.utils.flags import FLAGS as JAX_FLAGS
import rocksplicator_tpu_torch
import rocksplicator_tpu_torch.observability.collector as port_collector
import rocksplicator_tpu_torch.storage as port_storage
import rocksplicator_tpu_torch.storage.native_compaction as port_native
import rocksplicator_tpu_torch.storage.stream_merge as port_stream_merge
import rocksplicator_tpu_torch.testing.failpoints as port_fp
import rocksplicator_tpu_torch.utils.stats as port_stats
from rocksplicator_tpu_torch.admin import BatchCompactor
from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
from rocksplicator_tpu_torch.gpu.compaction_service import \
    compact_dbs_batched as port_compact_dbs_batched
from rocksplicator_tpu_torch.ops import compaction_kernel  # noqa: F401
from rocksplicator_tpu_torch.storage.sst import COMPRESSION_RLZ
from rocksplicator_tpu_torch.utils.flags import FLAGS as PORT_FLAGS
from torch_parity import reset_observability, span_shape

pack64 = struct.Struct("<q").pack

# (reference backend, port backend, port sort flag)
PAIRS = {
    "native": (lambda: None, port_native.NativeCompactionBackend, None),
    "card_fused": (TpuCompactionBackend,
                   lambda: GpuCompactionBackend(device="cpu"),
                   "pallas_fused"),
    "card_bitonic": (TpuCompactionBackend,
                     lambda: GpuCompactionBackend(device="cpu"), "pallas"),
}

# the counters the engine and its SST layer emit
ENGINE_COUNTERS = ("storage.block_cache.hit", "storage.block_cache.miss",
                   "compaction.retain_trims", "compaction.subcompactions",
                   "compaction.stream_chunks", "compaction.stream_merges")
# annotations that carry host-clock times
_TIMED = ("sst_write_ms", "install_ms", "wal_purge_ms")


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    """Both packages compact in RAM unless a test streams, the reference
    on its lax sort, each package's singletons reset."""
    for mod in (jax_stream_merge, port_stream_merge):
        monkeypatch.setattr(mod, "STREAM_MODE_OVERRIDE", "never")
    old_jax, old_port = (JAX_FLAGS.get("sort_backend"),
                         PORT_FLAGS.get("sort_backend"))
    JAX_FLAGS.set("sort_backend", "lax")
    reset_observability(rocksplicator_tpu, rocksplicator_tpu_torch)
    jax_storage.sst.BlockCache.reset_for_test()
    port_storage.sst.BlockCache.reset_for_test()
    try:
        yield
    finally:
        JAX_FLAGS.set("sort_backend", old_jax)
        PORT_FLAGS.set("sort_backend", old_port)
        jax_fp.reset_for_test()
        port_fp.reset_for_test()


def _open(st, path, backend=None, **opts):
    """A DB of package ``st`` (``jax_storage`` or ``port_storage``)."""
    opts.setdefault("merge_operator", st.UInt64AddOperator())
    opts.setdefault("memtable_bytes", 4096)
    opts.setdefault("block_bytes", 1024)
    opts.setdefault("level0_compaction_trigger", 3)
    opts.setdefault("max_subcompactions", 1)
    return st.DB(str(path), st.DBOptions(compaction_backend=backend,
                                         **opts))


def _counter_ops(db, st, seed=0, rounds=3, keys=160):
    """Counter traffic: write batches of merges, puts and deletes over 16-
    byte keys, single-op writes, and an explicit flush; the small
    memtable flushes on its own and L0 compacts at its trigger."""
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        for _ in range(8):
            batch = st.WriteBatch()
            for _ in range(20):
                key = f"counter:{int(rng.integers(0, keys)):08d}".encode()
                op = int(rng.integers(0, 10))
                if op < 6:
                    batch.merge(key, pack64(int(rng.integers(-50, 1000))))
                elif op < 9:
                    batch.put(key, pack64(int(rng.integers(0, 1 << 40))))
                else:
                    batch.delete(key)
            db.write(batch)
        db.merge(b"counter:%08d" % r, pack64(7))
        db.put(b"counter:%08d" % (r + 1), pack64(r))
        db.delete(b"counter:%08d" % (r + 2))
        if r == 1:
            db.flush()


def _keys(n=170):
    return [f"counter:{i:08d}".encode() for i in range(n)]


def _reads(db):
    keys = _keys()
    return {"get": [db.get(k) for k in keys],
            "multi_get": db.multi_get(keys),
            "scan": list(db.new_iterator()),
            "seq": db.latest_sequence_number(),
            "updates": list(db.get_updates_since(1)),
            "levels": [len(files) for files in db._levels]}


def _tsst(path):
    """{file number: bytes} of the DB's .tsst files."""
    return {f.rsplit("-", 1)[1]: open(os.path.join(path, f), "rb").read()
            for f in os.listdir(path) if f.endswith(".tsst")}


def _masked_manifest(path):
    text = open(os.path.join(path, "MANIFEST")).read()
    return json.loads(text.replace(json.loads(text)["incarnation"], "INC"))


def _wal(path):
    wal_dir = os.path.join(path, "wal")
    if not os.path.isdir(wal_dir):  # a checkpoint holds no WAL
        return {}
    return {f: open(os.path.join(wal_dir, f), "rb").read()
            for f in sorted(os.listdir(wal_dir))}


def assert_same_dirs(ref, port, by_number=True):
    """The two DB directories hold the same files. ``by_number=False``
    compares the files as a multiset, for jobs whose threads allocate
    their file numbers in a racy order."""
    ref, port = str(ref), str(port)
    want_m, got_m = _masked_manifest(ref), _masked_manifest(port)
    want, got = _tsst(ref), _tsst(port)
    if by_number:
        assert got_m == want_m
        assert sorted(got) == sorted(want)
        for num in want:
            assert got[num] == want[num], f"file {num} differs"
    else:
        assert [len(lv) for lv in got_m["levels"]] == [
            len(lv) for lv in want_m["levels"]]
        assert sorted(got.values()) == sorted(want.values())
    assert _wal(port) == _wal(ref)


def _pair(tmp_path, pair, run, by_number=True, **opts):
    """``run(db, st)`` on a reference and a port DB of backend pair
    ``pair``; the directories and reads are compared, then both reopen
    (the WAL replayed) and their reads are compared again."""
    jax_backend, port_backend, flag = PAIRS[pair]
    if flag is not None:
        PORT_FLAGS.set("sort_backend", flag)
    out = {}
    ported = port_backend()
    for name, st, backend in (("ref", jax_storage, jax_backend()),
                              ("port", port_storage, ported)):
        db = _open(st, tmp_path / name, backend, **opts)
        try:
            run(db, st)
            out[name] = _reads(db)
        finally:
            db.close()
    assert out["port"] == out["ref"]
    assert_same_dirs(tmp_path / "ref", tmp_path / "port", by_number)
    again = {}
    for name, st, backend in (("ref", jax_storage, jax_backend()),
                              ("port", port_storage, port_backend())):
        db = _open(st, tmp_path / name, backend, **opts)
        try:
            again[name] = _reads(db)
        finally:
            db.close()
    assert again["port"] == again["ref"] == out["ref"]
    if isinstance(ported, GpuCompactionBackend):
        # the last compaction took the direct sink, on the plain kernels
        assert {"source_decode", "bloom", "encode_write"} <= set(
            ported.last_stage_seconds) or ported.last_stream_chunks
    return out["ref"]


def _crud_then_compact(db, st):
    _counter_ops(db, st)
    db.compact_range()
    # the merge counter across the compacted level and a new memtable
    _counter_ops(db, st, seed=1, rounds=1)


@pytest.mark.parametrize("ingest_behind_db", [False, True])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_engine_matches_reference(pair, ingest_behind_db, tmp_path):
    """CRUD, write batches and the merge counter across flushes, the
    automatic flush of a full memtable, L0 compaction at its trigger, and
    compact_range dropping tombstones (or keeping them for ingest
    behind); then a reopen replays the WAL."""
    reads = _pair(tmp_path, pair, _crud_then_compact,
                  allow_ingest_behind=ingest_behind_db)
    assert reads["scan"] and any(v is None for v in reads["get"])


def test_subcompactions_match_reference(tmp_path, monkeypatch):
    """Key-range subcompactions of compact_range, slices of 32 entries in
    both packages; the host backends write one file set per slice from
    threads, so their numbers are matched as a multiset."""
    for mod in (jax_native, port_native):
        monkeypatch.setattr(mod, "MIN_SLICE_ENTRIES", 32)
    _pair(tmp_path / "native", "native", _crud_then_compact,
          by_number=False, max_subcompactions=4, memtable_bytes=1 << 20)
    _pair(tmp_path / "card", "card_fused", _crud_then_compact,
          max_subcompactions=4, memtable_bytes=1 << 20)
    assert jax_stats.Stats.get().get_counter(
        "compaction.subcompactions") == port_stats.Stats.get().get_counter(
        "compaction.subcompactions") > 0


@pytest.mark.parametrize("pair", ["native", "card_fused"])
def test_streamed_compaction_matches_reference(pair, tmp_path, monkeypatch):
    for mod in (jax_stream_merge, port_stream_merge):
        monkeypatch.setattr(mod, "STREAM_MODE_OVERRIDE", "always")
        monkeypatch.setattr(mod, "CHUNK_ENTRIES_OVERRIDE", 128)
    _pair(tmp_path, pair, _crud_then_compact, block_bytes=512)
    chunks = [st.Stats.get().get_counter("compaction.stream_chunks")
              for st in (jax_stats, port_stats)]
    assert chunks[0] == chunks[1] > 0


def test_rlz_files_match_reference(tmp_path):
    """F5: with RLZ1 block compression both packages write the same files,
    the planar flush and compaction sinks and the entry-stream writer of
    the tuple path (mixed value widths) alike."""
    def run(db, st):
        _crud_then_compact(db, st)
        for i in range(40):
            db.put(b"wide:%04d" % i, bytes([i]) * (3 + i % 5))
        db.compact_range()

    _pair(tmp_path, "native", run, compression=COMPRESSION_RLZ)
    assert COMPRESSION_RLZ == JAX_RLZ


def _sst_files(st, d, seed):
    """Three SST files of disjoint key ranges written by package ``st``'s
    writer, for ingestion."""
    paths = []
    rng = np.random.default_rng(seed)
    for f in range(3):
        p = os.path.join(d, f"ext{f}.tsst")
        w = st.sst.SSTWriter(p, 1024)
        for i in range(40):
            w.add(b"counter:%08d" % (200 + 100 * f + i), 1, 1,
                  pack64(int(rng.integers(0, 1000))))
        w.finish()
        paths.append(p)
    return paths


@pytest.mark.parametrize("mode", ["normal", "behind", "move"])
def test_ingest_matches_reference(mode, tmp_path):
    def run(db, st):
        src = os.path.join(db.path, "..", os.path.basename(db.path) + "_in")
        os.makedirs(src)
        paths = _sst_files(st, src, seed=4)
        if mode != "behind":
            _counter_ops(db, st, rounds=1)
        db.ingest_external_file(paths, move_files=mode == "move",
                                ingest_behind=mode == "behind")
        _counter_ops(db, st, seed=2, rounds=1)
        db.compact_range()
        assert [os.path.exists(p) for p in paths] == [mode != "move"] * 3

    reads = _pair(tmp_path, "native", run,
                  allow_ingest_behind=mode == "behind")
    assert reads["scan"][-1][0] >= b"counter:00000400"


def test_checkpoint_then_reopen(tmp_path):
    seqs = {}
    for name, st, backend in (
            ("ref", jax_storage, None),
            ("port", port_storage, port_native.NativeCompactionBackend())):
        db = _open(st, tmp_path / name, backend)
        try:
            _counter_ops(db, st)
            seqs[name] = db.checkpoint(str(tmp_path / f"{name}_ckpt"))
            _counter_ops(db, st, seed=5, rounds=1)
        finally:
            db.close()
    assert seqs["port"] == seqs["ref"]
    assert_same_dirs(tmp_path / "ref_ckpt", tmp_path / "port_ckpt")
    reads = {}
    for name, st, backend in (
            ("ref", jax_storage, None),
            ("port", port_storage, port_native.NativeCompactionBackend())):
        db = _open(st, tmp_path / f"{name}_ckpt", backend)
        try:
            reads[name] = _reads(db)
        finally:
            db.close()
    assert reads["port"] == reads["ref"]
    assert reads["port"]["seq"] == seqs["port"]


def test_wal_replay_after_torn_tail(tmp_path):
    """Each package cuts the last WAL record in half after close; both
    reopen to the same state and the same truncated segment."""
    reads = {}
    for name, st, backend in (
            ("ref", jax_storage, None),
            ("port", port_storage, port_native.NativeCompactionBackend())):
        path = tmp_path / name
        db = _open(st, path, backend, memtable_bytes=1 << 20)
        _counter_ops(db, st, rounds=1)
        db.close()
        wal_dir = path / "wal"
        seg = sorted(os.listdir(wal_dir))[-1]
        size = os.path.getsize(wal_dir / seg)
        with open(wal_dir / seg, "r+b") as f:
            f.truncate(size - 37)
        db = _open(st, path, backend, memtable_bytes=1 << 20)
        try:
            reads[name] = _reads(db)
        finally:
            db.close()
    assert reads["port"] == reads["ref"]
    assert 0 < reads["port"]["seq"] < 8 * 20 + 3
    assert _wal(tmp_path / "port") == _wal(tmp_path / "ref")


def test_properties_and_metrics_match_reference(tmp_path):
    props = ("num-levels", "highest-empty-level", "rocksdb.num-files-at-"
             "level0", "num-files-at-level6", "estimate-num-keys",
             "total-sst-bytes", "no-such-property")
    out = {}
    for name, st, backend in (
            ("ref", jax_storage, None),
            ("port", port_storage, port_native.NativeCompactionBackend())):
        db = _open(st, tmp_path / name, backend)
        try:
            _counter_ops(db, st)
            db.set_options({"level0_compaction_trigger": "5",
                            "disable_auto_compaction": "false"})
            got = {p: db.get_property(p) for p in props}
            snap = db.metrics_snapshot(max_age=0)
            with pytest.raises(st.engine.InvalidArgument):
                db.set_options({"num_levels": 3})
            out[name] = (got, snap, db.options.level0_compaction_trigger,
                         db.options.disable_auto_compaction)
        finally:
            db.close()
    assert out["port"] == out["ref"]
    assert out["port"][2:] == (5, False)
    assert out["port"][0]["num-levels"] == "7"


def _trips(fp):
    return {k: v for k, v in fp.trip_counts().items() if v}


def test_spans_counters_and_failpoints_match_reference(tmp_path):
    """The engine's span trees, counters and failpoint trips: a flush, an
    L0 compaction, compact_range, a checkpoint and an ingest, with the
    WAL append armed to fail once and the compaction install to fail
    once, in both packages' own registries."""
    out = {}
    for name, st, backend, fp, stats, col in (
            ("ref", jax_storage, None, jax_fp, jax_stats, jax_collector),
            ("port", port_storage, port_native.NativeCompactionBackend(),
             port_fp, port_stats, port_collector)):
        reset_observability(rocksplicator_tpu, rocksplicator_tpu_torch)
        fp.activate("wal.append", "fail_nth:5")
        fp.activate("compact.install", "fail_nth:2")
        db = _open(st, tmp_path / name, backend, background_compaction=False)
        errors = []
        try:
            for attempt in range(2):
                try:
                    _counter_ops(db, st, seed=attempt)
                except fp.FailpointError as exc:
                    errors.append(type(exc).__name__)
            for _ in range(2):
                try:
                    db.compact_range()
                except fp.FailpointError as exc:
                    errors.append(type(exc).__name__)
            db.checkpoint(str(tmp_path / f"{name}_ckpt"))
            src = tmp_path / f"{name}_in"
            os.makedirs(src)
            db.ingest_external_file(_sst_files(st, str(src), seed=3))
            reads = _reads(db)
        finally:
            db.close()
        out[name] = (span_shape(col, timed=_TIMED), _trips(fp), errors,
                     reads, {c: stats.Stats.get().get_counter(c)
                             for c in ENGINE_COUNTERS})
    names = {key[0] for key in out["ref"][0]}
    assert {"storage.compact_range", "compaction.merge", "flush.drain",
            "storage.checkpoint", "checkpoint.link"} <= names
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1] == {"wal.append": 1,
                                               "compact.install": 1}
    assert out["port"][2:] == out["ref"][2:]


def test_state_carries_across_both_ways(tmp_path):
    """A directory one package's DB wrote and closed (SSTs, and a WAL tail
    not yet flushed) opens in the other's with the same reads and the
    same latest sequence number, and the other compacts it into the same
    files as the writer would have."""
    for writer, reader in ((jax_storage, port_storage),
                           (port_storage, jax_storage)):
        base = tmp_path / writer.__name__.split(".")[0]
        db = _open(writer, base / "db", port_native.NativeCompactionBackend()
                   if writer is port_storage else None)
        _counter_ops(db, writer)
        _counter_ops(db, writer, seed=3, rounds=1)
        want = _reads(db)
        db.close()
        shutil.copytree(base / "db", base / "same")
        db = _open(reader, base / "db", port_native.NativeCompactionBackend()
                   if reader is port_storage else None)
        try:
            assert _reads(db) == want
            db.compact_range()
            after = _reads(db)
        finally:
            db.close()
        db = _open(writer, base / "same", port_native.NativeCompactionBackend()
                   if writer is port_storage else None)
        try:
            db.compact_range()
            assert _reads(db) == after
        finally:
            db.close()
        assert_same_dirs(base / "same", base / "db")


class _FailingSink:
    """A backend whose direct file sink raises; ``device`` says where its
    merge runs."""

    supports_subcompactions = True
    supports_memory_budget = True

    def __init__(self, device):
        self.device = device
        self.name = f"failing-{device}"
        self.sink_calls = 0
        self._heap = port_storage.compaction.CpuCompactionBackend()

    def merge_runs(self, runs, merge_op, drop_tombstones):
        return self._heap.merge_runs(runs, merge_op, drop_tombstones)

    def merge_runs_to_files(self, *args, **kwargs):
        self.sink_calls += 1
        raise RuntimeError("the kernel failed")


def test_card_sink_failure_raises_and_host_failure_takes_tuple_path(
        tmp_path):
    import torch

    card = _FailingSink(torch.device("cuda"))
    db = _open(port_storage, tmp_path / "card", card)
    try:
        _counter_ops(db, port_storage, rounds=1)
        with pytest.raises(RuntimeError, match="the kernel failed"):
            db.compact_range()
        # nothing was installed: the inputs stay live and readable
        assert db._levels[-1] == [] and db.get(b"counter:00000000") \
            == db.multi_get([b"counter:00000000"])[0]
    finally:
        db.close()
    assert card.sink_calls == 1
    host = {}
    for name, st in (("ref", jax_storage), ("port", port_storage)):
        backend = _FailingSink("cpu")
        db = _open(st, tmp_path / name, backend)
        try:
            _counter_ops(db, st)
            db.compact_range()
            host[name] = _reads(db)
        finally:
            db.close()
        assert backend.sink_calls >= 2
    assert host["port"] == host["ref"]
    assert_same_dirs(tmp_path / "ref", tmp_path / "port")


@pytest.mark.parametrize("pair", ["native", "card_fused"])
def test_background_mode_reads_back(pair, tmp_path):
    """Background flush and compaction threads with the scheduler on, from
    three writer threads: every acknowledged write reads back and no
    background job failed (file layout depends on timing, so files are
    not compared)."""
    _jax, port_backend, flag = PAIRS[pair]
    if flag is not None:
        PORT_FLAGS.set("sort_backend", flag)
    db = _open(port_storage, tmp_path, port_backend(),
               background_compaction=True, compaction_scheduler=True,
               level0_compaction_trigger=2)
    want = {}
    lock = threading.Lock()

    def writer(t):
        rng = np.random.default_rng(t)
        for i in range(300):
            key = f"t{t}:{int(rng.integers(0, 60)):06d}".encode()
            if rng.integers(0, 2):
                db.merge(key, pack64(1))
                with lock:
                    want[key] = want.get(key, 0) + 1
            else:
                db.put(key, pack64(5))
                with lock:
                    want[key] = 5

    try:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        db.flush()
        db.compact_range()
        keys = sorted(want)
        got = db.multi_get(keys)
        assert got == [pack64(want[k]) for k in keys]
        assert [k for k, _v in db.new_iterator()] == keys
        assert db._bg_flush_failures == 0
        assert db._bg_compaction_failures == 0
    finally:
        db.close()


def test_batched_callers_take_the_port_db(tmp_path):
    """The port's compact_dbs_batched over port DBs writes the files the
    reference's writes over reference DBs; the port's BatchCompactor
    compacts a port DB."""
    def fill(st, path):
        db = _open(st, path, port_native.NativeCompactionBackend()
                   if st is port_storage else None,
                   level0_compaction_trigger=100)
        _counter_ops(db, st)
        return db

    ref = [(f"db{i}", fill(jax_storage, tmp_path / f"ref{i}"))
           for i in range(2)]
    port = [(f"db{i}", fill(port_storage, tmp_path / f"port{i}"))
            for i in range(2)]
    try:
        want = jax_compact_dbs_batched(ref)
        got = port_compact_dbs_batched(port, device="cpu")
        assert sorted(got[0]) == sorted(want[0]) == ["db0", "db1"]
        assert [_reads(db) for _n, db in port] == [
            _reads(db) for _n, db in ref]
    finally:
        for _n, db in ref + port:
            db.close()
    for i in range(2):
        assert_same_dirs(tmp_path / f"ref{i}", tmp_path / f"port{i}")
    db = fill(port_storage, tmp_path / "bc")
    compactor = BatchCompactor(device="cpu")
    try:
        compactor.compact("bc", db)
        assert db.get_property("num-files-at-level6") == "1"
        assert db.get_property("num-files-at-level0") == "0"
    finally:
        compactor.close()
        db.close()
