"""The port's memory-budget streaming merge against the JAX package's.

The port's ``storage/stream_merge.py`` with ``GpuChunkResolver`` on CPU
tensors (``GpuCompactionBackend(device="cpu")``) must write the same file
bytes as the reference's streamed merge through ``TpuCompactionBackend``
(jax on the CPU, lax sort path) and as the port's own in-RAM route: with
key groups straddling many chunks, under a ceiling far below the input,
at the block floor, behind an all-tombstone prefix, and through the
reference engine. Tolerance 0: files are compared byte for byte.

Both packages keep their own knobs and budget singletons; every test pins
both packages' ``STREAM_MODE_OVERRIDE`` and ``CHUNK_ENTRIES_OVERRIDE`` and
resets both budgets after it runs. They keep their own Stats, span
collectors and failpoint tables too: the stream's counters, its
``compact.stream`` span and its two failpoints are held against the
reference's, each package read and armed on its own.
"""

import hashlib
import os
import struct

import numpy as np
import pytest

import rocksplicator_tpu
import rocksplicator_tpu.observability.collector as jax_collector
import rocksplicator_tpu.storage.stream_merge as jax_sm
import rocksplicator_tpu.testing.failpoints as jax_fp
import rocksplicator_tpu.utils.stats as jax_stats
import rocksplicator_tpu.tpu.backend as jax_backend
from rocksplicator_tpu.storage import DB, DBOptions, UInt64AddOperator
from rocksplicator_tpu.storage.compaction_scheduler import \
    adaptive_chunk_entries as jax_adaptive_chunk_entries
from rocksplicator_tpu.storage.sst import SSTReader as JaxSSTReader
from rocksplicator_tpu.storage.sst import SSTWriter as JaxSSTWriter
from rocksplicator_tpu.tpu import TpuCompactionBackend
from rocksplicator_tpu.tpu.format import \
    SstBlockLaneSource as JaxSstBlockLaneSource
from rocksplicator_tpu.utils.flags import FLAGS
import rocksplicator_tpu_torch
import rocksplicator_tpu_torch.observability.collector as port_collector
import rocksplicator_tpu_torch.storage.stream_merge as sm
import rocksplicator_tpu_torch.testing.failpoints as port_fp
import rocksplicator_tpu_torch.utils.stats as port_stats
from rocksplicator_tpu_torch.gpu import backend as gpu_backend
from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
from rocksplicator_tpu_torch.gpu.compaction_service import GpuChunkResolver
from rocksplicator_tpu_torch.gpu.format import (SstBlockLaneSource,
                                                planar_stride,
                                                write_sst_from_arrays)
from rocksplicator_tpu_torch.ops.kv_format import pack_entries
from rocksplicator_tpu_torch.storage.compaction_scheduler import (
    STALL_BOOST_MS, adaptive_chunk_entries)
from rocksplicator_tpu_torch.storage.sst import SSTReader
from torch_parity import G1_COUNTERS, counters, reset_observability, \
    span_shape

P, D, M = 1, 2, 3
pack_u64 = struct.Struct("<q").pack


@pytest.fixture(autouse=True)
def _pin_both_packages(monkeypatch):
    """Both packages stream (or not) as each test says, the reference on
    its lax sort path; both budgets start and end at their defaults."""
    for mod in (jax_sm, sm):
        monkeypatch.setattr(mod, "STREAM_MODE_OVERRIDE", None)
        monkeypatch.setattr(mod, "CHUNK_ENTRIES_OVERRIDE", None)
        mod.CompactionMemoryBudget.reset_for_test()
    monkeypatch.setenv("RSTPU_FLAG_SORT_BACKEND", "lax")
    old = FLAGS.get("sort_backend")
    FLAGS.set("sort_backend", "lax")
    # tests/conftest.py resets only the JAX package's singletons
    reset_observability(rocksplicator_tpu, rocksplicator_tpu_torch)
    try:
        yield
    finally:
        FLAGS.set("sort_backend", old)
        for mod in (jax_sm, sm):
            mod.CompactionMemoryBudget.reset_for_test()
        jax_fp.reset_for_test()
        port_fp.reset_for_test()


def _knobs(mode, chunk=None):
    for mod in (jax_sm, sm):
        mod.STREAM_MODE_OVERRIDE = mode
        mod.CHUNK_ENTRIES_OVERRIDE = chunk


def _write_run(path, entries, block_bytes=4096):
    """A row-format run (uniform stride where the widths are)."""
    w = JaxSSTWriter(path, block_bytes)
    for k, s, t, v in sorted(entries, key=lambda e: (e[0], -e[1])):
        w.add(k, s, t, v)
    w.finish()
    return path


def _write_planar_run(path, entries, block_bytes=4096):
    """A planar run: tombstones beside values stream only from planar
    files, which is how the engine's flush writes them."""
    vbytes = max(8, max(len(e[3]) for e in entries))
    batch = pack_entries(sorted(entries, key=lambda e: (e[0], -e[1])),
                         val_bytes=(vbytes + 3) // 4 * 4)
    n = batch.num_valid()
    arr = {f: getattr(batch, f)[:n] for f in (
        "key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
        "val_words", "val_len")}
    vl = arr["val_len"][arr["vtype"] != D]
    stride = planar_stride(int(arr["key_len"][0]),
                           int(vl[0]) if len(vl) else 0)
    assert write_sst_from_arrays(
        arr, n, path, block_entries=max(64, block_bytes // stride),
        compression=0, bits_per_key=10, planar=True) is not None
    return path


def _straddle_runs(root):
    """Three overlapping runs with every chunk-boundary hazard: a
    MERGE-operand chain spanning many blocks (its group cannot fit a
    window), stacks of one key at many seqs, tombstones shadowing puts of
    other runs."""
    runs = [_write_run(os.path.join(root, "r0.tsst"), [
        (b"k%05d" % i, 1000 + i, P, pack_u64(i))
        for i in range(0, 3000, 2)])]
    e = [(b"k%05d" % i, 50000 + i, M, pack_u64(7))
         for i in range(0, 3000, 3)]
    e += [(b"k%05d" % i, 56000 + i, M, pack_u64(5))
          for i in range(0, 3000, 6)]
    e += [(b"k01500", 90000 + j, M, pack_u64(1)) for j in range(2000)]
    runs.append(_write_run(os.path.join(root, "r1.tsst"), e))
    e = [(b"k%05d" % i, 70000 + i, D if i % 10 else P,
          b"" if i % 10 else pack_u64(1)) for i in range(0, 3000, 5)]
    e += [(b"k00777", 80000 + j, P, pack_u64(j)) for j in range(1500)]
    runs.append(_write_planar_run(os.path.join(root, "r2.tsst"), e))
    return runs


def _sha_files(outs):
    hs = []
    for p, _props in outs:
        with open(p, "rb") as f:
            hs.append(hashlib.sha256(f.read()).hexdigest())
    return hs


def _path_factory(root, tag):
    made = []

    def pf():
        made.append(os.path.join(root, f"out-{tag}-{len(made)}.tsst"))
        return made[-1]

    return pf, made


def _port_merge(paths, tag, root, merge_op, drop, mode, chunk=None,
                tracker=None, budget=0, backend=None):
    _knobs(mode, chunk)
    pf, _ = _path_factory(root, tag)
    backend = backend or GpuCompactionBackend(device="cpu")
    readers = [SSTReader(p) for p in paths]
    try:
        outs = backend.merge_runs_to_files(
            readers, merge_op, drop, pf, 4096, 0, 10, 8192,
            mem_tracker=tracker, memory_budget_bytes=budget)
    finally:
        for r in readers:
            r.close()
    assert outs is not None, tag
    return outs


def _reference_merge(paths, tag, root, merge_op, drop, mode, chunk=None):
    _knobs(mode, chunk)
    pf, _ = _path_factory(root, tag)
    readers = [JaxSSTReader(p) for p in paths]
    try:
        outs = TpuCompactionBackend().merge_runs_to_files(
            readers, merge_op, drop, pf, 4096, 0, 10, 8192)
    finally:
        for r in readers:
            r.close()
    assert outs is not None, tag
    return outs


class _Counting:
    """Wraps a resolver and counts its submits."""

    def __init__(self, inner):
        self.inner = inner
        self.fields = inner.fields
        self.pipelined = inner.pipelined
        self.submits = 0

    def submit(self, *a):
        self.submits += 1
        return self.inner.submit(*a)

    def collect(self, handle):
        return self.inner.collect(handle)


# ---------------------------------------------------------------------------
# F7: over the entry cap the engine gets the reference's planar files
# ---------------------------------------------------------------------------


def _counter_writes(db, rounds=4, keys=600, seed=5):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        for i in rng.permutation(keys):
            key = f"counter:{i:08d}".encode()
            op = rng.integers(0, 10)
            if op < 6:
                db.merge(key, pack_u64(int(rng.integers(-50, 1000))))
            elif op < 8:
                db.put(key, pack_u64(int(rng.integers(0, 1 << 40))))
            else:
                db.delete(key)
        db.flush()


def _db_files(path):
    names = sorted((f for f in os.listdir(path) if f.endswith(".tsst")),
                   key=lambda f: f.rsplit("-", 1)[1])
    return [f.rsplit("-", 1)[1] for f in names], [
        open(os.path.join(path, f), "rb").read() for f in names]


def _run_db(path, backend):
    db = DB(str(path), DBOptions(
        compaction_backend=backend, merge_operator=UInt64AddOperator(),
        level0_compaction_trigger=100, memtable_bytes=1 << 30,
        block_bytes=2048, compaction_memory_budget_bytes=16 * 1024))
    try:
        _counter_writes(db)
        db.compact_range()
        _counter_writes(db, seed=6)
        db.compact_range()
        items = list(db.new_iterator())
        peak = db.metrics_snapshot(max_age=0)[
            "compaction_peak_bytes_materialized"]
    finally:
        db.close()
    return _db_files(str(path)), items, peak


def test_over_the_entry_cap_the_engine_writes_the_reference_files(
        tmp_path, monkeypatch):
    """F7. Both packages' single-launch caps lowered to 256 entries and a
    16 KiB budget: the reference streams every compaction into planar
    files; the port must write the same bytes (before the streaming merge
    was ported it handed such jobs to the engine's row-format tuple
    path) and report the reference's peak to the engine's gauge."""
    monkeypatch.setattr(jax_backend, "MAX_TPU_ENTRIES", 256)
    monkeypatch.setattr(gpu_backend, "MAX_LAUNCH_ENTRIES", 256)
    gpu = GpuCompactionBackend(device="cpu")
    assert gpu.supports_memory_budget
    sink = gpu.merge_runs_to_files
    chunks = []

    def sink_spy(*a, **kw):
        out = sink(*a, **kw)
        chunks.append(gpu.last_stream_chunks)
        return out

    gpu.merge_runs_to_files = sink_spy
    (want_names, want_files), want_items, want_peak = _run_db(
        tmp_path / "tpu", TpuCompactionBackend())
    (got_names, got_files), got_items, got_peak = _run_db(
        tmp_path / "gpu", gpu)
    assert len(chunks) == 2 and all(c >= 2 for c in chunks), chunks
    assert got_names == want_names
    for name, w, g in zip(want_names, want_files, got_files):
        assert g == w, f"{name} differs"
    assert got_items == want_items
    # the same accounting: the engine's peak gauge reads the same bytes
    assert got_peak == want_peak > 0


# ---------------------------------------------------------------------------
# byte identity with key groups straddling chunk boundaries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop_tombstones", [False, True])
@pytest.mark.parametrize("merge_op", [None, UInt64AddOperator()],
                         ids=["no-op", "uint64add"])
def test_streamed_files_match_the_reference(tmp_path, drop_tombstones,
                                            merge_op):
    """Chunks of 300 entries, so the operand chain and the one-key stacks
    straddle many chunks: the port's streamed files equal the reference's
    streamed files and the port's in-RAM files."""
    root = str(tmp_path)
    paths = _straddle_runs(root)
    if merge_op is None:
        # MERGE records without an operator decline the array routes
        paths = [paths[0], paths[2]]
    want = _reference_merge(paths, "ref", root, merge_op, drop_tombstones,
                            "always", chunk=300)
    ram = _port_merge(paths, "ram", root, merge_op, drop_tombstones,
                      "never")
    backend = GpuCompactionBackend(device="cpu")
    got = _port_merge(paths, "s", root, merge_op, drop_tombstones,
                      "always", chunk=300, backend=backend)
    assert backend.last_stream_chunks >= 3
    assert set(backend.last_stage_seconds) == {
        "window_decode", "submit", "collect", "sink"}
    assert len(got) > 0
    assert _sha_files(got) == _sha_files(want) == _sha_files(ram)


def test_cpu_chunk_resolver_writes_the_same_files(tmp_path):
    """The host resolver (numpy) and the card's resolver on CPU tensors
    stream the same bytes, one submit per chunk each."""
    root = str(tmp_path)
    paths = _straddle_runs(root)
    op = UInt64AddOperator()
    _knobs("always", 400)
    outs = {}
    for name, resolver in (("cpu", sm.CpuChunkResolver()),
                           ("gpu", GpuChunkResolver("cpu"))):
        counting = _Counting(resolver)
        report = {}
        pf, _ = _path_factory(root, name)
        readers = [SSTReader(p) for p in paths]
        outs[name] = sm.maybe_stream_merge(
            readers, op, True, pf, 4096, 0, 10, 8192, resolver=counting,
            report=report)
        for r in readers:
            r.close()
        assert counting.submits == report["chunks"] >= 3
    assert _sha_files(outs["cpu"]) == _sha_files(outs["gpu"])


# ---------------------------------------------------------------------------
# the ceiling
# ---------------------------------------------------------------------------


def test_ceiling_holds_for_input_far_over_the_budget(tmp_path):
    """A lane image ~13x a 512 KiB budget, in auto mode: the port streams,
    holds its peak at or under the budget, and writes the bytes of the
    reference's streamed merge under the same budget and of its own
    in-RAM route."""
    root = str(tmp_path)
    big = _write_run(os.path.join(root, "big.tsst"), [
        (b"b%07d" % i, i + 1, P, pack_u64(i)) for i in range(60000)])
    big2 = _write_run(os.path.join(root, "big2.tsst"), [
        (b"b%07d" % i, 200000 + i, P, pack_u64(i * 3))
        for i in range(0, 60000, 2)])
    budget = 512 * 1024
    for mod in (jax_sm, sm):
        mod.CompactionMemoryBudget.reset_for_test(budget)
    tracker = sm.CompactionMemoryBudget.get().tracker()
    backend = GpuCompactionBackend(device="cpu")
    got = _port_merge([big, big2], "b", root, None, True, None,
                      tracker=tracker, backend=backend)
    assert backend.last_stream_chunks >= 2
    assert 0 < tracker.peak <= budget
    assert sm.CompactionMemoryBudget.get().live_bytes() == 0
    want = _reference_merge([big, big2], "rb", root, None, True, None)
    for mod in (jax_sm, sm):
        mod.CompactionMemoryBudget.reset_for_test()
    ram = _port_merge([big, big2], "ub", root, None, True, "never")
    assert _sha_files(got) == _sha_files(want) == _sha_files(ram)


def test_a_reference_tracker_sets_the_budget(tmp_path):
    """The reference engine hands the port ITS tracker: the port takes
    that tracker's budget, not its own singleton's."""
    root = str(tmp_path)
    big = _write_run(os.path.join(root, "t.tsst"), [
        (b"t%07d" % i, i + 1, P, pack_u64(i)) for i in range(20000)])
    jax_sm.CompactionMemoryBudget.reset_for_test(256 * 1024)
    tracker = jax_sm.CompactionMemoryBudget.get().tracker()
    backend = GpuCompactionBackend(device="cpu")
    _port_merge([big], "t", root, None, True, None, tracker=tracker,
                backend=backend)
    # auto mode streamed: the port's own 256 MiB budget would not have
    assert backend.last_stream_chunks >= 2
    assert 0 < tracker.peak <= 256 * 1024
    assert jax_sm.CompactionMemoryBudget.get().live_bytes() == 0


def test_auto_mode_keeps_small_compactions_in_ram(tmp_path):
    p = _write_run(os.path.join(str(tmp_path), "s.tsst"), [
        (b"k%04d" % i, i + 1, P, pack_u64(i)) for i in range(500)])
    backend = GpuCompactionBackend(device="cpu")
    _port_merge([p], "small", str(tmp_path), None, True, None,
                backend=backend)
    assert backend.last_stream_chunks == 0
    assert "merge" in backend.last_stage_seconds


def test_degrades_to_the_block_floor_never_aborts(tmp_path):
    """A budget below one block's rows cannot be honoured: the pipeline
    degrades to one-block windows, completes, and reports the honest
    peak."""
    big = _write_run(os.path.join(str(tmp_path), "g.tsst"), [
        (b"g%06d" % i, i + 1, P, pack_u64(i)) for i in range(30000)],
        block_bytes=32 * 1024)
    sm.CompactionMemoryBudget.reset_for_test(16 * 1024)
    tracker = sm.CompactionMemoryBudget.get().tracker()
    outs = _port_merge([big], "g", str(tmp_path), None, True, "always",
                       tracker=tracker)
    assert outs and tracker.peak > 16 * 1024  # honest, not clamped
    want = _reference_merge([big], "rg", str(tmp_path), None, True,
                            "never")
    assert _sha_files(outs) == _sha_files(want)


def test_tombstone_prefix_does_not_defeat_the_ceiling(tmp_path):
    """An all-tombstone resolved PREFIX (drop_tombstones=False) must not
    buffer without bound while the sink waits for a value row to derive
    vlen: once a file's worth is buffered the sink takes the PLANNED
    width, and the bytes stay those of the in-RAM route."""
    root = str(tmp_path)
    dels = [(b"a%06d" % i, 10000 + i, D, b"") for i in range(40000)]
    tail = [(b"z%06d" % i, 50000 + i, P, pack_u64(i)) for i in range(50)]
    p = _write_planar_run(os.path.join(root, "tp.tsst"), dels + tail)
    budget = 768 * 1024
    sm.CompactionMemoryBudget.reset_for_test(budget)
    tracker = sm.CompactionMemoryBudget.get().tracker()
    got = _port_merge([p], "tp", root, None, False, "always", chunk=2048,
                      tracker=tracker)
    assert 0 < tracker.peak <= budget
    sm.CompactionMemoryBudget.reset_for_test()
    ram = _port_merge([p], "utp", root, None, False, "never")
    want = _reference_merge([p], "rtp", root, None, False, "always",
                            chunk=2048)
    assert _sha_files(got) == _sha_files(ram) == _sha_files(want)


# ---------------------------------------------------------------------------
# declines and failures sweep their outputs
# ---------------------------------------------------------------------------


def test_mid_stream_width_drift_declines_and_sweeps(tmp_path):
    """A file whose later blocks break the probed uniform stride declines
    the stream mid-flight: written outputs are swept, and the in-RAM
    route declines the mixed widths too (None: the engine's tuple
    path)."""
    root = str(tmp_path)
    path = os.path.join(root, "drift.tsst")
    entries = [(b"d%05d" % i, i + 1, P, b"v" * 8) for i in range(2500)]
    entries += [(b"e%05d" % i, i + 1, P, b"w" * 16) for i in range(600)]
    _write_run(path, entries, block_bytes=1024)
    _knobs("always", 256)
    pf, made = _path_factory(root, "o")
    reader = SSTReader(path)
    try:
        assert sm.maybe_stream_merge([reader], None, True, pf, 4096, 0, 10,
                                     1024) is None
        assert made, "the stream wrote no output before the drift"
        outs = GpuCompactionBackend(device="cpu").merge_runs_to_files(
            [reader], None, True, pf, 4096, 0, 10, 8192)
    finally:
        reader.close()
    assert outs is None
    assert [f for f in os.listdir(root) if f.startswith("out-")] == []
    assert sm.CompactionMemoryBudget.get().live_bytes() == 0


class _Boom(Exception):
    pass


def test_a_resolver_that_raises_sweeps_and_reaches_the_caller(tmp_path):
    """A resolver that fails one chunk before the end: the exception
    reaches the caller, every file written so far is swept and the
    budget's live bytes return to 0."""
    root = str(tmp_path)
    paths = _straddle_runs(root)
    _knobs("always", 300)

    def merge(tag, resolver, made):
        pf, made[:] = _path_factory(root, tag)[0], []

        def path_factory():
            made.append(pf())
            return made[-1]

        readers = [SSTReader(p) for p in paths]
        try:
            sm.maybe_stream_merge(readers, UInt64AddOperator(), True,
                                  path_factory, 4096, 0, 10, 1024,
                                  resolver=resolver)
        finally:
            for r in readers:
                r.close()

    counting = _Counting(sm.CpuChunkResolver())
    whole = []
    merge("whole", counting, whole)
    assert len(whole) >= 2

    class Failing(sm.CpuChunkResolver):
        submits = 0

        def submit(self, *a):
            Failing.submits += 1
            if Failing.submits == counting.submits - 1:
                raise _Boom("resolver failed mid-stream")
            return super().submit(*a)

    made = []
    with pytest.raises(_Boom):
        merge("boom", Failing(), made)
    assert Failing.submits == counting.submits - 1
    assert made, "no file was written before the failure"
    assert not any(os.path.exists(p) for p in made)
    assert sm.CompactionMemoryBudget.get().live_bytes() == 0


# ---------------------------------------------------------------------------
# the block source, the knobs
# ---------------------------------------------------------------------------


def _probe_pair(reader_path):
    ref_reader, reader = JaxSSTReader(reader_path), SSTReader(reader_path)
    return (JaxSstBlockLaneSource.probe(ref_reader),
            SstBlockLaneSource.probe(reader), ref_reader, reader)


def test_block_lane_source_probe_matrix(tmp_path):
    """probe() recognises uniform-prop, inferred-uniform and planar files
    and refuses mixed key widths, as the reference's does; decode_blocks
    gives the reference's lanes block by block."""
    root = str(tmp_path)
    uni = _write_run(os.path.join(root, "u.tsst"), [
        (b"u%04d" % i, i + 1, P, pack_u64(i)) for i in range(300)])
    planar = _write_planar_run(os.path.join(root, "p.tsst"), [
        (b"p%05d" % i, i + 1, D if i % 7 == 0 else P,
         b"" if i % 7 == 0 else b"v" * 16) for i in range(2000)])
    with DB(str(tmp_path / "db"), DBOptions(memtable_bytes=1 << 30)) as db:
        for i in range(2000):
            db.put(b"f%05d" % i, b"v" * 12)
        db.flush()
        flushed = db._readers[db._levels[0][0]]._path
    mixed = _write_run(os.path.join(root, "m.tsst"), [
        (b"k" * (3 + (i % 4)), i + 1, P, b"v") for i in range(64)])
    kinds = {}
    for name, path in (("uniform", uni), ("planar", planar),
                       ("flushed", flushed), ("mixed", mixed)):
        want, got, ref_reader, reader = _probe_pair(path)
        try:
            if want is None:
                assert got is None, name
                kinds[name] = None
                continue
            assert (got.kind, got.klen, got.vlen, got.num_blocks,
                    got.num_entries) == (
                want.kind, want.klen, want.vlen, want.num_blocks,
                want.num_entries), name
            kinds[name] = got.kind
            for b in range(got.num_blocks):
                w = want.decode_blocks(b, b + 1)
                g = got.decode_blocks(b, b + 1)
                assert sorted(g) == sorted(w)
                for f in w:
                    np.testing.assert_array_equal(g[f], w[f])
        finally:
            ref_reader.close()
            reader.close()
    assert kinds["uniform"] == "uniform" and kinds["planar"] == "planar"
    assert kinds["mixed"] is None


class _Stalled:
    """An IO budget whose stall pressure holds still (the engine's decays
    with time)."""

    def __init__(self, pressure):
        self.pressure = pressure

    def stall_pressure(self):
        return self.pressure


@pytest.mark.parametrize("stall_ms", [0.0, STALL_BOOST_MS, 120.0, 500.0])
def test_adaptive_chunk_entries_matches_the_reference(stall_ms):
    budget = _Stalled(stall_ms)
    for base in (256, 4096, 1 << 16):
        assert adaptive_chunk_entries(base, budget) == \
            jax_adaptive_chunk_entries(base, budget)
        assert adaptive_chunk_entries(base, None) == base
    shrunk = adaptive_chunk_entries(4096, budget)
    assert 4096 // 4 <= shrunk <= 4096


@pytest.mark.parametrize("raw,want", [
    ("0", "never"), ("never", "never"), ("FALSE", "never"),
    ("1", "always"), ("Always", "always"), ("true", "always"),
    ("auto", "auto"), ("bogus", "auto"), (None, "auto")])
def test_stream_mode_env(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv(sm.ENV_STREAM_MODE, raising=False)
    else:
        monkeypatch.setenv(sm.ENV_STREAM_MODE, raw)
    assert sm.stream_mode() == jax_sm.stream_mode() == want
    sm.STREAM_MODE_OVERRIDE = "never"
    assert sm.stream_mode() == "never"


def test_chunk_entries_env(monkeypatch):
    for raw, want in (("100", sm.MIN_WINDOW_ENTRIES), ("5000", 5000),
                      ("x", sm.DEFAULT_CHUNK_ENTRIES)):
        monkeypatch.setenv(sm.ENV_CHUNK_ENTRIES, raw)
        assert sm.default_chunk_entries() == \
            jax_sm.default_chunk_entries() == want
    sm.CHUNK_ENTRIES_OVERRIDE = 7
    assert sm.default_chunk_entries() == 7
    assert sm.est_row_bytes(2) == jax_sm.est_row_bytes(2) == 76


# ---------------------------------------------------------------------------
# the stream's counters, span and failpoints against the reference's (G1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("merge_op", [None, UInt64AddOperator()],
                         ids=["no-op", "uint64add"])
def test_stream_counters_and_span_match_the_reference(tmp_path, merge_op):
    """The same streamed job through both packages: the same chunk,
    refill, merge and decline counts, each in its own Stats (the port's
    chunks are its ``last_stream_chunks``), and the same compact.stream
    span with its runs, entries and budget."""
    root = str(tmp_path)
    paths = _straddle_runs(root)
    if merge_op is None:
        paths = [paths[0], paths[2]]
    _reference_merge(paths, "ref", root, merge_op, True, "always", 300)
    want = counters(jax_stats)
    want_trace = span_shape(jax_collector)
    reset_observability(rocksplicator_tpu)
    backend = GpuCompactionBackend(device="cpu")
    _port_merge(paths, "s", root, merge_op, True, "always", chunk=300,
                backend=backend)
    got = counters(port_stats)
    assert got == want
    assert got["compaction.stream_chunks"] == backend.last_stream_chunks >= 3
    assert got["compaction.stream_merges"] == 1
    assert got["compaction.stream_declines"] == 0
    assert got["compaction.stream_refills"] >= len(paths)
    # the reference's Stats saw nothing of the port's stream
    assert counters(jax_stats) == dict.fromkeys(G1_COUNTERS, 0.0)
    trace = span_shape(port_collector)
    assert trace == want_trace
    [(name, parent, ann, err)] = trace
    assert (name, parent, err) == ("compact.stream", None, "")
    assert dict(ann)["runs"] == len(paths)


def test_stream_decline_is_counted_as_the_reference(tmp_path):
    """A width drift declines the stream mid-flight in both packages: one
    stream_declines each, the chunks and refills before it equal, no
    stream_merges, and the compact.stream span records the decline."""
    root = str(tmp_path)
    path = os.path.join(root, "drift.tsst")
    entries = [(b"d%05d" % i, i + 1, P, b"v" * 8) for i in range(2500)]
    entries += [(b"e%05d" % i, i + 1, P, b"w" * 16) for i in range(600)]
    _write_run(path, entries, block_bytes=1024)
    _knobs("always", 256)
    results = {}
    for label, mod, reader_cls, stats_mod, col in (
            ("jax", jax_sm, JaxSSTReader, jax_stats, jax_collector),
            ("port", sm, SSTReader, port_stats, port_collector)):
        pf, made = _path_factory(root, label)
        reader = reader_cls(path)
        try:
            out = mod.maybe_stream_merge([reader], None, True, pf, 4096, 0,
                                         10, 1024)
        finally:
            reader.close()
        assert out is None and made
        assert not any(os.path.exists(p) for p in made)
        results[label] = (counters(stats_mod), span_shape(col), len(made))
    assert results["port"] == results["jax"]
    got, trace, _made = results["port"]
    assert got["compaction.stream_declines"] == 1
    assert got["compaction.stream_merges"] == 0
    assert got["compaction.stream_chunks"] >= 2
    [(name, _parent, _ann, err)] = trace
    assert name == "compact.stream" and err == "UnsupportedBatch"


def _armed_merge(label, paths, root, site, spec):
    """One package's streamed merge with ``site`` armed in its own
    registry: (exception class name, files made, files left, trips)."""
    fp_mod = jax_fp if label == "jax" else port_fp
    _knobs("always", 300)
    pf, made = _path_factory(root, label + site)
    fp_mod.activate(site, spec)
    if label == "jax":
        readers = [JaxSSTReader(p) for p in paths]
        backend = TpuCompactionBackend()
    else:
        readers = [SSTReader(p) for p in paths]
        backend = GpuCompactionBackend(device="cpu")
    try:
        with pytest.raises(fp_mod.FailpointError) as exc:
            backend.merge_runs_to_files(readers, UInt64AddOperator(), True,
                                        pf, 4096, 0, 10, 1024)
    finally:
        for r in readers:
            r.close()
        trips = fp_mod.trip_counts()
        fp_mod.reset_for_test()
    return (type(exc.value).__name__, str(exc.value), len(made),
            [p for p in made if os.path.exists(p)], trips)


@pytest.mark.parametrize("site", ["compact.stream.chunk",
                                  "compact.stream.refill"])
def test_armed_stream_site_fails_the_merge_as_the_reference(tmp_path, site):
    """Each package's own site armed at fail_nth:k, k one short of the
    job's count: the merge raises FailpointError after writing a file,
    sweeps every one of them, and the other package's registry is not
    touched."""
    root = str(tmp_path)
    paths = _straddle_runs(root)
    _reference_merge(paths, "count", root, UInt64AddOperator(), True,
                     "always", 300)
    total = counters(jax_stats)[
        "compaction.stream_chunks" if site.endswith("chunk")
        else "compaction.stream_refills"]
    spec = f"fail_nth:{int(total) - 1}"
    want = _armed_merge("jax", paths, root, site, spec)
    got = _armed_merge("port", paths, root, site, spec)
    assert got == want
    name, _msg, made, left, trips = got
    assert name == "FailpointError" and made >= 1 and left == []
    assert trips == {site: 1}
    assert sm.CompactionMemoryBudget.get().live_bytes() == 0
