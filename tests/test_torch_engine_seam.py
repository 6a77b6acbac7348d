"""The port's engine seam against the JAX package's: a reference DB that
compacts through ``GpuCompactionBackend(device="cpu")`` writes the same
``.tsst`` bytes as one that compacts through ``TpuCompactionBackend``
(jax on the CPU, lax path) for the same writes, and serves the same keys,
key-range subcompactions and values wider than 32 bytes included.
Tolerance 0: files are compared byte for byte."""

import os
import struct

import numpy as np
import pytest

import rocksplicator_tpu.storage.native_compaction as jax_native
import rocksplicator_tpu.tpu.backend as jax_backend
from rocksplicator_tpu.ops.kv_format import pack_entries as jax_pack
from rocksplicator_tpu.storage import DB, DBOptions, UInt64AddOperator
from rocksplicator_tpu.storage import stream_merge
from rocksplicator_tpu.storage.merge import MergeOperator
from rocksplicator_tpu.storage.records import OpType
from rocksplicator_tpu.tpu import TpuCompactionBackend
from rocksplicator_tpu.utils.flags import FLAGS
from rocksplicator_tpu_torch.gpu import backend as gpu_backend
from rocksplicator_tpu_torch.gpu import (GpuCompactionBackend,
                                         NumpyCompactionBackend)
from rocksplicator_tpu_torch.ops.kv_format import pack_entries
from rocksplicator_tpu_torch.storage import native_compaction
from rocksplicator_tpu_torch.storage.merge import is_uint64_add

pack64 = struct.Struct("<q").pack


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    """The reference compacts in RAM (no streaming merge) on its lax
    sort path, whatever the environment says."""
    monkeypatch.setattr(stream_merge, "STREAM_MODE_OVERRIDE", "never")
    monkeypatch.setenv("RSTPU_FLAG_SORT_BACKEND", "lax")
    old = FLAGS.get("sort_backend")
    FLAGS.set("sort_backend", "lax")
    try:
        yield
    finally:
        FLAGS.set("sort_backend", old)


def _counters(db, rounds=3, keys=120, seed=0):
    """Counter traffic: merges, puts and deletes over a shared key set,
    one flush per round, 16-byte keys and 8-byte values."""
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        for i in rng.permutation(keys):
            key = f"counter:{i:08d}".encode()
            op = rng.integers(0, 10)
            if op < 6:
                db.merge(key, pack64(int(rng.integers(-50, 1000))))
            elif op < 8:
                db.put(key, pack64(int(rng.integers(0, 1 << 40))))
            else:
                db.delete(key)
        db.flush()


def _puts_and_deletes(db):
    for r in range(2):
        for i in range(150):
            key = f"k{i:07d}".encode()
            if (i + r) % 5 == 0:
                db.delete(key)
            else:
                db.put(key, pack64(i * 7 + r))
        db.flush()


def _split(db):
    for i in range(2000):
        db.put(f"k{i:06d}".encode(), pack64(i))
    db.flush()


def _all_tombstoned(db):
    for i in range(20):
        db.put(f"k{i:03d}".encode(), pack64(i))
        db.delete(f"k{i:03d}".encode())
    db.flush()


def _mixed_widths(db):
    # key and value widths vary: the direct sink declines, the engine
    # takes the tuple path (merge_runs + its own writer)
    for r in range(2):
        for i in range(60):
            db.put(f"k{i}".encode() * (1 + i % 3), b"v" * (1 + (i + r) % 8))
        db.put(b"short", b"v")
        db.flush()


def _long_keys(db):
    for r in range(2):
        for i in range(40):
            db.put(f"{i:032d}".encode(), pack64(i + r))  # 32-byte keys
        db.put(b"short", pack64(r))
        db.flush()


def _wide_values(db):
    # 16-byte keys and 64-byte values: 16 value words through the sort,
    # wider than K1/K2 took before any number of payload lanes
    for r in range(2):
        for i in range(90):
            key = f"wide:{i:011d}".encode()
            if (i + r) % 7 == 0:
                db.delete(key)
            else:
                db.put(key, bytes([(i * 13 + r) % 251]) * 64)
        db.flush()


def _chunked(db):
    # four runs over one key set: each run folds in chunks, then the run
    # summaries fold two by two before the last launch
    rng = np.random.default_rng(3)
    for r in range(4):
        for i in range(100):
            key = f"c{i:05d}".encode()
            if rng.integers(0, 8) == 0:
                db.delete(key)
            else:
                db.merge(key, pack64(int(rng.integers(0, 100))))
        db.flush()


# case: (DBOptions, writes, True where the direct file sink writes the
# compaction's files, False where the engine takes its tuple path)
CASES = {
    "uint64add_drop_tombstones": (dict(merge_operator=UInt64AddOperator),
                                  _counters, True),
    "uint64add_keep_tombstones": (dict(merge_operator=UInt64AddOperator,
                                       allow_ingest_behind=True), _counters,
                                  True),
    "no_operator": (dict(), _puts_and_deletes, True),
    "split_at_target_file_bytes": (dict(merge_operator=UInt64AddOperator,
                                        target_file_bytes=8 * 1024), _split,
                                   True),
    "all_tombstoned": (dict(), _all_tombstoned, True),
    "mixed_widths_tuple_path": (dict(), _mixed_widths, False),
    "long_keys_cpu_path": (dict(merge_operator=UInt64AddOperator),
                           _long_keys, False),
    "chunked": (dict(merge_operator=UInt64AddOperator), _chunked, False),
    "wide_values_planar": (dict(), _wide_values, True),
    "subcompactions": (dict(merge_operator=UInt64AddOperator,
                            max_subcompactions=4), _counters, True),
}


def _tsst_bytes(path):
    """The db's .tsst files in file-number order (names carry a random
    per-db incarnation before the number)."""
    names = sorted((f for f in os.listdir(path) if f.endswith(".tsst")),
                   key=lambda f: f.rsplit("-", 1)[1])
    return [f.rsplit("-", 1)[1] for f in names], [
        open(os.path.join(path, f), "rb").read() for f in names]


def _run_db(path, backend, opts, write):
    opts = dict(opts)
    if "merge_operator" in opts:
        opts["merge_operator"] = opts["merge_operator"]()
    db = DB(str(path), DBOptions(compaction_backend=backend,
                                 level0_compaction_trigger=100,
                                 memtable_bytes=1 << 30, **opts))
    try:
        write(db)
        db.compact_range()
        # a second compaction reads the files the first one wrote
        write(db)
        db.compact_range()
        items = list(db.new_iterator())
        keys = [k for k, _v in items] + [b"missing-key"]
        gets = [db.get(k) for k in keys]
    finally:
        db.close()
    return _tsst_bytes(str(path)), items, gets


@pytest.mark.parametrize("case", sorted(CASES))
def test_gpu_backend_writes_the_reference_files(case, tmp_path,
                                                monkeypatch):
    opts, write, direct = CASES[case]
    chunked_calls = []
    if case == "chunked":
        monkeypatch.setattr(jax_backend, "MAX_TPU_ENTRIES", 256)
        monkeypatch.setattr(gpu_backend, "MAX_LAUNCH_ENTRIES", 256)
        real = gpu_backend.chunked_merge

        def spy(*a, **kw):
            out = real(*a, **kw)
            chunked_calls.append(out is not None)
            return out

        monkeypatch.setattr(gpu_backend, "chunked_merge", spy)
    gpu = GpuCompactionBackend(device="cpu")
    sliced = []
    if case == "subcompactions":
        # slices of 32 entries: both packages cut every job in four
        monkeypatch.setattr(jax_native, "MIN_SLICE_ENTRIES", 32)
        monkeypatch.setattr(native_compaction, "MIN_SLICE_ENTRIES", 32)
        real_sub = gpu._subcompact_arrays

        def sub_spy(*a, **kw):
            out = real_sub(*a, **kw)
            sliced.append(out is not None)
            return out

        gpu._subcompact_arrays = sub_spy
    sink = gpu.merge_runs_to_files
    wrote = []

    def sink_spy(*a, **kw):
        out = sink(*a, **kw)
        wrote.append(out is not None)
        return out

    gpu.merge_runs_to_files = sink_spy
    want = _run_db(tmp_path / "tpu", TpuCompactionBackend(), opts, write)
    got = _run_db(tmp_path / "gpu", gpu, opts, write)
    assert wrote == [direct, direct], wrote
    (want_names, want_files), want_items, want_gets = want
    (got_names, got_files), got_items, got_gets = got
    assert got_names == want_names
    for name, w, g in zip(want_names, want_files, got_files):
        assert g == w, f"{case}: {name} differs"
    assert got_items == want_items
    assert got_gets == want_gets
    if case == "all_tombstoned":
        assert want_names == [] and want_items == []
    if case == "split_at_target_file_bytes":
        assert len(want_names) > 1
    if case == "chunked":
        assert chunked_calls and all(chunked_calls), chunked_calls
    if case == "subcompactions":
        assert sliced == [True, True], sliced


def _entries(seed, n=300, keys=60, klen=10):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(1, n + 1):
        key = f"{int(rng.integers(0, keys)):0{klen}d}".encode()
        vt = int(rng.choice([1, 2, 3], p=[0.3, 0.2, 0.5]))
        value = b"" if vt == 2 else pack64(int(rng.integers(-9, 1 << 33)))
        out.append((key, s, vt, value))
    return sorted(out, key=lambda e: (e[0], -e[1]))


class _Concat(MergeOperator):
    """A custom operator: the backends route it to the heap merge."""

    name = "concat"

    def merge(self, key, existing, operands):
        return (existing or b"") + b"".join(operands)

    def partial_merge(self, key, operands):
        return b"".join(operands)


@pytest.mark.parametrize("op", ["uint64add", "none", "custom"])
@pytest.mark.parametrize("drop", [True, False])
def test_merge_runs_matches_reference(op, drop):
    merge_op = {"uint64add": UInt64AddOperator(), "none": None,
                "custom": _Concat()}[op]
    entries = _entries(7)
    if op == "none":  # MERGE without an operator is a CPU route of its own
        entries = [e for e in entries if e[2] != OpType.MERGE]
    runs = [entries[0::2], entries[1::2]]
    want = list(TpuCompactionBackend().merge_runs(runs, merge_op, drop))
    got = list(GpuCompactionBackend(device="cpu").merge_runs(
        runs, merge_op, drop))
    assert [tuple(map(int, (s, vt))) + (k, v) for k, s, vt, v in got] == [
        tuple(map(int, (s, vt))) + (k, v) for k, s, vt, v in want]


@pytest.mark.parametrize("uint64_add", [True, False])
@pytest.mark.parametrize("drop", [True, False])
def test_numpy_merge_resolve_matches_reference(uint64_add, drop):
    entries = _entries(11, n=500, keys=90)
    want, wn = jax_backend.numpy_merge_resolve(
        jax_pack(entries), uint64_add, drop)
    got, gn = gpu_backend.numpy_merge_resolve(
        pack_entries(entries), uint64_add, drop)
    assert gn == wn
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    ref = list(jax_backend.NumpyCompactionBackend().merge_runs(
        [entries], UInt64AddOperator() if uint64_add else None, drop))
    port = list(NumpyCompactionBackend().merge_runs(
        [entries], UInt64AddOperator() if uint64_add else None, drop))
    assert [(k, int(s), int(vt), v) for k, s, vt, v in port] == [
        (k, int(s), int(vt), v) for k, s, vt, v in ref]


def test_uint64_add_is_recognised_by_name():
    assert is_uint64_add(UInt64AddOperator())
    assert not is_uint64_add(_Concat())
    assert not is_uint64_add(None)


def test_file_sink_refuses_capabilities_it_lacks(tmp_path):
    """Subcompactions are taken; the memory budget is not ported yet."""
    backend = GpuCompactionBackend(device="cpu")
    assert backend.supports_subcompactions
    assert not backend.supports_memory_budget
    args = ([], None, True, lambda: str(tmp_path / "x.tsst"), 32768, 1, 10,
            1 << 20)
    for kw in (dict(memory_budget_bytes=1), dict(mem_tracker=object())):
        with pytest.raises(TypeError):
            backend.merge_runs_to_files(*args, **kw)
    assert backend.merge_runs_to_files(*args) is None
    assert backend.merge_runs_to_files(*args, max_subcompactions=4) is None
