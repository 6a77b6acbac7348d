"""The port's batched compaction service (``gpu/compaction_service.py``,
plain PyTorch path on the CPU) against the JAX package's
``tpu/compaction_service.py`` on jax-CPU: the same shards through
``compact_shard_batch``, ``compact_shard_stream`` and
``resolve_slices_batched``, and the same writes into two sets of reference
DBs compacted by ``compact_dbs_batched``. Tolerance 0: entries, lanes,
counts and bloom words are compared element for element, files byte for
byte."""

import os
import struct

import numpy as np
import pytest

import rocksplicator_tpu.tpu.compaction_service as jax_service
from rocksplicator_tpu.ops.compaction_kernel import MergeKind as JaxKind
from rocksplicator_tpu.ops.kv_format import pack_entries as jax_pack
from rocksplicator_tpu.storage import DB, DBOptions, UInt64AddOperator
from rocksplicator_tpu.storage.merge import MergeOperator
from rocksplicator_tpu.utils.flags import FLAGS
from rocksplicator_tpu_torch.gpu import compaction_service as service
from rocksplicator_tpu_torch.gpu.compaction_service import (
    GpuCompactionService, compact_dbs_batched, resolve_slices_batched,
    resolve_slices_on_device)
from rocksplicator_tpu_torch.ops.compaction_kernel import MergeKind
from rocksplicator_tpu_torch.ops.kv_format import pack_entries
from rocksplicator_tpu_torch.ops.lanes import u32_numpy

pack64 = struct.Struct("<q").pack
LANES = ("key_words_be", "key_words_le", "key_len", "seq_hi", "seq_lo",
         "vtype", "val_words", "val_len")


@pytest.fixture(autouse=True)
def _reference_lax():
    """The reference runs its lax sort path, whatever the environment
    says."""
    old = FLAGS.get("sort_backend")
    FLAGS.set("sort_backend", "lax")
    try:
        yield
    finally:
        FLAGS.set("sort_backend", old)


def _entries(seed, n, *, uniform, uint64_add, hot=0):
    """``n`` entries in random order: 16-byte keys and 32-bit seqs
    (``uniform``), or keys of 5..15 bytes and seqs above 2^32; MERGE /
    PUT / DELETE with 8-byte values (``uint64_add``), or PUT / DELETE
    with values of 1..8 bytes; ``hot`` MERGE operands of one key."""
    rng = np.random.default_rng(seed)
    base = 1 if uniform else (1 << 33) + 7
    out = []
    for i, k in enumerate(rng.integers(0, max(4, n // 3), n)):
        key = (f"key:{k:012d}".encode() if uniform
               else f"k{k}".encode() * (1 + k % 3))
        r = rng.random()
        if uint64_add:
            vt = 3 if r < 0.6 else (1 if r < 0.85 else 2)
            value = b"" if vt == 2 else pack64(int(rng.integers(-99, 1 << 40)))
        else:
            vt = 1 if r < 0.8 else 2
            value = b"" if vt == 2 else bytes(
                rng.integers(0, 256, int(rng.integers(1, 9)), dtype=np.uint8))
        out.append((key, base + i, vt, value))
    out += [(b"key:hot-counter!", base + n + i, 3, pack64(1))
            for i in range(hot)]
    return out


def _pair(shards):
    """The same entries packed by both packages."""
    return ([jax_pack(e) for e in shards], [pack_entries(e) for e in shards])


def _norm(entries):
    return [(k, int(s), int(vt), v) for k, s, vt, v in entries]


def _assert_same(want, got, return_arrays):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g["count"] == w["count"] and isinstance(g["count"], int)
        bw, bg = np.asarray(w["bloom_words"]), g["bloom_words"]
        assert bg.dtype == bw.dtype == np.uint32
        np.testing.assert_array_equal(bg, bw)
        if return_arrays:
            assert set(g["arrays"]) == set(w["arrays"]) == set(LANES)
            for f in LANES:
                wa, ga = np.asarray(w["arrays"][f]), g["arrays"][f]
                assert ga.dtype == wa.dtype, f
                np.testing.assert_array_equal(ga, wa, err_msg=f)
        else:
            assert _norm(g["entries"]) == _norm(w["entries"])


# mixed capacities (37..300 entries, padded to 512) and, in "mixed",
# shards whose fast flags differ (the pooled flags are then off)
SHARD_SETS = {
    "uniform": [dict(seed=1, n=37, uniform=True),
                dict(seed=2, n=150, uniform=True),
                dict(seed=3, n=300, uniform=True)],
    "mixed": [dict(seed=4, n=60, uniform=True),
              dict(seed=5, n=300, uniform=False),
              dict(seed=6, n=129, uniform=False)],
}


@pytest.mark.parametrize("return_arrays", [False, True])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("uint64_add", [True, False])
@pytest.mark.parametrize("shard_set", sorted(SHARD_SETS))
def test_compact_shard_batch_matches_reference(shard_set, uint64_add, drop,
                                               return_arrays):
    shards = [_entries(uint64_add=uint64_add, **spec)
              for spec in SHARD_SETS[shard_set]]
    jax_batches, batches = _pair(shards)
    kind = MergeKind.UINT64_ADD if uint64_add else MergeKind.NONE
    want = jax_service.TpuCompactionService().compact_shard_batch(
        jax_batches, merge_kind=JaxKind(kind.value), drop_tombstones=drop,
        return_arrays=return_arrays)
    got = GpuCompactionService(device="cpu").compact_shard_batch(
        batches, merge_kind=kind, drop_tombstones=drop,
        return_arrays=return_arrays)
    _assert_same(want, got, return_arrays)


def test_overflow_shard_is_recomputed_on_the_host(monkeypatch):
    """A shard with 2^16 operands of one key is flagged and recomputed on
    the host, its bloom at the job's size; the other shard is not."""
    shards = [_entries(7, 90, uniform=True, uint64_add=True),
              _entries(8, 40, uniform=True, uint64_add=True, hot=1 << 16)]
    jax_batches, batches = _pair(shards)
    svc = GpuCompactionService(device="cpu")
    recomputed = []
    real = svc._cpu_recompute

    def spy(batch, *a, **kw):
        recomputed.append(batch.capacity)
        return real(batch, *a, **kw)

    monkeypatch.setattr(svc, "_cpu_recompute", spy)
    for return_arrays in (True, False):
        want = jax_service.TpuCompactionService().compact_shard_batch(
            jax_batches, return_arrays=return_arrays)
        got = svc.compact_shard_batch(batches, return_arrays=return_arrays)
        _assert_same(want, got, return_arrays)
        assert svc.last_host_recomputes == 1
    assert recomputed == [40 + (1 << 16)] * 2
    svc.compact_shard_batch(batches[:1])
    assert svc.last_host_recomputes == 0


def test_compact_shard_stream_matches_reference():
    """7 shards in groups of 3: the last group is padded with empty
    shards; the stream equals the reference's and the port's batch."""
    shards = [_entries(20 + s, 30 + 17 * s, uniform=s % 2 == 0,
                       uint64_add=True) for s in range(7)]
    jax_batches, batches = _pair(shards)
    want = jax_service.TpuCompactionService().compact_shard_stream(
        jax_batches, group_size=3)
    svc = GpuCompactionService(device="cpu")
    got = svc.compact_shard_stream(batches, group_size=3)
    _assert_same(want, got, False)
    _assert_same(want, svc.compact_shard_batch(batches), False)
    arrays = svc.compact_shard_stream(batches, group_size=3,
                                      return_arrays=True)
    _assert_same(jax_service.TpuCompactionService().compact_shard_stream(
        jax_batches, group_size=3, return_arrays=True), arrays, True)


def _slice(entries):
    b = pack_entries(entries)
    n = b.num_valid()
    return {f: getattr(b, f)[:n] for f in LANES}


@pytest.mark.parametrize("drop", [True, False])
def test_resolve_slices_batched_matches_reference(drop):
    """Key-range slices, empty ones among them, resolved as one batch."""
    ents = sorted(_entries(30, 240, uniform=True, uint64_add=True),
                  key=lambda e: (e[0], -e[1]))
    cuts = [0, 0, 100, 100, 170, 240, 240]
    slices = [_slice(ents[a:b]) if b > a else {
        f: v[:0] for f, v in _slice(ents[:1]).items()}
        for a, b in zip(cuts, cuts[1:])]
    want = jax_service.resolve_slices_batched(
        slices, JaxKind.UINT64_ADD, drop)
    got = resolve_slices_batched(slices, MergeKind.UINT64_ADD, drop,
                                 device="cpu")
    assert [c for _a, c in got] == [c for _a, c in want]
    for (wa, wc), (ga, gc) in zip(want, got):
        assert set(ga) == set(wa)
        for f in ga:
            np.testing.assert_array_equal(ga[f], np.asarray(wa[f]))
    assert [c for _a, c in got][0] == 0 and got[0][0] == {}


@pytest.mark.parametrize("drop", [True, False])
def test_resolve_slices_on_device_concatenates_the_slices(drop):
    """The device-resident route gives the per-slice results concatenated
    in slice order; an overflow slice (2^16 operands of one key) is
    recomputed on the host and counted, empty slices are skipped."""
    ents = sorted(_entries(31, 200, uniform=True, uint64_add=True, hot=1 << 16),
                  key=lambda e: (e[0], -e[1]))
    hot = [i for i, e in enumerate(ents) if e[0] == b"key:hot-counter!"]
    cuts = [0, 0, 90, hot[0], hot[-1] + 1, len(ents)]
    slices = [_slice(ents[a:b]) if b > a else {
        f: v[:0] for f, v in _slice(ents[:1]).items()}
        for a, b in zip(cuts, cuts[1:])]
    per_slice = resolve_slices_batched(slices, MergeKind.UINT64_ADD, drop,
                                       device="cpu")
    # each slice in two pieces, as the runs of a job give them
    pieces = [[{f: v[:n // 2] for f, v in sl.items()},
               {f: v[n // 2:] for f, v in sl.items()}]
              for sl in slices for n in [sl["key_len"].shape[0]]]
    out, count = resolve_slices_on_device(pieces, MergeKind.UINT64_ADD, drop,
                                          device="cpu")
    assert GpuCompactionService.instance("cpu").last_host_recomputes == 1
    assert count == sum(c for _a, c in per_slice)
    assert set(out) == set(LANES)
    for f in LANES:
        want = np.concatenate([a[f] for a, c in per_slice if c])
        np.testing.assert_array_equal(u32_numpy(out[f]), want, err_msg=f)


class _Concat(MergeOperator):
    """A custom operator: declined to the per-DB path."""

    name = "concat"

    def merge(self, key, existing, operands):
        return (existing or b"") + b"".join(operands)

    def partial_merge(self, key, operands):
        return b"".join(operands)


def _counter_writes(seed, keys=40, rounds=3):
    def write(db):
        rng = np.random.default_rng(seed)
        for _r in range(rounds):
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
    return write


def _puts(db):
    for r in range(2):
        for i in range(50):
            key = f"k{i:07d}".encode()
            if (i + r) % 4 == 0:
                db.delete(key)
            else:
                db.put(key, pack64(i * 3 + r))
        db.flush()


def _short_value(db):
    db.put(b"counter:00000001", pack64(5))
    db.put(b"counter:00000002", b"abc")  # not 8 bytes under uint64-add
    db.flush()


def _merge_without_operator(db):
    db.put(b"m", b"a")
    db.flush()
    db.merge(b"m", b"b")
    db.flush()


# name: (merge operator class, writes, handled by the batched path)
DB_SPECS = {
    "counters0": (UInt64AddOperator, _counter_writes(0), True),
    "counters1": (UInt64AddOperator, _counter_writes(1), True),
    "counters2": (UInt64AddOperator, _counter_writes(2), True),
    "puts": (None, _puts, True),
    "custom_operator": (_Concat, _puts, False),
    "short_value": (UInt64AddOperator, _short_value, False),
    "merge_without_operator": (None, _merge_without_operator, False),
    "over_the_cap": (UInt64AddOperator, _counter_writes(3, keys=90), False),
    "empty": (UInt64AddOperator, lambda db: None, True),
}


def _open_dbs(root):
    dbs = []
    for name, (op, write, _handled) in DB_SPECS.items():
        db = DB(str(root / name), DBOptions(
            merge_operator=op() if op else None,
            level0_compaction_trigger=100, memtable_bytes=1 << 30))
        write(db)
        dbs.append((name, db))
    return dbs


def _tsst_bytes(path):
    names = sorted((f for f in os.listdir(path) if f.endswith(".tsst")),
                   key=lambda f: int(f.rsplit("-", 1)[1].split(".")[0]))
    return [f.rsplit("-", 1)[1] for f in names], [
        open(os.path.join(path, f), "rb").read() for f in names]


def test_compact_dbs_batched_matches_reference(tmp_path, monkeypatch):
    """Two sets of reference DBs given the same writes: the batched
    compaction writes the same files, handles the same DBs and declines
    the same ones (custom operator, a non-8-byte value under uint64-add,
    MERGE without an operator, a shard over MAX_BATCHED_DB_ENTRIES). The
    three counter DBs take the stream path (groups of 2, the last padded);
    the no-operator DB a batch of its own."""
    monkeypatch.setattr(jax_service, "MAX_BATCHED_DB_ENTRIES", 150)
    monkeypatch.setattr(service, "MAX_BATCHED_DB_ENTRIES", 150)
    results = {}
    for label, fn, kw in (
            ("jax", jax_service.compact_dbs_batched, {}),
            ("gpu", compact_dbs_batched, dict(device="cpu"))):
        dbs = _open_dbs(tmp_path / label)
        try:
            handled, remaining = fn(dbs, group_size=2, **kw)
            reads = {name: list(db.new_iterator()) for name, db in dbs}
        finally:
            for _name, db in dbs:
                db.close()
        files = {name: _tsst_bytes(str(tmp_path / label / name))
                 for name in DB_SPECS}
        results[label] = (sorted(handled), sorted(n for n, _ in remaining),
                          reads, files)
    want, got = results["jax"], results["gpu"]
    assert got[0] == want[0] == sorted(
        n for n, (_o, _w, h) in DB_SPECS.items() if h)
    assert got[1] == want[1]
    assert got[2] == want[2]
    for name, (_op, _write, handled) in DB_SPECS.items():
        (want_nums, want_files), (got_nums, got_files) = (
            want[3][name], got[3][name])
        assert got_nums == want_nums, name
        assert got_nums or name == "empty", name
        for num, w, g in zip(want_nums, want_files, got_files):
            assert g == w, f"{name}: file {num} differs"


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("kernel", ["merge_resolve_batched", "bloom_build"])
def test_failed_kernel_reaches_the_caller(kernel, pool, tmp_path,
                                          monkeypatch):
    """A merge-resolve launch or a file bloom that raises is not turned
    into a per-DB fallback: the exception reaches the caller, and every
    DB's compaction mutex is free again."""
    from concurrent.futures import ThreadPoolExecutor

    def broken(*_a, **_kw):
        raise RuntimeError(f"{kernel} failed")

    monkeypatch.setattr(service, kernel, broken)
    dbs = []
    for s in range(3):
        db = DB(str(tmp_path / f"db{s}"), DBOptions(
            merge_operator=UInt64AddOperator(),
            level0_compaction_trigger=100, memtable_bytes=1 << 30))
        _counter_writes(s, keys=12, rounds=2)(db)
        dbs.append((f"db{s}", db))
    executor = ThreadPoolExecutor(2) if pool else None
    try:
        with pytest.raises(RuntimeError, match=f"{kernel} failed"):
            compact_dbs_batched(dbs, group_size=2, pool=executor,
                                device="cpu")
        for _name, db in dbs:
            assert db._compaction_mutex.acquire(timeout=5)
            db._compaction_mutex.release()
    finally:
        if executor is not None:
            executor.shutdown()
        for _name, db in dbs:
            db.close()
