"""The port's ``admin/ingest_pipeline.py`` (``IngestGate``,
``BatchCompactor``) against the JAX package's: the reference's
BatchCompactor tests (tests/test_load_sst_pipeline.py) and unit tests of
IngestGate, run on both packages' classes; and, with reference DBs, the
port's BatchCompactor on the CPU (``device="cpu"``) against the
reference's ``BatchCompactor(use_tpu=True)`` on jax-CPU: the same files,
the same contents, the same per-DB fallback after a failed launch (D1),
the same dispatch failpoint and the same trace shape. Files are compared
byte for byte, by file number."""

import logging
import os
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import rocksplicator_tpu.admin.ingest_pipeline as jax_pipeline
import rocksplicator_tpu.observability.collector as jax_collector
import rocksplicator_tpu.testing.failpoints as jax_fp
import rocksplicator_tpu.tpu.compaction_service as jax_service
import rocksplicator_tpu_torch.admin.ingest_pipeline as pipeline
import rocksplicator_tpu_torch.observability.collector as collector
import rocksplicator_tpu_torch.testing.failpoints as fp
from rocksplicator_tpu.storage import DB, DBOptions, UInt64AddOperator
from rocksplicator_tpu.storage.merge import MergeOperator
from rocksplicator_tpu.utils.flags import FLAGS
from rocksplicator_tpu_torch.gpu import compaction_service as service
from rocksplicator_tpu_torch.utils.stats import Stats

pack64 = struct.Struct("<q").pack

PACKAGES = {
    "jax": SimpleNamespace(pipeline=jax_pipeline, fp=jax_fp,
                           collector=jax_collector),
    "port": SimpleNamespace(pipeline=pipeline, fp=fp, collector=collector),
}


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """tests/conftest.py resets only the JAX package's singletons; the
    port's, and both failpoint tables, are reset here. The reference runs
    its lax sort path."""
    old = FLAGS.get("sort_backend")
    FLAGS.set("sort_backend", "lax")
    for m in PACKAGES.values():
        m.collector.SpanCollector.reset_for_test()
        m.fp.reset_for_test()
    Stats.reset_for_test()
    yield
    FLAGS.set("sort_backend", old)
    for m in PACKAGES.values():
        m.fp.reset_for_test()


def _compactor(package: str, gpu: bool, **kw):
    cls = PACKAGES[package].pipeline.BatchCompactor
    if package == "jax":
        return cls(use_tpu=gpu, **kw)
    return cls(use_gpu=gpu, device="cpu", **kw)


class StubDB:
    def __init__(self, log_list, name, block=None):
        self._log = log_list
        self._name = name
        self._block = block
        # a custom operator: the batched path declines it to compact_range
        self.options = SimpleNamespace(merge_operator=object())

    def compact_range(self):
        if self._block is not None:
            assert self._block.wait(timeout=30)
        self._log.append(self._name)


def _wait(cond, what):
    deadline = time.monotonic() + 30
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _compact_together(compactor, dbs, held=lambda: None):
    """Submit ``dbs`` while the leader is held on a blocking shard, so
    they ride ONE batch after it (``held`` runs once the leader is held);
    {name: batch size or exception}."""
    gate = threading.Event()
    results = {}

    def submit(name, db):
        try:
            results[name] = compactor.compact(name, db)
        except Exception as exc:
            results[name] = exc

    lead = threading.Thread(target=submit,
                            args=("blocker", StubDB([], "blocker", gate)))
    lead.start()
    _wait(lambda: compactor.dispatch_count == 1, "the leader's dispatch")
    held()
    threads = []
    for name, db in dbs:
        threads.append(threading.Thread(target=submit, args=(name, db)))
        threads[-1].start()
        _wait(lambda: len(compactor._queue) == len(threads), "queueing")
    gate.set()
    for t in [lead] + threads:
        t.join(60)
        assert not t.is_alive()
    return results


# ---------------------------------------------------------------------------
# the reference's BatchCompactor tests, on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_batch_compactor_coalesces_concurrent_shards(package):
    compactor = _compactor(package, False, compact_parallelism=2)
    try:
        done = []
        sizes = _compact_together(compactor, [
            (f"db{i}", StubDB(done, f"db{i}")) for i in (1, 2)])
        assert sorted(done) == ["db1", "db2"]
        assert compactor.batch_sizes == [1, 2]
        assert sizes["db1"] == sizes["db2"] == 2
        assert sizes["blocker"] == 1
    finally:
        compactor.close()


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_batch_compactor_propagates_per_db_errors(package):
    compactor = _compactor(package, False, compact_parallelism=2)
    try:
        class Boom:
            def compact_range(self):
                raise RuntimeError("disk on fire")

        ok = []
        with pytest.raises(RuntimeError, match="disk on fire"):
            compactor.compact("bad", Boom())
        compactor.compact("good", StubDB(ok, "good"))
        assert ok == ["good"]
    finally:
        compactor.close()


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_same_db_twice_in_one_batch_compacts_once(package):
    compactor = _compactor(package, False, compact_parallelism=2)
    try:
        done = []
        db = StubDB(done, "twice")
        sizes = _compact_together(compactor, [("a", db), ("b", db)])
        assert done == ["twice"]
        assert sizes["a"] == sizes["b"] == 2
        assert compactor.batch_sizes == [1, 2]
    finally:
        compactor.close()


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_failed_dispatch_fails_its_batch_and_the_leader_drains_on(package):
    """``compact.dispatch`` armed in the package's own registry: the
    tripped batch fails loudly, the next batch is still dispatched by the
    same leader, and nobody is left waiting."""
    m = PACKAGES[package]
    m.collector.SpanCollector.get().configure(sample_rate=1.0)
    compactor = _compactor(package, False, compact_parallelism=2,
                           max_batch=1)
    try:
        done = []
        # armed once the leader is held: "a" is the first batch it trips
        results = _compact_together(
            compactor, [("a", StubDB(done, "a")), ("b", StubDB(done, "b"))],
            held=lambda: m.fp.activate("compact.dispatch", "fail_nth:1"))
        assert isinstance(results["a"], m.fp.FailpointError)
        assert results["b"] == 1 and results["blocker"] == 1
        assert done == ["b"]
        assert compactor.dispatch_count == 2
        assert compactor.batch_sizes == [1, 1]
        assert not compactor._dispatching
        assert m.fp.trip_counts() == {"compact.dispatch": 1}
        spans = [(s["name"], s["annotations"],
                  (s["error"] or "").split("(")[0])
                 for s in m.collector.SpanCollector.get().snapshot()]
        assert sorted(spans, key=repr) == sorted([
            ("admin.compact_dispatch", {"shards": 1, "tpu": False}, ""),
            ("admin.compact_dispatch",
             {"shards": 1, "tpu": False, "failpoint": "compact.dispatch"},
             "FailpointError"),
            ("admin.compact_dispatch", {"shards": 1, "tpu": False}, "")],
            key=repr)
    finally:
        compactor.close()


# ---------------------------------------------------------------------------
# IngestGate, on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_ingest_gate_try_enter_rejects_over_capacity(package):
    gate = PACKAGES[package].pipeline.IngestGate(2)
    assert [gate.try_enter() for _ in range(3)] == [True, True, False]
    assert gate.in_flight == 2
    gate.exit()
    assert gate.in_flight == 1
    assert gate.try_enter() and not gate.try_enter()


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_ingest_gate_enter_wait_gets_a_freed_slot(package):
    gate = PACKAGES[package].pipeline.IngestGate(1)
    assert gate.enter_wait(0.1)
    timer = threading.Timer(0.05, gate.exit)
    timer.start()
    t0 = time.monotonic()
    assert gate.enter_wait(10.0)
    assert time.monotonic() - t0 < 5.0
    assert gate.in_flight == 1
    timer.join(10)
    assert not timer.is_alive()


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_ingest_gate_enter_wait_times_out(package):
    gate = PACKAGES[package].pipeline.IngestGate(1)
    assert gate.try_enter()
    t0 = time.monotonic()
    assert not gate.enter_wait(0.05)
    assert time.monotonic() - t0 >= 0.04
    assert gate.in_flight == 1 and gate._waiting == 0


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_ingest_gate_enter_wait_refuses_past_max_waiting(package):
    """With the slots taken and ``max_waiting`` callers parked, another
    caller is refused at once; a parked caller still gets the next slot."""
    gate = PACKAGES[package].pipeline.IngestGate(1)
    assert gate.try_enter()
    got = []
    parked = threading.Thread(
        target=lambda: got.append(gate.enter_wait(10.0, max_waiting=1)))
    parked.start()
    _wait(lambda: gate._waiting == 1, "the parked caller")
    t0 = time.monotonic()
    assert not gate.enter_wait(10.0, max_waiting=1)
    assert time.monotonic() - t0 < 1.0
    gate.exit()
    parked.join(10)
    assert got == [True] and gate.in_flight == 1 and gate._waiting == 0


# ---------------------------------------------------------------------------
# on reference DBs: the port on the CPU against the reference on jax-CPU
# ---------------------------------------------------------------------------


class _Concat(MergeOperator):
    """A custom operator: declined to the per-DB path."""

    name = "concat"

    def merge(self, key, existing, operands):
        return (existing or b"") + b"".join(operands)

    def partial_merge(self, key, operands):
        return b"".join(operands)


def _counter_writes(seed, keys=30, rounds=3):
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
        for i in range(40):
            key = f"k{i:07d}".encode()
            if (i + r) % 4 == 0:
                db.delete(key)
            else:
                db.put(key, pack64(i * 3 + r))
        db.flush()


# name: (merge operator class, writes); the counters form one group of
# the batched path, "puts" (no operator) a second, "custom" is declined
ONE_GROUP = {"counters0": (UInt64AddOperator, _counter_writes(0)),
             "counters1": (UInt64AddOperator, _counter_writes(1)),
             "counters2": (UInt64AddOperator, _counter_writes(2))}
TWO_GROUPS = {"counters0": (UInt64AddOperator, _counter_writes(3)),
              "counters1": (UInt64AddOperator, _counter_writes(4)),
              "puts": (None, _puts)}
WITH_DECLINED = {**ONE_GROUP, "puts": (None, _puts),
                 "custom": (_Concat, _puts)}


def _open_dbs(root, specs):
    dbs = []
    for name, (op, write) in specs.items():
        db = DB(str(root / name), DBOptions(
            merge_operator=op() if op else None,
            level0_compaction_trigger=100, memtable_bytes=1 << 30))
        write(db)
        dbs.append((name, db))
    return dbs


def _tsst_bytes(path):
    names = sorted((f for f in os.listdir(path) if f.endswith(".tsst")),
                   key=lambda f: int(f.rsplit("-", 1)[1].split(".")[0]))
    return {f.rsplit("-", 1)[1]: open(os.path.join(path, f), "rb").read()
            for f in names}


def _run(package, root, specs):
    """The DBs of ``specs`` compacted in one batch by the package's
    BatchCompactor on its device path: (waiter results, files by DB,
    contents by DB, admin./tpu. spans of the package's collector)."""
    m = PACKAGES[package]
    m.collector.SpanCollector.reset_for_test()
    m.collector.SpanCollector.get().configure(sample_rate=1.0)
    dbs = _open_dbs(root, specs)
    compactor = _compactor(package, True)
    try:
        results = _compact_together(compactor, dbs)
        assert compactor.batch_sizes == [1, len(dbs)]
        contents = {name: list(db.new_iterator()) for name, db in dbs}
    finally:
        compactor.close()
        for _name, db in dbs:
            db.close()
    files = {name: _tsst_bytes(str(root / name)) for name in specs}
    spans = {}
    by_id = {s["span_id"]: s["name"]
             for s in m.collector.SpanCollector.get().snapshot()}
    for s in m.collector.SpanCollector.get().snapshot():
        if s["name"].startswith(("admin.", "tpu.")):
            key = (s["name"], by_id.get(s["parent_id"]),
                   tuple(sorted(s["annotations"].items())))
            spans[key] = spans.get(key, 0) + 1
    return results, files, contents, spans


def test_batch_compactor_writes_the_reference_files(tmp_path):
    """Three counter DBs and a no-operator DB compact on the device path
    (two groups), a custom-operator DB per DB: every DB ends with the
    reference's files and contents, and the trace has the reference's
    admin. and tpu. spans with their annotations and parents."""
    want = _run("jax", tmp_path / "jax", WITH_DECLINED)
    got = _run("port", tmp_path / "port", WITH_DECLINED)
    assert got[0] == want[0] == {"blocker": 1, **{
        n: len(WITH_DECLINED) for n in WITH_DECLINED}}
    for name in WITH_DECLINED:
        assert got[1][name] == want[1][name], name
        assert got[1][name], name
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert {(name, parent) for name, parent, _ann in got[3]} >= {
        ("admin.compact_stage", "admin.compact_dispatch"),
        ("tpu.compact_batch", "admin.compact_dispatch"),
        ("tpu.kernel", "tpu.compact_batch"),
        ("admin.compact_install", "admin.compact_dispatch")}


class _Broken:
    """Raises on the calls numbered ``fail_from`` and after."""

    def __init__(self, real, fail_from, what):
        self.real, self.fail_from, self.what = real, fail_from, what
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls >= self.fail_from:
            raise RuntimeError(f"{self.what} failed")
        return self.real(*args, **kwargs)


@pytest.mark.parametrize("groups", ["one_group", "two_groups"])
@pytest.mark.parametrize("kernel", ["merge_resolve_batched", "bloom_build"])
def test_failed_launch_falls_back_per_db_as_the_reference(
        kernel, groups, tmp_path, monkeypatch, caplog):
    """D1 on the CPU: a K2 launch or a file's K3 bloom that raises inside
    compact_dbs_batched reaches the port's BatchCompactor, which logs it
    and compacts the DBs of the failed group per DB; the reference's
    compact_dbs_batched declines the failed group itself. Only the second
    group fails in ``two_groups``, and the first group's DBs keep their
    batched compaction in both packages: files and contents are the
    reference's either way."""
    specs = ONE_GROUP if groups == "one_group" else TWO_GROUPS
    # the call that belongs to the failing group: in two_groups the first
    # group (two counter DBs, one file each) makes one K2 call, two K3
    fail_from = 1 if groups == "one_group" else (
        2 if kernel == "merge_resolve_batched" else 3)
    broken = _Broken(getattr(service, kernel), fail_from, kernel)
    monkeypatch.setattr(service, kernel, broken)
    jax_launch = _Broken(jax_service.TpuCompactionService.compact_shard_batch,
                         1 if groups == "one_group" else 2, "launch")
    monkeypatch.setattr(jax_service.TpuCompactionService,
                        "compact_shard_batch",
                        lambda self, *a, **kw: jax_launch(self, *a, **kw))
    raised = []
    real = service.compact_dbs_batched

    def spy(*args, **kwargs):
        try:
            return real(*args, **kwargs)
        except RuntimeError as exc:
            raised.append(str(exc))
            raise

    monkeypatch.setattr(service, "compact_dbs_batched", spy)
    with caplog.at_level(logging.ERROR):
        want = _run("jax", tmp_path / "jax", specs)
        got = _run("port", tmp_path / "port", specs)
    assert raised == [f"{kernel} failed"]
    # every DB of the failing group builds its blooms (the install stage
    # runs them all) before the raise: three calls in either case
    assert broken.calls == (3 if kernel == "bloom_build" else fail_from)
    assert jax_launch.calls == (1 if groups == "one_group" else 2)
    assert any(r.name == pipeline.log.name
               and "per-db fallback" in r.getMessage()
               for r in caplog.records)
    assert got[0] == want[0] == {"blocker": 1, **{
        n: len(specs) for n in specs}}
    assert got[2] == want[2]
    assert all(got[2].values())
    assert got[1] == want[1]


@pytest.mark.parametrize("kernel", ["merge_resolve_batched", "bloom_build"])
def test_failed_launch_on_the_card_fails_its_waiters(kernel, tmp_path,
                                                      monkeypatch, caplog):
    """On the card a failed launch is never hidden behind the per-DB
    path: the waiters of the failed group get the kernel's exception, the
    DBs of the group installed before it keep their result, and no DB is
    compacted twice. The compactor's device reads ``cuda``; the batched
    compaction itself runs on the CPU, with the second group's kernel
    patched to raise."""
    broken = _Broken(getattr(service, kernel),
                     2 if kernel == "merge_resolve_batched" else 3, kernel)
    monkeypatch.setattr(service, kernel, broken)
    real = service.compact_dbs_batched
    monkeypatch.setattr(
        service, "compact_dbs_batched",
        lambda dbs, pool=None, device=None: real(dbs, pool=pool,
                                                 device="cpu"))
    dbs = _open_dbs(tmp_path, TWO_GROUPS)
    before = {name: list(db.new_iterator()) for name, db in dbs}

    def no_fallback(*_a, **_kw):
        raise AssertionError("per-DB fallback taken")

    for _name, db in dbs:
        db.compact_range = no_fallback
        db.schedule_compaction = no_fallback
    compactor = _compactor("port", True)
    compactor.device = torch.device("cuda")
    try:
        with caplog.at_level(logging.ERROR):
            results = _compact_together(compactor, dbs)
        assert compactor.batch_sizes == [1, len(dbs)]
        assert results["blocker"] == 1
        assert results["counters0"] == results["counters1"] == len(dbs)
        assert isinstance(results["puts"], RuntimeError)
        assert str(results["puts"]) == f"{kernel} failed"
        assert any(r.name == pipeline.log.name
                   and "per-db fallback" not in r.getMessage()
                   for r in caplog.records)
        for name, db in dbs:
            assert db._compaction_mutex.acquire(timeout=5), name
            db._compaction_mutex.release()
            assert list(db.new_iterator()) == before[name], name
        files = {name: _tsst_bytes(str(tmp_path / name)) for name in TWO_GROUPS}
        assert len(files["counters0"]) == len(files["counters1"]) == 1
        assert len(files["puts"]) > 1
    finally:
        compactor.close()
        for _name, db in dbs:
            db.close()
