"""The port's CDC stack against the JAX package's: the exactly-once
consumer (``kafka/ingestion.py``), the CDC observer service
(``admin/cdc.py``) and the message-ingestion RPCs, each scenario on both
packages with equal results (tolerance 0).

- ``tests/test_cdc_exactly_once.py``: a consumer killed at each seam
  (``kafka.fetch``, ``kafka.apply``, ``kafka.checkpoint``) resumes from
  its durable watermark, once and twice; a leader failover mid-consume.
  The two chaos cases run each package's own ``run_cdc_chaos`` (the
  reference's ``tools.chaos_soak``, the port's
  ``rocksplicator_tpu_torch.tools.chaos_soak`` on the plain path): the
  deck's first schedule, a checkpoint-seam kill against a semi-sync
  three-replica group with the invariant on every replica, and the
  ``cdc_dedup`` tooth that decouples the watermark from its batch, with
  the reference's seeds and asserts.
- ``tests/test_admin.py``: the ingestion RPCs' error paths (F9: the port's
  ``start_message_ingestion`` imported a module it lacked), the observer
  publishing updates, a failing publisher (at least once) and a
  concurrent duplicate ``add_observer``.
- The slice: one seeded stream of CDC records (11-byte keys, 256-byte
  values, a tenth of them deletes) consumed from an embedded topic into a
  three-replica semi-sync shard whose leader has a CDC observer, with
  small memtables so the replicas compact; the reference's replicas on
  ``TpuCompactionBackend`` (jax-CPU), the port's on
  ``GpuCompactionBackend(device="cpu")``. Files, seqs, watermarks, reads
  and the observer's output are equal, and the port's compactions pack
  the 256-byte values into K2's lanes (W = 64) where the reference takes
  them to the host.
"""

import asyncio
import importlib
import os
import random

import numpy as np
import pytest

from torch_parity import (PACKAGES, AdminClient, AdminNode, ReplPackage,
                          reset_both, tsst_digests, wait_until)

PKGS = [ReplPackage("ref"), ReplPackage("port")]
PORT = PKGS[1]
TOPIC = "cdc_t"


def kafka(pkg, name):
    return importlib.import_module(f"{PACKAGES[pkg.key]}.kafka.{name}")


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield
    reset_both()


@pytest.fixture(params=PKGS, ids=repr)
def pkg(request):
    return request.param


@pytest.fixture()
def small_batches(monkeypatch):
    """The reference's shape: a couple hundred messages span many fetch
    rounds and batches, so a mid-batch kill has progress to tear."""
    for p in PKGS:
        ing = kafka(p, "ingestion")
        monkeypatch.setattr(ing, "MAX_DRAIN", 40)
        monkeypatch.setattr(ing, "BATCH_RECORDS", 16)


def _produce_deck(cluster, n, base_ts=1000):
    expect = {}
    for i in range(n):
        key = b"k%03d" % (i % 150)
        value = b"" if (i % 37 == 0 and i > 0) else b"v%d" % i
        cluster.produce(TOPIC, 0, key, value, timestamp_ms=base_ts + i)
        if value:
            expect[key] = value
        else:
            expect.pop(key, None)
    return expect


def _fold_matches(engine, expect):
    return all(engine.get(k) == v for k, v in expect.items())


def _watcher(pkg, target, consumer, name="ev00000"):
    w = kafka(pkg, "ingestion").IngestionWatcher(
        None, name, target, consumer, TOPIC, [0], 0)
    w.start()
    return w


def _dump(db):
    return list(db.new_iterator())


SEAM_KILLS = {
    "kafka.fetch": "fail_nth:3",
    "kafka.apply": "fail_nth:2",
    "kafka.checkpoint": "fail_nth:5",
}


def _crash_resume(pkg, root, seam):
    b, cp = kafka(pkg, "broker"), kafka(pkg, "checkpoint")
    cluster = b.MockKafkaCluster()
    cluster.create_topic(TOPIC, 1)
    expect = _produce_deck(cluster, 200)
    path = os.path.join(root, pkg.key)
    db = pkg.open_db(path)
    pkg.fp.activate(seam, SEAM_KILLS[seam])
    w = _watcher(pkg, db, b.MockConsumer(cluster))
    try:
        assert wait_until(lambda: w.error is not None, timeout=15), seam
        assert wait_until(lambda: not w.alive, timeout=15)
    finally:
        w.stop()
    pkg.fp.clear()
    wm = cp.read_watermark(db, TOPIC, 0)
    applied_before = 0 if wm is None else wm["offset"]
    assert applied_before < 200
    assert cp.read_applies(db, TOPIC, 0) == applied_before
    db.close()
    db = pkg.open_db(path)
    try:
        w2 = _watcher(pkg, db, b.MockConsumer(cluster))
        try:
            assert wait_until(lambda: w2.watermark(0) == 200, timeout=15)
            assert wait_until(w2.replay_done.is_set, timeout=15)
            for i in range(10):
                cluster.produce(TOPIC, 0, b"live%d" % i, b"lv%d" % i,
                                timestamp_ms=9000 + i)
                expect[b"live%d" % i] = b"lv%d" % i
            assert wait_until(lambda: w2.watermark(0) == 210, timeout=15)
            assert w2.error is None
        finally:
            w2.stop()
        assert cp.read_watermark(db, TOPIC, 0)["offset"] == 210
        assert cp.read_applies(db, TOPIC, 0) == 210
        assert _fold_matches(db, expect)
        return applied_before, _dump(db)
    finally:
        db.close()


@pytest.mark.parametrize("seam", sorted(SEAM_KILLS))
def test_crash_resume_exactly_once_at_seam(tmp_path, small_batches, seam):
    """A consumer killed at each seam resumes from the durable watermark:
    watermark == applies counter == produced, the state the fold of the
    log; the port tears at the same offset and ends in the reference's
    state, key for key."""
    got = {p.key: _crash_resume(p, str(tmp_path), seam) for p in PKGS}
    assert got["port"] == got["ref"]


def test_resume_survives_double_crash_same_seam(tmp_path, small_batches,
                                                pkg):
    b, cp = kafka(pkg, "broker"), kafka(pkg, "checkpoint")
    cluster = b.MockKafkaCluster()
    cluster.create_topic(TOPIC, 1)
    expect = _produce_deck(cluster, 200)
    db = pkg.open_db(tmp_path / "db")
    try:
        for _ in range(2):
            pkg.fp.activate("kafka.apply", "fail_nth:2")
            w = _watcher(pkg, db, b.MockConsumer(cluster))
            assert wait_until(lambda: w.error is not None, timeout=15)
            w.stop()
            pkg.fp.clear()
        w = _watcher(pkg, db, b.MockConsumer(cluster))
        try:
            assert wait_until(lambda: w.watermark(0) == 200, timeout=15)
        finally:
            w.stop()
        assert cp.read_watermark(db, TOPIC, 0)["offset"] == 200
        assert cp.read_applies(db, TOPIC, 0) == 200
        assert _fold_matches(db, expect)
    finally:
        db.close()


# -- the chaos deck's CDC schedules, each package's own ----------------------

CHAOS_DB = "seg00001"


def _run_cdc_chaos(pkg, root, **kw):
    """``run_cdc_chaos`` of ``pkg``'s chaos harness: the reference's
    ``tools.chaos_soak``, or the port's copy on the plain PyTorch path."""
    if pkg.key == "ref":
        mod = importlib.import_module("tools.chaos_soak")
    else:
        mod = importlib.import_module(
            "rocksplicator_tpu_torch.tools.chaos_soak")
        kw["device"] = "cpu"
    return mod.run_cdc_chaos(root, log=lambda *a: None, **kw)


class _ApplyTarget:
    """ApplicationDB-shaped: ``.db`` is the local engine, ``write_many``
    replicates each batch (the watermark rides with its records)."""

    def __init__(self, engine, rdb):
        self.db = engine
        self._rdb = rdb

    def write_many(self, batches):
        for b in batches:
            self._rdb.write(b)


class _Group:
    """A leader and two followers over TCP, semi-sync (mode 1)."""

    def __init__(self, pkg, root, flags, **db_kw):
        self.hosts = [pkg.Replicator(port=0, flags=flags) for _ in range(3)]
        self.dbs = [pkg.open_db(os.path.join(root, f"n{i}", CHAOS_DB),
                                **db_kw) for i in range(3)]
        leader = ("127.0.0.1", self.hosts[0].port)
        self.rdbs = [
            self.hosts[i].add_db(
                CHAOS_DB, pkg.StorageDbWrapper(self.dbs[i]),
                pkg.ReplicaRole.LEADER if i == 0
                else pkg.ReplicaRole.FOLLOWER,
                upstream_addr=None if i == 0 else leader,
                replication_mode=1, epoch=1)
            for i in range(3)]

    def converged(self, dbs=None):
        dbs = dbs or self.dbs
        lat = dbs[0].latest_sequence_number_relaxed()
        return all(d.latest_sequence_number_relaxed() == lat
                   for d in dbs[1:])

    def stop(self):
        for h in self.hosts:
            h.stop()
        for d in self.dbs:
            d.close()


def test_cdc_chaos_smoke(tmp_path, pkg):
    """One pass of the cdc_burst chaos deck's first schedule (the
    checkpoint-seam kill): a kill/resume cycle against a real 3-replica
    group must hold invariant 8 (exactly-once on every serving
    replica)."""
    result = _run_cdc_chaos(pkg, str(tmp_path / "chaos"), schedules=1,
                            seed=11)
    assert result["violations"] == []
    assert result["consumer_starts"] >= 2  # a resume actually happened
    assert result["failpoint_trips"].get("kafka.checkpoint", 0) >= 1


def test_cdc_chaos_catches_decoupled_checkpoint(tmp_path, pkg):
    """The tooth: a consumer whose offset checkpoint is decoupled from
    its apply batch must be CAUGHT by the applies-counter witness."""
    result = _run_cdc_chaos(pkg, str(tmp_path / "chaos"), schedules=1,
                            seed=1, break_guard="cdc_dedup")
    assert result["violations"], "cdc_dedup tooth NOT caught"
    assert any("applies_total" in v for v in result["violations"])


def test_leader_failover_mid_consume_resumes_exactly_once(tmp_path, pkg):
    """Consume into the leader of a semi-sync group, depose it (epoch-2
    promotion and the fencing pull), restart the consumer against the
    promoted follower: it resumes from its own replicated watermark."""
    b, cp = kafka(pkg, "broker"), kafka(pkg, "checkpoint")
    cluster = b.MockKafkaCluster()
    cluster.create_topic(TOPIC, 1)
    expect = _produce_deck(cluster, 60)
    flags = pkg.ReplicationFlags(
        server_long_poll_ms=200, pull_error_delay_min_ms=30,
        pull_error_delay_max_ms=80, ack_timeout_ms=60_000, write_window=8)
    repl = _Group(pkg, str(tmp_path), flags)
    old_leader = repl.rdbs[0]
    try:
        w = _watcher(pkg, _ApplyTarget(repl.dbs[0], old_leader),
                     b.MockConsumer(cluster), name=CHAOS_DB)
        assert wait_until(lambda: w.watermark(0) == 60, timeout=15)
        assert wait_until(repl.converged, timeout=15)
        repl.hosts[1].remove_db(CHAOS_DB)
        new_leader = repl.hosts[1].add_db(
            CHAOS_DB, pkg.StorageDbWrapper(repl.dbs[1]),
            pkg.ReplicaRole.LEADER, replication_mode=1, epoch=2)
        repl.rdbs[1] = new_leader
        repl.rdbs[2].adopt_epoch(2)
        assert wait_until(lambda: old_leader.fenced, timeout=10)
        for i in range(40):
            k, v = b"post%02d" % i, b"pv%d" % i
            cluster.produce(TOPIC, 0, k, v, timestamp_ms=7000)
            expect[k] = v
        assert wait_until(lambda: w.error is not None, timeout=10)
        w.stop()
        repl.rdbs[2].reset_upstream(("127.0.0.1", repl.hosts[1].port))
        wm = cp.read_watermark(repl.dbs[1], TOPIC, 0)
        assert wm is not None and wm["offset"] == 60
        w2 = _watcher(pkg, _ApplyTarget(repl.dbs[1], new_leader),
                      b.MockConsumer(cluster), name=CHAOS_DB)
        try:
            assert wait_until(lambda: w2.watermark(0) == 100, timeout=15)
            assert w2.error is None
        finally:
            w2.stop()
        assert cp.read_watermark(repl.dbs[1], TOPIC, 0)["offset"] == 100
        assert cp.read_applies(repl.dbs[1], TOPIC, 0) == 100
        assert _fold_matches(repl.dbs[1], expect)
        assert wait_until(
            lambda: cp.read_applies(repl.dbs[2], TOPIC, 0) == 100,
            timeout=15)
    finally:
        repl.stop()


# -- the admin plane: ingestion RPC errors and the observer service ---------

@pytest.fixture()
def nodes(tmp_path, pkg):
    created = []

    def make(name, **kw):
        n = AdminNode(pkg, tmp_path, name, **kw)
        created.append(n)
        return n

    yield make
    for n in created:
        n.stop()


@pytest.fixture()
def call(pkg):
    client = AdminClient(pkg)
    yield client
    client.close()


def test_message_ingestion_error_paths(pkg, nodes, call):
    """F9: the port's start_message_ingestion answers DB_ADMIN_ERROR for
    an unknown topic and an unparseable broker address (it raised
    ModuleNotFoundError while the port had no ``kafka/``)."""
    n = nodes("a")
    call(n, "add_db", db_name="seg00001", role="LEADER")
    with pytest.raises(pkg.RpcApplicationError) as ei:
        call(n, "start_message_ingestion", db_name="seg00001",
             topic_name="no-such-topic")
    assert ei.value.code == "DB_ADMIN_ERROR"
    with pytest.raises(pkg.RpcApplicationError) as ei3:
        call(n, "start_message_ingestion", db_name="seg00001",
             topic_name="t", kafka_broker_serverset_path="/etc/brokers")
    assert ei3.value.code == "DB_ADMIN_ERROR"
    assert "bad broker address" in ei3.value.message
    with pytest.raises(pkg.RpcApplicationError) as ei2:
        call(n, "stop_message_ingestion", db_name="seg00001")
    assert ei2.value.code == "DB_NOT_FOUND"


def test_cdc_observer_publishes_updates(pkg, nodes, call):
    cdc_mod = pkg.mod("admin.cdc")
    a = nodes("a")
    call(a, "add_db", db_name="seg00001", role="LEADER")
    adb = a.app_db("seg00001")
    adb.write(pkg.WriteBatch().put(b"before", b"x"))
    cdc_node = nodes("cdc")
    publisher = cdc_mod.MemoryPublisher()
    cdc = cdc_mod.CdcAdminHandler(cdc_node.replicator, publisher)
    server = pkg.RpcServer(port=0, ioloop=cdc_node.replicator.ioloop)
    server.add_handler(cdc)
    server.start()
    pool = pkg.RpcClientPool()
    ioloop = pkg.IoLoop.default()

    def cdc_call(method, **args):
        async def go():
            return await pool.call("127.0.0.1", server.port, method, args)
        return ioloop.run_sync(go())

    try:
        r = cdc_call("add_observer", db_name="seg00001",
                     upstream_ip=a.repl_addr[0], upstream_port=a.repl_addr[1])
        assert r["start_seq"] == 1
        with pytest.raises(pkg.RpcApplicationError):
            cdc_call("add_observer", db_name="seg00001",
                     upstream_ip=a.repl_addr[0],
                     upstream_port=a.repl_addr[1])
        adb.write(pkg.WriteBatch().put(b"k1", b"v1"))
        adb.write(pkg.WriteBatch().delete(b"k0"))
        assert wait_until(lambda: len(publisher.buffer) >= 2, timeout=15)
        db_name, start_seq, raw, _ts = publisher.buffer[0]
        assert (db_name, start_seq) == ("seg00001", 2)
        ops = list(pkg.mod("storage.records").decode_batch(raw).ops())
        assert (pkg.OpType.PUT, b"k1", b"v1") in ops
        check = cdc_call("check_observer", db_name="seg00001")
        assert check["seq_num"] == 3 and check["published_count"] == 2
        assert cdc_call("get_sequence_number",
                        db_name="seg00001")["seq_num"] == 3
        cdc_call("remove_observer", db_name="seg00001")
        with pytest.raises(pkg.RpcApplicationError):
            cdc_call("check_observer", db_name="seg00001")
    finally:
        ioloop.run_sync(pool.close())
        server.stop()
        cdc.close()


def test_cdc_publisher_failure_is_at_least_once(pkg, nodes, call):
    a = nodes("a")
    call(a, "add_db", db_name="seg00001", role="LEADER")
    failures, published = [2], []

    def flaky_publisher(db_name, start_seq, raw, ts):
        if failures[0] > 0:
            failures[0] -= 1
            raise RuntimeError("broker down")
        published.append((start_seq, raw))

    cdc_node = nodes("cdc")
    cdc = pkg.mod("admin.cdc").CdcAdminHandler(cdc_node.replicator,
                                                flaky_publisher)
    try:
        cdc_node.replicator.ioloop.run_coro(cdc.handle_add_observer(
            db_name="seg00001", upstream_ip=a.repl_addr[0],
            upstream_port=a.repl_addr[1])).result(10)
        a.app_db("seg00001").write(pkg.WriteBatch().put(b"k", b"v"))
        assert wait_until(lambda: len(published) == 1, timeout=20)
        assert published[0][0] == 1
    finally:
        cdc.close()


def test_concurrent_duplicate_add_observer_typed_error(pkg, nodes,
                                                       monkeypatch):
    Cdc = pkg.mod("admin.cdc").CdcAdminHandler
    a = nodes("a")
    cdc = Cdc(a.replicator, pkg.mod("admin.cdc").MemoryPublisher())
    real = Cdc._do_add_observer

    async def slow(self, *args, **kw):
        await asyncio.sleep(0.5)
        return await real(self, *args, **kw)

    monkeypatch.setattr(Cdc, "_do_add_observer", slow)

    async def both():
        t1 = asyncio.ensure_future(cdc.handle_add_observer(
            db_name="segX", upstream_ip="127.0.0.1", upstream_port=1))
        await asyncio.sleep(0.05)
        try:
            await cdc.handle_add_observer(
                db_name="segX", upstream_ip="127.0.0.1", upstream_port=1)
            code = None
        except pkg.RpcApplicationError as e:
            code = e.code
        t1.cancel()
        try:
            await t1
        except (asyncio.CancelledError, Exception):
            pass
        return code

    try:
        assert a.replicator.ioloop.run_coro(both()).result(10) == \
            "OBSERVER_ALREADY_EXISTS"
    finally:
        cdc.close()


# -- the tuple path's value lanes ---------------------------------------------

def _wide_runs(seed):
    rng = random.Random(seed)
    runs, seq = [], 1
    for _r in range(3):
        run = []
        for i in sorted(rng.sample(range(300), 120)):
            v = rng.randbytes(rng.choice([0, 256, 256, 40]))
            run.append((b"cdc%08d" % i, seq, 2 if not v else 1, v))
            seq += 1
        run.sort(key=lambda e: (e[0], -e[1]))
        runs.append(run)
    runs.append([(b"\x00cdc\x00wm\x00t\x000", seq, 1, b'{"offset": 9}')])
    return runs


@pytest.mark.parametrize("drop", [False, True])
def test_tuple_path_packs_wide_values_for_the_card(drop, monkeypatch):
    """Entries of mixed widths with 256-byte values: the reference's
    tuple path merges them on the host; the port's packs them into K2's
    lanes at 64 value words (its plain version on the CPU) and returns
    the reference's entries, element for element. Values past
    MAX_TUPLE_VAL_BYTES go to the host."""
    from rocksplicator_tpu.tpu.backend import TpuCompactionBackend
    from rocksplicator_tpu_torch.gpu import backend as gb

    widths = []
    real = gb.GpuCompactionBackend._run_batch

    def spy(self, batch, *args):
        widths.append(batch.val_words.shape[1])
        return real(self, batch, *args)

    monkeypatch.setattr(gb.GpuCompactionBackend, "_run_batch", spy)
    runs = _wide_runs(1)
    want = list(TpuCompactionBackend().merge_runs(runs, None, drop))
    got = list(gb.GpuCompactionBackend(device="cpu").merge_runs(
        runs, None, drop))
    assert got == want
    assert widths == [64]
    big = runs + [[(b"big", 10_000, 1, b"x" * (gb.MAX_TUPLE_VAL_BYTES + 1))]]
    got = list(gb.GpuCompactionBackend(device="cpu").merge_runs(
        big, None, drop))
    assert got == list(TpuCompactionBackend().merge_runs(big, None, drop))
    assert widths == [64]


def test_inline_l0_compaction_waits_for_a_full_compaction(tmp_path):
    """F11, in the JAX package's engine: with inline compaction a write's
    flush could compact L0 while compact_range merged off the DB lock. With
    no level below L1 yet, that L0 compaction dropped a tombstone whose
    shadowed PUT compact_range then installed at the bottom: a deleted key
    read back. The port's flush leaves L0 alone while the compaction mutex
    is held; the delete holds."""
    import threading

    db = PORT.open_db(tmp_path / "db", level0_compaction_trigger=2)
    merging, resume = threading.Event(), threading.Event()
    real = db._write_merged

    def held(*args, **kw):
        if threading.current_thread().name == "full":
            merging.set()
            assert resume.wait(30)
        return real(*args, **kw)

    db._write_merged = held
    try:
        db.put(b"k", b"old")
        db.put(b"other", b"x")
        db.flush()
        full = threading.Thread(target=db.compact_range, name="full")
        full.start()
        assert merging.wait(30)
        db.delete(b"k")
        db.flush()  # L0 at the trigger while compact_range merges
        resume.set()
        full.join(30)
        assert not full.is_alive()
        assert db.get(b"k") is None
        db.put(b"more", b"y")
        db.flush()  # the next flush compacts L0, tombstone kept
        assert db._levels[0] == []
        assert db.get(b"k") is None and db.get(b"other") == b"x"
    finally:
        resume.set()
        db.close()


# -- the slice: a CDC stream into a three-replica shard with an observer ----

SLICE_DB = "seg00000"
SLICE_RECORDS = 3000


def _slice_stream(seed=11):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SLICE_RECORDS // 2, SLICE_RECORDS)
    deletes = rng.random(SLICE_RECORDS) < 0.1
    values = rng.integers(0, 256, (SLICE_RECORDS, 256), dtype=np.uint8)
    return [(b"cdc%08d" % i, b"" if d else v.tobytes())
            for i, d, v in zip(ids.tolist(), deletes.tolist(), values)]


def _run_slice(pkg, root, stream):
    """The stream into ``cdc_in`` of an embedded cluster, A leading (with
    D, a CDC observer, publishing into ``cdc_out``), B and C following in
    mode 1; ingestion through A's start_message_ingestion; compact_db on
    C, B, A halfway and on each once more after the drain."""
    b = kafka(pkg, "broker")
    broker = b.get_cluster("slice")
    broker.create_topic("cdc_in", 1)
    broker.create_topic("cdc_out", 1)
    half = len(stream) // 2
    for i, (k, v) in enumerate(stream[:half]):
        broker.produce("cdc_in", 0, k, v, timestamp_ms=1000 + i)
    kw = {"tpu_compaction": True} if pkg.key == "ref" else {}

    def options(segment):
        return pkg.DBOptions(memtable_bytes=64 << 10, max_subcompactions=1,
                             level0_compaction_trigger=4,
                             background_compaction=True)

    nodes = {t: AdminNode(pkg, root, t, options_generator=options, **kw)
             for t in "ABC"}
    call = AdminClient(pkg)
    cdc_mod = pkg.mod("admin.cdc")
    publisher = kafka(pkg, "publisher").QueuePublisher(
        "cdc_out", broker, num_partitions=1)
    observer_host = pkg.Replicator(port=0, flags=pkg.flags())
    observer = cdc_mod.CdcAdminHandler(observer_host, publisher)
    try:
        call(nodes["A"], "add_db", db_name=SLICE_DB, role="LEADER",
             replication_mode=1)
        for t in "BC":
            call(nodes[t], "add_db", db_name=SLICE_DB, role="FOLLOWER",
                 upstream_ip="127.0.0.1",
                 upstream_port=nodes["A"].replicator.port,
                 replication_mode=1)
        observer_host.ioloop.run_coro(observer.handle_add_observer(
            db_name=SLICE_DB, upstream_ip="127.0.0.1",
            upstream_port=nodes["A"].replicator.port)).result(10)
        call(nodes["A"], "start_message_ingestion", db_name=SLICE_DB,
             topic_name="cdc_in",
             kafka_broker_serverset_path="embedded://slice")
        lead = nodes["A"].app_db(SLICE_DB)
        cp = kafka(pkg, "checkpoint")

        def applied():
            wm = cp.read_watermark(lead.db, "cdc_in", 0)
            return 0 if wm is None else wm["offset"]

        assert wait_until(lambda: applied() >= half, timeout=60)
        for i, (k, v) in enumerate(stream[half:]):
            broker.produce("cdc_in", 0, k, v, timestamp_ms=1000 + half + i)
        for t in "CBA":
            call(nodes[t], "compact_db", db_name=SLICE_DB)
        assert wait_until(lambda: applied() == len(stream), timeout=60)
        call(nodes["A"], "stop_message_ingestion", db_name=SLICE_DB)
        want = lead.db.latest_sequence_number()
        dbs = {t: nodes[t].app_db(SLICE_DB).db for t in "ABC"}
        assert wait_until(lambda: all(
            d.latest_sequence_number() == want for d in dbs.values()),
            timeout=60)
        wrapper = observer._observers[SLICE_DB][0]
        assert wait_until(lambda: wrapper.latest_sequence_number() == want,
                          timeout=60)
        for t in "ABC":
            call(nodes[t], "compact_db", db_name=SLICE_DB)
        out = {
            "files": {t: tsst_digests(d) for t, d in dbs.items()},
            "seqs": {t: d.latest_sequence_number() for t, d in dbs.items()},
            "watermarks": {t: (cp.read_watermark(d, "cdc_in", 0)["offset"],
                               cp.read_applies(d, "cdc_in", 0))
                           for t, d in dbs.items()},
            "reads": {t: list(d.new_iterator()) for t, d in dbs.items()},
        }
        consumer = b.MockConsumer(broker)
        consumer.assign("cdc_out", [0])
        records = pkg.mod("storage.records")
        published = []
        while True:
            m = consumer.consume(1.0)
            if m is None:
                break
            seq = int(m.key.split(b":")[1])
            for vtype, k, v in records.decode_batch(m.value).ops():
                # a replicated batch's wall-clock stamp takes no seq
                if vtype != records.OpType.LOG_DATA:
                    published.append((seq, int(vtype), k, v))
                    seq += 1
        out["observer"] = published
        return out
    finally:
        observer.close()
        observer_host.stop()
        call.close()
        for n in nodes.values():
            n.stop()


def test_slice_cdc_shard_with_observer_matches_reference(tmp_path,
                                                         monkeypatch):
    from rocksplicator_tpu_torch.gpu import backend as gb

    widths = []
    real = gb.GpuCompactionBackend._run_batch

    def spy(self, batch, *args):
        widths.append(batch.val_words.shape[1])
        return real(self, batch, *args)

    monkeypatch.setattr(gb.GpuCompactionBackend, "_run_batch", spy)
    stream = _slice_stream()
    got = {p.key: _run_slice(p, tmp_path / p.key, stream) for p in PKGS}
    ref, port = got["ref"], got["port"]
    expect = {}
    for k, v in stream:
        if v:
            expect[k] = v
        else:
            expect.pop(k, None)
    for t in "ABC":
        user = [(k, v) for k, v in port["reads"][t]
                if not k.startswith(b"\x00")]
        assert user == sorted(expect.items()), t
        assert port["watermarks"][t] == (SLICE_RECORDS, SLICE_RECORDS)
        assert port["files"][t] == port["files"]["A"]
    assert port == ref
    assert len(port["observer"]) == port["seqs"]["A"]
    assert [s for s, *_ in port["observer"]] == list(
        range(1, port["seqs"]["A"] + 1))
    # the port's compactions went through K2's lanes at 64 value words
    assert widths and set(widths) == {64}
