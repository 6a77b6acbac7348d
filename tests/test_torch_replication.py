"""The port's replication against the JAX package's: the reference's
scenarios (``tests/test_replication.py``) run on each package's own
Replicator, ReplicatedDB and DBs over real TCP loopback — the topologies
(one leader and one follower, a follower from behind, a tree, a chain),
merge operands, ack modes 1 and 2 and mode 2's timeout degradation, an
observer, a missing source, removal, a write refused on a follower, an
upstream repoint, response batching, a WAL gap, a sequence
discontinuity, no zombie registration, the test proxy and the
MaxNumberBox. Each scenario ends in the same sequence numbers and reads
on both packages (tolerance 0). The port's DBs compact on the card's
backend, run on the CPU.

Windows are wide and no test bounds a speed: where the reference bounds
a latency, the port's test checks the ack state instead.
"""

import asyncio
import os
import struct
import threading
import time

import pytest

from torch_parity import ReplHost, ReplPackage, reset_both, wait_until

PKGS = [ReplPackage("ref"), ReplPackage("port")]


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield
    reset_both()


@pytest.fixture(params=PKGS, ids=repr)
def pkg(request):
    return request.param


@pytest.fixture()
def hosts(tmp_path, pkg):
    created = []

    def make(name, flags=None):
        h = ReplHost(pkg, tmp_path, name, flags)
        created.append(h)
        return h

    yield make
    for h in created:
        h.stop()


def put(pkg, k, v):
    return pkg.WriteBatch().put(k, v)


def test_one_leader_one_follower(pkg, hosts):
    leader, follower = hosts("leader"), hosts("follower")
    ldb, _ = leader.add_db("seg00001", pkg.ReplicaRole.LEADER)
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr)
    for i in range(20):
        leader.write("seg00001", put(pkg, f"k{i}".encode(), f"v{i}".encode()))
    assert wait_until(lambda: fdb.latest_sequence_number() == 20)
    assert [fdb.get(f"k{i}".encode()) for i in range(20)] == [
        f"v{i}".encode() for i in range(20)]


def test_follower_catches_up_from_behind(pkg, hosts):
    leader = hosts("leader")
    ldb, _ = leader.add_db("seg00001", pkg.ReplicaRole.LEADER)
    for i in range(100):
        leader.write("seg00001", put(pkg, f"k{i}".encode(), b"x"))
    follower = hosts("follower")
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr)
    assert wait_until(lambda: fdb.latest_sequence_number() == 100)
    assert fdb.get(b"k99") == b"x"


def test_tree_one_leader_two_followers(pkg, hosts):
    leader, f1, f2 = hosts("l"), hosts("f1"), hosts("f2")
    leader.add_db("seg00001", pkg.ReplicaRole.LEADER)
    fdb1, _ = f1.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                        upstream=leader.addr)
    fdb2, _ = f2.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                        upstream=leader.addr)
    for i in range(30):
        leader.write("seg00001", put(pkg, f"k{i}".encode(), b"v"))
    assert wait_until(lambda: fdb1.latest_sequence_number() == 30)
    assert wait_until(lambda: fdb2.latest_sequence_number() == 30)


def test_chain_leader_follower_follower(pkg, hosts):
    a, b, c = hosts("a"), hosts("b"), hosts("c")
    a.add_db("seg00001", pkg.ReplicaRole.LEADER)
    b.add_db("seg00001", pkg.ReplicaRole.FOLLOWER, upstream=a.addr)
    cdb, _ = c.add_db("seg00001", pkg.ReplicaRole.FOLLOWER, upstream=b.addr)
    for i in range(25):
        a.write("seg00001", put(pkg, f"k{i}".encode(), f"{i}".encode()))
    assert wait_until(lambda: cdb.latest_sequence_number() == 25)
    assert cdb.get(b"k24") == b"24"
    # timestamps survive the chain: the lag metric was recorded
    assert pkg.Stats.get().metric_count("replicator.replication_lag_ms") > 0


def test_merge_ops_replicate(pkg, hosts):
    pack = struct.Struct("<q").pack
    leader, follower = hosts("l"), hosts("f")
    leader.add_db("seg00001", pkg.ReplicaRole.LEADER,
                  merge_operator=pkg.UInt64AddOperator())
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr,
                             merge_operator=pkg.UInt64AddOperator())
    for _ in range(10):
        leader.write("seg00001", pkg.WriteBatch().merge(b"ctr", pack(3)))
    assert wait_until(lambda: fdb.latest_sequence_number() == 10)
    assert fdb.get(b"ctr") == pack(30)


def test_semi_sync_mode1_ack(pkg, hosts):
    leader, follower = hosts("l"), hosts("f")
    _, lrdb = leader.add_db("seg00001", pkg.ReplicaRole.LEADER, mode=1)
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr)
    leader.write("seg00001", put(pkg, b"k", b"v"))
    # the write returned on the follower's ack, not on the (wide) timeout
    assert lrdb._acked.value >= 1
    assert pkg.Stats.get().get_counter(pkg.M["ack_timeouts"]) == 0
    assert wait_until(lambda: fdb.get(b"k") == b"v")


def test_sync_mode2_ack(pkg, hosts):
    leader, follower = hosts("l"), hosts("f")
    _, lrdb = leader.add_db("seg00001", pkg.ReplicaRole.LEADER, mode=2)
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr)
    leader.write("seg00001", put(pkg, b"k1", b"v1"))
    assert wait_until(lambda: lrdb._acked.value >= 1)
    assert fdb.get(b"k1") == b"v1"


def test_mode2_ack_timeout_degradation(pkg, hosts):
    """A mode-2 leader with no follower: writes time out, and after the
    configured run of timeouts the shard degrades to the short timeout."""
    flags = pkg.flags(ack_timeout_ms=60, degraded_ack_timeout_ms=5,
                      consecutive_timeouts_to_degrade=3)
    leader = hosts("l", flags)
    _, lrdb = leader.add_db("seg00001", pkg.ReplicaRole.LEADER, mode=2)
    for _ in range(3):
        leader.write("seg00001", put(pkg, b"k", b"v"))
    assert lrdb._degraded
    stats = pkg.Stats.get()
    assert stats.get_counter(pkg.M["ack_timeouts"]) == 3
    assert stats.get_counter(pkg.M["ack_degraded"]) == 1
    for _ in range(10):
        leader.write("seg00001", put(pkg, b"k", b"v"))
    assert lrdb._degraded and lrdb._acked.value == 0
    assert stats.get_counter(pkg.M["ack_timeouts"]) == 13


def test_observer_does_not_ack(pkg, hosts):
    flags = pkg.flags(server_long_poll_ms=300, ack_timeout_ms=80,
                      degraded_ack_timeout_ms=5,
                      consecutive_timeouts_to_degrade=100)
    leader, observer = hosts("l", flags), hosts("o", flags)
    _, lrdb = leader.add_db("seg00001", pkg.ReplicaRole.LEADER, mode=2)
    odb, _ = observer.add_db("seg00001", pkg.ReplicaRole.OBSERVER,
                             upstream=leader.addr)
    t0 = time.monotonic()
    leader.write("seg00001", put(pkg, b"k", b"v"))
    # the write waited out its ack timeout: the observer did not ack
    assert time.monotonic() - t0 >= 0.07
    assert lrdb._acked.value == 0
    assert wait_until(lambda: odb.get(b"k") == b"v")


def test_source_not_found_then_recovers(pkg, hosts):
    leader, follower = hosts("l"), hosts("f")
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr)
    time.sleep(0.3)  # pulls meet SOURCE_NOT_FOUND and back off
    leader.add_db("seg00001", pkg.ReplicaRole.LEADER)
    leader.write("seg00001", put(pkg, b"k", b"v"))
    assert wait_until(lambda: fdb.get(b"k") == b"v")


def test_remove_db_stops_replication(pkg, hosts):
    leader, follower = hosts("l"), hosts("f")
    leader.add_db("seg00001", pkg.ReplicaRole.LEADER)
    fdb, frdb = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                                upstream=leader.addr)
    leader.write("seg00001", put(pkg, b"k1", b"v1"))
    assert wait_until(lambda: fdb.get(b"k1") == b"v1")
    follower.replicator.remove_db("seg00001")
    assert frdb.removed
    leader.write("seg00001", put(pkg, b"k2", b"v2"))
    time.sleep(0.5)
    assert fdb.get(b"k2") is None
    leader.replicator.remove_db("seg00001")
    with pytest.raises(KeyError):
        leader.write("seg00001", put(pkg, b"x", b"y"))


def test_write_rejected_on_follower(pkg, hosts):
    leader, follower = hosts("l"), hosts("f")
    leader.add_db("seg00001", pkg.ReplicaRole.LEADER)
    follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                    upstream=leader.addr)
    with pytest.raises(pkg.RpcApplicationError):
        follower.write("seg00001", put(pkg, b"k", b"v"))


def test_upstream_repoint_failover(pkg, hosts):
    a, b, c = hosts("a"), hosts("b"), hosts("c")
    a.add_db("seg00001", pkg.ReplicaRole.LEADER)
    bdb, _ = b.add_db("seg00001", pkg.ReplicaRole.FOLLOWER, upstream=a.addr)
    cdb, crdb = c.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                         upstream=a.addr)
    a.write("seg00001", put(pkg, b"k1", b"v1"))
    assert wait_until(lambda: bdb.get(b"k1") == b"v1"
                      and cdb.get(b"k1") == b"v1")
    a.replicator.remove_db("seg00001")
    b.replicator.remove_db("seg00001")
    b.replicator.add_db("seg00001", pkg.StorageDbWrapper(bdb),
                        pkg.ReplicaRole.LEADER)
    crdb.reset_upstream(b.addr)
    b.write("seg00001", put(pkg, b"k2", b"v2"))
    assert wait_until(lambda: cdb.get(b"k2") == b"v2")
    assert cdb.latest_sequence_number() == bdb.latest_sequence_number() == 2


def test_batching_respects_max_updates(pkg, hosts):
    flags = pkg.flags(server_long_poll_ms=300, max_updates_per_response=5,
                      adaptive_max_updates_cap=5)
    leader, follower = hosts("l", flags), hosts("f", flags)
    leader.add_db("seg00001", pkg.ReplicaRole.LEADER)
    for i in range(50):
        leader.write("seg00001", put(pkg, f"k{i:02d}".encode(), b"v"))
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr)
    assert wait_until(lambda: fdb.latest_sequence_number() == 50)
    stats = pkg.Stats.get()
    # 50 updates at most 5 a response: at least 10 responses
    assert stats.get_counter("replicator.replicate_requests") >= 10
    assert stats.get_counter(pkg.M["replicate_updates_sent"]) == 50
    assert stats.get_counter(pkg.M["pull_updates_applied"]) == 50


def test_wal_gap_raises_typed_gap_error(pkg, hosts):
    leader = hosts("l")
    ldb, lrdb = leader.add_db("seg00001", pkg.ReplicaRole.LEADER,
                              wal_segment_bytes=200)
    for i in range(20):
        leader.write("seg00001", put(pkg, f"k{i}".encode(), b"v"))
    ldb.flush()
    removed = pkg.wal.purge_obsolete(os.path.join(ldb.path, "wal"),
                                     persisted_seq=20, ttl_seconds=0.0)
    assert removed > 0

    async def ask():
        return await lrdb.handle_replicate_request(seq_no=1, max_wait_ms=0)

    with pytest.raises(pkg.RpcApplicationError) as ei:
        asyncio.run_coroutine_threadsafe(
            ask(), leader.replicator.ioloop.loop).result(30)
    assert ei.value.code == "WAL_GAP"


def test_apply_rejects_seq_discontinuity(pkg, hosts):
    leader = hosts("l")
    _, lrdb = leader.add_db("seg00001", pkg.ReplicaRole.LEADER)
    raw = put(pkg, b"k", b"v").encode()
    with pytest.raises(ValueError):
        lrdb._apply_updates([{"seq_no": 99, "raw_data": raw,
                              "timestamp": None}])


def test_add_db_failed_start_no_zombie(pkg, hosts):
    leader = hosts("l")
    db = pkg.open_db(leader.dir / "seg00009")
    leader.dbs["seg00009"] = db
    with pytest.raises(ValueError):
        leader.replicator.add_db("seg00009", pkg.StorageDbWrapper(db),
                                 pkg.ReplicaRole.FOLLOWER, upstream_addr=None)
    assert leader.replicator.add_db("seg00009", pkg.StorageDbWrapper(db),
                                    pkg.ReplicaRole.LEADER) is not None


def test_wrapper_based_add_db_via_test_proxy(pkg, hosts):
    leader, follower = hosts("l"), hosts("f")
    ldb = pkg.open_db(leader.dir / "seg00001")
    leader.dbs["seg00001"] = ldb
    proxy = pkg.TestDbProxy(ldb)
    leader.replicator.add_db("seg00001", proxy, pkg.ReplicaRole.LEADER)
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr)
    for i in range(5):
        leader.write("seg00001", put(pkg, f"k{i}".encode(), b"v"))
    assert wait_until(lambda: fdb.latest_sequence_number() == 5)
    assert proxy.writes == 5
    assert proxy.reads >= 1


def test_replicated_compaction_on_each_replica(pkg, hosts):
    """Each replica compacts its own files; after compact_range a leader
    and its follower hold sha256-equal files and read back equal, and
    the port's card backend (plain versions on the CPU) ran for both."""
    from torch_parity import tsst_digests

    pack = struct.Struct("<Q").pack
    leader, follower = hosts("l"), hosts("f")
    kw = dict(merge_operator=pkg.UInt64AddOperator(), memtable_bytes=4096,
              level0_compaction_trigger=100)
    ldb, _ = leader.add_db("seg00001", pkg.ReplicaRole.LEADER, **kw)
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr, **kw)
    keys = [b"counter:%06d" % i for i in range(64)]
    for r in range(6):
        batch = pkg.WriteBatch()
        for i, k in enumerate(keys):
            if (i + r) % 10 == 0:
                batch.delete(k)
            elif (i + r) % 3 == 0:
                batch.put(k, pack(r))
            else:
                batch.merge(k, pack(i))
        leader.write("seg00001", batch)
    assert wait_until(lambda: fdb.latest_sequence_number() == 6 * 64)
    for db in (ldb, fdb):
        db.compact_range()
    assert tsst_digests(ldb) == tsst_digests(fdb) != []
    assert ldb.multi_get(keys) == fdb.multi_get(keys)
    if pkg.key == "port":
        assert type(ldb._backend).__name__ == "GpuCompactionBackend"


def test_max_number_box_basic(pkg):
    box = pkg.MaxNumberBox()
    assert not box.wait(1, 0.05)
    box.post(5)
    assert box.wait(5, 0.05)
    assert box.wait(3, 0.0)
    assert not box.wait(6, 0.05)
    box.post(4)
    assert box.value == 5


def test_max_number_box_stress(pkg):
    box = pkg.MaxNumberBox()
    results = []
    threads = [threading.Thread(target=lambda t=t: results.append(
        box.wait(t, 30.0))) for t in range(1, 51)]
    for t in threads:
        t.start()
    for i in range(1, 51):
        box.post(i)
    for t in threads:
        t.join()
    assert results == [True] * 50
