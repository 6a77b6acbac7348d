"""The port's pipelined leader write path and multiplexed pull sessions
against the JAX package's: the reference's scenarios
(``tests/test_repl_pipeline.py``, ``tests/test_pull_mux.py``) on each
package — the AckWindow units, the window cap, pipelined futures
resolving in sequence order, no acked write lost when the leader dies
with a full window; many shards in one mux session, an epoch bump that
fences one section, a torn frame that half-applies nothing, and the
per-shard fallback for a peer without ``replicate_mux``. Windows are
wide and no test bounds a speed.
"""

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


def put(pkg, k, v=b"v"):
    return pkg.WriteBatch().put(k, v)


# ---------------------------------------------------------------------------
# AckWindow units
# ---------------------------------------------------------------------------


def test_ack_window_post_resolves_all_leq(pkg):
    resolved = []
    win = pkg.AckWindow(capacity=16, on_resolve=lambda w, acked: resolved
                        .append((w.target_seq, acked)))
    waiters = [win.register(i, i, timeout_sec=60.0) for i in range(1, 6)]
    assert win.depth == 5
    assert win.post(3) == 3
    assert [w.future.done() for w in waiters] == [True] * 3 + [False] * 2
    assert resolved == [(1, True), (2, True), (3, True)]
    assert win.depth == 2
    win.post(10)
    assert all(w.future.done() for w in waiters)
    assert [t for t, _ in resolved] == [1, 2, 3, 4, 5]


def test_ack_window_register_after_watermark_resolves_immediately(pkg):
    win = pkg.AckWindow(capacity=4)
    win.post(10)
    w = win.register(7, 7, timeout_sec=60.0)
    assert w.future.done() and w.acked


def test_ack_window_expiry_resolves_not_acked(pkg):
    win = pkg.AckWindow(capacity=4)
    w = win.register(1, 1, timeout_sec=0.01)
    time.sleep(0.02)
    assert win.expire_due() is None
    assert w.future.done() and not w.acked
    assert win.depth == 0


def test_ack_window_close_resolves_everything(pkg):
    win = pkg.AckWindow(capacity=8)
    waiters = [win.register(i, i, timeout_sec=60.0) for i in range(1, 4)]
    win.close()
    assert all(w.future.done() and not w.acked for w in waiters)
    w = win.register(9, 9, timeout_sec=60.0)
    assert w.future.done() and not w.acked


def test_ack_window_capacity_blocks_then_unblocks(pkg):
    win = pkg.AckWindow(capacity=2)
    win.register(1, 1, timeout_sec=60.0)
    win.register(2, 2, timeout_sec=60.0)
    entered, done = threading.Event(), threading.Event()

    def third():
        entered.set()
        win.register(3, 3, timeout_sec=60.0)
        done.set()

    t = threading.Thread(target=third)
    t.start()
    assert entered.wait(30.0)
    time.sleep(0.15)
    assert not done.is_set()  # the window is full: register parks
    win.post(1)
    assert done.wait(30.0)
    assert win.depth == 2
    win.close()
    t.join(30.0)


# ---------------------------------------------------------------------------
# the pipelined write path
# ---------------------------------------------------------------------------


def test_window_cap_enforced_on_leader(pkg, hosts):
    flags = pkg.flags(server_long_poll_ms=300, ack_timeout_ms=600,
                      degraded_ack_timeout_ms=600,
                      consecutive_timeouts_to_degrade=10**6, write_window=4)
    leader = hosts("l", flags)
    _, lrdb = leader.add_db("seg00001", pkg.ReplicaRole.LEADER, mode=1)
    waiters, max_depth = [], 0
    for i in range(12):
        waiters.append(leader.replicator.write_async(
            "seg00001", put(pkg, f"k{i}".encode())))
        max_depth = max(max_depth, lrdb.ack_window_depth)
    assert 2 <= max_depth <= 4
    for w in waiters:
        w.result(timeout=60.0)
    assert not any(w.acked for w in waiters)


def test_pipelined_futures_resolve_in_seq_order(pkg, hosts):
    leader, follower = hosts("l"), hosts("f")
    leader.add_db("seg00001", pkg.ReplicaRole.LEADER, mode=1)
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr)
    order, waiters = [], []
    for i in range(40):
        w = leader.replicator.write_async(
            "seg00001", put(pkg, f"k{i:04d}".encode()))
        w.future.add_done_callback(lambda f, s=w.target_seq: order.append(s))
        waiters.append(w)
    for w in waiters:
        w.result(timeout=60.0)
    assert all(w.acked for w in waiters)
    assert order == sorted(order) == [w.target_seq for w in waiters]
    assert wait_until(lambda: fdb.latest_sequence_number() == 40)


def test_no_acked_write_loss_on_leader_crash_with_full_window(pkg, hosts):
    flags = pkg.flags(server_long_poll_ms=300, ack_timeout_ms=20000,
                      consecutive_timeouts_to_degrade=100, write_window=16)
    leader, follower = hosts("l", flags), hosts("f", flags)
    _, lrdb = leader.add_db("seg00001", pkg.ReplicaRole.LEADER, mode=1)
    fdb, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                             upstream=leader.addr)
    waiters = [leader.replicator.write_async(
        "seg00001", put(pkg, f"k{i:04d}".encode())) for i in range(64)]
    wait_until(lambda: lrdb._acked.value > 0)
    leader.replicator.stop()
    for w in waiters:  # nobody hangs on a dead leader
        w.result(timeout=60.0)
    acked = [w for w in waiters if w.acked]
    assert acked
    high = max(w.target_seq for w in acked)
    assert wait_until(lambda: fdb.latest_sequence_number() >= high)
    for w in acked:
        assert fdb.get(f"k{w.seq - 1:04d}".encode()) == b"v"


# ---------------------------------------------------------------------------
# multiplexed pull sessions
# ---------------------------------------------------------------------------


def mux_flags(pkg, **kw):
    return pkg.flags(pull_fast_first_attempts=3, pull_fast_min_ms=10,
                     pull_fast_max_ms=30, pull_mux=True, **kw)


def counter_total(pkg, name):
    s = pkg.Stats.get()
    s.flush()
    return s.export_state()["counters"].get(name, {}).get("total", 0.0)


def in_sync(ldb, fdb):
    return (ldb.latest_sequence_number() == fdb.latest_sequence_number()
            and ldb.latest_sequence_number() > 0)


def test_mux_many_shards_one_session(pkg, hosts):
    leader, follower = hosts("l", mux_flags(pkg)), hosts("f", mux_flags(pkg))
    pairs = []
    for i in range(8):
        name = f"seg{i:05d}"
        ldb, _ = leader.add_db(name, pkg.ReplicaRole.LEADER, mode=2)
        fdb, _ = follower.add_db(name, pkg.ReplicaRole.FOLLOWER,
                                 upstream=leader.addr, mode=2)
        pairs.append((name, ldb, fdb))
    for name, *_ in pairs:
        for k in range(20):
            leader.write(name, put(pkg, f"k{k}".encode(), name.encode()))
    assert wait_until(lambda: all(in_sync(l, f) for _n, l, f in pairs))
    assert counter_total(pkg, pkg.M["mux_pulls"]) > 0
    assert (counter_total(pkg, pkg.M["mux_sections"])
            > counter_total(pkg, pkg.M["mux_requests"]) > 0)
    for name, _l, _f in pairs:
        assert follower.replicator.get_db(name)._pull_task is None
    w = leader.replicator.get_db(pairs[0][0]).write_async(
        put(pkg, b"fin", b"al"))
    w.future.result(60)
    assert w.acked


def test_mux_epoch_bump_fences_one_section(pkg, hosts):
    leader, follower = hosts("l", mux_flags(pkg)), hosts("f", mux_flags(pkg))
    names = [f"seg{i:05d}" for i in range(3)]
    ldbs, fdbs, frdbs = {}, {}, {}
    for n in names:
        ldbs[n], _ = leader.add_db(n, pkg.ReplicaRole.LEADER)
        fdbs[n], frdbs[n] = follower.add_db(n, pkg.ReplicaRole.FOLLOWER,
                                            upstream=leader.addr)
    for n in names:
        leader.write(n, put(pkg, b"a", b"1"))
    assert wait_until(lambda: all(in_sync(ldbs[n], fdbs[n]) for n in names))
    frdbs[names[1]].adopt_epoch(7)
    lrdb1 = leader.replicator.get_db(names[1])
    assert wait_until(lambda: lrdb1.fenced)
    with pytest.raises(pkg.RpcApplicationError) as ei:
        leader.write(names[1], put(pkg, b"b", b"2"))
    assert ei.value.code == "STALE_EPOCH"
    for n in (names[0], names[2]):
        leader.write(n, put(pkg, b"b", b"2"))
    assert wait_until(lambda: all(in_sync(ldbs[n], fdbs[n])
                                  for n in (names[0], names[2])))
    assert not leader.replicator.get_db(names[0]).fenced
    assert not leader.replicator.get_db(names[2]).fenced


def test_mux_torn_response_no_half_apply(pkg, hosts):
    leader, follower = hosts("l", mux_flags(pkg)), hosts("f", mux_flags(pkg))
    names = [f"seg{i:05d}" for i in range(4)]
    ldbs, fdbs = {}, {}
    for n in names:
        ldbs[n], _ = leader.add_db(n, pkg.ReplicaRole.LEADER)
        fdbs[n], _ = follower.add_db(n, pkg.ReplicaRole.FOLLOWER,
                                     upstream=leader.addr)
    for n in names:
        leader.write(n, put(pkg, b"w0", b"x"))
    assert wait_until(lambda: all(in_sync(ldbs[n], fdbs[n]) for n in names))
    pkg.fp.activate("rpc.frame.send", "fail_nth:1")
    pkg.fp.activate("repl.mux.serve", "fail_nth:2")
    try:
        for i in range(10):
            for n in names:
                leader.write(n, put(pkg, f"k{i}".encode(), b"y"))
        assert wait_until(lambda: all(in_sync(ldbs[n], fdbs[n])
                                      for n in names))
    finally:
        pkg.fp.deactivate("rpc.frame.send")
        pkg.fp.deactivate("repl.mux.serve")
    for n in names:
        assert fdbs[n].latest_sequence_number() == 11
        assert fdbs[n].get(b"k9") == b"y"


def test_mux_legacy_peer_falls_back_per_shard(pkg, hosts):
    mux_leader = hosts("lm", mux_flags(pkg))
    old_leader = hosts("lo", mux_flags(pkg))
    follower = hosts("f", mux_flags(pkg))
    for h in old_leader.replicator._server._handlers:
        h.handle_replicate_mux = None  # a peer without replicate_mux
    lm, _ = mux_leader.add_db("seg00000", pkg.ReplicaRole.LEADER)
    lo, _ = old_leader.add_db("seg00001", pkg.ReplicaRole.LEADER)
    fm, _ = follower.add_db("seg00000", pkg.ReplicaRole.FOLLOWER,
                            upstream=mux_leader.addr)
    fo, _ = follower.add_db("seg00001", pkg.ReplicaRole.FOLLOWER,
                            upstream=old_leader.addr)
    mux_leader.write("seg00000", put(pkg, b"k", b"m"))
    old_leader.write("seg00001", put(pkg, b"k", b"o"))
    assert wait_until(lambda: in_sync(lm, fm) and in_sync(lo, fo))
    assert fm.get(b"k") == b"m" and fo.get(b"k") == b"o"
    assert counter_total(pkg, pkg.M["mux_fallbacks"]) >= 1
    assert follower.replicator.get_db("seg00001")._pull_task is not None
    assert follower.replicator.get_db("seg00000")._pull_task is None
    lo2, _ = old_leader.add_db("seg00002", pkg.ReplicaRole.LEADER)
    fo2, _ = follower.add_db("seg00002", pkg.ReplicaRole.FOLLOWER,
                             upstream=old_leader.addr)
    old_leader.write("seg00002", put(pkg, b"k", b"2"))
    assert wait_until(lambda: in_sync(lo2, fo2))
    assert follower.replicator.get_db("seg00002")._pull_task is not None
