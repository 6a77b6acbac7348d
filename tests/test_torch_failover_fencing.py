"""Failover under fault: end-to-end leader fencing + control-plane chaos.
(The port's copy of ``tests/test_failover_fencing.py``: the same cases,
bounds and markers on ``rocksplicator_tpu_torch``; DBs and admin handlers
compact through the card's backend on the CPU, and the chaos cases run
the port's ``tools/chaos_soak.py``.)

The no-split-brain contract: the controller mints a monotonic
fencing epoch per partition exactly when leadership moves, stamps it on
every assignment, participants thread it into the data plane, the leader
attaches it to every replicate/ack frame, and followers + the ack path
reject stale-epoch traffic — a demoted leader holding a full AckWindow
cannot ack a single write after the new leader's epoch is visible to its
followers.

Layers covered here:
- controller two-phase handoff edges + epoch ledger (pure unit tests on
  ``assign_resource``);
- coordinator WAL fencing (``coordinator.wal.append`` failpoint: every
  pending and future mutation fails fenced — the coordinator.py _Wal
  contract);
- ReplicatedDB fencing (the acceptance scenario, over real RPC);
- participant rejoin after session expiry (no manual restart);
- control-plane retry adoption (spectator / shard-map agent);
- the failover chaos harness itself + its ``--break-guard fencing``
  tooth (fast tier-1 markers; the full run is ``python -m
  rocksplicator_tpu_torch.tools.chaos_soak --failover --device cpu``).
"""

import asyncio
import os
import time

import pytest

from rocksplicator_tpu_torch.cluster.controller import assign_resource
from rocksplicator_tpu_torch.cluster.coordinator import (
    CoordinatorClient,
    CoordinatorServer,
)
from rocksplicator_tpu_torch.cluster.model import (
    InstanceInfo,
    PartitionAssignment,
    ResourceDef,
    decode_assignments,
    encode_assignments,
)
from rocksplicator_tpu_torch.replication import (
    ReplicaRole,
    ReplicationFlags,
    Replicator,
    StorageDbWrapper,
)
from rocksplicator_tpu_torch.replication.wire import ReplicateErrorCode
from rocksplicator_tpu_torch.rpc import RpcApplicationError
from rocksplicator_tpu_torch.storage import DB, DBOptions, WriteBatch
from rocksplicator_tpu_torch.testing import failpoints as fp
from rocksplicator_tpu_torch.utils.stats import Stats, tagged
from tests.torch_parity import reset_both

PARTITION = "seg_0"
DB_NAME = "seg00000"

FAST = ReplicationFlags(
    server_long_poll_ms=200,
    pull_error_delay_min_ms=30,
    pull_error_delay_max_ms=80,
    ack_timeout_ms=60_000,  # acks must come from FENCING, never timeouts
    write_window=8,
)


def wait_until(pred, timeout=15.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


@pytest.fixture(autouse=True)
def _clean_failpoints():
    reset_both()
    yield
    reset_both()


def _cpu_options(**kw):
    from rocksplicator_tpu_torch.gpu.backend import GpuCompactionBackend

    return DBOptions(compaction_backend=GpuCompactionBackend(device="cpu"),
                     **kw)


# ---------------------------------------------------------------------------
# controller: two-phase handoff edges + the epoch ledger (pure units)
# ---------------------------------------------------------------------------


def _instances(*iids):
    return {
        iid: InstanceInfo(iid, "127.0.0.1", 1000 + i, 2000 + i)
        for i, iid in enumerate(iids)
    }


def _leader_of(per_instance, partition=PARTITION):
    leaders = [
        iid for iid, a in per_instance.items()
        if partition in a and a[partition].state == "LEADER"
    ]
    assert len(leaders) <= 1, leaders
    return leaders[0] if leaders else None


def _assign(resource, instances, current, epochs):
    per = {iid: {} for iid in instances}
    changed = assign_resource(resource, instances, current, per, epochs)
    return per, changed


def test_cold_start_mints_epoch_one_and_stamps_every_assignment():
    res = ResourceDef("seg", num_shards=1, replicas=3)
    instances = _instances("a", "b", "c")
    epochs = {}
    per, changed = _assign(res, instances, {}, epochs)
    leader = _leader_of(per)
    assert leader is not None
    assert changed == {PARTITION}
    assert epochs[PARTITION] == {"epoch": 1, "leader": leader}
    for iid in instances:
        assert per[iid][PARTITION].epoch == 1
    # followers point at the leader; the leader has no upstream
    for iid in instances:
        a = per[iid][PARTITION]
        if iid == leader:
            assert a.upstream is None
        else:
            assert a.state == "FOLLOWER" and a.upstream is not None


def test_sticky_live_leader_keeps_epoch():
    """The live leader stays target even when it is not rank-0, and a
    steady pass never bumps the epoch."""
    res = ResourceDef("seg", num_shards=1, replicas=3)
    instances = _instances("a", "b", "c")
    epochs = {}
    per, _ = _assign(res, instances, {}, epochs)
    natural = _leader_of(per)
    # hand leadership to a DIFFERENT replica and record it as live
    other = next(iid for iid in instances if iid != natural)
    epochs = {PARTITION: {"epoch": 5, "leader": other}}
    current = {
        iid: {PARTITION: "LEADER" if iid == other else "FOLLOWER"}
        for iid in instances
    }
    per2, changed = _assign(res, instances, current, epochs)
    assert _leader_of(per2) == other  # sticky beats rendezvous rank
    assert not changed
    assert epochs[PARTITION]["epoch"] == 5
    assert all(per2[iid][PARTITION].epoch == 5 for iid in instances)


def test_promote_blocked_while_live_leader_set_demote_first():
    """Two-phase handoff: while a live leader outside the replica set
    still reports leaderlike, the target stays a FOLLOWER of the ACTING
    leader and the epoch is NOT minted; once the old leader reports
    non-leader, the promotion lands with a fresh epoch."""
    res = ResourceDef("seg", num_shards=1, replicas=2)
    instances = _instances("a", "b", "c", "d")
    epochs = {}
    per0, _ = _assign(res, instances, {}, epochs)
    replicas = [iid for iid in instances if PARTITION in per0[iid]]
    outsider = next(iid for iid in instances if iid not in replicas)
    epoch0 = epochs[PARTITION]["epoch"]
    # the outsider currently leads (e.g. placement moved off it)
    current = {outsider: {PARTITION: "LEADER"}}
    for iid in replicas:
        current[iid] = {PARTITION: "FOLLOWER"}
    epochs[PARTITION] = {"epoch": epoch0, "leader": outsider}
    per1, changed = _assign(res, instances, current, epochs)
    assert _leader_of(per1) is None  # promote blocked: demote first
    assert not changed and epochs[PARTITION]["epoch"] == epoch0
    acting_addr = (f"{instances[outsider].host}:"
                   f"{instances[outsider].repl_port}")
    for iid in replicas:
        a = per1[iid][PARTITION]
        # demote-in-flight target stays a follower OF THE ACTING leader
        assert a.state == "FOLLOWER" and a.upstream == acting_addr
        assert a.epoch == epoch0
    assert PARTITION not in per1[outsider]  # not placed: drop follows
    # phase 2: the old leader demoted — now the promotion mints epoch+1
    current[outsider] = {PARTITION: "FOLLOWER"}
    per2, changed2 = _assign(res, instances, current, epochs)
    new_leader = _leader_of(per2)
    assert new_leader in replicas
    assert changed2 == {PARTITION}
    assert epochs[PARTITION] == {"epoch": epoch0 + 1, "leader": new_leader}
    assert all(per2[iid][PARTITION].epoch == epoch0 + 1 for iid in replicas)


def test_rejoined_stale_leader_claim_does_not_flap_leadership():
    """A deposed leader rejoining still CLAIMS leaderlike in its
    persistent current state; with two live claimers the epoch ledger's
    recorded leader wins — found by the failover chaos harness, where
    trusting the stale claim flapped leadership straight back."""
    res = ResourceDef("seg", num_shards=1, replicas=3)
    instances = _instances("a", "b", "c")
    epochs = {}
    per, _ = _assign(res, instances, {}, epochs)
    old = _leader_of(per)
    new = next(iid for iid in instances if iid != old)
    epochs[PARTITION] = {"epoch": 2, "leader": new}
    current = {iid: {PARTITION: "FOLLOWER"} for iid in instances}
    current[old] = {PARTITION: "LEADER"}  # the stale claim
    current[new] = {PARTITION: "LEADER"}  # the true leader of epoch 2
    per2, changed = _assign(res, instances, current, epochs)
    assert _leader_of(per2) == new
    assert not changed and epochs[PARTITION]["epoch"] == 2
    assert per2[old][PARTITION].state == "FOLLOWER"


def test_assignment_epoch_roundtrips_and_legacy_decodes():
    enc = encode_assignments(
        {PARTITION: PartitionAssignment("LEADER", None, 7)})
    assert decode_assignments(enc)[PARTITION].epoch == 7
    legacy = b'{"seg_0": {"state": "FOLLOWER", "upstream": "h:1"}}'
    assert decode_assignments(legacy)[PARTITION].epoch == 0


# ---------------------------------------------------------------------------
# coordinator WAL fencing (coordinator.py:96 contract)
# ---------------------------------------------------------------------------


def test_coordinator_wal_append_failpoint_fences_every_mutation(tmp_path):
    server = CoordinatorServer(port=0, session_ttl=5.0,
                               data_dir=str(tmp_path / "coord"))
    client = CoordinatorClient("127.0.0.1", server.port)
    try:
        client.put("/pre", b"1")
        fp.activate("coordinator.wal.append", "fail_nth:1")
        with pytest.raises(RpcApplicationError) as ei:
            client.put("/boom", b"2")
        assert ei.value.code == "WAL_ERROR"
        fp.deactivate("coordinator.wal.append")
        # fenced: every FUTURE mutation fails even with the fault gone
        for i in range(3):
            with pytest.raises(RpcApplicationError) as e2:
                client.put(f"/after{i}", b"x")
            assert e2.value.code == "WAL_ERROR"
        # reads still serve (fail-stop is for mutations; a fenced
        # mutation may remain visible in memory until restart — the
        # documented _Wal contract)
        assert client.get("/pre")[0] == b"1"
        with pytest.raises(RpcApplicationError) as e3:
            client.delete("/pre")
        assert e3.value.code == "WAL_ERROR"
        assert fp.trip_counts().get("coordinator.wal.append") == 1
    finally:
        client.close()
        server.stop()


def test_coordinator_wal_torn_append_fences_then_heals_on_restart(tmp_path):
    data_dir = str(tmp_path / "coord")
    server = CoordinatorServer(port=0, session_ttl=5.0, data_dir=data_dir)
    client = CoordinatorClient("127.0.0.1", server.port)
    client.put("/pre", b"1")
    fp.activate("coordinator.wal.append", "torn:1.0,one_shot")
    with pytest.raises(RpcApplicationError) as ei:
        client.put("/torn", b"2")
    assert ei.value.code == "WAL_ERROR"
    # still fenced after the one-shot tear
    with pytest.raises(RpcApplicationError):
        client.put("/torn2", b"3")
    client.close()
    server.stop()
    # reopen: the torn tail is truncated; acked pre-fault state intact;
    # mutations work again
    server2 = CoordinatorServer(port=0, session_ttl=5.0, data_dir=data_dir)
    client2 = CoordinatorClient("127.0.0.1", server2.port)
    try:
        assert client2.get("/pre")[0] == b"1"
        assert not client2.exists("/torn")  # never acked
        client2.put("/post", b"4")
        assert client2.get("/post")[0] == b"4"
    finally:
        client2.close()
        server2.stop()


# ---------------------------------------------------------------------------
# data-plane fencing: the acceptance scenario
# ---------------------------------------------------------------------------


class _Cluster3:
    """Leader + 2 followers over real TCP, semi-sync (mode 1), epoch 1."""

    def __init__(self, root):
        self.hosts = [Replicator(port=0, flags=FAST) for _ in range(3)]
        self.dbs = [DB(os.path.join(root, f"n{i}", DB_NAME),
                       _cpu_options())
                    for i in range(3)]
        leader_addr = ("127.0.0.1", self.hosts[0].port)
        self.rdbs = [
            self.hosts[i].add_db(
                DB_NAME, StorageDbWrapper(self.dbs[i]),
                ReplicaRole.LEADER if i == 0 else ReplicaRole.FOLLOWER,
                upstream_addr=None if i == 0 else leader_addr,
                replication_mode=1, epoch=1,
            )
            for i in range(3)
        ]

    def converged(self):
        lat = self.dbs[0].latest_sequence_number_relaxed()
        return all(d.latest_sequence_number_relaxed() == lat
                   for d in self.dbs[1:])

    def stop(self):
        for h in self.hosts:
            h.stop()
        for d in self.dbs:
            d.close()


def test_demoted_leader_with_full_ack_window_cannot_ack(tmp_path):
    """THE acceptance test: the deposed leader holds a FULL AckWindow
    when the new leader's epoch becomes visible to a follower; the
    follower's next (stale-epoch-carrying) pull fences it — every
    pending write fails un-acked, new writes are refused, and zero
    acked writes are lost on the new lineage. Ack timeouts are 60 s, so
    any un-acked resolution here is the FENCE, not a timeout."""
    cluster = _Cluster3(str(tmp_path))
    old_leader = cluster.rdbs[0]
    try:
        # baseline: acked writes, fully replicated
        baseline = []
        for i in range(5):
            k = f"base{i}".encode()
            w = old_leader.write_async(WriteBatch().put(k, k))
            assert w.future.result(10.0) is not None and w.acked
            baseline.append(k)
        assert wait_until(cluster.converged)
        # block pulls; drain the parked long-polls they already issued
        fp.activate("repl.pull", "fail_prob:1.0")
        time.sleep(FAST.server_long_poll_ms / 1000.0 + 0.15)
        pending = []
        while old_leader.ack_window_free > 0:
            k = f"pend{len(pending)}".encode()
            pending.append(old_leader.write_async(WriteBatch().put(k, k)))
        assert old_leader.ack_window_depth == len(pending) == FAST.write_window
        # the controller's promotion, expressed at the data plane:
        # follower 1 becomes LEADER under epoch 2
        cluster.hosts[1].remove_db(DB_NAME)
        new_leader = cluster.hosts[1].add_db(
            DB_NAME, StorageDbWrapper(cluster.dbs[1]), ReplicaRole.LEADER,
            replication_mode=1, epoch=2)
        cluster.rdbs[1] = new_leader
        # follower 2 learns the new epoch (its assignment) but its pull
        # loop still points at the OLD leader — the stale-frame race
        follower = cluster.rdbs[2]
        follower.adopt_epoch(2)
        fp.deactivate("repl.pull")
        # the follower's next pull carries epoch 2 → the old leader
        # fences: pending window fails un-acked NOW (not in 60 s)
        assert wait_until(lambda: old_leader.fenced, timeout=10.0)
        for w in pending:
            w.future.result(10.0)
            assert not w.acked, "stale ack on a deposed leader"
        # a deposed leader cannot take (let alone ack) a single write
        with pytest.raises(RpcApplicationError) as ei:
            old_leader.write_async(WriteBatch().put(b"late", b"late"))
        assert ei.value.code == ReplicateErrorCode.STALE_EPOCH.value
        assert Stats.get().get_counter(
            "replicator.stale_epoch_rejects") >= 1
        # repoint the follower at the new leader (the controller's
        # follower assignment) — the new lineage serves and acks
        follower.reset_upstream(("127.0.0.1", cluster.hosts[1].port))
        w = new_leader.write_async(WriteBatch().put(b"new", b"new"))
        assert w.future.result(10.0) is not None and w.acked
        # zero acked loss: every baseline write is on the new lineage
        for k in baseline:
            assert cluster.dbs[1].get(k) == k
            assert wait_until(lambda: cluster.dbs[2].get(k) == k)
    finally:
        cluster.stop()


def test_follower_rejects_stale_leader_updates(tmp_path):
    """The other direction: a follower that learned a newer epoch must
    not apply updates from a deposed (lower-epoch) upstream."""
    cluster = _Cluster3(str(tmp_path))
    try:
        leader, follower = cluster.rdbs[0], cluster.rdbs[1]
        w = leader.write_async(WriteBatch().put(b"a", b"1"))
        assert w.future.result(10.0) is not None
        assert wait_until(cluster.converged)
        follower.adopt_epoch(3)  # a newer leader exists elsewhere
        seq_before = cluster.dbs[1].latest_sequence_number_relaxed()
        # the deposed leader keeps writing — NOOP-style, acks irrelevant
        for i in range(5):
            leader.write_async(WriteBatch().put(b"x%d" % i, b"y"))
        time.sleep(1.0)
        assert cluster.dbs[1].latest_sequence_number_relaxed() == seq_before
        assert Stats.get().get_counter(
            "replicator.stale_epoch_rejects") >= 1
    finally:
        cluster.stop()


def test_replicate_ack_with_newer_epoch_fences_leader(tmp_path):
    """Mode-2 ack path: a replicate_ack frame carrying a newer epoch
    deposes the leader exactly like a pull does."""
    cluster = _Cluster3(str(tmp_path))
    try:
        leader = cluster.rdbs[0]
        with pytest.raises(RpcApplicationError) as ei:
            leader.post_applied(1, ReplicaRole.FOLLOWER.value, epoch=9)
        assert ei.value.code == ReplicateErrorCode.STALE_EPOCH.value
        assert leader.fenced
        with pytest.raises(RpcApplicationError):
            leader.write_async(WriteBatch().put(b"k", b"v"))
    finally:
        cluster.stop()


def test_set_db_epoch_adopts_in_place(tmp_path):
    """Sticky-leader adoption: the admin RPC raises the epoch with no
    role transition; lower values are no-ops (monotonic)."""
    from rocksplicator_tpu_torch.admin.handler import AdminHandler

    rep = Replicator(port=0, flags=FAST)
    handler = AdminHandler(str(tmp_path / "admin"), rep, device="cpu")
    try:
        asyncio.run(handler.handle_add_db(db_name=DB_NAME, role="LEADER",
                                          epoch=1))
        rdb = rep.get_db(DB_NAME)
        assert rdb.epoch == 1
        asyncio.run(handler.handle_set_db_epoch(db_name=DB_NAME, epoch=4))
        assert rdb.epoch == 4 and not rdb.fenced
        asyncio.run(handler.handle_set_db_epoch(db_name=DB_NAME, epoch=2))
        assert rdb.epoch == 4
        # the epoch survives a role change (max-merged)
        asyncio.run(handler.handle_change_db_role_and_upstream(
            db_name=DB_NAME, new_role="LEADER"))
        assert rep.get_db(DB_NAME).epoch == 4
    finally:
        handler.close()
        rep.stop()


# ---------------------------------------------------------------------------
# participant rejoin after session expiry (no manual restart)
# ---------------------------------------------------------------------------


# flaky_host: host-noise-flaky under full-suite load (passes standalone
# and in targeted runs; the 1.2s session TTL races the loaded host's
# scheduler — reap/rejoin may not complete inside the wait window when
# 600+ tests contend) — retried once by the conftest guard
@pytest.mark.flaky_host
def test_participant_rejoins_after_session_expiry(tmp_path):
    """A reaped participant re-registers its ephemeral instance node,
    republishes current state, and resumes serving as FOLLOWER — the
    state-transition gap the rejoin closes."""
    from rocksplicator_tpu_torch.admin import AdminHandler
    from rocksplicator_tpu_torch.cluster.controller import Controller
    from rocksplicator_tpu_torch.cluster.model import cluster_path
    from rocksplicator_tpu_torch.cluster.participant import Participant
    from rocksplicator_tpu_torch.rpc import RpcServer

    coord_server = CoordinatorServer(port=0, session_ttl=1.2)
    cluster = "rejoin"
    nodes = []

    class Node:
        def __init__(self, name):
            self.replicator = Replicator(port=0, flags=ReplicationFlags(
                server_long_poll_ms=300, pull_error_delay_min_ms=50,
                pull_error_delay_max_ms=120))
            self.handler = AdminHandler(str(tmp_path / name),
                                        self.replicator, device="cpu")
            self.server = RpcServer(port=0, ioloop=self.replicator.ioloop)
            self.server.add_handler(self.handler)
            self.server.start()
            self.instance = InstanceInfo(
                f"127.0.0.1_{self.server.port}", "127.0.0.1",
                self.server.port, self.replicator.port)
            self.participant = Participant(
                "127.0.0.1", coord_server.port, cluster, self.instance,
                catch_up_timeout=10.0)
            self.handler.set_leader_resolver(
                self.participant.make_leader_resolver())

        def stop(self):
            self.participant.stop()
            self.server.stop()
            self.handler.close()
            self.replicator.stop()

    ctrl = None
    client = CoordinatorClient("127.0.0.1", coord_server.port)
    try:
        nodes = [Node("a"), Node("b")]
        ctrl = Controller("127.0.0.1", coord_server.port, cluster,
                          "ctrl", reconcile_interval=0.3)
        ctrl.add_resource(ResourceDef("seg", num_shards=1, replicas=2))

        def states():
            return sorted(
                s for s in (
                    n.participant.current_states.get(PARTITION)
                    for n in nodes) if s)

        assert wait_until(lambda: states() == ["FOLLOWER", "LEADER"],
                          timeout=30)
        victim = next(n for n in nodes
                      if n.participant.current_states.get(PARTITION)
                      == "FOLLOWER")
        leader = next(n for n in nodes if n is not victim)
        node_path = cluster_path(cluster, "instances",
                                 victim.instance.instance_id)
        # wedge: heartbeats stop, session expires, ephemeral reaped
        victim.participant.coord.suspend_heartbeats()
        assert wait_until(lambda: not client.exists(node_path), timeout=10)
        # un-wedge: the next beat gets NO_SESSION → re-establish →
        # rejoin: registration + current state back, serving resumes
        victim.participant.coord.resume_heartbeats()
        assert wait_until(lambda: client.exists(node_path), timeout=10)
        assert wait_until(
            lambda: victim.participant.current_states.get(PARTITION)
            == "FOLLOWER", timeout=15)
        assert Stats.get().get_counter("participant.rejoins") >= 1
        # replication still works through the rejoined follower
        app = leader.handler.db_manager.get_db(DB_NAME)
        app.write(WriteBatch().put(b"post-rejoin", b"v"))
        assert wait_until(
            lambda: (victim.handler.db_manager.get_db(DB_NAME) is not None
                     and victim.handler.db_manager.get_db(DB_NAME)
                     .get(b"post-rejoin") == b"v"), timeout=20)
    finally:
        client.close()
        if ctrl is not None:
            ctrl.stop()
        for n in nodes:
            n.stop()
        coord_server.stop()


# ---------------------------------------------------------------------------
# control-plane retry adoption (spectator / shard-map agent)
# ---------------------------------------------------------------------------


def test_spectator_publish_retries_with_backoff_and_counters(tmp_path):
    """The shardmap.publish failpoint fails the first two publish passes;
    the spectator's refresh loop absorbs them through the unified
    RetryPolicy (visible as retry.attempts op=spectator.publish) and the
    map still lands."""
    from rocksplicator_tpu_torch.cluster.publishers import CallbackPublisher
    from rocksplicator_tpu_torch.cluster.spectator import Spectator

    coord_server = CoordinatorServer(port=0, session_ttl=5.0)
    published = []
    fp.activate("shardmap.publish", "fail_first:2")
    spec = Spectator("127.0.0.1", coord_server.port, "retrycluster",
                     [CallbackPublisher(published.append)])
    try:
        assert wait_until(lambda: len(published) >= 1, timeout=15)
        assert Stats.get().get_counter(
            tagged("retry.attempts", op="spectator.publish")) >= 2
        assert fp.trip_counts().get("shardmap.publish") == 2
    finally:
        spec.stop()
        coord_server.stop()


def test_shardmap_agent_write_retries(tmp_path, monkeypatch):
    import rocksplicator_tpu_torch.cluster.shardmap_agent as sa
    from rocksplicator_tpu_torch.cluster.model import cluster_path
    from rocksplicator_tpu_torch.utils.misc import write_file_atomic

    coord_server = CoordinatorServer(port=0, session_ttl=5.0)
    client = CoordinatorClient("127.0.0.1", coord_server.port)
    target = tmp_path / "map.json"
    fails = {"n": 2}

    def flaky_write(path, data):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("disk blip")
        write_file_atomic(path, data)

    monkeypatch.setattr(sa, "write_file_atomic", flaky_write)
    agent = sa.ShardMapAgent("127.0.0.1", coord_server.port, "c1",
                             str(target))
    try:
        client.put(cluster_path("c1", "shardmap"), b'{"seg": {}}')
        assert wait_until(target.exists, timeout=15)
        assert target.read_bytes() == b'{"seg": {}}'
        assert Stats.get().get_counter(
            tagged("retry.attempts", op="shardmap.write")) >= 2
    finally:
        agent.stop()
        client.close()
        coord_server.stop()


def test_failover_fault_sites_registered():
    """Every site the failover schedule menu arms must be a registered
    failpoint (a typo'd site would arm nothing and pass vacuously)."""
    from rocksplicator_tpu_torch.tools.chaos_soak import _FAILOVER_FAULT_SITES

    for site in _FAILOVER_FAULT_SITES:
        assert site in fp.SITES, site


# ---------------------------------------------------------------------------
# the failover chaos harness (fast tier-1 markers; full run = make
# chaos-failover-smoke)
# ---------------------------------------------------------------------------


# flaky_host: the pre-fault "baseline converged" gate is a wall-clock
# bound on controller passes that races the loaded host's scheduler
# under full-suite contention (passes standalone and in targeted runs;
# seeded invariant VIOLATIONS would reproduce on the retry, so the
# retry-once guard cannot mask a real regression)
@pytest.mark.flaky_host
def test_failover_chaos_schedules_hold_invariants(tmp_path):
    from rocksplicator_tpu_torch.tools.chaos_soak import run_failover_chaos

    result = run_failover_chaos(
        str(tmp_path / "chaos"), schedules=2, seed=1234,
        log=lambda *a: None, device="cpu")
    assert result["violations"] == [], result["violations"]
    assert result["acked"] > 0
    assert all(p <= 80 for p in result["passes_used"])


def test_failover_chaos_catches_fencing_guard(tmp_path):
    """The tooth: a leader patched to IGNORE epochs must be caught
    acking writes after deposition (split brain)."""
    from rocksplicator_tpu_torch.tools.chaos_soak import run_failover_chaos

    result = run_failover_chaos(
        str(tmp_path / "chaos"), schedules=1, seed=7,
        break_guard="fencing", heal_timeout=5.0, log=lambda *a: None,
        device="cpu")
    assert result["violations"], "fencing tooth NOT caught"
    assert any("SPLIT BRAIN" in v for v in result["violations"]), (
        result["violations"])
