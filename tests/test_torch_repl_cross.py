"""The replication and admin wire shared by the two packages.

Four pairings run one counter shard — a leader and a follower, each an
AdminHandler node, driven by an admin client pool — in ack modes 0, 1
and 2, with the multiplexed pull on and off:
- a port follower pulling from a reference leader;
- a reference follower pulling from a port leader;
- a port admin client on reference admin servers;
- a reference admin client on port admin servers.
In every case the live files after ``compact_db`` (sha256, as a
multiset), the sequence numbers and the reads equal an all-reference
run's. A backup written by either package restores on the other into
the backup's own files. Counters and spans of one scenario equal the
reference's. Tolerance 0 throughout; the port's nodes compact on the
card's backend, run on the CPU.
"""

import struct

import numpy as np
import pytest

from torch_parity import (AdminClient, AdminNode, ReplPackage, reset_both,
                          span_shape, tsst_digests, wait_until)

REF, PORT = ReplPackage("ref"), ReplPackage("port")
BY_KEY = {"ref": REF, "port": PORT}
DB_NAME = "seg00001"
N_KEYS = 256
pack = struct.Struct("<Q").pack

# leader node, follower node, admin client
PAIRINGS = {
    "port_follower_of_ref_leader": ("ref", "port", "port"),
    "ref_follower_of_port_leader": ("port", "ref", "ref"),
    "port_client_on_ref_servers": ("ref", "ref", "port"),
    "ref_client_on_port_servers": ("port", "port", "ref"),
}


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield
    reset_both()


def counter_batches(pkg, seed=7, batches=8, ops=64):
    """The counter mix (60/30/10 MERGE/PUT/DELETE of 8-byte values) over
    16-byte keys, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        batch = pkg.WriteBatch()
        kinds = rng.random(ops)
        keys = rng.integers(0, N_KEYS, ops)
        vals = rng.integers(0, 1 << 20, ops)
        for kind, k, v in zip(kinds, keys, vals):
            key = b"counter:%08d" % k
            if kind < 0.6:
                batch.merge(key, pack(int(v)))
            elif kind < 0.9:
                batch.put(key, pack(int(v)))
            else:
                batch.delete(key)
        out.append(batch)
    return out


def options_gen(pkg):
    # a small memtable: each replica flushes and compacts on its own
    return lambda segment: pkg.DBOptions(
        merge_operator=pkg.UInt64AddOperator(), memtable_bytes=2048,
        level0_compaction_trigger=3)


def run_shard(tmp_path, leader_key, follower_key, client_key, mode, mux):
    leader_pkg, follower_pkg = BY_KEY[leader_key], BY_KEY[follower_key]
    nodes = []
    client = AdminClient(BY_KEY[client_key])
    try:
        for name, pkg in (("leader", leader_pkg), ("follower", follower_pkg)):
            nodes.append(AdminNode(pkg, tmp_path, name,
                                   flags=pkg.flags(pull_mux=mux),
                                   options_generator=options_gen(pkg)))
        leader, follower = nodes
        client(leader, "add_db", db_name=DB_NAME, role="LEADER",
               replication_mode=mode)
        client(follower, "add_db", db_name=DB_NAME, role="FOLLOWER",
               upstream_ip=leader.repl_addr[0],
               upstream_port=leader.repl_addr[1], replication_mode=mode)
        app = leader.app_db(DB_NAME)
        for batch in counter_batches(leader_pkg):
            app.write(batch)
        want = client(leader, "get_sequence_number",
                      db_name=DB_NAME)["seq_num"]
        assert wait_until(lambda: client(
            follower, "get_sequence_number",
            db_name=DB_NAME)["seq_num"] == want)
        out = {}
        keys = [b"counter:%08d" % k for k in range(N_KEYS)]
        for role, node in (("leader", leader), ("follower", follower)):
            client(node, "compact_db", db_name=DB_NAME)
            app_db = node.app_db(DB_NAME)
            out[role] = (tsst_digests(app_db.db),
                         client(node, "get_sequence_number",
                                db_name=DB_NAME)["seq_num"],
                         app_db.multi_get(keys))
        return out
    finally:
        for n in nodes:
            n.stop()
        client.close()


_BASELINE = {}


def all_reference(tmp_path_factory):
    if "run" not in _BASELINE:
        _BASELINE["run"] = run_shard(tmp_path_factory.mktemp("allref"),
                                     "ref", "ref", "ref", 0, False)
    return _BASELINE["run"]


@pytest.mark.parametrize("mux", [False, True], ids=["solo", "mux"])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
def test_crosswise_pairing_equals_all_reference(pairing, mode, mux, tmp_path,
                                                tmp_path_factory):
    base = all_reference(tmp_path_factory)
    got = run_shard(tmp_path, *PAIRINGS[pairing], mode, mux)
    files, seq, reads = base["leader"]
    assert files and seq == 8 * 64
    assert base["follower"] == base["leader"]
    assert got["leader"] == base["leader"]
    assert got["follower"] == base["leader"]


@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref")])
def test_backup_restores_across_packages(src, dst, tmp_path):
    spkg, dpkg = BY_KEY[src], BY_KEY[dst]
    store_uri = str(tmp_path / "bucket")
    source = AdminNode(spkg, tmp_path, "source",
                       options_generator=options_gen(spkg))
    target = AdminNode(dpkg, tmp_path, "target",
                       options_generator=options_gen(dpkg))
    scall, tcall = AdminClient(spkg), AdminClient(dpkg)
    try:
        scall(source, "add_db", db_name=DB_NAME, role="LEADER")
        app = source.app_db(DB_NAME)
        for batch in counter_batches(spkg):
            app.write(batch)
        app.db.flush()
        backup = scall(source, "backup_db_to_s3", db_name=DB_NAME,
                       s3_bucket=store_uri, s3_backup_dir="b/" + DB_NAME)
        files = tsst_digests(app.db)
        tcall(target, "restore_db_from_s3", db_name=DB_NAME,
              s3_bucket=store_uri, s3_backup_dir="b/" + DB_NAME)
        restored = target.app_db(DB_NAME)
        assert backup["seq"] == 8 * 64
        assert tcall(target, "get_sequence_number",
                     db_name=DB_NAME)["seq_num"] == backup["seq"]
        assert tsst_digests(restored.db) == files != []
        keys = [b"counter:%08d" % k for k in range(N_KEYS)]
        assert restored.multi_get(keys) == app.multi_get(keys)
    finally:
        for n in (source, target):
            n.stop()
        scall.close()
        tcall.close()


# counters whose values a scenario fixes (pull and serve counts depend
# on timing; their spans are compared as a set below)
FIXED_COUNTERS = ("leader_writes", "leader_write_bytes", "ack_waits",
                  "ack_timeouts", "ack_degraded", "pull_updates_applied",
                  "replicate_updates_sent", "stale_epoch_rejects", "fenced",
                  "wal_gap_stalls", "upstream_resets")


def observed_scenario(pkg, tmp_path):
    """A leader and a follower in mode 1: writes, reads, compact_db and a
    backup; returns the counters and the span trees."""
    reset_both()
    client = AdminClient(pkg)
    gen = lambda segment: pkg.DBOptions(  # noqa: E731
        merge_operator=pkg.UInt64AddOperator())
    leader = AdminNode(pkg, tmp_path, "leader", options_generator=gen)
    follower = AdminNode(pkg, tmp_path, "follower", options_generator=gen)
    try:
        client(leader, "add_db", db_name=DB_NAME, role="LEADER",
               replication_mode=1)
        client(follower, "add_db", db_name=DB_NAME, role="FOLLOWER",
               upstream_ip=leader.repl_addr[0],
               upstream_port=leader.repl_addr[1], replication_mode=1)
        app = leader.app_db(DB_NAME)
        for batch in counter_batches(pkg, batches=4):
            app.write(batch)
        assert wait_until(lambda: follower.app_db(
            DB_NAME).latest_sequence_number() == 4 * 64)
        keys = [b"counter:%08d" % k for k in range(N_KEYS)]
        app.multi_get(keys)
        app.get(keys[0])
        for node in (leader, follower):
            client(node, "compact_db", db_name=DB_NAME)
        client(follower, "backup_db_to_s3", db_name=DB_NAME,
               s3_bucket=str(tmp_path / "bucket"), s3_backup_dir="b")
        stats = pkg.Stats.get()
        counters = {k: stats.get_counter(pkg.M[k]) for k in FIXED_COUNTERS}
        for name in ("applicationdb.writes", "applicationdb.gets",
                     "applicationdb.multigets"):
            counters[name] = stats.get_counter(pkg.tagged(name, db=DB_NAME))
        shard = [k for k in stats.export_state()["counters"]
                 if k.startswith("replicator.shard_writes")]
        counters["replicator.shard_writes"] = sum(
            stats.get_counter(k) for k in shard)
        counters["admin.compact_ms"] = stats.metric_count("admin.compact_ms")
        counters["admin.backup_ms"] = stats.metric_count("admin.backup_ms")
        timed = ("duration_ms", "ms", "bytes", "lag_ms", "elapsed_ms")
        fixed = span_shape(pkg.collector, ("repl.write", "repl.wal_write",
                                           "admin.", "backup.",
                                           "compaction", "lsm"),
                           timed=timed)
        timing = set(span_shape(pkg.collector, ("repl.pull", "repl.serve",
                                                "repl.apply"),
                                timed=timed))
        return counters, fixed, {(k[0], k[1]) for k in timing}
    finally:
        follower.stop()
        leader.stop()
        client.close()


def test_counters_and_spans_equal_reference(tmp_path):
    ref = observed_scenario(REF, tmp_path / "ref")
    port = observed_scenario(PORT, tmp_path / "port")
    counters, fixed, timing = ref
    assert counters["leader_writes"] == 4
    assert counters["pull_updates_applied"] == 4
    assert counters["applicationdb.multigets"] == N_KEYS
    assert counters["admin.compact_ms"] == 2
    assert counters["replicator.shard_writes"] == 4
    assert fixed and timing
    assert port[0] == counters
    assert port[1] == fixed
    assert port[2] == timing
