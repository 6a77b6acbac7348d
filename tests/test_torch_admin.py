"""The port's admin plane against the JAX package's: the reference's
scenarios (``tests/test_admin.py``) on each package's own AdminHandler,
Replicator, RpcServer and client pool — ping and not-found,
add_db/write/read/seq, leader and follower through admin RPCs, close
and clear, a role change for failover, backup/restore to itself and to a
peer, the SST-ingest cases, set_db_options and compact_db,
storage_info_text, the backup manager's incremental passes and its WAL
archive with a point-in-time restore. The port's handler runs its DBs'
compactions on the card's backend, on the CPU here (``device="cpu"``).

Then what is the port's own: the default handler compacts on the card and
refuses to start without CUDA, ``gpu_compaction=False`` names the host's
``NativeCompactionBackend`` (the meta_db too), and a card replica's
failed background compaction is the compaction's error, never retried on
the host.
"""

import struct

import pytest
import torch

from torch_parity import (AdminClient, AdminNode, ReplPackage, reset_both,
                          wait_until)

PKGS = [ReplPackage("ref"), ReplPackage("port")]
PORT = PKGS[1]


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield
    reset_both()


@pytest.fixture(params=PKGS, ids=repr)
def pkg(request):
    return request.param


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


def put(pkg, k, v):
    return pkg.WriteBatch().put(k, v)


def seq(call, node, name="seg00001"):
    return call(node, "get_sequence_number", db_name=name)["seq_num"]


def test_ping_and_not_found(pkg, nodes, call):
    n = nodes("a")
    assert call(n, "ping")["ok"] is True
    with pytest.raises(pkg.RpcApplicationError) as ei:
        call(n, "get_sequence_number", db_name="nope")
    assert ei.value.code == "DB_NOT_FOUND"


def test_add_db_write_read_seq(pkg, nodes, call):
    n = nodes("a")
    call(n, "add_db", db_name="seg00001", role="LEADER")
    with pytest.raises(pkg.RpcApplicationError) as ei:
        call(n, "add_db", db_name="seg00001", role="LEADER")
    assert ei.value.code == "DB_ALREADY_EXISTS"
    n.app_db("seg00001").write(put(pkg, b"k", b"v"))
    assert seq(call, n) == 1
    check = call(n, "check_db", db_name="seg00001")
    assert (check["seq_num"], check["role"]) == (1, "LEADER")
    assert n.app_db("seg00001").get(b"k") == b"v"
    with pytest.raises(pkg.RpcApplicationError) as ei:
        call(n, "add_db", db_name="seg00002", role="FOLLOWER")
    assert ei.value.code == "INVALID_UPSTREAM"


def test_leader_follower_via_admin(pkg, nodes, call):
    a, b = nodes("a"), nodes("b")
    call(a, "add_db", db_name="seg00001", role="LEADER")
    call(b, "add_db", db_name="seg00001", role="SLAVE",
         upstream_ip=a.repl_addr[0], upstream_port=a.repl_addr[1])
    app_db = a.app_db("seg00001")
    for i in range(10):
        app_db.write(put(pkg, f"k{i}".encode(), b"v"))
    assert wait_until(lambda: seq(call, b) == 10)
    assert b.app_db("seg00001").get(b"k9") == b"v"


def test_close_and_clear_db(pkg, nodes, call):
    n = nodes("a")
    call(n, "add_db", db_name="seg00001", role="LEADER")
    n.app_db("seg00001").write(put(pkg, b"k", b"v"))
    call(n, "close_db", db_name="seg00001")
    assert n.app_db("seg00001") is None
    call(n, "add_db", db_name="seg00001", role="LEADER")
    assert seq(call, n) == 1
    call(n, "clear_db", db_name="seg00001")
    assert seq(call, n) == 0


def test_change_db_role_and_upstream_failover(pkg, nodes, call):
    a, b = nodes("a"), nodes("b")
    call(a, "add_db", db_name="seg00001", role="LEADER")
    call(b, "add_db", db_name="seg00001", role="FOLLOWER",
         upstream_ip=a.repl_addr[0], upstream_port=a.repl_addr[1])
    a.app_db("seg00001").write(put(pkg, b"k1", b"v1"))
    assert wait_until(lambda: seq(call, b) == 1)
    call(a, "close_db", db_name="seg00001")
    call(b, "change_db_role_and_upstream", db_name="seg00001",
         new_role="MASTER")
    call(a, "add_db", db_name="seg00001", role="FOLLOWER",
         upstream_ip=b.repl_addr[0], upstream_port=b.repl_addr[1])
    b.app_db("seg00001").write(put(pkg, b"k2", b"v2"))
    assert wait_until(lambda: seq(call, a) == 2)
    assert a.app_db("seg00001").get(b"k2") == b"v2"


def test_backup_restore_roundtrip(pkg, nodes, call, tmp_path):
    n = nodes("a")
    store_uri = str(tmp_path / "bucket")
    call(n, "add_db", db_name="seg00001", role="LEADER")
    app_db = n.app_db("seg00001")
    for i in range(50):
        app_db.write(put(pkg, f"k{i}".encode(), f"v{i}".encode()))
    r = call(n, "backup_db_to_s3", db_name="seg00001", s3_bucket=store_uri,
             s3_backup_dir="backups/seg00001")
    assert r["seq"] == 50
    call(n, "clear_db", db_name="seg00001", reopen_db=False)
    call(n, "restore_db_from_s3", db_name="seg00001", s3_bucket=store_uri,
         s3_backup_dir="backups/seg00001")
    assert seq(call, n) == 50
    assert n.app_db("seg00001").get(b"k49") == b"v49"


def test_backup_restore_to_peer(pkg, nodes, call, tmp_path):
    a, b = nodes("a"), nodes("b")
    store_uri = str(tmp_path / "bucket")
    call(a, "add_db", db_name="seg00001", role="LEADER")
    adb = a.app_db("seg00001")
    for i in range(20):
        adb.write(put(pkg, f"k{i}".encode(), b"v"))
    call(a, "backup_db", db_name="seg00001", hdfs_backup_dir=store_uri)
    call(b, "restore_db", db_name="seg00001", hdfs_backup_dir=store_uri,
         upstream_ip=a.repl_addr[0], upstream_port=a.repl_addr[1])
    adb.write(put(pkg, b"new", b"x"))
    assert wait_until(lambda: seq(call, b) == 21)
    assert b.app_db("seg00001").get(b"new") == b"x"


def _sst_in_store(pkg, store, prefix, items, tmp_path, name="bulk.tsst"):
    local = tmp_path / f"{pkg.key}-{name}"
    w = pkg.SSTWriter(str(local))
    for k, v in items:
        w.add(k, 0, pkg.OpType.PUT, v)
    w.finish()
    store.put_object(str(local), f"{prefix}/{name}")


def test_add_sst_files_ingest(pkg, nodes, call, tmp_path):
    n = nodes("a")
    store_uri = str(tmp_path / "bucket")
    _sst_in_store(pkg, pkg.LocalObjectStore(store_uri), "sst/v1",
                  [(b"a", b"1"), (b"b", b"2")], tmp_path)
    call(n, "add_db", db_name="seg00001", role="LEADER")
    r = call(n, "add_s3_sst_files_to_db", db_name="seg00001",
             s3_bucket=store_uri, s3_path="sst/v1")
    assert r["ingested_files"] == 1
    assert n.app_db("seg00001").get(b"a") == b"1"
    r2 = call(n, "add_s3_sst_files_to_db", db_name="seg00001",
              s3_bucket=store_uri, s3_path="sst/v1")
    assert r2.get("skipped") is True
    assert n.handler.get_meta_data("seg00001").s3_path == "sst/v1"


def test_add_sst_files_full_replace_and_compact(pkg, nodes, call, tmp_path):
    n = nodes("a")
    store_uri = str(tmp_path / "bucket")
    _sst_in_store(pkg, pkg.LocalObjectStore(store_uri), "sst/v2",
                  [(b"new", b"data")], tmp_path)
    call(n, "add_db", db_name="seg00001", role="LEADER")
    n.app_db("seg00001").write(put(pkg, b"old", b"x"))
    call(n, "add_s3_sst_files_to_db", db_name="seg00001",
         s3_bucket=store_uri, s3_path="sst/v2",
         allow_overlapping_keys=False, compact_db_after_load=True)
    app_db2 = n.app_db("seg00001")
    assert app_db2.get(b"old") is None
    assert app_db2.get(b"new") == b"data"


def test_add_sst_files_ingest_behind(pkg, nodes, call, tmp_path):
    n = nodes("a", options_generator=lambda segment: pkg.DBOptions(
        allow_ingest_behind=True))
    store_uri = str(tmp_path / "bucket")
    _sst_in_store(pkg, pkg.LocalObjectStore(store_uri), "sst/vb",
                  [(b"base", b"bulk"), (b"k", b"bulk")], tmp_path)
    call(n, "add_db", db_name="seg00001", role="LEADER")
    app_db = n.app_db("seg00001")
    app_db.write(put(pkg, b"k", b"live"))
    call(n, "add_s3_sst_files_to_db", db_name="seg00001",
         s3_bucket=store_uri, s3_path="sst/vb", ingest_behind=True)
    assert app_db.get(b"k") == b"live"
    assert app_db.get(b"base") == b"bulk"


def test_add_sst_files_ingest_behind_rejected_without_option(
        pkg, nodes, call, tmp_path):
    n = nodes("a")
    store_uri = str(tmp_path / "bucket")
    _sst_in_store(pkg, pkg.LocalObjectStore(store_uri), "sst/vx",
                  [(b"a", b"1")], tmp_path)
    call(n, "add_db", db_name="seg00001", role="LEADER")
    with pytest.raises(pkg.RpcApplicationError) as ei:
        call(n, "add_s3_sst_files_to_db", db_name="seg00001",
             s3_bucket=store_uri, s3_path="sst/vx", ingest_behind=True)
    assert ei.value.code == "DB_ADMIN_ERROR"


def test_set_db_options_and_compact(pkg, nodes, call):
    n = nodes("a")
    call(n, "add_db", db_name="seg00001", role="LEADER")
    call(n, "set_db_options", db_name="seg00001",
         options={"disable_auto_compaction": True, "memtable_bytes": 4096})
    app_db = n.app_db("seg00001")
    assert app_db.db.options.disable_auto_compaction is True
    with pytest.raises(pkg.RpcApplicationError):
        call(n, "set_db_options", db_name="seg00001",
             options={"num_levels": 2})
    for i in range(10):
        app_db.write(put(pkg, f"k{i}".encode(), b"v"))
        app_db.write(pkg.WriteBatch().delete(f"k{i}".encode()))
    call(n, "compact_db", db_name="seg00001")
    assert list(app_db.new_iterator()) == []
    assert pkg.Stats.get().metric_count("admin.compact_ms") == 1


def test_storage_info_text(pkg, nodes, call):
    n = nodes("a")
    call(n, "add_db", db_name="seg00001", role="LEADER")
    text = n.handler.storage_info_text()
    assert "db=seg00001" in text and "role=LEADER" in text


def test_backup_manager_incremental(pkg, nodes, call, tmp_path):
    n = nodes("a")
    for name in ("seg00001", "seg00002"):
        call(n, "add_db", db_name=name, role="LEADER")
        for i in range(10):
            n.app_db(name).write(put(pkg, f"k{i}".encode(), b"v"))
    store = pkg.LocalObjectStore(str(tmp_path / "bucket"))
    mgr = pkg.BackupManager(n.handler.db_manager, store, "inc")
    assert mgr.backup_all_dbs() == 2
    before = set(store.list_objects("inc/seg00001/"))
    assert any("sst-" in f for f in before)
    n.app_db("seg00001").write(put(pkg, b"more", b"x"))
    assert mgr.backup_all_dbs() == 2
    assert before <= set(store.list_objects("inc/seg00001/"))
    dbmeta = pkg.backup.restore_db(store, "inc/seg00001",
                                   str(tmp_path / "r1"))
    with pkg.open_db(tmp_path / "r1") as restored:
        assert restored.get(b"more") == b"x"
        assert restored.latest_sequence_number() == dbmeta["seq"] == 11


def test_backup_manager_wal_archive_and_admin_pitr(pkg, nodes, call,
                                                   tmp_path):
    n = nodes("a")
    call(n, "add_db", db_name="seg00001", role="LEADER")
    app_db = n.app_db("seg00001")
    for i in range(10):
        app_db.write(put(pkg, f"k{i}".encode(), b"v1"))
    store = pkg.LocalObjectStore(str(tmp_path / "bucket"))
    mgr = pkg.BackupManager(n.handler.db_manager, store, "inc",
                            archive_wal=True)
    assert mgr.backup_all_dbs() == 1
    assert app_db.db.options.wal_archive_sink is not None
    for i in range(5):
        app_db.write(put(pkg, f"mid{i}".encode(), b"v2"))
    mid_seq = app_db.db.latest_sequence_number()
    for i in range(5):
        app_db.write(put(pkg, f"late{i}".encode(), b"v3"))
    assert mgr.backup_all_dbs() == 1
    call(n, "restore_db_from_s3", db_name="seg00002",
         s3_bucket=str(tmp_path / "bucket"), s3_backup_dir="inc/seg00001",
         to_seq=mid_seq)
    rdb = n.app_db("seg00002")
    assert rdb.get(b"mid4") == b"v2" and rdb.get(b"k0") == b"v1"
    assert seq(call, n, "seg00002") == mid_seq
    assert rdb.get(b"late0") is None


# ---------------------------------------------------------------------------
# the port's own: the card by default, the host by name, no fallback
# ---------------------------------------------------------------------------


def _backends(node, name):
    from rocksplicator_tpu_torch.gpu.backend import GpuCompactionBackend
    from rocksplicator_tpu_torch.storage.native_compaction import (
        NativeCompactionBackend)

    kinds = {GpuCompactionBackend: "card", NativeCompactionBackend: "host"}
    return (kinds[type(node.app_db(name).db._backend)],
            kinds[type(node.handler._meta_db._backend)])


def test_card_compaction_installs_backend(tmp_path):
    """The default handler (here on the CPU) names the card's backend on
    every DB it hosts and on its meta_db, and compact_db runs it."""
    call = AdminClient(PORT)
    n = AdminNode(PORT, tmp_path, "card")
    try:
        call(n, "add_db", db_name="seg00001", role="LEADER")
        assert _backends(n, "seg00001") == ("card", "card")
        app_db = n.app_db("seg00001")
        assert str(app_db.db._backend.device) == "cpu"
        app_db.write(put(PORT, b"a", b"1"))
        app_db.write(PORT.WriteBatch().delete(b"a"))
        app_db.write(put(PORT, b"b", b"2"))
        call(n, "compact_db", db_name="seg00001")
        assert app_db.get(b"a") is None and app_db.get(b"b") == b"2"
        assert n.handler._batch_compactor.device.type == "cpu"
    finally:
        n.stop()
        call.close()


def test_host_compaction_names_native_backend(tmp_path):
    call = AdminClient(PORT)
    n = AdminNode(PORT, tmp_path, "host", gpu_compaction=False)
    try:
        call(n, "add_db", db_name="seg00001", role="LEADER")
        assert _backends(n, "seg00001") == ("host", "host")
        assert n.handler.device is None
        assert n.handler._batch_compactor.device is None
    finally:
        n.stop()
        call.close()


def test_default_handler_refuses_to_start_without_cuda(tmp_path):
    """With no device the handler compacts on the card: without CUDA its
    constructor raises before it opens anything (so add_db is never
    reached and no host DB is opened); on the host it opens once asked."""
    assert not torch.cuda.is_available()
    replicator = PORT.Replicator(port=0, flags=PORT.flags())
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PORT.AdminHandler(str(tmp_path / "node"), replicator)
        assert not (tmp_path / "node" / "meta_db").exists()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PORT.AdminHandler(str(tmp_path / "node"), replicator,
                              device="cuda")
        assert not (tmp_path / "node" / "meta_db").exists()
    finally:
        replicator.stop()


def test_card_replica_compaction_failure_is_not_retried_on_host(
        tmp_path, monkeypatch):
    """A card replica whose background compaction fails: the error
    reaches ``_bg_compaction_error`` and neither the card's tuple path
    nor the host's backend merges in its place."""
    from rocksplicator_tpu_torch.gpu import compaction_service as cs
    from rocksplicator_tpu_torch.gpu.backend import GpuCompactionBackend
    from rocksplicator_tpu_torch.storage import native_compaction

    calls = {"direct": 0, "tuple": 0, "host": 0}

    class FailingCard(GpuCompactionBackend):
        def merge_runs_to_files(self, *a, **kw):
            calls["direct"] += 1
            raise RuntimeError("injected kernel launch failure")

        def merge_runs(self, *a, **kw):
            calls["tuple"] += 1
            return super().merge_runs(*a, **kw)

    def install(options, device=None):
        backend = FailingCard(device="cpu")
        backend.device = torch.device("cuda")  # a card replica's backend
        options.compaction_backend = backend
        return options

    def host(*a, **kw):
        calls["host"] += 1
        raise AssertionError("the host merged a card replica's compaction")

    monkeypatch.setattr(cs.GpuCompactionService, "install_on_options",
                        staticmethod(install))
    for name in ("merge_runs", "merge_runs_to_files"):
        monkeypatch.setattr(native_compaction.NativeCompactionBackend, name,
                            host)
    pack = struct.Struct("<Q").pack
    opts = dict(merge_operator=PORT.UInt64AddOperator(), memtable_bytes=1024,
                level0_compaction_trigger=2, background_compaction=True)
    call = AdminClient(PORT)
    # the leader (a host node) never compacts here
    leader = AdminNode(PORT, tmp_path, "leader", gpu_compaction=False,
                       options_generator=lambda s: PORT.DBOptions(
                           merge_operator=PORT.UInt64AddOperator()))
    follower = AdminNode(PORT, tmp_path, "follower",
                         options_generator=lambda s: PORT.DBOptions(**opts))
    try:
        call(leader, "add_db", db_name="seg00001", role="LEADER")
        call(follower, "add_db", db_name="seg00001", role="FOLLOWER",
             upstream_ip=leader.repl_addr[0],
             upstream_port=leader.repl_addr[1])
        fdb = follower.app_db("seg00001").db
        for r in range(3):
            batch = PORT.WriteBatch()
            for i in range(40):
                batch.merge(b"k%04d" % i, pack(r))
            leader.app_db("seg00001").write(batch)
            # a flush a batch: the follower's L0 reaches the trigger
            # however the background flush groups its memtables
            assert wait_until(
                lambda: fdb.latest_sequence_number() == 40 * (r + 1))
            fdb.flush()
        assert wait_until(lambda: fdb._bg_compaction_error is not None)
        assert "injected kernel launch failure" in repr(
            fdb._bg_compaction_error)
        assert calls["direct"] >= 1
        assert calls["tuple"] == calls["host"] == 0
    finally:
        follower.stop()
        leader.stop()
        call.close()
