"""The port's WebHDFS object store (``utils/hdfs.py``) against the JAX
package's, on the JAX package's stub namenode/datanode
(``tests/test_hdfs.py``): every scenario of that file on each package's
``HdfsObjectStore``; the same operations leave the same files on the
stub; ``build_object_store("hdfs://...")`` routes to the port's store (it
raised ImportError before the port had the module); and the admin plane's
backup to an ``hdfs://`` store restores across the packages, both ways.
"""

import asyncio
import importlib

import pytest

from test_hdfs import _StubWebHdfs, hdfs_stub_uri  # noqa: F401

PKGS = {"ref": "rocksplicator_tpu", "port": "rocksplicator_tpu_torch"}


def mod(key: str, name: str):
    return importlib.import_module(f"{PKGS[key]}.{name}")


@pytest.fixture(autouse=True)
def _fresh_port_singletons():
    from torch_parity import reset_observability

    import rocksplicator_tpu_torch

    reset_observability(rocksplicator_tpu_torch, sample_rate=0.0)
    yield


@pytest.fixture(params=list(PKGS))
def store(request, hdfs_stub_uri):  # noqa: F811
    hdfs = mod(request.param, "utils.hdfs")
    yield hdfs, hdfs.HdfsObjectStore(hdfs_stub_uri)


def test_direct_answer_gateway_does_not_drop_body(store):
    _hdfs, s = store
    _StubWebHdfs.direct_mode = True
    s.put_object_bytes("direct/file", b"payload-bytes")
    assert s.get_object_bytes("direct/file") == b"payload-bytes"


def test_put_get_roundtrip_via_redirect(store):
    _hdfs, s = store
    s.put_object_bytes("db1/MANIFEST", b"manifest-bytes")
    assert s.get_object_bytes("db1/MANIFEST") == b"manifest-bytes"
    s.put_object_bytes("db1/MANIFEST", b"v2")
    assert s.get_object_bytes("db1/MANIFEST") == b"v2"


def test_list_delete_copy(store):
    _hdfs, s = store
    s.put_object_bytes("db1/000001.sst", b"a" * 100)
    s.put_object_bytes("db1/sub/000002.sst", b"b" * 100)
    s.put_object_bytes("db2/CURRENT", b"c")
    assert s.list_objects("db1") == ["db1/000001.sst", "db1/sub/000002.sst"]
    s.copy_object("db2/CURRENT", "db1/CURRENT")
    assert s.get_object_bytes("db1/CURRENT") == b"c"
    s.delete_object("db1/000001.sst")
    assert s.list_objects("db1") == ["db1/CURRENT", "db1/sub/000002.sst"]


def test_file_transfer_and_batch(store, tmp_path):
    _hdfs, s = store
    src = tmp_path / "seg.sst"
    src.write_bytes(b"x" * 4096)
    s.put_object(str(src), "up/seg.sst")
    dst = tmp_path / "back.sst"
    s.get_object("up/seg.sst", str(dst))
    assert dst.read_bytes() == b"x" * 4096
    out = s.get_objects("up", str(tmp_path / "batch"))
    assert len(out) == 1 and out[0].endswith("seg.sst")


def test_list_partial_filename_prefix(store):
    _hdfs, s = store
    s.put_object_bytes("bk/db1/dbmeta-000010", b"a")
    s.put_object_bytes("bk/db1/dbmeta-000020", b"b")
    s.put_object_bytes("bk/db1/other", b"c")
    assert s.list_objects("bk/db1/dbmeta") == [
        "bk/db1/dbmeta-000010", "bk/db1/dbmeta-000020"]
    s.put_object_bytes("bk/db1/sub/dbmeta-000030", b"d")
    assert s.list_objects("bk/db1") == [
        "bk/db1/dbmeta-000010", "bk/db1/dbmeta-000020", "bk/db1/other",
        "bk/db1/sub/dbmeta-000030"]


def test_missing_object_raises(store):
    hdfs, s = store
    with pytest.raises(hdfs.HdfsError):
        s.get_object_bytes("nope/missing")
    assert s.list_objects("nope") == []


def test_same_operations_same_files(hdfs_stub_uri, tmp_path):  # noqa: F811
    """One script of puts, file uploads, copies and deletes through each
    package's store, under its own base path: the stub holds the same
    files with the same bytes for both."""
    src = tmp_path / "blob"
    src.write_bytes(bytes(range(256)) * 64)
    trees = {}
    for key in PKGS:
        base = f"{hdfs_stub_uri}/{key}"
        s = mod(key, "utils.hdfs").HdfsObjectStore(base)
        s.put_object_bytes("db/MANIFEST", b"m1")
        s.put_object_bytes("db/MANIFEST", b"m2")
        s.put_object(str(src), "db/000001.tsst")
        s.put_object_bytes("db/sub/000002.tsst", b"z" * 1000)
        s.copy_object("db/000001.tsst", "db/000003.tsst")
        s.delete_object("db/sub/000002.tsst")
        prefix = f"/backups/{key}/"
        trees[key] = {p[len(prefix):]: d for p, d in
                      _StubWebHdfs.files.items() if p.startswith(prefix)}
    assert trees["port"] == trees["ref"]
    assert sorted(trees["port"]) == ["db/000001.tsst", "db/000003.tsst",
                                     "db/MANIFEST"]


def test_build_object_store_routes_hdfs():
    from rocksplicator_tpu_torch.utils.hdfs import HdfsObjectStore
    from rocksplicator_tpu_torch.utils.objectstore import build_object_store

    store = build_object_store("hdfs://127.0.0.1:19999/base")
    assert isinstance(store, HdfsObjectStore)


def _handler(key, path):
    replicator = mod(key, "replication").Replicator(
        port=0, flags=mod(key, "replication").ReplicationFlags())
    kw = {"device": "cpu"} if key == "port" else {}
    return replicator, mod(key, "admin").AdminHandler(str(path), replicator,
                                                      **kw)


def _call(node, method, **kw):
    replicator, handler = node
    return asyncio.run_coroutine_threadsafe(
        getattr(handler, f"handle_{method}")(**kw),
        replicator.ioloop.loop).result(60)


@pytest.mark.parametrize("writer,reader",
                         [("port", "port"), ("ref", "port"),
                          ("port", "ref")],
                         ids=["port-port", "ref_backup-port_restore",
                              "port_backup-ref_restore"])
def test_admin_backup_restore_over_hdfs(hdfs_stub_uri, tmp_path,  # noqa
                                        writer, reader):
    """backup_db_to_s3 of one package's handler to an ``hdfs://`` store,
    restore_db_from_s3 by the other's: the sequence number and every key
    come back."""
    nodes = []
    try:
        src = _handler(writer, tmp_path / "src")
        nodes.append(src)
        _call(src, "add_db", db_name="seg00001", role="LEADER")
        app = src[1].db_manager.get_db("seg00001")
        WriteBatch = mod(writer, "storage").WriteBatch
        for i in range(50):
            app.write(WriteBatch().put(f"k{i}".encode(), f"v{i}".encode()))
        r = _call(src, "backup_db_to_s3", db_name="seg00001",
                  s3_bucket=hdfs_stub_uri, s3_backup_dir="backups/seg00001")
        assert r["seq"] == 50
        assert any("seg00001" in p for p in _StubWebHdfs.files)
        dst = _handler(reader, tmp_path / "dst")
        nodes.append(dst)
        _call(dst, "restore_db_from_s3", db_name="seg00001",
              s3_bucket=hdfs_stub_uri, s3_backup_dir="backups/seg00001")
        assert _call(dst, "get_sequence_number",
                     db_name="seg00001")["seq_num"] == 50
        db = dst[1].db_manager.get_db("seg00001")
        assert [db.get(f"k{i}".encode()) for i in range(50)] == [
            f"v{i}".encode() for i in range(50)]
    finally:
        for replicator, handler in nodes:
            handler.close()
            replicator.stop()
