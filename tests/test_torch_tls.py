"""The port's TLS (``utils/ssl_context_manager.py``) against the JAX
package's: mutual TLS on the RPC plane with a port client on a reference
server and a reference client on a port server, plaintext and foreign-CA
clients refused, certificates in the wrong role refused by the EKU check,
the refresh thread shared and reaped, rotated certificates picked up,
replication between a port and a reference node under mutual TLS both
ways, and the admin plane over TLS. Before the port had the module every
TLS client, server and replicator of the port raised ImportError.

Minting the test CA needs pyca/cryptography: these tests skip where it is
not installed, as the JAX package's TLS tests do.
"""

import importlib
import shutil
import ssl
import threading
import time

import pytest

pytest.importorskip(
    "cryptography",
    reason="TLS tests need the 'cryptography' package to mint the test CA")

PKGS = {"ref": "rocksplicator_tpu", "port": "rocksplicator_tpu_torch"}
# (client's package, server's package)
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]
PAIR_IDS = [f"client_{c}-server_{s}" for c, s in PAIRS]


def mod(key: str, name: str):
    return importlib.import_module(f"{PKGS[key]}.{name}")


@pytest.fixture(autouse=True)
def _fresh_port_singletons():
    from torch_parity import reset_observability

    import rocksplicator_tpu_torch

    reset_observability(rocksplicator_tpu_torch, sample_rate=0.0)
    mod("port", "rpc.admission").TenantAdmission.reset_for_test()
    yield


@pytest.fixture(scope="module", params=list(PKGS))
def tls_certs(request, tmp_path_factory):
    """A test CA with a server and a client certificate, minted by each
    package's ``make_test_ca`` in turn: the tests run on both."""
    return mod(request.param, "utils.ssl_context_manager").make_test_ca(
        str(tmp_path_factory.mktemp("certs")))


def managers(key, certs, server_cert="server", client_cert="client",
             **kw):
    M = mod(key, "utils.ssl_context_manager").SslContextManager
    server = M(certs[f"{server_cert}_cert"], certs[f"{server_cert}_key"],
               ca_path=certs["ca_cert"], server_side=True, **kw)
    client = M(certs[f"{client_cert}_cert"], certs[f"{client_cert}_key"],
               ca_path=certs["ca_cert"], server_side=False, **kw)
    return server, client


class EchoHandler:
    async def handle_echo(self, text="", blob=b""):
        return {"text": text, "blob": bytes(blob) + b"!"}


def serve(key, ssl_manager):
    rpc = mod(key, "rpc")
    server = rpc.RpcServer(port=0, ioloop=rpc.IoLoop.default(),
                           ssl_manager=ssl_manager)
    server.add_handler(EchoHandler())
    server.start()
    return server


def call(key, pool, port, method="echo", timeout=10, **args):
    rpc = mod(key, "rpc")

    async def go():
        return await pool.call("127.0.0.1", port, method, args,
                               timeout=timeout)

    return rpc.IoLoop.default().run_sync(go(), timeout=timeout + 5)


def close(key, pool):
    mod(key, "rpc").IoLoop.default().run_sync(pool.close())


def refused(key):
    errors = mod(key, "rpc.errors")
    return (errors.RpcError, errors.RpcConnectionError, ssl.SSLError)


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_rpc_over_mutual_tls(tls_certs, client, server):
    server_mgr, _ = managers(server, tls_certs)
    _, client_mgr = managers(client, tls_certs)
    srv = serve(server, server_mgr)
    pool = mod(client, "rpc").RpcClientPool(ssl_manager=client_mgr)
    try:
        out = call(client, pool, srv.port, blob=b"\x00secret")
        assert bytes(out["blob"]) == b"\x00secret!"
    finally:
        close(client, pool)
        srv.stop()


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_tls_refuses_plaintext_and_foreign_ca(tls_certs, client, server,
                                              tmp_path):
    """A plaintext client, and a client whose certificate another CA
    signed, are refused by the mutual-TLS server."""
    server_mgr, _ = managers(server, tls_certs)
    srv = serve(server, server_mgr)
    rogue = mod(client, "utils.ssl_context_manager").make_test_ca(
        str(tmp_path / "rogue"))
    rogue_mgr = mod(client, "utils.ssl_context_manager").SslContextManager(
        rogue["client_cert"], rogue["client_key"],
        ca_path=tls_certs["ca_cert"], server_side=False)
    try:
        for mgr in (None, rogue_mgr):
            pool = mod(client, "rpc").RpcClientPool(ssl_manager=mgr)
            try:
                with pytest.raises(refused(client)):
                    call(client, pool, srv.port, timeout=3)
            finally:
                close(client, pool)
    finally:
        srv.stop()


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_tls_role_binding_rejects_swapped_certs(tls_certs, client, server):
    """A server wearing the client certificate is refused by the client,
    and a client wearing the server certificate by the server."""
    impostor, _ = managers(server, tls_certs, server_cert="client")
    srv = serve(server, impostor)
    _, client_mgr = managers(client, tls_certs)
    pool = mod(client, "rpc").RpcClientPool(ssl_manager=client_mgr)
    try:
        with pytest.raises(refused(client)):
            call(client, pool, srv.port, timeout=3)
    finally:
        close(client, pool)
        srv.stop()
    server_mgr, _ = managers(server, tls_certs)
    srv = serve(server, server_mgr)
    _, swapped = managers(client, tls_certs, client_cert="server")
    pool = mod(client, "rpc").RpcClientPool(ssl_manager=swapped)
    try:
        with pytest.raises(refused(client)):
            call(client, pool, srv.port, timeout=3)
    finally:
        close(client, pool)
        srv.stop()


def test_check_peer_role_reads_eku_from_der(tls_certs):
    """Both packages' check_peer_role parse the EKU from the DER form,
    and agree on every (certificate, role)."""
    from cryptography import x509
    from cryptography.hazmat.primitives.serialization import Encoding

    class StubContext:
        verify_mode = ssl.CERT_REQUIRED

    class StubSslObject:
        context = StubContext()

        def __init__(self, pem_path):
            with open(pem_path, "rb") as f:
                cert = x509.load_pem_x509_certificate(f.read())
            self._der = cert.public_bytes(Encoding.DER)

        def getpeercert(self, binary_form=False):
            assert binary_form, "role check must request the DER form"
            return self._der

    verdicts = {}
    for key in PKGS:
        m = mod(key, "utils.ssl_context_manager")
        for cert in ("server_cert", "client_cert", "ca_cert"):
            for role in ("server", "client"):
                try:
                    m.check_peer_role(StubSslObject(tls_certs[cert]), role)
                    verdicts[(key, cert, role)] = "ok"
                except m.PeerRoleError:
                    verdicts[(key, cert, role)] = "refused"
    for key in PKGS:
        assert verdicts[(key, "server_cert", "server")] == "ok"
        assert verdicts[(key, "client_cert", "client")] == "ok"
        assert verdicts[(key, "client_cert", "server")] == "refused"
        assert verdicts[(key, "server_cert", "client")] == "refused"
        assert verdicts[(key, "ca_cert", "server")] == "ok"
    assert {k[1:]: v for k, v in verdicts.items() if k[0] == "port"} == {
        k[1:]: v for k, v in verdicts.items() if k[0] == "ref"}


def test_tls_refresh_thread_refcounted(tls_certs):
    """The port's shared manager: one refresh thread for two servers,
    kept through one stop and reaped at the last; a never-started
    server's stop and a double stop release nothing."""
    def refresh_threads():
        return sum(1 for t in threading.enumerate()
                   if t.name == "ssl-refresh" and t.is_alive())

    base = refresh_threads()
    mgr, _ = managers("port", tls_certs, refresh_interval=30.0)
    a, b = serve("port", mgr), serve("port", mgr)
    assert refresh_threads() == base + 1
    never_started = mod("port", "rpc").RpcServer(port=0, ssl_manager=mgr)
    never_started.stop()
    a.stop()
    a.stop()
    assert refresh_threads() == base + 1
    b.stop()
    assert refresh_threads() == base


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_tls_refresh_picks_up_rotated_certs(tls_certs, client, server,
                                            tmp_path):
    """The server's certificate rotated under the same CA by the
    server package's reissue_cert and force_refresh()ed: new handshakes
    keep working."""
    live = tmp_path / "live"
    live.mkdir()
    for k in ("server_cert", "server_key", "ca_cert"):
        shutil.copy(tls_certs[k], str(live / k))
    M = mod(server, "utils.ssl_context_manager")
    server_mgr = M.SslContextManager(
        str(live / "server_cert"), str(live / "server_key"),
        ca_path=str(live / "ca_cert"), server_side=True,
        refresh_interval=0.0)
    _, client_mgr = managers(client, tls_certs)
    srv = serve(server, server_mgr)
    try:
        for rotate in (False, True):
            if rotate:
                M.reissue_cert(tls_certs, "server", str(live / "server_cert"),
                               str(live / "server_key"))
                server_mgr.force_refresh()
            pool = mod(client, "rpc").RpcClientPool(ssl_manager=client_mgr)
            try:
                assert call(client, pool, srv.port, text="hi")["text"] == "hi"
            finally:
                close(client, pool)
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# replication and the admin plane under mutual TLS
# ---------------------------------------------------------------------------


def _flags(key):
    return mod(key, "replication").ReplicationFlags(
        server_long_poll_ms=400, pull_error_delay_min_ms=50,
        pull_error_delay_max_ms=120, ack_timeout_ms=2000)


class Node:
    """A Replicator of one package with TLS on both of its sides, and its
    DBs (the port's on the host's compaction backend)."""

    def __init__(self, key, tmp_path, name, certs):
        self.key = key
        self.dir = tmp_path / name
        s, c = managers(key, certs)
        self.replicator = mod(key, "replication").Replicator(
            port=0, flags=_flags(key), server_ssl_manager=s,
            client_ssl_manager=c)
        self.dbs = []

    def add_db(self, name, role, upstream=None):
        storage = mod(self.key, "storage")
        repl = mod(self.key, "replication")
        kw = {}
        if self.key == "port":
            kw["compaction_backend"] = mod(
                "port", "storage.native_compaction").NativeCompactionBackend()
        db = storage.DB(str(self.dir / name), storage.DBOptions(**kw))
        self.dbs.append(db)
        self.replicator.add_db(name, repl.StorageDbWrapper(db),
                               getattr(repl.ReplicaRole, role),
                               upstream_addr=upstream)
        return db

    def stop(self):
        self.replicator.stop()
        for db in self.dbs:
            db.close()


@pytest.mark.parametrize("leader,follower",
                         [("port", "port"), ("ref", "port"),
                          ("port", "ref")],
                         ids=["port-port", "ref_leader-port_follower",
                              "port_leader-ref_follower"])
def test_replication_over_mutual_tls(tls_certs, tmp_path, leader, follower):
    """WAL shipping under mutual TLS, each node verifying its peer's
    CA-signed certificate both ways: the follower holds every write."""
    nodes = []
    try:
        ln = Node(leader, tmp_path, "tls-leader", tls_certs)
        nodes.append(ln)
        fn = Node(follower, tmp_path, "tls-follower", tls_certs)
        nodes.append(fn)
        ldb = ln.add_db("seg00001", "LEADER")
        fdb = fn.add_db("seg00001", "FOLLOWER",
                        ("127.0.0.1", ln.replicator.port))
        WriteBatch = mod(leader, "storage").WriteBatch
        for i in range(25):
            ln.replicator.write("seg00001", WriteBatch().put(
                f"k{i}".encode(), f"v{i}".encode()))
        deadline = time.monotonic() + 60
        while fdb.latest_sequence_number() != ldb.latest_sequence_number():
            assert time.monotonic() < deadline, "the follower never caught up"
            time.sleep(0.02)
        assert [fdb.get(f"k{i}".encode()) for i in range(25)] == [
            f"v{i}".encode() for i in range(25)]
    finally:
        for n in nodes:
            n.stop()


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_admin_plane_over_mutual_tls(tls_certs, tmp_path, client, server):
    """Admin RPCs over a mutual-TLS server: ping, add_db, the sequence
    number after a write, check_db."""
    server_mgr, _ = managers(server, tls_certs)
    _, client_mgr = managers(client, tls_certs)
    replicator = mod(server, "replication").Replicator(
        port=0, flags=_flags(server))
    kw = {"device": "cpu"} if server == "port" else {}
    handler = mod(server, "admin").AdminHandler(
        str(tmp_path / "node"), replicator, **kw)
    rpc = mod(server, "rpc")
    srv = rpc.RpcServer(port=0, ioloop=replicator.ioloop,
                        ssl_manager=server_mgr)
    srv.add_handler(handler)
    srv.start()
    pool = mod(client, "rpc").RpcClientPool(ssl_manager=client_mgr)
    try:
        assert call(client, pool, srv.port, "ping", 30)["ok"] is True
        call(client, pool, srv.port, "add_db", 30, db_name="seg00001",
             role="LEADER")
        handler.db_manager.get_db("seg00001").write(
            mod(server, "storage").WriteBatch().put(b"k", b"v"))
        assert call(client, pool, srv.port, "get_sequence_number", 30,
                    db_name="seg00001")["seq_num"] == 1
        assert call(client, pool, srv.port, "check_db", 30,
                    db_name="seg00001")["seq_num"] == 1
    finally:
        close(client, pool)
        srv.stop()
        handler.close()
        replicator.stop()
