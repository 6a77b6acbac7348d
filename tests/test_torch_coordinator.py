"""The port's coordinator against the JAX package's: one scripted sequence
(create / ensure / get / set with versions, ``multi``, list, delete,
ephemeral nodes dying with a closed session, sequential nodes, locks,
election, ``watch``) gives the same results against a reference server
and a port server, from both packages' clients, and writes the same WAL
records; a durable ``data_dir`` one package wrote — a torn WAL tail
included — reopens in the other with the same tree, versions and
sequential counters; and a standby of either package follows a primary
of the other and is promoted. Tolerance 0.
"""

import importlib
import os
import time

import pytest

PACKAGES = ("rocksplicator_tpu", "rocksplicator_tpu_torch")
PAIRS = [(c, s) for c in PACKAGES for s in PACKAGES]
PAIR_IDS = ["ref-ref", "ref-client-port-server", "port-client-ref-server",
            "port-port"]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def coord(pkg: str):
    return mod(pkg, "cluster.coordinator")


def wait_until(pred, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


@pytest.fixture(autouse=True)
def _fresh_port_singletons():
    from torch_parity import reset_observability

    import rocksplicator_tpu_torch

    reset_observability(rocksplicator_tpu_torch, sample_rate=0.0)
    yield


def _app_error(fn, client_pkg):
    try:
        return ("ok", fn())
    except mod(client_pkg, "rpc.errors").RpcApplicationError as e:
        return ("error", e.code)


def scripted(client_pkg: str, port: int) -> list:
    """The scripted sequence from ``client_pkg``'s clients against the
    server on ``port``; every result, normalized (session ids and values
    as bytes)."""
    C = coord(client_pkg).CoordinatorClient
    c1, c2 = C("127.0.0.1", port), C("127.0.0.1", port)
    out = []
    rec = out.append
    err = lambda fn: _app_error(fn, client_pkg)  # noqa: E731
    try:
        rec(c1.create("/app/a", b"1"))
        rec(c1.get("/app/a"))
        rec(c1.set("/app/a", b"2"))
        rec(err(lambda: c1.set("/app/a", b"x", expected_version=0)))
        rec(c1.set("/app/a", b"3", expected_version=1))
        rec(err(lambda: c1.create("/app/a", b"dup")))
        c1.ensure("/app/a", b"ignored")
        c1.ensure("/app/new", b"made")
        rec(c1.get("/app/new"))
        rec(c1.create("/app/b/c/d", b"deep"))
        rec((c1.list("/app"), c1.list("/app/b")))
        rec(err(lambda: c1.delete("/app/b")))
        rec(err(lambda: c1.get("/app/missing")))
        rec(c1.get_or_none("/app/missing"))
        rec(err(lambda: c1.multi([
            {"op": "create", "path": "/m/a", "value": b"1"},
            {"op": "check", "path": "/app/a", "expected_version": 9}])))
        rec(c1.exists("/m/a"))
        c1.create("/m/dead", b"x")
        res = c1.multi([
            {"op": "check", "path": "/app/a", "expected_version": 2},
            {"op": "create", "path": "/m/a", "value": b"1"},
            {"op": "set", "path": "/app/a", "value": b"4",
             "expected_version": 2},
            {"op": "delete", "path": "/m/dead"}])
        rec([sorted((k, v) for k, v in r.items() if k != "path")
             for r in res])
        rec((c1.get("/app/a"), c1.exists("/m/dead")))
        c1.put("/app/put", b"p1")
        c1.put("/app/put", b"p2")
        rec(c1.get("/app/put"))
        rec([c1.create("/seq/n-", b"s", sequential=True) for _ in range(3)])
        # ephemerals die with a closed session
        c2.create("/eph/x", b"mine", ephemeral=True)
        rec(c1.exists("/eph/x"))
        c2.close()
        rec(wait_until(lambda: not c1.exists("/eph/x"), timeout=10))
        c2 = C("127.0.0.1", port)
        # locks and election
        n1 = c1.acquire_lock("/locks/x", timeout=5)
        rec(n1)
        rec(c2.acquire_lock("/locks/x", timeout=0.3))
        c1.release_lock(n1)
        n2 = c2.acquire_lock("/locks/x", timeout=5)
        rec(n2)
        c2.release_lock(n2)
        rec((c1.elect_leader("/election", "one"),
             c2.elect_leader("/election", "two"),
             c2.current_leader("/election")))
        # watch: each change is observed before the next one is made
        seen = []
        stop = c2.watch("/watched", seen.append, poll_ms=500)
        try:
            steps = [lambda: None, lambda: c1.create("/watched", b"v1"),
                     lambda: c1.set("/watched", b"v2"),
                     lambda: c1.create("/watched/kid", b""),
                     lambda: c1.delete("/watched", recursive=True)]
            for i, step in enumerate(steps):
                step()
                assert wait_until(lambda: len(seen) > i, timeout=10), seen
            rec([(s["exists"], bytes(s["value"]), s["version"],
                  s["children"]) for s in seen])
        finally:
            stop.set()
        c1.delete("/app", recursive=True)
        rec((c1.exists("/app"), c1.list("/")))
    finally:
        for c in (c1, c2):
            try:
                c.close()
            except Exception:
                pass
    return [bytes(r) if isinstance(r, memoryview) else r for r in out]


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=PAIR_IDS)
def test_scripted_sequence_equal_reference(client_pkg, server_pkg, tmp_path):
    """Every mixed client/server pair gives the all-reference results, and
    the server writes the same WAL records."""
    results, wals = {}, {}
    for pair in {("rocksplicator_tpu", "rocksplicator_tpu"),
                 (client_pkg, server_pkg)}:
        data = tmp_path / ("-".join(p[-5:] for p in pair))
        server = coord(pair[1]).CoordinatorServer(
            port=0, session_ttl=5.0, data_dir=str(data))
        try:
            results[pair] = scripted(pair[0], server.port)
        finally:
            server.stop()
        wals[pair] = (data / "coordinator_wal.log").read_bytes()
    ref = ("rocksplicator_tpu", "rocksplicator_tpu")
    got = results[(client_pkg, server_pkg)]
    assert got == results[ref]
    assert wals[(client_pkg, server_pkg)] == wals[ref]
    assert got[0] == "/app/a" and got[3] == ("error", "BAD_VERSION")


def _crash(server) -> None:
    """Stop serving without the clean stop's final snapshot, as a killed
    process would, and end the server's background tasks."""
    server._server.stop()
    for task in (server._reaper_task, server._snapshot_task):
        if task is not None:
            server._ioloop.loop.call_soon_threadsafe(task.cancel)


def _tree(client) -> dict:
    out = {}

    def walk(path):
        for child in client.list(path):
            if not child:
                continue  # the root lists itself as ""
            p = path.rstrip("/") + "/" + child
            out[p] = client.get(p)
            walk(p)

    walk("/")
    return {k: (bytes(v), ver) for k, (v, ver) in out.items()}


@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]],
                         ids=["ref-to-port", "port-to-ref"])
def test_data_dir_carries_across(writer, reader, tmp_path):
    """A tree, its versions and its sequential counters, written by one
    package's durable server (snapshot, then WAL records, then a torn
    tail), reopen in the other's; what the reader acks after the reopen
    survives a WAL-only reopen in the writer again."""
    data_dir = str(tmp_path / "coord")
    s1 = coord(writer).CoordinatorServer(port=0, session_ttl=5.0,
                                         data_dir=data_dir)
    c1 = coord(writer).CoordinatorClient("127.0.0.1", s1.port)
    c1.create("/clusters/prod/resources/seg", b'{"num_shards": 4}')
    c1.set("/clusters/prod/resources/seg", b'{"num_shards": 8}')
    c1.create("/eph", b"gone", ephemeral=True)
    seq1 = c1.create("/clusters/prod/locks/n-", sequential=True)
    s1._write_snapshot()
    c1.put("/after/snapshot", b"wal only")
    c1.set("/after/snapshot", b"wal v1", expected_version=0)
    seq2 = c1.create("/clusters/prod/locks/n-", sequential=True)
    want = _tree(c1)
    c1._stop.set()  # a crash: no clean session close
    s1._wal._f.close()
    with open(os.path.join(data_dir, "coordinator_wal.log"), "ab") as f:
        f.write(b"ffffffff:{\"op\":\"cre")  # torn, bad-crc line
    _crash(s1)
    try:
        c1._call("close_session", session_id=c1.session_id)
    except Exception:
        pass

    s2 = coord(reader).CoordinatorServer(port=0, session_ttl=5.0,
                                         data_dir=data_dir)
    c2 = coord(reader).CoordinatorClient("127.0.0.1", s2.port)
    want.pop("/eph")
    assert _tree(c2) == want
    seq3 = c2.create("/clusters/prod/locks/n-", sequential=True)
    assert seq1 < seq2 < seq3
    c2.put("/b", b"2")
    want = _tree(c2)
    c2.close()
    _crash(s2)  # no clean snapshot: the WAL alone carries /b
    s2._wal.close()

    s3 = coord(writer).CoordinatorServer(port=0, session_ttl=5.0,
                                         data_dir=data_dir)
    c3 = coord(writer).CoordinatorClient("127.0.0.1", s3.port)
    try:
        assert _tree(c3) == want
        assert c3.create("/clusters/prod/locks/n-", sequential=True) > seq3
    finally:
        c3.close()
        s3.stop()


@pytest.mark.parametrize("primary_pkg,standby_pkg",
                         [PACKAGES, PACKAGES[::-1]],
                         ids=["ref-primary-port-standby",
                              "port-primary-ref-standby"])
def test_standby_follows_and_promotes(primary_pkg, standby_pkg, tmp_path):
    primary = coord(primary_pkg).CoordinatorServer(
        port=0, session_ttl=3.0, data_dir=str(tmp_path / "p"))
    standby = coord(standby_pkg).CoordinatorServer(
        port=0, session_ttl=3.0, data_dir=str(tmp_path / "s"),
        replica_of=("127.0.0.1", primary.port))
    cli = coord(standby_pkg).CoordinatorClient(
        "127.0.0.1", primary.port, fallbacks=[("127.0.0.1", standby.port)])
    try:
        cli.create("/a/b", b"v1")
        cli.set("/a/b", b"v2")
        seq = cli.create("/a/seq-", sequential=True)
        cli.create("/locks/me", b"own", ephemeral=True)
        cli.create("/a/sub/deep", b"x")
        cli.delete("/a/sub", recursive=True)

        def caught_up():
            with standby._lock:
                n = dict(standby._nodes)
            return (n.get("/a/b") is not None and n["/a/b"].value == b"v2"
                    and seq in n and "/locks/me" in n
                    and "/a/sub" not in n)

        assert wait_until(caught_up)
        with standby._lock:
            assert standby._nodes["/a/b"].version == 1
            assert standby._nodes["/locks/me"].ephemeral_owner \
                == cli.session_id
        with pytest.raises(mod(standby_pkg, "rpc.errors").RpcApplicationError):
            direct = coord(standby_pkg).CoordinatorClient(
                "127.0.0.1", standby.port)
            try:
                direct.create("/refused", b"")
            finally:
                direct.close()
        primary.stop()
        standby.promote()
        assert not standby.is_standby
        assert cli.get("/a/b") == (b"v2", 1)
        cli.set("/a/b", b"after")
        assert cli.get("/locks/me")[0] == b"own"
        assert cli.create("/a/seq-", sequential=True) > seq
    finally:
        cli.close()
        for srv in (primary, standby):
            try:
                srv.stop()
            except Exception:
                pass


def test_port_coordinator_process_kill9_loses_no_acked_write(tmp_path):
    """``python -m rocksplicator_tpu_torch.cluster.coordinator`` serves a
    durable tree; killed with SIGKILL mid-stream and restarted on the same
    data_dir, every acknowledged write is there, read by a reference
    client."""
    import re
    import signal
    import subprocess
    import sys

    data_dir = str(tmp_path / "coord_data")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)

    def spawn():
        proc = subprocess.Popen(
            [sys.executable, "-m", "rocksplicator_tpu_torch.cluster."
             "coordinator", "--port", "0", "--data_dir", data_dir],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env)
        m = re.search(r"port=(\d+)", proc.stdout.readline())
        assert m, "no port in the coordinator's banner"
        return proc, int(m.group(1))

    proc, port = spawn()
    try:
        c = coord(PACKAGES[1]).CoordinatorClient("127.0.0.1", port)
        for i in range(50):
            c.put(f"/state/partition{i:03d}", f"seq={i}".encode())
        c.close()
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    proc2, port2 = spawn()
    try:
        c2 = coord(PACKAGES[0]).CoordinatorClient("127.0.0.1", port2)
        for i in range(50):
            assert c2.get(f"/state/partition{i:03d}")[0] \
                == f"seq={i}".encode()
        c2.close()
    finally:
        proc2.terminate()
        proc2.wait(timeout=30)
