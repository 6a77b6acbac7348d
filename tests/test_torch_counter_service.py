"""The port's counter service (``rocksplicator_tpu_torch/examples/
counter_service/``) against the JAX package's (``examples/
counter_service/``): the reference's seven counter-service scenarios on
port nodes (``device="cpu"``: the card's compaction backend, its plain
versions); a two-node cluster of one port and one reference node, both
ways, whose routed bumps, sets and gets (forwarding included) end in the
reads and DB files of an all-reference run; ``shard_for`` and the counter
options equal; a reference node's directory served by a port node and
back; the port's ``main`` as its own process (the up line, the status
endpoints, exit 0 on SIGTERM); and the port's ``stress_test`` against a
reference node. Tolerance 0.
"""

import hashlib
import importlib
import json
import os
import random
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKGS = {"ref": "rocksplicator_tpu", "port": "rocksplicator_tpu_torch"}
APPS = {"ref": "examples.counter_service",
        "port": "rocksplicator_tpu_torch.examples.counter_service"}


def mod(key: str, name: str):
    return importlib.import_module(f"{PKGS[key]}.{name}")


def app(key: str, name: str):
    return importlib.import_module(f"{APPS[key]}.{name}")


@pytest.fixture(autouse=True)
def _fresh_singletons():
    from torch_parity import reset_observability

    import rocksplicator_tpu
    import rocksplicator_tpu_torch

    reset_observability(rocksplicator_tpu, rocksplicator_tpu_torch,
                        sample_rate=0.0)
    for key in PKGS:
        mod(key, "rpc.admission").TenantAdmission.reset_for_test()
    yield


def _flags(key):
    return mod(key, "replication").ReplicationFlags(
        server_long_poll_ms=400, pull_error_delay_min_ms=50,
        pull_error_delay_max_ms=120)


class CounterNode:
    """One counter-service node of a package in this process: its
    Replicator, router, CounterHandler (a port node on the CPU) and RPC
    server (the reference test's harness)."""

    def __init__(self, key, root, name):
        self.key = key
        rpc = mod(key, "rpc")
        self.replicator = mod(key, "replication").Replicator(
            port=0, flags=_flags(key))
        self.router = rpc.RpcRouter(local_az="az1")
        kw = {"device": "cpu"} if key == "port" else {}
        self.handler = app(key, "counter_service").CounterHandler(
            str(Path(root) / name), self.replicator,
            options_generator=app(key, "options").counter_options_generator,
            router=self.router, **kw)
        self.server = rpc.RpcServer(port=0, ioloop=self.replicator.ioloop)
        self.server.add_handler(self.handler)
        self.server.start()
        self.dir = Path(root) / name

    @property
    def port(self):
        return self.server.port

    def host_key(self):
        return f"127.0.0.1:{self.port}:az1:{self.replicator.port}"

    def load_shard_map(self, shard_map):
        rpc = mod(self.key, "rpc")
        self.router.update_layout(rpc.ClusterLayout.parse(
            json.dumps(shard_map).encode()))

    def create_dbs(self):
        return app(self.key, "counter_service").create_dbs_from_shard_map(
            self.handler, self.router, ("127.0.0.1", self.port))

    def stop(self):
        self.server.stop()
        self.handler.close()
        self.replicator.stop()


def two_nodes(root, key_a, key_b):
    """A leads shard 0 and follows 1, B the reverse."""
    a, b = CounterNode(key_a, root, "a"), CounterNode(key_b, root, "b")
    shard_map = {"counter": {"num_shards": 2,
                             a.host_key(): ["00000:M", "00001:S"],
                             b.host_key(): ["00000:S", "00001:M"]}}
    for n in (a, b):
        n.load_shard_map(shard_map)
    assert a.create_dbs() == 2 and b.create_dbs() == 2
    return a, b


class Caller:
    """Calls from one package's client pool."""

    def __init__(self, key="port"):
        rpc = mod(key, "rpc")
        self.ioloop, self.pool = rpc.IoLoop.default(), rpc.RpcClientPool()
        self.errors = mod(key, "rpc.errors")

    def __call__(self, port, method, **args):
        async def go():
            return await self.pool.call("127.0.0.1", port, method, args,
                                        timeout=30)
        return self.ioloop.run_sync(go())

    def close(self):
        self.ioloop.run_sync(self.pool.close())


@pytest.fixture()
def call():
    c = Caller()
    yield c
    c.close()


@pytest.fixture()
def cluster(tmp_path):
    a, b = two_nodes(tmp_path, "port", "port")
    yield a, b
    a.stop()
    b.stop()


def wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _owner(a, b, name):
    shard = a.handler.router.shard_for(name)
    return (a, b) if shard == 0 else (b, a)


# ---------------------------------------------------------------------------
# the reference's seven scenarios, on port nodes
# ---------------------------------------------------------------------------


def test_set_get_bump_on_leader(cluster, call):
    leader, _ = _owner(*cluster, "visits")
    call(leader.port, "set_counter", counter_name="visits", counter_value=42)
    assert call(leader.port, "get_counter",
                counter_name="visits")["counter_value"] == 42
    for _ in range(8):
        call(leader.port, "bump_counter", counter_name="visits", delta=10)
    assert call(leader.port, "get_counter",
                counter_name="visits")["counter_value"] == 122


def test_replication_to_follower_and_read_from_follower(cluster, call):
    leader, follower = _owner(*cluster, "hits")
    call(leader.port, "bump_counter", counter_name="hits", delta=7)
    assert wait_until(lambda: call(follower.port, "get_counter",
                                   counter_name="hits")["counter_value"] == 7)


def test_need_routing_forwards_writes_to_leader(cluster, call):
    leader, follower = _owner(*cluster, "routed")
    call(follower.port, "bump_counter", counter_name="routed", delta=5,
         need_routing=True)
    assert call(leader.port, "get_counter",
                counter_name="routed")["counter_value"] == 5
    with pytest.raises(call.errors.RpcApplicationError) as ei:
        call(follower.port, "bump_counter", counter_name="routed", delta=5)
    assert ei.value.code == "NOT_LEADER"


def test_counter_admin_rpcs_available(cluster, call):
    a, _ = cluster
    assert call(a.port, "ping")["ok"] is True
    assert "seq_num" in call(a.port, "get_sequence_number",
                             db_name="counter00000")
    db = a.handler.db_manager.get_db("counter00000").db
    assert type(db._backend).__name__ == "GpuCompactionBackend"
    assert str(db._backend.device) == "cpu"


def test_baseline_config1_one_shard_counters(tmp_path, call):
    """BASELINE config 1's shape, 1 shard and 1 replica, at a small
    scale: 500 bumps over 50 counters sum to 500."""
    node = CounterNode("port", tmp_path, "solo")
    try:
        node.load_shard_map({"counter": {"num_shards": 1,
                                         node.host_key(): ["00000:M"]}})
        assert node.create_dbs() == 1
        for i in range(500):
            call(node.port, "bump_counter", counter_name=f"c{i % 50}",
                 delta=1)
        assert sum(call(node.port, "get_counter", counter_name=f"c{j}")
                   ["counter_value"] for j in range(50)) == 500
    finally:
        node.stop()


def test_stress_tool_runs(cluster):
    a, _ = cluster
    assert app("port", "stress_test").main([
        "--host", "127.0.0.1", "--port", str(a.port), "--threads", "2",
        "--requests", "50", "--counters", "10"]) == 0


def test_hot_key_detection_on_access_path(cluster, call):
    leader, _ = _owner(*cluster, "viral")
    for i in range(200):
        call(leader.port, "bump_counter", counter_name="viral", delta=1)
        call(leader.port, "get_counter", counter_name=f"cold{i}",
             need_routing=True)
    top = leader.handler.hot_keys.top(3)
    assert top and top[0][0] == "viral"
    assert leader.handler.hot_keys.is_above("viral", 0.3)
    text = leader.handler.hot_keys_text()
    assert "viral" in text.splitlines()[0] and "share=" in text


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def test_shard_for_and_options_equal_reference():
    """Every seeded name goes to the same shard and DB in both packages,
    for 1 to 64 shards; the counter options are the reference's."""
    rng = random.Random(10)
    names = ([f"counter-{i}" for i in range(2000)]
             + ["".join(rng.choice("abcxyz-_ünï☃0123456789")
                        for _ in range(rng.randint(0, 24)))
                for _ in range(2000)])
    ref, port = app("ref", "counter_router"), app("port", "counter_router")
    for shards in (1, 2, 3, 8, 64):
        assert [port.shard_for(n, shards) for n in names] == [
            ref.shard_for(n, shards) for n in names]
        assert [port.db_name_for(n, shards) for n in names[:300]] == [
            ref.db_name_for(n, shards) for n in names[:300]]
    assert port.SEGMENT == ref.SEGMENT
    want = app("ref", "options").counter_options_generator("counter")
    got = app("port", "options").counter_options_generator("counter")
    for field in ("wal_ttl_seconds", "bits_per_key", "background_compaction",
                  "memtable_bytes", "level0_compaction_trigger",
                  "block_bytes", "compression", "target_file_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert type(got.merge_operator).__name__ \
        == type(want.merge_operator).__name__ == "UInt64AddOperator"


def _script(seed=5, n=240):
    """Seeded counter traffic: (node index, method, args) with routing on:
    writes sent to either node, reads to the node that leads the
    counter's shard (a follower's own replica may lag, so a read there
    depends on timing)."""
    shard_for = app("ref", "counter_router").shard_for
    rng = random.Random(seed)
    out = []
    for i in range(n):
        name = f"counter-{rng.randrange(40)}"
        node = rng.randrange(2)
        r = rng.random()
        if r < 0.6:
            out.append((node, "bump_counter", {
                "counter_name": name, "delta": rng.randrange(-5, 50),
                "need_routing": True}))
        elif r < 0.7:
            out.append((node, "set_counter", {
                "counter_name": name, "counter_value": rng.randrange(1000),
                "need_routing": True}))
        else:
            out.append((shard_for(name, 2), "get_counter", {
                "counter_name": name, "need_routing": True}))
    return out


def _run_cluster(root, key_a, key_b):
    """The scripted traffic through a two-node cluster; then, once the
    followers caught up, compact_db on every replica: the replies, every
    counter read from every replica, the seqs and each replica's
    ``.tsst`` sha256s (sorted)."""
    a, b = two_nodes(root, key_a, key_b)
    call = Caller()
    try:
        nodes = (a, b)
        replies = [call(nodes[i].port, m, **args) for i, m, args in _script()]

        def seqs():
            return [[call(n.port, "get_sequence_number",
                          db_name=f"counter0000{s}")["seq_num"]
                     for n in nodes] for s in range(2)]

        assert wait_until(lambda: all(x == y for x, y in seqs()))
        for n in nodes:
            for s in range(2):
                call(n.port, "compact_db", db_name=f"counter0000{s}")
        reads = {(i, c): call(n.port, "get_counter",
                              counter_name=f"counter-{c}")["counter_value"]
                 for i, n in enumerate(nodes) for c in range(40)}
        files = {}
        for i, n in enumerate(nodes):
            for s in range(2):
                d = n.dir / f"counter0000{s}"
                files[(i, s)] = sorted(
                    hashlib.sha256((d / f).read_bytes()).hexdigest()
                    for f in os.listdir(d) if f.endswith(".tsst"))
        return replies, reads, seqs(), files
    finally:
        call.close()
        a.stop()
        b.stop()


@pytest.mark.parametrize("key_a,key_b", [("port", "ref"), ("ref", "port")],
                         ids=["port_A-ref_B", "ref_A-port_B"])
def test_mixed_cluster_equals_reference(tmp_path, key_a, key_b):
    """One port node and one reference node from one shard map: routed
    bumps, sets and gets (forwarded across the packages) give the same
    replies, reads from every replica, seqs and DB files as the same
    traffic through two reference nodes."""
    want = _run_cluster(tmp_path / "ref", "ref", "ref")
    got = _run_cluster(tmp_path / "mixed", key_a, key_b)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert all(got[3].values())


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")],
                         ids=["ref_dir-port_node", "port_dir-ref_node"])
def test_node_directory_carries_across(tmp_path, writer, reader, call):
    """A single-shard node of one package takes bumps and stops; a node of
    the other package opened on its rocksdb_dir serves the same
    counters and takes more bumps."""
    def node(key):
        n = CounterNode(key, tmp_path, "node")
        n.load_shard_map({"counter": {"num_shards": 1,
                                      n.host_key(): ["00000:M"]}})
        assert n.create_dbs() == 1
        return n

    n = node(writer)
    try:
        for i in range(60):
            call(n.port, "bump_counter", counter_name=f"c{i % 12}",
                 delta=i)
        call(n.port, "compact_db", db_name="counter00000")
        call(n.port, "bump_counter", counter_name="c0", delta=1000)
        want = [call(n.port, "get_counter", counter_name=f"c{j}")
                ["counter_value"] for j in range(12)]
    finally:
        n.stop()
    n = node(reader)
    try:
        assert [call(n.port, "get_counter", counter_name=f"c{j}")
                ["counter_value"] for j in range(12)] == want
        call(n.port, "bump_counter", counter_name="c1", delta=3)
        assert call(n.port, "get_counter",
                    counter_name="c1")["counter_value"] == want[1] + 3
    finally:
        n.stop()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_as_a_process(tmp_path, call):
    """``python -m rocksplicator_tpu_torch.examples.counter_service.
    counter_service --device cpu`` with a one-shard map: the up line, a
    bump and a get, /stats.txt, /hotkeys.txt and /storage_info.txt, and
    exit 0 on SIGTERM."""
    port, status = _free_port(), _free_port()
    shard_map = tmp_path / "shard_map.json"
    shard_map.write_text(json.dumps({"counter": {
        "num_shards": 1, f"127.0.0.1:{port}:az1:{_free_port()}": [
            "00000:M"]}}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), RSTPU_LOCAL_IP="127.0.0.1")
    log = tmp_path / "node.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", APPS["port"] + ".counter_service",
             "--rocksdb_dir", str(tmp_path / "node"), "--port", str(port),
             "--status_port", str(status), "--shard_map_path",
             str(shard_map), "--device", "cpu"],
            cwd=str(REPO), env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        assert wait_until(lambda: "counter_service up:" in log.read_text()
                          or proc.poll() is not None, 120), log.read_text()
        up = [ln for ln in log.read_text().splitlines()
              if ln.startswith("counter_service up:")]
        assert up and up[0].endswith(f"status={status} dbs=1"), \
            log.read_text()
        call(port, "bump_counter", counter_name="web", delta=3)
        assert call(port, "get_counter",
                    counter_name="web")["counter_value"] == 3

        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{status}{path}", timeout=10) as r:
                return r.read().decode()

        stats = get("/stats.txt")
        assert "counter rpc.bump_counter.success total=1" in stats, stats
        assert "counter rpc.get_counter.success total=1" in stats, stats
        assert get("/hotkeys.txt").startswith("web count=")
        assert "counter00000" in get("/storage_info.txt")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_port_stress_test_against_reference_node(tmp_path, capsys):
    """The port's stress_test against a reference two-node cluster: rc 0
    and the reference tool's output line."""
    a, b = two_nodes(tmp_path, "ref", "ref")
    try:
        args = ["--host", "127.0.0.1", "--port", str(a.port), "--threads",
                "2", "--requests", "40", "--counters", "10"]
        assert app("port", "stress_test").main(args) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert app("ref", "stress_test").main(args) == 0
        ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    finally:
        a.stop()
        b.stop()
    pattern = r"stress: 80 requests in \d+\.\d\ds = \d+ qps, errors=0"
    assert re.fullmatch(pattern, line), line
    assert re.fullmatch(pattern, ref_line), ref_line


def test_bulk_load_on_every_replica_then_writes_replicate(tmp_path, call):
    """The load tool's order: add_s3_sst_files_to_db on every replica of
    both shards while the followers' pull loops already run, then routed
    bumps. Each follower's sequence number catches up with its leader's
    and every counter reads load + bumps from both replicas. (An ingest
    takes a seqno outside the WAL; a puller whose cached cursor predates
    its own replica's ingest asks the leader for that seqno, gets a WAL
    gap, and re-reads its position from storage.)"""
    import struct

    a, b = two_nodes(tmp_path, "port", "port")
    try:
        time.sleep(1.0)  # the followers' pull loops connect and park
        SSTWriter = mod("port", "storage.sst").SSTWriter
        OpType = mod("port", "storage.records").OpType
        shard_for = app("port", "counter_router").shard_for
        store = tmp_path / "store"
        names = [f"counter-{i}" for i in range(200)]
        for s in range(2):
            d = store / "counter" / f"{s:05d}"
            d.mkdir(parents=True)
            w = SSTWriter(str(d / "part-0.tsst"), bits_per_key=10)
            for n in sorted(n for n in names if shard_for(n, 2) == s):
                w.add(n.encode(), 0, OpType.PUT, struct.pack("<q", 100))
            w.finish()
        for s in range(2):
            for n in (a, b):
                assert call(n.port, "add_s3_sst_files_to_db",
                            db_name=f"counter0000{s}",
                            s3_bucket=str(store),
                            s3_path=f"counter/{s:05d}/",
                            compact_db_after_load=True) == {
                    "ingested_files": 1}
        for i, n in enumerate(names[:60]):
            call((a, b)[i % 2].port, "bump_counter", counter_name=n,
                 delta=i, need_routing=True)

        def seqs(s):
            return [call(n.port, "get_sequence_number",
                         db_name=f"counter0000{s}")["seq_num"]
                    for n in (a, b)]

        assert wait_until(lambda: all(len(set(seqs(s))) == 1
                                      for s in range(2))), \
            [seqs(s) for s in range(2)]
        for n in (a, b):
            assert [call(n.port, "get_counter", counter_name=c)
                    ["counter_value"] for c in names] == [
                100 + (i if i < 60 else 0) for i in range(200)]
    finally:
        a.stop()
        b.stop()
