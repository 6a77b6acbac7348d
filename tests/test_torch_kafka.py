"""The port's queue-ingestion stack (``kafka/`` broker, watcher, network
broker, publisher, ingestion) against the JAX package's: the reference's
scenarios (``tests/test_kafka.py``, all but its ``admin_cli`` and
``rpcgrep`` cases, which wait for the port's CLI) on each package, and the
networked broker's ``broker://`` RPC protocol for each pairing of broker
and client packages — a port ``NetworkConsumer`` against a reference
``BrokerServer`` and the reverse, a port broker restarting from a
reference broker's data directory, and ingestion into a port node from a
reference broker. The port's broker and consumer app run as processes.
The two packages keep separate ``embedded://`` registries."""

import importlib
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from torch_parity import (PACKAGES, AdminClient, AdminNode, ReplPackage,
                          reset_both, wait_until)

REPO = Path(__file__).resolve().parents[1]
PKGS = [ReplPackage("ref"), ReplPackage("port")]
PAIRS = [("port", "port"), ("ref", "port"), ("port", "ref")]


def kafka(pkg, name):
    key = pkg if isinstance(pkg, str) else pkg.key
    return importlib.import_module(f"{PACKAGES[key]}.kafka.{name}")


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield
    reset_both()


@pytest.fixture(params=PKGS, ids=repr)
def pkg(request):
    return request.param


@pytest.fixture(params=PAIRS, ids=lambda p: f"broker-{p[0]}-client-{p[1]}")
def pair(request):
    return request.param


# -- broker + consumer -------------------------------------------------------

def test_produce_consume_roundtrip(pkg):
    b = kafka(pkg, "broker")
    cluster = b.MockKafkaCluster()
    cluster.create_topic("t", 2)
    cluster.produce("t", 0, b"k1", b"v1", timestamp_ms=100)
    cluster.produce("t", 1, b"k2", b"v2", timestamp_ms=200)
    cluster.produce("t", 0, b"k3", b"v3", timestamp_ms=300)
    c = b.MockConsumer(cluster)
    c.assign("t", [0, 1])
    got = [c.consume(0.5) for _ in range(3)]
    assert sorted((m.key, m.value) for m in got) == [
        (b"k1", b"v1"), (b"k2", b"v2"), (b"k3", b"v3")]
    assert c.consume(0.05) is None


def test_timestamp_seek(pkg):
    b = kafka(pkg, "broker")
    cluster = b.MockKafkaCluster()
    cluster.create_topic("t", 1)
    for i in range(10):
        cluster.produce("t", 0, f"k{i}".encode(), b"v", timestamp_ms=i * 100)
    c = b.MockConsumer(cluster)
    c.assign("t", [0])
    c.seek_to_timestamp(450)
    assert c.consume(0.5).key == b"k5"


def test_consumer_commit_and_blocking_fetch(pkg):
    b = kafka(pkg, "broker")
    cluster = b.MockKafkaCluster()
    cluster.create_topic("t", 1)
    c = b.MockConsumer(cluster)
    c.assign("t", [0])
    results = []
    t = threading.Thread(target=lambda: results.append(c.consume(5.0)))
    t.start()
    time.sleep(0.1)
    cluster.produce("t", 0, b"late", b"v")
    t.join(timeout=5)
    assert not t.is_alive()
    assert results and results[0].key == b"late"
    c.commit()
    assert c.committed == {0: 1}


def test_consumer_pool(pkg):
    b, w = kafka(pkg, "broker"), kafka(pkg, "watcher")
    cluster = b.MockKafkaCluster()
    pool = w.KafkaConsumerPool(2, lambda: b.MockConsumer(cluster))
    first = pool.acquire()
    pool.acquire()
    with pytest.raises(Exception):
        pool.acquire(timeout=0.05)
    pool.release(first)
    assert pool.acquire(timeout=1) is first


def test_watcher_replay_then_live(pkg):
    b, w = kafka(pkg, "broker"), kafka(pkg, "watcher")
    cluster = b.MockKafkaCluster()
    cluster.create_topic("t", 1)
    for i in range(5):
        cluster.produce("t", 0, f"old{i}".encode(), b"v",
                        timestamp_ms=1000 + i)
    seen = []
    watcher = w.KafkaWatcher(
        "w", b.MockConsumer(cluster), "t", [0], start_timestamp_ms=1002,
        on_message=lambda m, replay: seen.append((m.key, replay))).start()
    try:
        assert wait_until(watcher.replay_done.is_set, timeout=10)
        assert seen == [(b"old2", True), (b"old3", True), (b"old4", True)]
        cluster.produce("t", 0, b"live1", b"v")
        assert wait_until(lambda: (b"live1", False) in seen, timeout=10)
    finally:
        watcher.stop()


def test_broker_file_watcher(pkg, tmp_path):
    fw = pkg.mod("utils.file_watcher").FileWatcher
    fw.reset_for_test()
    try:
        path = tmp_path / "brokers"
        path.write_text("# comment\n10.0.0.1:9092\n10.0.0.2:9092\n")
        w = kafka(pkg, "watcher").KafkaBrokerFileWatcher(str(path))
        assert w.broker_list == ["10.0.0.1:9092", "10.0.0.2:9092"]
        path.write_text("10.0.0.3:9092\n")
        fw.instance().poll_now()
        assert w.broker_list == ["10.0.0.3:9092"]
        w.close()
    finally:
        fw.reset_for_test()


# -- end-to-end message ingestion via the admin RPC -------------------------

def test_message_ingestion_end_to_end(pkg, tmp_path):
    """The F9 path: start_message_ingestion on the port's AdminHandler
    starts a watcher that replays, tails, deletes on an empty value,
    refuses a duplicate start and persists the last timestamp on stop."""
    cluster = kafka(pkg, "broker").get_cluster("default")
    cluster.create_topic("events", 2)
    for i in range(10):
        cluster.produce("events", 1, f"k{i}".encode(), f"v{i}".encode(),
                        timestamp_ms=1000 + i)
    node = AdminNode(pkg, tmp_path, "a")
    call = AdminClient(pkg)
    try:
        call(node, "add_db", db_name="ev00001", role="LEADER")
        call(node, "start_message_ingestion", db_name="ev00001",
             topic_name="events",
             kafka_broker_serverset_path="embedded://default")
        app_db = node.app_db("ev00001")
        assert wait_until(lambda: app_db.get(b"k9") == b"v9", timeout=10)
        cluster.produce("events", 1, b"knew", b"x", timestamp_ms=5000)
        cluster.produce("events", 1, b"k0", b"", timestamp_ms=6000)
        assert wait_until(lambda: app_db.get(b"knew") == b"x", timeout=10)
        assert wait_until(lambda: app_db.get(b"k0") is None, timeout=10)
        with pytest.raises(pkg.RpcApplicationError):
            call(node, "start_message_ingestion", db_name="ev00001",
                 topic_name="events",
                 kafka_broker_serverset_path="embedded://default")
        call(node, "stop_message_ingestion", db_name="ev00001")
        meta = node.handler.get_meta_data("ev00001")
        assert meta.last_kafka_msg_timestamp_ms == 6000
    finally:
        call.close()
        node.stop()


# -- the networked broker, each pairing of packages ---------------------------

def test_network_broker_roundtrip(pair):
    broker_pkg, client_pkg = pair
    net = kafka(client_pkg, "network")
    srv = kafka(broker_pkg, "network").BrokerServer(port=0).start()
    try:
        prod = net.NetworkProducer("127.0.0.1", srv.port)
        prod.create_topic("t", 2)
        for i in range(20):
            prod.produce("t", i % 2, f"k{i}".encode(), f"v{i}".encode(),
                         timestamp_ms=1000 + i)
        cons = net.NetworkConsumer("127.0.0.1", srv.port, group_id="g1")
        cons.assign("t", [0, 1])
        got = {}
        for _ in range(20):
            m = cons.consume(5.0)
            assert m is not None
            got[m.key] = m.value
        assert got[b"k7"] == b"v7" and len(got) == 20
        assert cons.consume(0.1) is None
        assert cons.high_watermark(0) == 10
        cons.seek_to_timestamp(1018)
        replay = [cons.consume(5.0) for _ in range(2)]
        assert sorted(m.key for m in replay) == [b"k18", b"k19"]
        cons.commit()
        assert cons.committed == {0: 10, 1: 10}
        cons.close()
        prod.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("first,second", [("port", "port"), ("ref", "port")])
def test_network_broker_durable_restart(tmp_path, first, second):
    """A broker restarts on the same data directory with its log and
    committed offsets: the port's after the port's, and the port's after
    the reference's (the two write the same log files)."""
    data = str(tmp_path / "broker")
    net1 = kafka(first, "network")
    srv = net1.BrokerServer(port=0, data_dir=data).start()
    prod = net1.NetworkProducer("127.0.0.1", srv.port)
    prod.create_topic("t", 1)
    for i in range(5):
        prod.produce("t", 0, f"k{i}".encode(), f"v{i}".encode(),
                     timestamp_ms=100 + i)
    cons = net1.NetworkConsumer("127.0.0.1", srv.port, group_id="g")
    cons.assign("t", [0])
    for _ in range(5):
        assert cons.consume(5.0) is not None
    cons.commit()
    cons.close()
    prod.close()
    srv.stop()
    net2 = kafka(second, "network")
    srv2 = net2.BrokerServer(port=0, data_dir=data).start()
    try:
        cons2 = net2.NetworkConsumer("127.0.0.1", srv2.port, group_id="g")
        cons2.assign("t", [0])
        assert cons2.committed == {0: 5}
        assert cons2.high_watermark(0) == 5
        cons2.seek_to_timestamp(103)
        m = cons2.consume(5.0)
        assert m is not None and m.key == b"k3"
        prod2 = net2.NetworkProducer("127.0.0.1", srv2.port)
        assert prod2.produce("t", 0, b"knew", b"x") == 5
        cons2.close()
        prod2.close()
    finally:
        srv2.stop()


def test_consumer_app_tails_broker_across_processes(tmp_path):
    """The port's broker and consumer app as processes: the app tails the
    broker, and resumes from a timestamp across a broker restart."""
    net = kafka("port", "network")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    data = str(tmp_path / "bk")
    app = ["-m", "rocksplicator_tpu_torch.examples.kafka_consumer_app."
           "kafka_consumer_app"]

    def spawn_broker():
        proc = subprocess.Popen(
            [sys.executable, "-m", "rocksplicator_tpu_torch.kafka.network",
             "--port", "0", "--data_dir", data], cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env)
        line = proc.stdout.readline()
        m = re.search(r"port=(\d+)", line)
        assert m, f"no port in broker banner: {line!r}"
        return proc, int(m.group(1))

    broker, port = spawn_broker()
    try:
        prod = net.NetworkProducer("127.0.0.1", port)
        prod.create_topic("t", 1)
        for i in range(6):
            prod.produce("t", 0, f"k{i}".encode(), f"v{i}".encode(),
                         timestamp_ms=1000 + i)
        prod.close()
        out = subprocess.run(
            [sys.executable, *app, "--broker", f"127.0.0.1:{port}",
             "--topic", "t", "--replay_timestamp_ms", "1000",
             "--max_messages", "6"], cwd=str(REPO),
            capture_output=True, text=True, timeout=120, env=env)
        assert out.returncode == 0, out.stderr
        assert out.stdout.count("[replay]") + out.stdout.count("[live]") >= 6
        assert "k5" in out.stdout
        broker.terminate()
        broker.wait(timeout=10)
        broker, port = spawn_broker()
        out2 = subprocess.run(
            [sys.executable, *app, "--broker", f"127.0.0.1:{port}",
             "--topic", "t", "--replay_timestamp_ms", "1004",
             "--max_messages", "2"], cwd=str(REPO),
            capture_output=True, text=True, timeout=120, env=env)
        assert out2.returncode == 0, out2.stderr
        assert "k4" in out2.stdout and "k5" in out2.stdout
        assert "k3" not in out2.stdout
    finally:
        broker.terminate()
        broker.wait(timeout=10)


@pytest.mark.parametrize("broker_pkg,node_key", [
    ("port", "port"), ("ref", "port"), ("port", "ref")])
def test_ingestion_via_network_broker(tmp_path, broker_pkg, node_key):
    """start_message_ingestion with ``broker://host:port`` applies the
    messages of a networked broker of either package into a node of
    either package."""
    pkg = PKGS[0] if node_key == "ref" else PKGS[1]
    net = kafka(broker_pkg, "network")
    srv = net.BrokerServer(port=0).start()
    prod = net.NetworkProducer("127.0.0.1", srv.port)
    prod.create_topic("events", 2)
    for i in range(5):
        prod.produce("events", 1, f"k{i}".encode(), f"v{i}".encode(),
                     timestamp_ms=1000 + i)
    node = AdminNode(pkg, tmp_path, "a")
    call = AdminClient(pkg)
    try:
        call(node, "add_db", db_name="ev00001", role="LEADER")
        call(node, "start_message_ingestion", db_name="ev00001",
             topic_name="events",
             kafka_broker_serverset_path=f"broker://127.0.0.1:{srv.port}")
        app_db = node.app_db("ev00001")
        assert wait_until(lambda: app_db.get(b"k4") == b"v4", timeout=10)
        prod.produce("events", 1, b"klive", b"y", timestamp_ms=2000)
        assert wait_until(lambda: app_db.get(b"klive") == b"y", timeout=10)
        call(node, "stop_message_ingestion", db_name="ev00001")
    finally:
        call.close()
        node.stop()
        prod.close()
        srv.stop()


# -- CDC → queue publisher ----------------------------------------------------

def test_cdc_publishes_to_queue(pkg, tmp_path):
    cluster = kafka(pkg, "broker").get_cluster("cdcq")
    node = AdminNode(pkg, tmp_path, "a")
    cdc_node = AdminNode(pkg, tmp_path, "cdc")
    publisher = kafka(pkg, "publisher").QueuePublisher(
        "cdc-updates", cluster, num_partitions=4)
    cdc = pkg.mod("admin.cdc").CdcAdminHandler(cdc_node.replicator,
                                                publisher)
    try:
        ioloop = cdc_node.replicator.ioloop
        ioloop.run_coro(node.handler.handle_add_db(
            db_name="seg00002", role="LEADER")).result(10)
        ioloop.run_coro(cdc.handle_add_observer(
            db_name="seg00002", upstream_ip="127.0.0.1",
            upstream_port=node.replicator.port)).result(10)
        node.app_db("seg00002").write(
            pkg.WriteBatch().put(b"cdc-key", b"cdc-val"))
        consumer = kafka(pkg, "broker").MockConsumer(cluster)
        consumer.assign("cdc-updates", [2])
        msgs = []
        assert wait_until(lambda: msgs.append(consumer.consume(0.1))
                          or msgs[-1] is not None, timeout=15)
        msg = msgs[-1]
        assert msg.key == b"seg00002:1"
        ops = list(pkg.mod("storage.records").decode_batch(msg.value).ops())
        assert (pkg.OpType.PUT, b"cdc-key", b"cdc-val") in ops
    finally:
        cdc.close()
        cdc_node.stop()
        node.stop()
