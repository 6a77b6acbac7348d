"""The port imports neither JAX nor the JAX package, and its entry points
do not quietly run on the CPU when CUDA is missing; its engine seam
(``gpu/``, ``storage/``) compacts into a file, its batched service
compacts shards, its post-ingest BatchCompactor compacts stub DBs past
an armed failpoint, and its storage engine opens, writes, flushes,
compacts and reopens a DB with the host and the card's backends, and its
remote compaction tier (a coordinator, a worker on the card's backend, a
leader) offloads one compaction, and a replicated shard (a leader and a
follower behind admin handlers) adds a DB, replicates, compacts and reads
back, and a two-node counter service serves a routed bump and a get, on
the CPU with both blocked, counting into the port's own Stats; the
counter service's main refuses to start without CUDA before it opens a
DB.

The import check runs in a subprocess, because this test process has
imported JAX already (tests/conftest.py)."""

import os
import re
import subprocess
import sys
from pathlib import Path

from tools.rstpu_check import run_checks

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "rocksplicator_tpu_torch"

_CHILD = r'''
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "rocksplicator_tpu", "examples"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.cuda.is_available = lambda: False  # a host without CUDA

import rocksplicator_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "rocksplicator_tpu",
                                    "examples"))
assert not bad, bad
seam = {"gpu", "gpu.backend", "gpu.chunked", "gpu.format",
        "gpu.compaction_service", "storage.errors", "storage.merge",
        "storage.compaction", "storage.bloom", "storage.rlz",
        "storage.planar", "storage.sst", "storage.native_compaction",
        "storage.stream_merge", "storage.compaction_scheduler",
        "utils.flags", "utils.stats", "observability",
        "observability.context", "observability.span",
        "observability.collector", "testing", "testing.failpoints",
        "testing.failpoint_registry", "admin", "admin.ingest_pipeline",
        "storage.records", "storage.memtable", "storage.wal",
        "storage.engine", "storage.native", "storage.native.binding",
        "utils.misc", "utils.retry_policy", "utils.rate_limiter",
        "utils.directio", "utils.objectstore", "utils.s3", "utils.s3_stub",
        "rpc", "rpc.errors", "rpc.serde", "rpc.framing", "rpc.deadline",
        "rpc.admission", "rpc.ioloop", "rpc.transport", "rpc.client",
        "rpc.client_pool", "rpc.server", "cluster", "cluster.coordinator",
        "compaction_remote", "compaction_remote.jobs",
        "compaction_remote.queue", "compaction_remote.worker",
        "compaction_remote.install", "compaction_remote.dispatch",
        "tools", "tools.compaction_worker",
        "utils.segment_utils", "utils.object_lock", "utils.concurrent_map",
        "utils.timer", "utils.file_watcher", "utils.dbconfig",
        "replication", "replication.wire", "replication.ack_window",
        "replication.max_number_box", "replication.cond_var",
        "replication.db_wrapper", "replication.iter_cache",
        "replication.handler", "replication.pull_mux",
        "replication.replicated_db", "replication.replicator",
        "replication.test_db_proxy", "storage.backup", "storage.archive",
        "admin.application_db", "admin.db_manager",
        "admin.backup_manager", "admin.handler",
        "utils.future_util", "utils.ssl_context_manager", "utils.hdfs",
        "rpc.router", "utils.hot_key_detector", "utils.graceful_shutdown",
        "utils.status_server", "examples", "examples.counter_service",
        "examples.counter_service.options",
        "examples.counter_service.counter_router",
        "examples.counter_service.counter_service",
        "examples.counter_service.stress_test",
        "replication.performance"}
missing = {m for m in seam if pkg.__name__ + "." + m not in names}
assert not missing, missing
print("IMPORTED", len(names))

from rocksplicator_tpu_torch.entry import bench_model, entry
from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
from rocksplicator_tpu_torch.models import CompactionModel
from rocksplicator_tpu_torch.gpu.compaction_service import (
    GpuCompactionService)
from rocksplicator_tpu_torch.admin import BatchCompactor, IngestGate
for call in (entry, bench_model, lambda: CompactionModel().example_args(),
             GpuCompactionBackend, GpuCompactionService,
             GpuCompactionService.instance, BatchCompactor):
    try:
        call()
    except RuntimeError as exc:
        assert "CUDA is not available" in str(exc), exc
    else:
        raise AssertionError("an entry point ran without CUDA")
model, args = entry(device="cpu")
out = model(*args)
assert int(out["count"]) > 0
print("RAISES_WITHOUT_CUDA")

# the engine seam on the CPU: merge two runs into a file and read it back
import struct, tempfile
from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
from rocksplicator_tpu_torch.storage.sst import SSTReader
pk = struct.Struct("<q").pack
runs = [[(b"k%03d" % i, 10 + i, 3, pk(i)) for i in range(50)],
        [(b"k%03d" % i, 1 + i % 9, 1, pk(100)) for i in range(50)]]
with tempfile.TemporaryDirectory() as d:
    outs = GpuCompactionBackend(device="cpu").merge_runs_to_files(
        runs, UInt64AddOperator(), True, lambda: d + "/out.tsst", 32768, 1,
        10, 1 << 20)
    assert [p for p, _ in outs] == [d + "/out.tsst"], outs
    reader = SSTReader(d + "/out.tsst")
    got = [(k, v) for k, _s, _t, v in reader.iterate()]
    # the streaming merge re-merges that file into the same bytes
    from rocksplicator_tpu_torch.storage import stream_merge
    stream_merge.STREAM_MODE_OVERRIDE = "always"
    backend = GpuCompactionBackend(device="cpu")
    again = backend.merge_runs_to_files(
        [reader], UInt64AddOperator(), True, lambda: d + "/again.tsst",
        32768, 1, 10, 1 << 20)
    reader.close()
    assert backend.last_stream_chunks == 1, backend.last_stream_chunks
    assert [p for p, _ in again] == [d + "/again.tsst"], again
    assert (open(d + "/again.tsst", "rb").read()
            == open(d + "/out.tsst", "rb").read())
assert got == [(b"k%03d" % i, pk(100 + i)) for i in range(50)], got[:3]
print("SEAM_ON_CPU")

# the batched service on the CPU: two shards in one call
from rocksplicator_tpu_torch.ops.kv_format import pack_entries
shards = [pack_entries(run) for run in runs]
res = GpuCompactionService(device="cpu").compact_shard_batch(shards)
assert [r["count"] for r in res] == [50, 50], res
assert res[1]["entries"][0][3] == pk(100), res[1]["entries"][0]
print("BATCH_ON_CPU")

# the post-ingest BatchCompactor over two stub DBs on the CPU: the first
# dispatch trips the port's own armed failpoint, the retry compacts
import os
from types import SimpleNamespace
from rocksplicator_tpu_torch.gpu.format import write_sst_from_arrays
from rocksplicator_tpu_torch.storage.sst import COMPRESSION_ZLIB
from rocksplicator_tpu_torch.testing import failpoints as fp
from rocksplicator_tpu_torch.utils.stats import Stats, tagged
opts = SimpleNamespace(merge_operator=UInt64AddOperator(),
                       target_file_bytes=1 << 20, block_bytes=4096,
                       compression=COMPRESSION_ZLIB, bits_per_key=10)
with tempfile.TemporaryDirectory() as d:
    dbs = []
    for s, run in enumerate(runs):
        os.makedirs(f"{d}/db{s}")
        b = pack_entries(sorted(run, key=lambda e: (e[0], -e[1])))
        n = b.num_valid()
        write_sst_from_arrays({f: getattr(b, f)[:n] for f in (
            "key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
            "val_words", "val_len")}, n, f"{d}/db{s}/run.tsst",
            block_entries=64, compression=0, bits_per_key=10, planar=True)
        dbs.append((f"db{s}", chip_smoke._StubDB(
            f"{d}/db{s}", [f"{d}/db{s}/run.tsst"], opts)))
    fp.activate("compact.dispatch", "fail_nth:1")
    compactor = BatchCompactor(device="cpu")
    try:
        try:
            compactor.compact("db0", dbs[0][1])
        except fp.FailpointError:
            pass
        else:
            raise AssertionError("the armed dispatch did not trip")
        sizes = [compactor.compact(name, db) for name, db in dbs]
    finally:
        compactor.close()
    assert sizes == [1, 1], sizes
    assert all(db.files for _name, db in dbs)
    assert Stats.get().get_counter(
        tagged("failpoint.trips", site="compact.dispatch")) == 1
    assert compactor.batch_sizes == [1, 1], compactor.batch_sizes
gate = IngestGate(1)
assert gate.try_enter() and not gate.try_enter()
print("BATCH_COMPACTOR_ON_CPU")

# the storage engine: a DB opens, writes, flushes, compacts, closes and
# reopens with the host's backend and with the card's on the CPU; with no
# backend it compacts on the card, so it refuses to open without CUDA
from rocksplicator_tpu_torch.storage import DB, DBOptions, WriteBatch
from rocksplicator_tpu_torch.storage.native_compaction import (
    NativeCompactionBackend)
for make in (NativeCompactionBackend, lambda: GpuCompactionBackend("cpu")):
    with tempfile.TemporaryDirectory() as d:
        def opened():
            return DB(d, DBOptions(merge_operator=UInt64AddOperator(),
                                   compaction_backend=make(),
                                   memtable_bytes=2048,
                                   level0_compaction_trigger=2))
        db = opened()
        for r in range(3):
            batch = WriteBatch()
            for i in range(40):
                batch.merge(b"counter:%08d" % i, pk(r + 1))
            db.write(batch)
            db.flush()
        db.delete(b"counter:%08d" % 0)
        db.compact_range()
        db.put(b"counter:%08d" % 1, pk(9))
        db.close()
        db = opened()
        got = db.multi_get([b"counter:%08d" % i for i in range(40)])
        assert got == [None, pk(9)] + [pk(6)] * 38, got[:3]
        assert db.get_property("num-files-at-level6") == "1"
        db.close()
with tempfile.TemporaryDirectory() as d:
    try:
        DB(d)
    except RuntimeError as exc:
        assert "CUDA is not available" in str(exc), exc
    else:
        raise AssertionError("a DB compacting on the card opened without "
                             "CUDA")
print("ENGINE_ON_CPU")

# the remote compaction tier: a port coordinator, a port worker on the
# card's backend (its plain versions on the CPU) and a port leader that
# offloads one compaction and reads it back; the worker's default backend
# is the card, so without CUDA it refuses to build
import threading, time
from rocksplicator_tpu_torch.cluster import (CoordinatorClient,
                                             CoordinatorServer)
from rocksplicator_tpu_torch.compaction_remote import (
    CompactionWorker, RemoteCompactionManager, RemoteDispatchPolicy)
from rocksplicator_tpu_torch.compaction_remote.worker import _build_backend
try:
    _build_backend(None)
except RuntimeError as exc:
    assert "CUDA is not available" in str(exc), exc
else:
    raise AssertionError("the worker's default backend built without CUDA")
with tempfile.TemporaryDirectory() as d:
    server = CoordinatorServer(port=0, data_dir=d + "/coord")
    clients = [CoordinatorClient("127.0.0.1", server.port) for _ in range(2)]
    db = DB(d + "/db", DBOptions(merge_operator=UInt64AddOperator(),
                                 compaction_backend=NativeCompactionBackend(),
                                 memtable_bytes=2048,
                                 level0_compaction_trigger=100))
    for r in range(3):
        batch = WriteBatch()
        for i in range(40):
            batch.merge(b"counter:%08d" % i, pk(r + 1))
        db.write(batch)
        db.flush()
    worker = CompactionWorker(clients[1], d + "/wk",
                              backend=GpuCompactionBackend(device="cpu"),
                              poll_interval=0.05)
    stop = threading.Event()
    thread = threading.Thread(target=worker.serve_forever, args=(stop,))
    thread.start()
    try:
        mgr = RemoteCompactionManager(
            "db0", db, clients[0], "local://" + d + "/store",
            policy=RemoteDispatchPolicy(enabled=True, size_floor_bytes=0,
                                        claim_wait_s=120.0,
                                        deadline_s=300.0))
        class Pick:
            kind = "l0"
        outcome = mgr.maybe_offload(Pick())
    finally:
        stop.set()
        thread.join()
    assert outcome == "installed", outcome
    assert worker.jobs_done == 1, worker.jobs_done
    # the direct sink ran (streamed: the stream mode is "always" here)
    assert "submit" in worker.last_job["backend_stages"], worker.last_job
    got = db.multi_get([b"counter:%08d" % i for i in range(40)])
    assert got == [pk(6)] * 40, got[:3]
    assert db.metrics_snapshot(max_age=0)["bytes_compacted_local_total"] == 0
    db.close()
    for c in clients:
        c.close()
    server.stop()
print("REMOTE_ON_CPU")

# the replicated shard: a leader and a follower, each a Replicator and an
# AdminHandler on an RpcServer with the card's backend on the CPU, add a
# DB through admin RPCs, replicate in mode 1, compact and read back; the
# default handler (the card) refuses to start without CUDA
from rocksplicator_tpu_torch.admin import AdminHandler
from rocksplicator_tpu_torch.replication import ReplicationFlags, Replicator
from rocksplicator_tpu_torch.rpc import IoLoop, RpcClientPool, RpcServer
with tempfile.TemporaryDirectory() as d:
    replicator = Replicator(port=0)
    try:
        AdminHandler(d + "/nocuda", replicator)
    except RuntimeError as exc:
        assert "CUDA is not available" in str(exc), exc
    else:
        raise AssertionError("a card admin handler started without CUDA")
    finally:
        replicator.stop()
    assert not os.path.exists(d + "/nocuda/meta_db")
    flags = ReplicationFlags(server_long_poll_ms=400)
    nodes = []
    for name in ("leader", "follower"):
        replicator = Replicator(port=0, flags=flags)
        handler = AdminHandler(
            d + "/" + name, replicator, device="cpu",
            options_generator=lambda s: DBOptions(
                merge_operator=UInt64AddOperator()))
        server = RpcServer(port=0, ioloop=replicator.ioloop)
        server.add_handler(handler)
        server.start()
        nodes.append((replicator, handler, server))
    pool, ioloop = RpcClientPool(), IoLoop.default()
    def call(node, method, **args):
        async def go():
            return await pool.call("127.0.0.1", node[2].port, method, args,
                                   timeout=60)
        return ioloop.run_sync(go())
    leader, follower = nodes
    call(leader, "add_db", db_name="seg00001", role="LEADER",
         replication_mode=1)
    call(follower, "add_db", db_name="seg00001", role="FOLLOWER",
         upstream_ip="127.0.0.1", upstream_port=leader[0].port)
    app = leader[1].db_manager.get_db("seg00001")
    for r in range(3):
        batch = WriteBatch()
        for i in range(40):
            batch.merge(b"counter:%08d" % i, pk(r + 1))
        app.write(batch)
    deadline = time.monotonic() + 60
    while call(follower, "get_sequence_number",
               db_name="seg00001")["seq_num"] != 120:
        assert time.monotonic() < deadline, "the follower never caught up"
        time.sleep(0.02)
    keys = [b"counter:%08d" % i for i in range(40)]
    for node in nodes:
        call(node, "compact_db", db_name="seg00001")
        db = node[1].db_manager.get_db("seg00001")
        assert type(db.db._backend).__name__ == "GpuCompactionBackend"
        assert db.multi_get(keys) == [pk(6)] * 40
    assert Stats.get().get_counter("replicator.pull_updates_applied") == 3
    ioloop.run_sync(pool.close())
    for replicator, handler, server in nodes:
        server.stop()
        handler.close()
        replicator.stop()
print("REPLICATED_ON_CPU")

# the counter service: its main (and the replication harness's) refuses to
# start without CUDA unless asked for the CPU, before it opens a DB; a
# port counter node on the CPU serves a routed bump and a get
import json
from rocksplicator_tpu_torch.examples.counter_service import (
    counter_service as cs)
from rocksplicator_tpu_torch.examples.counter_service.options import (
    counter_options_generator)
from rocksplicator_tpu_torch.replication import performance
from rocksplicator_tpu_torch.rpc import ClusterLayout, RpcRouter
with tempfile.TemporaryDirectory() as d:
    for run in (lambda: cs.main(["--rocksdb_dir", d + "/svc", "--port", "0",
                                 "--status_port", "0"]),
                lambda: performance.main(["--role", "leader", "--port", "0",
                                          "--db_dir", d + "/perf"])):
        try:
            run()
        except RuntimeError as exc:
            assert "CUDA is not available" in str(exc), exc
        else:
            raise AssertionError("the counter service ran without CUDA")
    assert not os.path.exists(d + "/svc") and not os.path.exists(d + "/perf")
    pool = RpcClientPool()
    nodes = []
    for name in ("a", "b"):
        replicator = Replicator(port=0, flags=flags)
        router = RpcRouter(local_az="az1")
        handler = cs.CounterHandler(
            d + "/" + name, replicator, device="cpu", router=router,
            options_generator=counter_options_generator)
        server = RpcServer(port=0, ioloop=replicator.ioloop)
        server.add_handler(handler)
        server.start()
        nodes.append((replicator, handler, server, router))
    shard_map = {"counter": {"num_shards": 2}}
    for i, n in enumerate(nodes):
        shard_map["counter"][f"127.0.0.1:{n[2].port}:az1:{n[0].port}"] = (
            ["00000:M", "00001:S"] if i == 0 else ["00000:S", "00001:M"])
    for n in nodes:
        n[3].update_layout(ClusterLayout.parse(json.dumps(shard_map).encode()))
        assert cs.create_dbs_from_shard_map(
            n[1], n[3], ("127.0.0.1", n[2].port)) == 2
    name = next(f"c{i}" for i in range(100)
                if nodes[0][1].router.shard_for(f"c{i}") == 1)
    call(nodes[0], "bump_counter", counter_name=name, delta=5,
         need_routing=True)
    assert call(nodes[1], "get_counter", counter_name=name)[
        "counter_value"] == 5
    assert call(nodes[0], "get_counter", counter_name=name,
                need_routing=True)["counter_value"] in (0, 5)
    ioloop.run_sync(pool.close())
    for replicator, handler, server, _router in nodes:
        server.stop()
        handler.close()
        replicator.stop()
print("COUNTER_SERVICE_ON_CPU")
rc = chip_smoke.main()
assert rc != 0, rc
print("SMOKE_REFUSES", rc)
'''


def _run_child():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", _CHILD], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_without_jax_and_refuses_cpu_fallback():
    res = _run_child()
    assert res.returncode == 0, res.stdout + res.stderr
    n = int(re.search(r"IMPORTED (\d+)", res.stdout).group(1))
    assert n >= 15, res.stdout
    assert "RAISES_WITHOUT_CUDA" in res.stdout
    assert "SEAM_ON_CPU" in res.stdout
    assert "BATCH_ON_CPU" in res.stdout
    assert "BATCH_COMPACTOR_ON_CPU" in res.stdout
    assert "ENGINE_ON_CPU" in res.stdout
    assert "REMOTE_ON_CPU" in res.stdout
    assert "REPLICATED_ON_CPU" in res.stdout
    assert "COUNTER_SERVICE_ON_CPU" in res.stdout
    assert "SMOKE_REFUSES" in res.stdout
    assert '"ok"' not in res.stdout


def test_port_sources_name_no_jax_module():
    """No import line of the package names jax or the JAX package."""
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|rocksplicator_tpu)(\.|\s|$)",
        re.MULTILINE)
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 15
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, (path, hits)


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory with nothing else of the repo exits
    non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_port_failpoint_sites_are_registered():
    """Every pass of ``tools/rstpu_check.py`` over the port (lock
    discipline, loops, the registry): every fp.hit site names a
    registered failpoint with a literal name, every span is a ``with
    start_span``, every counter name follows the grammar, and every
    ``allow()`` pragma the engine carries from the JAX package suppresses
    a finding. The registry is the JAX package's whole, so the entries
    whose seams live in layers the port has not taken over yet (kafka,
    the cluster's controller, ...) have no call site here: those, and only those, are
    reported as dead entries."""
    from rocksplicator_tpu_torch.testing.failpoint_registry import REGISTRY

    findings, _suppressed, _lock = run_checks(str(PACKAGE), root=str(REPO))
    rules = {}
    for f in findings:
        rules.setdefault(f.rule, []).append(f)
    assert set(rules) <= {"failpoint-dead-entry"}, {
        r: [(f.path, f.line, f.message) for f in fs]
        for r, fs in rules.items() if r != "failpoint-dead-entry"}
    dead = {f.message.split("'")[1] for f in rules.get(
        "failpoint-dead-entry", [])}
    ported = {"compact.dispatch", "compact.subcompact",
              "compact.stream.chunk", "compact.stream.refill",
              # the storage engine (WAL, SST writer, manifest, ingest,
              # compaction install, the scheduler's pick and yield)
              "wal.append", "wal.fsync", "wal.roll", "sst.fsync",
              "manifest.persist", "engine.ingest", "sst.ingest_footer",
              "compact.install", "compact.pick", "compact.yield",
              # the remote compaction tier and the layers under it: the
              # object store and S3 client, the RPC core, the coordinator
              "compact.remote.publish", "compact.remote.claim",
              "compact.remote.fetch", "compact.remote.upload",
              "compact.remote.install", "compact.remote.heartbeat",
              "objectstore.get", "objectstore.put", "s3.request",
              "rpc.connect", "rpc.frame.send", "rpc.frame.recv",
              "rpc.deadline.check", "admission.shed",
              "coordinator.wal.append", "coordinator.reap",
              "coordinator.heartbeat",
              # replication and the admin plane
              "ack.expire", "repl.apply", "repl.pull", "repl.read",
              "repl.read.serve", "repl.mux.apply", "repl.mux.serve",
              "admin.ingest.engine", "admin.ingest.meta",
              # the router and the HDFS store
              "router.read_pick", "router.hedge.fire", "hdfs.request"}
    assert dead == set(REGISTRY) - ported
