"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: the same numpy inputs go through both, outputs come back as numpy
and must be equal element for element (integer lanes: tolerance 0)."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from rocksplicator_tpu_torch.models.compaction_model import FORWARD_ARGS
from rocksplicator_tpu_torch.ops.lanes import lanes_from_numpy, lanes_to_numpy


def jax_args(batch):
    return tuple(jnp.asarray(batch[k]) for k in FORWARD_ARGS)


def torch_args(batch, device="cpu"):
    lanes = lanes_from_numpy({k: batch[k] for k in FORWARD_ARGS}, device)
    return tuple(lanes[k] for k in FORWARD_ARGS)


def jax_out(out) -> dict:
    res = {}
    for k, v in out.items():
        a = np.asarray(v)
        res[k] = a.item() if a.ndim == 0 else a
    return res


def torch_out(out) -> dict:
    return lanes_to_numpy(out)


def assert_same_outputs(want: dict, got: dict, what: str = "") -> None:
    assert set(want) == set(got), (what, sorted(want), sorted(got))
    for k in want:
        w, g = want[k], got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), (what, k)
            assert w.dtype == g.dtype, (what, k, w.dtype, g.dtype)
            np.testing.assert_array_equal(w, g, err_msg=f"{what} {k}")
        else:
            assert type(g) is type(w) and g == w, (what, k, w, g)


# the JAX package's compaction counters that the port emits at the same
# sites (its own Stats singleton)
G1_COUNTERS = ("compaction.subcompactions", "compaction.stream_chunks",
               "compaction.stream_refills", "compaction.stream_merges",
               "compaction.stream_declines")


def counters(stats_module, names=G1_COUNTERS) -> dict:
    """The counters of ``names`` in one package's Stats singleton."""
    st = stats_module.Stats.get()
    return {n: st.get_counter(n) for n in names}


def span_shape(collector_module, prefixes=("",), timed=()) -> dict:
    """One package's kept spans whose names start with one of
    ``prefixes``, as a multiset: (name, parent's name, sorted
    annotations, error class) -> count; a parent outside the selected
    spans counts as none. Ids and times are left out, annotations named
    in ``timed`` (host-clock durations) too, so two packages' traces of
    the same job compare equal."""
    spans = [s for s in collector_module.SpanCollector.get().snapshot()
             if s["name"].startswith(tuple(prefixes))]
    names = {s["span_id"]: s["name"] for s in spans}
    shape: dict = {}
    for s in spans:
        key = (s["name"], names.get(s["parent_id"]),
               tuple(sorted((k, v) for k, v in s["annotations"].items()
                            if k not in timed)),
               (s["error"] or "").split("(")[0])
        shape[key] = shape.get(key, 0) + 1
    return shape


def reset_observability(*packages, sample_rate: float = 1.0) -> None:
    """Zero each package's Stats, empty its span collector (keeping every
    root at ``sample_rate``) and disarm its failpoints; ``packages`` are
    the top modules (``rocksplicator_tpu``, ``rocksplicator_tpu_torch``)."""
    import importlib

    for pkg in packages:
        name = pkg.__name__
        importlib.import_module(name + ".utils.stats").Stats.reset_for_test()
        col = importlib.import_module(name + ".observability.collector")
        col.SpanCollector.reset_for_test()
        col.SpanCollector.get().configure(sample_rate=sample_rate)
        importlib.import_module(name + ".testing.failpoints").reset_for_test()


# ---------------------------------------------------------------------------
# the replicated shard and its admin plane, on either package
# ---------------------------------------------------------------------------

PACKAGES = {"ref": "rocksplicator_tpu", "port": "rocksplicator_tpu_torch"}


def wait_until(pred, timeout=60.0, interval=0.02):
    """Poll ``pred``; the windows are wide (no test bounds a speed)."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class ReplPackage:
    """One package's replication and admin stack, by the JAX package's
    names. The port's DBs compact on the card's backend, run on the CPU
    (``GpuCompactionBackend(device="cpu")``), unless ``host=True`` names
    ``NativeCompactionBackend``; its admin handlers take ``device="cpu"``."""

    def __init__(self, key: str):
        import importlib

        self.key = key
        self.name = PACKAGES[key]

        def mod(name):
            return importlib.import_module(f"{self.name}.{name}")

        self.mod = mod
        self.top = importlib.import_module(self.name)
        repl = mod("replication")
        self.ReplicaRole = repl.ReplicaRole
        self.ReplicationFlags = repl.ReplicationFlags
        self.Replicator = repl.Replicator
        self.StorageDbWrapper = repl.StorageDbWrapper
        self.MaxNumberBox = repl.MaxNumberBox
        self.AckWindow = repl.AckWindow
        self.M = mod("replication.wire").REPLICATOR_METRICS
        self.TestDbProxy = mod("replication.test_db_proxy").TestDbProxy
        storage = mod("storage")
        self.DB, self.DBOptions = storage.DB, storage.DBOptions
        self.WriteBatch, self.OpType = storage.WriteBatch, storage.OpType
        self.UInt64AddOperator = storage.UInt64AddOperator
        self.wal = mod("storage.wal")
        self.backup = mod("storage.backup")
        self.archive = mod("storage.archive")
        self.SSTWriter = mod("storage.sst").SSTWriter
        self.Stats = mod("utils.stats").Stats
        self.tagged = mod("utils.stats").tagged
        self.fp = mod("testing.failpoints")
        self.collector = mod("observability.collector")
        rpc = mod("rpc")
        self.IoLoop, self.RpcServer = rpc.IoLoop, rpc.RpcServer
        self.RpcClientPool = rpc.RpcClientPool
        self.RpcApplicationError = mod("rpc.errors").RpcApplicationError
        self.AdminHandler = mod("admin.handler").AdminHandler
        self.BackupManager = mod(
            "admin.backup_manager").ApplicationDBBackupManager
        self.LocalObjectStore = mod("utils.objectstore").LocalObjectStore

    def __repr__(self):
        return self.key

    def backend(self, host: bool = False):
        """The compaction backend a port DB names (None: the reference's
        default, its native host merge)."""
        if self.key == "ref":
            return None
        if host:
            return self.mod(
                "storage.native_compaction").NativeCompactionBackend()
        return self.mod("gpu.backend").GpuCompactionBackend(device="cpu")

    def db_options(self, host: bool = False, **kw):
        if self.key == "port" and "compaction_backend" not in kw:
            kw["compaction_backend"] = self.backend(host)
        return self.DBOptions(**kw)

    def open_db(self, path, host: bool = False, **kw):
        return self.DB(str(path), self.db_options(host, **kw))

    def flags(self, **kw):
        base = dict(server_long_poll_ms=400, pull_error_delay_min_ms=50,
                    pull_error_delay_max_ms=120, ack_timeout_ms=20000,
                    degraded_ack_timeout_ms=10,
                    consecutive_timeouts_to_degrade=5,
                    empty_pulls_before_reset=1000)
        base.update(kw)
        return self.ReplicationFlags(**base)

    def admin_handler(self, rocksdb_dir, replicator, **kw):
        if self.key == "port":
            kw.setdefault("device", "cpu")
        return self.AdminHandler(str(rocksdb_dir), replicator, **kw)


class ReplHost:
    """One node of the reference's replication harness: a private
    Replicator on its own port and its DBs."""

    def __init__(self, pkg: ReplPackage, root, name, flags=None):
        self.pkg = pkg
        self.dir = root / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.replicator = pkg.Replicator(port=0, flags=flags or pkg.flags())
        self.dbs = {}

    @property
    def addr(self):
        return ("127.0.0.1", self.replicator.port)

    def add_db(self, db_name, role, upstream=None, mode=0,
               leader_resolver=None, **db_kw):
        db = self.pkg.open_db(self.dir / db_name, **db_kw)
        self.dbs[db_name] = db
        rdb = self.replicator.add_db(
            db_name, self.pkg.StorageDbWrapper(db), role,
            upstream_addr=upstream, replication_mode=mode,
            leader_resolver=leader_resolver)
        return db, rdb

    def write(self, db_name, batch):
        return self.replicator.write(db_name, batch)

    def stop(self):
        self.replicator.stop()
        for db in self.dbs.values():
            db.close()


class AdminNode:
    """One admin node: a Replicator, an AdminHandler and an RpcServer of
    one package."""

    def __init__(self, pkg: ReplPackage, root, name, flags=None, **kw):
        self.pkg = pkg
        self.replicator = pkg.Replicator(port=0, flags=flags or pkg.flags())
        self.handler = pkg.admin_handler(root / name, self.replicator, **kw)
        self.server = pkg.RpcServer(port=0, ioloop=self.replicator.ioloop)
        self.server.add_handler(self.handler)
        self.server.start()

    @property
    def admin_port(self):
        return self.server.port

    @property
    def repl_addr(self):
        return ("127.0.0.1", self.replicator.port)

    def app_db(self, name):
        return self.handler.db_manager.get_db(name)

    def stop(self):
        self.server.stop()
        self.handler.close()
        self.replicator.stop()


class AdminClient:
    """A client pool of one package, called synchronously on that
    package's own IO loop."""

    def __init__(self, pkg: ReplPackage):
        self.pkg = pkg
        self.ioloop = pkg.IoLoop.default()
        self.pool = pkg.RpcClientPool()

    def __call__(self, node, method, **args):
        async def go():
            return await self.pool.call("127.0.0.1", node.admin_port,
                                        method, args, timeout=60)

        return self.ioloop.run_sync(go())

    def close(self):
        self.ioloop.run_sync(self.pool.close())


def tsst_digests(db) -> list:
    """sha256 of every live ``.tsst`` file of ``db``, sorted (a multiset:
    file numbers may differ between replicas)."""
    import hashlib
    import os

    return sorted(
        hashlib.sha256(open(os.path.join(db.path, n), "rb").read())
        .hexdigest() for level in db._levels for n in level)


def reset_both():
    """Zero both packages' Stats, spans (every root kept), failpoints,
    tenant admission and embedded Kafka cluster registries."""
    import importlib

    tops = [importlib.import_module(n) for n in PACKAGES.values()]
    reset_observability(*tops)
    for n in PACKAGES.values():
        importlib.import_module(n + ".rpc.admission").TenantAdmission \
            .reset_for_test()
        importlib.import_module(n + ".kafka.broker") \
            .reset_clusters_for_test()
