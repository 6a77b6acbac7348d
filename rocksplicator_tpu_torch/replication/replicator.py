"""Replicator: owns the replication server, executor, pool, and db map.
(The port's copy of ``rocksplicator_tpu/replication/replicator.py``.)

Reference: rocksdb_replicator/rocksdb_replicator.h:83-256 — a singleton in
production (``instance()``) owning the replication thrift server (port
9091), a ≥16-thread CPU executor, a client pool, and the db map; tests
construct private instances on distinct ports to build multi-node
topologies in one process (rocksdb_replicator_test.cpp:137-144) — the
constructor here is public for exactly that reason.

``add_db``/``remove_db``/``write`` mirror the reference lifecycle;
removal stops the pull loop and waits for in-flight handlers to drain via
the removed flag (the reference spin-waits on a weak_ptr,
rocksdb_replicator.cpp:135-154 — here explicit ownership makes that a
cancel + flag).
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from ..rpc.client_pool import RpcClientPool
from ..rpc.ioloop import IoLoop
from ..rpc.server import RpcServer
from ..storage.records import WriteBatch
from ..utils.concurrent_map import FastReadMap
from ..utils.dbconfig import DBConfigManager
from ..utils.segment_utils import db_name_to_segment
from ..utils.stats import Stats, tagged
from .db_wrapper import DbWrapper
from .handler import ReplicatorHandler
from .pull_mux import MuxServerState, PullMuxManager, mux_enabled
from .replicated_db import LeaderResolver, ReplicatedDB, ReplicationFlags
from .wire import ReplicaRole

log = logging.getLogger(__name__)

DEFAULT_REPLICATOR_PORT = 9091
_EXECUTOR_THREADS = 16  # reference: ≥16 CPU threads (rocksdb_replicator.cpp:58-67)


class Replicator:
    _instance: Optional["Replicator"] = None
    _instance_lock = threading.Lock()

    def __init__(
        self,
        port: int = 0,
        ioloop: Optional[IoLoop] = None,
        flags: Optional[ReplicationFlags] = None,
        executor_threads: int = _EXECUTOR_THREADS,
        server_ssl_manager=None,
        client_ssl_manager=None,
    ):
        self._ioloop = ioloop or IoLoop.default()
        self._flags = flags or ReplicationFlags()
        self._dbs: FastReadMap = FastReadMap()
        self._executor = ThreadPoolExecutor(
            max_workers=executor_threads, thread_name_prefix="replicator"
        )
        # TLS for the WAL-shipping plane (reference: SSL in the thrift
        # client pool, thrift_client_pool.h:254-290; refreshable context
        # ssl_context_manager.h) — both sides optional, mutual-TLS when
        # the managers carry a CA.
        self._pool = RpcClientPool(ssl_manager=client_ssl_manager)
        # Mux pull sessions: the SERVER side always answers
        # replicate_mux (so mux-enabled peers can pull from anyone); the
        # CLIENT side multiplexes only when the killswitch allows.
        self._mux_state = MuxServerState()
        self._pull_mux: Optional[PullMuxManager] = (
            PullMuxManager(self._ioloop.loop, self._executor, self._pool,
                           self._flags)
            if mux_enabled(self._flags) else None)
        self._server = RpcServer(port=port, ioloop=self._ioloop,
                                 ssl_manager=server_ssl_manager)
        self._server.add_handler(
            ReplicatorHandler(self._dbs, mux_state=self._mux_state))
        self._server.start()
        # parked long-polls on THIS replica (per-shard parks + parked mux
        # sessions): the fleet A/B's park gauge, per-port so in-process
        # topologies keep one series per replica
        self._parked_gauge = tagged("replicator.parked_longpolls",
                                    port=str(self._server.port))
        Stats.get().add_gauge(self._parked_gauge, self._parked_longpolls)
        self._maintenance_stop = threading.Event()
        self._maintenance = threading.Thread(
            target=self._maintenance_loop, name="replicator-maint", daemon=True
        )
        self._maintenance.start()

    @classmethod
    def instance(cls, port: int = DEFAULT_REPLICATOR_PORT) -> "Replicator":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls(port=port)
        return cls._instance

    @classmethod
    def reset_for_test(cls) -> None:
        with cls._instance_lock:
            if cls._instance is not None:
                cls._instance.stop()
            cls._instance = None

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def ioloop(self) -> IoLoop:
        return self._ioloop

    # ------------------------------------------------------------------

    def add_db(
        self,
        name: str,
        wrapper: DbWrapper,
        role: ReplicaRole,
        upstream_addr: Optional[Tuple[str, int]] = None,
        replication_mode: Optional[int] = None,
        leader_resolver: Optional[LeaderResolver] = None,
        epoch: int = 0,
    ) -> ReplicatedDB:
        """Register a db for replication. Duplicate names are an error
        (reference returns DB_ALREADY_EXISTS)."""
        if replication_mode is None:
            # Per-dataset config with default 0 (replicated_db.cpp:131-136).
            try:
                segment = db_name_to_segment(name)
            except ValueError:
                segment = name
            replication_mode = DBConfigManager.get().get_replication_mode(segment)
        rdb = ReplicatedDB(
            name=name,
            wrapper=wrapper,
            role=role,
            loop=self._ioloop.loop,
            executor=self._executor,
            pool=self._pool,
            upstream_addr=upstream_addr,
            replication_mode=replication_mode,
            flags=self._flags,
            leader_resolver=leader_resolver,
            epoch=epoch,
            stat_tags={"port": str(self.port)},
            mux=self._pull_mux,
        )
        if not self._dbs.add(name, rdb):
            raise ValueError(f"db already exists: {name}")
        try:
            rdb.start()
        except BaseException:
            # Never leave a zombie registration behind a failed start.
            self._dbs.remove(name)
            rdb.stop()
            raise
        self._register_shard_gauges(name, rdb, wrapper)
        self._maybe_attach_remote_compactor(name, rdb, wrapper)
        return rdb

    def _maybe_attach_remote_compactor(self, name: str, rdb: ReplicatedDB,
                                       wrapper: DbWrapper) -> None:
        """When the environment opts in (RSTPU_COMPACT_REMOTE
        + coordinator endpoint + store URI), hook this shard's engine
        into the disaggregated compaction tier — pressure picks above
        the size floor publish to the job ledger instead of merging on
        the serving node. The epoch provider reads the shard's LIVE
        fencing epoch, so a job published before a deposition is
        rejected at install (the fencing rule extended to
        compaction). The ledger key is name@port: unique per replica,
        since every replica compacts independently. Never fatal — the
        tier is an optimization, serving never depends on it."""
        engine = wrapper.gauge_target()
        if engine is None:
            return
        try:
            from ..compaction_remote.dispatch import attach_from_env

            rdb._remote_compaction_mgr = attach_from_env(
                f"{name}@{self.port}", engine,
                epoch_provider=lambda: rdb.epoch)
        except Exception:
            log.exception("remote-compaction attach failed for %s", name)
            rdb._remote_compaction_mgr = None

    def _register_shard_gauges(self, name: str, rdb: ReplicatedDB,
                               wrapper: DbWrapper) -> None:
        """Pull-model gauges for this shard: replication lag
        + ack-window occupancy here, the engine's level/amp/debt gauges
        when the wrapper exposes a local engine. Tagged with this
        replicator's port so multi-replicator (in-process cluster) test
        topologies keep one gauge series per replica."""
        from ..storage.engine import register_db_gauges

        stats = Stats.get()
        port = str(self.port)
        names = []
        lag_name = tagged("replicator.applied_seq_lag", db=name, port=port)
        stats.add_gauge(lag_name, rdb.applied_seq_lag)
        names.append(lag_name)
        depth_name = tagged("replicator.ack_window_depth", db=name,
                            port=port)
        stats.add_gauge(depth_name, lambda: float(rdb.ack_window_depth))
        names.append(depth_name)
        engine = wrapper.gauge_target()
        if engine is not None:
            names.extend(register_db_gauges(name, engine, stats=stats,
                                            port=port))
        rdb._gauge_names = names

    def _unregister_shard_gauges(self, rdb: ReplicatedDB) -> None:
        stats = Stats.get()
        for gname in getattr(rdb, "_gauge_names", ()):
            stats.remove_gauge(gname)
        rdb._gauge_names = []

    def remove_db(self, name: str) -> None:
        rdb = self._dbs.get(name)
        if rdb is None:
            raise KeyError(f"no such db: {name}")
        rdb.stop()
        self._unregister_shard_gauges(rdb)
        mgr = getattr(rdb, "_remote_compaction_mgr", None)
        if mgr is not None:
            from ..compaction_remote.dispatch import detach

            detach(rdb.wrapper.gauge_target(), mgr)
            rdb._remote_compaction_mgr = None
        self._dbs.remove(name)

    def get_db(self, name: str) -> Optional[ReplicatedDB]:
        return self._dbs.get(name)

    def write(self, name: str, batch: WriteBatch) -> int:
        rdb = self._dbs.get(name)
        if rdb is None:
            raise KeyError(f"no such db: {name}")
        return rdb.write(batch)

    def write_async(self, name: str, batch: WriteBatch):
        """Pipelined write: WAL-write now, return an AckWaiter whose
        future resolves when the replication-mode ack condition is met
        (or its timeout expires). See ReplicatedDB.write_async."""
        rdb = self._dbs.get(name)
        if rdb is None:
            raise KeyError(f"no such db: {name}")
        return rdb.write_async(batch)

    def write_async_many(self, name: str, batches):
        """Batched pipelined writes: one WAL flush / wakeup / stats
        update for the whole group, one AckWaiter per batch. See
        ReplicatedDB.write_async_many."""
        rdb = self._dbs.get(name)
        if rdb is None:
            raise KeyError(f"no such db: {name}")
        return rdb.write_async_many(batches)

    def introspect(self) -> str:
        lines = [rdb.introspect() for _name, rdb in sorted(self._dbs.items())]
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------

    def _maintenance_loop(self) -> None:
        """Periodic iterator-cache eviction (reference CachedIterCleaner's
        background EventBase thread, cached_iter_cleaner.cpp:29-78)."""
        while not self._maintenance_stop.wait(5.0):
            for _name, rdb in self._dbs.items():
                rdb._iter_cache.evict_idle()

    def _parked_longpolls(self) -> float:
        """Gauge: serves currently parked on this replica — per-shard
        long-poll parks plus parked mux sessions."""
        total = self._mux_state.parked
        for _name, rdb in self._dbs.items():
            total += rdb._parked_serves
        return float(total)

    def stop(self) -> None:
        self._maintenance_stop.set()
        if self._pull_mux is not None:
            self._pull_mux.stop()
        for _name, rdb in list(self._dbs.items()):
            rdb.stop()
            self._unregister_shard_gauges(rdb)
        self._dbs.clear()
        Stats.get().remove_gauge(self._parked_gauge)
        self._server.stop()
        self._ioloop.run_sync(self._pool.close())
        self._executor.shutdown(wait=False)
        self._maintenance.join(timeout=2.0)
