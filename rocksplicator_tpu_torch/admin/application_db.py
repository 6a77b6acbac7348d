"""ApplicationDB: storage DB + replication registration.
(The port's copy of ``rocksplicator_tpu/admin/application_db.py``.)

Reference: rocksdb_admin/application_db.{h,cpp} — wraps rocksdb::DB, routes
writes through ``ReplicatedDB::Write`` when the db is replicated
(application_db.cpp:122-136), delegates reads with stats, exposes
``CompactRange``/``GetProperty`` including the custom
``applicationdb.num-levels`` / ``applicationdb.highest-empty-level`` props
backing the ``DBLmaxEmpty()`` ingest-behind safety check
(application_db.cpp:183-225). The constructor registers with the
replicator (application_db.cpp:52-70); ``close`` unregisters.
"""

from __future__ import annotations

import itertools
import logging
from typing import Iterator, List, Optional, Tuple

from ..replication.db_wrapper import (DbWrapper, StorageDbWrapper,
                                      execute_read_op)
from ..replication.replicated_db import LeaderResolver, ReplicatedDB
from ..replication.replicator import Replicator
from ..replication.wire import ReplicaRole
from ..storage.engine import DB
from ..storage.records import WriteBatch
from ..utils.stats import Stats, tagged

log = logging.getLogger(__name__)

# process-unique suffixes for the fallback gauge registrations below
_APPDB_GAUGE_REFS = itertools.count(1)


class ApplicationDB:
    def __init__(
        self,
        name: str,
        db: DB,
        role: ReplicaRole,
        replicator: Optional[Replicator] = None,
        upstream_addr: Optional[Tuple[str, int]] = None,
        replication_mode: Optional[int] = None,
        leader_resolver: Optional[LeaderResolver] = None,
        wrapper: Optional[DbWrapper] = None,
        enable_read_stats: bool = True,  # optional: ~10M Get/s design point
        epoch: int = 0,
    ):
        self.name = name
        self.db = db
        self.role = role
        self._replicator = replicator
        self._stats = Stats.get()
        self._enable_read_stats = enable_read_stats
        # local engine reader for the bounded-staleness read path: always
        # reads THIS replica's engine, independent of whatever wrapper
        # (possibly a non-persisting proxy) is registered for replication
        self._reader = StorageDbWrapper(db)
        self.replicated_db: Optional[ReplicatedDB] = None
        repl_wrapper = wrapper or StorageDbWrapper(db)
        if replicator is not None and role is not ReplicaRole.NOOP:
            self.replicated_db = replicator.add_db(
                name,
                repl_wrapper,
                role,
                upstream_addr=upstream_addr,
                replication_mode=replication_mode,
                leader_resolver=leader_resolver,
                epoch=epoch,
            )
        # engine introspection gauges: the replicator's
        # add_db registers them when the replication wrapper exposes the
        # engine; otherwise (unreplicated/NOOP dbs, CDC observers whose
        # wrapper has no local engine) this ApplicationDB owns them. The
        # ref tag disambiguates colocated same-name shards (in-process
        # test topologies) the way the replicator path's port tag does —
        # without it, two registrations would silently overwrite each
        # other and either close() would strip the survivor's gauges.
        from ..storage.engine import register_db_gauges

        self._gauge_names: list = []
        if self.replicated_db is None or repl_wrapper.gauge_target() is None:
            self._gauge_names = register_db_gauges(
                name, db, ref=f"a{next(_APPDB_GAUGE_REFS)}")

    # -- writes ------------------------------------------------------------

    def write(self, batch: WriteBatch) -> int:
        if self.replicated_db is not None:
            seq = self.replicated_db.write(batch)
        else:
            seq = self.db.write(batch)
        self._stats.incr(tagged("applicationdb.writes", db=self.name))
        return seq

    def write_async(self, batch: WriteBatch):
        """Pipelined write: WAL-commit now, return an AckWaiter whose
        ``future`` (a concurrent.futures.Future) resolves when the
        replication ack condition is met — async handlers await it via
        asyncio.wrap_future instead of parking an executor thread per
        in-flight write. Unreplicated DBs return an already-resolved
        waiter."""
        from ..replication.ack_window import resolved_waiter

        if self.replicated_db is not None:
            waiter = self.replicated_db.write_async(batch)
        else:
            waiter = resolved_waiter(self.db.write(batch))
        self._stats.incr(tagged("applicationdb.writes", db=self.name))
        return waiter

    def write_many(self, batches: List[WriteBatch]) -> int:
        """Grouped-commit apply (``write_many``): every batch
        commits with ONE storage lock pass and one WAL flush. The CDC
        batched apply path rides this; blocking semantics mirror
        ``write`` (replicated dbs wait each batch's ack future — ack or
        timeout — so callers see the same degradation accounting as N
        blocking writes). Returns the first batch's start seq."""
        if not batches:
            return 0
        if self.replicated_db is not None:
            import time as _time

            waiters = self.replicated_db.write_async_many(batches)
            for w in waiters:
                try:
                    w.result(max(0.0, w.deadline - _time.monotonic()) + 2.0)
                except Exception:
                    pass  # timeout accounting lives in the ack window
            seq = waiters[0].seq
        else:
            seq = self.db.write_many([(b, None) for b in batches])
        self._stats.incr(
            tagged("applicationdb.writes", db=self.name), len(batches))
        return seq

    # -- reads -------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        if self._enable_read_stats:
            self._stats.incr(tagged("applicationdb.gets", db=self.name))
        return self.db.get(key)

    def multi_get(self, keys: List[bytes]) -> List[Optional[bytes]]:
        if self._enable_read_stats:
            self._stats.incr(
                tagged("applicationdb.multigets", db=self.name), len(keys)
            )
        return self.db.multi_get(keys)

    def read(
        self,
        op: str = "get",
        keys=None,
        start: Optional[bytes] = None,
        count: Optional[int] = None,
        max_lag: Optional[int] = None,
        epoch: Optional[int] = None,
    ) -> dict:
        """Bounded-staleness local read: the in-process analog
        of the replication plane's ``read`` RPC, for embedding services
        (reference: ApplicationDB delegating reads to rocksdb,
        application_db.cpp:138-181) that want the same guarantees a
        routed client gets. Replicated dbs gate through
        ``ReplicatedDB.read_gate`` — a FOLLOWER serves only within
        ``max_lag`` of the leader's committed sequence and rejects a
        newer-epoch (deposed-lineage) read exactly as it rejects
        stale-epoch pulls; the sync gate never probes, so a follower
        whose commit-point estimate aged out bounces rather than
        blocking. Unreplicated/NOOP dbs serve directly."""
        gate: dict = {"applied_seq": None, "leader_seq": None, "lag": None}
        if self.replicated_db is not None:
            gate = self.replicated_db.read_gate(max_lag=max_lag, epoch=epoch)
        if self._enable_read_stats:
            self._stats.incr(tagged("applicationdb.reads", db=self.name))
        # one shared dispatch with the RPC path (execute_read_op) over a
        # local engine reader, so the two surfaces cannot diverge
        values = execute_read_op(self._reader, op, keys=keys, start=start,
                                 count=count)
        return {**gate, "values": values, "source_role": self.role.value}

    def new_iterator(self, start=None, end=None) -> Iterator[Tuple[bytes, bytes]]:
        return self.db.new_iterator(start, end)

    # -- admin surface -----------------------------------------------------

    def compact_range(self, start=None, end=None) -> None:
        self.db.compact_range(start, end)

    def get_property(self, name: str) -> Optional[str]:
        # applicationdb.* prefix parity (application_db.cpp:183-199)
        if name.startswith("applicationdb."):
            name = name[len("applicationdb."):]
        return self.db.get_property(name)

    def db_lmax_empty(self) -> bool:
        """True iff the bottom level is empty ⇒ ingest_behind is safe
        (application_db.cpp:200-225). highest-empty-level is -1 exactly
        when the bottom level holds files."""
        return int(self.get_property("highest-empty-level") or -1) != -1

    def latest_sequence_number(self) -> int:
        return self.db.latest_sequence_number()

    def close(self) -> None:
        from ..storage.engine import unregister_db_gauges

        unregister_db_gauges(self._gauge_names)
        self._gauge_names = []
        if self.replicated_db is not None and self._replicator is not None:
            try:
                self._replicator.remove_db(self.name)
            except KeyError:
                pass
            self.replicated_db = None
        self.db.close()
