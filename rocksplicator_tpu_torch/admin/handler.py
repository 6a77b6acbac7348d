"""AdminHandler: the admin data-plane service.
(The port's copy of ``rocksplicator_tpu/admin/handler.py``.)

Reference: rocksdb_admin/rocksdb_admin.thrift:259-363 (15 RPCs) +
rocksdb_admin/admin_handler.{h,cpp} (2.2k LoC). Implements:

ping, addDB, backupDB, restoreDB, backupDBToS3, restoreDBFromS3, checkDB,
closeDB, changeDBRoleAndUpStream, getSequenceNumber, clearDB,
addS3SstFilesToDB, startMessageIngestion, stopMessageIngestion,
setDBOptions, compactDB.

Structure parity: a private meta_db at ``<rocksdb_dir>/meta_db`` storing
per-db DBMetaData (admin_handler.cpp:204-212, 556-595); per-db ObjectLock
serializing admin ops; an object-store cache; an ingest concurrency gate
(``num_current_s3_sst_downloadings_``); message-ingestion watcher map.
"S3" RPC names are kept for wire parity — the bucket argument is any
object-store URI (local dir or s3://).

Where the port differs: the JAX package's handler opens host DBs unless
asked (``tpu_compaction=False``); this one compacts every DB it hosts, its
``meta_db`` included, on the card unless asked (``gpu_compaction=True``,
``device=None`` meaning ``cuda``). Without CUDA the constructor raises
before it opens anything. ``gpu_compaction=False`` names the host's
``NativeCompactionBackend`` wherever the options generator named no
backend.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..observability.context import wire_context
from ..observability.span import start_span
from ..replication.replicated_db import LeaderResolver
from ..replication.replicator import Replicator
from ..replication.wire import ReplicaRole
from ..rpc.errors import RpcApplicationError
from ..storage import backup as backup_mod
from ..storage.engine import DB, DBOptions, destroy_db
from ..storage.errors import StorageError
from ..device import resolve_device
from ..gpu.compaction_service import GpuCompactionService
from ..storage.native_compaction import NativeCompactionBackend
from ..testing import failpoints as fp
from ..utils.flags import FLAGS, define_flag
from ..utils.object_lock import ObjectLock
from ..utils.objectstore import build_object_store
from ..utils.segment_utils import db_name_to_segment
from ..utils.stats import Stats
from ..utils.timer import Timer
from .application_db import ApplicationDB
from .db_manager import ApplicationDBManager
from .ingest_pipeline import (BatchCompactor, IngestGate,
                              default_sst_loading_concurrency)

log = logging.getLogger(__name__)

# Reference gflag parity: direct-IO SST downloads keep a restore/ingest
# storm from evicting the serving working set (s3util.h:82-103)
define_flag("s3_direct_io", False,
            "download ingest SSTs through O_DIRECT sinks (page-cache "
            "bypass)")

# AdminErrorCode parity (rocksdb_admin.thrift)
DB_NOT_FOUND = "DB_NOT_FOUND"
DB_ALREADY_EXISTS = "DB_ALREADY_EXISTS"
INVALID_DB_ROLE = "INVALID_DB_ROLE"
INVALID_UPSTREAM = "INVALID_UPSTREAM"
DB_ADMIN_ERROR = "DB_ADMIN_ERROR"
DB_ERROR = "DB_ERROR"
TOO_MANY_REQUESTS = "TOO_MANY_REQUESTS"
NOT_IMPLEMENTED = "NOT_IMPLEMENTED"

_ROLE_ALIASES = {
    "LEADER": ReplicaRole.LEADER, "MASTER": ReplicaRole.LEADER,
    "FOLLOWER": ReplicaRole.FOLLOWER, "SLAVE": ReplicaRole.FOLLOWER,
    "NOOP": ReplicaRole.NOOP, "OBSERVER": ReplicaRole.OBSERVER,
}

OptionsGenerator = Callable[[str], DBOptions]

# sentinel marking an in-flight startMessageIngestion reservation
_RESERVED = object()


@dataclass
class DBMetaData:
    """rocksdb_admin.thrift DBMetaData (+ the split-trim retain range:
    hex key bounds a range-split child keeps across reopens so its
    compactions keep dropping the other half's keys)."""

    db_name: str
    s3_bucket: str = ""
    s3_path: str = ""
    last_kafka_msg_timestamp_ms: int = 0
    retain_lo: str = ""
    retain_hi: str = ""

    def encode(self) -> bytes:
        return json.dumps(asdict(self)).encode("utf-8")

    @classmethod
    def decode(cls, db_name: str, raw: Optional[bytes]) -> "DBMetaData":
        if not raw:
            return cls(db_name=db_name)
        d = json.loads(bytes(raw).decode("utf-8"))
        d.setdefault("db_name", db_name)
        return cls(**d)


def _current_mode(app_db: ApplicationDB) -> Optional[int]:
    """The db's live ack mode, for preserving across reopen/role change."""
    if app_db.replicated_db is not None:
        return app_db.replicated_db.replication_mode
    return None


def _current_epoch(app_db: ApplicationDB) -> int:
    """The db's live fencing epoch, preserved (max-merged) across
    reopen/role change so a legacy caller passing no epoch can never
    regress a shard below an epoch it already served under."""
    if app_db.replicated_db is not None:
        return app_db.replicated_db.epoch
    return 0


def _parse_role(role: str) -> ReplicaRole:
    r = _ROLE_ALIASES.get(role.upper())
    if r is None:
        raise RpcApplicationError(INVALID_DB_ROLE, role)
    return r


class AdminHandler:
    def __init__(
        self,
        rocksdb_dir: str,
        replicator: Replicator,
        db_manager: Optional[ApplicationDBManager] = None,
        options_generator: Optional[OptionsGenerator] = None,
        leader_resolver: Optional[LeaderResolver] = None,
        executor_threads: int = 8,
        max_sst_loading_concurrency: Optional[int] = None,
        object_store_rate_limit_bytes: Optional[float] = None,
        gpu_compaction: bool = True,
        device=None,
        compact_parallelism: Optional[int] = None,
    ):
        # the card is resolved first: without CUDA nothing is opened
        self.device = resolve_device(device) if gpu_compaction else None
        self.rocksdb_dir = os.path.abspath(rocksdb_dir)
        os.makedirs(self.rocksdb_dir, exist_ok=True)
        # sweep staging dirs orphaned by a crash mid-backup/restore:
        # they live on the data volume (same-fs for hardlinks/rename)
        # and are only meaningful to the in-flight op that created them
        for entry in os.listdir(self.rocksdb_dir):
            if entry.startswith((".restore-", ".backup-")):
                shutil.rmtree(os.path.join(self.rocksdb_dir, entry),
                              ignore_errors=True)
        self.replicator = replicator
        self.db_manager = db_manager or ApplicationDBManager()
        self._options_gen = options_generator or (lambda segment: DBOptions())
        self._leader_resolver = leader_resolver
        self._executor = ThreadPoolExecutor(
            max_workers=executor_threads, thread_name_prefix="admin"
        )
        self._db_admin_lock = ObjectLock()
        self._store_rate_limit = object_store_rate_limit_bytes
        # ingest admission gate: the 999 default made TOO_MANY_REQUESTS
        # dead code — None now derives a sane bound from the host
        self._ingest_gate = IngestGate(
            max_sst_loading_concurrency
            if max_sst_loading_concurrency is not None
            else default_sst_loading_concurrency()
        )
        self._gpu_compaction = gpu_compaction
        self._batch_compactor = BatchCompactor(
            use_gpu=gpu_compaction, device=self.device,
            compact_parallelism=compact_parallelism)
        self._meta_db = DB(os.path.join(self.rocksdb_dir, "meta_db"),
                           self._install_backend(DBOptions()))
        # db_name -> message-ingestion watcher (kafka-equivalent stack)
        self._ingestion: Dict[str, object] = {}
        self._stats = Stats.get()

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    async def _run(self, fn: Callable, *args):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._executor, fn, *args)

    def _db_path(self, db_name: str) -> str:
        return os.path.join(self.rocksdb_dir, db_name)

    def _options_for(self, db_name: str) -> DBOptions:
        try:
            segment = db_name_to_segment(db_name)
        except ValueError:
            segment = db_name
        return self._install_backend(self._options_gen(segment))

    def _install_backend(self, options: DBOptions) -> DBOptions:
        """The card's compaction service registers behind the engine's
        CompactionBackend seam for every db this admin hosts; a host node
        names the native backend, so no db falls to the engine's default
        (the card) by omission."""
        if self._gpu_compaction:
            GpuCompactionService.install_on_options(options, self.device)
        elif options.compaction_backend is None:
            options.compaction_backend = NativeCompactionBackend()
        return options

    def _get_app_db(self, db_name: str) -> ApplicationDB:
        app_db = self.db_manager.get_db(db_name)
        if app_db is None:
            raise RpcApplicationError(DB_NOT_FOUND, db_name)
        return app_db

    def set_leader_resolver(self, resolver: Optional[LeaderResolver]) -> None:
        """Install (or replace) the data-plane leader resolver. Takes
        effect for every hosted DB, including those already open — the
        per-DB resolver closure reads this attribute at resolve time."""
        self._leader_resolver = resolver

    def get_meta_data(self, db_name: str) -> DBMetaData:
        """admin_handler.cpp:556-576."""
        raw = self._meta_db.get(db_name.encode("utf-8"))
        return DBMetaData.decode(db_name, raw)

    def write_meta_data(
        self, db_name: str, s3_bucket: str = "", s3_path: str = "",
        last_kafka_msg_timestamp_ms: Optional[int] = None,
        retain_lo: Optional[str] = None, retain_hi: Optional[str] = None,
    ) -> None:
        """admin_handler.cpp:578-595. ``retain_lo``/``retain_hi``: None
        keeps the stored bounds (the common metadata update must never
        erase a split child's trim range)."""
        meta = self.get_meta_data(db_name)
        meta.s3_bucket = s3_bucket
        meta.s3_path = s3_path
        if last_kafka_msg_timestamp_ms is not None:
            meta.last_kafka_msg_timestamp_ms = last_kafka_msg_timestamp_ms
        if retain_lo is not None:
            meta.retain_lo = retain_lo
        if retain_hi is not None:
            meta.retain_hi = retain_hi
        self._meta_db.put(db_name.encode("utf-8"), meta.encode())

    def clear_meta_data(self, db_name: str) -> None:
        self._meta_db.delete(db_name.encode("utf-8"))

    def _store(self, uri: str):
        return build_object_store(uri, self._store_rate_limit)

    def _open_app_db(
        self,
        db_name: str,
        role: ReplicaRole,
        upstream: Optional[Tuple[str, int]],
        overwrite: bool = False,
        replication_mode: Optional[int] = None,
        epoch: int = 0,
    ) -> ApplicationDB:
        path = self._db_path(db_name)
        if overwrite:
            destroy_db(path)
        options = self._options_for(db_name)
        # a split child's retain range is durable identity (DBMetaData),
        # not dbconfig: reapply it on every reopen so scheduled
        # compactions keep trimming the inherited other-half keys
        meta = self.get_meta_data(db_name)
        if meta.retain_lo or meta.retain_hi:
            options.retain_lo = meta.retain_lo or None
            options.retain_hi = meta.retain_hi or None
        db = DB(path, options)
        app_db = ApplicationDB(
            db_name, db, role,
            replicator=self.replicator,
            upstream_addr=upstream,
            replication_mode=replication_mode,
            epoch=epoch,
            # late-bound: set_leader_resolver (called once the participant
            # exists — it is constructed after the handler) must reach DBs
            # that are already open, so the wrapper defers the lookup
            leader_resolver=lambda name: (
                self._leader_resolver(name) if self._leader_resolver
                else None
            ),
        )
        if not self.db_manager.add_db(db_name, app_db):
            app_db.close()
            raise RpcApplicationError(DB_ALREADY_EXISTS, db_name)
        return app_db

    # ------------------------------------------------------------------
    # RPC: liveness / introspection
    # ------------------------------------------------------------------

    async def handle_ping(self) -> dict:
        return {"ok": True, "timestamp_ms": int(time.time() * 1000)}

    async def handle_get_sequence_number(self, db_name: str = "") -> dict:
        app_db = self._get_app_db(db_name)
        return {"seq_num": app_db.latest_sequence_number()}

    async def handle_check_db(self, db_name: str = "") -> dict:
        """checkDB: seq + WAL/update recency info for rebuild decisions
        (needRebuildDB, LeaderFollowerStateModelFactory.java:469-479)."""
        app_db = self._get_app_db(db_name)

        def collect():
            seq = app_db.latest_sequence_number()
            last_ts = None
            # newest update timestamp from the WAL tail
            for _seq, raw in app_db.db.get_updates_since(max(1, seq)):
                from ..storage.records import decode_batch

                last_ts = decode_batch(raw).extract_timestamp_ms()
            wal_dir = os.path.join(app_db.db.path, "wal")
            oldest_wal_ts = None
            try:
                segs = sorted(os.listdir(wal_dir))
                if segs:
                    oldest_wal_ts = int(
                        os.path.getmtime(os.path.join(wal_dir, segs[0])) * 1000
                    )
            except OSError:
                pass
            rdb = app_db.replicated_db
            return {
                "seq_num": seq,
                "last_update_timestamp_ms": last_ts,
                "oldest_wal_timestamp_ms": oldest_wal_ts,
                # needRebuildDB's WAL-availability input: a rebuilding
                # peer below this seq cannot WAL-catch-up from us
                "oldest_wal_seq": app_db.db.oldest_wal_seq(),
                "db_size_bytes": app_db.db.approximate_disk_size(),
                "role": app_db.role.value,
                # live shard moves read these: the direct (coordinator-
                # less) mover mints its cutover epoch from the shard's
                # live one, and verifies the pause it armed
                "epoch": rdb.epoch if rdb is not None else 0,
                "write_paused": (rdb.write_paused
                                 if rdb is not None else False),
                # a leader that an inbound epoch fenced: the participant
                # reads it when the controller re-anoints this node at
                # the epoch that fenced it (state_models/leader_follower
                # ``reanoint_fenced``)
                "fenced": bool(rdb is not None and rdb.fenced),
                # a puller whose position predates its upstream's WAL:
                # the participant loop converts this into a snapshot
                # rebuild (pulling can never catch it up)
                "pull_stalled_wal_gap": bool(
                    rdb is not None
                    and getattr(rdb, "pull_stalled_wal_gap", False)),
                # a follower persistently AHEAD of its leader's commit
                # point: divergent suffix — the participant loop clears
                # + rejoins it (the follower analog of deposed resync)
                "pull_diverged": bool(
                    rdb is not None
                    and getattr(rdb, "pull_diverged", False)),
            }

        return await self._run(collect)

    # ------------------------------------------------------------------
    # RPC: lifecycle
    # ------------------------------------------------------------------

    async def handle_add_db(
        self,
        db_name: str = "",
        upstream_ip: str = "",
        upstream_port: int = 0,
        role: str = "FOLLOWER",
        overwrite: bool = False,
        replication_mode: Optional[int] = None,
        epoch: int = 0,
    ) -> dict:
        """addDB (admin_handler.cpp:597-694): open the db and register it
        with the replicator in the given role."""
        parsed = _parse_role(role)
        upstream = (upstream_ip, upstream_port) if upstream_ip else None
        if parsed in (ReplicaRole.FOLLOWER, ReplicaRole.OBSERVER) and not upstream:
            raise RpcApplicationError(INVALID_UPSTREAM, "follower requires upstream")

        def do():
            with self._db_admin_lock.locked(db_name):
                if self.db_manager.get_db(db_name) is not None:
                    raise RpcApplicationError(DB_ALREADY_EXISTS, db_name)
                self._open_app_db(db_name, parsed, upstream, overwrite,
                                  replication_mode=replication_mode,
                                  epoch=int(epoch))

        await self._run(do)
        return {}

    async def handle_close_db(self, db_name: str = "") -> dict:
        def do():
            with self._db_admin_lock.locked(db_name):
                if self.db_manager.remove_db(db_name) is None:
                    raise RpcApplicationError(DB_NOT_FOUND, db_name)

        await self._run(do)
        return {}

    async def handle_clear_db(
        self, db_name: str = "", reopen_db: bool = True
    ) -> dict:
        """clearDB: destroy data; optionally reopen fresh with the same
        role/upstream (admin_handler.cpp clearDB + reopen pattern)."""

        def do():
            with self._db_admin_lock.locked(db_name):
                app_db = self.db_manager.get_db(db_name)
                role, upstream, mode, epoch = ReplicaRole.NOOP, None, None, 0
                if app_db is not None:
                    role = app_db.role
                    mode = _current_mode(app_db)
                    epoch = _current_epoch(app_db)
                    if app_db.replicated_db is not None:
                        upstream = app_db.replicated_db.upstream_addr
                    self.db_manager.remove_db(db_name)
                destroy_db(self._db_path(db_name))
                self.clear_meta_data(db_name)
                if reopen_db:
                    self._open_app_db(db_name, role, upstream,
                                      replication_mode=mode, epoch=epoch)

        await self._run(do)
        return {}

    async def handle_change_db_role_and_upstream(
        self,
        db_name: str = "",
        new_role: str = "FOLLOWER",
        upstream_ip: str = "",
        upstream_port: int = 0,
        epoch: int = 0,
    ) -> dict:
        """changeDBRoleAndUpStream (admin_handler.cpp:1438): implemented as
        removeDB + addDB with the new role, keeping the storage.
        ``epoch`` is the controller's assignment epoch for the shard;
        max-merged with the live epoch so legacy callers (epoch 0) can
        never regress the fencing token."""
        parsed = _parse_role(new_role)
        upstream = (upstream_ip, upstream_port) if upstream_ip else None
        if parsed in (ReplicaRole.FOLLOWER, ReplicaRole.OBSERVER) and not upstream:
            raise RpcApplicationError(INVALID_UPSTREAM, "follower requires upstream")

        def do():
            with self._db_admin_lock.locked(db_name):
                app_db = self.db_manager.get_db(db_name)
                if app_db is None:
                    raise RpcApplicationError(DB_NOT_FOUND, db_name)
                # the ack mode survives role changes (an explicit addDB mode
                # must not silently revert to the dbconfig default)
                mode = _current_mode(app_db)
                new_epoch = max(int(epoch), _current_epoch(app_db))
                self.db_manager.remove_db(db_name)  # closes storage + repl
                self._open_app_db(db_name, parsed, upstream,
                                  replication_mode=mode, epoch=new_epoch)

        await self._run(do)
        return {}

    async def handle_rename_db(
        self,
        db_name: str = "",
        new_db_name: str = "",
        new_role: str = "",
        upstream_ip: str = "",
        upstream_port: int = 0,
        epoch: int = 0,
        retain_lo: str = "",
        retain_hi: str = "",
    ) -> dict:
        """renameDB — the shard-split cutover primitive: close the db,
        rename its storage directory, reopen under the new name with the
        given role/upstream/epoch (role empty = keep the current one).
        A range-split child starts life as a full copy of its parent
        under the PARENT's name (so the WAL-tail pull addresses match);
        at cutover this flips the copy to its child identity in one
        local, idempotent step.

        ``retain_lo``/``retain_hi`` (hex, [lo, hi)) record the child's
        key range in its durable metadata: every reopen folds the bounds
        into the engine options, and scheduled compactions then DROP the
        inherited other-half keys (DBOptions.retain_lo — the split-trim
        path) instead of carrying dead bytes forever.

        Idempotent for a resumed driver: if the new name is already
        registered and the old is gone, the rename already happened —
        succeed. If the process crashed between the directory rename and
        the reopen, the orphaned directory is adopted under the new
        name. Both per-db admin locks are taken in sorted-name order (a
        concurrent opposite-direction rename must not deadlock)."""
        if not new_db_name or new_db_name == db_name:
            raise RpcApplicationError(DB_ADMIN_ERROR,
                                      f"bad rename target {new_db_name!r}")
        parsed = _parse_role(new_role) if new_role else None
        upstream = (upstream_ip, upstream_port) if upstream_ip else None

        def do():
            first, second = sorted((db_name, new_db_name))
            with self._db_admin_lock.locked(first), \
                    self._db_admin_lock.locked(second):
                if self.db_manager.get_db(new_db_name) is not None:
                    if self.db_manager.get_db(db_name) is None:
                        return  # resumed after a completed rename
                    raise RpcApplicationError(DB_ALREADY_EXISTS, new_db_name)
                old_path = self._db_path(db_name)
                new_path = self._db_path(new_db_name)
                app_db = self.db_manager.get_db(db_name)
                role = parsed
                mode: Optional[int] = None
                live_epoch = 0
                up = upstream
                if app_db is not None:
                    if role is None:
                        role = app_db.role
                    mode = _current_mode(app_db)
                    live_epoch = _current_epoch(app_db)
                    if (up is None and app_db.replicated_db is not None
                            and role in (ReplicaRole.FOLLOWER,
                                         ReplicaRole.OBSERVER)):
                        up = app_db.replicated_db.upstream_addr
                    self.db_manager.remove_db(db_name)  # closes storage
                elif not os.path.exists(old_path):
                    # crashed between rename and reopen: adopt the dir
                    if not os.path.exists(new_path):
                        raise RpcApplicationError(DB_NOT_FOUND, db_name)
                if os.path.exists(old_path):
                    if os.path.exists(new_path):
                        # leftover from a crashed earlier attempt — the
                        # live data is still under the OLD name
                        destroy_db(new_path)
                    os.rename(old_path, new_path)
                if role is None:
                    raise RpcApplicationError(
                        INVALID_DB_ROLE, "rename of unregistered db "
                        "requires an explicit new_role")
                if role in (ReplicaRole.FOLLOWER, ReplicaRole.OBSERVER) \
                        and up is None:
                    raise RpcApplicationError(
                        INVALID_UPSTREAM, "follower requires upstream")
                # metadata BEFORE reopen: _open_app_db reads the retain
                # range out of the new name's metadata record
                meta = self.get_meta_data(db_name)
                self.write_meta_data(new_db_name, meta.s3_bucket,
                                     meta.s3_path,
                                     meta.last_kafka_msg_timestamp_ms,
                                     retain_lo=retain_lo or None,
                                     retain_hi=retain_hi or None)
                self.clear_meta_data(db_name)
                self._open_app_db(new_db_name, role, up,
                                  replication_mode=mode,
                                  epoch=max(int(epoch), live_epoch))

        await self._run(do)
        return {}

    async def handle_set_tenant_quota(
        self, tenant: str = "", ops_per_sec: float = 0.0,
        bytes_per_sec: float = 0.0,
    ) -> dict:
        """Runtime-mutable per-tenant admission quotas: override THIS
        node's token-bucket rates for one tenant without a restart
        (quotas were otherwise static per-node env). Zero/zero
        clears the override back to the env defaults."""
        from ..rpc.admission import TenantAdmission, sanitize_tenant

        name = sanitize_tenant(tenant)
        TenantAdmission.get().set_quota(
            name, float(ops_per_sec), float(bytes_per_sec))
        return {"tenant": name, "ops_per_sec": float(ops_per_sec),
                "bytes_per_sec": float(bytes_per_sec)}

    async def handle_check_pull_stall(self, db_name: str = "") -> dict:
        """Flags-only sibling of check_db for the participant's 5s
        stall-heal probe: two booleans read straight off the
        ReplicatedDB, no disk I/O (check_db walks the WAL dir and the
        db directory — too heavy to run per follower shard per tick)."""
        app_db = self._get_app_db(db_name)
        rdb = app_db.replicated_db
        return {
            "role": app_db.role.value,
            "pull_stalled_wal_gap": bool(
                rdb is not None
                and getattr(rdb, "pull_stalled_wal_gap", False)),
            "pull_diverged": bool(
                rdb is not None
                and getattr(rdb, "pull_diverged", False)),
        }

    async def handle_pause_db_writes(
        self, db_name: str = "", duration_ms: float = 0.0
    ) -> dict:
        """Arm (or clear, duration_ms<=0) the shard's cutover write
        pause: NEW leader writes raise WRITE_PAUSED until the window
        expires, bounding the WAL tail a live shard move must drain.
        Auto-expiring by construction — a mover that dies after arming
        this leaves the shard serving again within the window."""

        def do():
            rdb = self._get_app_db(db_name).replicated_db
            if rdb is None:
                raise RpcApplicationError(
                    DB_ADMIN_ERROR, f"{db_name} is not replicated")
            rdb.pause_writes(float(duration_ms))
            return rdb.write_paused

        return {"paused": await self._run(do)}

    async def handle_set_db_epoch(
        self, db_name: str = "", epoch: int = 0
    ) -> dict:
        """Raise a hosted db's fencing epoch WITHOUT a role transition —
        the sticky-leader path: the controller re-stamped the assignment
        epoch (e.g. after a ledger rebuild) while the leader stays put,
        and the leader must adopt it before its followers (which learned
        the new epoch from their repoints) fence it as deposed. Epochs
        only move forward; a lower value is a no-op."""

        def do():
            # under the per-db admin lock like every other db mutation:
            # an adopt racing a concurrent reopen must not land on a
            # discarded ReplicatedDB and silently vanish
            with self._db_admin_lock.locked(db_name):
                rdb = self._get_app_db(db_name).replicated_db
                if rdb is not None:
                    rdb.adopt_epoch(int(epoch))
                return rdb.epoch if rdb is not None else 0

        return {"epoch": await self._run(do)}

    # ------------------------------------------------------------------
    # RPC: backup / restore
    # ------------------------------------------------------------------

    async def handle_backup_db(self, db_name: str = "", hdfs_backup_dir: str = "") -> dict:
        """backupDB — the reference's HDFS path; here any store URI
        (admin_handler.cpp:696-766)."""
        return await self._backup(db_name, hdfs_backup_dir, "")

    async def handle_restore_db(
        self, db_name: str = "", hdfs_backup_dir: str = "",
        upstream_ip: str = "", upstream_port: int = 0, to_seq: int = 0,
    ) -> dict:
        return await self._restore(db_name, hdfs_backup_dir, "",
                                   upstream_ip, upstream_port, to_seq)

    async def handle_backup_db_to_s3(
        self, db_name: str = "", s3_bucket: str = "", s3_backup_dir: str = "",
        limit_mbs: int = 0,
    ) -> dict:
        """backupDBToS3 (admin_handler.cpp:996-1129 checkpoint path)."""
        return await self._backup(db_name, s3_bucket, s3_backup_dir)

    async def handle_restore_db_from_s3(
        self, db_name: str = "", s3_bucket: str = "", s3_backup_dir: str = "",
        upstream_ip: str = "", upstream_port: int = 0, limit_mbs: int = 0,
        to_seq: int = 0, role: str = "",
    ) -> dict:
        """restoreDBFromS3 + PITR extension: ``to_seq > 0`` replays the
        backup's WAL archive (<prefix>/wal, written by the backup
        manager's archive_wal rider) over the checkpoint up to that
        sequence point. ``role`` overrides the post-restore registration
        role — a live shard move restores its target as an OBSERVER
        (WAL-tail catch-up without joining the semi-sync ack set: a
        write must never be acked solely by a half-built replica that an
        aborted move will sweep)."""
        return await self._restore(db_name, s3_bucket, s3_backup_dir,
                                   upstream_ip, upstream_port, to_seq,
                                   role=role)

    async def _backup(self, db_name: str, store_uri: str, sub_path: str) -> dict:
        app_db = self._get_app_db(db_name)
        store = self._store(store_uri)
        prefix = sub_path or db_name
        # run_in_executor drops contextvars: carry the rpc.server span's
        # context across the hop so the backup phases join the RPC trace.
        # always=True: control-plane ops are rare enough to trace
        # unconditionally — the 45 s backup round trip gets a per-phase
        # breakdown (checkpoint → upload batches → dbmeta) every time.
        tctx = wire_context()

        def do():
            # The per-db admin lock covers ONLY the checkpoint (fast,
            # hardlink-based): the upload — the 45 s part — runs outside
            # it, off the checkpoint's immutable hardlinked file set, so
            # a backup no longer blocks addDB/closeDB/ingest on the same
            # db for its whole duration (rstpu-check blocking-under-lock;
            # same narrowing as the ingest pipeline).
            with Timer("admin.backup_ms"), \
                    start_span("admin.backup_db", always=True, remote=tctx,
                               db=db_name):
                meta = self.get_meta_data(db_name)
                # stage INSIDE rocksdb_dir: same filesystem as the db,
                # so the checkpoint's os.link fast path works — on /tmp
                # an EXDEV fallback would copy every SST under the DB
                # lock, inverting the narrowing this path exists for
                tmp = tempfile.mkdtemp(
                    dir=self.rocksdb_dir, prefix=f".backup-{db_name}-")
                ckpt_dir = os.path.join(tmp, "ckpt")
                try:
                    with self._db_admin_lock.locked(db_name), \
                            start_span("admin.backup.checkpoint"):
                        # re-fetch under the lock: a closeDB+addDB that
                        # raced the pre-lock resolution must checkpoint
                        # the LIVE instance, not a closed stale handle
                        live = self.db_manager.get_db(db_name)
                        if live is None:
                            raise RpcApplicationError(DB_NOT_FOUND, db_name)
                        ckpt_seq = live.db.checkpoint(ckpt_dir)
                    return backup_mod.upload_checkpoint(
                        live.db.path, store, prefix, ckpt_dir, ckpt_seq,
                        meta={"last_kafka_msg_timestamp_ms":
                              meta.last_kafka_msg_timestamp_ms},
                    )
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)

        dbmeta = await self._run(do)
        return {"seq": dbmeta["seq"], "timestamp_ms": dbmeta["timestamp_ms"]}

    async def _restore(
        self, db_name: str, store_uri: str, sub_path: str,
        upstream_ip: str, upstream_port: int, to_seq: int = 0,
        role: str = "",
    ) -> dict:
        store = self._store(store_uri)
        prefix = sub_path or db_name
        upstream = (upstream_ip, upstream_port) if upstream_ip else None
        if role:
            role = _parse_role(role)
            if role in (ReplicaRole.FOLLOWER, ReplicaRole.OBSERVER) \
                    and not upstream:
                raise RpcApplicationError(
                    INVALID_UPSTREAM, f"{role.value} requires upstream")
        else:
            role = ReplicaRole.FOLLOWER if upstream else ReplicaRole.NOOP
        tctx = wire_context()

        def do():
            with Timer("admin.restore_ms"), \
                    start_span("admin.restore_db", always=True, remote=tctx,
                               db=db_name, to_seq=to_seq):
                if to_seq > 0:
                    # PITR: checkpoint download + WAL-archive replay must
                    # materialize into the final path in one step; rare
                    # enough to stay fully serialized
                    from ..storage.archive import restore_db_to_seq

                    with self._db_admin_lock.locked(db_name):
                        if self.db_manager.get_db(db_name) is not None:
                            self.db_manager.remove_db(db_name)
                        destroy_db(self._db_path(db_name))
                        # the replay DB takes this node's backend: never
                        # the engine's default (the card) on a host node
                        dbmeta = restore_db_to_seq(
                            store, prefix, f"{prefix}/wal",
                            self._db_path(db_name), to_seq=to_seq,
                            options=self._install_backend(DBOptions()))
                        self._finish_restore(db_name, role, upstream, dbmeta)
                    return dbmeta
                # Plain restore: the download — the long part — runs into
                # a staging dir OUTSIDE the per-db admin lock, so a
                # restore no longer blocks same-db admin ops for its
                # whole transfer (rstpu-check blocking-under-lock); the
                # lock is taken only for the destroy→rename→reopen flip.
                # staging parent is unique per attempt (concurrent
                # restores of one db each download privately; last one
                # to take the lock wins the flip, as before) and lives
                # in rocksdb_dir so the rename is same-filesystem
                tmp_parent = tempfile.mkdtemp(
                    dir=self.rocksdb_dir, prefix=f".restore-{db_name}-")
                staging = os.path.join(tmp_parent, "db")
                try:
                    # the bulk transfer rides the SAME admission gate as
                    # SST loads (IngestGate): a drain-node restoring N
                    # moved shards onto this host pipelines its
                    # downloads boundedly instead of running N-wide.
                    # Restores QUEUE (enter_wait) rather than bounce —
                    # but the wait budget stays WELL below the caller's
                    # 600s RPC deadline: a slot that frees at t=550s
                    # would start a download with no client budget
                    # left, orphaning a server-side restore the mover
                    # already gave up on (and later re-registering a
                    # replica no move record points at)
                    if not self._ingest_gate.enter_wait(timeout=120.0):
                        raise RpcApplicationError(
                            TOO_MANY_REQUESTS,
                            f"{self._ingest_gate.in_flight} bulk loads in "
                            f"flight (max {self._ingest_gate.capacity})")
                    try:
                        dbmeta = backup_mod.restore_db(store, prefix,
                                                       staging)
                    finally:
                        self._ingest_gate.exit()
                    with self._db_admin_lock.locked(db_name):
                        if self.db_manager.get_db(db_name) is not None:
                            self.db_manager.remove_db(db_name)
                        destroy_db(self._db_path(db_name))
                        os.rename(staging, self._db_path(db_name))
                        self._finish_restore(db_name, role, upstream, dbmeta)
                finally:
                    shutil.rmtree(tmp_parent, ignore_errors=True)
                return dbmeta

        dbmeta = await self._run(do)
        # PITR restores report the seq actually reached after WAL replay,
        # not the checkpoint's
        return {"seq": dbmeta.get("restored_seq", dbmeta["seq"])}

    def _finish_restore(self, db_name, role, upstream, dbmeta) -> None:
        """Post-materialization half of a restore, under the per-db
        admin lock: register the reopened db + persist its kafka meta."""
        self._open_app_db(db_name, role, upstream)
        ts = dbmeta.get("last_kafka_msg_timestamp_ms")
        if ts:
            self.write_meta_data(db_name, last_kafka_msg_timestamp_ms=ts)

    # ------------------------------------------------------------------
    # RPC: SST bulk ingest — the north-star workload (§3.3)
    # ------------------------------------------------------------------

    async def handle_add_s3_sst_files_to_db(
        self,
        db_name: str = "",
        s3_bucket: str = "",
        s3_path: str = "",
        ingest_behind: bool = False,
        allow_overlapping_keys: bool = True,
        s3_download_limit_mb: int = 64,
        compact_db_after_load: bool = False,
    ) -> dict:
        """addS3SstFilesToDB (admin_handler.cpp:1635-1850), pipelined.

        Call-stack parity per SURVEY §3.3, with the per-db admin lock
        NARROWED: admission (idempotency + ingest-behind
        validation) takes the lock briefly, the download + SST validation
        run OUTSIDE it under the global ingest gate, then the lock is
        re-taken — with a close/idempotency staleness re-check — for the
        engine ingest + meta write only. N shards therefore download
        while others ingest; the post-load compaction coalesces across
        shards in the BatchCompactor."""
        store = self._store(s3_bucket)
        tctx = wire_context()

        def do():
            with start_span("admin.add_s3_sst", always=True, remote=tctx,
                            db=db_name, path=s3_path) as sp:
                return self._add_s3_sst(
                    sp, db_name, store, s3_bucket, s3_path, ingest_behind,
                    allow_overlapping_keys, compact_db_after_load,
                )

        return await self._run(do)

    def _add_s3_sst(
        self, sp, db_name, store, s3_bucket, s3_path,
        ingest_behind, allow_overlapping_keys, compact_after,
    ) -> dict:
        # -- admission: cheap checks only under the per-db lock ------------
        with self._db_admin_lock.locked(db_name):
            app_db = self._get_app_db(db_name)
            # idempotency via meta_db (:1655-1667)
            meta = self.get_meta_data(db_name)
            if meta.s3_bucket == s3_bucket and meta.s3_path == s3_path:
                return {"skipped": True}
            self._check_ingest_behind(app_db, ingest_behind)
        # concurrency gate (:1692-1706) — bounds the download/validate
        # stage globally, NOT under any db lock
        if not self._ingest_gate.try_enter():
            raise RpcApplicationError(
                TOO_MANY_REQUESTS,
                f"{self._ingest_gate.in_flight} ingests in flight "
                f"(max {self._ingest_gate.capacity})",
            )
        try:
            return self._do_ingest(
                sp, db_name, store, s3_bucket, s3_path,
                ingest_behind, allow_overlapping_keys, compact_after,
            )
        finally:
            self._ingest_gate.exit()

    @staticmethod
    def _check_ingest_behind(app_db: ApplicationDB, ingest_behind: bool):
        if not ingest_behind:
            return
        if not app_db.db.options.allow_ingest_behind:
            raise RpcApplicationError(
                DB_ADMIN_ERROR, "db not opened with allow_ingest_behind"
            )
        if not app_db.db_lmax_empty():
            raise RpcApplicationError(
                DB_ADMIN_ERROR, "bottom level not empty"
            )

    def _do_ingest(
        self, sp, db_name, store, s3_bucket, s3_path,
        ingest_behind, allow_overlapping_keys, compact_after,
    ) -> dict:
        tmp = tempfile.mkdtemp(prefix=f"rstpu-ingest-{db_name}-")
        try:
            # -- download + validate: OUTSIDE the per-db admin lock --------
            with Timer("admin.sst_download_ms"), \
                    start_span("admin.ingest.download"):
                local_files = store.get_objects(  # :1724-1726
                    s3_path, tmp,
                    direct_io=bool(FLAGS.get("s3_direct_io")))
            sst_files = [p for p in local_files if p.endswith(".tsst")]
            if not sst_files:
                raise RpcApplicationError(DB_ADMIN_ERROR, f"no .tsst under {s3_path}")
            with start_span("admin.ingest.validate", files=len(sst_files)):
                from ..storage.sst import SSTReader

                for path in sst_files:
                    try:
                        SSTReader(path).close()  # format/checksum probe
                    except Exception as e:
                        raise RpcApplicationError(
                            DB_ADMIN_ERROR, f"bad SST {os.path.basename(path)}: {e}"
                        ) from e
                    # Break object-store download hardlinks HERE, outside
                    # every lock: the engine's global-seqno footer rewrite
                    # must own the inode, and its own nlink guard would
                    # otherwise pay this copy under the DB lock.
                    if os.stat(path).st_nlink > 1:
                        tmp_copy = path + ".unlink"
                        shutil.copyfile(path, tmp_copy)
                        os.replace(tmp_copy, path)
            # -- ingest + meta: re-take the per-db lock, with staleness
            #    re-checks (the db and its meta may have changed while we
            #    were downloading without the lock) ------------------------
            with self._db_admin_lock.locked(db_name):
                app_db = self.db_manager.get_db(db_name)
                if app_db is None:
                    # closeDB won the race: surface DB_NOT_FOUND, never
                    # ingest into a closed/stale handle
                    raise RpcApplicationError(DB_NOT_FOUND, db_name)
                meta = self.get_meta_data(db_name)
                if meta.s3_bucket == s3_bucket and meta.s3_path == s3_path:
                    # a concurrent ingest of the same set won: idempotent
                    return {"skipped": True}
                self._check_ingest_behind(app_db, ingest_behind)
                target_db = app_db
                if not allow_overlapping_keys and not ingest_behind:
                    # full replace: close → destroy → reopen → re-add
                    # (:1774-1817)
                    role = app_db.role
                    mode = _current_mode(app_db)
                    epoch = _current_epoch(app_db)
                    upstream = (
                        app_db.replicated_db.upstream_addr
                        if app_db.replicated_db else None
                    )
                    self.db_manager.remove_db(db_name)
                    destroy_db(self._db_path(db_name))
                    target_db = self._open_app_db(db_name, role, upstream,
                                                  replication_mode=mode,
                                                  epoch=epoch)
                fp.hit("admin.ingest.engine")
                with Timer("admin.sst_ingest_ms"), \
                        start_span("admin.ingest.ingest", files=len(sst_files)):
                    target_db.db.ingest_external_file(
                        sst_files,
                        move_files=True,
                        allow_global_seqno=True,
                        ingest_behind=ingest_behind,
                        validated=True,  # probed in the pre-lock stage
                    )  # :1819-1827
                # the crash-consistency seam the chaos harness leans on:
                # a fault HERE must leave the DB fully post-ingest with
                # meta still pre-ingest (retryable), never meta-without-
                # data (tests/test_failpoints.py ingest invariants)
                fp.hit("admin.ingest.meta")
                with start_span("admin.ingest.meta"):
                    self.write_meta_data(db_name, s3_bucket, s3_path)  # :1836
            # -- post-load compaction: outside the admin lock, batched
            #    across concurrently-loading shards ------------------------
            if compact_after:
                with Timer("admin.post_ingest_compact_ms"), \
                        start_span("admin.ingest.compact") as csp:
                    try:
                        batched_with = self._batch_compactor.compact(
                            db_name, target_db.db)  # :1845-1850
                        csp.annotate(batch=batched_with)
                    except StorageError:
                        # compaction is advisory: a closeDB/clearDB that
                        # raced in after our ingest+meta committed tears
                        # the db down mid-compact — the load itself
                        # succeeded and a closed db needs no compaction,
                        # so don't fail the RPC for it
                        if self.db_manager.get_db(db_name) is not None:
                            raise
                        csp.annotate(skipped="db closed during compact")
                        log.info("%s closed during post-load compact; "
                                 "ingest already committed", db_name)
            sp.annotate(files=len(sst_files))
            self._stats.incr("admin.sst_files_ingested", len(sst_files))
            return {"ingested_files": len(sst_files)}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------------------------
    # RPC: options / compaction
    # ------------------------------------------------------------------

    async def handle_set_db_options(
        self, db_name: str = "", options: Optional[Dict[str, Any]] = None
    ) -> dict:
        """setDBOptions (admin_handler.cpp:2134-2158)."""
        def do():
            with self._db_admin_lock.locked(db_name):
                app_db = self._get_app_db(db_name)
                try:
                    app_db.db.set_options(options or {})
                except StorageError as e:
                    raise RpcApplicationError(DB_ADMIN_ERROR, str(e)) from e

        await self._run(do)
        return {}

    async def handle_compact_db(self, db_name: str = "") -> dict:
        tctx = wire_context()

        def do():
            # per-db lock: a concurrent clearDB/closeDB must not destroy the
            # directory under a running compaction
            with self._db_admin_lock.locked(db_name):
                app_db = self._get_app_db(db_name)
                with Timer("admin.compact_ms"), \
                        start_span("admin.compact_db", always=True,
                                   remote=tctx, db=db_name):
                    app_db.compact_range()

        await self._run(do)
        return {}

    # ------------------------------------------------------------------
    # RPC: message ingestion (kafka-equivalent; wired by the queue stack)
    # ------------------------------------------------------------------

    async def handle_start_message_ingestion(
        self, db_name: str = "", topic_name: str = "",
        kafka_broker_serverset_path: str = "", replay_timestamp_ms: int = 0,
    ) -> dict:
        from ..kafka.ingestion import start_ingestion  # lazy: optional stack

        app_db = self._get_app_db(db_name)
        # Reserve the slot before any await (atomic on the event loop): two
        # concurrent starts must not both pass the check and leak a watcher.
        if db_name in self._ingestion:
            raise RpcApplicationError(DB_ADMIN_ERROR, f"{db_name} already ingesting")
        self._ingestion[db_name] = _RESERVED
        try:
            meta = self.get_meta_data(db_name)
            start_ts = max(replay_timestamp_ms, meta.last_kafka_msg_timestamp_ms)
            watcher = await self._run(
                start_ingestion, self, db_name, app_db, topic_name,
                kafka_broker_serverset_path, start_ts,
            )
        except BaseException:
            if self._ingestion.get(db_name) is _RESERVED:
                del self._ingestion[db_name]
            raise
        self._ingestion[db_name] = watcher
        return {}

    async def handle_stop_message_ingestion(self, db_name: str = "") -> dict:
        watcher = self._ingestion.get(db_name)
        if watcher is None:
            raise RpcApplicationError(DB_NOT_FOUND, f"{db_name} not ingesting")
        if watcher is _RESERVED:
            raise RpcApplicationError(DB_ADMIN_ERROR, f"{db_name} still starting")
        del self._ingestion[db_name]
        await self._run(watcher.stop)
        return {}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def storage_info_text(self) -> str:
        """/storage_info.txt endpoint body (reference /rocksdb_info.txt)."""
        return self.db_manager.dump_db_stats_as_text()

    def close(self) -> None:
        for name in self.db_manager.get_all_db_names():
            self.db_manager.remove_db(name)
        for watcher in self._ingestion.values():
            try:
                watcher.stop()
            except Exception:
                pass
        self._ingestion.clear()
        self._meta_db.close()
        self._batch_compactor.close()
        self._executor.shutdown(wait=False)
