"""ApplicationDBBackupManager: continuous incremental backups.
(The port's copy of ``rocksplicator_tpu/admin/backup_manager.py``.)

Reference: rocksdb_admin/application_db_backup_manager.{h,cpp} — optional
background thread periodically checkpoint-backing-up every hosted DB to the
object store (flag ``enable_async_incremental_backup_dbs``,
admin_handler.cpp:467-470).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..observability.span import start_span
from ..storage import backup as backup_mod
from ..utils.objectstore import ObjectStore
from ..utils.stats import Stats
from .db_manager import ApplicationDBManager

log = logging.getLogger(__name__)


class ApplicationDBBackupManager:
    def __init__(
        self,
        db_manager: ApplicationDBManager,
        store: ObjectStore,
        prefix: str = "incremental_backups",
        interval_sec: float = 300.0,
        parallelism: int = 8,
        archive_wal: bool = False,
    ):
        self._db_manager = db_manager
        self._store = store
        self._prefix = prefix.rstrip("/")
        self._interval = interval_sec
        self._parallelism = parallelism
        # WAL archival rider (storage/archive.py): each backup pass also
        # ships every live WAL segment under <prefix>/<db>/wal and
        # installs the archiver as the DB's TTL-purge sink, so restores
        # can replay to ANY point since the oldest checkpoint
        # (restore_db_to_seq) — the BackupEngine-chain parity.
        self._archive_wal = archive_wal
        self._archivers: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _archiver(self, db_name: str, db):
        """One archiver per (db, incarnation). A destroyed+recreated DB
        reuses WAL segment names with NEW content — a fresh incarnation
        gets a fresh archive prefix (recorded in each backup's dbmeta as
        ``wal_prefix``), so stale same-named segments can neither be
        skipped as already-shipped nor mixed into a later replay."""
        from ..storage.archive import WalArchiver

        incarnation = getattr(db, "_incarnation", "0")
        key = (db_name, incarnation)
        arch = self._archivers.get(key)
        if arch is None:
            # drop prior-incarnation entries for this db (a clear/restore
            # cycle would otherwise leak one archiver per recreate)
            for stale in [k for k in self._archivers if k[0] == db_name]:
                del self._archivers[stale]
            arch = WalArchiver(
                self._store,
                f"{self._prefix}/{db_name}/wal-{incarnation}")
            self._archivers[key] = arch
        return arch

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="backup-manager", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def backup_all_dbs(self) -> int:
        """One pass over every hosted DB (backupAllDBsToS3). Returns the
        number successfully backed up."""
        ok = 0
        for name in self._db_manager.get_all_db_names():
            app_db = self._db_manager.get_db(name)
            if app_db is None:
                continue
            try:
                # one always-sampled trace per (db, pass): the incremental
                # backup inherits the same checkpoint→upload breakdown as
                # the admin backup_db path
                with start_span("backup_manager.backup", always=True,
                                db=name):
                    self._backup_one(name, app_db)
                ok += 1
                Stats.get().incr("backup_manager.backups_ok")
            except Exception:
                Stats.get().incr("backup_manager.backups_failed")
                log.exception("incremental backup failed for %s", name)
        return ok

    def _backup_one(self, name: str, app_db) -> None:
        meta = None
        if self._archive_wal:
            # Install the purge sink BEFORE the checkpoint upload:
            # a long upload overlaps live writes, and any WAL
            # segment the engine purges during it must hit the
            # archive or PITR into that range is lost forever.
            # (One shared archiver per DB: its mutex serializes
            # the purge-time sink against this pass's shipping.)
            arch = self._archiver(name, app_db.db)
            if app_db.db.options.wal_archive_sink is None:
                app_db.db.options.wal_archive_sink = arch.sink
            meta = {"wal_prefix": arch.prefix}
        backup_mod.backup_db(
            app_db.db, self._store, f"{self._prefix}/{name}",
            parallelism=self._parallelism, incremental=True,
            meta=meta,
        )
        if self._archive_wal:
            with start_span("backup.wal_archive"):
                self._archiver(name, app_db.db).archive_live(app_db.db)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.backup_all_dbs()
