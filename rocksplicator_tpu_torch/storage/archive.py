"""WAL archival + point-in-time restore (PITR).
(The port's copy of ``rocksplicator_tpu/storage/archive.py``.)

Reference seam: the admin plane's incremental BackupEngine chains plus
the 1h WAL TTL feeding replication (admin_handler.cpp backup paths;
performance.cpp's WAL-TTL setup). The reference can rebuild any point
covered by a backup chain; here the same capability is checkpoint +
archived-WAL replay:

- ``WalArchiver.sink`` is handed to ``DBOptions.wal_archive_sink`` (or
  directly to ``wal.purge_obsolete``): every sealed WAL segment is
  uploaded to the object store BEFORE its TTL deletion, keyed by its
  first sequence number (the segment file name already encodes it).
- ``restore_db_to_seq`` downloads a checkpoint backup (storage.backup),
  then replays archived + still-live WAL batches on top, stopping at
  ``to_seq`` — restoring the DB to any historical sequence point that
  is >= the checkpoint's seq.

Archive layout under ``<prefix>/``: the segment files verbatim
(``wal-<first_seq:020d>.log``) — the archive directory IS a valid WAL
directory, so ``wal.iter_updates`` replays it unchanged once fetched.

Upgrade note: dbmeta written by the backup manager records its own
``wal_prefix`` (per DB incarnation); older dbmeta without it falls back
to the caller-passed prefix. Restoring ACROSS that layout boundary
(checkpoint from before per-incarnation prefixes, WAL tail after) needs
the explicit wal_prefix of the segment range being replayed — a
``to_seq`` restore fails loudly (PITR gap / archive-ends-early) rather
than returning silently short.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Dict, Optional

from ..utils.objectstore import ObjectStore
from . import wal as wal_mod
from .engine import DB, DBOptions
from .errors import StorageError
from .records import decode_batch

log = logging.getLogger(__name__)


class WalArchiver:
    """Uploads sealed WAL segments to an object store. Idempotent per
    segment (a re-upload overwrites with identical bytes — segments are
    sealed, hence immutable, when the purge offers them)."""

    def __init__(self, store: ObjectStore, prefix: str):
        import threading

        self._store = store
        self._prefix = prefix.rstrip("/")
        # Serializes read+upload per archiver: without it, archive_live
        # could read a PARTIAL active segment, lose the CPU while the
        # purge ships the sealed full segment and deletes it, then land
        # its stale put last — permanently truncating archived history.
        # Engine purge and backup thread must share ONE archiver per DB.
        self._mutex = threading.Lock()
        # names shipped while SEALED (immutable): archive_live skips them
        # on later passes instead of re-uploading identical bytes.
        # Callers must use one archiver per DB INCARNATION (segment names
        # repeat with new content across a destroy+recreate — see
        # backup_manager._archiver).
        self._sealed_shipped: set = set()

    @property
    def prefix(self) -> str:
        return self._prefix

    def sink(self, path: str) -> None:
        """wal.purge_obsolete archive hook: ship one sealed segment."""
        key = f"{self._prefix}/{os.path.basename(path)}"
        with self._mutex:
            with open(path, "rb") as f:
                self._store.put_object_bytes(key, f.read())
            self._sealed_shipped.add(os.path.basename(path))
        log.info("archived WAL segment %s -> %s", path, key)

    def archive_live(self, db: DB) -> int:
        """Ship EVERY current WAL segment of an open DB — including the
        active one — so the archive covers history up to 'now' (rocksdb's
        backup copies live WAL the same way). Safe because uploads are
        whole-file and keyed by name: a growing active segment simply
        overwrites its archived copy with a longer version on the next
        call, and replay tolerates a torn tail on the last segment.
        Returns the number of segments shipped. Typical driver: the
        periodic backup thread (admin.backup_manager), right after its
        checkpoint upload."""
        n = 0
        segs = wal_mod._segments(db._wal_dir)
        for i, (_first_seq, path) in enumerate(segs):
            name = os.path.basename(path)
            sealed = i + 1 < len(segs)  # every segment but the ACTIVE one
            if sealed and name in self._sealed_shipped:
                continue  # immutable + already in the archive
            try:
                if sealed:
                    self.sink(path)
                else:
                    # ship the active tail WITHOUT marking it sealed: it
                    # is still growing and must re-ship next pass
                    key = f"{self._prefix}/{name}"
                    with self._mutex:
                        with open(path, "rb") as f:
                            self._store.put_object_bytes(key, f.read())
            except FileNotFoundError:
                continue  # purged (and therefore archived) under us
            n += 1
        return n

    def fetch_all(self, dest_dir: str) -> int:
        """Download every archived segment into ``dest_dir`` (a WAL-dir
        layout). Returns the number of segments fetched."""
        os.makedirs(dest_dir, exist_ok=True)
        n = 0
        for key in sorted(self._store.list_objects(self._prefix + "/")):
            name = key.rsplit("/", 1)[-1]
            if not (name.startswith("wal-") and name.endswith(".log")):
                continue
            with open(os.path.join(dest_dir, name), "wb") as f:
                f.write(self._store.get_object_bytes(key))
            n += 1
        return n


def replay_wal_dir(db: DB, wal_dir: str, to_seq: Optional[int]) -> int:
    """Replay WAL batches from ``wal_dir`` into an open DB, in sequence
    order, starting just past the DB's current seq and stopping after
    the batch containing ``to_seq`` (None = everything). Returns the
    number of batches applied. Raises on a sequence gap — a restore that
    silently skipped history would be worse than one that fails."""
    applied = 0
    expected = db.latest_sequence_number() + 1
    for start_seq, raw in wal_mod.iter_updates(wal_dir, expected):
        if to_seq is not None and start_seq > to_seq:
            break
        batch = decode_batch(raw)
        if start_seq + batch.count() - 1 < expected:
            continue  # fully below the checkpoint — already restored
        if start_seq != expected:
            raise StorageError(
                f"PITR gap: need seq {expected}, archive resumes at "
                f"{start_seq} — archive is missing a segment")
        got = db.write(batch)
        assert got == start_seq, (got, start_seq)
        applied += 1
        expected = db.latest_sequence_number() + 1
    if to_seq is not None and db.latest_sequence_number() < to_seq:
        raise StorageError(
            f"PITR: archive ends at seq {db.latest_sequence_number()}, "
            f"requested {to_seq}")
    return applied


def restore_db_to_seq(
    store: ObjectStore,
    backup_prefix: str,
    wal_prefix: str,
    db_path: str,
    to_seq: Optional[int] = None,
    options: Optional[DBOptions] = None,
    parallelism: int = 8,
) -> Dict:
    """Point-in-time restore: checkpoint backup + archived-WAL replay up
    to ``to_seq`` (None = latest archived). Picks the NEWEST checkpoint
    with seq <= to_seq from the prefix's versioned dbmeta chain
    (``dbmeta-<seq>``, written by every backup pass) — successive
    incremental backups into one prefix therefore advance nothing past
    restorability. Returns the chosen dbmeta augmented with
    ``restored_seq``. The restored DB is closed on return (same contract
    as restore_db: the caller reopens)."""
    from .backup import DBMETA_KEY, restore_db

    dbmeta_key = DBMETA_KEY
    if to_seq is not None:
        base = backup_prefix.rstrip("/") + "/" + DBMETA_KEY + "-"
        chain = []
        for key in store.list_objects(
                backup_prefix.rstrip("/") + "/" + DBMETA_KEY):
            tail = key[len(base):] if key.startswith(base) else ""
            if tail.isdigit():
                chain.append(int(tail))
        usable = sorted(s for s in chain if s <= to_seq)
        if usable:
            dbmeta_key = f"{DBMETA_KEY}-{usable[-1]:020d}"
        elif chain:
            # decide from the listing BEFORE downloading anything: the
            # requested point predates the whole chain
            raise StorageError(
                f"PITR: every checkpoint in {backup_prefix} is past seq "
                f"{to_seq} (oldest is {min(chain)}); the requested point "
                f"predates the backup chain")
    dbmeta = restore_db(
        store, backup_prefix, db_path, options=options,
        parallelism=parallelism, dbmeta_key=dbmeta_key)
    ckpt_seq = int(dbmeta.get("seq", 0))
    if to_seq is not None and to_seq < ckpt_seq:
        shutil.rmtree(db_path, ignore_errors=True)
        raise StorageError(
            f"PITR: every checkpoint in {backup_prefix} is past seq "
            f"{to_seq} (oldest usable is {ckpt_seq}); the requested "
            f"point predates the backup chain")
    tmp = tempfile.mkdtemp(prefix="rstpu-pitr-wal-")
    db = None
    try:
        # A dbmeta written by the backup manager names its own archive
        # prefix (per DB incarnation); it wins over the caller's guess
        WalArchiver(store, dbmeta.get("wal_prefix")
                    or wal_prefix).fetch_all(tmp)
        db = DB(db_path, options)
        replay_wal_dir(db, tmp, to_seq)
        dbmeta["restored_seq"] = db.latest_sequence_number()
        return dbmeta
    finally:
        if db is not None:
            db.close()
        shutil.rmtree(tmp, ignore_errors=True)
