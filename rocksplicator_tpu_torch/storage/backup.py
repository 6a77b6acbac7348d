"""Backup/restore: checkpoint-based object-store backups.
(The port's copy of ``rocksplicator_tpu/storage/backup.py``.)

Reference: the admin plane's four checkpoint/backup mechanisms (SURVEY §5):
(1) HDFS BackupEngine and (2) S3-env BackupEngine collapse here into one
object-store path (the store URI decides the backend); (3) checkpoint-based
backup — ``Checkpoint::CreateCheckpoint`` + parallel raw-file transfer with
a ``dbmeta`` file (admin_handler.cpp:996-1129, 1208-1327) — is the
mechanism implemented; (4) the continuous incremental thread lives in
``admin.backup_manager``.

Layout under ``<prefix>/``: the checkpoint's files verbatim plus ``dbmeta``
(JSON: DBMetaData + file list). Incremental upload skips files already in
the store (SST files are immutable and uniquely named per upload set).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

from ..observability.span import start_span
from ..utils.objectstore import ObjectStore
from .engine import DB, DBOptions
from .errors import StorageError

DBMETA_KEY = "dbmeta"


def backup_db(
    db: DB,
    store: ObjectStore,
    prefix: str,
    meta: Optional[Dict] = None,
    parallelism: int = 8,
    incremental: bool = True,
) -> Dict:
    """Checkpoint ``db`` and upload it under ``prefix``. Returns the dbmeta
    written. ``incremental`` skips files the store already holds.

    Split callers (the admin handler) checkpoint and upload separately so
    only the checkpoint — fast, hardlink-based — runs under the per-db
    admin lock: ``db.checkpoint(dir)`` then :func:`upload_checkpoint`.
    The checkpoint's hardlinks pin the SST inodes, so the upload stays
    consistent even if the db is closed or destroyed meanwhile."""
    # stage next to the db (same filesystem): the default temp dir is
    # often another device, where checkpoint's os.link degrades to a
    # full copy under the DB lock
    tmp = tempfile.mkdtemp(
        prefix=".backup-",  # swept at AdminHandler startup if orphaned
        dir=os.path.dirname(os.path.abspath(db.path)))
    ckpt_dir = os.path.join(tmp, "ckpt")
    try:
        ckpt_seq = db.checkpoint(ckpt_dir)
        return upload_checkpoint(
            db.path, store, prefix, ckpt_dir, ckpt_seq,
            meta=meta, parallelism=parallelism, incremental=incremental)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def upload_checkpoint(
    db_path: str,
    store: ObjectStore,
    prefix: str,
    ckpt_dir: str,
    ckpt_seq: int,
    meta: Optional[Dict] = None,
    parallelism: int = 8,
    incremental: bool = True,
) -> Dict:
    """Upload an already-created checkpoint directory under ``prefix``
    and write its dbmeta. Needs no db lock of any kind: the checkpoint
    directory is immutable once created."""
    files = sorted(
        f for f in os.listdir(ckpt_dir) if os.path.isfile(os.path.join(ckpt_dir, f))
    )
    existing = set()
    if incremental:
        with start_span("backup.list_existing"):
            plen = len(prefix.rstrip("/")) + 1
            existing = {
                k[plen:]
                for k in store.list_objects(prefix.rstrip("/") + "/")
            }
    to_upload = [
        os.path.join(ckpt_dir, f) for f in files
        if f not in existing or f == "MANIFEST"
    ]
    with start_span("backup.upload", files=len(to_upload),
                    parallelism=parallelism) as sp:
        sp.annotate(bytes=sum(os.path.getsize(p) for p in to_upload))
        store.put_objects(to_upload, prefix, parallelism=parallelism)
    # The MANIFEST is the one mutable file: a later incremental pass
    # into the same prefix overwrites it, which would break every
    # OLDER checkpoint in the chain (its dbmeta would download a
    # manifest referencing SSTs it never listed). Keep a versioned
    # copy per pass; the SSTs themselves are immutable and retained.
    manifest_key = f"MANIFEST-{ckpt_seq:020d}"
    with start_span("backup.manifest_copy"):
        store.copy_object(prefix.rstrip("/") + "/MANIFEST",
                          prefix.rstrip("/") + "/" + manifest_key)
    dbmeta = {
        "db_name": os.path.basename(db_path),
        "files": files,
        "manifest_key": manifest_key,
        "timestamp_ms": int(time.time() * 1000),
        # seq captured at checkpoint time, not after the upload: writes
        # landing during the upload are not in this backup.
        "seq": ckpt_seq,
    }
    if meta:
        dbmeta.update(meta)
    payload = json.dumps(dbmeta).encode("utf-8")
    with start_span("backup.dbmeta_put"):
        store.put_object_bytes(
            prefix.rstrip("/") + "/" + DBMETA_KEY, payload)
        # Versioned dbmeta: every past checkpoint stays restorable,
        # which is what lets point-in-time restore pick the newest
        # checkpoint <= to_seq (rocksdb BackupEngine's numbered-backup
        # chain analog).
        store.put_object_bytes(
            f"{prefix.rstrip('/')}/{DBMETA_KEY}-{ckpt_seq:020d}", payload)
    return dbmeta


def restore_db(
    store: ObjectStore,
    prefix: str,
    db_path: str,
    options: Optional[DBOptions] = None,
    parallelism: int = 8,
    dbmeta_key: str = DBMETA_KEY,
) -> Dict:
    """Download a backup into ``db_path`` (which must not exist) and
    validate against its dbmeta. Returns the dbmeta. The caller opens the
    DB afterwards (reference restoreDBHelper then re-adds the db).
    ``dbmeta_key`` selects a specific checkpoint from the versioned chain
    (``dbmeta-<seq>``); the default is the latest."""
    if os.path.exists(db_path):
        raise StorageError(f"restore target exists: {db_path}")
    with start_span("restore.dbmeta_get"):
        raw = store.get_object_bytes(prefix.rstrip("/") + "/" + dbmeta_key)
    dbmeta = json.loads(raw.decode("utf-8"))
    tmp = db_path + ".restoring"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        with start_span("restore.download", files=len(dbmeta["files"])):
            for f in dbmeta["files"]:
                key = f
                if f == "MANIFEST" and dbmeta.get("manifest_key"):
                    # download THIS checkpoint's manifest version (the bare
                    # MANIFEST object tracks the newest pass in the prefix)
                    key = dbmeta["manifest_key"]
                store.get_object(prefix.rstrip("/") + "/" + key,
                                 os.path.join(tmp, f))
        os.replace(tmp, db_path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dbmeta
