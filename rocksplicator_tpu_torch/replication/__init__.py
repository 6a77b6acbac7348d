"""Replication core (reference: rocksdb_replicator/ — SURVEY.md §2.1).
(The port's copy of ``rocksplicator_tpu/replication/__init__.py``.)

Per-shard leader/follower chained replication:
- leaders stamp timestamps into batches and serve WAL updates to
  long-polling followers;
- followers pull, apply raw batches, and chain to further followers;
- OBSERVER replicas replicate without counting toward ACKs (CDC seam);
- ack modes: 0 async, 1 semi-sync, 2 sync, with fail-fast degradation.
"""

from .wire import ReplicaRole, ReplicateErrorCode, REPLICATOR_METRICS
from .ack_window import AckWaiter, AckWindow, MaxNumberBox
from .db_wrapper import DbWrapper, StorageDbWrapper
from .replicated_db import ReplicatedDB, ReplicationFlags
from .replicator import Replicator

__all__ = [
    "ReplicaRole", "ReplicateErrorCode", "REPLICATOR_METRICS",
    "DbWrapper", "StorageDbWrapper", "MaxNumberBox",
    "AckWaiter", "AckWindow",
    "ReplicatedDB", "ReplicationFlags", "Replicator",
]
