"""Cluster management — the port's counterpart of
``rocksplicator_tpu/cluster/``, so far its coordination service alone:
``coordinator``, a small ZooKeeper stand-in (sessions, ephemeral and
sequential nodes, CAS, ``multi``, watches, locks, election, a durable WAL
with snapshots and standby replication). The remote compaction tier's job
ledger lives in it. The reference's controller, participant, state models,
spectator and tasks are not ported yet.
"""

from .coordinator import CoordinatorClient, CoordinatorServer

__all__ = ["CoordinatorClient", "CoordinatorServer"]
