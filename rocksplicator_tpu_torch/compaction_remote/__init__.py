"""Disaggregated compaction worker tier — the port's copy of
``rocksplicator_tpu/compaction_remote/``.

Leaders publish compaction jobs into a durable coordinator-backed
ledger (``/compactions/<db>``); stateless workers claim exactly one job
at a time, fetch the immutable input SSTs from the object store, run
the bounded-memory streaming merge (or the in-RAM merge, by the job's
budget) through their backend — on the port's default, the card — and
upload output SSTs plus a checksummed result manifest. The publishing
leader verifies checksums and installs the new generation atomically
through the engine's ``snapshot_full_compaction`` /
``begin_full_install`` / ``install_full_compaction`` seams — rejecting
any result whose job epoch is stale, so a deposed leader's in-flight job
can never install (the replication fencing rule extended to
compaction). Serving correctness never depends on the tier being up: if
no worker claims within the claim window, a worker dies mid-job
(heartbeat expiry), a checksum mismatches, or the deadline passes, the
pick falls back to the unchanged local compaction path.

The ledger, codecs and objects are the reference's, byte for byte, so a
reference leader and a port worker (or the other way round) share one
coordinator and one store.

Module map:

- :mod:`.jobs`     — job / result codecs + sha256 file manifests
- :mod:`.queue`    — the coordinator ledger (publish/claim/heartbeat/result)
- :mod:`.worker`   — the stateless merge worker (``tools/compaction_worker``)
- :mod:`.install`  — leader-side publish → await → verify → fenced install
- :mod:`.dispatch` — env-knob dispatch policy (``RSTPU_COMPACT_REMOTE``)
"""

from .dispatch import RemoteDispatchPolicy
from .install import RemoteCompactionManager
from .jobs import CompactionJob, JobResult, file_checksum
from .queue import CompactionJobQueue, JobInFlightError
from .worker import CompactionWorker

__all__ = [
    "CompactionJob",
    "CompactionJobQueue",
    "CompactionWorker",
    "JobInFlightError",
    "JobResult",
    "RemoteCompactionManager",
    "RemoteDispatchPolicy",
    "file_checksum",
]
