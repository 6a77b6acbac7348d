"""Compaction job / result codecs.
(The port's copy of ``rocksplicator_tpu/compaction_remote/jobs.py``.)

A job is the complete, self-contained description of one full
compaction: the immutable input SSTs (object-store keys + sha256
manifests), the merge parameters the publishing engine would have used
locally, and the publishing leader's epoch. A worker needs nothing
else — no engine, no manifest, no WAL — which is what makes the tier
stateless. Results carry per-file sha256 checksums so the leader can
verify every byte before the generation installs.

JSON encoding mirrors :class:`~..cluster.shard_move.MoveRecord`: the
records live as coordinator node values and must survive leader
restarts and version skew (unknown fields are dropped on decode).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import List, Optional


def file_checksum(path: str) -> str:
    """sha256 hex digest of a file, streamed in 1 MiB chunks — input and
    output SSTs cross the object store whole, so a whole-file digest
    (not the engine's per-block polynomial checksum) is the transfer
    integrity seal."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _decode_fields(cls, raw: bytes):
    data = json.loads(bytes(raw).decode("utf-8"))
    fields = {f for f in cls.__dataclass_fields__}
    return cls(**{k: v for k, v in data.items() if k in fields})


@dataclass
class CompactionJob:
    """One published full compaction. ``inputs`` entries are dicts of
    ``{"name", "key", "checksum", "bytes"}`` — SST file name in the
    source DB, object-store key, sha256, and size."""

    job_id: str
    db_name: str
    epoch: int
    store_uri: str
    inputs: List[dict] = field(default_factory=list)
    bottom: int = 0
    drop_tombstones: bool = True
    merge_operator: Optional[str] = None
    block_bytes: int = 32 * 1024
    compression: int = 1
    bits_per_key: int = 10
    target_file_bytes: int = 64 * 1024 * 1024
    memory_budget_bytes: int = 0
    deadline_ms: int = 0
    published_ms: int = 0

    def encode(self) -> bytes:
        return json.dumps(asdict(self), sort_keys=True).encode("utf-8")

    @classmethod
    def decode(cls, raw: bytes) -> "CompactionJob":
        return _decode_fields(cls, raw)

    @property
    def input_bytes(self) -> int:
        return sum(int(i.get("bytes", 0)) for i in self.inputs)


@dataclass
class JobResult:
    """A worker's completion manifest. ``outputs`` entries are dicts of
    ``{"name", "key", "checksum", "bytes"}``; an empty list with
    ``status == "done"`` means the merge compacted everything away
    (all-tombstoned), which installs as an empty generation."""

    job_id: str
    db_name: str
    epoch: int
    worker_id: str
    status: str = "done"  # "done" | "failed"
    error: Optional[str] = None
    outputs: List[dict] = field(default_factory=list)
    finished_ms: int = 0

    def encode(self) -> bytes:
        return json.dumps(asdict(self), sort_keys=True).encode("utf-8")

    @classmethod
    def decode(cls, raw: bytes) -> "JobResult":
        return _decode_fields(cls, raw)
