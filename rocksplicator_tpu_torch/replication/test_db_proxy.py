"""TestDbProxy: a DbWrapper test double.
(The port's copy of ``rocksplicator_tpu/replication/test_db_proxy.py``.)

Reference: rocksdb_replicator/test_db_proxy.{h,cpp} — a tiny wrapper
delegating to the default wrapper, used to exercise wrapper-based addDB
(proving the DbWrapper seam composes). Also counts calls for assertions.
"""

from __future__ import annotations

from typing import Iterator, Tuple

from .db_wrapper import DbWrapper, StorageDbWrapper


class TestDbProxy(DbWrapper):
    def __init__(self, db):
        self._inner = StorageDbWrapper(db)
        self.writes = 0
        self.reads = 0
        self.applies = 0

    def write_to_leader(self, batch) -> int:
        self.writes += 1
        return self._inner.write_to_leader(batch)

    def get_updates_from_leader(self, since_seq: int) -> Iterator[Tuple[int, bytes]]:
        self.reads += 1
        return self._inner.get_updates_from_leader(since_seq)

    def latest_sequence_number(self) -> int:
        return self._inner.latest_sequence_number()

    def handle_replicate_response(self, raw_data, timestamp_ms) -> None:
        self.applies += 1
        self._inner.handle_replicate_response(raw_data, timestamp_ms)
