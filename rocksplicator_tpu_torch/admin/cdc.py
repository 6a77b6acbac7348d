"""CDC admin service: change-data-capture via OBSERVER replicas.
(The port's copy of ``rocksplicator_tpu/admin/cdc.py``.)

Reference: cdc_admin/ (cdc_admin.thrift, cdc_admin_handler.{h,cpp},
cdc_application_db.cpp:15-41) — an OBSERVER is a replica that replicates
but never counts toward ACKs (replicator.thrift:63); its custom
``DbWrapper.handle_replicate_response`` publishes updates (e.g. to a
message queue) instead of persisting them. RPCs: addObserver,
removeObserver, checkObserver, getSequenceNumber.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Deque, Iterator, List, Optional, Tuple

from ..replication.db_wrapper import DbWrapper
from ..replication.replicator import Replicator
from ..replication.wire import ReplicaRole
from ..rpc.errors import RpcApplicationError
from ..storage.records import decode_batch

log = logging.getLogger(__name__)

OBSERVER_ALREADY_EXISTS = "OBSERVER_ALREADY_EXISTS"
OBSERVER_NOT_FOUND = "OBSERVER_NOT_FOUND"

# publish(db_name, start_seq, raw_batch_bytes, timestamp_ms)
Publisher = Callable[[str, int, bytes, Optional[int]], None]


class CdcDbWrapper(DbWrapper):
    """Observer-side wrapper: publishes instead of persisting
    (cdc_application_db.cpp:15-41). Tracks the applied seq in memory."""

    def __init__(self, db_name: str, start_seq: int, publisher: Publisher):
        self.db_name = db_name
        self._seq = start_seq
        self._publisher = publisher
        self._lock = threading.Lock()
        self.published_count = 0
        self.last_published_ms: Optional[int] = None

    def write_to_leader(self, batch) -> int:
        raise RpcApplicationError("NOT_LEADER", "observers do not accept writes")

    def get_updates_from_leader(self, since_seq: int) -> Iterator[Tuple[int, bytes]]:
        return iter(())  # observers never serve downstream replicas

    def latest_sequence_number(self) -> int:
        with self._lock:
            return self._seq

    def handle_replicate_response(self, raw_data: bytes, timestamp_ms) -> None:
        batch = decode_batch(raw_data)
        with self._lock:
            start_seq = self._seq + 1
        # Publish BEFORE advancing the applied seq: a publisher failure
        # leaves _seq unchanged so the pull loop re-fetches and re-publishes
        # the batch (at-least-once, never silent loss).
        self._publisher(self.db_name, start_seq, bytes(raw_data), timestamp_ms)
        with self._lock:
            self._seq += batch.count()
            self.published_count += 1
            self.last_published_ms = int(time.time() * 1000)


class MemoryPublisher:
    """Default publisher: in-memory ring buffer (a MockKafka analog for
    tests and checkObserver introspection; production plugs a queue
    producer in)."""

    def __init__(self, capacity: int = 1024):
        self.buffer: Deque[Tuple[str, int, bytes, Optional[int]]] = (
            collections.deque(maxlen=capacity)
        )
        self._lock = threading.Lock()

    def __call__(self, db_name: str, start_seq: int, raw: bytes, ts) -> None:
        with self._lock:
            self.buffer.append((db_name, start_seq, raw, ts))

    def drain(self) -> List[Tuple[str, int, bytes, Optional[int]]]:
        with self._lock:
            out = list(self.buffer)
            self.buffer.clear()
            return out


class CdcAdminHandler:
    """The CdcAdmin RPC service (cdc_admin.thrift:1-105)."""

    def __init__(
        self,
        replicator: Replicator,
        publisher: Optional[Publisher] = None,
    ):
        self.replicator = replicator
        self.publisher = publisher or MemoryPublisher()
        self._observers: dict = {}
        self._lock = threading.Lock()

    async def handle_add_observer(
        self,
        db_name: str = "",
        upstream_ip: str = "",
        upstream_port: int = 0,
        start_seq: Optional[int] = None,
    ) -> dict:
        """addObserver: start an OBSERVER replica of ``db_name`` pulling
        from upstream. ``start_seq`` None means "from the upstream's current
        position" (probed via a non-blocking replicate call)."""
        if not upstream_ip:
            raise RpcApplicationError("INVALID_UPSTREAM", "upstream required")
        # Reserve before the awaits so a concurrent duplicate gets the typed
        # error instead of a raw add_db ValueError.
        with self._lock:
            if db_name in self._observers:
                raise RpcApplicationError(OBSERVER_ALREADY_EXISTS, db_name)
            self._observers[db_name] = None  # reservation
        try:
            return await self._do_add_observer(
                db_name, upstream_ip, upstream_port, start_seq
            )
        except BaseException:
            with self._lock:
                if self._observers.get(db_name) is None:
                    self._observers.pop(db_name, None)
            raise

    async def _do_add_observer(
        self, db_name: str, upstream_ip: str, upstream_port: int,
        start_seq: Optional[int],
    ) -> dict:
        if start_seq is None:
            pool = self.replicator._pool
            client = await pool.get_client(upstream_ip, upstream_port)
            probe = await client.call(
                "replicate",
                {"db_name": db_name, "seq_no": 1 << 62, "max_wait_ms": 0,
                 "role": ReplicaRole.OBSERVER.value},
            )
            start_seq = int(probe.get("latest_seq", 0))
        wrapper = CdcDbWrapper(db_name, start_seq, self.publisher)
        rdb = self.replicator.add_db(
            db_name, wrapper, ReplicaRole.OBSERVER,
            upstream_addr=(upstream_ip, upstream_port),
        )
        with self._lock:
            self._observers[db_name] = (wrapper, rdb)
        return {"start_seq": start_seq}

    async def handle_remove_observer(self, db_name: str = "") -> dict:
        with self._lock:
            entry = self._observers.get(db_name)
            if entry is None:  # absent or still-starting reservation
                raise RpcApplicationError(OBSERVER_NOT_FOUND, db_name)
            del self._observers[db_name]
        self.replicator.remove_db(db_name)
        return {}

    async def handle_check_observer(self, db_name: str = "") -> dict:
        with self._lock:
            entry = self._observers.get(db_name)
        if entry is None:
            raise RpcApplicationError(OBSERVER_NOT_FOUND, db_name)
        wrapper, rdb = entry
        return {
            "seq_num": wrapper.latest_sequence_number(),
            "published_count": wrapper.published_count,
            "last_published_ms": wrapper.last_published_ms,
            "upstream": list(rdb.upstream_addr or ()),
        }

    async def handle_get_sequence_number(self, db_name: str = "") -> dict:
        with self._lock:
            entry = self._observers.get(db_name)
        if entry is None:
            raise RpcApplicationError(OBSERVER_NOT_FOUND, db_name)
        return {"seq_num": entry[0].latest_sequence_number()}

    def close(self) -> None:
        with self._lock:
            names = [n for n, e in self._observers.items() if e is not None]
            self._observers.clear()
        for name in names:
            try:
                self.replicator.remove_db(name)
            except KeyError:
                pass

