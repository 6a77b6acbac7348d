"""WriteBatch: the unit of atomic writes and of replication shipping.

(The port's copy of ``rocksplicator_tpu/storage/records.py``.)

Reference: rocksdb::WriteBatch. The replication layer ships raw batch bytes
to followers (rocksdb_replicator/rocksdb_wrapper.cpp:13-28 deserializes the
raw WriteBatch, re-stamps the timestamp, applies locally), and the leader
stamps a wall-clock timestamp into each batch via ``PutLogData``
(replicated_db.cpp:115-117) which consumes no sequence number. This module
keeps those contracts.

Wire format (little-endian):
    u32 num_ops
    per op:
        u8  op_type
        u32 key_len,  key bytes     (LOG_DATA: key empty)
        u32 val_len,  val bytes

PUT/DELETE/MERGE consume one sequence number each; LOG_DATA consumes none
(mirrors RocksDB, and the engine-assumption tests pin this).
"""

from __future__ import annotations

import enum
import struct
import time
from typing import Iterator, List, Optional, Tuple

from .errors import Corruption

_U32 = struct.Struct("<I")
_OPHEAD = struct.Struct("<BI")


class OpType(enum.IntEnum):
    PUT = 1
    DELETE = 2
    MERGE = 3
    LOG_DATA = 4


# Log-data payloads written by the replication layer: 8-byte little-endian
# wall-clock milliseconds (replicated_db.cpp stamps ms for the lag metric).
_TS = struct.Struct("<Q")


class WriteBatch:
    __slots__ = ("_ops",)

    def __init__(self) -> None:
        self._ops: List[Tuple[OpType, bytes, bytes]] = []

    def put(self, key: bytes, value: bytes) -> "WriteBatch":
        self._ops.append((OpType.PUT, bytes(key), bytes(value)))
        return self

    def delete(self, key: bytes) -> "WriteBatch":
        self._ops.append((OpType.DELETE, bytes(key), b""))
        return self

    def merge(self, key: bytes, operand: bytes) -> "WriteBatch":
        self._ops.append((OpType.MERGE, bytes(key), bytes(operand)))
        return self

    def put_log_data(self, blob: bytes) -> "WriteBatch":
        self._ops.append((OpType.LOG_DATA, b"", bytes(blob)))
        return self

    # -- replication timestamp helpers ------------------------------------

    def stamp_timestamp_ms(self, now_ms: Optional[int] = None) -> "WriteBatch":
        """Leader-side stamp (replicated_db.cpp:115-117)."""
        ts = int(time.time() * 1000) if now_ms is None else now_ms
        return self.put_log_data(_TS.pack(ts))

    def extract_timestamp_ms(self) -> Optional[int]:
        """Last LOG_DATA 8-byte timestamp, if any (follower lag metric)."""
        for op, _key, val in reversed(self._ops):
            if op is OpType.LOG_DATA and len(val) == _TS.size:
                return _TS.unpack(val)[0]
        return None

    def strip_log_data(self) -> "WriteBatch":
        """Copy without LOG_DATA ops (follower re-stamps its own)."""
        out = WriteBatch()
        out._ops = [t for t in self._ops if t[0] is not OpType.LOG_DATA]
        return out

    # -- introspection ----------------------------------------------------

    def count(self) -> int:
        """Number of sequence-number-consuming ops."""
        return sum(1 for op, _k, _v in self._ops if op is not OpType.LOG_DATA)

    def __len__(self) -> int:
        return len(self._ops)

    def ops(self) -> Iterator[Tuple[OpType, bytes, bytes]]:
        return iter(self._ops)

    def byte_size(self) -> int:
        return _U32.size + sum(
            _OPHEAD.size + _U32.size + len(k) + len(v) for _op, k, v in self._ops
        )

    # -- serialization ----------------------------------------------------

    def encode(self) -> bytes:
        parts = [_U32.pack(len(self._ops))]
        for op, key, val in self._ops:
            parts.append(_OPHEAD.pack(op, len(key)))
            parts.append(key)
            parts.append(_U32.pack(len(val)))
            parts.append(val)
        return b"".join(parts)


def scan_batch_meta(data) -> Tuple[int, Optional[int]]:
    """(count, timestamp_ms) by skimming op HEADERS only — no key/value
    slicing, no WriteBatch construction. The replication serve path needs
    exactly these two facts per shipped update; a full decode_batch +
    extract_timestamp_ms pair cost two O(bytes) passes per update on the
    hot serve path."""
    buf = bytes(data)
    if len(buf) < _U32.size:
        raise Corruption("batch too short")
    (num_ops,) = _U32.unpack_from(buf, 0)
    pos = _U32.size
    count = 0
    ts: Optional[int] = None
    try:
        for _ in range(num_ops):
            op_raw, key_len = _OPHEAD.unpack_from(buf, pos)
            pos += _OPHEAD.size + key_len
            (val_len,) = _U32.unpack_from(buf, pos)
            pos += _U32.size
            if op_raw == OpType.LOG_DATA:
                if val_len == _TS.size:
                    ts = _TS.unpack_from(buf, pos)[0]
            else:
                count += 1
            pos += val_len
        if pos > len(buf):
            raise Corruption("truncated batch")
    except struct.error as e:
        raise Corruption(f"bad batch: {e}") from e
    return count, ts


def decode_batch(data) -> WriteBatch:
    buf = bytes(data)
    if len(buf) < _U32.size:
        raise Corruption("batch too short")
    (num_ops,) = _U32.unpack_from(buf, 0)
    pos = _U32.size
    batch = WriteBatch()
    try:
        for _ in range(num_ops):
            op_raw, key_len = _OPHEAD.unpack_from(buf, pos)
            pos += _OPHEAD.size
            key = buf[pos:pos + key_len]
            if len(key) != key_len:
                raise Corruption("truncated key")
            pos += key_len
            (val_len,) = _U32.unpack_from(buf, pos)
            pos += _U32.size
            val = buf[pos:pos + val_len]
            if len(val) != val_len:
                raise Corruption("truncated value")
            pos += val_len
            batch._ops.append((OpType(op_raw), key, val))
    except (struct.error, ValueError) as e:
        raise Corruption(f"bad batch encoding: {e}") from e
    if pos != len(buf):
        raise Corruption("trailing bytes in batch")
    return batch
