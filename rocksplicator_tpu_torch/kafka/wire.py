"""Kafka binary wire protocol — real-broker interop for the queue stack.
(The port's copy of ``rocksplicator_tpu/kafka/wire.py``.)

Reference: common/kafka/kafka_consumer.h:27-118 wraps librdkafka speaking
the Apache Kafka protocol to actual clusters. This module implements that
protocol natively (no librdkafka in the image):

- :class:`KafkaWireConsumer` — a :class:`~.broker.Consumer` backend that
  bootstraps, fetches and commits against ANY Kafka-protocol broker.
- :class:`KafkaWireBroker` — serves the same protocol from the embedded
  :class:`~.broker.MockKafkaCluster`, so the consumer is exercised over
  real TCP frames in CI (and standard Kafka clients can read from the
  embedded queue).

Implemented APIs (fixed, non-flexible versions — pre-KIP-482 encodings):

  ========== ===== =============================================
  ApiVersions  v0  handshake / capability discovery
  Metadata     v1  topic -> partitions + leaders
  ListOffsets  v1  timestamp seek (-1 latest, -2 earliest)
  Fetch        v4  record batches v2 (magic=2, CRC-32C)
  OffsetCommit v2  consumer-group offset store
  OffsetFetch  v1  committed-offset recovery
  ========== ===== =============================================

Record batches are the v2 format: zigzag-varint records inside a
CRC-32C-protected batch frame. Compression: incoming gzip batches
(attributes codec 1 — what a default Java/librdkafka producer with
``compression.type=gzip`` ships) are decoded via stdlib zlib with bounded
decompression; snappy batches (codec 2) decode through a pure-python
block-format decoder that also understands snappy-java's xerial stream
framing; lz4/zstd are still rejected loudly (codec bytes must never be
handed up as record bytes). Produced batches are uncompressed by default
(``codec="gzip"``/``codec="snappy"`` opt-in; the snappy encoder emits
literal-only blocks — valid snappy, no match search).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from .broker import Consumer, Message, MockKafkaCluster

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_API_VERSIONS = 18

ERR_NONE = 0
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3


class KafkaWireError(Exception):
    """Broker-reported error the consumer cannot make progress past.
    ``error_code`` is the Kafka protocol code; for OFFSET_OUT_OF_RANGE,
    ``log_start``/``high_watermark`` (when known) let callers reseek."""

    def __init__(self, msg: str, error_code: int,
                 partition: int = -1, high_watermark: int = -1):
        super().__init__(msg)
        self.error_code = error_code
        self.partition = partition
        self.high_watermark = high_watermark

_SUPPORTED = {
    API_PRODUCE: (3, 3),
    API_FETCH: (4, 4),
    API_LIST_OFFSETS: (1, 1),
    API_METADATA: (1, 1),
    API_OFFSET_COMMIT: (2, 2),
    API_OFFSET_FETCH: (1, 1),
    API_API_VERSIONS: (0, 0),
}


# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli) — record batch v2 checksum. Software table; batches
# are small and this path is interop, not the hot loop.
# ---------------------------------------------------------------------------

def _make_crc32c_table() -> List[int]:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# primitive encoding
# ---------------------------------------------------------------------------

def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def encode_varint(n: int) -> bytes:
    """Unsigned LEB128 of the zigzag encoding (Kafka varint)."""
    u = _zigzag(n) & 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = u = 0
    while True:
        if pos >= len(buf):
            raise ValueError("kafka varint: truncated")
        b = buf[pos]
        pos += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzigzag(u), pos
        shift += 7
        if shift > 70:
            raise ValueError("kafka varint: too long")


class _W:
    """Request/response body writer (big-endian, Kafka conventions)."""

    def __init__(self) -> None:
        self.b = bytearray()

    def i8(self, v):
        self.b += struct.pack(">b", v)
        return self

    def i16(self, v):
        self.b += struct.pack(">h", v)
        return self

    def i32(self, v):
        self.b += struct.pack(">i", v)
        return self

    def i64(self, v):
        self.b += struct.pack(">q", v)
        return self

    def string(self, s: Optional[str]):
        if s is None:
            return self.i16(-1)
        raw = s.encode("utf-8")
        self.i16(len(raw))
        self.b += raw
        return self

    def bytes_(self, v: Optional[bytes]):
        if v is None:
            return self.i32(-1)
        self.i32(len(v))
        self.b += v
        return self

    def raw(self, v: bytes):
        self.b += v
        return self


class _R:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("kafka frame: truncated")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode("utf-8")

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        return bytes(self._take(n))


# ---------------------------------------------------------------------------
# record batch v2
# ---------------------------------------------------------------------------

_BATCH_HEAD = struct.Struct(">qiib")  # base_offset, batch_len, leader_epoch, magic

# decompressed-records cap, matching the fetch frame cap (_read_frame):
# a gzip bomb must not balloon past what an uncompressed record set
# could legally carry. The cap is CUMULATIVE across one record set's
# batches — per-batch bounding alone would let a 64MB frame packed with
# many maximally-compressed batches decode to frame_cap × batch_count
_MAX_DECOMPRESSED = 64 << 20


def _gunzip_bounded(data: bytes, cap: int) -> bytes:
    """gzip/zlib decode with an output bound (wbits=47 auto-detects both
    wrappers — Java producers write gzip format; tolerate zlib too)."""
    d = zlib.decompressobj(wbits=47)
    try:
        raw = d.decompress(data, cap + 1)
    except zlib.error as e:
        raise ValueError(f"kafka batch: bad gzip records: {e}") from None
    if len(raw) > cap or d.unconsumed_tail:
        raise ValueError("kafka batch: gzip records exceed size cap")
    return raw


# snappy-java's stream framing (what a Java producer's snappy codec
# actually ships): 8-byte magic, version, compat, then [len_be4, raw
# snappy block]*. librdkafka ships the raw block alone.
_XERIAL_MAGIC = b"\x82SNAPPY\x00"


def _snappy_uvarint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data) or shift > 31:
            raise ValueError("kafka batch: bad snappy preamble")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _snappy_block(data: bytes, cap: int) -> bytes:
    """Pure-python snappy *block format* decode (format_description.txt):
    little-endian-varint uncompressed length, then tagged elements —
    literals (tag 00, lengths 1-60 inline, 61-64 → 1-4 trailing length
    bytes) and back-references (tag 01: 4-11 bytes at an 11-bit offset;
    tag 10/11: 1-64 bytes at a 16/32-bit offset), overlap-legal (an
    offset shorter than the copy length repeats the tail, the RLE
    idiom). Bounded: the declared length must fit ``cap`` and every
    element is range-checked, so hostile bytes fail loudly instead of
    ballooning memory or reading out of bounds."""
    n, pos = _snappy_uvarint(data, 0)
    if n > cap:
        raise ValueError("kafka batch: snappy records exceed size cap")
    out = bytearray()
    ln = len(data)
    while pos < ln:
        tag = data[pos]
        pos += 1
        typ = tag & 3
        if typ == 0:  # literal
            length = tag >> 2
            if length >= 60:
                nb = length - 59
                if pos + nb > ln:
                    raise ValueError("kafka batch: bad snappy literal")
                length = int.from_bytes(data[pos:pos + nb], "little")
                pos += nb
            length += 1
            if pos + length > ln or len(out) + length > n:
                raise ValueError("kafka batch: bad snappy literal")
            out += data[pos:pos + length]
            pos += length
            continue
        if typ == 1:  # copy, 1-byte offset
            if pos >= ln:
                raise ValueError("kafka batch: bad snappy copy")
            length = ((tag >> 2) & 0x07) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif typ == 2:  # copy, 2-byte offset
            if pos + 2 > ln:
                raise ValueError("kafka batch: bad snappy copy")
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            if pos + 4 > ln:
                raise ValueError("kafka batch: bad snappy copy")
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out) or len(out) + length > n:
            raise ValueError("kafka batch: bad snappy copy")
        if offset >= length:
            start = len(out) - offset
            out += out[start:start + length]
        else:  # overlapping copy: byte-at-a-time semantics
            for _ in range(length):
                out.append(out[-offset])
    if len(out) != n:
        raise ValueError("kafka batch: snappy length mismatch")
    return bytes(out)


def _snappy_bounded(data: bytes, cap: int) -> bytes:
    """Codec-2 records decode: raw snappy block (librdkafka) or the
    xerial stream framing (snappy-java), auto-detected by magic."""
    if data[:8] == _XERIAL_MAGIC:
        if len(data) < 16:
            raise ValueError("kafka batch: truncated snappy stream")
        out = bytearray()
        pos = 16  # magic + version + compat
        while pos < len(data):
            if pos + 4 > len(data):
                raise ValueError("kafka batch: truncated snappy stream")
            blen = int.from_bytes(data[pos:pos + 4], "big")
            pos += 4
            if pos + blen > len(data):
                raise ValueError("kafka batch: truncated snappy stream")
            out += _snappy_block(data[pos:pos + blen], cap - len(out))
            pos += blen
        return bytes(out)
    return _snappy_block(data, cap)


def _snappy_compress(data: bytes) -> bytes:
    """Literal-only snappy block encoding (valid per the format spec;
    no back-reference search — the encoder exists for round-trips and a
    second produce codec, the pure-python *decoder* is the parity
    item)."""
    out = bytearray()
    n = len(data)
    # preamble: uncompressed length, little-endian varint
    v = n
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    pos = 0
    while pos < n:
        length = min(n - pos, 1 << 16)
        if length <= 60:
            out.append((length - 1) << 2)
        else:
            nb = ((length - 1).bit_length() + 7) // 8
            out.append((59 + nb) << 2)
            out += (length - 1).to_bytes(nb, "little")
        out += data[pos:pos + length]
        pos += length
    return bytes(out)


def encode_record_batch(base_offset: int,
                        records: Sequence[Tuple[int, bytes, bytes]],
                        codec: Optional[str] = None) -> bytes:
    """records: [(timestamp_ms, key, value)] -> one v2 batch.
    ``codec="gzip"`` compresses the records section (attributes codec 1,
    the v2 layout: batch header through recordCount stays uncompressed,
    only the records array is wrapped); default is uncompressed."""
    if not records:
        return b""
    if codec not in (None, "gzip", "snappy"):
        raise ValueError(f"unsupported kafka codec: {codec}")
    first_ts = records[0][0]
    max_ts = max(r[0] for r in records)
    body = _W()
    body.i16({"gzip": 1, "snappy": 2}.get(codec, 0))  # attributes codec
    body.i32(len(records) - 1)       # lastOffsetDelta
    body.i64(first_ts)
    body.i64(max_ts)
    body.i64(-1).i16(-1).i32(-1)     # producerId/Epoch, baseSequence
    body.i32(len(records))
    # uncompressed (the hot default): records append straight into body;
    # gzip diverts them through an intermediate buffer for the wrapper
    recs = _W() if codec in ("gzip", "snappy") else body
    for delta, (ts, key, value) in enumerate(records):
        rec = _W()
        rec.i8(0)                    # record attributes
        rec.raw(encode_varint(ts - first_ts))
        rec.raw(encode_varint(delta))
        if key is None:
            rec.raw(encode_varint(-1))
        else:
            rec.raw(encode_varint(len(key)))
            rec.raw(bytes(key))
        rec.raw(encode_varint(len(value)))
        rec.raw(bytes(value))
        rec.raw(encode_varint(0))    # headers
        recs.raw(encode_varint(len(rec.b)))
        recs.raw(bytes(rec.b))
    if codec == "gzip":
        # wbits=31 → gzip wrapper (what Kafka's gzip codec is); mtime
        # defaults to 0 in zlib's stream header, keeping output stable
        c = zlib.compressobj(wbits=31)
        body.raw(c.compress(bytes(recs.b)) + c.flush())
    elif codec == "snappy":
        body.raw(_snappy_compress(bytes(recs.b)))
    crc = crc32c(bytes(body.b))
    # batch_length counts everything after the length field itself
    batch_len = 4 + 1 + 4 + len(body.b)  # leader_epoch + magic + crc + body
    out = _W()
    out.raw(_BATCH_HEAD.pack(base_offset, batch_len, 0, 2))
    out.b += struct.pack(">I", crc)
    out.raw(bytes(body.b))
    return bytes(out.b)


def decode_record_batches(buf: bytes) -> List[Tuple[int, int, Optional[bytes], bytes]]:
    """record_set bytes -> [(offset, timestamp_ms, key, value)]. Verifies
    magic and CRC-32C per batch; rejects compressed batches; control
    batches (transaction markers) are skipped."""
    return decode_record_set(buf)[0]


def decode_record_set(buf: bytes) -> Tuple[
        List[Tuple[int, int, Optional[bytes], bytes]], Optional[int]]:
    """Like :func:`decode_record_batches` but also returns the offset
    AFTER the last complete batch (base_offset + last_offset_delta + 1),
    or None when no complete batch was present. Consumers need it to
    advance past control-only batches — a position parked on a
    transaction marker would otherwise refetch it forever."""
    out: List[Tuple[int, int, Optional[bytes], bytes]] = []
    gunzip_budget = _MAX_DECOMPRESSED  # shared across the set's batches
    next_offset: Optional[int] = None
    pos = 0
    while pos + _BATCH_HEAD.size + 4 <= len(buf):
        base_offset, batch_len, _epoch, magic = _BATCH_HEAD.unpack_from(buf, pos)
        end = pos + 8 + 4 + batch_len
        if end > len(buf):
            break  # partial trailing batch (legal in fetch responses)
        if magic != 2:
            raise ValueError(f"kafka batch: unsupported magic {magic}")
        crc = struct.unpack_from(">I", buf, pos + _BATCH_HEAD.size)[0]
        body_start = pos + _BATCH_HEAD.size + 4
        body = buf[body_start:end]
        if crc32c(body) != crc:
            raise ValueError("kafka batch: CRC-32C mismatch")
        r = _R(body)
        attributes = r.i16()
        codec = attributes & 0x07
        if codec not in (0, 1, 2):
            # lz4(3)/zstd(4): no in-image codec — reject loudly rather
            # than hand codec bytes up as record bytes (gzip rides
            # stdlib zlib, snappy has the pure-python block decoder)
            raise ValueError(
                f"kafka batch: compression codec {codec} "
                f"not supported")
        if attributes & 0x20:
            # control batch (transaction COMMIT/ABORT markers): its
            # records are protocol metadata, never application data —
            # but its offset range still advances next_offset
            next_offset = base_offset + r.i32() + 1
            pos = end
            continue
        # lastOffsetDelta advances next_offset even when the batch's
        # records were all compacted away (count may be 0)
        next_offset = base_offset + r.i32() + 1
        first_ts = r.i64()
        r.i64()                      # maxTimestamp
        r.i64(); r.i16(); r.i32()    # producer id/epoch, base seq
        count = r.i32()
        # v2 layout: only the records array (after recordCount) is
        # compressed; the CRC above covered the on-wire (compressed)
        # bytes. Codec 1 = gzip — stdlib zlib, bounded so a hostile
        # batch cannot balloon memory past the frame cap.
        rbuf, rpos = body, r.pos
        if codec == 1:
            rbuf = _gunzip_bounded(body[r.pos:], gunzip_budget)
            gunzip_budget -= len(rbuf)
            rpos = 0
        elif codec == 2:
            rbuf = _snappy_bounded(body[r.pos:], gunzip_budget)
            gunzip_budget -= len(rbuf)
            rpos = 0
        for _ in range(count):
            rec_len, p = decode_varint(rbuf, rpos)
            rec_end = p + rec_len
            rr = _R(rbuf[:rec_end], p)
            rr.i8()                  # record attributes
            ts_delta, rr.pos = decode_varint(rbuf, rr.pos)
            off_delta, rr.pos = decode_varint(rbuf, rr.pos)
            klen, rr.pos = decode_varint(rbuf, rr.pos)
            key = bytes(rr._take(klen)) if klen >= 0 else None
            vlen, rr.pos = decode_varint(rbuf, rr.pos)
            value = bytes(rr._take(vlen)) if vlen >= 0 else b""
            out.append((base_offset + off_delta, first_ts + ts_delta,
                        key, value))
            rpos = rec_end
        pos = end
    return out, next_offset


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(n)
        if not c:
            raise ConnectionError("kafka peer closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _read_frame(sock: socket.socket) -> bytes:
    size = struct.unpack(">i", _read_exact(sock, 4))[0]
    if size < 0 or size > 64 << 20:
        raise ValueError(f"kafka frame size {size}")
    return _read_exact(sock, size)


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">i", len(payload)) + payload)


# ---------------------------------------------------------------------------
# broker (serves MockKafkaCluster over the wire)
# ---------------------------------------------------------------------------

class KafkaWireBroker:
    """Kafka-protocol front end for the embedded cluster."""

    def __init__(self, cluster: MockKafkaCluster, port: int = 0,
                 node_id: int = 0, host: str = "127.0.0.1",
                 auto_create_partitions: int = 16):
        self._cluster = cluster
        self.auto_create_partitions = auto_create_partitions
        self.node_id = node_id
        self.host = host
        self._committed: Dict[Tuple[str, str, int], int] = {}
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._stop = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="kafka-wire-broker", daemon=True)
        self._accept_thread.start()

    def stop(self) -> None:
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass

    # -- server loop -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop:
                req = _read_frame(conn)
                r = _R(req)
                api_key = r.i16()
                api_version = r.i16()
                correlation_id = r.i32()
                r.string()  # client_id
                body = self._dispatch(api_key, api_version, r)
                resp = _W().i32(correlation_id).raw(bytes(body.b))
                _send_frame(conn, bytes(resp.b))
        except (ConnectionError, ValueError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, api_key: int, version: int, r: _R) -> _W:
        lo_hi = _SUPPORTED.get(api_key)
        if lo_hi is None or not lo_hi[0] <= version <= lo_hi[1]:
            if api_key == API_API_VERSIONS:
                # protocol convention: an unsupported ApiVersions version
                # still gets error 35 PLUS the supported-versions array
                # (in the v0 shape) so the client can fall back to v0 —
                # modern clients open with v3+ and need this to connect
                return self._api_versions(error=35)
            # UNSUPPORTED_VERSION (35) in the shape of the closest body
            return _W().i16(35)
        if api_key == API_API_VERSIONS:
            return self._api_versions()
        if api_key == API_PRODUCE:
            return self._produce(r)
        if api_key == API_METADATA:
            return self._metadata(r)
        if api_key == API_LIST_OFFSETS:
            return self._list_offsets(r)
        if api_key == API_FETCH:
            return self._fetch(r)
        if api_key == API_OFFSET_COMMIT:
            return self._offset_commit(r)
        return self._offset_fetch(r)

    def _api_versions(self, error: int = ERR_NONE) -> _W:
        w = _W().i16(error).i32(len(_SUPPORTED))
        for key, (lo, hi) in sorted(_SUPPORTED.items()):
            w.i16(key).i16(lo).i16(hi)
        return w

    def _produce(self, r: _R) -> _W:
        """Produce v3: record batches decoded and appended to the
        embedded cluster — any Kafka-protocol producer can publish into
        the embedded queue. Unknown topics auto-create
        (``auto_create_partitions``), mirroring auto.create.topics."""
        r.string()                    # transactional_id
        r.i16()                       # acks (the append is synchronous)
        r.i32()                       # timeout_ms
        n_topics = r.i32()
        w = _W().i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            w.string(topic).i32(n_parts)
            for _ in range(n_parts):
                p = r.i32()
                record_set = r.bytes_() or b""
                if (self._cluster.num_partitions(topic) == 0
                        and self.auto_create_partitions > 0):
                    self._cluster.create_topic(
                        topic, max(self.auto_create_partitions, p + 1))
                if not 0 <= p < self._cluster.num_partitions(topic):
                    w.i32(p).i16(ERR_UNKNOWN_TOPIC_OR_PARTITION)
                    w.i64(-1).i64(-1)
                    continue
                try:
                    records = decode_record_batches(record_set)
                except ValueError:
                    w.i32(p).i16(87)  # INVALID_RECORD
                    w.i64(-1).i64(-1)
                    continue
                base_offset = -1
                for off, ts, key, value in records:
                    got = self._cluster.produce(
                        topic, p, key or b"", value, timestamp_ms=ts)
                    if base_offset < 0:
                        base_offset = got
                w.i32(p).i16(ERR_NONE).i64(base_offset).i64(-1)
        w.i32(0)                      # throttle_time_ms (trails in v1+)
        return w

    def _metadata(self, r: _R) -> _W:
        n = r.i32()
        names = (None if n < 0
                 else [r.string() for _ in range(n)])
        if names is None:
            names = self._cluster.topics()
        w = _W()
        w.i32(1)                                 # brokers
        w.i32(self.node_id).string(self.host).i32(self.port).string(None)
        w.i32(self.node_id)                      # controller_id
        w.i32(len(names))
        for t in names:
            parts = self._cluster.num_partitions(t)
            w.i16(ERR_NONE if parts else ERR_UNKNOWN_TOPIC_OR_PARTITION)
            w.string(t)
            w.i8(0)                              # is_internal
            w.i32(parts)
            for p in range(parts):
                w.i16(ERR_NONE).i32(p).i32(self.node_id)
                w.i32(1).i32(self.node_id)       # replicas
                w.i32(1).i32(self.node_id)       # isr
        return w

    def _list_offsets(self, r: _R) -> _W:
        r.i32()  # replica_id
        n_topics = r.i32()
        w = _W().i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            w.string(topic).i32(n_parts)
            for _ in range(n_parts):
                p = r.i32()
                ts = r.i64()
                if not 0 <= p < self._cluster.num_partitions(topic):
                    w.i32(p).i16(ERR_UNKNOWN_TOPIC_OR_PARTITION)
                    w.i64(-1).i64(-1)
                    continue
                if ts == -1:
                    off = self._cluster.high_watermark(topic, p)
                elif ts == -2:
                    off = 0
                else:
                    off = self._cluster.offset_for_timestamp(topic, p, ts)
                w.i32(p).i16(ERR_NONE).i64(-1).i64(off)
        return w

    def _fetch(self, r: _R) -> _W:
        r.i32()                       # replica_id
        max_wait_ms = r.i32()
        r.i32()                       # min_bytes
        max_bytes = r.i32()
        r.i8()                        # isolation_level
        n_topics = r.i32()
        requests = []
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            for _ in range(n_parts):
                p = r.i32()
                fetch_offset = r.i64()
                part_max = r.i32()
                requests.append((topic, p, fetch_offset, part_max))
        # long-poll: wait for data on ANY VALID requested partition (an
        # unknown topic/partition must produce an error entry below, not
        # an IndexError that kills the connection thread)
        waitable = [
            (t, p, off) for t, p, off, _m in requests
            if 0 <= p < self._cluster.num_partitions(t)
        ]
        deadline = time.monotonic() + max_wait_ms / 1000.0
        while waitable and time.monotonic() < deadline:
            if any(self._cluster.high_watermark(t, p) > off
                   for t, p, off in waitable):
                break
            remaining = deadline - time.monotonic()
            self._cluster.fetch(waitable[0][0], waitable[0][1],
                                waitable[0][2],
                                max(0.0, min(remaining, 0.05)))
        w = _W().i32(0)               # throttle_time_ms
        by_topic: Dict[str, List] = {}
        for t, p, off, m in requests:
            by_topic.setdefault(t, []).append((p, off, m))
        w.i32(len(by_topic))
        budget = max_bytes
        for topic, parts in by_topic.items():
            w.string(topic).i32(len(parts))
            for p, off, part_max in parts:
                if not 0 <= p < self._cluster.num_partitions(topic):
                    w.i32(p).i16(ERR_UNKNOWN_TOPIC_OR_PARTITION)
                    w.i64(-1).i64(-1).i32(0).bytes_(b"")
                    continue
                hwm = self._cluster.high_watermark(topic, p)
                if off > hwm or off < 0:
                    w.i32(p).i16(ERR_OFFSET_OUT_OF_RANGE)
                    w.i64(hwm).i64(hwm).i32(0).bytes_(b"")
                    continue
                records: List[Tuple[int, bytes, bytes]] = []
                size = 0
                o = off
                while o < hwm and size < min(part_max, budget):
                    m = self._cluster.fetch(topic, p, o, 0.0)
                    if m is None:
                        break
                    records.append((m.timestamp_ms, m.key, m.value))
                    size += len(m.key) + len(m.value) + 32
                    o += 1
                record_set = encode_record_batch(off, records)
                budget -= len(record_set)
                w.i32(p).i16(ERR_NONE).i64(hwm).i64(hwm)
                w.i32(0)              # aborted_transactions
                w.bytes_(record_set)
        return w

    def _offset_commit(self, r: _R) -> _W:
        group = r.string()
        r.i32()                       # generation_id
        r.string()                    # member_id
        r.i64()                       # retention_time
        n_topics = r.i32()
        w = _W().i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            w.string(topic).i32(n_parts)
            for _ in range(n_parts):
                p = r.i32()
                off = r.i64()
                r.string()            # metadata
                with self._lock:
                    self._committed[(group, topic, p)] = off
                w.i32(p).i16(ERR_NONE)
        return w

    def _offset_fetch(self, r: _R) -> _W:
        group = r.string()
        n_topics = r.i32()
        w = _W().i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            w.string(topic).i32(n_parts)
            for _ in range(n_parts):
                p = r.i32()
                with self._lock:
                    off = self._committed.get((group, topic, p), -1)
                w.i32(p).i64(off).string(None).i16(ERR_NONE)
        return w


# ---------------------------------------------------------------------------
# consumer
# ---------------------------------------------------------------------------

class KafkaWireConsumer(Consumer):
    """Consumer over the Kafka binary protocol (any compliant broker).

    Mirrors the reference consumer's librdkafka usage
    (kafka_consumer.h:27-118): assign + seek (no group rebalancing),
    timestamp seek via ListOffsets, offsets committed to the group
    coordinator via OffsetCommit."""

    def __init__(self, host: str, port: int, group_id: str = "",
                 client_id: str = "rstpu-wire", connect_timeout: float = 10.0):
        self.group_id = group_id
        self._client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()  # rstpu-check: io-mutex serializes round-trips on the one blocking kafka socket
        self._sock = socket.create_connection((host, port), connect_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._topic: Optional[str] = None
        self._positions: Dict[int, int] = {}
        self._buffers: Dict[int, deque] = {}
        self._rr: List[int] = []
        self.api_versions = self._api_versions_handshake()

    # -- request plumbing --------------------------------------------------

    def _request(self, api_key: int, api_version: int, body: bytes) -> _R:
        with self._lock:
            self._corr += 1
            corr = self._corr
            head = _W().i16(api_key).i16(api_version).i32(corr)
            head.string(self._client_id)
            _send_frame(self._sock, bytes(head.b) + body)
            resp = _R(_read_frame(self._sock))
        got = resp.i32()
        if got != corr:
            raise ValueError(f"kafka: correlation mismatch {got} != {corr}")
        return resp

    def _api_versions_handshake(self) -> Dict[int, Tuple[int, int]]:
        r = self._request(API_API_VERSIONS, 0, b"")
        err = r.i16()
        if err:
            raise ValueError(f"kafka ApiVersions error {err}")
        out = {}
        for _ in range(r.i32()):
            key, lo, hi = r.i16(), r.i16(), r.i16()
            out[key] = (lo, hi)
        for key, ver in ((API_FETCH, 4), (API_LIST_OFFSETS, 1),
                         (API_METADATA, 1)):
            lo, hi = out.get(key, (0, -1))
            if not lo <= ver <= hi:
                raise ValueError(
                    f"kafka: broker lacks api {key} v{ver} "
                    f"(supports {lo}..{hi})")
        return out

    # -- metadata ----------------------------------------------------------

    def partitions_for(self, topic: str) -> int:
        body = _W().i32(1).string(topic)
        r = self._request(API_METADATA, 1, bytes(body.b))
        for _ in range(r.i32()):      # brokers
            r.i32(); r.string(); r.i32(); r.string()
        r.i32()                       # controller_id
        n_topics = r.i32()
        for _ in range(n_topics):
            err = r.i16()
            name = r.string()
            r.i8()
            n_parts = r.i32()
            for _ in range(n_parts):
                r.i16(); r.i32(); r.i32()
                for _ in range(r.i32()):
                    r.i32()
                for _ in range(r.i32()):
                    r.i32()
            if name == topic:
                if err:
                    raise KeyError(f"kafka topic {topic}: error {err}")
                return n_parts
        raise KeyError(f"kafka topic {topic}: not in metadata")

    # -- Consumer interface ------------------------------------------------

    def assign(self, topic: str, partitions: Sequence[int]) -> None:
        self._topic = topic
        self._positions = {p: 0 for p in partitions}
        self._buffers = {p: deque() for p in partitions}
        self._rr = list(partitions)

    def seek(self, partition: int, offset: int) -> None:
        self._positions[partition] = offset
        self._buffers[partition].clear()

    def _list_offsets(self, timestamp: int) -> Dict[int, int]:
        assert self._topic is not None
        body = _W().i32(-1).i32(1).string(self._topic)
        body.i32(len(self._positions))
        for p in self._positions:
            body.i32(p).i64(timestamp)
        r = self._request(API_LIST_OFFSETS, 1, bytes(body.b))
        out = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                p = r.i32()
                err = r.i16()
                r.i64()               # timestamp
                off = r.i64()
                if err:
                    raise ValueError(f"kafka ListOffsets p{p}: error {err}")
                out[p] = off
        return out

    def seek_to_timestamp(self, ts_ms: int) -> None:
        for p, off in self._list_offsets(ts_ms).items():
            self.seek(p, off)

    def high_watermark(self, partition: int) -> int:
        return self._list_offsets(-1)[partition]

    def position(self, partition: int) -> int:
        return self._positions[partition]

    def _fetch_into_buffers(self, timeout_sec: float) -> None:
        assert self._topic is not None
        body = _W().i32(-1).i32(max(0, int(timeout_sec * 1000)))
        body.i32(1)                   # min_bytes
        body.i32(8 << 20)             # max_bytes
        body.i8(0)                    # isolation_level: READ_UNCOMMITTED
        body.i32(1).string(self._topic).i32(len(self._positions))
        for p in self._rr:
            body.i32(p).i64(self._positions[p]).i32(1 << 20)
        r = self._request(API_FETCH, 4, bytes(body.b))
        r.i32()                       # throttle_time_ms
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                p = r.i32()
                err = r.i16()
                hwm = r.i64()         # high_watermark
                r.i64()               # last_stable_offset
                for _ in range(r.i32()):
                    r.i64(); r.i64()  # aborted txns
                record_set = r.bytes_() or b""
                if err:
                    # swallowing this would wedge consume() in an
                    # indefinite empty-poll loop (e.g. retention deleted
                    # our position: every fetch repeats the error). Fail
                    # loudly with enough context to reseek.
                    raise KafkaWireError(
                        f"kafka fetch {self._topic}[{p}] "
                        f"@{self._positions.get(p)}: error {err}",
                        error_code=err, partition=p, high_watermark=hwm)
                records, next_off = decode_record_set(record_set)
                delivered = False
                for off, ts, key, value in records:
                    if off < self._positions[p]:
                        continue      # broker returned the whole batch
                    delivered = True
                    self._buffers[p].append(Message(
                        topic=self._topic, partition=p, offset=off,
                        timestamp_ms=ts, key=key or b"", value=value,
                    ))
                if (not delivered and not self._buffers[p]
                        and next_off is not None
                        and next_off > self._positions[p]):
                    # nothing consumable (control markers / compacted
                    # batches): advance past them or the next fetch
                    # refetches the same batch forever
                    self._positions[p] = next_off

    def consume(self, timeout_sec: float) -> Optional[Message]:
        assert self._topic is not None
        deadline = time.monotonic() + timeout_sec
        while True:
            for _ in range(len(self._rr)):
                p = self._rr.pop(0)
                self._rr.append(p)
                if self._buffers[p]:
                    msg = self._buffers[p].popleft()
                    self._positions[p] = msg.offset + 1
                    return msg
            remaining = deadline - time.monotonic()
            if remaining < 0:
                return None
            self._fetch_into_buffers(min(remaining, 0.5))
            if not any(self._buffers.values()) and remaining <= 0.5:
                return None

    def commit(self) -> None:
        assert self._topic is not None
        body = _W().string(self.group_id).i32(-1).string("").i64(-1)
        body.i32(1).string(self._topic).i32(len(self._positions))
        for p, off in self._positions.items():
            body.i32(p).i64(off).string(None)
        r = self._request(API_OFFSET_COMMIT, 2, bytes(body.b))
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                p = r.i32()
                err = r.i16()
                if err:
                    raise ValueError(f"kafka OffsetCommit p{p}: error {err}")

    def committed_offsets(self) -> Dict[int, int]:
        assert self._topic is not None
        body = _W().string(self.group_id)
        body.i32(1).string(self._topic).i32(len(self._positions))
        for p in self._positions:
            body.i32(p)
        r = self._request(API_OFFSET_FETCH, 1, bytes(body.b))
        out = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                p = r.i32()
                off = r.i64()
                r.string()
                err = r.i16()
                if err:
                    raise ValueError(f"kafka OffsetFetch p{p}: error {err}")
                if off >= 0:
                    out[p] = off
        return out

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class KafkaWireProducer:
    """Minimal Kafka-protocol producer (Produce v3, acks=1): one record
    batch per request — the CDC publish cadence, not a bulk pipeline.
    Works against any Kafka-protocol broker (the reference publishes CDC
    updates through librdkafka producers)."""

    def __init__(self, host: str, port: int, client_id: str = "rstpu-wire",
                 connect_timeout: float = 10.0):
        self._client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()  # rstpu-check: io-mutex serializes round-trips on the one blocking kafka socket
        self._sock = socket.create_connection((host, port), connect_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _request(self, api_key: int, api_version: int, body: bytes) -> _R:
        with self._lock:
            self._corr += 1
            corr = self._corr
            head = _W().i16(api_key).i16(api_version).i32(corr)
            head.string(self._client_id)
            _send_frame(self._sock, bytes(head.b) + body)
            resp = _R(_read_frame(self._sock))
        got = resp.i32()
        if got != corr:
            raise ValueError(f"kafka: correlation mismatch {got} != {corr}")
        return resp

    def produce(self, topic: str, partition: int, key: bytes, value: bytes,
                timestamp_ms: int) -> int:
        """Appends one record; returns its offset."""
        record_set = encode_record_batch(
            0, [(timestamp_ms, key, value)])
        body = _W().string(None).i16(1).i32(30_000)
        body.i32(1).string(topic).i32(1)
        body.i32(partition).bytes_(record_set)
        r = self._request(API_PRODUCE, 3, bytes(body.b))
        base_offset = -1
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                p = r.i32()
                err = r.i16()
                off = r.i64()
                r.i64()               # log_append_time
                if err:
                    raise KafkaWireError(
                        f"kafka produce {topic}[{p}]: error {err}",
                        error_code=err, partition=p)
                base_offset = off
        return base_offset

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class KafkaWirePublisher:
    """CDC Publisher callable over the wire protocol — the drop-in
    real-Kafka variant of kafka/publisher.QueuePublisher (same partition
    routing: shard id mod partitions)."""

    def __init__(self, topic: str, host: str, port: int,
                 num_partitions: int = 16):
        from ..utils.segment_utils import extract_shard_id

        self._extract_shard_id = extract_shard_id
        self._topic = topic
        self._num_partitions = num_partitions
        self._producer = KafkaWireProducer(host, port)

    def __call__(self, db_name: str, start_seq: int, raw: bytes,
                 timestamp_ms) -> None:
        shard = self._extract_shard_id(db_name)
        partition = shard % self._num_partitions if shard >= 0 else 0
        self._producer.produce(
            self._topic, partition,
            key=f"{db_name}:{start_seq}".encode(), value=bytes(raw),
            timestamp_ms=int(timestamp_ms) if timestamp_ms else 0,
        )

    def close(self) -> None:
        self._producer.close()
