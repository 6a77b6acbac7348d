"""The port's Kafka wire protocol (``kafka/wire.py``) against the JAX
package's: the reference's codec vectors, golden frames and guards
(``tests/test_kafka_wire.py``) on the port, with every encoded byte and
every decoded record equal to the reference's (tolerance 0), and the
reference's interop scenarios over real TCP for each pairing of broker
and client packages: port with port, a port ``KafkaWireConsumer`` (and
producer, publisher, watcher) against a reference ``KafkaWireBroker``, and
a reference client against a port broker."""

import importlib
import random
import socket
import struct
import threading
import time

import pytest

import rocksplicator_tpu.kafka.wire as rw
import rocksplicator_tpu_torch.kafka.wire as pw
from torch_parity import PACKAGES, wait_until

# (broker package, client package)
PAIRS = [("port", "port"), ("ref", "port"), ("port", "ref")]


def mod(key, name):
    return importlib.import_module(f"{PACKAGES[key]}.kafka.{name}")


def _recrc(buf: bytes, body_off: int) -> bytes:
    b = bytearray(buf)
    struct.pack_into(">I", b, body_off - 4, pw.crc32c(bytes(b[body_off:])))
    return bytes(b)


BODY_OFF = 8 + 4 + 4 + 1 + 4  # base_offset, len, epoch, magic, crc


# -- primitives -------------------------------------------------------------

def test_crc32c_known_vectors():
    assert pw.crc32c(b"123456789") == 0xE3069283
    assert pw.crc32c(b"") == 0x0
    assert pw.crc32c(b"\x00" * 32) == 0x8A9136AA
    rng = random.Random(5)
    for n in (1, 7, 8, 64, 1000):
        buf = rng.randbytes(n)
        assert pw.crc32c(buf) == rw.crc32c(buf)


def test_varint_zigzag_vectors():
    for value, wire in [
        (0, b"\x00"), (-1, b"\x01"), (1, b"\x02"), (-2, b"\x03"),
        (63, b"\x7e"), (64, b"\x80\x01"), (-64, b"\x7f"),
        (300, b"\xd8\x04"),
    ]:
        assert pw.encode_varint(value) == wire, value
        assert pw.decode_varint(wire, 0) == (value, len(wire))
    for value in (-(1 << 40), -70000, 12345, 1 << 40):
        assert pw.encode_varint(value) == rw.encode_varint(value)


def test_record_batch_roundtrip_and_crc_guard():
    records = [(1000, b"k1", b"v1"), (1005, b"k2", b"longer-value" * 9),
               (1010, None, b"null-key")]
    batch = pw.encode_record_batch(41, records)
    assert batch == rw.encode_record_batch(41, records)
    assert pw.decode_record_batches(batch) == [
        (41, 1000, b"k1", b"v1"),
        (42, 1005, b"k2", b"longer-value" * 9),
        (43, 1010, None, b"null-key"),
    ]
    corrupt = bytearray(batch)
    corrupt[-1] ^= 0x40
    with pytest.raises(ValueError, match="CRC"):
        pw.decode_record_batches(bytes(corrupt))


def test_record_batch_golden_bytes():
    batch = pw.encode_record_batch(7, [(1500, b"key", b"value")])
    assert batch.hex() == (
        "0000000000000007" "00000040" "00000000" "02" "defd924f" "0000"
        "00000000" "00000000000005dc" "00000000000005dc" "ffffffffffffffff"
        "ffff" "ffffffff" "00000001" "1c" "00" "00" "00" "06" "6b6579"
        "0a" "76616c7565" "00")
    assert pw.decode_record_batches(batch) == [(7, 1500, b"key", b"value")]


GZIP_FRAME = bytes.fromhex(
    "000000000000002a" "0000006f" "00000000" "02" "0e61cb04" "0001"
    "00000002" "000001897bd98400" "000001897bd98409" "ffffffffffffffff"
    "ffff" "ffffffff" "00000003"
    "1f8b08000000000002ff93616060e04acc29c84864cbcf4b65106260636264"
    "2b29cf6750601062e14a4fcccd4de42ac9284a4d6500005f8158192a000000")


def test_record_batch_gzip_golden_frame():
    records, next_off = pw.decode_record_set(GZIP_FRAME)
    assert records == [
        (42, 1690000000000, b"alpha", b"one"),
        (43, 1690000000003, None, b"two"),
        (44, 1690000000009, b"gamma", b"three"),
    ]
    assert next_off == 45
    assert (records, next_off) == rw.decode_record_set(GZIP_FRAME)
    corrupt = bytearray(GZIP_FRAME)
    corrupt[-10] ^= 0x01
    with pytest.raises(ValueError, match="CRC"):
        pw.decode_record_batches(bytes(corrupt))


def _with_codec(batch: bytes, codec: int) -> bytes:
    b = bytearray(batch)
    attrs = (struct.unpack_from(">h", b, BODY_OFF)[0] & ~0x07) | codec
    struct.pack_into(">h", b, BODY_OFF, attrs)
    return _recrc(bytes(b), BODY_OFF)


@pytest.mark.parametrize("codec", ["gzip", "snappy"])
def test_record_batch_compressed_roundtrip_and_guards(monkeypatch, codec):
    """Both encoders' opt-in codecs write the reference's bytes and
    round-trip; lz4/zstd stay rejected, uncompressed bytes under codec 2
    fail in the snappy decoder, and the cumulative decompression cap
    bounds a bomb and a set of batches."""
    records = [(1000, b"k1", b"v" * 300), (1010, None, b"v2"),
               (1020, b"k3", b"abcd" * 40)]
    enc = pw.encode_record_batch(9, records, codec=codec)
    assert enc == rw.encode_record_batch(9, records, codec=codec)
    assert pw.decode_record_batches(enc) == pw.decode_record_batches(
        pw.encode_record_batch(9, records))
    plain = pw.encode_record_batch(0, [(1, b"k", b"v")])
    for bad in (3, 4):
        with pytest.raises(ValueError, match="codec"):
            pw.decode_record_batches(_with_codec(plain, bad))
    with pytest.raises(ValueError, match="snappy"):
        pw.decode_record_batches(_with_codec(plain, 2))
    monkeypatch.setattr(pw, "_MAX_DECOMPRESSED", 1 << 10)
    bomb = pw.encode_record_batch(0, [(1, b"k", b"\x00" * (1 << 12))],
                                  codec=codec)
    with pytest.raises(ValueError, match="size cap"):
        pw.decode_record_batches(bomb)
    one = pw.encode_record_batch(0, [(1, b"k", b"\x00" * 600)], codec=codec)
    assert pw.decode_record_batches(one)
    two = one + pw.encode_record_batch(1, [(2, b"k", b"\x00" * 600)],
                                       codec="gzip")
    with pytest.raises(ValueError, match="size cap"):
        pw.decode_record_batches(two)


SNAPPY_FRAME = bytes.fromhex(
    "000000000000002a" "00000062" "00000000" "02" "53a70268" "0002"
    "00000002" "000001897bd98400" "000001897bd98409" "ffffffffffffffff"
    "ffff" "ffffffff" "00000003" "37"
    "601c0000000a616c706861066f6e65002c000602012061626364" "2e0400"
    "4400200012040a67616d6d610a746872656500")


def test_record_batch_snappy_golden_frame():
    expect = [
        (42, 1690000000000, b"alpha", b"one"),
        (43, 1690000000003, None, b"abcdabcdabcdabcd"),
        (44, 1690000000009, b"gamma", b"three"),
    ]
    assert pw.decode_record_set(SNAPPY_FRAME) == (expect, 45)
    corrupt = bytearray(SNAPPY_FRAME)
    corrupt[-10] ^= 0x01
    with pytest.raises(ValueError, match="CRC"):
        pw.decode_record_batches(bytes(corrupt))
    head_len = 2 + 4 + 8 + 8 + 8 + 2 + 4 + 4
    body = SNAPPY_FRAME[BODY_OFF:]
    block = body[head_len:]
    xer = (b"\x82SNAPPY\x00" + struct.pack(">ii", 1, 1)
           + struct.pack(">I", len(block)) + block)
    xbody = body[:head_len] + xer
    xbatch = (struct.pack(">qiib", 42, 4 + 1 + 4 + len(xbody), 0, 2)
              + struct.pack(">I", pw.crc32c(xbody)) + xbody)
    assert pw.decode_record_set(xbatch)[0] == expect
    assert rw.decode_record_set(xbatch) == pw.decode_record_set(xbatch)


def test_control_batch_skipped_but_advances_offset():
    data = pw.encode_record_batch(0, [(1, b"k", b"v")])
    control = bytearray(pw.encode_record_batch(
        1, [(2, b"\x00\x00\x00\x01", b"")]))
    attrs = struct.unpack_from(">h", control, BODY_OFF)[0] | 0x20
    struct.pack_into(">h", control, BODY_OFF, attrs)
    control = _recrc(bytes(control), BODY_OFF)
    assert pw.decode_record_batches(data + control) == [(0, 1, b"k", b"v")]
    assert pw.decode_record_set(control) == ([], 2)


@pytest.mark.parametrize("broker_pkg", ["port"])
def test_api_versions_fallback_shape(broker_pkg):
    w = mod(broker_pkg, "wire")
    cluster = mod(broker_pkg, "broker").MockKafkaCluster()
    broker = w.KafkaWireBroker(cluster)
    try:
        s = socket.create_connection(("127.0.0.1", broker.port), 5.0)
        head = struct.pack(">hhih", w.API_API_VERSIONS, 3, 77, -1)
        s.sendall(struct.pack(">i", len(head)) + head)
        size = struct.unpack(">i", s.recv(4))[0]
        buf = b""
        while len(buf) < size:
            buf += s.recv(size - len(buf))
        s.close()
        r = w._R(buf)
        assert r.i32() == 77
        assert r.i16() == 35
        n = r.i32()
        assert n > 0
        versions = {r.i16(): (r.i16(), r.i16()) for _ in range(n)}
        assert versions[w.API_API_VERSIONS] == (0, 0)
    finally:
        broker.stop()


def _decode_or_error(w, buf):
    try:
        return w.decode_record_set(buf)
    except ValueError:
        return "ValueError"


def test_decoder_hostile_input_exception_discipline():
    """Random and mutated batches (half of the mutated ones re-stamped
    with a valid CRC, so they reach the record parser) raise nothing but
    ValueError from the port's decoder, and the port decodes or refuses
    each one exactly as the reference does."""
    from conftest import hostile_cases

    rng = random.Random(3)
    base = pw.encode_record_batch(
        5, [(100 + i, f"k{i}".encode(), b"v" * 20) for i in range(10)])
    for i, buf in enumerate(hostile_cases(rng, base, 400)):
        if i % 4 == 3 and len(buf) >= BODY_OFF:
            buf = _recrc(buf, BODY_OFF)
        assert _decode_or_error(pw, buf) == _decode_or_error(rw, buf), i


def test_partial_trailing_batch_tolerated():
    batch = pw.encode_record_batch(0, [(1, b"a", b"b"), (2, b"c", b"d")])
    assert pw.decode_record_batches(batch + batch[: len(batch) // 2]) == \
        pw.decode_record_batches(batch)


# -- wire interop, each pairing of broker and client packages ---------------

@pytest.fixture(params=PAIRS, ids=lambda p: f"broker-{p[0]}-client-{p[1]}")
def wire_pair(request):
    broker_pkg, client_pkg = request.param
    cluster = mod(broker_pkg, "broker").MockKafkaCluster()
    cluster.create_topic("t", 2)
    broker = mod(broker_pkg, "wire").KafkaWireBroker(cluster)
    cw = mod(client_pkg, "wire")
    consumers = []

    def make_consumer(group="g1"):
        c = cw.KafkaWireConsumer("127.0.0.1", broker.port, group_id=group)
        consumers.append(c)
        return c

    yield cluster, broker, make_consumer, client_pkg
    for c in consumers:
        c.close()
    broker.stop()


def test_wire_handshake_and_metadata(wire_pair):
    _cluster, _broker, make_consumer, _pkg = wire_pair
    c = make_consumer()
    assert c.api_versions[1][1] >= 4
    assert c.partitions_for("t") == 2
    with pytest.raises(KeyError):
        c.partitions_for("nope")


def test_wire_produce_consume_roundtrip(wire_pair):
    cluster, _broker, make_consumer, _pkg = wire_pair
    for i in range(10):
        cluster.produce("t", i % 2, f"k{i}".encode(), f"v{i}".encode(),
                        timestamp_ms=5000 + i)
    c = make_consumer()
    c.assign("t", [0, 1])
    got = {}
    for _ in range(10):
        m = c.consume(5.0)
        assert m is not None
        got[m.key] = (m.value, m.partition, m.offset, m.timestamp_ms)
    assert got[b"k3"] == (b"v3", 1, 1, 5003)
    assert c.consume(0.2) is None
    assert c.position(0) == 5 and c.position(1) == 5
    assert c.high_watermark(0) == 5


def test_wire_timestamp_seek(wire_pair):
    cluster, _broker, make_consumer, _pkg = wire_pair
    for i in range(6):
        cluster.produce("t", 0, f"k{i}".encode(), b"v",
                        timestamp_ms=1000 + 10 * i)
    c = make_consumer()
    c.assign("t", [0])
    c.seek_to_timestamp(1025)
    m = c.consume(5.0)
    assert m.key == b"k3" and m.offset == 3


def test_wire_commit_recovery(wire_pair):
    cluster, _broker, make_consumer, _pkg = wire_pair
    for i in range(4):
        cluster.produce("t", 0, f"k{i}".encode(), b"v")
    c1 = make_consumer("grp")
    c1.assign("t", [0])
    assert c1.consume(5.0).key == b"k0"
    assert c1.consume(5.0).key == b"k1"
    c1.commit()
    c1.close()
    c2 = make_consumer("grp")
    c2.assign("t", [0])
    assert c2.committed_offsets() == {0: 2}
    c2.seek(0, 2)
    assert c2.consume(5.0).key == b"k2"


def test_wire_blocking_fetch_long_poll(wire_pair):
    cluster, _broker, make_consumer, _pkg = wire_pair
    c = make_consumer()
    c.assign("t", [0])
    result = {}
    t = threading.Thread(target=lambda: result.update(msg=c.consume(10.0)))
    t.start()
    time.sleep(0.3)
    cluster.produce("t", 0, b"late", b"v")
    t.join(10.0)
    assert not t.is_alive()
    assert result["msg"] is not None and result["msg"].key == b"late"


def test_wire_offset_out_of_range_raises(wire_pair):
    cluster, _broker, make_consumer, client_pkg = wire_pair
    cluster.produce("t", 0, b"k", b"v")
    c = make_consumer()
    c.assign("t", [0])
    c.seek(0, 999)
    with pytest.raises(mod(client_pkg, "wire").KafkaWireError) as ei:
        c.consume(1.0)
    assert ei.value.error_code == 1 and ei.value.partition == 0
    assert ei.value.high_watermark == 1
    c.seek(0, 0)
    assert c.consume(5.0).key == b"k"


def test_wire_broker_survives_bad_partition_fetch(wire_pair):
    cluster, _broker, make_consumer, client_pkg = wire_pair
    c = make_consumer()
    c.assign("t", [7])
    with pytest.raises(mod(client_pkg, "wire").KafkaWireError) as ei:
        c.consume(0.5)
    assert ei.value.error_code == 3
    cluster.produce("t", 0, b"after", b"v")
    c.assign("t", [0])
    assert c.consume(5.0).key == b"after"


def test_watcher_replay_then_live_over_wire(wire_pair):
    cluster, _broker, make_consumer, client_pkg = wire_pair
    for i in range(5):
        cluster.produce("t", 0, f"old{i}".encode(), b"v",
                        timestamp_ms=1000 + i)
    seen = []
    watcher = mod(client_pkg, "watcher").KafkaWatcher(
        "w", make_consumer(), "t", [0], start_timestamp_ms=1002,
        on_message=lambda m, replay: seen.append((m.key, replay)),
    ).start()
    try:
        assert wait_until(watcher.replay_done.is_set, timeout=15)
        assert seen == [(b"old2", True), (b"old3", True), (b"old4", True)]
        cluster.produce("t", 0, b"live1", b"v")
        assert wait_until(lambda: (b"live1", False) in seen, timeout=15)
    finally:
        watcher.stop()


def test_wire_produce_roundtrip(wire_pair):
    cluster, broker, make_consumer, client_pkg = wire_pair
    prod = mod(client_pkg, "wire").KafkaWireProducer("127.0.0.1",
                                                      broker.port)
    try:
        assert (prod.produce("t", 0, b"pk0", b"pv0", 9000),
                prod.produce("t", 0, b"pk1", b"pv1", 9001)) == (0, 1)
        prod.produce("fresh-topic", 3, b"k", b"v", 9002)
        assert cluster.num_partitions("fresh-topic") >= 4
        c = make_consumer()
        c.assign("t", [0])
        m0, m1 = c.consume(5.0), c.consume(5.0)
        assert (m0.key, m0.value, m0.timestamp_ms) == (b"pk0", b"pv0", 9000)
        assert (m1.key, m1.value, m1.offset) == (b"pk1", b"pv1", 1)
    finally:
        prod.close()


def test_cdc_wire_publisher_routes_by_shard(wire_pair):
    cluster, broker, make_consumer, client_pkg = wire_pair
    cluster.create_topic("cdc", 16)
    pub = mod(client_pkg, "wire").KafkaWirePublisher(
        "cdc", "127.0.0.1", broker.port, num_partitions=16)
    try:
        pub("seg00003", 41, b"raw-batch-bytes", 7777)
        c = make_consumer()
        c.assign("cdc", [3])
        m = c.consume(5.0)
        assert (m.key, m.value, m.timestamp_ms) == (
            b"seg00003:41", b"raw-batch-bytes", 7777)
    finally:
        pub.close()
