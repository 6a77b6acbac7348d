"""Networked queue broker: a real cross-process message-ingestion path.
(The port's copy of ``rocksplicator_tpu/kafka/network.py``.)

Reference: the C++ stack consumes real Kafka via librdkafka
(common/kafka/kafka_consumer.h:27-118 — Seek by timestamp/offset,
Consume, Commit) from brokers in other processes. This module is its
equivalent: a standalone ``BrokerServer`` process hosting
durable topic/partition logs behind the framework's own RPC plane, plus
``NetworkConsumer`` / ``NetworkProducer`` clients. The embedded
``MockKafkaCluster`` stays the in-process test backend behind the same
``Consumer`` interface.

Durability: each (topic, partition) appends to
``<data_dir>/<topic>.<partition>.log`` (u32 len-prefixed records:
u64 timestamp_ms, u32 klen, key, value) reloaded on start, so ingestion
resume-from-timestamp works across broker restarts (the reference's
brokers are durable too; admin resume relies on it). Committed group
offsets persist to ``offsets.json``.

Run a broker:  python -m rocksplicator_tpu_torch.kafka.network \
                   --port 9092 --data_dir /var/broker
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import struct
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..rpc import IoLoop, RpcClientPool, RpcServer
from ..rpc.errors import RpcApplicationError
from .broker import Consumer, Message, MockKafkaCluster

_REC = struct.Struct("<QI")  # timestamp_ms, key_len (value = rest)


class _DurableLog:
    """Append-only record log for one (topic, partition)."""

    def __init__(self, path: str):
        self._path = path
        self._f = None

    def load(self, sink) -> None:
        if not os.path.isfile(self._path):
            return
        with open(self._path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 4 <= len(data):
            (rec_len,) = struct.unpack_from("<I", data, pos)
            if pos + 4 + rec_len > len(data):
                break  # torn tail from a crash mid-append — drop it
            rec = data[pos + 4: pos + 4 + rec_len]
            ts, klen = _REC.unpack_from(rec, 0)
            key = rec[_REC.size: _REC.size + klen]
            value = rec[_REC.size + klen:]
            sink(ts, key, value)
            pos += 4 + rec_len
        if pos < len(data):  # truncate the torn tail
            with open(self._path, "r+b") as f:
                f.truncate(pos)

    def append(self, ts_ms: int, key: bytes, value: bytes) -> None:
        if self._f is None:
            self._f = open(self._path, "ab")
        rec = _REC.pack(ts_ms, len(key)) + key + value
        self._f.write(struct.pack("<I", len(rec)) + rec)
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class BrokerHandler:
    """RPC handler hosting the broker state (methods are ``broker_*`` so
    it can stack with other handlers on one RpcServer)."""

    def __init__(self, data_dir: Optional[str] = None,
                 fetch_threads: int = 64):
        self._cluster = MockKafkaCluster()
        self._data_dir = data_dir
        self._logs: Dict[Tuple[str, int], _DurableLog] = {}
        self._log_lock = threading.Lock()
        # group -> topic -> {partition: offset}
        self._offsets: Dict[str, Dict[str, Dict[str, int]]] = {}
        # long-poll fetches park a thread each; a dedicated executor keeps
        # them from starving the process-wide asyncio default executor
        from concurrent.futures import ThreadPoolExecutor

        self._fetch_executor = ThreadPoolExecutor(
            max_workers=fetch_threads, thread_name_prefix="broker-fetch")
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._load()

    # -- persistence -------------------------------------------------------

    def _log_for(self, topic: str, partition: int) -> Optional[_DurableLog]:
        if not self._data_dir:
            return None
        with self._log_lock:
            log = self._logs.get((topic, partition))
            if log is None:
                log = self._logs[(topic, partition)] = _DurableLog(
                    os.path.join(self._data_dir,
                                 f"{topic}.{partition}.log"))
            return log

    def _load(self) -> None:
        assert self._data_dir is not None
        # topics meta
        meta_path = os.path.join(self._data_dir, "topics.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                topics = json.load(f)
            for topic, n in topics.items():
                self._cluster.create_topic(topic, n)
                for p in range(n):
                    log = self._log_for(topic, p)
                    if log:
                        log.load(
                            lambda ts, k, v, t=topic, pp=p:
                            self._cluster.produce(t, pp, k, v, ts)
                        )
        off_path = os.path.join(self._data_dir, "offsets.json")
        if os.path.isfile(off_path):
            with open(off_path) as f:
                self._offsets = json.load(f)

    def _persist_topics(self) -> None:
        if not self._data_dir:
            return
        topics = {
            t: self._cluster.num_partitions(t)
            for t in self._cluster.topics()
        }
        tmp = os.path.join(self._data_dir, "topics.json.tmp")
        with open(tmp, "w") as f:
            json.dump(topics, f)
        os.replace(tmp, os.path.join(self._data_dir, "topics.json"))

    def _persist_offsets(self) -> None:
        if not self._data_dir:
            return
        tmp = os.path.join(self._data_dir, "offsets.json.tmp")
        with open(tmp, "w") as f:
            json.dump(self._offsets, f)
        os.replace(tmp, os.path.join(self._data_dir, "offsets.json"))

    # -- RPC methods -------------------------------------------------------

    async def handle_broker_create_topic(
        self, topic: str = "", num_partitions: int = 1
    ) -> dict:
        self._cluster.create_topic(topic, num_partitions)
        self._persist_topics()
        return {"ok": True}

    async def handle_broker_num_partitions(self, topic: str = "") -> dict:
        return {"num_partitions": self._cluster.num_partitions(topic)}

    async def handle_broker_produce(
        self, topic: str = "", partition: int = 0, key: bytes = b"",
        value: bytes = b"", timestamp_ms: Optional[int] = None,
    ) -> dict:
        key, value = bytes(key), bytes(value)
        ts = (int(timestamp_ms) if timestamp_ms is not None
              else int(time.time() * 1000))
        try:
            offset = self._cluster.produce(topic, partition, key, value, ts)
        except (KeyError, IndexError) as e:
            raise RpcApplicationError("NO_SUCH_TOPIC", str(e))
        log = self._log_for(topic, partition)
        if log:
            with self._log_lock:
                log.append(ts, key, value)
        return {"offset": offset}

    async def handle_broker_fetch(
        self, topic: str = "", partition: int = 0, offset: int = 0,
        max_wait_ms: int = 1000, max_messages: int = 50,
    ) -> dict:
        """Batched long-poll fetch (the replicate-RPC pattern applied to
        the queue: park until data or timeout, then return ≤N messages)."""
        loop = asyncio.get_running_loop()
        first = await loop.run_in_executor(
            self._fetch_executor, self._cluster.fetch, topic, partition,
            offset, max_wait_ms / 1000.0,
        )
        msgs: List[dict] = []
        if first is not None:
            msgs.append(self._msg_dict(first))
            next_off = first.offset + 1
            while len(msgs) < max_messages:
                m = self._cluster.fetch(topic, partition, next_off, 0.0)
                if m is None:
                    break
                msgs.append(self._msg_dict(m))
                next_off = m.offset + 1
        return {"messages": msgs}

    @staticmethod
    def _msg_dict(m: Message) -> dict:
        return {
            "partition": m.partition, "offset": m.offset,
            "timestamp_ms": m.timestamp_ms, "key": m.key, "value": m.value,
        }

    async def handle_broker_high_watermark(
        self, topic: str = "", partition: int = 0
    ) -> dict:
        return {"offset": self._cluster.high_watermark(topic, partition)}

    async def handle_broker_offset_for_timestamp(
        self, topic: str = "", partition: int = 0, timestamp_ms: int = 0
    ) -> dict:
        return {
            "offset": self._cluster.offset_for_timestamp(
                topic, partition, timestamp_ms)
        }

    async def handle_broker_commit(
        self, group: str = "", topic: str = "",
        offsets: Optional[Dict[str, int]] = None,
    ) -> dict:
        # merge per partition: different consumers in one group may each
        # commit only the partitions they own
        self._offsets.setdefault(group, {}).setdefault(topic, {}).update(
            offsets or {})
        self._persist_offsets()
        return {"ok": True}

    async def handle_broker_committed(
        self, group: str = "", topic: str = ""
    ) -> dict:
        return {"offsets": self._offsets.get(group, {}).get(topic, {})}

    def close(self) -> None:
        self._fetch_executor.shutdown(wait=False)
        with self._log_lock:
            for log in self._logs.values():
                log.close()


class BrokerServer:
    """Standalone broker: RpcServer + BrokerHandler."""

    def __init__(self, port: int = 0, data_dir: Optional[str] = None,
                 ioloop: Optional[IoLoop] = None):
        self.handler = BrokerHandler(data_dir)
        self._server = RpcServer(port=port, ioloop=ioloop)
        self._server.add_handler(self.handler)

    def start(self) -> "BrokerServer":
        self._server.start()
        return self

    @property
    def port(self) -> int:
        return self._server.port

    def stop(self) -> None:
        self._server.stop()
        self.handler.close()


class _BrokerRpc:
    """Shared sync RPC plumbing for the network client classes."""

    def __init__(self, host: str, port: int,
                 pool: Optional[RpcClientPool] = None,
                 ioloop: Optional[IoLoop] = None):
        self._host = host
        self._port = port
        self._ioloop = ioloop or IoLoop.default()
        self._own_pool = pool is None
        self._pool = pool or RpcClientPool()

    def call(self, method: str, timeout: float = 10.0, **args):
        async def go():
            return await self._pool.call(
                self._host, self._port, method, args, timeout=timeout)

        return self._ioloop.run_sync(go(), timeout=timeout + 5)

    def close(self) -> None:
        """Closes the pool (and its sockets) if this client owns it."""
        if self._own_pool:
            try:
                self._ioloop.run_sync(self._pool.close(), timeout=5)
            except Exception:
                pass


class NetworkProducer(_BrokerRpc):
    def create_topic(self, topic: str, num_partitions: int = 1) -> None:
        self.call("broker_create_topic", topic=topic,
                  num_partitions=num_partitions)

    def produce(self, topic: str, partition: int, key: bytes, value: bytes,
                timestamp_ms: Optional[int] = None) -> int:
        return self.call(
            "broker_produce", topic=topic, partition=partition, key=key,
            value=value, timestamp_ms=timestamp_ms,
        )["offset"]


class NetworkConsumer(Consumer, _BrokerRpc):
    """Consumer over a remote BrokerServer (librdkafka-equivalent role).

    Batched long-poll fetches fill a local buffer; ``consume`` drains it
    message by message, preserving the reference Consumer semantics."""

    def __init__(self, host: str, port: int, group_id: str = "",
                 pool: Optional[RpcClientPool] = None,
                 ioloop: Optional[IoLoop] = None,
                 fetch_batch: int = 50):
        _BrokerRpc.__init__(self, host, port, pool=pool, ioloop=ioloop)
        self.group_id = group_id
        self._topic: Optional[str] = None
        self._positions: Dict[int, int] = {}
        self._buffer: List[Message] = []
        self._rr: List[int] = []
        self._fetch_batch = fetch_batch

    def assign(self, topic: str, partitions: Sequence[int]) -> None:
        self._topic = topic
        self._positions = {p: 0 for p in partitions}
        self._rr = list(partitions)
        self._buffer.clear()

    def seek(self, partition: int, offset: int) -> None:
        self._positions[partition] = offset
        self._buffer = [m for m in self._buffer
                        if m.partition != partition]

    def seek_to_timestamp(self, ts_ms: int) -> None:
        assert self._topic is not None
        for p in list(self._positions):
            self._positions[p] = self.call(
                "broker_offset_for_timestamp", topic=self._topic,
                partition=p, timestamp_ms=ts_ms,
            )["offset"]
        self._buffer.clear()

    def _fetch_into_buffer(self, partition: int, wait_ms: int) -> bool:
        assert self._topic is not None
        out = self.call(
            "broker_fetch", timeout=wait_ms / 1000.0 + 10.0,
            topic=self._topic, partition=partition,
            offset=self._positions[partition],
            max_wait_ms=wait_ms, max_messages=self._fetch_batch,
        )
        got = False
        for m in out["messages"]:
            self._buffer.append(Message(
                topic=self._topic, partition=int(m["partition"]),
                offset=int(m["offset"]),
                timestamp_ms=int(m["timestamp_ms"]),
                key=bytes(m["key"]), value=bytes(m["value"]),
            ))
            got = True
        return got

    def consume(self, timeout_sec: float) -> Optional[Message]:
        assert self._topic is not None
        if self._buffer:
            msg = self._buffer.pop(0)
            self._positions[msg.partition] = msg.offset + 1
            return msg
        deadline = time.monotonic() + timeout_sec
        while True:
            # non-blocking round-robin sweep first
            for _ in range(len(self._rr)):
                p = self._rr.pop(0)
                self._rr.append(p)
                if self._fetch_into_buffer(p, 0):
                    msg = self._buffer.pop(0)
                    self._positions[msg.partition] = msg.offset + 1
                    return msg
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            p = self._rr[0]
            if self._fetch_into_buffer(
                    p, int(min(remaining, 0.5) * 1000)):
                msg = self._buffer.pop(0)
                self._positions[msg.partition] = msg.offset + 1
                return msg

    def commit(self) -> None:
        assert self._topic is not None
        self.call(
            "broker_commit", group=self.group_id, topic=self._topic,
            offsets={str(p): o for p, o in self._positions.items()},
        )

    @property
    def committed(self) -> Dict[int, int]:
        assert self._topic is not None
        out = self.call(
            "broker_committed", group=self.group_id, topic=self._topic)
        return {int(p): int(o) for p, o in out["offsets"].items()}

    def position(self, partition: int) -> int:
        return self._positions[partition]

    def high_watermark(self, partition: int) -> int:
        assert self._topic is not None
        return self.call(
            "broker_high_watermark", topic=self._topic,
            partition=partition,
        )["offset"]

    def close(self) -> None:
        # MRO would resolve to the no-op Consumer.close(); the TCP pool
        # must actually be released on watcher teardown
        _BrokerRpc.close(self)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="standalone queue broker")
    p.add_argument("--port", type=int, default=9092)
    p.add_argument("--data_dir", default=None,
                   help="durable log directory (omit for in-memory)")
    args = p.parse_args(argv)
    srv = BrokerServer(port=args.port, data_dir=args.data_dir).start()
    print(f"broker up: port={srv.port} data_dir={args.data_dir}",
          flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
