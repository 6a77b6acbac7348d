"""Message broker abstraction + the in-process mock cluster.
(The port's copy of ``rocksplicator_tpu/kafka/broker.py``.)

Reference: common/kafka/ wraps librdkafka against real brokers and tests
against ``MockKafkaCluster`` (an in-memory topic/partition log with
timestamp seek, common/kafka/tests/mock_kafka_cluster.h) +
``MockKafkaConsumer``. Here the mock IS the first-class embedded backend
(no broker binary in the image); a librdkafka-style networked backend
slots in behind the same ``Consumer`` interface.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Message:
    topic: str
    partition: int
    offset: int
    timestamp_ms: int
    key: bytes
    value: bytes


class _PartitionLog:
    def __init__(self) -> None:
        self.messages: List[Message] = []
        self.timestamps: List[int] = []  # parallel, for timestamp seek

    def append(self, msg: Message) -> None:
        self.messages.append(msg)
        self.timestamps.append(msg.timestamp_ms)

    def offset_for_timestamp(self, ts_ms: int) -> int:
        """First offset with timestamp >= ts_ms (reference Seek-by-time)."""
        return bisect.bisect_left(self.timestamps, ts_ms)


class MockKafkaCluster:
    """In-memory topic/partition logs with condition-variable tailing."""

    def __init__(self) -> None:
        self._topics: Dict[str, List[_PartitionLog]] = {}
        self._cond = threading.Condition()

    def create_topic(self, topic: str, num_partitions: int = 1) -> None:
        with self._cond:
            if topic not in self._topics:
                self._topics[topic] = [
                    _PartitionLog() for _ in range(num_partitions)
                ]

    def num_partitions(self, topic: str) -> int:
        with self._cond:
            return len(self._topics.get(topic, []))

    def topics(self) -> List[str]:
        with self._cond:
            return sorted(self._topics)

    def produce(self, topic: str, partition: int, key: bytes, value: bytes,
                timestamp_ms: Optional[int] = None) -> int:
        with self._cond:
            if topic not in self._topics:
                raise KeyError(f"no such topic: {topic}")
            log = self._topics[topic][partition]
            msg = Message(
                topic=topic, partition=partition, offset=len(log.messages),
                timestamp_ms=(
                    timestamp_ms if timestamp_ms is not None
                    else int(time.time() * 1000)
                ),
                key=bytes(key), value=bytes(value),
            )
            log.append(msg)
            self._cond.notify_all()
            return msg.offset

    def high_watermark(self, topic: str, partition: int) -> int:
        with self._cond:
            return len(self._topics[topic][partition].messages)

    def fetch(self, topic: str, partition: int, offset: int,
              timeout_sec: float) -> Optional[Message]:
        deadline = time.monotonic() + timeout_sec
        with self._cond:
            while True:
                log = self._topics.get(topic, [None])[partition]
                if log is not None and offset < len(log.messages):
                    return log.messages[offset]
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)

    def offset_for_timestamp(self, topic: str, partition: int,
                             ts_ms: int) -> int:
        with self._cond:
            return self._topics[topic][partition].offset_for_timestamp(ts_ms)


class Consumer:
    """The consumer interface (reference kafka_consumer.h:27-118)."""

    def assign(self, topic: str, partitions: Sequence[int]) -> None:
        raise NotImplementedError

    def seek(self, partition: int, offset: int) -> None:
        raise NotImplementedError

    def seek_to_timestamp(self, ts_ms: int) -> None:
        raise NotImplementedError

    def consume(self, timeout_sec: float) -> Optional[Message]:
        raise NotImplementedError

    def commit(self) -> None:
        raise NotImplementedError

    def position(self, partition: int) -> int:
        raise NotImplementedError

    def high_watermark(self, partition: int) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MockConsumer(Consumer):
    """Consumer over MockKafkaCluster (reference MockKafkaConsumer)."""

    def __init__(self, cluster: MockKafkaCluster, group_id: str = ""):
        self._cluster = cluster
        self.group_id = group_id
        self._topic: Optional[str] = None
        self._positions: Dict[int, int] = {}
        self._committed: Dict[int, int] = {}
        self._rr: List[int] = []

    def assign(self, topic: str, partitions: Sequence[int]) -> None:
        self._topic = topic
        self._positions = {p: 0 for p in partitions}
        self._rr = list(partitions)

    def seek(self, partition: int, offset: int) -> None:
        self._positions[partition] = offset

    def seek_to_timestamp(self, ts_ms: int) -> None:
        assert self._topic is not None
        for p in self._positions:
            self._positions[p] = self._cluster.offset_for_timestamp(
                self._topic, p, ts_ms
            )

    def consume(self, timeout_sec: float) -> Optional[Message]:
        assert self._topic is not None
        deadline = time.monotonic() + timeout_sec
        while True:
            # round-robin over assigned partitions, non-blocking first
            for _ in range(len(self._rr)):
                p = self._rr.pop(0)
                self._rr.append(p)
                msg = self._cluster.fetch(self._topic, p,
                                          self._positions[p], 0.0)
                if msg is not None:
                    self._positions[p] = msg.offset + 1
                    return msg
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            # block on the first partition for the remainder
            p = self._rr[0]
            msg = self._cluster.fetch(
                self._topic, p, self._positions[p], min(remaining, 0.1)
            )
            if msg is not None:
                self._positions[p] = msg.offset + 1
                return msg

    def commit(self) -> None:
        self._committed = dict(self._positions)

    @property
    def committed(self) -> Dict[int, int]:
        return dict(self._committed)

    def position(self, partition: int) -> int:
        return self._positions[partition]

    def high_watermark(self, partition: int) -> int:
        assert self._topic is not None
        return self._cluster.high_watermark(self._topic, partition)


# process-wide registry so admin RPC handlers can reach embedded clusters
# by name (stands in for broker addresses in the serverset file)
_clusters: Dict[str, MockKafkaCluster] = {}
_clusters_lock = threading.Lock()


def get_cluster(name: str = "default") -> MockKafkaCluster:
    with _clusters_lock:
        cluster = _clusters.get(name)
        if cluster is None:
            cluster = _clusters[name] = MockKafkaCluster()
        return cluster


def reset_clusters_for_test() -> None:
    with _clusters_lock:
        _clusters.clear()
