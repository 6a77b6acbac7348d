"""QueuePublisher: CDC observer updates → message queue.
(The port's copy of ``rocksplicator_tpu/kafka/publisher.py``.)

Reference: the CDC observer's custom DbWrapper "publishes updates (e.g. to
Kafka) instead of persisting" (cdc_admin, SURVEY §2.2). This is the queue
-producer implementation of the CdcAdminHandler ``Publisher`` callable.
"""

from __future__ import annotations

from ..utils.segment_utils import extract_shard_id
from .broker import MockKafkaCluster, get_cluster


class QueuePublisher:
    def __init__(self, topic: str, cluster: MockKafkaCluster | None = None,
                 num_partitions: int = 16):
        self._cluster = cluster or get_cluster()
        self._topic = topic
        self._num_partitions = num_partitions
        self._cluster.create_topic(topic, num_partitions)

    def __call__(self, db_name: str, start_seq: int, raw: bytes,
                 timestamp_ms) -> None:
        shard = extract_shard_id(db_name)
        partition = shard % self._num_partitions if shard >= 0 else 0
        self._cluster.produce(
            self._topic, partition,
            key=f"{db_name}:{start_seq}".encode(),
            value=raw,
            timestamp_ms=timestamp_ms,
        )
