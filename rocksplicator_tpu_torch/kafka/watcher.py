"""KafkaWatcher: replay-then-tail consumption with hooks.
(The port's copy of ``rocksplicator_tpu/kafka/watcher.py``.)

Reference: common/kafka/kafka_watcher.{h,cpp}:42-168,141-350 — owns the
consume thread; first a blocking replay from the configured start
timestamp up to "now" (``ConsumeUpToNow``), then the live tail loop;
virtual hooks let subclasses process messages and observe replay
completion. Also KafkaConsumerPool (bounded consumer reuse) and the
broker-serverset file watcher.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

from ..utils.file_watcher import FileWatcher
from ..utils.stats import Stats
from .broker import Consumer, Message

log = logging.getLogger(__name__)


class KafkaWatcher:
    """Consume thread with replay + live phases.

    Subclass (or pass callbacks) to handle messages:
    - ``on_message(msg, is_replay)`` per message;
    - ``on_replay_done()`` once caught up to the start-time watermark.
    """

    def __init__(
        self,
        name: str,
        consumer: Consumer,
        topic: str,
        partitions: Sequence[int],
        start_timestamp_ms: int = 0,
        on_message: Optional[Callable[[Message, bool], None]] = None,
        on_replay_done: Optional[Callable[[], None]] = None,
        poll_timeout_sec: float = 0.2,
    ):
        self.name = name
        self._consumer = consumer
        self._topic = topic
        self._partitions = list(partitions)
        self._start_ts = start_timestamp_ms
        self._on_message = on_message
        self._on_replay_done = on_replay_done
        self._poll_timeout = poll_timeout_sec
        self._stop = threading.Event()
        self.replay_done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.messages_processed = 0
        self.last_timestamp_ms = 0

    # -- hooks (overridable) ----------------------------------------------

    def handle_message(self, msg: Message, is_replay: bool) -> None:
        if self._on_message:
            self._on_message(msg, is_replay)

    def handle_replay_done(self) -> None:
        if self._on_replay_done:
            self._on_replay_done()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "KafkaWatcher":
        self._consumer.assign(self._topic, self._partitions)
        if self._start_ts > 0:
            self._consumer.seek_to_timestamp(self._start_ts)
        self._thread = threading.Thread(
            target=self._run, name=f"kafka-watcher-{self.name}", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        stats = Stats.get()
        # replay phase: consume up to the high watermarks captured now
        # (ConsumeUpToNow, kafka_watcher.cpp:141-233)
        watermarks = {
            p: self._consumer.high_watermark(p) for p in self._partitions
        }

        def caught_up() -> bool:
            return all(
                self._consumer.position(p) >= watermarks[p]
                for p in self._partitions
            )

        while not self._stop.is_set() and not caught_up():
            msg = self._consumer.consume(self._poll_timeout)
            if msg is None:
                continue
            self._dispatch(msg, is_replay=True, stats=stats)
        if not self._stop.is_set():
            self.replay_done.set()
            try:
                self.handle_replay_done()
            except Exception:
                log.exception("%s: replay-done hook failed", self.name)
        # live tail loop (kafka_watcher.cpp:235-350)
        while not self._stop.is_set():
            msg = self._consumer.consume(self._poll_timeout)
            if msg is None:
                continue
            self._dispatch(msg, is_replay=False, stats=stats)

    def _dispatch(self, msg: Message, is_replay: bool, stats) -> None:
        try:
            self.handle_message(msg, is_replay)
            self.messages_processed += 1
            self.last_timestamp_ms = max(self.last_timestamp_ms, msg.timestamp_ms)
            stats.incr("kafka.messages_consumed")
            if is_replay:
                stats.incr("kafka.messages_replayed")
        except Exception:
            stats.incr("kafka.message_errors")
            log.exception("%s: message handler failed @%s/%d:%d",
                          self.name, msg.topic, msg.partition, msg.offset)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # Best-effort: a networked consumer's commit RPC can fail when the
        # broker is down — the watcher must still stop cleanly and close
        # its consumer (the reference ignores commit errors on teardown).
        try:
            self._consumer.commit()
        except Exception:
            log.warning("%s: final commit failed (broker down?)", self.name,
                        exc_info=True)
        finally:
            self._consumer.close()


class KafkaConsumerPool:
    """Bounded reusable consumer pool (common/kafka/kafka_consumer_pool)."""

    def __init__(self, size: int, factory: Callable[[], Consumer]):
        self._queue: "queue.Queue[Consumer]" = queue.Queue()
        for _ in range(size):
            self._queue.put(factory())

    def acquire(self, timeout: float = 10.0) -> Consumer:
        return self._queue.get(timeout=timeout)

    def release(self, consumer: Consumer) -> None:
        self._queue.put(consumer)


class KafkaBrokerFileWatcher:
    """Broker serverset file → live broker list
    (common/kafka/kafka_broker_file_watcher): one 'host:port' per line,
    hot-reloaded."""

    def __init__(self, serverset_path: str):
        self._path = serverset_path
        self._lock = threading.Lock()
        self._brokers: List[str] = []
        FileWatcher.instance().add_file(serverset_path, self._on_content)

    def _on_content(self, content: bytes) -> None:
        brokers = [
            line.strip() for line in content.decode("utf-8").splitlines()
            if line.strip() and not line.startswith("#")
        ]
        with self._lock:
            self._brokers = brokers

    @property
    def broker_list(self) -> List[str]:
        with self._lock:
            return list(self._brokers)

    def close(self) -> None:
        FileWatcher.instance().remove_file(self._path, self._on_content)


class KafkaBrokerFileWatcherManager:
    """Singleton dedup of broker-list watchers keyed by serverset path
    (rocksdb_admin/detail/kafka_broker_file_watcher_manager)."""

    _instance: Optional["KafkaBrokerFileWatcherManager"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._watchers: dict = {}

    @classmethod
    def instance(cls) -> "KafkaBrokerFileWatcherManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def get_file_watcher(self, serverset_path: str) -> KafkaBrokerFileWatcher:
        with self._lock:
            w = self._watchers.get(serverset_path)
            if w is None:
                w = KafkaBrokerFileWatcher(serverset_path)
                self._watchers[serverset_path] = w
            return w
