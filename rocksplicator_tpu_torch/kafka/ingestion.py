"""start/stopMessageIngestion: queue → db wiring, exactly-once.
(The port's copy of ``rocksplicator_tpu/kafka/ingestion.py``.)

Reference: admin_handler.cpp message-ingestion paths — a consumer per db
on the topic partition matching the db's shard id; messages apply as
PUTs (empty value ⇒ DELETE); ``last_kafka_msg_timestamp_ms`` persists
into the meta_db every 1000 messages (admin_handler.cpp:2065-2075).

This implementation replaces the reference's at-least-once
timestamp-replay resume with exactly-once WAL-riding checkpoints
(kafka/checkpoint.py): every apply batch carries the partition's
watermark PUT in the same engine WriteBatch as its records, so a
crashed consumer reopens, reads the durable watermark, seeks to it, and
skips re-delivered offsets below it — zero duplicates, zero gaps, by
construction. Batches commit through the ``write_many``
grouped-commit path (one lock pass + one WAL flush per drained fetch,
not per record). The timestamp-persist path stays as the reference-
compatible fallback for dbs that never checkpointed.

Backpressure: before each fetch round the consumer reads the engine's
pressure gauges (L0 depth vs the delayed-write controller's
slowdown/stop triggers, memtable fullness, WAL backlog) and sleeps
proportionally — a hot topic slows the fetch loop instead of stacking
unflushed memtables. A typed RETRY_LATER from the write path (admission
shedding) is honored via the retry-after hint: the SAME group
retries after the hinted delay, so shedding never drops or duplicates
records.

Fault seams (registered): ``kafka.fetch`` (before each fetch round),
``kafka.apply`` (before the grouped commit), ``kafka.checkpoint`` (as
each batch's watermark is folded in). A fault at any seam kills the
consumer thread mid-batch; restart resumes from the durable watermark.

Broker addressing: ``embedded://<cluster>`` selects an in-process
MockKafkaCluster; ``broker://host:port`` the networked broker; a file
path is a broker-serverset file.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..rpc.errors import RpcApplicationError
from ..storage.records import WriteBatch
from ..testing import failpoints as fp
from ..utils.retry_policy import retry_after_hint
from ..utils.segment_utils import extract_shard_id
from ..utils.stats import Stats
from .broker import Message, MockConsumer, get_cluster
from .checkpoint import (applies_key, encode_watermark, read_applies,
                         read_watermark, watermark_key)

log = logging.getLogger(__name__)

META_PERSIST_EVERY = 1000  # messages (admin_handler.cpp:2065-2075)

# grouped-commit shape: one fetch round drains up to MAX_DRAIN messages,
# chunked into WriteBatches of BATCH_RECORDS records (each chunk carries
# its own watermark — write_many groups are not crash-atomic across
# batches, so every batch must be self-describing)
MAX_DRAIN = 512
BATCH_RECORDS = 64
POLL_SEC = 0.2  # blocking fetch when idle
PACE_MAX_SEC = 0.25  # hard cap on one backpressure sleep


def _pacing_delay(snap: Dict, opts) -> float:
    """Fetch-pacing delay derived from the delayed-write controller's
    own inputs (the engine's gauges): scale from 0 at the L0 slowdown
    trigger to PACE_MAX at the stop trigger, and from a full memtable
    pipeline upward. Zero when the engine is keeping up."""
    if not snap:
        return 0.0
    delay = 0.0
    level_files = snap.get("level_files") or [0]
    l0 = level_files[0]
    soft = opts.level0_slowdown_writes_trigger
    hard = opts.level0_stop_writes_trigger
    if hard > soft and l0 > soft:
        delay = PACE_MAX_SEC * min(1.0, (l0 - soft) / (hard - soft))
    # memtable pipeline fullness: active + immutables vs one memtable
    mem_frac = snap.get("memtable_bytes", 0) / max(1.0, opts.memtable_bytes)
    if mem_frac > 1.0:
        delay = max(delay, PACE_MAX_SEC * min(1.0, mem_frac - 1.0))
    # WAL backlog: unflushed bytes several memtables deep means flush is
    # behind — back off proportionally
    wal_frac = snap.get("wal_backlog_bytes", 0) / max(
        1.0, 8.0 * opts.memtable_bytes)
    if wal_frac > 1.0:
        delay = max(delay, PACE_MAX_SEC * min(1.0, wal_frac - 1.0))
    return delay


class IngestionWatcher:
    """The exactly-once batched applier: one consumer thread per db."""

    def __init__(self, handler, db_name: str, app_db, consumer, topic: str,
                 partitions: Sequence[int], start_ts: int):
        self._handler = handler
        self._db_name = db_name
        self._app_db = app_db
        self._consumer = consumer
        self._topic = topic
        self._partitions = list(partitions)
        self._start_ts = start_ts
        self._stats = Stats.get()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # durable positions, mirrored in memory: next offset to apply and
        # records-applied-total per partition
        self._watermarks: Dict[int, int] = {}
        self._applied: Dict[int, int] = {}
        self._since_persist = 0
        self.replay_done = threading.Event()
        self.last_timestamp_ms = 0
        self.error: Optional[BaseException] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"cdc-{self._db_name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        if self.last_timestamp_ms:
            self._persist_timestamp(self.last_timestamp_ms)
        try:
            self._consumer.commit()
        except Exception:
            pass  # broker-side offsets are advisory; the WAL is truth
        try:
            self._consumer.close()
        except Exception:
            pass

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def watermark(self, partition: int) -> int:
        """Next offset the consumer will apply (in-memory mirror)."""
        return self._watermarks.get(partition, 0)

    # -- engine access ----------------------------------------------------

    def _engine_db(self):
        return getattr(self._app_db, "db", self._app_db)

    # -- the consume/apply loop -------------------------------------------

    def _run(self) -> None:
        try:
            self._resume()
            highs = {p: self._consumer.high_watermark(p)
                     for p in self._partitions}
            if all(self._position(p) >= highs[p]
                   for p in self._partitions):
                self.replay_done.set()
            while not self._stop_evt.is_set():
                self._pace()
                if self._stop_evt.is_set():
                    break
                fp.hit("kafka.fetch")
                msgs = self._drain()
                if not self.replay_done.is_set() and all(
                        self._position(p) >= highs[p]
                        for p in self._partitions):
                    self.replay_done.set()
                if not msgs:
                    continue
                groups = self._build_batches(msgs)
                if not groups:
                    continue
                fp.hit("kafka.apply")
                self._apply_group([g[4] for g in groups])
                self._commit_positions(groups)
        except BaseException as e:  # noqa: BLE001 — seam kills land here
            if not self._stop_evt.is_set():
                self.error = e
                self._stats.incr("kafka.cdc.consumer_errors")
                log.exception("%s: CDC consumer died (restart resumes "
                              "from the durable watermark)", self._db_name)

    def _position(self, partition: int) -> int:
        try:
            return self._consumer.position(partition)
        except Exception:
            return 0

    def _resume(self) -> None:
        """Durable watermark wins; timestamp seek is the never-
        checkpointed fallback (reference replay semantics)."""
        self._consumer.assign(self._topic, self._partitions)
        engine = self._engine_db()
        unseen: List[int] = []
        for p in self._partitions:
            wm = read_watermark(engine, self._topic, p)
            if wm is None:
                unseen.append(p)
                self._watermarks[p] = 0
                self._applied[p] = read_applies(engine, self._topic, p)
            else:
                self._watermarks[p] = wm["offset"]
                # the durable counter (riding the records batches) is the
                # authority, NOT the watermark's copy: with a checkpoint
                # decoupled from its batch (the cdc_dedup bug class) the
                # watermark's count is stale-consistent and would let
                # re-applied records self-heal the witness
                self._applied[p] = max(
                    wm["applied"], read_applies(engine, self._topic, p))
                self.last_timestamp_ms = max(
                    self.last_timestamp_ms, wm["ts_ms"])
        if unseen and len(unseen) == len(self._partitions) \
                and self._start_ts:
            self._consumer.seek_to_timestamp(self._start_ts)
        for p in self._partitions:
            if p not in unseen:
                self._consumer.seek(p, self._watermarks[p])
        self._stats.incr("kafka.cdc.resumes")

    def _pace(self) -> None:
        engine = self._engine_db()
        snap_fn = getattr(engine, "metrics_snapshot", None)
        if snap_fn is None:
            return
        try:
            delay = _pacing_delay(snap_fn(max_age=0.1), engine.options)
        except Exception:
            return
        if delay > 0:
            self._stats.incr("kafka.cdc.paced_sleeps")
            self._stats.incr("kafka.cdc.paced_ms", delay * 1000.0)
            self._stop_evt.wait(delay)

    def _drain(self) -> List[Message]:
        msgs: List[Message] = []
        msg = self._consumer.consume(POLL_SEC)
        while msg is not None:
            msgs.append(msg)
            if len(msgs) >= MAX_DRAIN:
                break
            msg = self._consumer.consume(0.0)
        return msgs

    def _build_batches(
        self, msgs: List[Message],
    ) -> List[Tuple[int, int, int, int, WriteBatch, int]]:
        """(partition, next_offset, applied_total, last_ts_ms, batch,
        n_records) per chunk — records + applies counter + watermark,
        one atomic WriteBatch each. Re-delivered offsets below the
        watermark are skipped (the dedup-by-construction window)."""
        per_part: Dict[int, List[Message]] = {}
        for m in msgs:
            if m.offset < self._watermarks.get(m.partition, 0):
                self._stats.incr("kafka.cdc.dup_skipped")
                continue
            per_part.setdefault(m.partition, []).append(m)
        groups: List[Tuple[int, int, int, int, WriteBatch, int]] = []
        for p, ms in per_part.items():
            applied = self._applied.get(p, 0)
            for i in range(0, len(ms), BATCH_RECORDS):
                chunk = ms[i:i + BATCH_RECORDS]
                batch = WriteBatch()
                for m in chunk:
                    if m.value:
                        batch.put(m.key, m.value)
                    else:
                        batch.delete(m.key)
                applied += len(chunk)
                next_off = chunk[-1].offset + 1
                ts = chunk[-1].timestamp_ms
                batch.put(applies_key(self._topic, p),
                          b"%d" % applied)
                self._fold_checkpoint(batch, p, next_off, applied, ts)
                groups.append((p, next_off, applied, ts, batch,
                               len(chunk)))
        return groups

    def _fold_checkpoint(self, batch: WriteBatch, partition: int,
                         next_offset: int, applied: int,
                         ts_ms: int) -> None:
        """THE exactly-once seam: the watermark PUT joins the records'
        own WriteBatch (one WAL record, crash-atomic). The chaos
        harness's ``cdc_dedup`` tooth patches this to a decoupled
        second write — which the applies-counter invariant catches."""
        fp.hit("kafka.checkpoint")
        batch.put(watermark_key(self._topic, partition),
                  encode_watermark(next_offset, applied, ts_ms))

    def _apply_group(self, batches: List[WriteBatch]) -> None:
        """One grouped commit; RETRY_LATER (admission shed) retries the
        SAME group after the server's hinted delay — shedding must
        never drop or duplicate records."""
        while True:
            try:
                self._write_many(batches)
                return
            except RpcApplicationError as e:
                hint = retry_after_hint(e)
                if hint is None:
                    raise
                self._stats.incr("kafka.cdc.retry_later")
                if self._stop_evt.wait(min(hint, 5.0)):
                    raise

    def _write_many(self, batches: List[WriteBatch]) -> None:
        target = self._app_db
        if hasattr(target, "db"):  # ApplicationDB: replication-aware
            target.write_many(batches)
        elif hasattr(target, "write_many"):  # raw engine DB
            target.write_many([(b, None) for b in batches])
        else:
            for b in batches:
                target.write(b)

    def _commit_positions(self, groups) -> None:
        n = 0
        for p, next_off, applied, ts, _batch, nrec in groups:
            n += nrec
            self._watermarks[p] = next_off
            self._applied[p] = applied
            if ts > self.last_timestamp_ms:
                self.last_timestamp_ms = ts
        self._stats.incr("kafka.cdc.batches", len(groups))
        self._stats.incr("kafka.cdc.records_applied", n)
        self._stats.incr("kafka.cdc.bytes_applied",
                         sum(g[4].byte_size() for g in groups))
        self._since_persist += n
        if self._since_persist >= META_PERSIST_EVERY:
            self._since_persist = 0
            self._persist_timestamp(self.last_timestamp_ms)

    def _persist_timestamp(self, ts_ms: int) -> None:
        if self._handler is None:
            return
        try:
            self._handler.write_meta_data(
                self._db_name, last_kafka_msg_timestamp_ms=ts_ms
            )
        except Exception:
            log.exception("%s: persisting kafka timestamp failed",
                          self._db_name)


def _resolve_consumer(broker_path: str, topic_name: str, group_id: str):
    """(consumer, num_partitions) for a broker address.

    ``embedded://<name>`` (or empty) → in-process MockKafkaCluster;
    ``broker://host:port`` / ``host:port`` → networked BrokerServer
    (kafka/network.py, the librdkafka analog); an existing file path →
    broker-serverset file whose first line is ``host:port`` (reference
    KafkaBrokerFileWatcher reads the broker list from such files)."""
    import os

    if broker_path.startswith("embedded://") or not broker_path:
        cluster_name = broker_path[len("embedded://"):] or "default"
        cluster = get_cluster(cluster_name)
        return (
            MockConsumer(cluster, group_id=group_id),
            cluster.num_partitions(topic_name),
        )
    addr = broker_path
    if addr.startswith("broker://"):
        addr = addr[len("broker://"):]
    elif os.path.isfile(addr):
        # serverset format (KafkaBrokerFileWatcher): one host:port per
        # line, comments/blanks skipped; use the first broker listed
        with open(addr) as f:
            lines = [ln.strip() for ln in f
                     if ln.strip() and not ln.lstrip().startswith("#")]
        if not lines:
            raise RpcApplicationError(
                "DB_ADMIN_ERROR", f"empty broker serverset: {broker_path}")
        addr = lines[0]
    host, _, port_s = addr.rpartition(":")
    if not host or not port_s.isdigit():
        raise RpcApplicationError(
            "DB_ADMIN_ERROR", f"bad broker address: {broker_path!r}")
    from .network import NetworkConsumer

    consumer = NetworkConsumer(host, int(port_s), group_id=group_id)
    try:
        n = consumer.call("broker_num_partitions",
                          topic=topic_name)["num_partitions"]
    except BaseException:
        consumer.close()
        raise
    return consumer, n


def start_ingestion(handler, db_name: str, app_db, topic_name: str,
                    broker_path: str, start_ts: int) -> IngestionWatcher:
    """The admin RPC seam (handler.py start/stopMessageIngestion)."""
    if not topic_name:
        raise RpcApplicationError("DB_ADMIN_ERROR", "topic_name required")
    consumer, num_partitions = _resolve_consumer(
        broker_path, topic_name, group_id=f"ingest-{db_name}")
    if num_partitions == 0:
        consumer.close()
        raise RpcApplicationError(
            "DB_ADMIN_ERROR", f"no such topic: {topic_name}"
        )
    # The partition IS the shard id (reference rejects any mismatch rather
    # than silently ingesting another shard's data).
    shard = extract_shard_id(db_name)
    if not (0 <= shard < num_partitions):
        consumer.close()
        raise RpcApplicationError(
            "DB_ADMIN_ERROR",
            f"shard {shard} of {db_name} has no partition in topic "
            f"{topic_name} ({num_partitions} partitions)",
        )
    partition = shard
    watcher = IngestionWatcher(
        handler, db_name, app_db, consumer, topic_name, [partition], start_ts
    )
    watcher.start()
    return watcher
