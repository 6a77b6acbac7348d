"""Canonical lock-acquisition order — GENERATED, do not edit.

The port's table, keyed by the port's own lock sites. Regenerate with:
  python -m tools.rstpu_check --package rocksplicator_tpu_torch \
      --emit-lock-order > rocksplicator_tpu_torch/testing/lock_order.py
and put this docstring back (the emitted one names the JAX package's
path). Verified fresh by tests/test_torch_lockwatch.py, which compares
RANKS and ORDER with the emitted ones.

ORDER is the transitive closure of the static
acquired-while-holding graph (tools/rstpu_check.py pass 1),
keyed by lock construction site: (A, B) present means A is
canonically acquired before B, so a live acquisition of A while
holding B is a violation. RANKS names each known lock and gives
a topological rank for humans reading reports; pairs the static
graph never relates are constrained only by the lockwatch
runtime's dynamic cycle detection.
"""

# construction site (repo-relative file:line) -> (name, rank)
RANKS = {
    "rocksplicator_tpu_torch/replication/ack_window.py:128": ('AckWindow._cond', 0),
    "rocksplicator_tpu_torch/admin/handler.py:176": ('AdminHandler._db_admin_lock', 1),
    "rocksplicator_tpu_torch/admin/ingest_pipeline.py:139": ('BatchCompactor._lock', 2),
    "rocksplicator_tpu_torch/storage/sst.py:101": ('BlockCache._instance_lock', 3),
    "rocksplicator_tpu_torch/storage/sst.py:105": ('BlockCache._lock', 4),
    "rocksplicator_tpu_torch/kafka/network.py:92": ('BrokerHandler._log_lock', 5),
    "rocksplicator_tpu_torch/admin/cdc.py:104": ('CdcAdminHandler._lock', 6),
    "rocksplicator_tpu_torch/admin/cdc.py:43": ('CdcDbWrapper._lock', 7),
    "rocksplicator_tpu_torch/storage/stream_merge.py:115": ('CompactionMemoryBudget._instance_lock', 8),
    "rocksplicator_tpu_torch/storage/stream_merge.py:119": ('CompactionMemoryBudget._lock', 9),
    "rocksplicator_tpu_torch/utils/rate_limiter.py:26": ('ConcurrentRateLimiter._lock', 10),
    "rocksplicator_tpu_torch/cluster/coordinator.py:304": ('CoordinatorServer._snapshot_mutex', 11),
    "rocksplicator_tpu_torch/storage/engine.py:293": ('DB._compaction_mutex', 12),
    "rocksplicator_tpu_torch/utils/dbconfig.py:49": ('DBConfigManager._instance_lock', 13),
    "rocksplicator_tpu_torch/cluster/publishers.py:70": ('DedupPublisher._lock', 14),
    "rocksplicator_tpu_torch/utils/concurrent_map.py:23": ('FastReadMap._write_lock', 15),
    "rocksplicator_tpu_torch/utils/file_watcher.py:45": ('FileWatcher._lock', 16),
    "rocksplicator_tpu_torch/gpu/compaction_service.py:77": ('GpuCompactionService._instance_lock', 17),
    "rocksplicator_tpu_torch/utils/graceful_shutdown.py:31": ('GracefulShutdownHandler._lock', 18),
    "rocksplicator_tpu_torch/utils/hot_key_detector.py:28": ('HotKeyDetector._lock', 19),
    "rocksplicator_tpu_torch/admin/ingest_pipeline.py:61": ('IngestGate._lock', 20),
    "rocksplicator_tpu_torch/storage/compaction_scheduler.py:120": ('IoBudget._fg_cv', 21),
    "rocksplicator_tpu_torch/storage/compaction_scheduler.py:119": ('IoBudget._fg_lock', 22),
    "rocksplicator_tpu_torch/rpc/ioloop.py:38": ('IoLoop._default_lock', 23),
    "rocksplicator_tpu_torch/replication/iter_cache.py:42": ('IterCache._lock', 24),
    "rocksplicator_tpu_torch/kafka/watcher.py:166": ('KafkaBrokerFileWatcher._lock', 25),
    "rocksplicator_tpu_torch/kafka/watcher.py:192": ('KafkaBrokerFileWatcherManager._lock', 26),
    "rocksplicator_tpu_torch/kafka/wire.py:574": ('KafkaWireBroker._lock', 27),
    "rocksplicator_tpu_torch/kafka/wire.py:862": ('KafkaWireConsumer._lock', 28),
    "rocksplicator_tpu_torch/kafka/wire.py:1091": ('KafkaWireProducer._lock', 29),
    "rocksplicator_tpu_torch/replication/ack_window.py:58": ('MaxNumberBox._cond', 30),
    "rocksplicator_tpu_torch/storage/stream_merge.py:165": ('MemTracker._lock', 31),
    "rocksplicator_tpu_torch/admin/cdc.py:80": ('MemoryPublisher._lock', 32),
    "rocksplicator_tpu_torch/kafka/broker.py:50": ('MockKafkaCluster._cond', 33),
    "rocksplicator_tpu_torch/utils/file_watcher.py:174": ('MultiFilePoller._lock', 34),
    "rocksplicator_tpu_torch/utils/object_lock.py:19": ('ObjectLock._guard', 35),
    "rocksplicator_tpu_torch/cluster/participant.py:77": ('Participant._publish_lock', 36),
    "rocksplicator_tpu_torch/replication/replicated_db.py:176": ('ReplicatedDB._ack_state_lock', 37),
    "rocksplicator_tpu_torch/replication/replicated_db.py:153": ('ReplicatedDB._epoch_lock', 38),
    "rocksplicator_tpu_torch/replication/replicated_db.py:182": ('ReplicatedDB._expiry_lock', 39),
    "rocksplicator_tpu_torch/replication/replicated_db.py:273": ('ReplicatedDB._write_traces_lock', 40),
    "rocksplicator_tpu_torch/replication/replicator.py:47": ('Replicator._instance_lock', 41),
    "rocksplicator_tpu_torch/utils/retry_policy.py:78": ('RetryBudget._lock', 42),
    "rocksplicator_tpu_torch/utils/s3_stub.py:49": ('S3StubServer.lock', 43),
    "rocksplicator_tpu_torch/observability/collector.py:48": ('SpanCollector._instance_lock', 44),
    "rocksplicator_tpu_torch/utils/ssl_context_manager.py:58": ('SslContextManager._lock', 45),
    "rocksplicator_tpu_torch/utils/stats.py:233": ('Stats._buffers_lock', 46),
    "rocksplicator_tpu_torch/utils/stats.py:242": ('Stats._dump_lock', 47),
    "rocksplicator_tpu_torch/utils/stats.py:214": ('Stats._instance_lock', 48),
    "rocksplicator_tpu_torch/utils/status_server.py:32": ('StatusServer._instance_lock', 49),
    "rocksplicator_tpu_torch/rpc/admission.py:116": ('TenantAdmission._instance_lock', 50),
    "rocksplicator_tpu_torch/rpc/admission.py:126": ('TenantAdmission._lock', 51),
    "rocksplicator_tpu_torch/rpc/admission.py:68": ('TokenBucket._lock', 52),
    "rocksplicator_tpu_torch/storage/archive.py:64": ('WalArchiver._mutex', 53),
    "rocksplicator_tpu_torch/tools/chaos_soak.py:2195": ('_BgWriter._lock', 54),
    "rocksplicator_tpu_torch/tools/chaos_soak.py:2917": ('_ShardWriter._lock', 55),
    "rocksplicator_tpu_torch/testing/failpoints.py:130": ('_Site.lock', 56),
    "rocksplicator_tpu_torch/utils/stats.py:202": ('_ThreadBuffer.lock', 57),
    "rocksplicator_tpu_torch/kafka/broker.py:205": ('kafka.broker:_clusters_lock', 58),
    "rocksplicator_tpu_torch/ops/_build.py:53": ('ops._build:_COUNT_LOCK', 59),
    "rocksplicator_tpu_torch/ops/_build.py:52": ('ops._build:_LOAD_LOCK', 60),
    "rocksplicator_tpu_torch/storage/native/binding.py:485": ('storage.native.binding:_native_lock', 61),
    "rocksplicator_tpu_torch/testing/failpoints.py:162": ('testing.failpoints:_lock', 62),
    "rocksplicator_tpu_torch/utils/objectstore.py:380": ('utils.objectstore:_store_cache_lock', 63),
    "rocksplicator_tpu_torch/admin/db_manager.py:21": ('ApplicationDBManager._lock', 64),
    "rocksplicator_tpu_torch/cluster/coordinator.py:297": ('CoordinatorServer._lock', 65),
    "rocksplicator_tpu_torch/storage/engine.py:265": ('DB._lock', 66),
    "rocksplicator_tpu_torch/storage/engine.py:300": ('DB._manifest_mutex', 67),
    "rocksplicator_tpu_torch/utils/file_watcher.py:41": ('FileWatcher._instance_lock', 68),
    "rocksplicator_tpu_torch/cluster/participant.py:76": ('Participant._state_lock', 69),
    "rocksplicator_tpu_torch/utils/stats.py:220": ('Stats._lock', 70),
    "rocksplicator_tpu_torch/storage/compaction_scheduler.py:125": ('IoBudget._lock', 71),
    "rocksplicator_tpu_torch/storage/wal.py:70": ('WalWriter._sync_lock', 72),
}

# static partial order: (acquired-first, acquired-second)
ORDER = {
    ("rocksplicator_tpu_torch/admin/handler.py:176", "rocksplicator_tpu_torch/admin/db_manager.py:21"),
    ("rocksplicator_tpu_torch/cluster/coordinator.py:304", "rocksplicator_tpu_torch/cluster/coordinator.py:297"),
    ("rocksplicator_tpu_torch/cluster/participant.py:77", "rocksplicator_tpu_torch/cluster/participant.py:76"),
    ("rocksplicator_tpu_torch/storage/engine.py:265", "rocksplicator_tpu_torch/storage/compaction_scheduler.py:125"),
    ("rocksplicator_tpu_torch/storage/engine.py:265", "rocksplicator_tpu_torch/storage/wal.py:70"),
    ("rocksplicator_tpu_torch/storage/engine.py:293", "rocksplicator_tpu_torch/storage/compaction_scheduler.py:125"),
    ("rocksplicator_tpu_torch/storage/engine.py:293", "rocksplicator_tpu_torch/storage/engine.py:265"),
    ("rocksplicator_tpu_torch/storage/engine.py:293", "rocksplicator_tpu_torch/storage/engine.py:300"),
    ("rocksplicator_tpu_torch/storage/engine.py:293", "rocksplicator_tpu_torch/storage/wal.py:70"),
    ("rocksplicator_tpu_torch/utils/dbconfig.py:49", "rocksplicator_tpu_torch/utils/file_watcher.py:41"),
    ("rocksplicator_tpu_torch/utils/stats.py:242", "rocksplicator_tpu_torch/utils/stats.py:220"),
}
