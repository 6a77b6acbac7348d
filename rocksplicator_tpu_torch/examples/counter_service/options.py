"""Per-segment storage options.
(The port's copy of ``examples/counter_service/options.py``.)

Reference: examples/counter_service/rocksdb_options.cpp — per-segment
rocksdb options including the counter merge operator and WAL TTL (1h in
performance.cpp configs).
"""

from rocksplicator_tpu_torch.storage import DBOptions, UInt64AddOperator


def counter_options_generator(segment: str) -> DBOptions:
    return DBOptions(
        merge_operator=UInt64AddOperator(),
        wal_ttl_seconds=3600.0,
        bits_per_key=10,
        # production posture: flush/compaction off the write path
        background_compaction=True,
    )
