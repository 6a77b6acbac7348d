"""Storage-layer constants the compaction pipeline needs (copies of
``rocksplicator_tpu/storage``)."""
