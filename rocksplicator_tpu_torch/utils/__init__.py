"""Host helpers (copies of ``rocksplicator_tpu/utils``)."""
