"""Message-queue ingestion stack (reference: common/kafka/ — SURVEY §2.3).
(The port's copy of ``rocksplicator_tpu/kafka/__init__.py``.)

``ingestion.start_ingestion`` is the
seam the admin plane's start/stopMessageIngestion RPCs call.
"""
