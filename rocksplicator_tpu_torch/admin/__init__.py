"""Admin plane of the port — counterpart of ``rocksplicator_tpu/admin``.
So far the post-ingest batch compactor and the ingest admission gate
(``ingest_pipeline.py``)."""

from .ingest_pipeline import BatchCompactor, IngestGate

__all__ = ["BatchCompactor", "IngestGate"]
