"""Admin plane of the port — counterpart of ``rocksplicator_tpu/admin``:
``ApplicationDB`` and its manager, the ``AdminHandler`` (every RPC but
message ingestion, which waits for the kafka stack), the backup manager,
the post-ingest batch compactor and the ingest admission gate
(``ingest_pipeline.py``). ``cdc.py`` is not ported yet."""

from .application_db import ApplicationDB
from .db_manager import ApplicationDBManager
from .handler import AdminHandler, DBMetaData
from .ingest_pipeline import BatchCompactor, IngestGate

__all__ = [
    "ApplicationDB", "ApplicationDBManager", "AdminHandler", "DBMetaData",
    "BatchCompactor", "IngestGate",
]
