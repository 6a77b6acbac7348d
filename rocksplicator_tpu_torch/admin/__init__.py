"""Admin plane of the port — counterpart of ``rocksplicator_tpu/admin``:
``ApplicationDB`` and its manager, the ``AdminHandler`` (its message
ingestion RPCs start the ``kafka`` stack's watchers), the CDC observer
service ``CdcAdminHandler`` (``cdc.py``), the backup manager, the
post-ingest batch compactor and the ingest admission gate
(``ingest_pipeline.py``)."""

from .application_db import ApplicationDB
from .db_manager import ApplicationDBManager
from .handler import AdminHandler, DBMetaData
from .cdc import CdcAdminHandler
from .ingest_pipeline import BatchCompactor, IngestGate

__all__ = [
    "ApplicationDB", "ApplicationDBManager", "AdminHandler", "DBMetaData",
    "CdcAdminHandler", "BatchCompactor", "IngestGate",
]
