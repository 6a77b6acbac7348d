"""ApplicationDBManager: the name → ApplicationDB registry.
(The port's copy of ``rocksplicator_tpu/admin/db_manager.py``.)

Reference: rocksdb_admin/application_db_manager.{h,cpp} — shared_mutex map;
removal spin-waits use_count()==1 (here: explicit close after removal from
the map — new lookups can't find it, in-flight ops finish on their
reference); DB-size stats text dump (application_db_manager.cpp:140-150).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..utils.stats import Stats
from .application_db import ApplicationDB


class ApplicationDBManager:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._dbs: Dict[str, ApplicationDB] = {}

    def add_db(self, name: str, app_db: ApplicationDB) -> bool:
        with self._lock:
            if name in self._dbs:
                return False
            self._dbs[name] = app_db
            return True

    def get_db(self, name: str) -> Optional[ApplicationDB]:
        with self._lock:
            return self._dbs.get(name)

    def remove_db(self, name: str, close: bool = True) -> Optional[ApplicationDB]:
        with self._lock:
            app_db = self._dbs.pop(name, None)
        if app_db is not None and close:
            app_db.close()
        return app_db

    def get_all_db_names(self) -> List[str]:
        with self._lock:
            return sorted(self._dbs.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._dbs)

    def dump_db_stats_as_text(self) -> str:
        """reference DumpDBStatsAsText + per-db size gauges
        (application_db_manager.cpp:120-150)."""
        lines = []
        with self._lock:
            dbs = list(self._dbs.items())
        for name, app_db in sorted(dbs):
            try:
                size = app_db.db.approximate_disk_size()
                seq = app_db.latest_sequence_number()
                lines.append(
                    f"db={name} role={app_db.role.value} seq={seq} "
                    f"sst_bytes={size}"
                )
            except Exception as e:  # closed mid-dump
                lines.append(f"db={name} error={e!r}")
        return "\n".join(lines) + "\n"
