"""Per-dataset dynamic configuration.
(The port's copy of ``rocksplicator_tpu/utils/dbconfig.py``.)

Reference: common/dbconfig.{h,cpp} + common/config.h — singleton holding a
JSON config keyed by dataset (segment); currently one knob in the reference:
``replication_mode`` (ack mode) per dataset; hot-reloaded via FileWatcher
with an atomic shared_ptr swap (dbconfig.h:30-70).
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Any, Dict, Optional

from .file_watcher import FileWatcher

log = logging.getLogger(__name__)


class DBConfig:
    """Immutable parsed config snapshot."""

    def __init__(self, raw: Dict[str, Any]):
        self._raw = raw

    def replication_mode(self, segment: str, default: int = 0) -> int:
        entry = self._raw.get(segment)
        if isinstance(entry, dict):
            return int(entry.get("replication_mode", default))
        return default

    def get(self, segment: str, key: str, default: Any = None) -> Any:
        entry = self._raw.get(segment)
        if isinstance(entry, dict):
            return entry.get(key, default)
        return default

    @property
    def raw(self) -> Dict[str, Any]:
        return self._raw


class DBConfigManager:
    """Singleton; atomic snapshot swap on file change."""

    _instance: Optional["DBConfigManager"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._config = DBConfig({})
        self._path: Optional[str] = None

    @classmethod
    def get(cls) -> "DBConfigManager":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    @classmethod
    def reset_for_test(cls) -> None:
        with cls._instance_lock:
            if cls._instance is not None and cls._instance._path is not None:
                FileWatcher.instance().remove_file(
                    cls._instance._path, cls._instance._on_content
                )
            cls._instance = None

    def load_from_file(self, path: str, watch: bool = True) -> None:
        if self._path is not None:
            FileWatcher.instance().remove_file(self._path, self._on_content)
        self._path = path
        if watch:
            FileWatcher.instance().add_file(path, self._on_content)
        else:
            try:
                with open(path, "rb") as f:
                    self._on_content(f.read())
            except OSError:
                log.warning("db config file missing: %s", path)

    def load_from_dict(self, raw: Dict[str, Any]) -> None:
        self._config = DBConfig(dict(raw))

    def _on_content(self, content: bytes) -> None:
        try:
            raw = json.loads(content.decode("utf-8")) if content.strip() else {}
        except (ValueError, UnicodeDecodeError):
            log.error("invalid db config JSON, keeping previous config")
            return
        if not isinstance(raw, dict):
            log.error("db config must be a JSON object, keeping previous config")
            return
        self._config = DBConfig(raw)

    @property
    def config(self) -> DBConfig:
        return self._config

    def get_replication_mode(self, segment: str, default: int = 0) -> int:
        return self._config.replication_mode(segment, default)
