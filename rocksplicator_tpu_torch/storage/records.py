"""Record op types — counterpart of ``rocksplicator_tpu/storage/records.py``
(``OpType`` only)."""

from __future__ import annotations

import enum


class OpType(enum.IntEnum):
    PUT = 1
    DELETE = 2
    MERGE = 3
    LOG_DATA = 4
