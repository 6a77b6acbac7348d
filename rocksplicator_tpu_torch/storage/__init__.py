"""The storage engine — the port's copy of ``rocksplicator_tpu/storage``:
the LSM ``DB`` (memtable, WAL, flush, levels, compaction, ingest,
checkpoint), the TSST format, the native host library, and the
compaction pipeline's host side (streaming merge, subcompactions).

The public names are the JAX package's. One default differs: a ``DB``
opened without a ``compaction_backend`` compacts on the card
(``gpu.GpuCompactionBackend()``); the host's
``native_compaction.NativeCompactionBackend`` is asked for by name.
"""

from .records import WriteBatch, OpType, decode_batch
from .engine import DB, DBOptions, destroy_db
from .errors import StorageError, NotFoundError, Corruption
from .merge import MergeOperator, UInt64AddOperator

__all__ = [
    "DB", "DBOptions", "destroy_db", "WriteBatch", "OpType",
    "decode_batch", "StorageError", "NotFoundError", "Corruption",
    "MergeOperator", "UInt64AddOperator",
]
