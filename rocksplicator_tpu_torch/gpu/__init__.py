"""The engine seam of the port — counterpart of ``rocksplicator_tpu/tpu``
(``backend.py``, ``chunked.py``, ``format.py``).

``GpuCompactionBackend`` plugs into the storage engine's
``CompactionBackend`` seam and compacts on the card; importing it builds
no kernel (kernels build on first launch).
"""

from .backend import GpuCompactionBackend, NumpyCompactionBackend

__all__ = ["GpuCompactionBackend", "NumpyCompactionBackend"]
