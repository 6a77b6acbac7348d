"""FastReadMap: read-optimized copy-on-write hash map.
(The port's copy of ``rocksplicator_tpu/utils/concurrent_map.py``.)

Reference: rocksdb_replicator/fast_read_map.h:36-140 — RWSpinLock + shared_ptr
swap so readers never block writers and reads are wait-free. In Python the
same effect comes from swapping an immutable dict reference (attribute reads
are atomic under the GIL); writers copy-on-write under a mutex. Readers also
get consistent snapshot iteration, which the reference exposes via ``for_each``.
"""

from __future__ import annotations

import threading
from typing import Dict, Generic, Hashable, Iterator, Optional, Tuple, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class FastReadMap(Generic[K, V]):
    def __init__(self) -> None:
        self._map: Dict[K, V] = {}
        self._write_lock = threading.Lock()

    def get(self, key: K) -> Optional[V]:
        return self._map.get(key)

    def add(self, key: K, value: V) -> bool:
        """Add; False if the key already exists (reference semantics)."""
        with self._write_lock:
            if key in self._map:
                return False
            new = dict(self._map)
            new[key] = value
            self._map = new
            return True

    def remove(self, key: K) -> bool:
        with self._write_lock:
            if key not in self._map:
                return False
            new = dict(self._map)
            del new[key]
            self._map = new
            return True

    def clear(self) -> None:
        with self._write_lock:
            self._map = {}

    def snapshot(self) -> Dict[K, V]:
        """Wait-free consistent snapshot (the swapped dict itself)."""
        return self._map

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: K) -> bool:
        return key in self._map

    def items(self) -> Iterator[Tuple[K, V]]:
        return iter(self._map.items())
