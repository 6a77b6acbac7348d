"""Per-object (per-db-name) lock registry.
(The port's copy of ``rocksplicator_tpu/utils/object_lock.py``.)

Reference: common/object_lock.h:42-209 — striped per-object mutexes used to
serialize admin operations per db name. The reference uses bucketed intrusive
lists with a node pool; here a refcounted dict of locks gives the same
semantics (an object's lock exists only while held or waited on).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Hashable, Iterator, Tuple


class ObjectLock:
    def __init__(self) -> None:
        self._guard = threading.Lock()
        self._locks: Dict[Hashable, Tuple[threading.RLock, int]] = {}

    def lock(self, key: Hashable) -> None:
        with self._guard:
            entry = self._locks.get(key)
            if entry is None:
                lk = threading.RLock()
                self._locks[key] = (lk, 1)
            else:
                lk, refs = entry
                self._locks[key] = (lk, refs + 1)
        lk.acquire()

    def unlock(self, key: Hashable) -> None:
        with self._guard:
            lk, refs = self._locks[key]
            if refs == 1:
                del self._locks[key]
            else:
                self._locks[key] = (lk, refs - 1)
        lk.release()

    def try_lock(self, key: Hashable) -> bool:
        with self._guard:
            entry = self._locks.get(key)
            if entry is None:
                lk = threading.RLock()
                self._locks[key] = (lk, 1)
            else:
                lk, refs = entry
                self._locks[key] = (lk, refs + 1)
        ok = lk.acquire(blocking=False)
        if not ok:
            with self._guard:
                lk2, refs = self._locks[key]
                if refs == 1:
                    del self._locks[key]
                else:
                    self._locks[key] = (lk2, refs - 1)
        return ok

    @contextmanager
    def locked(self, key: Hashable) -> Iterator[None]:
        self.lock(key)
        try:
            yield
        finally:
            self.unlock(key)

    def num_live_locks(self) -> int:
        with self._guard:
            return len(self._locks)
