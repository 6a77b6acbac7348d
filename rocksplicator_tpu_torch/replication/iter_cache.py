"""Cached WAL update iterators with idle eviction.
(The port's copy of ``rocksplicator_tpu/replication/iter_cache.py``.)

Reference: replicated_db.cpp:577-611 (cached TransactionLogIterators so
long WAL scans don't restart per request) + cached_iter_cleaner.cpp:29-78
(background eviction of iterators idle > 60s).

A cached cursor is keyed by the next seq it will serve; a follower's steady
pull stream hits the cache every time (seq_n+1 == next), so serving N
updates costs one WAL position, not a rescan from seq 0.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from ..utils.stats import Stats
from .wire import REPLICATOR_METRICS as M


class _Cursor:
    __slots__ = ("it", "next_seq", "last_used")

    def __init__(self, it: Iterator[Tuple[int, bytes]], next_seq: int):
        self.it = it
        self.next_seq = next_seq
        self.last_used = time.monotonic()


class IterCache:
    """next_seq → cursors. Multiple cursors may share one key: two
    followers tailing the same shard both park at the same next_seq, and
    a single-slot map would make them evict each other every pull (each
    miss re-scans the active WAL segment — the exact cost the cache
    exists to avoid)."""

    def __init__(self, idle_timeout_sec: float = 60.0, max_cursors: int = 8):
        self._idle_timeout = idle_timeout_sec
        self._max = max_cursors
        self._lock = threading.Lock()
        self._cursors: Dict[int, List[_Cursor]] = {}

    @staticmethod
    def _close(cur: _Cursor) -> None:
        close = getattr(cur.it, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass

    def take(self, next_seq: int) -> Optional[Iterator[Tuple[int, bytes]]]:
        """Pop a cursor positioned at next_seq, if cached."""
        with self._lock:
            lst = self._cursors.get(next_seq)
            cur = lst.pop() if lst else None
            if lst is not None and not lst:
                self._cursors.pop(next_seq, None)
        if cur is not None:
            Stats.get().incr(M["iter_cache_hits"])
            return cur.it
        Stats.get().incr(M["iter_cache_misses"])
        return None

    def put(self, next_seq: int, it: Iterator[Tuple[int, bytes]]) -> None:
        evicted = None
        with self._lock:
            self._cursors.setdefault(next_seq, []).append(_Cursor(it, next_seq))
            total = sum(len(v) for v in self._cursors.values())
            if total > self._max:
                oldest_key = min(
                    self._cursors,
                    key=lambda k: min(c.last_used for c in self._cursors[k]),
                )
                lst = self._cursors[oldest_key]
                lst.sort(key=lambda c: c.last_used)
                evicted = lst.pop(0)
                if not lst:
                    del self._cursors[oldest_key]
        if evicted is not None:
            self._close(evicted)

    def evict_idle(self, now: Optional[float] = None) -> int:
        """Reference CachedIterCleaner behavior; called by the replicator's
        periodic maintenance task."""
        now = time.monotonic() if now is None else now
        evicted: List[_Cursor] = []
        with self._lock:
            for k in list(self._cursors):
                lst = self._cursors[k]
                keep = []
                for c in lst:
                    (keep if now - c.last_used <= self._idle_timeout
                     else evicted).append(c)
                if keep:
                    self._cursors[k] = keep
                else:
                    del self._cursors[k]
        for c in evicted:
            self._close(c)
        return len(evicted)

    def clear(self) -> None:
        with self._lock:
            dropped = [c for lst in self._cursors.values() for c in lst]
            self._cursors.clear()
        for c in dropped:
            self._close(c)
