"""Hot-key detection via SpaceSaving-style K-bucket counting with time decay.
(The port's copy of ``rocksplicator_tpu/utils/hot_key_detector.py``.)

Reference: common/hot_key_detector.{h,cpp}:64-204 — tracks the top-K keys by
access count; counts decay over time so stale hot keys cool off. Reference
benchmark: record(int) ≈55ns (hot_key_detector.h:52-62); the Python version
trades that for simplicity (the C++ native engine owns the true hot path).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Hashable, List, Tuple


class HotKeyDetector:
    """Track the hottest keys among a stream of accesses.

    ``record(key)`` counts an access; ``is_above(key, threshold)`` reports
    whether the key's decayed rate share exceeds ``threshold`` (0..1);
    ``top(n)`` returns the hottest keys.
    """

    def __init__(self, num_buckets: int = 100, decay_half_life_sec: float = 60.0):
        self._k = num_buckets
        self._half_life = decay_half_life_sec
        self._lock = threading.Lock()
        self._counts: Dict[Hashable, float] = {}
        self._total = 0.0
        self._last_decay = time.monotonic()

    def _decay(self, now: float) -> None:
        elapsed = now - self._last_decay
        if elapsed < 1.0:
            return
        factor = 0.5 ** (elapsed / self._half_life)
        self._last_decay = now
        self._total *= factor
        for k in list(self._counts):
            v = self._counts[k] * factor
            if v < 0.5:
                del self._counts[k]
            else:
                self._counts[k] = v

    def record(self, key: Hashable, count: float = 1.0) -> None:
        with self._lock:
            now = time.monotonic()
            self._decay(now)
            self._total += count
            if key in self._counts:
                self._counts[key] += count
            elif len(self._counts) < self._k:
                self._counts[key] = count
            else:
                # SpaceSaving: evict the minimum, inherit its count.
                min_key = min(self._counts, key=self._counts.__getitem__)
                min_count = self._counts.pop(min_key)
                self._counts[key] = min_count + count

    def is_above(self, key: Hashable, threshold: float) -> bool:
        with self._lock:
            self._decay(time.monotonic())
            if self._total <= 0:
                return False
            return self._counts.get(key, 0.0) / self._total > threshold

    def top(self, n: int = 10) -> List[Tuple[Hashable, float]]:
        with self._lock:
            self._decay(time.monotonic())
            items = sorted(self._counts.items(), key=lambda kv: -kv[1])
            return items[:n]

    def total(self) -> float:
        """Decayed total access count (the denominator of is_above)."""
        with self._lock:
            self._decay(time.monotonic())
            return self._total
