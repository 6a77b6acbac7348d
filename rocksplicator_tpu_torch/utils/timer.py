"""RAII latency timers and slow-request sampled logging.
(The port's copy of ``rocksplicator_tpu/utils/timer.py``.)

Reference: common/timer.h (RAII latency metric) and common/slow_log_timer.h:20-45
(slow-request sampling logger).
"""

from __future__ import annotations

import logging
import random
import time
from typing import Optional

from .retry_policy import seeded_rng
from .stats import Stats

log = logging.getLogger(__name__)

# Slow-log sampling draws ride the seeded_rng()/RSTPU_RETRY_SEED
# contract (utils/retry_policy.py — the ONE home of the seed-pinning
# rule) instead of the global `random`: with the seed pinned, a chaos
# schedule or slow-log test sees a deterministic sample sequence.
# Created lazily so an env seed set at process start (how chaos arms
# children) is honored regardless of import order.
_slow_log_rng: Optional[random.Random] = None


def _slow_log_draw() -> float:
    global _slow_log_rng
    if _slow_log_rng is None:
        _slow_log_rng = seeded_rng()
    return _slow_log_rng.random()


def reset_slow_log_rng_for_test() -> None:
    """Re-derive the sampling RNG from the environment (tests pin
    RSTPU_RETRY_SEED and need the stream to restart)."""
    global _slow_log_rng
    _slow_log_rng = None


class Timer:
    """Context manager that records elapsed milliseconds as a metric."""

    def __init__(self, metric_name: str, stats: Optional[Stats] = None):
        self._metric = metric_name
        self._stats = stats or Stats.get()
        self._start = 0.0
        self.elapsed_ms = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        self.elapsed_ms = (time.monotonic() - self._start) * 1000.0
        self._stats.add_metric(self._metric, self.elapsed_ms)
        return False


class SlowLogTimer(Timer):
    """Timer that additionally logs a sampled message when elapsed time
    exceeds ``threshold_ms`` (reference slow_log_timer.h:20-45)."""

    def __init__(
        self,
        metric_name: str,
        threshold_ms: float = 100.0,
        sample_rate: float = 0.1,
        context: str = "",
        stats: Optional[Stats] = None,
    ):
        super().__init__(metric_name, stats)
        self._threshold_ms = threshold_ms
        self._sample_rate = sample_rate
        self._context = context

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        if self.elapsed_ms > self._threshold_ms \
                and _slow_log_draw() < self._sample_rate:
            log.warning(
                "slow request: %s took %.1fms (threshold %.1fms) %s",
                self._metric,
                self.elapsed_ms,
                self._threshold_ms,
                self._context,
            )
        return False
