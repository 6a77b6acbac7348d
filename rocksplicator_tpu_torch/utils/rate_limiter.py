"""Token-bucket rate limiters.
(The port's copy of ``rocksplicator_tpu/utils/rate_limiter.py``.)

Reference: common/concurrent_rate_limiter.h (lock-free token bucket via
atomic State CAS) and common/aws_s3_rate_limiter.h (adapter implementing the
AWS SDK ``RateLimiterInterface``). Python's GIL stands in for the CAS loop;
the API (``try_get`` non-blocking, ``apply_cost`` blocking) matches both.
"""

from __future__ import annotations

import threading
import time


class ConcurrentRateLimiter:
    """Token bucket: ``rate`` tokens/sec, burst up to ``burst`` tokens."""

    def __init__(self, rate: float, burst: float | None = None):
        if rate <= 0:
            raise ValueError("rate must be positive")
        self._rate = rate
        self._burst = burst if burst is not None else rate
        self._tokens = self._burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        # _tokens may be negative (debt from an oversized apply_cost); refill
        # pays the debt first, then accumulates up to the burst cap.
        elapsed = now - self._last
        if elapsed > 0:
            self._tokens = min(self._burst, self._tokens + elapsed * self._rate)
            self._last = now

    def try_get(self, tokens: float = 1.0) -> bool:
        """Non-blocking acquire; True iff tokens were available."""
        with self._lock:
            now = time.monotonic()
            self._refill(now)
            if self._tokens >= tokens:
                self._tokens -= tokens
                return True
            return False

    def apply_cost(self, tokens: float = 1.0) -> float:
        """Blocking acquire (AWS RateLimiterInterface::ApplyCost semantics):
        charge the bucket — going into token debt if ``tokens`` exceeds the
        burst capacity — then sleep off any deficit. Returns seconds slept."""
        with self._lock:
            self._refill(time.monotonic())
            self._tokens -= tokens
            deficit = -self._tokens
        if deficit > 0:
            sleep_time = deficit / self._rate
            time.sleep(sleep_time)
            return sleep_time
        return 0.0

    @property
    def rate(self) -> float:
        return self._rate

    def set_rate(self, rate: float) -> None:
        if rate <= 0:
            raise ValueError("rate must be positive")
        with self._lock:
            self._refill(time.monotonic())
            self._rate = rate
