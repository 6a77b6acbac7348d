"""Unified retry story: exponential backoff + full jitter + retry budget.
(The port's copy of ``rocksplicator_tpu/utils/retry_policy.py``.)

Reference: common/s3util.cpp leans on the AWS SDK's default retry
strategy (exp backoff, jittered, bounded attempts). Before this module
each backend hand-rolled its own: s3.py had an inline
``2**attempt * 0.1`` sleep, hdfs.py retried nothing, and the follower
pull loop drew a uniform delay that never grew. One policy object now
covers all of them, with two properties the chaos harness depends on:

- **determinism**: every jitter draw goes through a caller-supplied (or
  per-call seeded) ``random.Random`` — same seed, same schedule, which
  is what makes ``RSTPU_FAILPOINTS`` chaos runs reproducible from a
  printed ``--seed``;
- **a retry budget**: a token bucket shared by a client's retries so a
  hard-down dependency degrades to fail-fast instead of multiplying
  load (the classic retry-storm amplifier at 4000-host scale).

Retries are visible: each one increments ``retry.attempts op=<op>`` on
/stats, so a chaos run can show exactly which recovery path absorbed an
injected fault.
"""

from __future__ import annotations

import math
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

__all__ = ["RetryPolicy", "RetryBudget", "retry_call", "backoff_step",
           "seeded_rng", "retry_after_hint"]


def retry_after_hint(exc: BaseException) -> Optional[float]:
    """The server's retry-after hint, in SECONDS, from a typed
    ``RETRY_LATER`` application error (tail armor: the
    admission edge sheds with ``data={"retry_after_ms": ...}`` sized to
    the bucket refill / measured backlog). Duck-typed on ``.code`` /
    ``.data`` so this layer needs nothing from the rpc package. None
    for every other exception shape — callers fall back to their
    policy's own jittered delay."""
    if getattr(exc, "code", None) != "RETRY_LATER":
        return None
    data = getattr(exc, "data", None)
    if not isinstance(data, dict):
        return None
    try:
        hint_ms = float(data.get("retry_after_ms"))
    except (TypeError, ValueError):
        return None
    return max(0.0, hint_ms / 1e3)


def seeded_rng(env_var: str = "RSTPU_RETRY_SEED") -> random.Random:
    """The one place the seed-pinning contract lives: a private RNG
    seeded from ``env_var`` when set (reproducible chaos runs), random
    otherwise. Every retry loop that jitters should draw from one of
    these, not the global ``random``."""
    import os

    seed = os.environ.get(env_var)
    return random.Random(int(seed) if seed else None)


class RetryBudget:
    """Token bucket bounding retries (not first attempts) per client.
    ``try_spend`` never blocks: an empty bucket means the caller should
    surface the error now instead of piling on a struggling backend."""

    def __init__(self, capacity: float = 10.0, refill_per_sec: float = 1.0):
        self.capacity = float(capacity)
        self.refill_per_sec = float(refill_per_sec)
        self._tokens = float(capacity)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def try_spend(self, cost: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.capacity,
                self._tokens + (now - self._last) * self.refill_per_sec)
            self._last = now
            if self._tokens < cost:
                return False
            self._tokens -= cost
            return True


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter (delay ~ U[floor,
    cap_attempt], cap growing ``multiplier``-fold per attempt up to
    ``max_delay``). ``floor`` defaults to 0 (AWS-style full jitter);
    callers whose delay doubles as politeness toward a control plane
    (the follower pull loop) set ``floor`` to keep a hard minimum.

    ``max_attempts`` counts the first try: 4 means one call + up to
    three retries. Attempt indices passed to :meth:`delay` are 0-based
    retry indices (0 = delay before the first retry).
    """

    max_attempts: int = 4
    base_delay: float = 0.1
    max_delay: float = 5.0
    multiplier: float = 2.0
    jitter: bool = True
    floor: float = 0.0

    def cap(self, attempt: int) -> float:
        # saturating exponentiation: long-lived retry loops (a follower
        # through an hours-long outage) pass unbounded attempt counts,
        # and multiplier**attempt overflows float around attempt ~1024 —
        # past the saturation exponent the cap IS max_delay
        if self.base_delay <= 0.0:
            return 0.0  # parity with base*mult**n for any attempt
        if self.base_delay >= self.max_delay or self.multiplier <= 1.0:
            return min(self.max_delay, self.base_delay)
        sat = math.log(self.max_delay / self.base_delay, self.multiplier)
        if attempt >= sat:
            return self.max_delay
        return self.base_delay * (self.multiplier ** attempt)

    def delay(self, attempt: int,
              rng: Optional[random.Random] = None) -> float:
        cap = self.cap(attempt)
        if not self.jitter:
            return cap
        return (rng or random).uniform(min(self.floor, cap), cap)

    def schedule(self, seed: Optional[int] = None) -> List[float]:
        """The full jittered delay sequence for one seeded run —
        deterministic under a fixed seed (tested)."""
        rng = random.Random(seed)
        return [self.delay(a, rng) for a in range(self.max_attempts - 1)]


def backoff_step(
    policy: RetryPolicy,
    attempt: int,
    *,
    op: str,
    budget: Optional[RetryBudget] = None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
    hint: Optional[float] = None,
) -> bool:
    """One retry-accounting step — the ONE place retries are counted
    (``retry.attempts op=<op>`` on /stats), budget-gated, and slept.
    Returns False when the attempt count or budget is exhausted (caller
    surfaces its error); True after sleeping the jittered delay. Shared
    by :func:`retry_call` and loops that interleave their own
    status-code handling (the S3 client).

    ``hint`` (seconds, from :func:`retry_after_hint`) is a server-side
    retry-after floor: the delay becomes ``max(jittered, hint * (1 +
    U[0,0.25]))`` — honoring the admission edge's backlog estimate
    while re-jittering so a shed cohort doesn't return in lockstep."""
    if attempt >= policy.max_attempts - 1:
        return False
    if budget is not None and not budget.try_spend():
        return False
    try:
        from .stats import Stats, tagged

        Stats.get().incr(tagged("retry.attempts", op=op or "?"))
    except Exception:
        pass
    delay = policy.delay(attempt, rng)
    if hint is not None and hint > 0.0:
        delay = max(delay, hint * (1.0 + 0.25 * (rng or random).random()))
    sleep(delay)
    return True


def retry_call(
    fn: Callable,
    *,
    policy: RetryPolicy,
    classify: Callable[[BaseException], bool],
    op: str = "",
    budget: Optional[RetryBudget] = None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` under ``policy``. ``classify(exc)`` says whether an
    exception is transient (retryable); anything else — or attempt/budget
    exhaustion — re-raises the last error unchanged."""
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as e:
            if not classify(e):
                raise
            if not backoff_step(policy, attempt, op=op, budget=budget,
                                rng=rng, sleep=sleep,
                                hint=retry_after_hint(e)):
                raise
            attempt += 1
