"""AckWindow: a windowed registry of in-flight leader writes awaiting
(The port's copy of ``rocksplicator_tpu/replication/ack_window.py``.)
follower ACKs.

Replaces :class:`MaxNumberBox` on the leader write path. The box's
``wait(num, timeout)`` blocked the writer thread per write — exactly one
write per shard could be in flight, so the ack round-trip (pull long-poll
RTT, ~95% of a semi-sync write per the traces) was paid serially
by every write. The window instead hands the writer a *future*:

- ``register(target_seq, ...)`` parks a waiter in a min-heap keyed by
  ``target_seq`` and returns immediately (flow control aside);
- ``post(n)`` resolves **every** waiter with ``target_seq <= n`` in one
  heap-pop pass — no Condition broadcast, no thundering herd of waiters
  re-checking a predicate (each ``MaxNumberBox.post`` woke all waiters;
  here each waiter is touched exactly once, when it resolves);
- a per-waiter deadline (min-heap keyed by deadline) preserves the
  reference's ack-timeout semantics (replicated_db.cpp:236-273) without
  a blocked thread: expiry is driven by the owner's event-loop timer via
  :meth:`expire_due`, so a pure-async writer's future still resolves
  when no follower ever acks;
- ``capacity`` bounds in-flight writes per shard (default from
  ``ReplicationFlags.write_window``): ``register`` blocks only when the
  window is full, which is the back-pressure that keeps an unacked
  backlog from growing without bound.

Resolution (ack, timeout, or close) is reported through the owner's
``on_resolve(waiter, acked)`` callback, invoked OUTSIDE the window lock
in target_seq order — the one place stats, the degradation state
machine, deferred ``repl.ack_wait`` spans, and the public future are
settled.

``MaxNumberBox`` itself now lives here too (the general max-watermark
utility is still used by tests and stays exported);
``max_number_box.py`` re-exports it for compatibility.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple


class MaxNumberBox:
    """Tracks the max ACKed sequence number and wakes waiters.

    Reference: rocksdb_replicator/max_number_box.h:38-83 — ``post(n)``
    raises the box's number and wakes waiters whose target ≤ n;
    ``wait(num, timeout)`` blocks until the box reaches ``num``.
    """

    def __init__(self, initial: int = 0):
        self._max = initial
        self._cond = threading.Condition()

    @property
    def value(self) -> int:
        with self._cond:
            return self._max

    def post(self, number: int) -> None:
        with self._cond:
            if number > self._max:
                self._max = number
                self._cond.notify_all()

    def wait(self, number: int, timeout_sec: float) -> bool:
        """True iff the box reached ``number`` within the timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: self._max >= number, timeout_sec)


class AckWaiter:
    """One in-flight write awaiting its follower ACK.

    ``future`` resolves to the write's start seq once the ack arrived OR
    the per-write timeout expired (mirroring the blocking path, which
    returned the seq either way and left timeout accounting to the
    degradation state machine); ``acked`` records which it was. ``span``
    optionally holds a deferred ``repl.ack_wait`` span finished at
    resolution time, so sampled traces show the real (overlapping)
    ack-wait intervals under pipelining.
    """

    __slots__ = ("target_seq", "seq", "deadline", "future", "acked",
                 "span", "done")

    def __init__(self, target_seq: int, seq: int, deadline: float,
                 span=None):
        self.target_seq = target_seq
        self.seq = seq
        self.deadline = deadline
        self.future: Future = Future()
        self.acked = False
        self.span = span
        self.done = False

    def result(self, timeout: Optional[float] = None) -> int:
        """Block until resolution; returns the write's start seq."""
        return self.future.result(timeout)


# resolved immediately at creation: mode-0 / non-leader writes need no ack
def resolved_waiter(seq: int) -> AckWaiter:
    w = AckWaiter(seq, seq, 0.0)
    w.done = True
    w.acked = True
    w.future.set_result(seq)
    return w


class AckWindow:
    """Min-heap ack-future registry with per-shard flow control."""

    def __init__(
        self,
        capacity: int,
        on_resolve: Optional[Callable[[AckWaiter, bool], None]] = None,
        initial: int = 0,
    ):
        self._capacity = max(1, int(capacity))
        self._on_resolve = on_resolve
        self._max = initial
        self._cond = threading.Condition()
        self._tie = itertools.count()  # heap tiebreaker (waiters not orderable)
        self._by_seq: List[Tuple[int, int, AckWaiter]] = []
        self._by_deadline: List[Tuple[float, int, AckWaiter]] = []
        self._inflight = 0
        self._closed = False

    # -- introspection (lock-free reads of ints are atomic enough) --------

    @property
    def value(self) -> int:
        """Max ACKed sequence number (MaxNumberBox-compatible)."""
        return self._max

    @property
    def depth(self) -> int:
        """Current number of in-flight (unresolved) waiters."""
        return self._inflight

    @property
    def capacity(self) -> int:
        return self._capacity

    # -- registration (writer threads) ------------------------------------

    def register(self, target_seq: int, seq: int, timeout_sec: float,
                 span=None) -> AckWaiter:
        """Park a waiter for ``target_seq``. Blocks only while the window
        is at capacity (flow control); a closed window resolves the
        waiter immediately as not-acked."""
        now = time.monotonic()
        w = AckWaiter(target_seq, seq, now + timeout_sec, span)
        with self._cond:
            while self._inflight >= self._capacity and not self._closed:
                # Slots free on ack (post) or expiry (the owner's loop
                # timer). Bounded waits keep this robust if the timer is
                # torn down mid-shutdown: each wakeup re-checks _closed.
                self._cond.wait(0.05)
            if self._closed:
                w.done = True
                self._settle([(w, False)])
                return w
            if self._max >= target_seq:
                # ack already arrived (e.g. a mode-2 pull confirmed past
                # this seq before the writer registered)
                w.done = True
                w.acked = True
                self._settle([(w, True)])
                return w
            tie = next(self._tie)
            heapq.heappush(self._by_seq, (target_seq, tie, w))
            heapq.heappush(self._by_deadline, (w.deadline, tie, w))
            self._inflight += 1
        return w

    # -- resolution (loop thread / server path) ----------------------------

    def post(self, number: int) -> int:
        """Raise the ack watermark; resolve every waiter ≤ number in one
        pass. Returns how many waiters resolved."""
        settled: List[Tuple[AckWaiter, bool]] = []
        with self._cond:
            if number > self._max:
                self._max = number
            while self._by_seq and self._by_seq[0][0] <= self._max:
                _, _, w = heapq.heappop(self._by_seq)
                if w.done:
                    continue  # lazily-deleted (expired) entry
                w.done = True
                w.acked = True
                self._inflight -= 1
                settled.append((w, True))
            if settled:
                self._cond.notify_all()  # free flow-control waiters
        self._settle(settled)
        return len(settled)

    def expire_due(self, now: Optional[float] = None) -> Optional[float]:
        """Resolve (not-acked) every waiter whose deadline passed.
        Returns the next pending deadline, or None when idle — the
        owner's timer re-arms off this."""
        if now is None:
            now = time.monotonic()
        settled: List[Tuple[AckWaiter, bool]] = []
        next_deadline: Optional[float] = None
        with self._cond:
            while self._by_deadline:
                deadline, _, w = self._by_deadline[0]
                if w.done:
                    heapq.heappop(self._by_deadline)
                    continue
                if deadline > now:
                    next_deadline = deadline
                    break
                heapq.heappop(self._by_deadline)
                w.done = True
                self._inflight -= 1
                settled.append((w, False))
            if settled:
                self._cond.notify_all()
        self._settle(settled)
        return next_deadline

    def close(self) -> None:
        """Resolve everything still in flight (not-acked) and refuse new
        registrations — no writer may hang across a stop()."""
        settled: List[Tuple[AckWaiter, bool]] = []
        with self._cond:
            self._closed = True
            while self._by_seq:
                _, _, w = heapq.heappop(self._by_seq)
                if w.done:
                    continue
                w.done = True
                self._inflight -= 1
                settled.append((w, False))
            self._by_deadline.clear()
            self._cond.notify_all()
        self._settle(settled)

    # -- internal ----------------------------------------------------------

    def _settle(self, settled: List[Tuple[AckWaiter, bool]]) -> None:
        """Run owner accounting + resolve futures OUTSIDE the lock, in
        target_seq order (post pops in seq order already; expiry batches
        are sorted here so the degradation counter sees writes in order)."""
        if not settled:
            return
        settled.sort(key=lambda pair: pair[0].target_seq)
        cb = self._on_resolve
        for w, acked in settled:
            if cb is not None:
                try:
                    cb(w, acked)
                except Exception:  # owner accounting must never wedge acks
                    pass
            w.future.set_result(w.seq)
