"""AsyncNotifier: park long-poll requests without holding threads.
(The port's copy of ``rocksplicator_tpu/replication/cond_var.py``.)

Reference: rocksdb_replicator/non_blocking_condition_variable.h:40-165 —
an executor-backed condition variable where a task runs when its predicate
is true, when notifyAll fires, or on timeout, exactly once. With asyncio
the same contract is a notifier whose ``wait(timeout)`` parks a coroutine
(no thread held — same property that lets thousands of long-polls park)
and a thread-safe ``notify_all`` that wakes every parked waiter.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Set


class AsyncNotifier:
    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._waiters: Set[asyncio.Future] = set()
        self._wake_pending = False

    async def wait(self, timeout_sec: float) -> bool:
        """Park until notify_all or timeout. True iff notified."""
        fut = self.reserve()
        return await self.wait_reserved(fut, timeout_sec)

    def reserve(self) -> asyncio.Future:
        """Register a waiter slot NOW (loop thread only) without parking.
        Lets a caller re-check its predicate AFTER registration — any
        state change after reserve() is guaranteed to notify this slot,
        so the check-then-park race has no missed-wakeup window — which
        in turn makes the writer-side empty-set fast path sound."""
        fut: asyncio.Future = self._loop.create_future()
        self._waiters.add(fut)
        return fut

    async def wait_reserved(self, fut: asyncio.Future,
                            timeout_sec: float) -> bool:
        """Park on a slot from reserve(). True iff notified."""
        try:
            await asyncio.wait_for(fut, timeout_sec)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            self._waiters.discard(fut)

    def cancel_reserved(self, fut: asyncio.Future) -> None:
        """Release an unused slot (predicate became true before parking)."""
        self._waiters.discard(fut)

    def notify_all(self) -> None:
        """Callable only on the loop thread; use notify_all_threadsafe
        elsewhere."""
        for fut in self._waiters:
            if not fut.done():
                fut.set_result(True)
        self._waiters.clear()

    def notify_all_threadsafe(self) -> None:
        # Empty-set fast path: per-write loop wakeups would otherwise cost
        # a syscall + loop callback per write even with nobody parked (the
        # common pipelined steady state — pullers have backlog and don't
        # park). Safe because waiters register via reserve() BEFORE
        # re-checking the condition: a writer observing the pre-reserve
        # empty set implies the waiter's post-reserve check sees that
        # write. (_waiters mutates only on the loop thread; reading its
        # emptiness from another thread is GIL-atomic.)
        if not self._waiters:
            return
        # Coalescing: N writes landing between two loop iterations
        # schedule ONE wakeup (one self-pipe write), not N. _wake clears
        # the flag BEFORE notifying, so a write racing the notify
        # schedules a fresh wakeup and nothing is missed.
        if self._wake_pending:
            return
        self._wake_pending = True
        self._loop.call_soon_threadsafe(self._wake)

    def _wake(self) -> None:
        self._wake_pending = False
        self.notify_all()
