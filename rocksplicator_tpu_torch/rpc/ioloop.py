"""IoLoop: one asyncio event loop in a dedicated IO thread.
(The port's copy of ``rocksplicator_tpu/rpc/ioloop.py``.)

Reference analog: common/thrift_client_pool.h's N IO threads each driving a
folly EventBase. Here one loop multiplexes all connections (Python sockets
are cheap under asyncio); sync layers submit coroutines and wait on
concurrent futures, matching the reference pattern of CPU worker threads
handing IO to EventBase threads.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import threading
import time
from typing import Any, Awaitable, Coroutine, Optional, TypeVar

T = TypeVar("T")

# Loop-stall watchdog (the runtime half of rstpu-check pass 2): armed
# with the lockwatch (RSTPU_LOCKWATCH) or on its own (RSTPU_LOOPWATCH=1),
# a monitor task measures dispatch lag every tick and publishes stalls
# longer than RSTPU_LOOPWATCH_MS (default 100) as `ioloop.stalls` +
# `ioloop.stall_ms` on /stats — one blocking call on the loop stalls
# every colocated replica, and this is how a chaos run notices.
_WATCH_TICK_S = 0.25


def _loopwatch_armed() -> bool:
    return bool(os.environ.get("RSTPU_LOCKWATCH")
                or os.environ.get("RSTPU_LOOPWATCH"))


class IoLoop:
    _default: Optional["IoLoop"] = None
    _default_lock = threading.Lock()

    def __init__(self, name: str = "rpc-io"):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()
        if _loopwatch_armed():
            self._stall_threshold_s = float(
                os.environ.get("RSTPU_LOOPWATCH_MS", "100")) / 1000.0
            self._loop.call_soon_threadsafe(
                self._stall_tick, time.monotonic())

    def _stall_tick(self, last: float) -> None:
        # self-rescheduling call_later chain (no long-lived task to
        # destroy at loop stop): dispatch lag beyond the tick interval
        # is time some callback/coroutine spent hogging the loop
        now = time.monotonic()
        lag = now - last - _WATCH_TICK_S
        if lag > self._stall_threshold_s:
            from ..utils.stats import Stats

            stats = Stats.get()
            stats.incr("ioloop.stalls")
            stats.add_metric("ioloop.stall_ms", lag * 1000.0)
        self._loop.call_later(_WATCH_TICK_S, self._stall_tick, now)

    @classmethod
    def default(cls) -> "IoLoop":
        with cls._default_lock:
            if cls._default is None or not cls._default._thread.is_alive():
                cls._default = cls()
            return cls._default

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.call_soon(self._started.set)
        self._loop.run_forever()

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        return self._loop

    def run_coro(self, coro: Coroutine[Any, Any, T]) -> "concurrent.futures.Future[T]":
        """Submit a coroutine from any thread; returns a concurrent future."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def run_sync(self, coro: Coroutine[Any, Any, T], timeout: Optional[float] = None) -> T:
        if threading.current_thread() is self._thread:
            raise RuntimeError("run_sync called from the IO thread (would deadlock)")
        return self.run_coro(coro).result(timeout)

    def call_soon(self, fn, *args) -> None:
        self._loop.call_soon_threadsafe(fn, *args)

    def stop(self) -> None:
        def _shutdown():
            for task in asyncio.all_tasks(self._loop):
                task.cancel()
            self._loop.stop()

        self._loop.call_soon_threadsafe(_shutdown)
        self._thread.join(timeout=5.0)
