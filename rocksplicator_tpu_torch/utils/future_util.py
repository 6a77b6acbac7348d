"""Async combinators: delayed futures and speculative (hedged) requests.
(The port's copy of ``rocksplicator_tpu/utils/future_util.py``.)

Reference: common/future_util.{h,cpp} — ``GenerateDelayedFuture`` and a
speculative/backup-request future combinator used for hedged reads at the
router layer. Here expressed over asyncio.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, TypeVar

T = TypeVar("T")


async def delayed(value: T, delay_sec: float) -> T:
    """GenerateDelayedFuture equivalent."""
    await asyncio.sleep(delay_sec)
    return value


async def speculate(
    primary: Callable[[], Awaitable[T]],
    backup: Callable[[], Awaitable[T]],
    backup_delay_sec: float,
) -> T:
    """Hedged request: start ``primary``; if it hasn't completed within
    ``backup_delay_sec``, also start ``backup``; return the first success.
    Fails only if both fail (reference future_util speculative combinator).
    """
    primary_task = asyncio.ensure_future(primary())
    try:
        return await asyncio.wait_for(asyncio.shield(primary_task), backup_delay_sec)
    except asyncio.TimeoutError:
        pass
    except Exception:
        # Primary failed fast — fall through to the backup alone.
        return await backup()

    backup_task = asyncio.ensure_future(backup())
    tasks = {primary_task, backup_task}
    result: T
    last_exc: BaseException | None = None
    while tasks:
        done, tasks = await asyncio.wait(tasks, return_when=asyncio.FIRST_COMPLETED)
        for task in done:
            exc = task.exception()
            if exc is None:
                for t in tasks:
                    t.cancel()
                # rstpu-check: allow(loop-blocking) asyncio.Task.result() on a task from asyncio.wait's done set — already completed, returns immediately
                return task.result()
            last_exc = exc
    assert last_exc is not None
    raise last_exc
