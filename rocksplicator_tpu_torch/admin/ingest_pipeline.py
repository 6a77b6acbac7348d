"""Bulk-ingest pipeline plumbing: admission gate + cross-shard batched
post-load compaction — counterpart of
``rocksplicator_tpu/admin/ingest_pipeline.py``.

The pipelined load_sst path is three bounded stages:

- **download/validate** — outside the per-db admin lock, globally bounded
  by :class:`IngestGate` (the reference's
  ``num_current_s3_sst_downloadings_`` TOO_MANY_REQUESTS gate,
  admin_handler.cpp:1692-1706) so shard k+1's object-store fetch overlaps
  shard k's engine ingest;
- **ingest + meta** — back under the per-db admin lock with a staleness
  re-check (the lock-narrowing half; see admin/handler.py);
- **post-load compact** — :class:`BatchCompactor`: concurrent shards'
  compactions coalesce AckWindow/group-commit style; one submitter
  becomes the dispatch leader and drains the whole queue as a batch (one
  batched launch per group on the card via
  gpu.compaction_service.compact_dbs_batched; thread-pool fan-out of
  per-DB compactions otherwise), every submitter just waits on its
  shard's future.

``compact_dbs_batched`` raises when a launch or a file bloom fails.
:class:`BatchCompactor` logs it; the DBs the batch already compacted
keep their result. On the card the others' waiters get the exception: a
kernel that fails there is never hidden behind another path. On the CPU
(the kernels' plain versions) the others compact per DB, as the JAX
package's declined group does.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ..device import resolve_device
from ..testing import failpoints as fp

log = logging.getLogger(__name__)


def default_sst_loading_concurrency() -> int:
    """CPU-derived default for the ingest admission gate. The reference
    gflag defaulted to 999 — dead code as a gate; download+validate is
    IO-plus-checksum work, so ~2 slots per core keeps the pipeline full
    without letting an ingest storm starve serving threads."""
    return max(4, 2 * (os.cpu_count() or 2))


class IngestGate:
    """Counting admission gate for in-flight SST loads. ``try_enter``
    never blocks — over-capacity callers are REJECTED (the handler maps
    that to TOO_MANY_REQUESTS, matching the reference's behavior of
    telling the orchestrator to back off rather than queueing)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._free = threading.Condition(self._lock)
        self._in_flight = 0
        self._waiting = 0

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def try_enter(self) -> bool:
        with self._lock:
            if self._in_flight >= self.capacity:
                return False
            self._in_flight += 1
            return True

    def enter_wait(self, timeout: float, max_waiting: int = 2) -> bool:
        """Blocking admission for callers that should QUEUE rather than
        bounce: snapshot-restore downloads in a live shard move (a
        drain-node moving N shards pipelines its bulk transfers through
        this gate, exactly like the SST-load path, instead of saturating
        the NIC/disk N-wide). Returns False when no slot freed within
        ``timeout`` — or IMMEDIATELY when ``max_waiting`` callers are
        already parked: each waiter occupies a shared admin-executor
        thread, and an unbounded queue of 10-minute waits would starve
        every other admin RPC on the host (the WRITE_WINDOW_FULL
        fail-fast lesson). The SST-load RPC keeps try_enter's
        reject-don't-queue contract."""
        deadline = time.monotonic() + timeout
        with self._free:
            if self._in_flight >= self.capacity \
                    and self._waiting >= max_waiting:
                return False
            self._waiting += 1
            try:
                while self._in_flight >= self.capacity:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._free.wait(remaining):
                        if self._in_flight < self.capacity:
                            break
                        return False
                self._in_flight += 1
                return True
            finally:
                self._waiting -= 1

    def exit(self) -> None:
        with self._lock:
            self._in_flight -= 1
            self._free.notify()


class BatchCompactor:
    """Group-commit for post-load compactions.

    ``compact(db_name, db)`` blocks until the shard's full compaction is
    done, but concurrent callers are BATCHED: the first submitter into an
    idle compactor becomes the leader and repeatedly drains everything
    queued (shards that arrive while a batch runs form the next batch —
    the same natural coalescing as WAL group commit). Dispatch goes
    through the configured backend: batched launches on ``device`` when
    ``use_gpu`` (compact_dbs_batched), thread-pool fan-out of per-db
    ``compact_range`` otherwise (and for shards the lane representation
    declines, and on the CPU for the shards of a group whose launch
    failed; on the card their waiters get the launch's exception).

    ``use_gpu`` is the counterpart of the JAX package's ``use_tpu``; the
    card is the default here. ``device``: None means ``cuda`` (raises
    without it); ``"cpu"`` runs the kernels' plain versions.
    """

    def __init__(self, use_gpu: bool = True, device=None,
                 compact_parallelism: Optional[int] = None,
                 max_batch: int = 64):
        self._use_gpu = use_gpu
        self.device = resolve_device(device) if use_gpu else None
        self._max_batch = max_batch
        self._lock = threading.Lock()
        self._queue: List[Tuple[str, object, Future]] = []
        self._dispatching = False
        # compaction releases the GIL in its numpy/zlib/fsync phases, so
        # more workers than cores still overlaps usefully
        self._pool = ThreadPoolExecutor(
            max_workers=compact_parallelism or max(4, os.cpu_count() or 2),
            thread_name_prefix="post-load-compact",
        )
        # observability: batches dispatched and their sizes (tests + the
        # bench's "did the batching actually batch" assertion)
        self.dispatch_count = 0
        self.batch_sizes: List[int] = []

    def compact(self, db_name: str, db) -> int:
        """Compact ``db`` (a storage.engine.DB), batched with concurrent
        callers. Returns the size of the batch this shard rode in."""
        fut: Future = Future()
        with self._lock:
            self._queue.append((db_name, db, fut))
            leader = not self._dispatching
            if leader:
                self._dispatching = True
        if leader:
            try:
                while True:
                    with self._lock:
                        batch = self._queue[: self._max_batch]
                        del self._queue[: self._max_batch]
                        if not batch:
                            self._dispatching = False
                            break
                    try:
                        self._dispatch(batch)
                    except BaseException as e:
                        # a dispatch blow-up (e.g. pool shutdown mid-close)
                        # must fail ITS batch loudly and keep draining —
                        # never strand waiters or the leadership flag
                        log.exception("compact dispatch failed")
                        for _n, _d, f in batch:
                            if not f.done():
                                f.set_exception(e)
            except BaseException:
                # pathological (queue handling itself raised): hand
                # leadership back so the compactor is not wedged forever
                with self._lock:
                    self._dispatching = False
                raise
        return fut.result()

    # -- dispatch ---------------------------------------------------------

    def _dispatch(self, batch: List[Tuple[str, object, Future]]) -> None:
        from ..observability.span import start_span

        # the annotation keeps the JAX package's key: dashboards read it
        with start_span("admin.compact_dispatch", always=True,
                        shards=len(batch), tpu=self._use_gpu):
            self._dispatch_spanned(batch)

    def _dispatch_spanned(self, batch: List[Tuple[str, object, Future]]) -> None:
        fp.hit("compact.dispatch")  # a raise must fail the batch loudly,
        # release every waiter, and keep the leader loop draining
        self.dispatch_count += 1
        self.batch_sizes.append(len(batch))
        # Deduplicate by DB identity: the same db can legally ride one
        # batch twice (back-to-back ingests), one full compaction
        # satisfies every waiter — and a duplicate would deadlock the
        # batched plan stage on the db's compaction mutex.
        futures: Dict[int, List[Future]] = {}
        by_db: Dict[int, Tuple[str, object]] = {}
        for name, db, fut in batch:
            futures.setdefault(id(db), []).append(fut)
            by_db.setdefault(id(db), (name, db))
        remaining = list(by_db.values())

        def resolve(db, result=None, exc=None) -> None:
            for fut in futures[id(db)]:
                if fut.done():
                    continue
                if exc is not None:
                    fut.set_exception(exc)
                else:
                    fut.set_result(result)

        if self._use_gpu:
            from ..gpu.compaction_service import compact_dbs_batched

            unfinished: List[Tuple[str, object]] = []
            try:
                # host stages (plan/lane-read, SST write/install) fan out
                # over this pool; only the device launch is centralized
                handled, remaining = compact_dbs_batched(
                    remaining, pool=self._pool, device=self.device)
            except Exception as e:
                # a failed launch or file bloom raises with every plan
                # released, naming the DBs it declined and those it left
                # unfinished; the rest were compacted and installed
                remaining = list(getattr(e, "remaining", ()))
                unfinished = list(getattr(e, "unfinished", by_db.values()))
                if self.device.type == "cuda":
                    log.exception("compact_dbs_batched failed on %s",
                                  self.device)
                    for _name, db in unfinished:
                        resolve(db, exc=e)
                else:
                    log.exception(
                        "compact_dbs_batched failed; per-db fallback")
                    remaining += unfinished
            # everything not handed back for per-db fallback was compacted
            rem_ids = {id(db) for _n, db in remaining + unfinished}
            for _name, db in by_db.values():
                if id(db) not in rem_ids:
                    resolve(db, result=len(batch))
        # per-db fan-out: CPU backends, declined shards, single shards.
        # DBs running the adaptive compaction scheduler take its manual
        # queue (DB.schedule_compaction) so the post-ingest compaction
        # obeys the same PRIORITY order as background picks — an
        # L0-storm drain outranks it; schedule_compaction returns None
        # for engines without an adaptive compaction thread (inline
        # mode, scheduler off), which keep the direct compact_range.
        def one(name: str, db) -> None:
            try:
                fut = None
                submit = getattr(db, "schedule_compaction", None)
                if submit is not None:
                    fut = submit()
                if fut is not None:
                    fut.result()
                else:
                    db.compact_range()
                resolve(db, result=len(batch))
            except BaseException as e:
                resolve(db, exc=e)

        waits = [self._pool.submit(one, name, db) for name, db in remaining]
        for w in waits:
            w.result()

    def close(self) -> None:
        self._pool.shutdown(wait=False)
