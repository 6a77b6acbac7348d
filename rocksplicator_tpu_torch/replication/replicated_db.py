"""ReplicatedDB: the per-shard replication state machine.
(The port's copy of ``rocksplicator_tpu/replication/replicated_db.py``.)

Reference: rocksdb_replicator/replicated_db.cpp (613 LoC) — three faces:
- **leader write path** (``write``): stamp wall-clock ms into the batch,
  write via DbWrapper, wake parked long-polls, and in mode 1/2 wait for a
  follower ACK with fail-fast degradation (replicated_db.cpp:103-166,
  236-273);
- **server path** (``handle_replicate_request``): post ACKs from follower
  pulls, park on the notifier up to max_wait_ms, then serve ≤ max_updates
  batches from a cached WAL cursor (replicated_db.cpp:435-575);
- **follower path** (``pull loop``): long-poll the upstream, apply raw
  batches via DbWrapper, track lag from embedded timestamps, and on errors
  back off with randomized delay / reset upstream via the leader resolver
  (replicated_db.cpp:314-433, 278-312).

Replication modes (replicated_db.cpp:59-64): 0 async, 1 semi-sync (ACK
when the response carrying the write is sent to a follower), 2 sync (ACK
when a follower's next pull confirms the seq was applied).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Tuple

from ..observability.context import current_span, wire_context
from ..observability.span import detached_span, start_span
from ..rpc.client_pool import RpcClientPool
from ..rpc.errors import (RpcApplicationError, RpcConnectionError, RpcError,
                          RpcTransportConfigError)
from ..storage.records import WriteBatch, decode_batch, scan_batch_meta
from ..testing import failpoints as fp
from ..utils.misc import now_ms
from ..utils.retry_policy import RetryPolicy
from ..utils.stats import Stats, tagged
from .ack_window import AckWaiter, AckWindow, resolved_waiter
from .cond_var import AsyncNotifier
from .db_wrapper import DbWrapper
from .iter_cache import IterCache
from .wire import READ_METRICS as R
from .wire import REPLICATOR_METRICS as M
from .wire import ReplicaRole, ReplicateErrorCode

log = logging.getLogger(__name__)

LeaderResolver = Callable[[str], Optional[Tuple[str, int]]]


@dataclass
class ReplicationFlags:
    """Defaults mirror the reference gflags (replicated_db.cpp:36-90)."""

    max_updates_per_response: int = 50
    server_long_poll_ms: int = 10_000
    pull_error_delay_min_ms: int = 5_000
    pull_error_delay_max_ms: int = 10_000
    ack_timeout_ms: int = 2_000
    degraded_ack_timeout_ms: int = 10
    consecutive_timeouts_to_degrade: int = 100
    upstream_reset_sample_rate: float = 0.1
    # pulls from a non-leader that return nothing this many times in a row
    # trigger an upstream reset (replicated_db.cpp:392-408 heuristic)
    empty_pulls_before_reset: int = 5
    # consecutive CONNECTION errors to the same upstream force a resolver
    # query (no sampling): a steady follower whose leader died gets no
    # state transition — without escalation its repoint waits on the 10%
    # sample × 5-10s backoff (~75 s expected; observed blowing the soak
    # failover convergence window at 4000 shards)
    conn_errors_before_forced_reset: int = 3
    pull_rpc_margin_ms: int = 5_000
    # leader write pipelining: max in-flight (unacked) writes per shard.
    # write_async blocks only when the window is full — the back-pressure
    # that bounds the unacked backlog. 1 degenerates to the old
    # one-write-in-flight blocking behavior.
    write_window: int = 64
    # follower pull adaptivity: when the upstream reports a backlog, the
    # next pull asks for up to this many updates (instead of the fixed
    # max_updates_per_response) so one response acks a whole write
    # window; also the server-side clamp on any requested max_updates
    adaptive_max_updates_cap: int = 1024
    # bounded-staleness follower reads: how old the cached
    # upstream commit-point estimate may be before a bounded read must
    # refresh it with a seq probe (serving on a stale estimate is how a
    # partitioned follower silently blows the client's lag bound); and
    # the probe RPC's timeout — a probe that can't reach the upstream
    # means the bound is unverifiable and the read bounces. The client's
    # total staleness window is max_lag seqs + this TTL of time. The
    # default sits ABOVE server_long_poll_ms: an idle follower's
    # estimate refreshes on every long-poll expiry (~10 s), so the
    # sync (probe-free) ApplicationDB.read gate stays serveable on an
    # idle caught-up cluster; deployments wanting a tighter time window
    # lower BOTH knobs together (the bench and chaos flags do).
    read_info_ttl_ms: int = 12_000
    read_probe_timeout_ms: int = 1000
    # Fast-first-connect backoff tier: the 5-10s error floor
    # is right for a STEADY follower whose upstream died, but a fleet
    # cold start races pullers against their leaders' process spin-up —
    # with only the steady floor, a 100-shard node staggers its first
    # convergence across minutes. The first N attempts of a shard that
    # has NEVER completed a pull retry on a jittered fast tier instead;
    # once any pull succeeds (or N attempts burn), the steady floor
    # rules. Jitter rides the same RSTPU_PULL_RETRY_SEED rng.
    pull_fast_first_attempts: int = 5
    pull_fast_min_ms: int = 100
    pull_fast_max_ms: int = 500
    # Multiplexed per-peer pull sessions: one long-poll
    # carries every shard pulled from that peer. None = obey the
    # RSTPU_PULL_MUX env killswitch (default off); True/False override.
    pull_mux: Optional[bool] = None
    # server-side cap on the TOTAL updates one mux response may carry
    # across all sections (each section is additionally clamped by its
    # own requested max_updates and adaptive_max_updates_cap)
    mux_session_budget: int = 4096


class ReplicatedDB:
    def __init__(
        self,
        name: str,
        wrapper: DbWrapper,
        role: ReplicaRole,
        loop: asyncio.AbstractEventLoop,
        executor: ThreadPoolExecutor,
        pool: RpcClientPool,
        upstream_addr: Optional[Tuple[str, int]] = None,
        replication_mode: int = 0,
        flags: Optional[ReplicationFlags] = None,
        leader_resolver: Optional[LeaderResolver] = None,
        epoch: int = 0,
        stat_tags: Optional[dict] = None,
        mux=None,
    ):
        self.name = name
        self.wrapper = wrapper
        self.role = role
        self.replication_mode = replication_mode
        self.upstream_addr = upstream_addr
        # Fencing epoch (the controller-stamped assignment epoch; the
        # ZK-zxid-epoch analog). Every replicate request/response and
        # replicate_ack frame carries one; see _reject_stale_epoch for
        # the rules. 0 = unfenced legacy plumbing (epoch checks only
        # engage when a frame carries a strictly newer epoch).
        self.epoch = int(epoch or 0)
        self._epoch_lock = threading.Lock()
        self._fenced_by: Optional[int] = None
        self.flags = flags or ReplicationFlags()
        # Live shard move: monotonic deadline until which NEW
        # leader writes are refused (WRITE_PAUSED, retryable). The move
        # cutover arms this so WAL-tail catch-up has a bounded tail on a
        # hot shard; ALWAYS auto-expiring — a crashed move coordinator
        # can never wedge the shard. 0.0 = not paused.
        self._write_paused_until = 0.0
        self._loop = loop
        self._executor = executor
        self._pool = pool
        self._leader_resolver = leader_resolver
        self._notifier = AsyncNotifier(loop)
        self._acked = AckWindow(
            capacity=self.flags.write_window, on_resolve=self._on_ack_resolve
        )
        self._iter_cache = IterCache()
        self._removed = False
        self._pull_task: Optional[asyncio.Task] = None
        # ACK degradation state (replicated_db.cpp:236-273); resolutions
        # arrive from writer threads AND the loop's expiry timer, so the
        # counters live behind a lock now that writes pipeline
        self._ack_state_lock = threading.Lock()
        self._consecutive_ack_timeouts = 0
        self._degraded = False
        # ack-expiry timer: one loop timer per shard, armed for the
        # earliest pending waiter deadline (uniform timeouts ⇒ FIFO
        # deadlines ⇒ the common registration path skips the loop hop)
        self._expiry_lock = threading.Lock()
        self._expiry_deadline: Optional[float] = None
        self._expiry_handle: Optional[asyncio.TimerHandle] = None
        # follower pull pipeline state (loop thread only)
        self._apply_future = None
        self._apply_target: Optional[int] = None
        self._applied_through: Optional[int] = None
        self._cur_max_updates = self.flags.max_updates_per_response
        self._upstream_mode: Optional[int] = None  # learned from responses
        # commit-point estimate for bounded-staleness reads: the
        # upstream's latest_seq as carried on the most recent pull/probe
        # response, plus when we heard it. ONE tuple swapped atomically
        # (GIL attribute store): a torn (old seq, fresh mono) pair would
        # let the sync read gate serve past the bound — pairing an old
        # lower-bound estimate with a fresh age is a wrong SERVE, not a
        # spurious bounce.
        self._upstream_latest: Optional[Tuple[int, float]] = None
        # single-flight probe: concurrent bounded reads hitting a stale
        # estimate share ONE refresh RPC instead of stampeding the
        # upstream (loop thread only)
        self._probe_task: Optional[asyncio.Task] = None
        self._empty_pulls = 0
        self._conn_errors = 0
        # set when the upstream answered WAL_GAP: our position predates
        # its oldest surviving WAL record, so pulling can NEVER catch up
        # — the participant's periodic loop reads this (via check_db)
        # and forces a snapshot rebuild; cleared by any successful pull
        # (an upstream repoint may land on a deeper-WAL donor)
        self.pull_stalled_wal_gap = False
        # set when this follower is PERSISTENTLY ahead of a direct
        # LEADER upstream's own committed seq: it applied writes from a
        # deposed leader inside the r11 visibility window (before the
        # new epoch reached it), so its suffix is not in the lineage
        # and pulling can never reconcile it. The participant loop
        # clears + rejoins the replica (the follower analog of the
        # deposed-leader resync). Never reset by success — the flag
        # dies with the resync's reopen.
        self.pull_diverged = False
        self._ahead_pulls = 0
        # pull-error backoff: exp backoff + jitter via the unified
        # RetryPolicy (utils/retry_policy.py) — jittered within
        # [min, cap], cap growing from the reference's min delay toward
        # max across consecutive errors, reset on the first successful
        # pull. The min flag stays a HARD floor (the reference's
        # uniform(min, max) contract): an error loop must never hammer
        # the upstream/control plane at sub-floor intervals.
        # RSTPU_PULL_RETRY_SEED pins the jitter for reproducible chaos.
        f = self.flags
        self._pull_retry = RetryPolicy(
            max_attempts=1 << 30,
            base_delay=f.pull_error_delay_min_ms / 1000.0,
            max_delay=f.pull_error_delay_max_ms / 1000.0,
            floor=f.pull_error_delay_min_ms / 1000.0,
        )
        self._pull_retry_attempt = 0
        _seed = os.environ.get("RSTPU_PULL_RETRY_SEED")
        self._pull_rng = random.Random(int(_seed) if _seed else None)
        # first-connect detection for the fast backoff tier: flips true
        # on the first successful pull (solo loop or mux section)
        self._ever_pulled = False
        # mux pull session manager (replication/pull_mux.py) — when set
        # and the killswitch allows, start() registers with it instead
        # of spawning the per-shard _pull_loop
        self._mux = mux
        # serves currently PARKED in this shard's long-poll (loop thread
        # only) — the per-shard half of the parked-longpolls gauge the
        # fleet A/B reads; the mux session park has its own counter
        self._parked_serves = 0
        self._stats = Stats.get()
        # per-shard load counters: the spectator's hot-spot
        # ranking input. Names precomputed — tagged() is a string join
        # and these sit on the write/read hot paths. stat_tags carries
        # the replicator's port so the series stays per-REPLICA even in
        # in-process multi-replicator topologies sharing one Stats
        # registry (the aggregator dedupes scraped series by full name).
        _tags = stat_tags or {}
        self._m_shard_writes = tagged("replicator.shard_writes", db=name,
                                      **_tags)
        self._m_shard_reads = tagged("replicator.shard_reads", db=name,
                                     **_tags)
        # serves handled since start: benches/ops gate their write phase
        # on every shard having a live puller (a shard whose pullers are
        # all in connect backoff times out its whole first write window)
        self.serve_count = 0
        # seq -> wire trace context of a SAMPLED write at that seq: lets the
        # serve path attach the originating write's trace to the updates it
        # ships, so a follower's apply span joins the LEADER's write trace
        # (and re-records here for chained downstreams) — one stitched
        # trace across the whole replication chain. Bounded; empty when
        # tracing is off, so the hot serve/apply paths pay one falsy check.
        self._write_traces: dict = {}
        self._write_traces_lock = threading.Lock()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        if self.role in (ReplicaRole.FOLLOWER, ReplicaRole.OBSERVER):
            if self.upstream_addr is None:
                raise ValueError(f"{self.name}: {self.role} requires an upstream")
            if self._mux is not None:
                # multiplexed pulls: one session per upstream PEER, not
                # per shard — the manager routes this shard into (or
                # spawns) its peer's session; shards whose peer predates
                # replicate_mux come back through start_solo_pull()
                self._mux.register(self)
            else:
                self.start_solo_pull()

    def start_solo_pull(self) -> None:
        """Spawn the classic per-shard pull loop (the non-mux path, and
        the mux manager's automatic fallback for legacy peers)."""
        if self._removed or self._pull_task is not None:
            return
        self._pull_task = asyncio.run_coroutine_threadsafe(
            self._pull_loop(), self._loop
        )

    def stop(self) -> None:
        self._removed = True
        if self._mux is not None:
            self._mux.deregister(self)
        task = self._pull_task
        if task is not None:
            self._loop.call_soon_threadsafe(task.cancel)
            self._pull_task = None
        self._acked.close()  # no writer may hang on an in-flight ack
        with self._expiry_lock:
            handle, self._expiry_handle = self._expiry_handle, None
            self._expiry_deadline = None
        if handle is not None:
            self._loop.call_soon_threadsafe(handle.cancel)
        self._notifier.notify_all_threadsafe()
        self._iter_cache.clear()

    @property
    def removed(self) -> bool:
        return self._removed

    # ------------------------------------------------------------------
    # fencing (monotonic epoch, end to end)
    # ------------------------------------------------------------------

    @property
    def fenced(self) -> bool:
        return self._fenced_by is not None

    def adopt_epoch(self, epoch: int) -> None:
        """Raise this db's epoch (never lowers). Used by followers
        adopting a newer epoch from upstream responses and by the admin
        set_db_epoch path (a sticky leader whose assignment epoch moved
        without a role transition).

        RE-ANOINTMENT: adopting an epoch STRICTLY ABOVE the one that
        fenced us clears the fence — the controller mints a fresh epoch
        exactly when it issues leadership, so an assignment carrying
        one means this node is the legitimate leader again under it
        (and any peer still at the fencing epoch is now the stale one).
        Without this, a fenced-then-sticky-re-elected leader satisfied
        the control plane while its data plane refused every write and
        serve forever (found wedged by the reshard chaos: lineages=[])."""
        epoch = int(epoch)
        unfenced = False
        with self._epoch_lock:
            if epoch > self.epoch:
                self.epoch = epoch
            if (self._fenced_by is not None
                    and self.epoch > self._fenced_by):
                self._fenced_by = None
                unfenced = True
        if unfenced:
            log.warning(
                "%s: UNFENCED — re-anointed at epoch %d (above the "
                "deposing epoch); serving resumes", self.name, self.epoch)

    def _reject_stale_epoch(self, remote_epoch) -> bool:
        """Process the epoch carried on an inbound replicate/ack frame.

        Followers/observers ADOPT a newer epoch (assignments flow
        controller → participant, but a chained or raced promotion can
        reach the data plane first) and never reject. A LEADER (or NOOP)
        seeing a newer epoch has been deposed — a new leader was
        promoted under that epoch — so it fences itself: every pending
        ack waiter resolves un-acked, and this and every future
        replicate/ack/write is refused. Returns True when the caller
        must raise STALE_EPOCH and post no acks.

        This method is the no-split-brain guard the chaos harness's
        ``--break-guard fencing`` tooth disables to prove the harness
        catches a leader that ignores epochs."""
        if remote_epoch is not None:
            remote = int(remote_epoch)
            if remote > self.epoch:
                if self.role in (ReplicaRole.FOLLOWER, ReplicaRole.OBSERVER):
                    self.adopt_epoch(remote)
                    return False
                self._fence(remote)
        return self._fenced_by is not None

    def _fence(self, remote_epoch: int) -> None:
        with self._epoch_lock:
            first = self._fenced_by is None
            self._fenced_by = max(self._fenced_by or 0, int(remote_epoch))
        if first:
            self._stats.incr(M["fenced"])
            log.warning(
                "%s: FENCED — epoch %d deposed by %d; failing %d pending "
                "acks, refusing further writes", self.name, self.epoch,
                self._fenced_by, self._acked.depth)
            # every in-flight waiter resolves un-acked NOW: a deposed
            # leader must not sit out ack timeouts pretending its window
            # might still land
            self._acked.close()

    def _check_fenced(self) -> None:
        fenced_by = self._fenced_by
        if fenced_by is not None:
            raise RpcApplicationError(
                ReplicateErrorCode.STALE_EPOCH.value,
                f"{self.name}: leader epoch {self.epoch} deposed by "
                f"epoch {fenced_by}",
            )

    # ------------------------------------------------------------------
    # cutover write pause (live shard moves)
    # ------------------------------------------------------------------

    @property
    def write_paused(self) -> bool:
        return time.monotonic() < self._write_paused_until

    def pause_writes(self, duration_ms: float) -> None:
        """Refuse NEW leader writes for ``duration_ms`` — the shard-move
        cutover's tail bound: with the ingress paused, WAL-tail catch-up
        converges to exact seq equality instead of chasing a hot shard
        forever. Auto-expires (never latched), so a mover that dies
        mid-cutover leaves the shard serving again within the window;
        ``duration_ms <= 0`` resumes immediately. In-flight writes and
        their acks are untouched — the pause only gates NEW admissions,
        so it can never turn an acked write into a lost one."""
        if duration_ms <= 0:
            self._write_paused_until = 0.0
            log.info("%s: write pause cleared", self.name)
            return
        self._write_paused_until = time.monotonic() + duration_ms / 1000.0
        log.info("%s: writes paused for %.0f ms (move cutover)",
                 self.name, duration_ms)

    def _check_write_paused(self) -> None:
        if time.monotonic() < self._write_paused_until:
            self._stats.incr(M["write_paused"])
            raise RpcApplicationError(
                ReplicateErrorCode.WRITE_PAUSED.value,
                f"{self.name}: writes paused for move cutover "
                f"({max(0.0, self._write_paused_until - time.monotonic()) * 1e3:.0f} ms left)",
            )

    # ------------------------------------------------------------------
    # leader write path (any thread)
    # ------------------------------------------------------------------

    def write(self, batch: WriteBatch) -> int:
        """Blocking write: pipeline entry + wait for the ack future.
        Exactly the old semantics (returns the seq whether the ack landed
        or timed out; timeouts feed the degradation state machine) but
        expressed over write_async, so sync and async writers share one
        code path."""
        start = time.monotonic()
        waiter = self.write_async(batch)
        try:
            # Belt and braces on the old MaxNumberBox.wait(num, timeout)
            # contract: the future normally resolves via ack or the
            # loop's expiry timer, but a wedged/stopped loop must not
            # turn a 2000ms ack timeout into an unbounded hang. The
            # margin covers timer latency; on expiry the degradation
            # accounting still runs whenever the window resolves.
            waiter.result(max(0.0, waiter.deadline - time.monotonic()) + 2.0)
        except FuturesTimeoutError:
            log.warning("%s: ack expiry timer overdue; returning after "
                        "local wait deadline", self.name)
        self._stats.add_metric(M["leader_write_ms"], (time.monotonic() - start) * 1e3)
        return waiter.seq

    def write_async(self, batch: WriteBatch) -> AckWaiter:
        """Pipelined write: stamp + WAL-write immediately (fsync is
        group-committed by the engine), register an ack waiter in the
        AckWindow, and return without blocking on the follower
        round-trip. The returned waiter's ``future`` resolves to the
        batch's start seq when the ack arrives or its timeout expires;
        ``.acked`` records which. Blocks only when the shard's write
        window (flags.write_window) is full — the flow control that
        bounds the unacked backlog. Must not be called from the IO loop
        thread (it may block on flow control; the loop drives acks).
        """
        if self.role not in (ReplicaRole.LEADER, ReplicaRole.NOOP):
            raise RpcApplicationError(
                "NOT_LEADER", f"{self.name} role is {self.role.value}"
            )
        self._check_fenced()
        self._check_write_paused()
        # The per-write trace: root span with wal_write through fsync;
        # the ack_wait phase becomes a DEFERRED child span finished at
        # ack resolution, so sampled traces show the real (overlapping)
        # in-flight windows. Head sampled — with sampling off this costs
        # one contextvar set/reset.
        with start_span("repl.write", db=self.name) as sp:
            batch.stamp_timestamp_ms()
            with start_span("repl.wal_write"):
                seq = self.wrapper.write_to_leader(batch)
            end_seq = seq + batch.count() - 1
            if sp.sampled:
                sp.annotate(seq=seq, bytes=batch.byte_size())
                self._remember_write_trace(seq, sp)
            self._stats.incr(M["leader_writes"])
            self._stats.incr(M["leader_write_bytes"], batch.byte_size())
            self._stats.incr(self._m_shard_writes)
            # Wake parked follower long-polls (no thread was held by them).
            self._notifier.notify_all_threadsafe()
            if (self.replication_mode in (1, 2)
                    and self.role is ReplicaRole.LEADER):
                return self._register_ack_wait(end_seq, seq, sp)
        return resolved_waiter(seq)

    def write_async_many(self, batches: List[WriteBatch]) -> List[AckWaiter]:
        """Pipelined GROUP write: commit every batch with one storage
        lock pass and ONE WAL flush (engine ``write_many``), one
        follower wakeup, and one stats update — then register one ack
        waiter per batch. The per-write flush syscall + notify + stats
        were the dominant leader-side issue cost once writes pipelined;
        a writer topping up a shard's window issues its writes
        back-to-back, which is exactly the shape this amortizes. Same
        per-batch ack/timeout/degradation semantics as N
        ``write_async`` calls; may block on window flow control."""
        if not batches:
            return []
        if self.role not in (ReplicaRole.LEADER, ReplicaRole.NOOP):
            raise RpcApplicationError(
                "NOT_LEADER", f"{self.name} role is {self.role.value}"
            )
        self._check_fenced()
        self._check_write_paused()
        with start_span("repl.write_group", db=self.name,
                        n=len(batches)) as sp:
            total_bytes = 0
            for b in batches:
                b.stamp_timestamp_ms()
                total_bytes += b.byte_size()
            with start_span("repl.wal_write"):
                first_seq = self.wrapper.write_to_leader_many(batches)
            if sp.sampled:
                sp.annotate(seq=first_seq, bytes=total_bytes)
                self._remember_write_trace(first_seq, sp)
            self._stats.incr(M["leader_writes"], len(batches))
            self._stats.incr(M["leader_write_bytes"], total_bytes)
            self._stats.incr(self._m_shard_writes, len(batches))
            self._notifier.notify_all_threadsafe()
            acking = (self.replication_mode in (1, 2)
                      and self.role is ReplicaRole.LEADER)
            waiters: List[AckWaiter] = []
            seq = first_seq
            for b in batches:
                end_seq = seq + b.count() - 1
                if acking:
                    waiters.append(self._register_ack_wait(end_seq, seq, sp))
                else:
                    waiters.append(resolved_waiter(seq))
                seq = end_seq + 1
        return waiters

    @property
    def ack_window_depth(self) -> int:
        """Current in-flight (unacked) writes in this shard's window."""
        return self._acked.depth

    def applied_seq_lag(self) -> float:
        """Gauge value: how many committed sequence numbers this replica
        is behind the leader's last-heard commit point (0 on the leader
        by definition; 0 when no estimate has been heard yet — a fresh
        follower reports lag only once it has an upstream attestation,
        matching the bounded-read gate's 'unverifiable ≠ infinitely
        stale' stance)."""
        applied, est, _age = self._read_lag_state()
        if est is None:
            return 0.0
        return float(max(0, est - applied))

    @property
    def ack_window_free(self) -> int:
        """Free slots in the write window: how many write_async calls are
        guaranteed not to block on flow control right now. Writers
        pumping MANY shards use this to top up every shard's window
        round-robin instead of head-of-line blocking on one full
        window."""
        return max(0, self._acked.capacity - self._acked.depth)

    def _register_ack_wait(self, target_seq: int, seq: int,
                           write_span) -> AckWaiter:
        """Park an ack waiter (replicated_db.cpp:236-273 timeouts: 2000ms
        normally; 10ms once degraded — fail fast)."""
        f = self.flags
        timeout_ms = (
            f.degraded_ack_timeout_ms if self._degraded else f.ack_timeout_ms
        )
        self._stats.incr(M["ack_waits"])
        # detached: the waiter resolves on another thread (loop expiry /
        # follower ack); AckWindow's resolution funnel finishes+records
        ack_span = detached_span(
            "repl.ack_wait", write_span,
            target_seq=target_seq, timeout_ms=timeout_ms,
            window_depth=self._acked.depth + 1)
        waiter = self._acked.register(
            target_seq, seq, timeout_ms / 1000.0, span=ack_span
        )
        if not waiter.done:
            self._request_expiry(waiter.deadline)
        return waiter

    def _on_ack_resolve(self, waiter: AckWaiter, acked: bool) -> None:
        """AckWindow resolution callback (writer thread, loop expiry
        timer, or server ack path): stats + the 100-consecutive-timeouts
        degradation state machine + the deferred ack_wait span."""
        if acked:
            with self._ack_state_lock:
                self._consecutive_ack_timeouts = 0
                if self._degraded:
                    self._degraded = False
                    log.info("%s: ACK degradation recovered", self.name)
        elif not self._removed and self._fenced_by is None:
            # fence-failed waiters are not timeouts: the leader is
            # deposed, not degraded — keep the degradation machine clean
            f = self.flags
            self._stats.incr(M["ack_timeouts"])
            with self._ack_state_lock:
                self._consecutive_ack_timeouts += 1
                if (
                    not self._degraded
                    and self._consecutive_ack_timeouts
                    >= f.consecutive_timeouts_to_degrade
                ):
                    self._degraded = True
                    self._stats.incr(M["ack_degraded"])
                    log.warning("%s: entering degraded ACK mode", self.name)
        span = waiter.span
        if span is not None:
            waiter.span = None
            span.annotate(acked=acked, degraded=self._degraded,
                          window_depth_at_resolve=self._acked.depth)
            span.finish()
            from ..observability.collector import SpanCollector

            SpanCollector.get().record(span)

    # -- ack-expiry timer (per-future timeouts without a blocked thread) --

    def _request_expiry(self, deadline: float) -> None:
        """Ensure the loop's expiry timer fires by ``deadline``. With
        uniform timeouts deadlines are FIFO, so the common case is a
        lock-check and no loop hop."""
        with self._expiry_lock:
            cur = self._expiry_deadline
            if cur is not None and cur <= deadline:
                return
            self._expiry_deadline = deadline
        self._loop.call_soon_threadsafe(self._arm_expiry, deadline)

    def _arm_expiry(self, deadline: float) -> None:
        """Loop thread: (re)schedule the timer for an earlier deadline."""
        if self._removed:
            return
        delay = max(0.0, deadline - time.monotonic())
        when = self._loop.time() + delay
        with self._expiry_lock:
            handle = self._expiry_handle
            if (handle is not None and not handle.cancelled()
                    and self._loop.time() < handle.when() <= when + 1e-4):
                return  # an earlier-or-equal fire is already armed
            if handle is not None:
                handle.cancel()
            self._expiry_handle = self._loop.call_later(
                delay, self._fire_expiry)

    def _fire_expiry(self) -> None:
        """Loop thread: resolve overdue waiters, re-arm for the next."""
        with self._expiry_lock:
            self._expiry_handle = None
            self._expiry_deadline = None
        if self._removed:
            return
        try:
            # delay = a LATE timer (rescheduled, not a blocked loop);
            # fail = a LOST one — the next register re-arms, and write()
            # carries a belt-and-braces local deadline either way
            late = fp.pending_delay("ack.expire")
        except OSError:
            return
        if late > 0.0:
            self._loop.call_later(late, self._fire_expiry)
            return
        next_deadline = self._acked.expire_due()
        if next_deadline is not None:
            self._request_expiry(next_deadline)

    _WRITE_TRACE_CAP = 512

    def _remember_write_trace(self, seq: int, span) -> None:
        """Record a sampled write's (or applied update's) trace context by
        its start seq so downstream serving can propagate it in-band."""
        ctx = span.to_wire()
        with self._write_traces_lock:
            self._write_traces[seq] = ctx
            while len(self._write_traces) > self._WRITE_TRACE_CAP:
                self._write_traces.pop(next(iter(self._write_traces)))

    # ------------------------------------------------------------------
    # server path (loop thread)
    # ------------------------------------------------------------------

    async def handle_replicate_request(
        self,
        seq_no: int,
        max_wait_ms: Optional[int] = None,
        max_updates: Optional[int] = None,
        role: str = ReplicaRole.FOLLOWER.value,
        applied_seq: Optional[int] = None,
        epoch: Optional[int] = None,
    ) -> dict:
        """Serve updates after ``seq_no`` (the puller's WAL cursor).
        Returns {updates, latest_seq, source_role}; updates is empty on a
        long-poll timeout. source_role lets pullers detect they're polling
        a non-leader (upstream-reset heuristic, replicated_db.cpp:385-399).

        ``applied_seq`` is the puller's durably-APPLIED position, which a
        pipelined puller reports separately: its cursor runs ahead of its
        apply executor (the next pull is issued while the previous
        response is still applying), so acking off ``seq_no`` would
        over-claim in mode 2. Absent (legacy pullers), the cursor IS the
        applied position.

        ``epoch`` is the puller's fencing epoch. A pull carrying a newer
        epoch than ours proves a newer leader was promoted: we are
        deposed — reject the frame (STALE_EPOCH), post NO acks, fail the
        pending ack window, refuse further writes. This is what stops a
        demoted-but-still-running leader from acking a write after the
        new leader's epoch is visible to its followers."""
        if self._reject_stale_epoch(epoch):
            self._stats.incr(M["stale_epoch_rejects"])
            raise RpcApplicationError(
                ReplicateErrorCode.STALE_EPOCH.value,
                f"{self.name}: serving epoch {self.epoch} < puller epoch "
                f"{epoch}" if epoch is not None else
                f"{self.name}: fenced by epoch {self._fenced_by}",
            )
        f = self.flags
        max_wait_ms = f.server_long_poll_ms if max_wait_ms is None else max_wait_ms
        max_updates = (
            f.max_updates_per_response if max_updates is None else max_updates
        )
        # bound what one response can pin in memory regardless of what
        # the (possibly adaptive, possibly buggy) puller asked for
        max_updates = min(max_updates, f.adaptive_max_updates_cap)
        self.serve_count += 1
        self._stats.incr(M["replicate_requests"])
        # Child of the puller's rpc.server span when the pull was sampled:
        # per-phase serve breakdown (seq read vs long-poll park vs WAL
        # read) — where a 10 s long-poll hides inside one "slow RPC".
        with start_span("repl.serve", db=self.name, from_role=role) as sp:
            # Mode-2 ACK: the puller's request proves it applied through
            # applied_seq (replicated_db.cpp:450-456); OBSERVERs never
            # count.
            if role != ReplicaRole.OBSERVER.value and self.replication_mode == 2:
                self._acked.post(
                    seq_no if applied_seq is None else applied_seq)
            # RELAXED seq reads: the locking read would park behind flush/
            # compaction holding the storage lock (the old code paid an
            # executor hop per read to avoid blocking the loop on it — two
            # hops per serve, pure scheduling latency on the hot path). A
            # stale value is safe: the reserve-then-recheck protocol below
            # guarantees any write bumping the seq after reserve() also
            # notifies the reserved slot, so a stale "nothing new" can
            # only park until that notify, never for the full long-poll.
            latest = self.wrapper.latest_sequence_number_relaxed()
            if latest <= seq_no and max_wait_ms > 0:
                slot = self._notifier.reserve()
                latest = self.wrapper.latest_sequence_number_relaxed()
                if latest <= seq_no:
                    # this serve is about to PARK by design — the
                    # enclosing rpc.server root must not be tail-kept
                    # as a slow outlier (it would fill the tail ring
                    # with idle long-polls)
                    root = current_span()
                    if root is not None:
                        root.annotate(tail_exempt="longpoll_serve")
                    self._stats.incr(M["longpoll_parks"])
                    self._parked_serves += 1
                    try:
                        with start_span("repl.longpoll_wait",
                                        max_wait_ms=max_wait_ms):
                            await self._notifier.wait_reserved(
                                slot, max_wait_ms / 1000.0)
                    finally:
                        self._parked_serves -= 1
                    if self._removed:
                        raise RpcApplicationError(
                            ReplicateErrorCode.SOURCE_REMOVED.value, self.name
                        )
                    latest = self.wrapper.latest_sequence_number_relaxed()
                else:
                    self._notifier.cancel_reserved(slot)
            if latest <= seq_no:
                return {"updates": [], "latest_seq": latest,
                        "source_role": self.role.value,
                        "replication_mode": self.replication_mode,
                        "epoch": self.epoch,
                        **self._commit_point_fields()}
            try:
                with start_span("repl.wal_read") as sp_read:
                    # Cached-cursor fast path: serve INLINE on the loop.
                    # A parked tail cursor reads freshly-appended (page-
                    # cache-resident) bytes in microseconds; the executor
                    # round-trip (self-pipe wakeup + future + two context
                    # switches) costs more than the read itself and was a
                    # measurable share of serve latency under pipelined
                    # load. The cursor is TAKEN here (not peeked) so a
                    # concurrent serve or idle eviction can never leave
                    # the inline path opening a fresh cursor — a cold
                    # segment scan must never run on the loop; no-cursor
                    # serves go to the executor, which may touch disk.
                    it = self._iter_cache.take(seq_no + 1)
                    if it is not None:
                        updates = self._read_updates(
                            seq_no + 1, max_updates, it=it)
                    else:
                        updates = await self._loop.run_in_executor(
                            self._executor, self._read_updates, seq_no + 1,
                            max_updates
                        )
                    sp_read.annotate(updates=len(updates))
            except RpcApplicationError:
                # already typed for the puller — WAL_GAP above all: the
                # SOURCE_READ_ERROR wrapper below would mask the code
                # the puller's stall detection keys on, leaving a
                # behind-the-purge-horizon follower retrying seq 1
                # forever instead of flagging the snapshot rebuild
                # (found by the rebalance chaos harness: a fresh
                # split-child follower wedged exactly this way)
                raise
            except Exception as e:
                log.exception("%s: WAL read failed", self.name)
                raise RpcApplicationError(
                    ReplicateErrorCode.SOURCE_READ_ERROR.value, repr(e)
                ) from e
            # In-band trace propagation: updates whose originating write
            # (or upstream apply) was sampled carry that trace context, so
            # the puller's apply joins the write's trace across processes.
            if self._write_traces:
                with self._write_traces_lock:
                    for u in updates:
                        ctx = self._write_traces.get(u["seq_no"])
                        if ctx is not None:
                            u["trace"] = ctx
            # Mode-1 semi-sync ACK: posted when the response is handed to
            # the transport (replicated_db.cpp:543-546).
            if (
                updates
                and self.replication_mode == 1
                and role != ReplicaRole.OBSERVER.value
            ):
                last = updates[-1]
                self._acked.post(last["seq_no"] + last["count"] - 1)
            self._stats.incr(M["replicate_updates_sent"], len(updates))
            self._stats.incr(
                M["replicate_bytes_sent"],
                sum(len(u["raw_data"]) for u in updates),
            )
            sp.annotate(latest_seq=latest)
            return {"updates": updates, "latest_seq": latest,
                    "source_role": self.role.value,
                    "replication_mode": self.replication_mode,
                    "epoch": self.epoch,
                    **self._commit_point_fields()}

    def _read_updates(self, from_seq: int, max_updates: int,
                      it=None) -> List[dict]:
        """WAL read using the cursor cache (executor-side, unless the
        caller already took a cached cursor and passes it for an inline
        loop-side read).

        Raises on a WAL gap (requested updates already purged) — the analog
        of rocksdb GetUpdatesSince returning NotFound, which tells the
        puller it must rebuild from a snapshot rather than silently skip."""
        if it is None:
            it = self._iter_cache.take(from_seq)
        if it is None:
            it = self.wrapper.get_updates_from_leader(from_seq)
        updates: List[dict] = []
        next_seq = from_seq
        exhausted = True
        first = True
        # batch read when the cursor supports it (WalTailCursor): one
        # call parses the whole response's records out of the read-ahead
        # buffer instead of paying iterator overhead per record
        read_many = getattr(it, "read_many", None)
        if read_many is not None:
            records = read_many(max_updates)
            exhausted = len(records) < max_updates
        else:
            records = it
        for start_seq, raw in records:
            if first:
                first = False
                if start_seq > from_seq:
                    raise RpcApplicationError(
                        ReplicateErrorCode.WAL_GAP.value,
                        f"WAL gap: requested seq {from_seq}, oldest "
                        f"available {start_seq} (purged — puller must "
                        f"rebuild)",
                    )
            # header skim, not decode_batch + extract_timestamp_ms: the
            # serve path needs only (count, stamp) per shipped update
            count, ts = scan_batch_meta(raw)
            updates.append(
                {
                    "seq_no": start_seq,
                    "count": count,
                    "raw_data": bytes(raw),
                    "timestamp": ts,
                }
            )
            next_seq = start_seq + count
            if read_many is None and len(updates) >= max_updates:
                exhausted = False
                break
        # Resumable cursors (WalTailCursor) stay valid at the live tail,
        # so cache them even when this response drained the WAL — the
        # steady pipelined state — instead of re-scanning the active
        # segment on every pull. One-shot iterators keep the old rule.
        if not exhausted or getattr(it, "resumable", False):
            self._iter_cache.put(next_seq, it)
        return updates

    # ------------------------------------------------------------------
    # serving reads (bounded-staleness follower reads)
    # ------------------------------------------------------------------

    _READ_OPS = ("get", "multi_get", "scan")
    # a cursor pinned past any real sequence: the upstream answers the
    # probe inline from a relaxed seq read (max_wait_ms=0 skips the
    # long-poll park, nothing to serve skips the WAL read)
    _SEQ_PROBE_CURSOR = 1 << 60

    def _note_upstream_latest(self, seq: int, age_ms: float = 0.0) -> None:
        """Record a LEADER-ORIGIN commit-point attestation: "the leader
        had committed ≥ seq as of (now − age_ms)". ``age_ms`` is the
        attestation's age already accumulated upstream (a chained
        follower forwards its own estimate plus ITS age, so staleness
        COMPOUNDS down the chain instead of resetting per hop).
        Because leader commit is monotonic, "leader ≥ S as of t" stays
        true for every t' > t — so max-merging seq and timestamp
        independently is sound. The (seq, heard_at) pair is swapped as
        ONE tuple so concurrent sync-gate readers can never observe an
        old estimate wearing a fresh timestamp."""
        heard_at = time.monotonic() - max(0.0, age_ms) / 1000.0
        cur = self._upstream_latest
        if cur is not None:
            seq = max(seq, cur[0])
            heard_at = max(heard_at, cur[1])
        self._upstream_latest = (seq, heard_at)

    def _commit_point_fields(self) -> dict:
        """What THIS node can honestly attest about the leader's commit
        point, for downstream pullers' bounded reads: a LEADER attests
        its own committed seq (age 0); a chained FOLLOWER forwards its
        upstream estimate WITH its accumulated age (never its own
        applied seq — that would let a downstream caught up to a lagging
        middle hop serve reads violating the leader-relative bound).
        ``leader_seq`` is explicitly None when a follower has no
        estimate yet, so new downstreams never fall back to the legacy
        latest_seq (= this hop's applied position)."""
        applied, est, age = self._read_lag_state()
        return {
            "leader_seq": None if est is None else int(est),
            "leader_seq_age_ms": 0.0 if not age else round(age * 1e3, 1),
        }

    def _adopt_commit_point(self, result) -> None:
        """Shared pull/probe response handling for the commit-point
        estimate. New upstreams attest a leader-origin (seq, age) pair;
        legacy responses (no ``leader_seq`` key) fall back to
        latest_seq — correct for a direct-from-leader pull, the only
        shape legacy servers produced bounded reads for."""
        if not result:
            return
        if "leader_seq" in result:
            if result["leader_seq"] is not None:
                self._note_upstream_latest(
                    int(result["leader_seq"]),
                    float(result.get("leader_seq_age_ms") or 0.0))
        elif result.get("latest_seq") is not None:
            self._note_upstream_latest(int(result["latest_seq"]))

    def _read_lag_state(self) -> Tuple[int, Optional[int], Optional[float]]:
        """(applied, leader_est, age_sec): this replica's durably-visible
        engine position (relaxed read — same contract as the serve
        path), the last commit point heard from upstream, and how long
        ago it was heard. Leaders ARE the commit point (lag 0 by
        definition)."""
        applied = self.wrapper.latest_sequence_number_relaxed()
        if self.role in (ReplicaRole.LEADER, ReplicaRole.NOOP):
            return applied, applied, 0.0
        cur = self._upstream_latest
        if cur is None:
            return applied, None, None
        est, heard_at = cur
        return applied, est, time.monotonic() - heard_at

    def _read_epoch_gate(self, epoch) -> None:
        """Lineage check for reads — the read-path analog of
        ``_reject_stale_epoch``, with one asymmetry: a FOLLOWER must
        never ADOPT an epoch from a read request. A client's epoch claim
        is not authoritative (assignments flow controller→participant
        and pull responses come from the upstream we replicate from); a
        bogus inflated epoch here would make the real leader's frames
        look stale and wedge a healthy replica. It still REJECTS: a read
        carrying a newer epoch proves a newer leader was promoted, and
        this replica's applied prefix may end in the deposed lineage's
        divergent un-acked suffix — exactly the stale-epoch-pull rule."""
        if epoch is not None and int(epoch) > self.epoch:
            if self.role in (ReplicaRole.FOLLOWER, ReplicaRole.OBSERVER):
                self._stats.incr(R["stale_epoch_rejected"])
                raise RpcApplicationError(
                    ReplicateErrorCode.STALE_EPOCH.value,
                    f"{self.name}: replica epoch {self.epoch} < read "
                    f"epoch {epoch} — possibly deposed lineage",
                )
            # leader/NOOP: a newer epoch deposes it, same as pulls/acks
            self._reject_stale_epoch(epoch)
        if self._fenced_by is not None:
            self._stats.incr(R["stale_epoch_rejected"])
        self._check_fenced()

    def read_gate(self, max_lag: Optional[int] = None,
                  epoch=None) -> dict:
        """Admission control for serving a read from THIS replica:
        lineage (fencing epoch) first, then the client's staleness
        bound. Raises STALE_EPOCH (deposed lineage — reject exactly as a
        stale-epoch pull is rejected) or STALE_READ (lag bound exceeded,
        or unverifiable because the commit-point estimate is older than
        ``read_info_ttl_ms``); returns the lag bookkeeping the response
        reports. Sync and probe-free so in-process callers
        (ApplicationDB.read) can gate without an event-loop hop; the
        async RPC handler refreshes a stale estimate with an upstream
        seq probe before gating.

        Boundary contract (tested): lag == max_lag SERVES,
        lag == max_lag + 1 bounces."""
        self._read_epoch_gate(epoch)
        applied, est, age = self._read_lag_state()
        lag = max(0, est - applied) if est is not None else None
        if (max_lag is not None
                and self.role not in (ReplicaRole.LEADER, ReplicaRole.NOOP)):
            ttl = self.flags.read_info_ttl_ms / 1000.0
            if est is None or age is None or age > ttl:
                self._stats.incr(R["stale_rejected"])
                raise RpcApplicationError(
                    ReplicateErrorCode.STALE_READ.value,
                    f"{self.name}: lag bound {max_lag} unverifiable "
                    f"(commit-point estimate "
                    f"{'missing' if est is None else f'{age * 1e3:.0f}ms old'})",
                )
            if lag > int(max_lag):
                self._stats.incr(R["stale_rejected"])
                raise RpcApplicationError(
                    ReplicateErrorCode.STALE_READ.value,
                    f"{self.name}: lag {lag} exceeds bound {max_lag} "
                    f"(applied {applied}, leader {est})",
                )
        return {"applied_seq": applied, "leader_seq": est, "lag": lag}

    async def _probe_upstream_seq(self) -> None:
        """Refresh the commit-point estimate (single-flight: concurrent
        stale reads share one probe)."""
        task = self._probe_task
        if task is None or task.done():
            task = self._probe_task = asyncio.ensure_future(
                self._probe_upstream_seq_once())
        await task

    async def _probe_upstream_seq_once(self) -> None:
        """Refresh the commit-point estimate with one lightweight
        replicate RPC. Failure leaves the estimate stale and the gate
        bounces the read: a partitioned follower must not serve bounded
        reads on memories. Probes ride role=OBSERVER so a mode-1/2
        upstream never counts them toward acks."""
        if self.upstream_addr is None:
            return
        self._stats.incr(R["probes"])
        host, port = self.upstream_addr
        try:
            client = await self._pool.get_client(host, port)
            result = await client.call(
                "replicate",
                {
                    "db_name": self.name,
                    "seq_no": self._SEQ_PROBE_CURSOR,
                    "max_wait_ms": 0,
                    "max_updates": 1,
                    "role": ReplicaRole.OBSERVER.value,
                    "epoch": self.epoch,
                },
                timeout=self.flags.read_probe_timeout_ms / 1000.0,
            )
        except Exception as e:
            log.debug("%s: upstream seq probe failed: %r", self.name, e)
            return
        resp_epoch = result.get("epoch") if result else None
        if resp_epoch is not None and int(resp_epoch) > self.epoch:
            self.adopt_epoch(int(resp_epoch))
        if resp_epoch is not None and int(resp_epoch) < self.epoch:
            # deposed-lineage attestation: the pull path raises
            # STALE_EPOCH before adopting anything from an older-epoch
            # upstream — the probe must be exactly as deaf, or a fresh
            # wrong-lineage estimate lets bounded reads serve past the
            # REAL leader's commit point (a wrong serve, not a bounce)
            log.debug("%s: ignoring seq probe from deposed upstream "
                      "epoch %s < ours %d", self.name, resp_epoch,
                      self.epoch)
            return
        self._adopt_commit_point(result)

    async def handle_read_request(
        self,
        op: str = "get",
        keys=None,
        start=None,
        count: Optional[int] = None,
        max_lag: Optional[int] = None,
        epoch=None,
    ) -> dict:
        """Serve a get/multi_get/scan from THIS replica under the
        client's staleness bound (``max_lag``, in sequence numbers;
        None = unbounded — any live replica serves) and fencing epoch.
        The read-scaling half of follower reads: any FOLLOWER within the bound
        serves, so read throughput scales with replica count instead of
        saturating the leader."""
        await fp.async_hit("repl.read")
        if self._removed:
            raise RpcApplicationError(
                ReplicateErrorCode.SOURCE_REMOVED.value, self.name)
        if op not in self._READ_OPS:
            raise RpcApplicationError(
                "BAD_READ_OP",
                f"{self.name}: unknown read op {op!r} "
                f"(want one of {self._READ_OPS})",
            )
        t0 = time.monotonic()
        with start_span("repl.read", db=self.name, op=op) as sp:
            if (max_lag is not None
                    and self.role in (ReplicaRole.FOLLOWER,
                                      ReplicaRole.OBSERVER)):
                _applied, est, age = self._read_lag_state()
                if (est is None or age is None
                        or age > self.flags.read_info_ttl_ms / 1000.0):
                    # stale estimate: verify against the upstream BEFORE
                    # gating, so the serve decision is exact as of the
                    # probe's answer — the chaos invariant's foundation
                    await self._probe_upstream_seq()
            gate = self.read_gate(max_lag=max_lag, epoch=epoch)
            values = await self._loop.run_in_executor(
                self._executor, self._do_read, op, keys, start, count)
            if op in ("multi_get", "scan"):
                # tail armor: re-check the request deadline
                # before a potentially large response is serialized —
                # the engine read may have spent the whole budget, and
                # encoding N values nobody is waiting for only delays
                # live requests behind this connection
                from ..rpc.deadline import current_deadline

                dl = current_deadline()
                if dl is not None and dl.expired:
                    self._stats.incr(tagged("reads.deadline_shed", op=op))
                    raise RpcApplicationError(
                        "DEADLINE_EXCEEDED",
                        f"{self.name}: {op} deadline expired "
                        f"{-dl.remaining_ms():.1f}ms ago before "
                        "response serialization")
            if self.role in (ReplicaRole.LEADER, ReplicaRole.NOOP):
                self._stats.incr(R["leader_served"])
            else:
                self._stats.incr(R["follower_served"])
            self._stats.incr(self._m_shard_reads)
            if sp.sampled:
                sp.annotate(lag=gate["lag"], applied_seq=gate["applied_seq"])
            # SERVED reads only enter the latency histogram (a Timer
            # context would also record gate bounces — a bounced probe's
            # upstream RTT is not a serve latency, and at p99 a handful
            # of them would make the fleet-merged histogram disagree
            # with what clients actually experienced; bounces have their
            # own counters). The SAME value rides the response as
            # serve_ms, so a client's pooled samples and the merged
            # histogram measure the identical quantity — the
            # macro-bench's p99 agreement check is exact by
            # construction, up to bucket resolution.
            serve_ms = (time.monotonic() - t0) * 1e3
            self._stats.add_metric(tagged("reads.latency_ms", op=op),
                                   serve_ms)
            return {
                **gate,
                "values": values,
                "source_role": self.role.value,
                "epoch": self.epoch,
                "serve_ms": round(serve_ms, 3),
            }

    def _do_read(self, op: str, keys, start, count):
        """Executor-side read execution (engine reads may touch disk —
        never on the loop). Wrapper/argument problems surface as typed
        RPC errors, never as INTERNAL stack traces: a non-persisting
        wrapper (CDC observer) bounces cleanly down the router's chain."""
        from .db_wrapper import execute_read_op

        # sync hit ON the executor thread (unlike the loop-side
        # repl.read seam above): a delay policy here OCCUPIES a
        # dispatch slot without burning CPU — the hot-shift bench's
        # deterministic per-read service cost, so the serving knee is
        # rate-derived rather than host-derived even on a 1-core box
        fp.hit("repl.read.serve")
        try:
            return execute_read_op(self.wrapper, op, keys=keys,
                                   start=start, count=count)
        except NotImplementedError as e:
            raise RpcApplicationError(
                "READS_UNSUPPORTED",
                f"{self.name}: wrapper does not serve reads ({e})",
            ) from e
        except (ValueError, TypeError) as e:
            raise RpcApplicationError(
                "BAD_READ_OP", f"{self.name}: {e}") from e

    async def handle_write_request(self, raw_batch, epoch=None) -> dict:
        """Remote entry to the leader write path (the macro-bench's
        full-stack put op class): fence-check the carried epoch, commit
        via write_async OFF the loop (it may block on window flow
        control), and await the ack condition. Returns the batch's start
        seq and whether the replication ack condition was met."""
        if self.role not in (ReplicaRole.LEADER, ReplicaRole.NOOP):
            # role check BEFORE any epoch processing: a FOLLOWER must
            # never adopt a client-claimed epoch (_reject_stale_epoch
            # would — and the bogus epoch would then ride this
            # follower's pulls upstream and fence the HEALTHY leader).
            # Same no-adopt rule as _read_epoch_gate: client claims are
            # not authoritative.
            raise RpcApplicationError(
                ReplicateErrorCode.NOT_LEADER.value,
                f"{self.name} role is {self.role.value}",
            )
        if self._reject_stale_epoch(epoch):
            self._stats.incr(M["stale_epoch_rejects"])
            raise RpcApplicationError(
                ReplicateErrorCode.STALE_EPOCH.value,
                f"{self.name}: write epoch {epoch} fences serving epoch "
                f"{self.epoch}",
            )
        # Fail fast on a full write window instead of parking an
        # executor thread inside write_async's flow-control block: with
        # followers partitioned, enough concurrent write RPCs would
        # otherwise exhaust the SHARED executor and starve every read
        # and cold-cursor WAL serve behind stalled writes. The depth
        # check is advisory (a racing writer can still fill the window
        # and briefly park the executor task — bounded by the race, not
        # systematic); the client sees a typed, retryable error.
        if self.ack_window_free <= 0:
            self._stats.incr(M["write_window_full"])
            raise RpcApplicationError(
                "WRITE_WINDOW_FULL",
                f"{self.name}: {self._acked.depth}/{self._acked.capacity} "
                f"writes in flight — retry with backoff",
            )
        batch = decode_batch(bytes(raw_batch))
        # server-side latency per op class (the write sibling of
        # reads.latency_ms): the fleet p50/p99 the spectator merge
        # reports for puts, measured commit → ack condition; recorded on
        # COMPLETED writes only (same served-only contract as reads)
        t0 = time.monotonic()
        waiter = await self._loop.run_in_executor(
            self._executor, self.write_async, batch)
        await asyncio.wrap_future(waiter.future)
        self._stats.add_metric(tagged("writes.latency_ms", op="put"),
                               (time.monotonic() - t0) * 1e3)
        return {"seq": waiter.seq, "acked": waiter.acked,
                "epoch": self.epoch}

    # ------------------------------------------------------------------
    # follower pull path (loop thread)
    # ------------------------------------------------------------------

    async def _pull_loop(self) -> None:
        f = self.flags
        while not self._removed:
            try:
                applied, source_role = await self._pull_once()
                self._mark_pull_ok()
                if (
                    applied == 0
                    and self.role is ReplicaRole.FOLLOWER
                    and source_role not in (None, ReplicaRole.LEADER.value)
                ):
                    # Empty pulls FROM A NON-LEADER mean leadership moved
                    # (replicated_db.cpp:385-399); idle leaders are normal
                    # and never trigger resets.
                    self._empty_pulls += 1
                    if self._empty_pulls >= f.empty_pulls_before_reset:
                        self._empty_pulls = 0
                        await self._maybe_reset_upstream(force_sample=False)
                else:
                    self._empty_pulls = 0
            except asyncio.CancelledError:
                # do not await the in-flight apply here — stop() must not
                # block on executor work; just forget the pipeline state
                self._apply_future = None
                self._apply_target = None
                self._applied_through = None
                raise
            except RpcApplicationError as e:
                await self._drain_pending_apply()
                self._stats.incr(M["pull_errors"])
                self._conn_errors = 0
                if e.code == ReplicateErrorCode.SOURCE_NOT_FOUND.value:
                    await self._maybe_reset_upstream(force_sample=False)
                elif e.code == ReplicateErrorCode.WAL_GAP.value:
                    # the upstream's WAL was purged past our position:
                    # no amount of pulling can ever catch us up. Flag
                    # the stall (the participant loop turns it into a
                    # snapshot rebuild) and still consult the resolver
                    # — a repoint to a deeper-WAL donor may heal it
                    # without a rebuild.
                    if not self.pull_stalled_wal_gap:
                        self.pull_stalled_wal_gap = True
                        self._stats.incr(M["wal_gap_stalls"])
                        log.warning(
                            "%s: WAL-tail catch-up STALLED (%s) — "
                            "snapshot rebuild required", self.name, e)
                    # the cached cursor may predate a local advance the
                    # pull loop never saw (an SST ingest on this replica
                    # takes a seqno outside the WAL): the next pull
                    # re-reads storage, and heals if the DB moved past
                    # the gap
                    self._applied_through = None
                    await self._maybe_reset_upstream(force_sample=True)
                elif e.code == ReplicateErrorCode.STALE_EPOCH.value:
                    # a KNOWN-deposed upstream (or one that outran us):
                    # consult the resolver unsampled — faster pulls at
                    # the stale leader cannot help
                    await self._maybe_reset_upstream(force_sample=True)
                await self._pull_error_delay()
            except RpcTransportConfigError as e:
                # a MISCONFIG, not a connection error: loud (ERROR, not
                # the routine pull warning), never escalated to the
                # leader resolver, and retried only on the growing
                # backoff — faster retries cannot heal a bad transport
                # config, but the loop stays alive so reset_upstream /
                # changeDBRoleAndUpStream can repoint past it
                await self._drain_pending_apply()
                self._stats.incr(M["pull_errors"])
                self._conn_errors = 0
                log.error("%s: transport misconfig pulling from %s: %s",
                          self.name, self.upstream_addr, e)
                await self._pull_error_delay()
            except (RpcError, Exception) as e:
                await self._drain_pending_apply()
                self._stats.incr(M["pull_errors"])
                log.warning("%s: pull error from %s: %r", self.name,
                            self.upstream_addr, e)
                # A dead upstream looks like CONNECTION errors; consult
                # the leader resolver — sampled at first, FORCED after a
                # few in a row (a steady follower gets no transition when
                # its leader dies; only this path repoints it). Only
                # connection-class errors escalate: a local apply/decode
                # failure loop must not hammer the control plane
                # unsampled.
                forced = False
                if isinstance(e, (RpcConnectionError, ConnectionError,
                                  OSError)):
                    self._conn_errors += 1
                    forced = (self._conn_errors
                              >= f.conn_errors_before_forced_reset)
                    if forced:
                        self._conn_errors = 0
                else:
                    self._conn_errors = 0
                await self._maybe_reset_upstream(force_sample=forced)
                await self._pull_error_delay()

    def _mark_pull_ok(self) -> None:
        """Reset the error machinery after a successful pull (solo loop
        or mux section): error counters, backoff attempt, and the
        WAL-gap stall flag (an upstream repoint may have landed on a
        deeper-WAL donor)."""
        self._ever_pulled = True
        self._conn_errors = 0
        self._pull_retry_attempt = 0
        self.pull_stalled_wal_gap = False

    async def _pull_once(self) -> Tuple[int, Optional[str]]:
        """One pull iteration, DOUBLE-BUFFERED: the pull RPC for the next
        batch is issued while the PREVIOUS response is still applying in
        the executor, so network long-poll/RTT and storage apply overlap
        instead of alternating. The request cursor (``seq_no``) runs from
        the in-flight apply's target; the durably-applied position rides
        along as ``applied_seq`` so mode-2 acks never over-claim."""
        f = self.flags
        assert self.upstream_addr is not None
        await fp.async_hit("repl.pull")
        host, port = self.upstream_addr
        # Follower-rooted pull trace: pool acquire + RPC RTT (which carries
        # the context to the upstream's serve span) + the apply handoff.
        with start_span("repl.pull", db=self.name) as sp:
            if f.server_long_poll_ms > 0:
                # a pull's duration is dominated by the deliberate
                # server-side long-poll park — exempt from tail-keep
                sp.annotate(tail_exempt="long_poll")
            client = await self._pool.get_client(host, port)
            if self._applied_through is None:
                # cold pipeline: one storage-lock read seeds the cursor;
                # afterwards apply completions keep it current without
                # touching the storage lock per pull
                with start_span("repl.seq_read"):
                    self._applied_through = await self._loop.run_in_executor(
                        self._executor, self.wrapper.latest_sequence_number
                    )
            from_seq = (
                self._apply_target if self._apply_target is not None
                else self._applied_through
            )
            self._stats.incr(M["pull_requests"])
            call_coro = client.call(
                "replicate",
                {
                    "db_name": self.name,
                    "seq_no": from_seq,
                    "applied_seq": self._applied_through,
                    "max_wait_ms": f.server_long_poll_ms,
                    "max_updates": self._cur_max_updates,
                    "role": self.role.value,
                    # fencing: our epoch rides the request frame header —
                    # a deposed upstream seeing a newer one fences itself
                    "epoch": self.epoch,
                },
                timeout=(f.server_long_poll_ms + f.pull_rpc_margin_ms) / 1000.0,
                # the RTT of a long poll IS the long poll: a parked
                # pull must not be tail-kept as a slow outlier
                tail_exempt=f.server_long_poll_ms > 0,
            )
            if self._apply_future is None:
                result = await call_coro
            else:
                result = await self._call_racing_apply(client, call_coro)
            updates = result.get("updates", []) if result else []
            source_role = result.get("source_role") if result else None
            resp_epoch = result.get("epoch") if result else None
            if resp_epoch is not None:
                if int(resp_epoch) > self.epoch:
                    # a promotion reached the data plane before our
                    # assignment did — adopt; epochs only move forward
                    self.adopt_epoch(int(resp_epoch))
                elif int(resp_epoch) < self.epoch:
                    # deposed upstream: its updates may carry a divergent
                    # un-acked suffix — apply NOTHING, repoint instead
                    self._stats.incr(M["stale_epoch_rejects"])
                    raise RpcApplicationError(
                        ReplicateErrorCode.STALE_EPOCH.value,
                        f"{self.name}: upstream {host}:{port} epoch "
                        f"{resp_epoch} < ours {self.epoch}",
                    )
            if result and result.get("replication_mode") is not None:
                self._upstream_mode = int(result["replication_mode"])
            # every pull response refreshes the commit-point estimate
            # bounded follower reads check their lag against
            self._adopt_commit_point(result)
            self._note_divergence(result, source_role)
            self._adapt_max_updates(result, updates)
            if not updates:
                # idle upstream: let the pipeline drain so apply errors
                # surface here rather than lingering across long-polls
                await self._drain_pending_apply(reraise=True)
                return 0, source_role
            sp.annotate(updates=len(updates),
                        pipelined=self._apply_future is not None)
            # in-order apply: the previous response must land before this
            # one is handed to the executor (and its failure must surface
            # BEFORE we commit to a cursor built on top of it)
            await self._drain_pending_apply(reraise=True)
            # run_in_executor does not carry contextvars: hand the pull
            # context across the hop explicitly (observability/context.py).
            pull_ctx = wire_context()
            last = updates[-1]
            self._apply_target = int(last["seq_no"]) + int(
                last.get("count") or 1) - 1
            self._apply_future = self._loop.run_in_executor(
                self._executor, self._apply_updates, updates, pull_ctx
            )
            return len(updates), source_role

    async def _call_racing_apply(self, client, call_coro):
        """Await the pull RPC while the previous apply runs. If the apply
        lands first and the RPC is a parked long-poll, roll the cursor
        forward immediately and — for a mode-2 upstream — push the fresh
        applied position via a lightweight replicate_ack RPC, so the
        leader's pipelined ack waiters for the burst tail resolve at
        apply time instead of waiting out the park."""
        rpc_task = asyncio.ensure_future(call_coro)
        apply_fut = self._apply_future
        try:
            await asyncio.wait(
                {rpc_task, apply_fut}, return_when=asyncio.FIRST_COMPLETED
            )
        except asyncio.CancelledError:
            rpc_task.cancel()
            raise
        if not rpc_task.done():
            try:
                await self._drain_pending_apply(reraise=True)
            except Exception:
                rpc_task.cancel()
                raise
            if self._upstream_mode == 2 and self._applied_through:
                await self._send_applied_ack(client)
        return await rpc_task

    async def _send_applied_ack(self, client) -> None:
        """Best-effort ack push (mode-2 upstreams): the next pull carries
        applied_seq anyway, so failures only cost ack latency."""
        try:
            await client.call(
                "replicate_ack",
                {
                    "db_name": self.name,
                    "applied_seq": self._applied_through,
                    "role": self.role.value,
                    "epoch": self.epoch,
                },
                timeout=2.0,
            )
        except Exception:
            log.debug("%s: replicate_ack push failed", self.name,
                      exc_info=True)

    def post_applied(self, applied_seq: int, role: str,
                     epoch: Optional[int] = None) -> None:
        """Server side of the replicate_ack push: count the follower's
        durably-applied position toward mode-2 acks (OBSERVERs never
        count, same as the pull path). Same epoch fencing as the pull
        path: an ack carrying a newer epoch deposes this leader and must
        never resolve a waiter."""
        if self._reject_stale_epoch(epoch):
            self._stats.incr(M["stale_epoch_rejects"])
            raise RpcApplicationError(
                ReplicateErrorCode.STALE_EPOCH.value,
                f"{self.name}: ack epoch {epoch} fences serving epoch "
                f"{self.epoch}",
            )
        if role != ReplicaRole.OBSERVER.value and self.replication_mode == 2:
            self._acked.post(int(applied_seq))

    def _note_divergence(self, result, source_role) -> None:
        """Detect a lineage-divergent suffix: a FOLLOWER persistently
        AHEAD of a direct LEADER upstream's own committed seq holds
        records that are not in the lineage — it applied them from a
        deposed leader inside the visibility window, before the new
        epoch reached it. Pulling can never reconcile this (the
        upstream serves only seqs above ours, and our extra seqs shadow
        the lineage's), so flag it for the participant's resync loop.
        Requires several CONSECUTIVE ahead observations from a LEADER
        source: a momentarily-lagging middle hop or a racing estimate
        must never trigger a data-destroying resync."""
        if (self.role is not ReplicaRole.FOLLOWER
                or source_role != ReplicaRole.LEADER.value):
            self._ahead_pulls = 0
            return
        latest = (result or {}).get("latest_seq")
        applied = self._applied_through
        if latest is None or applied is None \
                or int(latest) >= int(applied):
            self._ahead_pulls = 0
            return
        self._ahead_pulls += 1
        if self._ahead_pulls >= 3 and not self.pull_diverged:
            self.pull_diverged = True
            self._stats.incr(M["diverged_stalls"])
            log.warning(
                "%s: applied %d is AHEAD of the leader's committed %d "
                "for %d consecutive pulls — divergent suffix (deposed-"
                "leader window write); resync required",
                self.name, applied, int(latest), self._ahead_pulls)

    def _adapt_max_updates(self, result, updates) -> None:
        """Size the NEXT pull to the upstream's reported backlog: behind
        by a window, ask for the whole window in one response (one pull
        round-trip then acks many pipelined writes at once); caught up,
        fall back to the reference's fixed max_updates_per_response."""
        f = self.flags
        base = f.max_updates_per_response
        latest_up = (result or {}).get("latest_seq")
        if updates and latest_up is not None:
            last = updates[-1]
            served_through = int(last["seq_no"]) + int(
                last.get("count") or 1) - 1
            backlog = int(latest_up) - served_through
            if backlog > 0:
                self._cur_max_updates = min(
                    f.adaptive_max_updates_cap, max(base, backlog))
                return
        self._cur_max_updates = base

    async def _drain_pending_apply(self, reraise: bool = False) -> None:
        """Wait out the in-flight apply (if any) and roll the cached
        applied-through cursor forward; on apply failure the cache is
        invalidated (next pull re-reads storage) and the error either
        propagates (pull path) or is swallowed (error-path cleanup —
        the pull loop is already backing off)."""
        fut = self._apply_future
        if fut is None:
            return
        self._apply_future = None
        target, self._apply_target = self._apply_target, None
        try:
            await fut
        except Exception:
            self._applied_through = None
            if reraise:
                raise
            log.exception("%s: pipelined apply failed", self.name)
            return
        self._applied_through = target

    def _apply_updates(self, updates: List[dict],
                       pull_ctx: Optional[dict] = None) -> None:
        """Executor-side ordered apply of one response's updates."""
        fp.hit("repl.apply")
        now = now_ms()
        total_bytes = 0
        with start_span("repl.apply_batch", remote=pull_ctx, db=self.name,
                        updates=len(updates)):
            # Sequence-continuity guard: applying out of order would shift
            # the local numbering below the leader's and silently diverge
            # (re-fetch + double-apply). One storage-lock read, then the
            # whole group is validated arithmetically BEFORE any of it is
            # applied — a bad response applies nothing.
            expected = self.wrapper.latest_sequence_number() + 1
            for u in updates:
                got = int(u.get("seq_no", expected))
                if got != expected:
                    raise ValueError(
                        f"{self.name}: replication seq discontinuity: expected "
                        f"{expected}, got {got} — rebuild required"
                    )
                expected += int(u.get("count")
                                or decode_batch(bytes(u["raw_data"])).count())
                total_bytes += len(u["raw_data"])
            # Apply: consecutive UNTRACED updates flow through the
            # wrapper's batched group path (one storage-lock pass + one
            # WAL flush per run — the per-record flush dominated the
            # apply side once leader writes pipelined); a traced update
            # breaks the run so its apply span records individually and
            # re-propagates to chained downstreams.
            run: List[dict] = []

            def flush_run():
                if run:
                    self.wrapper.handle_replicate_updates(run)
                    run.clear()

            for u in updates:
                tctx = u.get("trace")
                if tctx is None:
                    run.append(u)
                    continue
                flush_run()
                got = int(u["seq_no"])
                # the update carried its originating write's sampled
                # context: this apply joins the WRITE's trace (child of
                # the leader's repl.write), and re-records the context
                # so chained downstreams stitch onto the same trace
                with start_span("repl.apply", remote=tctx, db=self.name,
                                seq=got) as asp:
                    if pull_ctx is not None:
                        asp.annotate(pull_trace=pull_ctx["trace_id"])
                    self.wrapper.handle_replicate_response(
                        bytes(u["raw_data"]), u.get("timestamp"))
                    if asp.sampled:
                        self._remember_write_trace(got, asp)
            flush_run()
            for u in updates:
                ts = u.get("timestamp")
                if ts is not None:
                    self._stats.add_metric(
                        M["replication_lag_ms"], max(0, now - ts))
        self._stats.incr(M["pull_updates_applied"], len(updates))
        self._stats.incr(M["pull_bytes_applied"], total_bytes)
        # Wake OUR parked long-polls so chained downstream followers see the
        # new updates immediately (reference replicated_db.cpp:391).
        self._notifier.notify_all_threadsafe()

    def _next_pull_delay(self) -> float:
        """Compute (and account) the next pull-error backoff in seconds.
        A shard that has NEVER completed a pull rides the jittered
        fast-first-connect tier for its first few attempts — fleet cold
        start races pullers against leader spin-up, and the steady 5-10s
        floor would stagger 100-shard convergence across minutes. After
        that (or after any successful pull) the steady RetryPolicy floor
        rules. Shared by the solo loop and the mux session's per-shard
        error handling."""
        f = self.flags
        if (not self._ever_pulled
                and self._pull_retry_attempt < f.pull_fast_first_attempts):
            delay = self._pull_rng.uniform(
                f.pull_fast_min_ms / 1000.0, f.pull_fast_max_ms / 1000.0)
        else:
            delay = self._pull_retry.delay(
                self._pull_retry_attempt, self._pull_rng)
        self._pull_retry_attempt += 1
        self._stats.add_metric(
            "replicator.pull_backoff_ms", delay * 1000.0)
        return delay

    async def _pull_error_delay(self) -> None:
        await asyncio.sleep(self._next_pull_delay())

    async def _maybe_reset_upstream(self, force_sample: bool) -> None:
        """Query the leader resolver (reference: Helix GetLeaderInstanceId,
        sampled at 10% to avoid hammering the control plane)."""
        f = self.flags
        if self._leader_resolver is None:
            return
        if not force_sample and random.random() > f.upstream_reset_sample_rate:
            return
        try:
            new_addr = await self._loop.run_in_executor(
                self._executor, self._leader_resolver, self.name
            )
        except Exception:
            log.exception("%s: leader resolver failed", self.name)
            return
        if new_addr and tuple(new_addr) != tuple(self.upstream_addr or ()):
            log.info("%s: resetting upstream %s -> %s", self.name,
                     self.upstream_addr, new_addr)
            self.upstream_addr = tuple(new_addr)
            self._conn_errors = 0  # fresh upstream, fresh error budget
            self._stats.incr(M["upstream_resets"])

    def reset_upstream(self, addr: Tuple[str, int]) -> None:
        """Explicit upstream repoint (changeDBRoleAndUpStream path)."""
        self.upstream_addr = tuple(addr)
        self._conn_errors = 0

    # ------------------------------------------------------------------
    # introspection (replicated_db.cpp:168-182)
    # ------------------------------------------------------------------

    def introspect(self) -> str:
        # RELAXED seq read: the blocking read takes the storage lock,
        # which flush/compaction can hold for seconds — the serve path
        # already keeps it off the loop thread; the status-server path
        # must not hang on it either. Staleness is fine for status text.
        return (
            f"db={self.name} role={self.role.value} "
            f"mode={self.replication_mode} "
            f"latest_seq={self.wrapper.latest_sequence_number_relaxed()} "
            f"acked_seq={self._acked.value} "
            f"ack_window={self._acked.depth}/{self._acked.capacity} "
            f"upstream={self.upstream_addr} "
            f"epoch={self.epoch} fenced_by={self._fenced_by} "
            f"degraded={self._degraded} removed={self._removed}"
        )
