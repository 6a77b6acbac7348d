"""Multiplexed per-peer pull sessions (fleet density).
(The port's copy of ``rocksplicator_tpu/replication/pull_mux.py``.)

Reference: the C++ reference amortizes per-shard replication traffic with
shared per-host connections (``ThriftClientPool`` — one connection pool
per upstream host, every shard's calls ride it). This module goes one
step further for the PULL plane, where the per-shard cost is not just
the connection but the whole long-poll stream: a follower node with 100
shards against one peer runs 100 parked long-polls, 100 reconnect
machines, and 100 frames per poll window even when idle.

One **mux session** per upstream peer replaces them: a single long-poll
request carries the cursor set for every shard this node pulls from that
peer, the server drains every shard with backlog into per-shard sections
of ONE response — parking ONCE across all member notifiers when
everything is idle — and the client demuxes each section through the
existing per-shard apply pipeline.

Per-shard semantics survive the mux unchanged, by construction: the
server side serves each section through the SAME
``ReplicatedDB.handle_replicate_request`` (with ``max_wait_ms=0``), so
fencing epochs, mode-1/2 acks, WAL_GAP typing, commit-point attestation
and the adaptive max_updates clamp are per-section; the client side runs
the SAME error taxonomy as ``_pull_loop`` per section, so an epoch bump
fences ONE shard, a WAL_GAP stalls ONE shard, and each shard backs off
on its own jittered RetryPolicy while the rest of the session keeps
streaming.

Killswitch: ``RSTPU_PULL_MUX`` (default off; ``ReplicationFlags.pull_mux``
overrides). Peers that predate ``replicate_mux`` answer NO_SUCH_METHOD —
the session falls back to per-shard pull loops automatically and the
peer is remembered as legacy.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from typing import Dict, List, Optional, Set, Tuple

from ..observability.context import current_span, wire_context
from ..rpc.errors import (RpcApplicationError, RpcConnectionError, RpcError,
                          RpcTransportConfigError)
from ..testing import failpoints as fp
from ..utils.retry_policy import RetryPolicy
from ..utils.stats import Stats
from .wire import REPLICATOR_METRICS as M
from .wire import ReplicaRole, ReplicateErrorCode

log = logging.getLogger(__name__)


def mux_enabled(flags=None) -> bool:
    """Resolve the mux killswitch: an explicit ``flags.pull_mux`` wins;
    otherwise the RSTPU_PULL_MUX env var (default OFF)."""
    if flags is not None and getattr(flags, "pull_mux", None) is not None:
        return bool(flags.pull_mux)
    val = os.environ.get("RSTPU_PULL_MUX", "")
    return val.lower() not in ("", "0", "false", "no")


# ----------------------------------------------------------------------
# server side
# ----------------------------------------------------------------------


class MuxServerState:
    """Per-process server state for ``replicate_mux``: the parked-session
    count (the fleet A/B's parked-longpolls gauge input) and a rotation
    cursor so the session budget starves no section under sustained
    backlog."""

    def __init__(self):
        self.parked = 0
        self._rot = 0

    async def serve(self, db_map, sections: Dict[str, dict],
                    max_wait_ms: Optional[int] = None,
                    budget: Optional[int] = None) -> dict:
        """Serve one mux request: per-section {error} or the exact dict
        ``handle_replicate_request`` returns. Parks AT MOST ONCE for the
        whole session (one reserved slot per member notifier, any wake
        ends the park) — never per section."""
        await fp.async_hit("repl.mux.serve")
        stats = Stats.get()
        stats.incr(M["mux_requests"])
        out: Dict[str, dict] = {}
        live: Dict[str, Tuple[object, dict]] = {}
        for name, sec in (sections or {}).items():
            db = db_map.get(name)
            if db is None or db.removed:
                out[name] = {
                    "error": ReplicateErrorCode.SOURCE_NOT_FOUND.value,
                    "message": name,
                }
                continue
            live[name] = (db, sec or {})
        # Pre-park pass, preserving the legacy per-shard serve ORDER
        # (fence check, then mode-2 ack posting, BEFORE any park): a
        # deposed section must post no acks and must not hold the
        # session's park hostage; a mode-2 leader's pipelined waiters
        # resolve from the puller's applied_seq even when this session
        # is about to park for the full window.
        for name in list(live):
            db, sec = live[name]
            epoch = sec.get("epoch")
            if db._reject_stale_epoch(epoch):
                db._stats.incr(M["stale_epoch_rejects"])
                out[name] = {
                    "error": ReplicateErrorCode.STALE_EPOCH.value,
                    "message": (
                        f"{name}: serving epoch {db.epoch} < puller epoch "
                        f"{epoch}" if epoch is not None else
                        f"{name}: fenced by epoch {db._fenced_by}"),
                }
                live.pop(name)
                continue
            role = sec.get("role", ReplicaRole.FOLLOWER.value)
            if role != ReplicaRole.OBSERVER.value and db.replication_mode == 2:
                applied = sec.get("applied_seq")
                db._acked.post(int(
                    sec.get("seq_no", 0) if applied is None else applied))
        flags = next(iter(live.values()))[0].flags if live else None
        if max_wait_ms is None:
            max_wait_ms = flags.server_long_poll_ms if flags else 0
        if budget is None:
            budget = flags.mux_session_budget if flags else 0

        def _backlog() -> bool:
            for db, sec in live.values():
                latest = db.wrapper.latest_sequence_number_relaxed()
                if latest > int(sec.get("seq_no", 0)):
                    return True
            return False

        if live and max_wait_ms > 0 and not _backlog():
            # ONE park for the whole session: reserve a slot on EVERY
            # member's notifier BEFORE the backlog re-check (the same
            # no-missed-wakeup contract as the per-shard park), then
            # wait for ANY slot; unfired slots are released after.
            slots = [(db, db._notifier.reserve())
                     for db, _sec in live.values()]
            try:
                if not _backlog():
                    root = current_span()
                    if root is not None:
                        root.annotate(tail_exempt="mux_longpoll_serve")
                    stats.incr(M["mux_parks"])
                    self.parked += 1
                    try:
                        await asyncio.wait(
                            [s for _db, s in slots],
                            timeout=max_wait_ms / 1000.0,
                            return_when=asyncio.FIRST_COMPLETED,
                        )
                    finally:
                        self.parked -= 1
            finally:
                for db, slot in slots:
                    db._notifier.cancel_reserved(slot)
        # Serve pass: each live section through the EXACT per-shard
        # serve path with max_wait_ms=0 (no second park) — per-section
        # epoch/ack/WAL/commit-point semantics by construction. The
        # session budget bounds what one response pins in memory; the
        # rotation makes budget starvation impossible under sustained
        # backlog (a zero-grant section still reports latest_seq, so
        # its puller sizes the next round adaptively).
        self._rot += 1
        names = list(live)
        start = self._rot % len(names) if names else 0
        remaining = max(0, int(budget))
        for name in names[start:] + names[:start]:
            db, sec = live[name]
            if db.removed:
                out[name] = {
                    "error": ReplicateErrorCode.SOURCE_REMOVED.value,
                    "message": name,
                }
                continue
            want = int(sec.get("max_updates")
                       or db.flags.max_updates_per_response)
            grant = min(want, remaining)
            if grant <= 0:
                # budget exhausted this round: report position only (the
                # mode-2 ack already posted pre-park); the rotation puts
                # this section first next round
                out[name] = {
                    "updates": [],
                    "latest_seq":
                        db.wrapper.latest_sequence_number_relaxed(),
                    "source_role": db.role.value,
                    "replication_mode": db.replication_mode,
                    "epoch": db.epoch,
                    **db._commit_point_fields(),
                }
                continue
            try:
                res = await db.handle_replicate_request(
                    seq_no=int(sec.get("seq_no", 0)),
                    max_wait_ms=0,
                    max_updates=grant,
                    role=sec.get("role", ReplicaRole.FOLLOWER.value),
                    applied_seq=sec.get("applied_seq"),
                    epoch=sec.get("epoch"),
                )
            except RpcApplicationError as e:
                out[name] = {"error": e.code, "message": str(e)}
                continue
            remaining -= len(res.get("updates") or ())
            out[name] = res
        stats.incr(M["mux_sections"], len(sections or ()))
        return {"sections": out}


# ----------------------------------------------------------------------
# client side
# ----------------------------------------------------------------------


class PullMuxManager:
    """Routes FOLLOWER/OBSERVER shards into one PullMuxSession per
    upstream peer. Lives on the Replicator; ``register``/``deregister``
    are thread-safe (they hop to the IO loop), everything else runs on
    the loop thread."""

    def __init__(self, loop: asyncio.AbstractEventLoop, executor, pool,
                 flags):
        self._loop = loop
        self._executor = executor
        self._pool = pool
        self.flags = flags
        self._sessions: Dict[Tuple[str, int], PullMuxSession] = {}
        self._legacy: Set[Tuple[str, int]] = set()
        self._stopped = False

    def register(self, rdb) -> None:
        self._loop.call_soon_threadsafe(self._route, rdb)

    def deregister(self, rdb) -> None:
        self._loop.call_soon_threadsafe(self._drop, rdb)

    def stop(self) -> None:
        def _stop():
            self._stopped = True
            for sess in list(self._sessions.values()):
                sess.cancel()
            self._sessions.clear()

        self._loop.call_soon_threadsafe(_stop)

    # -- loop thread ---------------------------------------------------

    def _route(self, rdb) -> None:
        if self._stopped or rdb.removed:
            return
        addr = tuple(rdb.upstream_addr or ())
        if len(addr) != 2:
            return
        if addr in self._legacy:
            # peer known to predate replicate_mux: classic per-shard loop
            rdb.start_solo_pull()
            return
        sess = self._sessions.get(addr)
        if sess is None or sess.closed:
            sess = self._sessions[addr] = PullMuxSession(self, addr)
            sess.start()
        sess.add(rdb)

    def _drop(self, rdb) -> None:
        for sess in self._sessions.values():
            sess.discard(rdb)

    def mark_legacy(self, addr) -> None:
        self._legacy.add(tuple(addr))

    def _session_closed(self, sess: "PullMuxSession") -> None:
        if self._sessions.get(sess.addr) is sess:
            self._sessions.pop(sess.addr, None)


class PullMuxSession:
    """One multiplexed pull stream against one upstream peer. The round
    loop mirrors ``ReplicatedDB._pull_loop`` lifted to a member SET:
    whole-call failures are peer-level (one session backoff, per-member
    error accounting), per-SECTION failures run the exact per-shard
    taxonomy and back off only that shard."""

    def __init__(self, mgr: PullMuxManager, addr: Tuple[str, int]):
        self.mgr = mgr
        self.addr = addr
        self.members: Dict[str, object] = {}
        self.closed = False
        self._backoff_until: Dict[str, float] = {}
        self._task: Optional[asyncio.Task] = None
        # membership-change kick: joining shards must not wait out a
        # parked long-poll they are not part of
        self._wake = asyncio.Event()
        f = mgr.flags
        self._retry = RetryPolicy(
            max_attempts=1 << 30,
            base_delay=f.pull_error_delay_min_ms / 1000.0,
            max_delay=f.pull_error_delay_max_ms / 1000.0,
            floor=f.pull_error_delay_min_ms / 1000.0,
        )
        self._retry_attempt = 0
        _seed = os.environ.get("RSTPU_PULL_RETRY_SEED")
        self._rng = random.Random(int(_seed) if _seed else None)
        self._ever_pulled = False

    # -- loop thread ---------------------------------------------------

    def start(self) -> None:
        self._task = self.mgr._loop.create_task(self._run())

    def cancel(self) -> None:
        self.closed = True
        if self._task is not None:
            self._task.cancel()

    def add(self, rdb) -> None:
        self.members[rdb.name] = rdb
        self._backoff_until.pop(rdb.name, None)
        self._wake.set()

    def discard(self, rdb) -> None:
        if self.members.get(rdb.name) is rdb:
            self.members.pop(rdb.name, None)
            self._backoff_until.pop(rdb.name, None)
            self._wake.set()

    def _refresh_members(self) -> List[object]:
        """Drop removed members, re-route members whose upstream moved
        (an upstream reset repoints ONE shard — it changes session, not
        semantics), return the live set."""
        out = []
        for name, rdb in list(self.members.items()):
            if rdb.removed:
                self.members.pop(name)
                self._backoff_until.pop(name, None)
                continue
            if tuple(rdb.upstream_addr or ()) != self.addr:
                self.members.pop(name)
                self._backoff_until.pop(name, None)
                self.mgr._route(rdb)
                continue
            out.append(rdb)
        return out

    async def _run(self) -> None:
        try:
            # coalesce the registration burst (add_db storms register one
            # shard per loop tick) so the first round carries the node's
            # whole cursor set instead of one
            await asyncio.sleep(0.02)
            while True:
                self._wake.clear()
                members = self._refresh_members()
                if not members:
                    return
                now = time.monotonic()
                eligible = [
                    r for r in members
                    if self._backoff_until.get(r.name, 0.0) <= now
                ]
                if not eligible:
                    deadline = min(self._backoff_until[r.name]
                                   for r in members)
                    try:
                        await asyncio.wait_for(
                            self._wake.wait(),
                            max(0.01, deadline - now))
                    except asyncio.TimeoutError:
                        pass
                    continue
                try:
                    await self._pull_round(eligible)
                except asyncio.CancelledError:
                    # same contract as _pull_loop cancellation: never
                    # block teardown on executor work — forget pipelines
                    for r in eligible:
                        r._apply_future = None
                        r._apply_target = None
                        r._applied_through = None
                    raise
                except RpcApplicationError as e:
                    if e.code == "NO_SUCH_METHOD":
                        self._fallback_legacy()
                        return
                    await self._session_error(eligible, e, conn=False)
                except RpcTransportConfigError as e:
                    log.error("mux[%s:%s]: transport misconfig: %s",
                              self.addr[0], self.addr[1], e)
                    await self._session_error(eligible, e, conn=False,
                                              resolver=False)
                except (RpcError, Exception) as e:
                    conn = isinstance(
                        e, (RpcConnectionError, ConnectionError, OSError))
                    log.warning("mux[%s:%s]: pull error: %r",
                                self.addr[0], self.addr[1], e)
                    await self._session_error(eligible, e, conn=conn)
        finally:
            self.closed = True
            self.mgr._session_closed(self)

    async def _pull_round(self, eligible: List[object]) -> None:
        """One mux round: ONE RPC carrying every eligible shard's cursor,
        racing the members' in-flight applies (mode-2 ack pushes fire at
        apply time, exactly as the solo loop's racing apply does), then
        per-section demux."""
        mgr = self.mgr
        f = mgr.flags
        host, port = self.addr
        # the solo loop's pull seam: existing chaos decks inject faults
        # at repl.pull — mux rounds must feel them identically
        await fp.async_hit("repl.pull")
        client = await mgr._pool.get_client(host, port)
        for r in eligible:
            if r._applied_through is None and r._apply_future is None:
                # cold pipeline: one storage-lock read seeds the cursor
                r._applied_through = await mgr._loop.run_in_executor(
                    mgr._executor, r.wrapper.latest_sequence_number)
        sections = {}
        for r in eligible:
            from_seq = (r._apply_target if r._apply_target is not None
                        else r._applied_through)
            sections[r.name] = {
                "seq_no": from_seq,
                "applied_seq": r._applied_through,
                "max_updates": r._cur_max_updates,
                "role": r.role.value,
                "epoch": r.epoch,
            }
        stats = Stats.get()
        stats.incr(M["mux_pulls"])
        stats.incr(M["pull_requests"])
        rpc_task = asyncio.ensure_future(client.call(
            "replicate_mux",
            {
                "sections": sections,
                "max_wait_ms": f.server_long_poll_ms,
                "budget": f.mux_session_budget,
            },
            timeout=(f.server_long_poll_ms + f.pull_rpc_margin_ms) / 1000.0,
            tail_exempt=f.server_long_poll_ms > 0,
        ))
        result = await self._race(client, rpc_task, eligible)
        if result is None:
            return  # round abandoned for a membership change
        self._ever_pulled = True
        self._retry_attempt = 0
        resp = (result or {}).get("sections") or {}
        for r in eligible:
            sec = resp.get(r.name)
            if sec is None or r.removed:
                continue
            if "error" in sec:
                await self._section_error(r, sec)
            else:
                await self._section_ok(r, sec, client)

    async def _race(self, client, rpc_task, eligible):
        """Await the mux RPC while racing (a) every member's in-flight
        apply — completions roll cursors and push mode-2 acks at apply
        time — and (b) the membership-change kick, which abandons the
        round (cancels the RPC; the id-keyed client discards the orphan
        response) so a joining shard never waits out a park it is not
        part of. Returns the RPC result, or None when abandoned."""
        try:
            while not rpc_task.done():
                pend = {}
                for r in eligible:
                    fut = r._apply_future
                    if fut is not None and not fut.done():
                        pend[fut] = r
                done_applies = [r for r in eligible
                                if r._apply_future is not None
                                and r._apply_future.done()]
                for r in done_applies:
                    try:
                        await r._drain_pending_apply(reraise=True)
                    except Exception as e:
                        r._stats.incr(M["pull_errors"])
                        log.warning("%s: pipelined apply failed: %r",
                                    r.name, e)
                        self._shard_backoff(r)
                        continue
                    if r._upstream_mode == 2 and r._applied_through:
                        await r._send_applied_ack(client)
                if done_applies:
                    continue
                waits = {rpc_task, *pend.keys()}
                wake_task = None
                if not self._wake.is_set():
                    wake_task = asyncio.ensure_future(self._wake.wait())
                    waits.add(wake_task)
                elif not pend:
                    # membership changed and nothing left to race
                    rpc_task.cancel()
                    try:
                        await rpc_task
                    except BaseException:
                        pass
                    return None
                try:
                    await asyncio.wait(
                        waits, return_when=asyncio.FIRST_COMPLETED)
                finally:
                    if wake_task is not None:
                        wake_task.cancel()
                if not rpc_task.done() and self._wake.is_set() and not any(
                        f.done() for f in pend):
                    rpc_task.cancel()
                    try:
                        await rpc_task
                    except BaseException:
                        pass
                    return None
            return await rpc_task
        except asyncio.CancelledError:
            rpc_task.cancel()
            raise

    async def _section_ok(self, r, sec: dict, client) -> None:
        """Demux one successful section through the exact solo-pull
        response semantics."""
        source_role = sec.get("source_role")
        resp_epoch = sec.get("epoch")
        if resp_epoch is not None:
            if int(resp_epoch) > r.epoch:
                r.adopt_epoch(int(resp_epoch))
            elif int(resp_epoch) < r.epoch:
                # deposed upstream FOR THIS SHARD: apply nothing, repoint
                # — the rest of the session is untouched
                r._stats.incr(M["stale_epoch_rejects"])
                await self._section_error(r, {
                    "error": ReplicateErrorCode.STALE_EPOCH.value,
                    "message": f"{r.name}: upstream epoch {resp_epoch} "
                               f"< ours {r.epoch}",
                })
                return
        if sec.get("replication_mode") is not None:
            r._upstream_mode = int(sec["replication_mode"])
        r._adopt_commit_point(sec)
        r._note_divergence(sec, source_role)
        updates = sec.get("updates") or []
        r._adapt_max_updates(sec, updates)
        try:
            if not updates:
                await r._drain_pending_apply(reraise=True)
                r._mark_pull_ok()
                self._backoff_until.pop(r.name, None)
                if (r.role is ReplicaRole.FOLLOWER
                        and source_role not in (None,
                                                ReplicaRole.LEADER.value)):
                    r._empty_pulls += 1
                    if r._empty_pulls >= r.flags.empty_pulls_before_reset:
                        r._empty_pulls = 0
                        await r._maybe_reset_upstream(force_sample=False)
                else:
                    r._empty_pulls = 0
                return
            await fp.async_hit("repl.mux.apply")
            # in-order apply: the previous response must land (and its
            # failure surface) before this one reaches the executor
            await r._drain_pending_apply(reraise=True)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            r._stats.incr(M["pull_errors"])
            log.warning("%s: mux apply pipeline error: %r", r.name, e)
            self._shard_backoff(r)
            return
        # A FAILED apply drained inside _race resets the pipeline to
        # storage truth (applied_through=None) — a response built for
        # the abandoned cursor must be dropped here, exactly as the solo
        # loop discards its in-flight response when the racing apply
        # errors. Feeding it on would advance the target past the
        # failure and cascade discontinuity errors round after round.
        cur = (r._apply_target if r._apply_target is not None
               else r._applied_through)
        if cur is None or int(updates[0]["seq_no"]) != cur + 1:
            log.debug("%s: dropping stale mux section (cursor reset)",
                      r.name)
            return
        pull_ctx = wire_context()
        last = updates[-1]
        r._apply_target = int(last["seq_no"]) + int(
            last.get("count") or 1) - 1
        r._apply_future = self.mgr._loop.run_in_executor(
            self.mgr._executor, r._apply_updates, updates, pull_ctx)
        r._mark_pull_ok()
        r._empty_pulls = 0
        self._backoff_until.pop(r.name, None)

    async def _section_error(self, r, sec: dict) -> None:
        """Per-section error: the RpcApplicationError branch of
        ``_pull_loop``, scoped to ONE shard — its backoff, its stall
        flags, its resolver escalation; the session streams on."""
        code = sec.get("error")
        r._stats.incr(M["pull_errors"])
        r._conn_errors = 0
        await r._drain_pending_apply()
        if code in (ReplicateErrorCode.SOURCE_NOT_FOUND.value,
                    ReplicateErrorCode.SOURCE_REMOVED.value):
            await r._maybe_reset_upstream(force_sample=False)
        elif code == ReplicateErrorCode.WAL_GAP.value:
            if not r.pull_stalled_wal_gap:
                r.pull_stalled_wal_gap = True
                r._stats.incr(M["wal_gap_stalls"])
                log.warning(
                    "%s: WAL-tail catch-up STALLED (%s) — snapshot "
                    "rebuild required", r.name, sec.get("message"))
            await r._maybe_reset_upstream(force_sample=True)
        elif code == ReplicateErrorCode.STALE_EPOCH.value:
            await r._maybe_reset_upstream(force_sample=True)
        self._shard_backoff(r)

    def _shard_backoff(self, r) -> None:
        self._backoff_until[r.name] = time.monotonic() + r._next_pull_delay()

    async def _session_error(self, members, e, conn: bool,
                             resolver: bool = True) -> None:
        """Whole-call failure (peer-level): per-member error accounting
        mirroring _pull_loop's connection/generic branches, then ONE
        session backoff — a dead peer costs one reconnect machine, not
        one per shard."""
        for r in members:
            if r.removed:
                continue
            r._stats.incr(M["pull_errors"])
            await r._drain_pending_apply()
            if not resolver:
                r._conn_errors = 0
                continue
            forced = False
            if conn:
                r._conn_errors += 1
                forced = (r._conn_errors
                          >= r.flags.conn_errors_before_forced_reset)
                if forced:
                    r._conn_errors = 0
            else:
                r._conn_errors = 0
            await r._maybe_reset_upstream(force_sample=forced)
        await self._session_delay()

    async def _session_delay(self) -> None:
        """Session-level backoff with the same fast-first-connect tier as
        the per-shard path (one fleet cold start = one fast reconnect
        per PEER, not per shard); interruptible by membership changes."""
        f = self.mgr.flags
        if (not self._ever_pulled
                and self._retry_attempt < f.pull_fast_first_attempts):
            delay = self._rng.uniform(f.pull_fast_min_ms / 1000.0,
                                      f.pull_fast_max_ms / 1000.0)
        else:
            delay = self._retry.delay(self._retry_attempt, self._rng)
        self._retry_attempt += 1
        Stats.get().add_metric("replicator.pull_backoff_ms", delay * 1000.0)
        try:
            await asyncio.wait_for(self._wake.wait(), delay)
        except asyncio.TimeoutError:
            pass

    def _fallback_legacy(self) -> None:
        """The peer answered NO_SUCH_METHOD for replicate_mux: remember
        it as legacy and hand every member its own classic pull loop."""
        Stats.get().incr(M["mux_fallbacks"])
        log.info("mux[%s:%s]: peer predates replicate_mux — falling back "
                 "to per-shard pull loops (%d shards)",
                 self.addr[0], self.addr[1], len(self.members))
        self.mgr.mark_legacy(self.addr)
        for name, r in list(self.members.items()):
            self.members.pop(name)
            if not r.removed:
                r.start_solo_pull()
