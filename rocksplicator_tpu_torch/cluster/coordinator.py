"""Coordination service — the ZooKeeper equivalent.
(The port's copy of ``rocksplicator_tpu/cluster/coordinator.py``.)

Reference dependency: the entire Java control plane sits on ZK (sessions,
ephemeral znodes, watches, InterProcessMutex locks, merged event stores).
This module provides those primitives natively over the framework's RPC
layer:

- hierarchical nodes with versioned CAS writes;
- sessions with TTL heartbeats; ephemeral nodes die with their session;
- sequential nodes (``path-0000000001``) for lock/election recipes;
- long-poll watches on data and children (the same no-thread-parked
  pattern as the replication server);
- client-side distributed lock + leader election recipes;
- **replication**: a standby server (``replica_of=(host, port)``) tails
  the primary's mutation stream (long-poll, resumable by index, full
  state transfer when behind), applies every mutation including
  ephemerals and session lifecycle, persists durable state to its OWN
  WAL+snapshot, and serves reads/watches. ``promote()`` turns it into
  the primary: replicated sessions get a fresh TTL grace window (the ZK
  session-re-establishment analog) so ephemeral registrations survive a
  failover as long as owners keep heartbeating. ``CoordinatorClient``
  accepts fallback endpoints and rotates on connection failure or
  NOT_PRIMARY. Failover is operator/controller-driven by default;
  ``auto_promote_after`` opts a standby into self-promotion after the
  primary has been unreachable that long (deploy at most one such
  standby — two could split-brain on a partition, the reason ZK uses
  quorum; the conservative default is manual).
- **quorum mode** (``quorum_size=N``): ZK-majority semantics for a
  3+-node ensemble. Mutations ack only after floor(N/2) standbys
  received them (no timeout-degrade: QUORUM_LOST on timeout), the
  primary refuses writes once a majority of standbys hasn't pulled
  within ``leader_lease_sec`` (a minority-partitioned primary
  self-demotes), ``promote_best()`` elects the highest-(ftoken,
  mut_index) standby and repoints the rest, and monotonic fencing
  tokens on every ack let clients reject a deposed primary they have
  already outgrown. Reference: the control plane's ZK ensemble
  (common/helix_client.cpp consumes it; quorum + fencing are what ZK
  provides it).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..observability.context import current_span
from ..rpc.client_pool import RpcClientPool
from ..rpc.errors import RpcApplicationError, RpcError
from ..rpc.ioloop import IoLoop
from ..rpc.server import RpcServer
from ..testing import failpoints as fp
from ..utils.stats import Stats

log = logging.getLogger(__name__)

NO_NODE = "NO_NODE"
NODE_EXISTS = "NODE_EXISTS"
BAD_VERSION = "BAD_VERSION"
NO_SESSION = "NO_SESSION"
NOT_EMPTY = "NOT_EMPTY"
NOT_PRIMARY = "NOT_PRIMARY"
QUORUM_LOST = "QUORUM_LOST"

DEFAULT_SESSION_TTL = 6.0
# mutation-stream ring: a standby farther behind than this does a full
# state transfer instead of an incremental catch-up
RECENT_MUTATIONS_CAP = 8192


class _Node:
    __slots__ = ("value", "version", "ephemeral_owner", "seq_counter")

    def __init__(self, value: bytes, ephemeral_owner: Optional[int]):
        self.value = value
        self.version = 0
        self.ephemeral_owner = ephemeral_owner
        self.seq_counter = 0  # next sequential-child suffix


class _Wal:
    """Group-committed append-only mutation log.

    Each record is one line ``<crc32 hex 8>:<json>\n``; replay stops at
    the first torn/corrupt line (a crash mid-append), and opening the log
    TRUNCATES that garbage so later appends are never stranded behind it.
    Records carry ABSOLUTE resulting state (versions, seq values) so
    replay over a newer snapshot is idempotent.

    Appends go through a dedicated writer thread: ``append_async``
    returns a Future resolved after the record is fsync'd. The writer
    drains the queue and fsyncs once per batch (group commit), so a write
    burst costs one fsync — and the fsync never runs on the RPC event
    loop. A failed write/fsync FENCES the log: every pending and future
    append fails, so no further mutation can be acked."""

    def __init__(self, path: str):
        import queue

        self._path = path
        valid = self._valid_prefix_len(path)
        if valid is not None:
            with open(path, "r+b") as f:
                f.truncate(valid)
        self._f = open(path, "ab")
        self._q: "queue.Queue" = queue.Queue()
        self._failed: Optional[Exception] = None
        self._thread = threading.Thread(
            target=self._writer_loop, name="coordinator-wal", daemon=True)
        self._thread.start()

    @staticmethod
    def _encode(rec: dict) -> bytes:
        import json
        import zlib

        payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        return b"%08x:%s\n" % (zlib.crc32(payload), payload)

    def append_async(self, rec: dict):
        """Enqueue; returns a concurrent.futures.Future resolved (True)
        once the record is durable, or failed if the WAL is broken."""
        from concurrent.futures import Future

        fut: Future = Future()
        if self._failed is not None:
            fut.set_exception(self._failed)
            return fut
        self._q.put((self._encode(rec), fut))
        return fut

    def _writer_loop(self) -> None:
        import os
        import queue

        pending = None  # boundary item deferred mid-drain (preserves FIFO)
        while True:
            item = pending if pending is not None else self._q.get()
            pending = None
            if item is None:
                return
            if item[0] == "reset":
                try:
                    self._do_reset()
                    item[1].set_result(True)
                except Exception as e:
                    self._failed = e
                    item[1].set_exception(e)
                    return
                continue
            batch = [item]
            while True:  # drain whatever arrived — one fsync per batch
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None or nxt[0] == "reset":
                    pending = nxt  # handle after this batch, in order
                    break
                batch.append(nxt)
            try:
                for line, _fut in batch:
                    # the control plane touching durable state: a tripped
                    # fail policy fences the log exactly like a real
                    # ENOSPC; a torn policy leaves a truncated record on
                    # disk (healed by _valid_prefix_len on reopen) and
                    # then fences
                    cut = fp.torn_point("coordinator.wal.append", len(line))
                    if cut is not None:
                        self._f.write(line[:cut])
                        self._f.flush()
                        raise fp.FailpointError(
                            f"coordinator.wal.append torn at {cut}")
                    fp.hit("coordinator.wal.append")
                    self._f.write(line)
                self._f.flush()
                os.fsync(self._f.fileno())
            except Exception as e:  # ENOSPC/IO error: fence the log
                self._failed = e
                for _line, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                log.critical("coordinator WAL failed — mutations fenced: %r", e)
                return
            for _line, fut in batch:
                if not fut.done():
                    fut.set_result(True)

    @staticmethod
    def _valid_prefix_len(path: str) -> Optional[int]:
        """Byte length of the valid record prefix, or None if no file."""
        import json
        import os
        import zlib

        if not os.path.isfile(path):
            return None
        pos = 0
        with open(path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n") or len(line) < 10:
                    break
                crc_hex, _, payload = line[:-1].partition(b":")
                try:
                    if int(crc_hex, 16) != zlib.crc32(payload):
                        break
                    json.loads(payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    break
                pos += len(line)
        return pos

    @staticmethod
    def replay(path: str):
        import json
        import os
        import zlib

        if not os.path.isfile(path):
            return
        with open(path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n") or len(line) < 10:
                    return  # torn tail
                crc_hex, _, payload = line[:-1].partition(b":")
                try:
                    if int(crc_hex, 16) != zlib.crc32(payload):
                        return
                    yield json.loads(payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    return

    @property
    def failed(self) -> Optional[Exception]:
        return self._failed

    def reset_async(self):
        """Truncate after a snapshot made the log's contents redundant.
        Runs on the writer thread (never races in-flight appends); caller
        must ensure no un-snapshotted record can be enqueued before this
        (it holds the server lock when the dirty flag was clear)."""
        from concurrent.futures import Future

        fut: Future = Future()
        if self._failed is not None:
            fut.set_exception(self._failed)
            return fut
        self._q.put(("reset", fut))
        return fut

    def _do_reset(self) -> None:
        import os

        self._f.close()
        self._f = open(self._path, "wb")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5.0)
        self._f.close()


class CoordinatorServer:
    """Coordination server. With ``data_dir`` it is DURABLE the way ZK is:
    every acknowledged mutation is fsync'd to a WAL (group commit on a
    dedicated writer thread) before the ack, and periodic snapshots
    truncate the log (kill -9 loses nothing acked). Ephemeral nodes die
    with their sessions by definition and are never persisted; sequential
    counters ARE durable so lock/election suffixes never regress across
    restarts. A failed WAL write fences all further mutations and stops
    snapshots (readers may briefly see the last never-acked mutation in
    memory until restart — standard fail-stop WAL semantics)."""

    def __init__(self, port: int = 0, ioloop: Optional[IoLoop] = None,
                 session_ttl: float = DEFAULT_SESSION_TTL,
                 data_dir: Optional[str] = None,
                 replica_of: Optional[Tuple[str, int]] = None,
                 auto_promote_after: Optional[float] = None,
                 min_sync_standbys: int = 0,
                 ack_timeout: float = 2.0,
                 ack_degrade_after: int = 100,
                 quorum_size: int = 0,
                 leader_lease_sec: float = 6.0):
        import collections

        self._ioloop = ioloop or IoLoop.default()
        self._nodes: Dict[str, _Node] = {"/": _Node(b"", None)}
        self._sessions: Dict[int, float] = {}  # sid -> expiry deadline
        self._session_ids = itertools.count(1)
        self._max_sid_seen = 0
        self._lock = threading.Lock()
        # Serializes the read-state → atomic-write → WAL-truncate
        # snapshot sequence: the periodic snapshot job, a promote's
        # post-promote snapshot, and stop() now run on DIFFERENT threads
        # (executor offload, rstpu-check loop-blocking), and a stale
        # interleaved writer could otherwise overwrite a newer fencing
        # token and then truncate the WAL under it.
        self._snapshot_mutex = threading.Lock()  # rstpu-check: io-mutex snapshot writer — fsync + truncate-wait under it is the mechanism
        self._ttl = session_ttl
        self._change_event: Dict[str, asyncio.Event] = {}
        self._global_version = 0
        self._data_dir = data_dir
        self._dirty = False
        self._wal: Optional[_Wal] = None
        # replication: every mutation gets a stream index; a bounded ring
        # backs incremental standby catch-up. The epoch token qualifies
        # indices (the zxid-epoch analog): a restarted primary starts a
        # new epoch, so a standby resuming with stale indices is forced
        # into a full state transfer instead of silently applying a
        # divergent suffix.
        import uuid

        self._mut_index = 0
        self._epoch = uuid.uuid4().hex
        self._recent: "collections.deque" = collections.deque(
            maxlen=RECENT_MUTATIONS_CAP)
        self._stream_event = asyncio.Event()
        self._upstream = replica_of
        self._standby = replica_of is not None
        self._auto_promote_after = auto_promote_after
        self._standby_task = None
        # semi-sync replication (reference mode-1/2 semantics,
        # replicated_db.cpp:236-273): a mutation acks only once
        # min_sync_standbys standbys have RECEIVED it (their next
        # repl_updates pull implies everything before from_index). On
        # timeout the write proceeds (availability over durability —
        # same as writeWaitFollowerACK) and after ack_degrade_after
        # consecutive timeouts the wait degrades to 10 ms to fail fast,
        # recovering on the first success.
        self._min_sync_standbys = min_sync_standbys
        self._ack_timeout = ack_timeout
        self._ack_degrade_after = ack_degrade_after
        self._ack_timeouts_in_a_row = 0
        self._standby_acked: Dict[str, int] = {}
        self._ack_event = asyncio.Event()
        # Quorum mode (the ZK-majority analog).
        # quorum_size = total ensemble size N (primary + standbys). When
        # > 0, a mutation ACKS only once floor(N/2) standbys received it
        # (majority including self) and there is NO timeout-degrade: on
        # timeout the client gets QUORUM_LOST. Additionally the primary
        # holds a LEASE: mutations are refused outright (NOT_PRIMARY)
        # unless a majority of standbys pulled the stream within
        # leader_lease_sec — a primary cut off from the majority
        # self-demotes for writes, bounding the split-brain window of an
        # asymmetric partition to the lease length. Keep
        # auto_promote_after > leader_lease_sec so the deposed primary
        # stops committing before any standby can take over.
        self._quorum_size = quorum_size
        self._leader_lease_sec = leader_lease_sec
        self._standby_last_pull: Dict[str, float] = {}
        self._standby_parked: Dict[str, int] = {}  # live long-polls
        self._standby_addrs: Dict[str, str] = {}  # id -> "ip:port"
        self._sync_pool: Optional[RpcClientPool] = None  # handle_sync
        # Fencing token (monotonic, the ZK-epoch analog): bumped by every
        # promote, carried on repl_state/repl_updates (standbys adopt the
        # max) and on mutation acks (clients remember the max and refuse
        # to keep talking to a lower-token — deposed — primary).
        self._fencing_token = 1
        if data_dir:
            self._load_snapshot()
            self._replay_wal()
            self._wal = _Wal(self._wal_path())
        self._server = RpcServer(port=port, ioloop=self._ioloop)
        self._server.add_handler(self)
        self._server.start()
        self._reaper_task = self._ioloop.run_coro(self._reap_sessions())
        self._snapshot_task = (
            self._ioloop.run_coro(self._snapshot_loop()) if data_dir else None
        )
        if self._standby:
            self._standby_task = self._ioloop.run_coro(self._standby_loop())

    # -- durability --------------------------------------------------------

    def _snapshot_path(self) -> str:
        import os

        return os.path.join(self._data_dir, "coordinator_state.json")

    def _wal_path(self) -> str:
        import os

        return os.path.join(self._data_dir, "coordinator_wal.log")

    def _load_snapshot(self) -> None:
        import json
        import os

        os.makedirs(self._data_dir, exist_ok=True)
        try:
            with open(self._snapshot_path(), "r") as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return
        with self._lock:
            self._fencing_token = max(
                self._fencing_token, int(raw.get("ftoken", 1)))
            for path, entry in raw.get("nodes", {}).items():
                node = _Node(bytes.fromhex(entry["value"]), None)
                node.version = entry["version"]
                node.seq_counter = entry.get("seq", 0)
                self._nodes[path] = node

    def _replay_wal(self) -> None:
        """Apply WAL records on top of the snapshot. Records hold absolute
        resulting state, so re-applying ones already captured by the
        snapshot is harmless. Ephemeral creates are skipped — those
        sessions died with the process (standby APPLY differs: see
        _apply_record_locked)."""
        with self._lock:
            for rec in _Wal.replay(self._wal_path()):
                self._apply_record_locked(rec, include_ephemeral=False)

    def _record(self, rec: dict, durable: bool = True):
        """Called under self._lock for EVERY state mutation. Appends the
        record to the replication stream ring (standbys tail it — session
        lifecycle and ephemerals included), and, when ``durable``, to the
        WAL. Returns a durability future (or None); the handler must
        await it BEFORE acknowledging. Setting _dirty here — under the
        lock, atomically with the enqueue — is what makes snapshot
        truncation safe: the snapshot loop only truncates when the flag
        was clear under the same lock, which implies no un-snapshotted
        record exists."""
        self._mut_index += 1
        self._recent.append((self._mut_index, rec))
        if not durable or self._wal is None:
            return None
        self._dirty = True
        return self._wal.append_async(rec)

    def _signal_stream(self) -> None:
        """Wake parked repl_updates long-polls (ioloop thread only)."""
        self._stream_event.set()
        self._stream_event = asyncio.Event()

    async def _await_standby_ack(self, idx: int) -> None:
        """Semi-sync wait: block the ack until min_sync_standbys have
        pulled past ``idx`` (or the — possibly degraded — timeout).
        Quorum mode instead requires floor(N/2) standby acks and FAILS
        the mutation on timeout (QUORUM_LOST) — availability is
        sacrificed, majority durability is not."""
        quorum = self._quorum_size > 0
        need = self._quorum_size // 2 if quorum else self._min_sync_standbys
        if need <= 0 or self._standby:
            return
        timeout = (
            0.01 if not quorum
            and self._ack_timeouts_in_a_row >= self._ack_degrade_after
            else self._ack_timeout
        )
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                have = sum(
                    1 for v in self._standby_acked.values() if v >= idx
                )
                if have >= need:
                    self._ack_timeouts_in_a_row = 0
                    return
                ev = self._ack_event
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._on_ack_timeout(quorum, idx)
                return
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                self._on_ack_timeout(quorum, idx)
                return

    def _on_ack_timeout(self, quorum: bool, idx: int) -> None:
        self._ack_timeouts_in_a_row += 1
        Stats.get().incr("coordinator.sync_ack_timeouts")
        if quorum:
            # The mutation is applied + WAL'd locally but NOT majority-
            # replicated; the client must treat it as failed (it may
            # still surface after a failover — same contract as a ZK
            # proposal the leader logged but never committed).
            raise RpcApplicationError(
                QUORUM_LOST,
                f"mutation {idx} not acked by "
                f"{self._quorum_size // 2} standbys")

    def _check_quorum_lease(self) -> None:
        """Quorum mode only: refuse mutations unless a majority of
        standbys pulled the stream within the lease — the fencing that
        stops a deposed primary from committing during an asymmetric
        partition."""
        if self._quorum_size <= 0:
            return
        need = self._quorum_size // 2
        now = time.monotonic()
        with self._lock:
            live = sum(
                1 for sid, t in self._standby_last_pull.items()
                if now - t <= self._leader_lease_sec
                or self._standby_parked.get(sid, 0) > 0
            )
        if live < need:
            raise RpcApplicationError(
                NOT_PRIMARY,
                f"quorum lease lost: {live}/{need} standbys in contact")

    @staticmethod
    async def _await_durable(futs: list) -> None:
        """Block the ack on WAL fsync; translate failure to an RPC error.
        The writer resolves batches in FIFO order, so awaiting each
        future (usually just one) is cheap."""
        for fut in futs:
            if fut is None:
                continue
            try:
                await asyncio.wrap_future(fut)
            except Exception as e:
                raise RpcApplicationError(
                    "WAL_ERROR", f"mutation not durable: {e!r}")

    def _write_snapshot(self) -> None:
        # one writer end to end: a second snapshotter parks here until
        # the first finishes its write+truncate, then re-reads fresh
        # state (or sees _dirty clear and no-ops)
        with self._snapshot_mutex:
            self._write_snapshot_locked()

    def _write_snapshot_locked(self) -> None:
        import json

        from ..utils.misc import write_file_atomic

        if self._wal is not None and self._wal.failed is not None:
            return  # fenced: memory may hold never-acked state
        with self._lock:
            if not self._dirty:
                return
            self._dirty = False
            nodes = {
                path: {
                    "value": node.value.hex(),
                    "version": node.version,
                    # preserve sequential-node counters across restarts
                    "seq": node.seq_counter,
                }
                for path, node in self._nodes.items()
                if node.ephemeral_owner is None
            }
            ftoken = self._fencing_token
        write_file_atomic(
            self._snapshot_path(),
            json.dumps({"nodes": nodes, "ftoken": ftoken}).encode("utf-8"),
        )
        # The snapshot now covers everything in the WAL; truncate it —
        # unless a mutation landed meanwhile (_dirty set under the lock
        # with its WAL append), in which case the next cycle handles it.
        # (Crash between the two steps just replays idempotent records.)
        fut = None
        with self._lock:
            if self._wal is not None and not self._dirty:
                fut = self._wal.reset_async()
        if fut is not None:
            try:
                fut.result(timeout=10)
            except Exception:
                log.exception("coordinator WAL truncation failed")

    async def _snapshot_loop(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            if self._wal is not None and self._wal.failed is not None:
                # fenced WAL: in-memory state may hold never-acked
                # mutations — do NOT persist it
                continue
            try:
                # off-loop: the snapshot's atomic write fsyncs (file +
                # dir) and its WAL-truncate future wait would otherwise
                # stall every session/heartbeat sharing this loop for
                # tens of ms per cycle (rstpu-check loop-blocking)
                await asyncio.get_running_loop().run_in_executor(
                    None, self._write_snapshot)
            except Exception:
                log.exception("coordinator snapshot failed")

    def _mark_dirty(self) -> None:
        if self._data_dir:
            self._dirty = True

    @property
    def port(self) -> int:
        return self._server.port

    def stop(self) -> None:
        self._reaper_task.cancel()
        if self._standby_task is not None:
            self._standby_task.cancel()
            self._standby_task = None
        if self._snapshot_task is not None:
            self._snapshot_task.cancel()
            try:
                self._write_snapshot()
            except Exception:
                pass
        if self._sync_pool is not None:
            pool, self._sync_pool = self._sync_pool, None
            try:
                self._ioloop.run_sync(pool.close(), timeout=5)
            except Exception:
                pass
        self._server.stop()
        if self._wal is not None:
            self._wal.close()

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    @staticmethod
    def _norm(path: str) -> str:
        if not path.startswith("/"):
            raise RpcApplicationError(NO_NODE, f"bad path {path!r}")
        return "/" + "/".join(p for p in path.split("/") if p)

    @staticmethod
    def _parent(path: str) -> str:
        return path.rsplit("/", 1)[0] or "/"

    def _signal_change(self, *paths: str) -> None:
        self._global_version += 1
        self._mark_dirty()
        self._signal_stream()
        for path in paths:
            ev = self._change_event.get(path)
            if ev is not None:
                ev.set()
                self._change_event.pop(path, None)

    async def _wait_change(self, path: str, timeout: float) -> None:
        ev = self._change_event.get(path)
        if ev is None:
            ev = asyncio.Event()
            self._change_event[path] = ev
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    def _check_session(self, sid: int) -> None:
        if sid and sid not in self._sessions:
            raise RpcApplicationError(NO_SESSION, str(sid))

    def _check_primary(self) -> None:
        if self._standby:
            up = f"{self._upstream[0]}:{self._upstream[1]}" \
                if self._upstream else ""
            raise RpcApplicationError(NOT_PRIMARY, up)

    async def _reap_sessions(self) -> None:
        while True:
            await asyncio.sleep(self._ttl / 3)
            if self._standby:
                continue  # replicated deadlines are inf until promote
            try:
                # delay = a stalled reaper (sessions outlive their TTL);
                # fail = a reap pass lost — both must only postpone
                # expiry, never wedge the loop
                await fp.async_hit("coordinator.reap")
            except OSError:
                continue
            now = time.monotonic()
            with self._lock:
                dead = [s for s, dl in self._sessions.items() if dl < now]
                for sid in dead:
                    del self._sessions[sid]
                touched: Set[str] = set()
                if dead:
                    dead_set = set(dead)
                    for path in [
                        p for p, n in self._nodes.items()
                        if n.ephemeral_owner in dead_set
                    ]:
                        del self._nodes[path]
                        touched.add(path)
                        touched.add(self._parent(path))
                    for sid in dead:
                        self._record({"op": "expire_session", "sid": sid},
                                     durable=False)
            for sid in dead:
                log.info("coordinator: session %d expired", sid)
            if dead:
                self._signal_change(*touched)

    # ------------------------------------------------------------------
    # session RPCs
    # ------------------------------------------------------------------

    async def handle_create_session(self, ttl: Optional[float] = None) -> dict:
        self._check_primary()
        self._check_quorum_lease()
        sid = next(self._session_ids)
        with self._lock:
            self._sessions[sid] = time.monotonic() + (ttl or self._ttl)
            self._max_sid_seen = max(self._max_sid_seen, sid)
            self._record({"op": "create_session", "sid": sid}, durable=False)
            sync_idx = self._mut_index
        self._signal_stream()
        await self._await_standby_ack(sync_idx)
        return {"session_id": sid, "ttl": ttl or self._ttl,
                "ftoken": self._fencing_token}

    async def handle_heartbeat(self, session_id: int = 0) -> dict:
        # dropped/stalled heartbeats are how chaos drives REAL session
        # expiry end to end (participant retry → TTL lapse → ephemeral
        # teardown → failover), not a simulated shortcut
        await fp.async_hit("coordinator.heartbeat")
        self._check_primary()
        # A minority-partitioned quorum primary must NOT keep sessions
        # (and their ephemeral lock nodes) alive: the majority side will
        # expire them and re-grant the locks — two holders otherwise.
        self._check_quorum_lease()
        with self._lock:
            if session_id not in self._sessions:
                raise RpcApplicationError(NO_SESSION, str(session_id))
            self._sessions[session_id] = time.monotonic() + self._ttl
        return {"ftoken": self._fencing_token}

    async def handle_close_session(self, session_id: int = 0) -> dict:
        self._check_primary()
        # mutates the tree (drops ephemerals): same lease gate as every
        # other mutation — a minority primary must not diverge its stream
        self._check_quorum_lease()
        with self._lock:
            self._sessions.pop(session_id, None)
            touched: Set[str] = set()
            for path in [
                p for p, n in self._nodes.items()
                if n.ephemeral_owner == session_id
            ]:
                del self._nodes[path]
                touched.add(path)
                touched.add(self._parent(path))
            self._record({"op": "close_session", "sid": session_id},
                         durable=False)
            sync_idx = self._mut_index
        self._signal_change(*touched)
        await self._await_standby_ack(sync_idx)
        return {"ftoken": self._fencing_token}

    # ------------------------------------------------------------------
    # node RPCs
    # ------------------------------------------------------------------

    async def handle_create(
        self, path: str = "", value: bytes = b"", ephemeral: bool = False,
        sequential: bool = False, session_id: int = 0,
        make_parents: bool = True,
    ) -> dict:
        self._check_primary()
        self._check_quorum_lease()
        path = self._norm(path)
        value = bytes(value)
        with self._lock:
            if ephemeral:
                self._check_session(session_id)
            parent = self._parent(path)
            created_parents: List[str] = []
            if parent not in self._nodes:
                if not make_parents:
                    raise RpcApplicationError(NO_NODE, parent)
                # materialize missing ancestors (persistent)
                parts = [p for p in parent.split("/") if p]
                cur = ""
                for p in parts:
                    cur += "/" + p
                    if cur not in self._nodes:
                        self._nodes[cur] = _Node(b"", None)
                        created_parents.append(cur)
            seq = None
            if sequential:
                pnode = self._nodes[parent]
                seq = pnode.seq_counter
                pnode.seq_counter += 1
                path = f"{path}{seq:010d}"
            if path in self._nodes:
                raise RpcApplicationError(NODE_EXISTS, path)
            self._nodes[path] = _Node(
                value, session_id if ephemeral else None
            )
            # WAL before ack. Ephemeral nodes die with the restart anyway,
            # but materialized persistent ancestors and sequential suffix
            # consumption ARE durable changes (lock ordering must never
            # regress across restarts). The stream gets every record —
            # standbys replicate ephemerals (incl. values) too.
            futs = [
                self._record({
                    "op": "create", "path": p, "value": "",
                    "ephemeral": False, "seq": None,
                })
                for p in created_parents
            ]
            futs.append(self._record(
                {
                    "op": "create", "path": path, "value": value.hex(),
                    "ephemeral": bool(ephemeral), "seq": seq,
                    "sid": session_id if ephemeral else None,
                },
                durable=not (ephemeral and seq is None),
            ))
            sync_idx = self._mut_index
        await self._await_durable(futs)
        # Wake parked standby long-polls BEFORE waiting for their ack —
        # otherwise a standby sitting in repl_updates cannot see the
        # mutation it must ack until its poll timeout, and every mutation
        # burns the full ack_timeout (matching handle_create_session).
        self._signal_stream()
        try:
            await self._await_standby_ack(sync_idx)
        finally:
            # even on QUORUM_LOST the node EXISTS locally (and may yet be
            # majority-replicated) — parked watchers must still fire
            self._signal_change(path, self._parent(path))
        return {"path": path, "ftoken": self._fencing_token}

    async def handle_get(self, path: str = "") -> dict:
        path = self._norm(path)
        with self._lock:
            node = self._nodes.get(path)
            if node is None:
                raise RpcApplicationError(NO_NODE, path)
            # ftoken on reads too: a client that has outgrown a deposed
            # primary rotates instead of consuming its stale tree
            return {"value": node.value, "version": node.version,
                    "ftoken": self._fencing_token}

    async def handle_exists(self, path: str = "") -> dict:
        path = self._norm(path)
        with self._lock:
            node = self._nodes.get(path)
            return {
                "exists": node is not None,
                "version": node.version if node else -1,
                "ftoken": self._fencing_token,
            }

    async def handle_set(
        self, path: str = "", value: bytes = b"", expected_version: int = -1
    ) -> dict:
        self._check_primary()
        self._check_quorum_lease()
        path = self._norm(path)
        value = bytes(value)
        with self._lock:
            node = self._nodes.get(path)
            if node is None:
                raise RpcApplicationError(NO_NODE, path)
            if expected_version >= 0 and node.version != expected_version:
                raise RpcApplicationError(
                    BAD_VERSION, f"{path}: {node.version} != {expected_version}"
                )
            node.value = value
            node.version += 1
            version = node.version
            futs = [self._record(
                {"op": "set", "path": path, "value": value.hex(),
                 "version": version},
                durable=node.ephemeral_owner is None,
            )]
            sync_idx = self._mut_index
        await self._await_durable(futs)
        self._signal_stream()  # wake standby long-polls before the ack wait
        try:
            await self._await_standby_ack(sync_idx)
        finally:
            self._signal_change(path)  # applied even if QUORUM_LOST
        return {"version": version, "ftoken": self._fencing_token}

    async def handle_delete(
        self, path: str = "", expected_version: int = -1,
        recursive: bool = False,
    ) -> dict:
        self._check_primary()
        self._check_quorum_lease()
        path = self._norm(path)
        with self._lock:
            node = self._nodes.get(path)
            if node is None:
                raise RpcApplicationError(NO_NODE, path)
            if expected_version >= 0 and node.version != expected_version:
                raise RpcApplicationError(BAD_VERSION, path)
            prefix = path + "/"
            children = [p for p in self._nodes if p.startswith(prefix)]
            if children and not recursive:
                raise RpcApplicationError(NOT_EMPTY, path)
            durable = node.ephemeral_owner is None or any(
                self._nodes[p].ephemeral_owner is None for p in children
            )
            for p in children:
                del self._nodes[p]
            del self._nodes[path]
            futs = [self._record({"op": "delete", "path": path},
                                 durable=durable)]
            sync_idx = self._mut_index
        await self._await_durable(futs)
        self._signal_stream()  # wake standby long-polls before the ack wait
        try:
            await self._await_standby_ack(sync_idx)
        finally:
            self._signal_change(path, self._parent(path))  # applied even
            # if QUORUM_LOST
        return {"ftoken": self._fencing_token}

    async def handle_multi(self, ops: Optional[list] = None) -> dict:
        """ZK multi() parity: an all-or-nothing batch of mutations.
        Each op is {"op": "create"|"set"|"delete"|"check", "path": ...}
        with the per-op fields of the single-op RPCs (create: value/
        ephemeral/sequential/session_id; set: value/expected_version;
        delete: expected_version/recursive; check: expected_version).
        EVERY op is validated under one lock hold before ANY is applied —
        failure returns the failing op's index and error with no state
        change. Election/lock recipes use this for check-and-act steps
        that single CAS ops cannot express atomically."""
        self._check_primary()
        self._check_quorum_lease()
        ops = ops or []
        results: List[dict] = []
        with self._lock:
            # Phase 1: simulate the WHOLE batch on a shadow view —
            # (version, exists) per path, seeded from the live tree — so
            # later ops observe earlier ops' effects exactly as the apply
            # phase will produce them (ZK multi semantics: ops apply in
            # order; version checks chain through intra-batch bumps,
            # deletes remove whole subtrees, creates materialize full
            # ancestor chains).
            view: Dict[str, int] = {
                p: n.version for p, n in self._nodes.items()
            }

            def ancestors(path):
                parts = [p for p in path.split("/") if p]
                cur_path = ""
                out = []
                for part in parts[:-1]:
                    cur_path += "/" + part
                    out.append(cur_path)
                return out

            for i, op in enumerate(ops):
                kind = op.get("op")
                path = self._norm(op.get("path", ""))
                try:
                    if kind == "check":
                        if path not in view:
                            raise RpcApplicationError(NO_NODE, path)
                        ev = int(op.get("expected_version", -1))
                        if ev >= 0 and view[path] != ev:
                            raise RpcApplicationError(BAD_VERSION, path)
                    elif kind == "create":
                        if op.get("ephemeral"):
                            self._check_session(
                                int(op.get("session_id", 0)))
                        if op.get("sequential"):
                            raise RpcApplicationError(
                                "BAD_OP",
                                "sequential not supported inside multi")
                        if path in view:
                            raise RpcApplicationError(NODE_EXISTS, path)
                        for anc in ancestors(path):
                            view.setdefault(anc, 0)
                        view[path] = 0
                    elif kind == "set":
                        if path not in view:
                            raise RpcApplicationError(NO_NODE, path)
                        ev = int(op.get("expected_version", -1))
                        if ev >= 0 and view[path] != ev:
                            raise RpcApplicationError(BAD_VERSION, path)
                        view[path] += 1
                    elif kind == "delete":
                        if path not in view:
                            raise RpcApplicationError(NO_NODE, path)
                        ev = int(op.get("expected_version", -1))
                        if ev >= 0 and view[path] != ev:
                            raise RpcApplicationError(BAD_VERSION, path)
                        prefix = path + "/"
                        kids = [p for p in view if p.startswith(prefix)]
                        if kids and not op.get("recursive"):
                            raise RpcApplicationError(NOT_EMPTY, path)
                        for p in kids:
                            del view[p]
                        del view[path]
                    else:
                        raise RpcApplicationError(
                            "BAD_OP", f"unknown multi op {kind!r}")
                except RpcApplicationError as e:
                    raise RpcApplicationError(
                        e.code,
                        f"multi op {i} ({kind} {path}): {e.message}")
            # phase 2: apply — cannot fail after validation (every apply
            # step below mirrors a validated view transition)
            futs = []
            touched: List[str] = []
            for op in ops:
                kind = op.get("op")
                path = self._norm(op.get("path", ""))
                if kind == "check":
                    results.append({"op": "check", "path": path})
                    continue
                if kind == "create":
                    # full ancestor chain, matching single-op create and
                    # the standby's replay (divergence otherwise)
                    for anc in ancestors(path):
                        if anc not in self._nodes:
                            self._nodes[anc] = _Node(b"", None)
                            futs.append(self._record({
                                "op": "create", "path": anc, "value": "",
                                "ephemeral": False, "seq": None}))
                            touched.append(anc)
                    value = bytes(op.get("value", b""))
                    eph = bool(op.get("ephemeral"))
                    sid = int(op.get("session_id", 0))
                    self._nodes[path] = _Node(value, sid if eph else None)
                    futs.append(self._record(
                        {"op": "create", "path": path,
                         "value": value.hex(), "ephemeral": eph,
                         "seq": None, "sid": sid if eph else None},
                        durable=not eph))
                    results.append({"op": "create", "path": path})
                elif kind == "set":
                    node = self._nodes[path]
                    node.value = bytes(op.get("value", b""))
                    node.version += 1
                    futs.append(self._record(
                        {"op": "set", "path": path,
                         "value": node.value.hex(),
                         "version": node.version},
                        durable=node.ephemeral_owner is None))
                    results.append({"op": "set", "path": path,
                                    "version": node.version})
                elif kind == "delete":
                    prefix = path + "/"
                    for p in [q for q in self._nodes
                              if q.startswith(prefix)]:
                        del self._nodes[p]
                        touched.append(p)
                    del self._nodes[path]
                    futs.append(self._record({"op": "delete",
                                              "path": path}))
                    results.append({"op": "delete", "path": path})
                touched.append(path)
                touched.append(self._parent(path))
            sync_idx = self._mut_index
        await self._await_durable(futs)
        self._signal_stream()
        try:
            await self._await_standby_ack(sync_idx)
        finally:
            if touched:
                self._signal_change(*touched)
        return {"results": results, "ftoken": self._fencing_token}

    async def handle_list(self, path: str = "") -> dict:
        path = self._norm(path)
        with self._lock:
            if path != "/" and path not in self._nodes:
                raise RpcApplicationError(NO_NODE, path)
            prefix = path if path.endswith("/") else path + "/"
            children = sorted({
                p[len(prefix):].split("/", 1)[0]
                for p in self._nodes
                if p.startswith(prefix)
            })
        return {"children": children, "ftoken": self._fencing_token}

    async def handle_watch(
        self, path: str = "", known_version: int = -2,
        max_wait_ms: int = 10_000,
    ) -> dict:
        """Long-poll: returns when the node (or its children) changed vs
        ``known_version`` (use the ``cversion`` from the previous call), or
        on timeout. version -1 = node absent."""
        path = self._norm(path)

        def snapshot():
            with self._lock:
                node = self._nodes.get(path)
                prefix = path if path.endswith("/") else path + "/"
                children = sorted({
                    p[len(prefix):].split("/", 1)[0]
                    for p in self._nodes if p.startswith(prefix)
                })
                version = node.version if node else -1
                cver = hash((version, tuple(children))) & 0x7FFFFFFF
                return {
                    "exists": node is not None,
                    "value": node.value if node else b"",
                    "version": version,
                    "children": children,
                    "cversion": cver,
                }

        snap = snapshot()
        if known_version != -2 and snap["cversion"] == known_version:
            # parked long-poll by design: the enclosing rpc.server root
            # must not be tail-kept as a slow outlier
            root = current_span()
            if root is not None:
                root.annotate(tail_exempt="watch_longpoll")
            await self._wait_change(path, max_wait_ms / 1000.0)
            snap = snapshot()
        return snap

    # ------------------------------------------------------------------
    # replication: primary-side RPCs
    # ------------------------------------------------------------------

    async def handle_sync(self, timeout_ms: int = 10_000) -> dict:
        """ZK sync() parity: on a STANDBY, block until this replica has
        applied everything the upstream primary had committed when the
        call arrived — a read issued after sync() therefore observes
        every write acked before it, even when the client's reads were
        rotated onto a standby. On the primary it is a no-op. (As with
        ZK, the guarantee is relative to the CURRENT upstream: across a
        primary restart the standby full-transfers and indices re-align
        before acks resume.)"""
        if not self._standby:
            return {"index": self._mut_index,
                    "ftoken": self._fencing_token}
        deadline = time.monotonic() + timeout_ms / 1000  # ONE budget for
        # the upstream probe AND the catch-up wait
        host, port = self._upstream
        if self._sync_pool is None:
            self._sync_pool = RpcClientPool()
        pos = await self._sync_pool.call(
            host, port, "repl_position", {},
            timeout=max(1.0, deadline - time.monotonic()))
        target = int(pos["mut_index"])
        while True:
            with self._lock:
                if self._mut_index >= target:
                    return {"index": self._mut_index,
                            "ftoken": self._fencing_token}
                ev = self._stream_event
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RpcApplicationError(
                    "SYNC_TIMEOUT",
                    f"applied {self._mut_index} < upstream {target}")
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                pass

    async def handle_repl_state(self) -> dict:
        """Full state transfer for a (re)joining standby: every node
        (ephemerals included, with owners), live session ids, sequence
        counters, and the (epoch, index) to resume from."""
        with self._lock:
            # copy under the lock, serialize after releasing it — the
            # hex-encode of a large tree must not stall writes/heartbeats
            raw_nodes = [
                (p, n.value, n.version, n.seq_counter, n.ephemeral_owner)
                for p, n in self._nodes.items()
            ]
            sessions = sorted(self._sessions)
            max_sid = self._max_sid_seen
            next_index = self._mut_index + 1
        return {
            "nodes": [
                {"path": p, "value": v.hex(), "version": ver,
                 "seq": seq, "sid": sid}
                for p, v, ver, seq, sid in raw_nodes
            ],
            "sessions": sessions,
            "max_sid": max_sid,
            "next_index": next_index,
            "epoch": self._epoch,
            "ftoken": self._fencing_token,
        }

    async def handle_ensemble(self) -> dict:
        """Ensemble discovery (ZK dynamic-config analog): the serving
        addresses of every standby in recent lease contact. A client
        configured with ONE endpoint learns the rest and can fail over
        without static fallback lists."""
        now = time.monotonic()
        window = max(self._leader_lease_sec, 15.0)
        with self._lock:
            live = {
                sid: addr for sid, addr in self._standby_addrs.items()
                if now - self._standby_last_pull.get(sid, 0) <= window * 10
                or self._standby_parked.get(sid, 0) > 0
            }
            # prune long-dead ids (a crash-looping standby mints a fresh
            # id per restart; the dict must not grow unboundedly)
            self._standby_addrs = live
            standbys = sorted({
                addr for sid, addr in live.items()
                if now - self._standby_last_pull.get(sid, 0) <= window
                or self._standby_parked.get(sid, 0) > 0
            })
        # a STANDBY also advertises its upstream: a client that only
        # knows standbys can still find the primary
        upstream = ""
        if self._standby and self._upstream:
            upstream = f"{self._upstream[0]}:{self._upstream[1]}"
        return {"standbys": standbys, "is_standby": self._standby,
                "primary": upstream, "ftoken": self._fencing_token}

    async def handle_repl_position(self) -> dict:
        """Election probe: (fencing token, mutation index, role). The
        failover helper promotes the reachable standby with the highest
        (ftoken, mut_index) — the ZK highest-zxid-wins analog."""
        with self._lock:
            return {
                "ftoken": self._fencing_token,
                "mut_index": self._mut_index,
                "standby": self._standby,
            }

    async def handle_repl_updates(
        self, from_index: int = 1, max_wait_ms: int = 10_000,
        max_updates: int = 500, epoch: str = "", standby_id: str = "",
        standby_addr: str = "",
    ) -> dict:
        """Long-poll the mutation stream from ``from_index`` within
        ``epoch``. Returns ``reset=True`` when the epoch doesn't match
        this server instance or the ring no longer covers the index (the
        standby full-transfers and resumes). ``standby_id`` makes the
        pull an ACK: requesting from_index implies everything before it
        was received — the semi-sync wait watches these (the same
        implicit-ACK design as the replication plane's seq pulls)."""
        if max_wait_ms > 0:
            # long-poll serve by design — never tail-keep its root
            root = current_span()
            if root is not None:
                root.annotate(tail_exempt="repl_updates_longpoll")
        if standby_id:
            with self._lock:
                # lease contact counts even before the epoch handshake
                # completes (a full-transferring standby is in contact)
                self._standby_last_pull[standby_id] = time.monotonic()
                if standby_addr:
                    self._standby_addrs[standby_id] = standby_addr
                if epoch == self._epoch:
                    prev = self._standby_acked.get(standby_id, 0)
                    self._standby_acked[standby_id] = max(
                        prev, from_index - 1)
            if epoch == self._epoch:
                self._ack_event.set()
                self._ack_event = asyncio.Event()
        deadline = time.monotonic() + max_wait_ms / 1000.0
        # A standby PARKED in this long-poll is in contact by definition:
        # count it for the quorum lease for the whole poll (its
        # _standby_last_pull stamp otherwise ages up to max_wait_ms,
        # letting a healthy primary spuriously lose its lease), and
        # refresh the stamp on the way out.
        if standby_id:
            self._standby_parked[standby_id] = (
                self._standby_parked.get(standby_id, 0) + 1)
        try:
            while True:
                with self._lock:
                    ring_start = (
                        self._recent[0][0] if self._recent
                        else self._mut_index + 1
                    )
                    if (
                        epoch != self._epoch
                        or from_index < ring_start
                        or from_index > self._mut_index + 1
                    ):
                        return {"reset": True, "updates": [], "indices": [],
                                "ftoken": self._fencing_token}
                    updates = [
                        (i, r) for i, r in self._recent if i >= from_index
                    ][:max_updates]
                    if updates:
                        return {
                            "reset": False,
                            "updates": [r for _, r in updates],
                            "indices": [i for i, _ in updates],
                            "ftoken": self._fencing_token,
                        }
                    ev = self._stream_event
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"reset": False, "updates": [], "indices": [],
                            "ftoken": self._fencing_token}
                try:
                    await asyncio.wait_for(ev.wait(), remaining)
                except asyncio.TimeoutError:
                    return {"reset": False, "updates": [], "indices": [],
                            "ftoken": self._fencing_token}
        finally:
            if standby_id:
                n = self._standby_parked.get(standby_id, 1) - 1
                if n <= 0:
                    self._standby_parked.pop(standby_id, None)
                else:
                    self._standby_parked[standby_id] = n
                self._standby_last_pull[standby_id] = time.monotonic()

    # ------------------------------------------------------------------
    # replication: standby side
    # ------------------------------------------------------------------

    def _apply_record_locked(self, rec: dict,
                             include_ephemeral: bool) -> Set[str]:
        """Apply one stream/WAL record; returns touched paths for watch
        signalling. WAL replay passes include_ephemeral=False (ephemerals
        die with the process that owned the sessions); standby apply
        passes True (it mirrors the primary's live state)."""
        op = rec.get("op")
        touched: Set[str] = set()
        if op == "create":
            parent = self._parent(rec["path"])
            parts = [p for p in parent.split("/") if p]
            cur = ""
            for p in parts:
                cur += "/" + p
                if cur not in self._nodes:
                    self._nodes[cur] = _Node(b"", None)
                    touched.add(cur)
            if rec.get("seq") is not None:
                pnode = self._nodes.get(parent)
                if pnode is not None:
                    pnode.seq_counter = max(
                        pnode.seq_counter, rec["seq"] + 1)
            if not rec.get("ephemeral"):
                node = self._nodes.setdefault(rec["path"], _Node(b"", None))
                node.value = bytes.fromhex(rec["value"])
                touched.add(rec["path"])
            elif include_ephemeral:
                self._nodes[rec["path"]] = _Node(
                    bytes.fromhex(rec["value"]), rec.get("sid"))
                touched.add(rec["path"])
            touched.add(parent)
        elif op == "set":
            node = self._nodes.get(rec["path"])
            if node is not None:
                node.value = bytes.fromhex(rec["value"])
                node.version = rec["version"]
                touched.add(rec["path"])
        elif op == "delete":
            prefix = rec["path"] + "/"
            for p in [q for q in self._nodes if q.startswith(prefix)]:
                del self._nodes[p]
                touched.add(p)
            if self._nodes.pop(rec["path"], None) is not None:
                touched.add(rec["path"])
            touched.add(self._parent(rec["path"]))
        elif op == "create_session":
            sid = rec["sid"]
            self._max_sid_seen = max(self._max_sid_seen, sid)
            # deadline inf until promote: a standby cannot observe the
            # owner's heartbeats, so it must not expire anything
            self._sessions[sid] = float("inf")
        elif op in ("close_session", "expire_session"):
            sid = rec["sid"]
            self._sessions.pop(sid, None)
            for p in [
                q for q, n in self._nodes.items()
                if n.ephemeral_owner == sid
            ]:
                del self._nodes[p]
                touched.add(p)
                touched.add(self._parent(p))
        return touched

    def _apply_stream_batch(self, updates: List[dict],
                            indices: List[int]) -> None:
        touched: Set[str] = set()
        with self._lock:
            for rec, idx in zip(updates, indices):
                touched |= self._apply_record_locked(
                    rec, include_ephemeral=True)
                self._mut_index = idx
                self._recent.append((idx, rec))
                # persist what the primary persists (same durability
                # filter) so a promoted standby restarts like a primary
                durable = (
                    rec.get("op") in ("set", "delete")
                    or (rec.get("op") == "create"
                        and not (rec.get("ephemeral")
                                 and rec.get("seq") is None))
                )
                if durable and self._wal is not None:
                    self._dirty = True
                    fut = self._wal.append_async(rec)
                    fut.add_done_callback(self._on_standby_wal_write)
        if touched:
            self._signal_change(*touched)
        else:
            self._signal_stream()

    def _on_standby_wal_write(self, fut) -> None:
        """A fenced WAL on a standby must be LOUD: persistence has
        stopped while replication looks healthy, and a later promote +
        restart would lose everything since the last snapshot. promote()
        refuses while the WAL is failed (force=True overrides)."""
        exc = fut.exception()
        if exc is not None and not getattr(self, "_wal_fail_logged", False):
            self._wal_fail_logged = True
            log.error(
                "coordinator standby: WAL append failed (%r) — durable "
                "persistence has STOPPED; promote() will refuse until "
                "the WAL is healthy", exc)

    def _apply_state_transfer(self, state: dict) -> None:
        with self._lock:
            self._nodes = {"/": _Node(b"", None)}
            for ent in state["nodes"]:
                node = _Node(bytes.fromhex(ent["value"]), ent.get("sid"))
                node.version = ent["version"]
                node.seq_counter = ent.get("seq", 0)
                self._nodes[ent["path"]] = node
            self._sessions = {sid: float("inf")
                              for sid in state.get("sessions", [])}
            self._max_sid_seen = state.get("max_sid", 0)
            self._mut_index = state["next_index"] - 1
            self._recent.clear()
            self._dirty = True
        self._signal_change(*[e["path"] for e in state["nodes"]])

    async def _standby_loop(self) -> None:
        """Tail the upstream primary: full transfer, then incremental
        long-poll catch-up; optional self-promotion after a sustained
        outage (see class docstring for the split-brain caveat)."""
        from ..rpc.errors import RpcConnectionError, RpcTimeout

        from ..utils.misc import local_ip

        pool = RpcClientPool()
        host, port = self._upstream
        next_index = None
        epoch = ""
        down_since: Optional[float] = None
        # advertised once: constant for the process lifetime. A loopback
        # answer is useless to REMOTE clients; advertise nothing rather
        # than teach every client a self-pointing fallback.
        my_ip = local_ip()
        my_addr = ("" if my_ip.startswith("127.")
                   else f"{my_ip}:{self.port}")
        try:
            while self._standby:
                try:
                    if self._upstream != (host, port):
                        host, port = self._upstream  # repointed mid-loop
                        next_index = None
                    if next_index is None:
                        state = await pool.call(
                            host, port, "repl_state", {}, timeout=30)
                        self._apply_state_transfer(state)
                        next_index = state["next_index"]
                        epoch = state.get("epoch", "")
                        self._adopt_ftoken(state.get("ftoken", 0))
                        log.info(
                            "coordinator standby: state transfer done "
                            "(%d nodes, resuming at %d epoch=%s)",
                            len(state["nodes"]), next_index, epoch[:8])
                    r = await pool.call(
                        host, port, "repl_updates",
                        {"from_index": next_index, "max_wait_ms": 5000,
                         "epoch": epoch, "standby_id": self._epoch,
                         # advertise our serving endpoint so clients can
                         # discover the ensemble from any one member
                         "standby_addr": my_addr},
                        timeout=35,
                        tail_exempt=True,  # 5s long-poll by design
                    )
                    down_since = None
                    self._adopt_ftoken(r.get("ftoken", 0))
                    if r.get("reset"):
                        next_index = None
                        continue
                    if r["updates"]:
                        self._apply_stream_batch(r["updates"], r["indices"])
                        next_index = r["indices"][-1] + 1
                except asyncio.CancelledError:
                    raise
                except (RpcConnectionError, RpcTimeout, ConnectionError,
                        OSError) as e:
                    # ONLY unreachability counts toward auto-promote: an
                    # application-level error with a LIVE primary must
                    # never trigger self-promotion (split-brain)
                    now = time.monotonic()
                    down_since = down_since or now
                    outage = now - down_since
                    if (
                        self._auto_promote_after is not None
                        and outage >= self._auto_promote_after
                    ):
                        log.warning(
                            "coordinator standby: upstream %s:%d "
                            "unreachable for %.1fs — self-promoting",
                            host, port, outage)
                        await self.promote_async()
                        return
                    log.debug("coordinator standby pull error: %r", e)
                    await asyncio.sleep(0.5)
                except Exception:
                    down_since = None
                    log.exception(
                        "coordinator standby: apply/protocol error — "
                        "retrying with full state transfer")
                    next_index = None
                    await asyncio.sleep(1.0)
        finally:
            await pool.close()

    def _adopt_ftoken(self, token: int) -> None:
        if token > self._fencing_token:
            self._fencing_token = token
            self._mark_dirty()

    def promote(self, force: bool = False) -> None:
        """Standby → primary. Replicated sessions get a fresh TTL grace
        window (owners re-establish by heartbeating, as with a ZK leader
        change); session ids continue above everything ever seen; the
        fencing token is bumped STRICTLY ABOVE the old primary's, so any
        client that has talked to this primary refuses acks from the
        deposed one. Refuses while the local WAL is fenced (state since
        the last snapshot would not be durable) unless ``force``.

        Loop-side callers (the standby loop's self-promotion, the
        promote RPC) use :meth:`promote_async`, which runs the durable
        snapshot in an executor — fsyncing on the loop at the promote
        moment is exactly when heartbeats/session grants must keep
        flowing (rstpu-check loop-blocking)."""
        if self._promote_state(force):
            self._post_promote_snapshot()

    async def promote_async(self, force: bool = False) -> None:
        if self._promote_state(force):
            # shield: once promotion flipped state, the durable snapshot
            # of the bumped fencing token must complete even if THIS
            # task is cancelled (the standby loop's self-promotion is
            # cancelled by _promote_state scheduling its own teardown)
            await asyncio.shield(asyncio.get_running_loop().run_in_executor(
                None, self._post_promote_snapshot))

    def _promote_state(self, force: bool) -> bool:
        """Flip standby→primary state; True iff a transition happened."""
        if (
            not force and self._wal is not None
            and self._wal.failed is not None
        ):
            raise RuntimeError(
                f"refusing to promote with a fenced WAL "
                f"({self._wal.failed!r}); pass force=True to override")
        with self._lock:
            if not self._standby:
                return False
            self._standby = False
            grace = time.monotonic() + self._ttl
            self._sessions = {sid: grace for sid in self._sessions}
            self._session_ids = itertools.count(self._max_sid_seen + 1)
            self._standby_acked.clear()  # acks restart under MY serving
            self._standby_last_pull.clear()  # lease restarts too
            self._standby_parked.clear()
            self._standby_addrs.clear()
            self._fencing_token += 1
            self._dirty = True
        task, self._standby_task = self._standby_task, None
        if task is not None:
            try:
                current = asyncio.current_task()
            except RuntimeError:  # sync promote() off the loop thread
                current = None
            if task is not current:
                # never cancel the task running THIS promotion (standby
                # self-promotion): the scheduled cancel would land on
                # promote_async's snapshot await; the loop returns right
                # after promoting anyway
                task.cancel()
        return True

    def _post_promote_snapshot(self) -> None:
        try:
            if self._data_dir:
                self._write_snapshot()  # make the token bump durable now
        except Exception:
            log.exception("coordinator: post-promote snapshot failed")
        log.info("coordinator: promoted to primary (%d sessions in grace, "
                 "fencing token %d)",
                 len(self._sessions), self._fencing_token)

    def repoint(self, host: str, port: int) -> None:
        """Re-target a standby at a NEW upstream (after a failover
        elsewhere in the ensemble). The standby loop notices and does a
        full state transfer from the new primary."""
        if not self._standby:
            raise RuntimeError("repoint: not a standby")
        self._upstream = (host, port)

    async def handle_repoint(self, host: str = "", port: int = 0) -> dict:
        try:
            self.repoint(host, int(port))
        except RuntimeError as e:
            raise RpcApplicationError(NOT_PRIMARY, str(e))
        return {}

    async def handle_promote(self, force: bool = False) -> dict:
        """Operator/controller-driven failover for standalone standby
        processes (the in-process path calls promote() directly)."""
        try:
            await self.promote_async(force=bool(force))
        except RuntimeError as e:
            raise RpcApplicationError("WAL_ERROR", str(e))
        return {"standby": self._standby}

    @property
    def is_standby(self) -> bool:
        return self._standby


def promote_best(endpoints: List[Tuple[str, int]],
                 ioloop: Optional[IoLoop] = None,
                 timeout: float = 10.0,
                 ensemble_size: Optional[int] = None) -> Tuple[str, int]:
    """Ensemble failover (controller/operator entry point): probe every
    reachable endpoint's (ftoken, mut_index), promote the most advanced
    STANDBY — the ZK highest-zxid-wins rule — then repoint the remaining
    standbys at the winner. Returns the new primary's endpoint.

    No-acked-write-lost guarantee: a quorum-acked mutation lives on
    >= floor(N/2) standbys, so the probe must reach enough standbys to
    intersect EVERY possible ack set — ceil(N/2) of the N-1 standbys
    (with the dead primary excluded). ``ensemble_size`` is N; defaults
    to len(endpoints) + 1 (caller lists the standbys, primary is dead).
    Fewer answers than that → RuntimeError instead of silently electing
    a lagging standby and discarding acked writes. Raises RuntimeError
    too when a live primary is still reachable."""
    loop = ioloop or IoLoop.default()
    pool = RpcClientPool()
    n = ensemble_size or (len(endpoints) + 1)

    async def probe(host, port):
        try:
            r = await pool.call(host, port, "repl_position", {},
                                timeout=timeout)
            return (host, port, r)
        except Exception:
            return (host, port, None)

    async def run():
        import asyncio as aio

        try:
            results = await aio.gather(
                *(probe(h, p) for h, p in endpoints))
            live = [(h, p, r) for h, p, r in results if r is not None]
            if any(not r["standby"] for _, _, r in live):
                alive = [(h, p) for h, p, r in live if not r["standby"]]
                raise RuntimeError(
                    f"live primary still reachable at {alive}; demote or "
                    f"partition it before promoting")
            standbys = [(h, p, r) for h, p, r in live if r["standby"]]
            need = n - n // 2  # ceil(N/2): intersects every ack majority
            if len(standbys) < need:
                raise RuntimeError(
                    f"only {len(standbys)}/{need} standbys answered "
                    f"(ensemble {n}): electing now could lose "
                    f"quorum-acked writes")
            standbys.sort(
                key=lambda t: (t[2]["ftoken"], t[2]["mut_index"]),
                reverse=True)
            win_h, win_p, _ = standbys[0]
            await pool.call(win_h, win_p, "promote", {}, timeout=timeout)
            for h, p, _ in standbys[1:]:
                try:
                    await pool.call(h, p, "repoint",
                                    {"host": win_h, "port": win_p},
                                    timeout=timeout)
                except Exception:
                    log.exception(
                        "promote_best: repoint %s:%d failed", h, p)
            return (win_h, win_p)
        finally:
            await pool.close()

    return loop.run_sync(run(), timeout=timeout * (len(endpoints) + 2))


class CoordinatorClient:
    """Sync client + session keepalive + watch loops + lock/election
    recipes (the Curator equivalent)."""

    def __init__(self, host: str, port: int, ioloop: Optional[IoLoop] = None,
                 session_ttl: Optional[float] = None,
                 fallbacks: Optional[List[Tuple[str, int]]] = None):
        self._host, self._port = host, port
        # failover rotation: primary first, then standbys. A NOT_PRIMARY
        # rejection or connection failure rotates to the next endpoint
        # (sessions are replicated, so the session survives the switch).
        self._endpoints: List[Tuple[str, int]] = [(host, port)]
        self._endpoints.extend(fallbacks or [])
        self._ioloop = ioloop or IoLoop.default()
        self._pool = RpcClientPool()
        self._stop = threading.Event()
        self._hb_suspended = threading.Event()
        self._requested_ttl = session_ttl
        # highest fencing token seen from any primary; acks carrying a
        # LOWER token come from a deposed primary and are rejected
        self._max_ftoken = 0
        # fired (from the heartbeat thread) after an expired session was
        # re-established: ephemerals owned by the old session are gone —
        # owners (participants) re-register here
        self.on_session_reestablished: Optional[Callable[[], None]] = None
        r = self._call("create_session", ttl=session_ttl)
        self.session_id = r["session_id"]
        self._ttl = r["ttl"]
        self._discover_endpoints()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="coord-heartbeat", daemon=True
        )
        self._hb_thread.start()
        self._watch_threads: List[threading.Thread] = []

    # -- plumbing ---------------------------------------------------------

    # mutations must NOT be silently re-sent after a connection error:
    # the primary may have executed them before the connection died, and
    # e.g. a duplicated ephemeral-sequential lock node deadlocks every
    # other contender. A NOT_PRIMARY rejection is always retry-safe (the
    # standby executed nothing). create_session is exempt: a duplicate
    # session just expires unused.
    _UNSAFE_RETRY = frozenset({"create", "set", "delete", "multi"})

    def _call(self, method: str, timeout: float = 30.0, **args):
        # any coordinator RPC that long-polls by protocol (watch, lock
        # recipes) has a BY-DESIGN slow RTT: never tail-keep it as an
        # outlier trace
        exempt = int(args.get("max_wait_ms") or 0) > 0

        async def go(host: str, port: int):
            return await self._pool.call(
                host, port, method, args, timeout=timeout,
                tail_exempt=exempt,
            )

        last: Optional[Exception] = None
        for attempt in range(max(2 * len(self._endpoints), 1)):
            host, port = self._host, self._port
            fenced = None
            try:
                r = self._ioloop.run_sync(
                    go(host, port), timeout=timeout + 5)
                ftoken = (r or {}).get("ftoken") \
                    if isinstance(r, dict) else None
                if ftoken is None or ftoken >= self._max_ftoken:
                    if ftoken is not None:
                        self._max_ftoken = ftoken
                    return r
                # fencing: this ack came from a DEPOSED primary (a newer
                # one has a higher token) — a mutation it applied may be
                # discarded by the failover, so never report it as
                # committed. Mutations must surface the failure (the
                # deposed primary DID apply them — a blind retry
                # double-applies); reads just rotate.
                fenced = RpcApplicationError(
                    NOT_PRIMARY,
                    f"fenced: ack token {ftoken} < {self._max_ftoken}")
            except RpcApplicationError as e:
                if e.code != NOT_PRIMARY or len(self._endpoints) == 1:
                    raise
                last = e
            except RpcError as e:
                if len(self._endpoints) == 1:
                    raise
                last = e
                if method in self._UNSAFE_RETRY:
                    # rotate so the NEXT call targets a live endpoint,
                    # but surface this failure — the caller must decide
                    # whether the mutation may have been applied
                    self._rotate(host, port)
                    raise
            if fenced is not None:
                self._rotate(host, port)
                if method in self._UNSAFE_RETRY:
                    raise fenced
                last = fenced
                continue
            # rotate to the next endpoint and retry
            self._rotate(host, port)
            if attempt >= len(self._endpoints):
                time.sleep(0.3)  # full rotation failed — brief backoff
        raise last  # type: ignore[misc]

    def _discover_endpoints(self) -> None:
        """Learn the rest of the ensemble from whichever endpoint is
        serving (ZK dynamic-config analog): standbys in lease contact
        become fallback endpoints, so a client configured with one
        address survives failovers. Best-effort; static fallbacks and
        already-known endpoints are kept."""
        try:
            r = self._call("ensemble", timeout=10.0)
        except Exception:
            return
        known = list(r.get("standbys") or [])
        if r.get("primary"):
            known.append(r["primary"])
        for addr in known:
            try:
                host, port_s = addr.rsplit(":", 1)
                ep = (host, int(port_s))
            except ValueError:
                continue
            if ep not in self._endpoints:
                self._endpoints.append(ep)

    def _rotate(self, host: str, port: int) -> None:
        idx = self._endpoints.index((host, port)) \
            if (host, port) in self._endpoints else 0
        self._host, self._port = self._endpoints[
            (idx + 1) % len(self._endpoints)]

    def suspend_heartbeats(self) -> None:
        """Stop heartbeating WITHOUT closing: the server expires the
        session after its TTL — the faithful 'process wedged / GC pause /
        partitioned' simulation (chaos harness + tests). resume() lets
        the next beat discover the expiry and re-establish."""
        self._hb_suspended.set()

    def resume_heartbeats(self) -> None:
        self._hb_suspended.clear()

    def _heartbeat_loop(self) -> None:
        interval = self._ttl / 3
        beats = 0
        while not self._stop.wait(interval):
            if self._hb_suspended.is_set():
                continue
            try:
                self._call("heartbeat", session_id=self.session_id)
            except RpcApplicationError as e:
                if e.code == NO_SESSION:
                    # the session expired server-side (TTL lapse while we
                    # were wedged/partitioned): its ephemerals are gone.
                    # Re-establish rather than beating a dead session
                    # forever — the ZK session-re-establishment analog.
                    self._reestablish_session()
            except RpcError:
                pass  # reconnects on next beat; session may expire meanwhile
            except Exception:
                log.exception("coordinator heartbeat failed")
            beats += 1
            if beats % 5 == 0 or len(self._endpoints) == 1:
                # keep the ensemble view fresh: a client created before
                # any standby registered would otherwise never learn
                # its failover endpoints
                self._discover_endpoints()

    def _reestablish_session(self) -> None:
        try:
            r = self._call("create_session", ttl=self._requested_ttl)
        except Exception:
            log.exception("coordinator session re-establishment failed "
                          "(retrying on the next beat)")
            return
        old = self.session_id
        self.session_id = r["session_id"]
        self._ttl = r["ttl"]
        log.warning("coordinator session %d expired — re-established as %d",
                    old, self.session_id)
        cb = self.on_session_reestablished
        if cb is not None:
            try:
                cb()
            except Exception:
                log.exception("on_session_reestablished callback failed")

    def close(self) -> None:
        self._stop.set()
        try:
            self._call("close_session", session_id=self.session_id)
        except Exception:
            pass
        self._hb_thread.join(timeout=2.0)
        for t in self._watch_threads:
            t.join(timeout=2.0)
        self._ioloop.run_sync(self._pool.close())

    # -- node ops ---------------------------------------------------------

    def create(self, path: str, value: bytes = b"", ephemeral: bool = False,
               sequential: bool = False) -> str:
        return self._call(
            "create", path=path, value=value, ephemeral=ephemeral,
            sequential=sequential, session_id=self.session_id,
        )["path"]

    def ensure(self, path: str, value: bytes = b"") -> None:
        try:
            self.create(path, value)
        except RpcApplicationError as e:
            if e.code != NODE_EXISTS:
                raise

    def get(self, path: str) -> Tuple[bytes, int]:
        r = self._call("get", path=path)
        return bytes(r["value"]), r["version"]

    def get_or_none(self, path: str) -> Optional[bytes]:
        try:
            return self.get(path)[0]
        except RpcApplicationError as e:
            if e.code == NO_NODE:
                return None
            raise

    def set(self, path: str, value: bytes, expected_version: int = -1) -> int:
        return self._call(
            "set", path=path, value=value, expected_version=expected_version
        )["version"]

    def put(self, path: str, value: bytes) -> None:
        """create-or-set."""
        try:
            self.create(path, value)
        except RpcApplicationError as e:
            if e.code != NODE_EXISTS:
                raise
            self.set(path, value)

    def delete(self, path: str, recursive: bool = False) -> None:
        self._call("delete", path=path, recursive=recursive)

    def delete_if_exists(self, path: str, recursive: bool = False) -> None:
        try:
            self.delete(path, recursive=recursive)
        except RpcApplicationError as e:
            if e.code != NO_NODE:
                raise

    def list(self, path: str) -> List[str]:
        try:
            return self._call("list", path=path)["children"]
        except RpcApplicationError as e:
            if e.code == NO_NODE:
                return []
            raise

    def exists(self, path: str) -> bool:
        return self._call("exists", path=path)["exists"]

    def multi(self, ops: List[dict]) -> List[dict]:
        """Atomic all-or-nothing batch (ZK multi). Each op dict mirrors
        the single-op RPC fields, e.g.
        {"op": "check", "path": p, "expected_version": v},
        {"op": "create", "path": p, "value": b"..."},
        {"op": "set", "path": p, "value": b"...", "expected_version": v},
        {"op": "delete", "path": p, "recursive": True}."""
        return self._call("multi", ops=ops)["results"]

    def sync(self, timeout_ms: int = 10_000) -> int:
        """ZK sync() parity: make the endpoint this client currently
        reads from catch up with its primary before the next read —
        read-your-writes even when reads rotated onto a standby.
        Returns the endpoint's applied index."""
        # RPC timeout must cover the server-side wait budget
        return self._call("sync", timeout=timeout_ms / 1000 + 5.0,
                          timeout_ms=timeout_ms)["index"]

    # -- watches ----------------------------------------------------------

    def watch(self, path: str, callback, poll_ms: int = 5_000) -> threading.Event:
        """Fire ``callback(snapshot_dict)`` on every observed change (and
        once initially). Returns an Event; set it to stop the watch.

        Error backoff goes through the unified RetryPolicy (growing,
        jittered, deterministic under RSTPU_RETRY_SEED like the follower
        pull loop; ``retry.attempts op=coord.watch`` on /stats) instead
        of the old flat 0.5 s sleep — a control-plane outage must not be
        hammered at a fixed cadence by every watcher at once."""
        from ..utils.retry_policy import (RetryPolicy, backoff_step,
                                          seeded_rng)

        stop = threading.Event()
        policy = RetryPolicy(max_attempts=1 << 30, base_delay=0.2,
                             max_delay=2.0, floor=0.1)
        rng = seeded_rng()

        def loop():
            known = -2
            attempt = 0
            while not stop.is_set() and not self._stop.is_set():
                try:
                    snap = self._call(
                        "watch", path=path, known_version=known,
                        max_wait_ms=poll_ms, timeout=poll_ms / 1000 + 10,
                    )
                except (RpcError, RpcApplicationError):
                    backoff_step(policy, attempt, op="coord.watch", rng=rng)
                    attempt += 1
                    continue
                except Exception:
                    log.exception("watch loop error for %s", path)
                    backoff_step(policy, attempt, op="coord.watch", rng=rng)
                    attempt += 1
                    continue
                attempt = 0
                if snap["cversion"] != known:
                    known = snap["cversion"]
                    try:
                        callback(snap)
                    except Exception:
                        log.exception("watch callback failed for %s", path)

        t = threading.Thread(target=loop, name=f"watch:{path}", daemon=True)
        t.start()
        self._watch_threads.append(t)
        return stop

    # -- recipes -----------------------------------------------------------

    def acquire_lock(self, lock_path: str, timeout: float = 30.0) -> Optional[str]:
        """InterProcessMutex recipe: ephemeral sequential node; lowest wins.
        Returns my node path (pass to release_lock), or None on timeout."""
        self.ensure(lock_path)
        me = self.create(f"{lock_path}/lock-", ephemeral=True, sequential=True)
        my_name = me.rsplit("/", 1)[1]
        deadline = time.monotonic() + timeout
        known = -2  # first watch returns immediately with the snapshot
        while time.monotonic() < deadline:
            remaining = max(0.05, deadline - time.monotonic())
            wait_ms = int(min(remaining, 2.0) * 1000)
            snap = self._call(
                "watch", path=lock_path, known_version=known,
                max_wait_ms=wait_ms, timeout=wait_ms / 1000 + 10,
            )
            known = snap["cversion"]
            siblings = sorted(snap["children"])
            if siblings and siblings[0] == my_name:
                return me
        self.delete_if_exists(me)
        return None

    def release_lock(self, my_node: str) -> None:
        self.delete_if_exists(my_node)

    def elect_leader(self, election_path: str, my_id: str) -> bool:
        """Simple leader election: ephemeral node claim. True if leader."""
        self.ensure(election_path)
        try:
            self.create(f"{election_path}/leader", my_id.encode(),
                        ephemeral=True)
            return True
        except RpcApplicationError as e:
            if e.code == NODE_EXISTS:
                return False
            raise

    def current_leader(self, election_path: str) -> Optional[str]:
        raw = self.get_or_none(f"{election_path}/leader")
        return raw.decode() if raw is not None else None


def main(argv=None) -> int:
    """Standalone coordinator process (the zkServer analog)."""
    import argparse

    p = argparse.ArgumentParser(description="coordination server")
    p.add_argument("--port", type=int, default=2181)
    p.add_argument("--data_dir", default=None,
                   help="durable WAL+snapshot dir (omit for in-memory)")
    p.add_argument("--session_ttl", type=float, default=DEFAULT_SESSION_TTL)
    p.add_argument("--replica_of", default=None, metavar="HOST:PORT",
                   help="run as a standby tailing this primary")
    p.add_argument("--auto_promote_after", type=float, default=None,
                   help="standby self-promotes after the primary is "
                        "unreachable this many seconds (deploy at most "
                        "one such standby)")
    p.add_argument("--min_sync_standbys", type=int, default=0,
                   help="semi-sync: mutations ack only after this many "
                        "standbys received them (0 = async shipping)")
    args = p.parse_args(argv)
    upstream = None
    if args.replica_of:
        h, _, pt = args.replica_of.rpartition(":")
        upstream = (h, int(pt))
    srv = CoordinatorServer(port=args.port, session_ttl=args.session_ttl,
                            data_dir=args.data_dir, replica_of=upstream,
                            auto_promote_after=args.auto_promote_after,
                            min_sync_standbys=args.min_sync_standbys)
    print(f"coordinator up: port={srv.port} data_dir={args.data_dir} "
          f"standby={srv.is_standby}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
