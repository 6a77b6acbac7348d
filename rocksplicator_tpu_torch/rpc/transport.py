"""Pluggable RPC byte transports: tcp (default), uds, in-process loopback.
(The port's copy of ``rocksplicator_tpu/rpc/transport.py``.)

The reference runs its entire serving fabric on fbthrift's pluggable
channel layer — zero-copy IOBuf chains over header-protocol TCP
(common/thrift_client_pool.h), with the transport chosen per channel.
This module is that seam for our stack: everything above it
(client.py / server.py / client_pool.py) speaks ``Connection`` objects
(``send_frames`` / ``recv_frames`` / ``close``) and never touches a
socket, so the byte layer is selected per endpoint:

- **tcp** — asyncio streams, one joined write per frame (the
  ``_JOIN_MAX`` economy), TLS-capable. The default and the only
  cross-host transport.
- **uds** — unix-domain socket with VECTORED frame coalescing: every
  sender enqueues encoded frame parts (length-prefix struct, header,
  payload chunks — never joined) and a single drainer empties the whole
  pending queue into one ``sendmsg`` iovec; the receiver decodes
  multiple frames per ``recv_into`` against a reusable buffer
  (framing.FrameBuffer). Same wire format as tcp, ~0 copies above the
  kernel, and far fewer syscalls under concurrency.
- **loopback** — in-process queue pair for same-host replica
  colocation and tests: frame header/payload memoryviews are handed
  across a deque with no wire encode, no compression, and no recv copy
  — a syscall-free ceiling that de-noises small benchmark hosts.

Selection (client and server agree by construction):

- an explicit URL endpoint wins: ``tcp://host:port``,
  ``uds:///path/to.sock``, ``loopback://key``;
- else the ``RSTPU_TRANSPORT`` env policy (``tcp``|``uds``|``loopback``)
  applies to plain ``(host, port)`` addresses — ``uds`` only for
  same-host peers (socket path derived from the port, see
  ``uds_path_for_port``), ``loopback`` only within the process;
- TLS pins tcp: an ``ssl_manager`` forces the tcp transport (the
  role-binding handshake is a TLS-over-TCP contract here).

Failpoints (``rpc.connect``, ``rpc.frame.send``, ``rpc.frame.recv``,
torn frames) arm identically on all three transports: the send/recv
hits and the torn-prefix semantics live at this layer's seams.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import socket
import tempfile
from collections import deque
from dataclasses import dataclass
from typing import Awaitable, Callable, Dict, List, Optional, Sequence, Tuple

from ..testing import failpoints as fp
from ..utils.stats import Stats
from .errors import RpcTransportConfigError
from .framing import (
    FrameBuffer,
    FrameReader,
    encode_wire_parts,
    write_frame,
)

log = logging.getLogger(__name__)

# Process-wide frame counters: the fleet A/B's frames/sec
# signal — 100 per-shard pull streams vs one mux session per peer show
# up HERE first. Counted once per frame at each transport's send/recv
# choke point (thread-buffered Stats incr; negligible next to the frame
# encode itself).
M_FRAMES_SENT = "rpc.frames_sent"
M_FRAMES_RECEIVED = "rpc.frames_received"

SCHEMES = ("tcp", "uds", "loopback")

# one sendmsg's iovec cap: Linux IOV_MAX is 1024; stay comfortably under
# it (a frame contributes ≥2 iovec entries: length-prefix + header)
IOV_CAP = 512

Frame = Tuple[bytes, List[bytes]]  # (header_json, payload_chunks)
ConnectionCallback = Callable[["Connection"], Awaitable[None]]


# ---------------------------------------------------------------------------
# endpoints + selection
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Endpoint:
    scheme: str          # tcp | uds | loopback
    host: str = ""       # tcp
    port: int = 0        # tcp; also the loopback default key
    path: str = ""       # uds socket path
    key: str = ""        # loopback registry key

    def __str__(self) -> str:
        if self.scheme == "tcp":
            return f"tcp://{self.host}:{self.port}"
        if self.scheme == "uds":
            return f"uds://{self.path}"
        return f"loopback://{self.key}"


def transport_policy() -> str:
    """The process-wide default transport (``RSTPU_TRANSPORT``)."""
    v = os.environ.get("RSTPU_TRANSPORT", "").strip().lower()
    if not v:
        return "tcp"
    if v not in SCHEMES:
        raise RpcTransportConfigError(
            f"RSTPU_TRANSPORT={v!r}: unknown transport "
            f"(expected one of {'|'.join(SCHEMES)})")
    return v


def uds_default_dir() -> str:
    d = os.environ.get("RSTPU_UDS_DIR")
    if d:
        return d
    return os.path.join(
        tempfile.gettempdir(), f"rstpu-uds-{os.getuid()}")


def uds_path_for_port(port: int) -> str:
    """The well-known per-port socket path: a server that binds TCP port
    N under the uds policy also listens here, so a same-host client can
    derive the fast path from the (host, port) address alone."""
    return os.path.join(uds_default_dir(), f"{port}.sock")


_LOCAL_HOSTS = {"127.0.0.1", "localhost", "::1", "0.0.0.0", ""}


def _is_local_host(host: str) -> bool:
    if host in _LOCAL_HOSTS:
        return True
    try:
        from ..utils.misc import local_ip

        return host in (local_ip(), socket.gethostname())
    except Exception:
        return False


def parse_endpoint(url: str) -> Endpoint:
    """Parse an explicit endpoint URL (scheme://...)."""
    scheme, _, rest = url.partition("://")
    scheme = scheme.strip().lower()
    if scheme == "tcp":
        host, _, port = rest.rpartition(":")
        if not host or not port.isdigit():
            raise RpcTransportConfigError(
                f"bad tcp endpoint {url!r} (want tcp://host:port)")
        return Endpoint("tcp", host=host, port=int(port))
    if scheme == "uds":
        if not rest:
            raise RpcTransportConfigError(
                f"bad uds endpoint {url!r} (want uds:///path/to.sock)")
        # accept uds:///abs/path (canonical) and uds://abs/path
        return Endpoint(
            "uds", path=rest if rest.startswith("/") else "/" + rest)
    if scheme in ("loopback", "loop"):
        if not rest:
            raise RpcTransportConfigError(
                f"bad loopback endpoint {url!r} (want loopback://key)")
        return Endpoint("loopback", key=rest)
    raise RpcTransportConfigError(
        f"unknown transport scheme {scheme!r} in endpoint {url!r} "
        f"(expected one of {'|'.join(SCHEMES)})")


def resolve_endpoint(host: str, port: int, *, ssl: bool = False) -> Endpoint:
    """Resolve an address to a concrete endpoint: explicit URL wins, else
    the ``RSTPU_TRANSPORT`` policy applies (uds only for same-host
    peers; TLS pins tcp)."""
    if "://" in host:
        ep = parse_endpoint(host)
        if ssl and ep.scheme != "tcp":
            raise RpcTransportConfigError(
                f"TLS requires the tcp transport, got {host!r}")
        return ep
    policy = "tcp" if ssl else transport_policy()
    if policy == "uds" and _is_local_host(host):
        return Endpoint("uds", path=uds_path_for_port(port))
    if policy == "loopback" and _is_local_host(host):
        # same-host only, like uds: a remote peer can never be served by
        # this process's loopback registry, and the port-keyed endpoint
        # discards the host — falling through to tcp keeps a mixed
        # local/remote topology correct under the policy
        return Endpoint("loopback", key=str(port))
    return Endpoint("tcp", host=host, port=port)


# ---------------------------------------------------------------------------
# interface
# ---------------------------------------------------------------------------


class Connection:
    """One bidirectional frame stream. Implementations guarantee frame
    atomicity and FIFO ordering under CONCURRENT ``send_frames`` callers
    (no caller-side write lock needed — that's what lets the vectored
    transport coalesce many senders into one syscall)."""

    scheme = "?"

    async def send_frames(self, frames: Sequence[Frame]) -> None:
        raise NotImplementedError

    async def recv_frames(self) -> List[Tuple[memoryview, memoryview]]:
        """≥1 decoded (header, payload) frames, or raises
        asyncio.IncompleteReadError / ConnectionError when the stream
        ends (clean or torn)."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    async def wait_closed(self) -> None:
        pass

    def get_extra_info(self, name: str, default=None):
        return default


class Listener:
    """A bound acceptor; ``on_connection(conn)`` is spawned as a task
    per accepted peer."""

    def close(self) -> None:
        raise NotImplementedError

    async def wait_closed(self) -> None:
        pass


class Transport:
    scheme = "?"

    async def connect(self, ep: Endpoint, *, ssl_manager=None) -> Connection:
        raise NotImplementedError

    async def accept(self, ep: Endpoint, on_connection: ConnectionCallback,
                     *, ssl_manager=None) -> Listener:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# tcp — asyncio streams (the seed behavior, TLS-capable)
# ---------------------------------------------------------------------------


class TcpConnection(Connection):
    scheme = "tcp"

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._reader = FrameReader(reader)
        self._writer = writer
        # StreamWriter interleaves concurrent writes at write() call
        # granularity; serialize whole frames
        self._lock = asyncio.Lock()

    async def send_frames(self, frames: Sequence[Frame]) -> None:
        async with self._lock:
            for header, chunks in frames:
                await write_frame(self._writer, header, chunks)
        Stats.get().incr(M_FRAMES_SENT, len(frames))

    async def recv_frames(self) -> List[Tuple[memoryview, memoryview]]:
        frame = await self._reader.read_frame()
        Stats.get().incr(M_FRAMES_RECEIVED)
        return [frame]

    def close(self) -> None:
        self._writer.close()

    async def wait_closed(self) -> None:
        try:
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass

    def get_extra_info(self, name: str, default=None):
        return self._writer.get_extra_info(name, default)


class _TcpListener(Listener):
    def __init__(self, server: asyncio.AbstractServer):
        self.server = server

    @property
    def port(self) -> int:
        return self.server.sockets[0].getsockname()[1]

    def close(self) -> None:
        self.server.close()

    async def wait_closed(self) -> None:
        await self.server.wait_closed()


class TcpTransport(Transport):
    scheme = "tcp"

    async def connect(self, ep: Endpoint, *, ssl_manager=None) -> Connection:
        reader, writer = await asyncio.open_connection(
            ep.host, ep.port,
            ssl=(ssl_manager.get() if ssl_manager else None),
        )
        return TcpConnection(reader, writer)

    async def accept(self, ep: Endpoint, on_connection: ConnectionCallback,
                     *, ssl_manager=None) -> Listener:
        ssl_ctx = ssl_manager.get() if ssl_manager else None

        async def on_stream(reader, writer):
            await on_connection(TcpConnection(reader, writer))

        server = await asyncio.start_server(
            on_stream, ep.host, ep.port, ssl=ssl_ctx)
        return _TcpListener(server)


# ---------------------------------------------------------------------------
# uds — vectored sendmsg batching over a unix-domain socket
# ---------------------------------------------------------------------------


class UdsConnection(Connection):
    """Vectored frame coalescing: ``send_frames`` encodes to wire parts
    and enqueues them; ONE drainer empties the whole pending queue into
    a single ``sendmsg`` iovec (length-prefix structs interleaved with
    header/payload buffers — no join-buffer materialization). This
    generalizes the ``_JOIN_MAX`` single-write join from "one
    memcpy per frame" to "zero memcpy, one syscall per queue drain"."""

    scheme = "uds"

    def __init__(self, sock: socket.socket,
                 loop: asyncio.AbstractEventLoop):
        sock.setblocking(False)
        self._sock = sock
        self._loop = loop
        self._sendq: deque = deque()  # (parts, waiter)
        self._drainer: Optional[asyncio.Task] = None
        self._broken: Optional[BaseException] = None
        self._closed = False
        self._rbuf = FrameBuffer()
        # coalescing counters (introspection + tests): frames vs syscalls
        self.frames_sent = 0
        self.sendmsg_calls = 0
        self.frames_received = 0
        self.recv_calls = 0

    # -- send half ------------------------------------------------------

    async def send_frames(self, frames: Sequence[Frame]) -> None:
        if self._broken is not None:
            raise ConnectionResetError(
                f"uds connection is broken: {self._broken}")
        if self._closed:
            raise ConnectionResetError("uds connection is closed")
        parts: List[bytes] = []
        for header, chunks in frames:
            frame_parts, wire_len = encode_wire_parts(header, chunks)
            await fp.async_hit("rpc.frame.send")
            cut = fp.torn_point("rpc.frame.send", wire_len)
            if cut is not None:
                # torn frame: flush anything already encoded in this
                # call plus the torn prefix IN ORDER behind the queued
                # frames, then break the connection — the peer sees a
                # short/desynced stream (clean decode error there), we
                # see a failed send
                prefix = b"".join(
                    bytes(p) for p in frame_parts)[:cut]
                waiter = self._enqueue(parts + [prefix])
                try:
                    await waiter
                except (ConnectionError, OSError):
                    pass
                self._broken = ConnectionResetError("torn frame")
                try:
                    self._sock.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                raise fp.FailpointError(f"torn frame at +{cut}B")
            parts.extend(frame_parts)
            self.frames_sent += 1
        Stats.get().incr(M_FRAMES_SENT, len(frames))
        await self._enqueue(parts)

    def _enqueue(self, parts: List[bytes]) -> "asyncio.Future[None]":
        waiter: asyncio.Future = self._loop.create_future()
        # send_frames may have suspended (failpoint delay, torn flush)
        # between its entry checks and this call, with the connection
        # breaking meanwhile: a waiter enqueued now would spawn a drainer
        # whose loop condition is already false and hang forever
        err = self._broken if self._broken is not None else (
            ConnectionResetError("uds connection is closed")
            if self._closed else None)
        if err is not None:
            waiter.set_exception(
                ConnectionResetError(f"uds send failed: {err}"))
            return waiter
        self._sendq.append((parts, waiter))
        if self._drainer is None or self._drainer.done():
            self._drainer = self._loop.create_task(self._drain())
        return waiter

    async def _drain(self) -> None:
        while self._sendq and self._broken is None and not self._closed:
            batch = list(self._sendq)
            self._sendq.clear()
            iov: deque = deque()
            for parts, _w in batch:
                for p in parts:
                    if len(p):
                        iov.append(p if isinstance(p, memoryview)
                                   else memoryview(p))
            try:
                await self._sendmsg_all(iov)
            except asyncio.CancelledError:
                # close() cancels the drainer: the popped batch's waiters
                # are no longer reachable from _sendq, so fail them here
                # or their senders hang forever
                e = ConnectionResetError("connection closed")
                self._fail_batch(batch, e)
                self._fail_queued(e)
                raise
            except (ConnectionError, OSError) as e:
                self._broken = e
                self._fail_batch(batch, e)
                self._fail_queued(e)
                return
            for _parts, w in batch:
                if not w.done():
                    w.set_result(None)
        # belt and braces for the enqueue-vs-break race: anything still
        # queued when the loop exits on _broken/_closed must be failed,
        # not stranded
        if self._sendq:
            self._fail_queued(
                self._broken
                or ConnectionResetError("uds connection is closed"))

    def _fail_batch(self, batch, exc: BaseException) -> None:
        for _parts, w in batch:
            if not w.done():
                w.set_exception(
                    ConnectionResetError(f"uds send failed: {exc}"))

    def _fail_queued(self, exc: BaseException) -> None:
        while self._sendq:
            _parts, w = self._sendq.popleft()
            if not w.done():
                w.set_exception(
                    ConnectionResetError(f"uds send failed: {exc}"))

    async def _sendmsg_all(self, iov: deque) -> None:
        while iov:
            batch = list(itertools.islice(iov, IOV_CAP))
            sent = self._try_sendmsg(batch)
            if sent is None:
                await self._wait_writable()
                continue
            self.sendmsg_calls += 1
            while sent > 0:
                head = iov[0]
                if sent >= len(head):
                    sent -= len(head)
                    iov.popleft()
                else:
                    iov[0] = head[sent:]
                    sent = 0

    def _try_sendmsg(self, bufs: List[memoryview]) -> Optional[int]:
        try:
            # rstpu-check: allow(loop-blocking) non-blocking socket — EAGAIN returns None and the drainer awaits loop writability; the vectored send never parks the loop
            return self._sock.sendmsg(bufs)
        except (BlockingIOError, InterruptedError):
            return None

    def _wait_writable(self) -> "asyncio.Future[None]":
        fut: asyncio.Future = self._loop.create_future()
        fd = self._sock.fileno()
        if fd < 0:
            raise ConnectionResetError("uds connection is closed")
        self._loop.add_writer(fd, lambda: fut.done() or fut.set_result(None))
        fut.add_done_callback(lambda _f: self._loop.remove_writer(fd))
        return fut

    # -- recv half ------------------------------------------------------

    async def recv_frames(self) -> List[Tuple[memoryview, memoryview]]:
        frames = self._rbuf.pop_frames()
        while not frames:
            view = self._rbuf.recv_view()
            try:
                n = await self._loop.sock_recv_into(self._sock, view)
            finally:
                view.release()
            self.recv_calls += 1
            if n == 0:
                # EOF: clean between frames, short mid-frame — either way
                # the FrameReader contract is IncompleteReadError
                raise asyncio.IncompleteReadError(b"", None)
            self._rbuf.advance(n)
            frames = self._rbuf.pop_frames()
        # arm once per FRAME, not per coalesced recv batch, so fail_nth /
        # delay / seeded policies count the same logical events as the
        # tcp FrameReader (one hit per read_frame)
        for _ in frames:
            await fp.async_hit("rpc.frame.recv")
        self.frames_received += len(frames)
        Stats.get().incr(M_FRAMES_RECEIVED, len(frames))
        return frames

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._drainer is not None and not self._drainer.done():
            self._drainer.cancel()
        self._fail_queued(ConnectionResetError("connection closed"))
        try:
            self._sock.close()
        except OSError:
            pass

    async def wait_closed(self) -> None:
        if self._drainer is not None:
            try:
                await self._drainer
            except (asyncio.CancelledError, ConnectionError, OSError):
                pass


class _UdsListener(Listener):
    def __init__(self, sock: socket.socket, path: str,
                 task: asyncio.Task):
        self._sock = sock
        self.path = path
        self._task = task

    def close(self) -> None:
        self._task.cancel()
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass

    async def wait_closed(self) -> None:
        try:
            await self._task
        except (asyncio.CancelledError, Exception):
            pass


class UdsTransport(Transport):
    scheme = "uds"

    async def connect(self, ep: Endpoint, *, ssl_manager=None) -> Connection:
        if ssl_manager is not None:
            raise RpcTransportConfigError(
                "TLS requires the tcp transport (uds endpoint "
                f"{ep.path!r})")
        loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            await loop.sock_connect(sock, ep.path)
        except BaseException:
            sock.close()
            raise
        return UdsConnection(sock, loop)

    async def accept(self, ep: Endpoint, on_connection: ConnectionCallback,
                     *, ssl_manager=None) -> Listener:
        if ssl_manager is not None:
            raise RpcTransportConfigError(
                "TLS requires the tcp transport (uds endpoint "
                f"{ep.path!r})")
        loop = asyncio.get_running_loop()
        os.makedirs(os.path.dirname(ep.path) or "/", exist_ok=True)
        try:
            os.unlink(ep.path)  # stale socket from a dead process
        except OSError:
            pass
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.setblocking(False)
        sock.bind(ep.path)
        sock.listen(128)

        async def accept_loop():
            while True:
                try:
                    client, _addr = await loop.sock_accept(sock)
                except asyncio.CancelledError:
                    raise
                except OSError as e:
                    # transient accept failure (EMFILE/ENFILE under fd
                    # pressure): keep the listener alive, like the tcp
                    # path's asyncio.start_server does — a dead uds
                    # acceptor would strand every policy client on
                    # ConnectionRefused with no server-side signal
                    if sock.fileno() < 0:
                        return  # listener closed
                    log.warning("uds accept error on %s: %s", ep.path, e)
                    await asyncio.sleep(0.1)
                    continue
                conn = UdsConnection(client, loop)
                t = asyncio.ensure_future(on_connection(conn))
                t.add_done_callback(_reap_connection_task)

        task = asyncio.ensure_future(accept_loop())
        return _UdsListener(sock, ep.path, task)


def _reap_connection_task(task: asyncio.Task) -> None:
    if not task.cancelled():
        task.exception()  # connection handlers log their own errors


# ---------------------------------------------------------------------------
# loopback — in-process queue pair (syscall-free ceiling)
# ---------------------------------------------------------------------------


class LoopbackConnection(Connection):
    """Frames cross as (header, payload) memoryviews on a deque: no wire
    pack, no compression, no recv copy — the only serde work is
    encode_message/decode_message at the call layer. Failpoints arm
    exactly as on the socket transports; a torn frame becomes a poison
    entry the receiver turns into a connection-reset, so reconnect
    behavior matches byte-for-byte."""

    scheme = "loopback"

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._q: deque = deque()
        self._wakeup = asyncio.Event()
        self.peer: Optional["LoopbackConnection"] = None
        self._closed = False
        self.frames_sent = 0
        self.frames_received = 0

    async def send_frames(self, frames: Sequence[Frame]) -> None:
        peer = self.peer
        for header, chunks in frames:
            await fp.async_hit("rpc.frame.send")
            # seeded-stream parity with the socket transports: the
            # offset draw (randrange) consumes a range-dependent number
            # of rng draws, so the length passed to torn_point must be
            # the SAME wire length uds/tcp would use — pay the one-off
            # encode (incl. compression) only when the site is armed;
            # production loopback sends stay zero-copy
            if fp.is_active("rpc.frame.send"):
                _parts, wire_len = encode_wire_parts(
                    bytes(header), [bytes(c) for c in chunks])
            else:
                wire_len = 12 + len(header) + sum(len(c) for c in chunks)
            cut = fp.torn_point("rpc.frame.send", wire_len)
            if cut is not None:
                if peer is not None and not peer._closed:
                    peer._push(("torn", None, None))
                self._closed = True
                self._wakeup.set()
                raise fp.FailpointError(f"torn frame at +{cut}B")
            if self._closed or peer is None or peer._closed:
                raise ConnectionResetError("loopback peer closed")
            if len(chunks) == 1:
                payload = memoryview(chunks[0])
            else:
                payload = memoryview(b"".join(chunks))
            peer._push(("frame", memoryview(header), payload))
            self.frames_sent += 1
        Stats.get().incr(M_FRAMES_SENT, len(frames))

    def _push(self, item) -> None:
        self._q.append(item)
        self._wakeup.set()

    async def recv_frames(self) -> List[Tuple[memoryview, memoryview]]:
        while not self._q:
            if self._closed:
                raise asyncio.IncompleteReadError(b"", None)
            self._wakeup.clear()
            await self._wakeup.wait()
        frames: List[Tuple[memoryview, memoryview]] = []
        while self._q:
            kind, header, payload = self._q[0]
            if kind == "frame":
                self._q.popleft()
                frames.append((header, payload))
                continue
            if frames:
                break  # deliver completed frames before the poison
            self._q.popleft()
            if kind == "torn":
                raise ConnectionResetError("torn frame on loopback")
            raise asyncio.IncompleteReadError(b"", None)  # eof
        # arm once per FRAME (matching the tcp FrameReader's one hit per
        # read_frame), not per drained batch
        for _ in frames:
            await fp.async_hit("rpc.frame.recv")
        self.frames_received += len(frames)
        Stats.get().incr(M_FRAMES_RECEIVED, len(frames))
        return frames

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        peer = self.peer
        if peer is not None and not peer._closed:
            peer._push(("eof", None, None))
        self._wakeup.set()


class _LoopbackListener(Listener):
    def __init__(self, key: str, on_connection: ConnectionCallback,
                 loop: asyncio.AbstractEventLoop):
        self.key = key
        self._on_connection = on_connection
        self._loop = loop
        self.closed = False

    def make_connection(self) -> LoopbackConnection:
        client = LoopbackConnection(self._loop)
        server = LoopbackConnection(self._loop)
        client.peer, server.peer = server, client
        t = asyncio.ensure_future(self._on_connection(server))
        t.add_done_callback(_reap_connection_task)
        return client

    def close(self) -> None:
        self.closed = True
        if _LOOPBACK_REGISTRY.get(self.key) is self:
            del _LOOPBACK_REGISTRY[self.key]


_LOOPBACK_REGISTRY: Dict[str, _LoopbackListener] = {}


class LoopbackTransport(Transport):
    scheme = "loopback"

    async def connect(self, ep: Endpoint, *, ssl_manager=None) -> Connection:
        if ssl_manager is not None:
            raise RpcTransportConfigError(
                "TLS requires the tcp transport (loopback endpoint "
                f"{ep.key!r})")
        listener = _LOOPBACK_REGISTRY.get(ep.key)
        if listener is None or listener.closed:
            raise ConnectionRefusedError(
                f"loopback endpoint {ep.key!r} is not served by this "
                f"process (in-process transport; did you mean tcp/uds?)")
        if listener._loop is not asyncio.get_running_loop():
            raise ConnectionRefusedError(
                f"loopback endpoint {ep.key!r} is served from a "
                f"different event loop")
        return listener.make_connection()

    async def accept(self, ep: Endpoint, on_connection: ConnectionCallback,
                     *, ssl_manager=None) -> Listener:
        if ssl_manager is not None:
            raise RpcTransportConfigError(
                "TLS requires the tcp transport (loopback endpoint "
                f"{ep.key!r})")
        existing = _LOOPBACK_REGISTRY.get(ep.key)
        if existing is not None and not existing.closed:
            raise OSError(
                f"loopback endpoint {ep.key!r} already registered")
        listener = _LoopbackListener(
            ep.key, on_connection, asyncio.get_running_loop())
        _LOOPBACK_REGISTRY[ep.key] = listener
        return listener


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


_TRANSPORTS: Dict[str, Transport] = {
    "tcp": TcpTransport(),
    "uds": UdsTransport(),
    "loopback": LoopbackTransport(),
}


def get_transport(scheme: str) -> Transport:
    tr = _TRANSPORTS.get(scheme)
    if tr is None:
        raise RpcTransportConfigError(
            f"unknown transport scheme {scheme!r} "
            f"(expected one of {'|'.join(SCHEMES)})")
    return tr
