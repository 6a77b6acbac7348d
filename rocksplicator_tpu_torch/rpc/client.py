"""RpcClient: one multiplexed connection with health tracking.
(The port's copy of ``rocksplicator_tpu/rpc/client.py``.)

Reference: common/thrift_client_pool.h:107-142 — ``ClientStatusCallback``
tracks ``is_good`` via close/connectError callbacks; requests are
multiplexed on a header channel. Here: request ids multiplex concurrent
calls on one transport connection (tcp/uds/loopback — transport.py);
``is_good`` flips false on connection errors and the pool handles
reconnect throttling.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import Any, Dict, Optional, Tuple

from ..testing import failpoints as fp
from .deadline import (DEADLINE_KEY, TENANT_KEY, armor_enabled,
                       current_deadline, current_tenant)
from .errors import (RpcApplicationError, RpcConnectionError, RpcTimeout,
                     RpcTransportConfigError)
from .serde import decode_message, encode_message
from .transport import Connection, get_transport, resolve_endpoint
from ..observability.context import TRACE_KEY
from ..observability.span import start_span

log = logging.getLogger(__name__)


class RpcClient:
    """Async RPC client bound to the event loop that created it."""

    def __init__(self, host: str, port: int, connect_timeout: float = 5.0,
                 ssl_manager=None):
        self.host = host
        self.port = port
        self._connect_timeout = connect_timeout
        self._ssl_manager = ssl_manager
        self._conn: Optional[Connection] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._ids = itertools.count(1)
        self._recv_task: Optional[asyncio.Task] = None
        self.is_good = False
        self.last_connect_attempt = 0.0
        # a remembered RpcTransportConfigError from the last connect: the
        # pool's reconnect throttle re-raises it as itself, so a misconfig
        # is never laundered into a throttled RpcConnectionError
        self.last_connect_config_error: Optional[Exception] = None

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)

    @property
    def transport_scheme(self) -> Optional[str]:
        """The connected transport's scheme (None before connect)."""
        return self._conn.scheme if self._conn is not None else None

    async def connect(self) -> None:
        self.last_connect_attempt = time.monotonic()
        self.last_connect_config_error = None
        # endpoint resolution is per-connect: an explicit URL in ``host``
        # wins, else the RSTPU_TRANSPORT policy applies. A transport
        # MISCONFIG (RpcTransportConfigError) propagates as itself —
        # reconnect machinery must not retry it into oblivion.
        try:
            ep = resolve_endpoint(self.host, self.port,
                                  ssl=self._ssl_manager is not None)
            transport = get_transport(ep.scheme)
        except RpcTransportConfigError as e:
            self.last_connect_config_error = e
            raise
        try:
            # inside the except net: a tripped fail policy surfaces as
            # RpcConnectionError, a delay policy is a stuck connect
            await fp.async_hit("rpc.connect")
            self._conn = await asyncio.wait_for(
                transport.connect(ep, ssl_manager=self._ssl_manager),
                self._connect_timeout,
            )
        except (OSError, asyncio.TimeoutError) as e:
            # (ssl.SSLError is an OSError subclass: handshake failures
            # funnel into RpcConnectionError too)
            self.is_good = False
            raise RpcConnectionError(f"connect {ep}: {e}") from e
        if self._ssl_manager is not None:
            # role binding: the peer must hold a SERVER cert — CA
            # membership alone would let any cluster client cert
            # impersonate a server (utils/ssl_context_manager)
            from ..utils.ssl_context_manager import (
                PeerRoleError, check_peer_role)

            try:
                check_peer_role(
                    self._conn.get_extra_info("ssl_object"), "server")
            except PeerRoleError as e:
                self._conn.close()
                self.is_good = False
                raise RpcConnectionError(f"connect {ep}: {e}") from e
        self.is_good = True
        self._recv_task = asyncio.ensure_future(self._recv_loop())

    async def _recv_loop(self) -> None:
        assert self._conn is not None
        conn = self._conn
        try:
            while True:
                for header, payload in await conn.recv_frames():
                    msg = decode_message(header, payload)
                    fut = self._pending.pop(msg.get("id"), None)
                    if fut is None or fut.done():
                        continue
                    if msg.get("ok"):
                        fut.set_result(msg.get("result"))
                    else:
                        err = msg.get("error") or {}
                        fut.set_exception(
                            RpcApplicationError(
                                err.get("code", "UNKNOWN"),
                                err.get("message", ""),
                                err.get("data"),
                            )
                        )
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self._fail_pending(RpcConnectionError(f"connection lost: {e}"))
        except asyncio.CancelledError:
            self._fail_pending(RpcConnectionError("client closed"))
            raise
        except Exception as e:  # pragma: no cover - defensive
            log.exception("rpc client recv loop error")
            self._fail_pending(RpcConnectionError(f"recv error: {e}"))
        finally:
            self.is_good = False

    def _fail_pending(self, exc: Exception) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    async def call(
        self, method: str, args: Optional[Dict[str, Any]] = None,
        timeout: Optional[float] = 30.0,
        tail_exempt: bool = False,
        deadline_ms: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> Any:
        """``tail_exempt=True`` marks a call whose long RTT is BY DESIGN
        (a long-poll pull parks server-side up to max_wait_ms): the
        tracing tail-keep path must not retain it as a slow outlier.

        ``deadline_ms``/``tenant`` stamp the tail-armor frame
        headers (rpc/deadline): an explicit value wins; otherwise the
        AMBIENT request scope propagates — a handler fanning out
        downstream re-stamps its caller's decremented budget and tenant
        automatically, like the trace context."""
        if not self.is_good:
            raise RpcConnectionError(f"client {self.host}:{self.port} not connected")
        req_id = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        # The RTT span covers serialize → send → response future. When
        # sampled, the trace context rides the message's JSON frame header
        # under the reserved "trace" key; the server reattaches it before
        # dispatch, stitching the caller's trace across the process hop.
        with start_span("rpc.rtt", method=method, peer=self.host) as sp:
            if tail_exempt:
                sp.annotate(tail_exempt="long_poll")
            msg: Dict[str, Any] = {
                "id": req_id, "method": method, "args": args or {}
            }
            if sp.sampled:
                msg[TRACE_KEY] = sp.to_wire()
            if armor_enabled():
                budget_ms = deadline_ms
                if budget_ms is None:
                    ambient = current_deadline()
                    if ambient is not None:
                        budget_ms = ambient.remaining_ms()
                if budget_ms is not None:
                    # relative budget on the wire — wall clocks across
                    # processes are not comparable (deadline.py); an
                    # already-negative budget still ships so the server
                    # sheds with the TYPED error instead of serving it
                    msg[DEADLINE_KEY] = round(float(budget_ms), 3)
                wire_tenant = tenant if tenant is not None \
                    else current_tenant()
                if wire_tenant is not None:
                    msg[TENANT_KEY] = wire_tenant
            header, chunks = encode_message(msg)
            try:
                conn = self._conn
                assert conn is not None
                # no caller-side write lock: connections guarantee frame
                # atomicity + FIFO under concurrent senders, which lets
                # the vectored transports coalesce concurrent calls
                await conn.send_frames([(header, chunks)])
            except (ConnectionError, OSError) as e:
                self.is_good = False
                self._pending.pop(req_id, None)
                raise RpcConnectionError(f"send failed: {e}") from e
            try:
                if timeout is None:
                    return await fut
                return await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                self._pending.pop(req_id, None)
                raise RpcTimeout(
                    f"{method} to {self.host}:{self.port} timed out"
                ) from None
            except asyncio.CancelledError:
                # a cancelled caller (hedged-read loser) stops waiting
                # HERE: drop the pending future so the late answer is
                # discarded by _recv_loop's pop-miss, and tell the
                # server to stop working on it — best-effort, off the
                # cancellation path (the winner must not wait on the
                # loser's cancel frame reaching a slow server)
                self._pending.pop(req_id, None)
                if armor_enabled():
                    asyncio.ensure_future(self._send_cancel(req_id))
                raise

    async def _send_cancel(self, req_id: int) -> None:
        """Best-effort ``cancel`` control frame (no "method" key, never
        replied to): the server cancels the matching in-flight dispatch
        task if the request is still running. Losing the frame is fine
        — the reply is discarded client-side either way."""
        conn = self._conn
        if conn is None or not self.is_good:
            return
        try:
            header, chunks = encode_message({"cancel": req_id})
            await conn.send_frames([(header, chunks)])
        except (ConnectionError, OSError):
            pass

    async def close(self) -> None:
        self.is_good = False
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except (asyncio.CancelledError, Exception):
                pass
            self._recv_task = None
        if self._conn is not None:
            self._conn.close()
            try:
                await self._conn.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._conn = None
