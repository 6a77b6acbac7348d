"""RpcServer: asyncio server dispatching typed method calls.
(The port's copy of ``rocksplicator_tpu/rpc/server.py``.)

Reference: the fbthrift ThriftServer hosting e.g. the ``Replicator`` service
(rocksdb_replicator/rocksdb_replicator.cpp:46-87) and ``Admin`` service.
Handlers are objects exposing ``async def handle_<method>(self, **args)``;
raising RpcApplicationError maps to a typed error frame (thrift exception
equivalent). CPU-bound work should be pushed to an executor by the handler.

The byte layer is pluggable (transport.py): the server always binds its
TCP port (the port is the cluster-wide identity — shard maps and
upstream addresses carry it), and under the ``RSTPU_TRANSPORT`` policy
ALSO serves the derived fast-path endpoints for that port — the
per-port unix socket (``uds``) and/or the in-process loopback key
(``loopback``) — so clients resolving the same (host, port) address
under the same policy land on the fast path while stray tcp clients
still work. Explicit extra endpoints may be passed as URL strings.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from .admission import TenantAdmission, sanitize_tenant
from .deadline import (DEADLINE_EXCEEDED, DEADLINE_KEY, RETRY_LATER,
                       TENANT_KEY, Deadline, armor_enabled, request_scope)
from .errors import RpcApplicationError, RpcTransportConfigError
from .ioloop import IoLoop
from .serde import decode_message, encode_message
from .transport import (
    Connection,
    Endpoint,
    TcpConnection,
    get_transport,
    parse_endpoint,
    transport_policy,
    uds_path_for_port,
)
from ..observability.context import TRACE_KEY
from ..observability.span import start_span
from ..testing import failpoints as fp
from ..utils.stats import Stats, tagged

log = logging.getLogger(__name__)


def _request_cost_bytes(args: Dict[str, Any]) -> int:
    """Admission byte-cost of a request: the payload-bearing argument
    sizes (a write's raw_batch, a multi_get's key list). One shallow
    pass — this runs on every metered dispatch."""
    cost = 0
    for v in args.values():
        if isinstance(v, (bytes, bytearray, memoryview)):
            cost += len(v)
        elif isinstance(v, str):
            cost += len(v)
        elif isinstance(v, (list, tuple)):
            for item in v:
                if isinstance(item, (bytes, bytearray, memoryview, str)):
                    cost += len(item)
    return cost


class RpcServer:
    """Serves one or more handler objects on a TCP port (plus any
    policy-derived or explicit fast-path endpoints).

    Multiple handlers may be stacked (e.g. an application handler extending
    the Admin service — counter.thrift's ``service Counter extends Admin``);
    method lookup walks them in registration order.
    """

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 ioloop: Optional[IoLoop] = None, ssl_manager=None,
                 endpoints: Optional[List[str]] = None):
        self._host = host
        self._port = port
        self._ioloop = ioloop or IoLoop.default()
        self._handlers: list = []
        self._server: Optional[asyncio.AbstractServer] = None
        self._extra_endpoints = list(endpoints or [])
        self._extra_listeners: list = []
        self._ready = threading.Event()
        # connection task -> its in-flight dispatch-task set (one structure
        # serves both teardown cancellation and graceful drain)
        self._connections: dict = {}
        self._draining = False
        # TLS: an SslContextManager (utils/ssl_context_manager) — the
        # SAME context object is handed to asyncio once; cert refreshes
        # reload into it, so new handshakes pick up rotated certs.
        # _ssl_claimed tracks whether THIS server currently holds a
        # refresh-thread claim (managers are shared; an unpaired stop()
        # must not release someone else's claim).
        self._ssl_manager = ssl_manager
        self._ssl_claimed = False

    def add_handler(self, handler: object) -> None:
        self._handlers.append(handler)

    @property
    def port(self) -> int:
        return self._port

    def serving_endpoints(self) -> List[str]:
        """Every endpoint this server currently accepts on (tcp first)."""
        eps = [f"tcp://{self._host}:{self._port}"]
        for lst in self._extra_listeners:
            if getattr(lst, "path", None):
                eps.append(f"uds://{lst.path}")
            elif getattr(lst, "key", None):
                eps.append(f"loopback://{lst.key}")
        return eps

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Start serving (callable from any thread); blocks until bound."""
        try:
            self._ioloop.run_sync(self._start_async())
        except Exception:
            # a failed start has no stop() to pair with: drop this
            # server's refresh-thread claim here (outside the loop,
            # mirroring stop())
            if self._ssl_manager is not None and self._ssl_claimed:
                self._ssl_claimed = False
                self._ssl_manager.release_auto_refresh()
            raise

    async def _start_async(self) -> None:
        self._draining = False  # a restarted server serves again
        ssl_ctx = None
        if self._ssl_manager is not None:
            ssl_ctx = self._ssl_manager.get()
        self._server = await asyncio.start_server(
            self._on_tcp_connection, self._host, self._port, ssl=ssl_ctx,
        )
        if self._ssl_manager is not None and not self._ssl_claimed:
            # claim the refresh thread only for a server that actually
            # bound (a failed bind has no stop() to pair the release);
            # the background thread keeps rotated certs flowing into the
            # pinned context — servers call get() only at bind time
            self._ssl_manager.ensure_auto_refresh()
            self._ssl_claimed = True
        self._port = self._server.sockets[0].getsockname()[1]
        try:
            await self._start_extra_listeners()
        except Exception:
            # a half-started server must not keep accepting: the tcp
            # listener is already bound (and some extras may be up) when
            # an extra listener fails — close them before propagating so
            # start() raising leaves nothing serving
            self._server.close()
            self._server = None
            for listener in self._extra_listeners:
                listener.close()
            self._extra_listeners.clear()
            raise
        self._ready.set()

    async def _start_extra_listeners(self) -> None:
        """Fast-path listeners: the policy-derived endpoints for this
        port plus any explicit endpoint URLs. TLS pins tcp — a TLS
        server never exposes a plaintext side channel."""
        eps: List[Endpoint] = []
        if self._ssl_manager is not None:
            if self._extra_endpoints:
                # refuse loudly rather than silently dropping a listener
                # the operator asked for: a TLS server must not expose a
                # plaintext side channel, and a config accepted-but-
                # ignored would read as the fast path being up
                raise RpcTransportConfigError(
                    "TLS requires the tcp transport: explicit extra "
                    f"endpoints {self._extra_endpoints!r} cannot be "
                    "served by a TLS server")
        else:
            policy = transport_policy()
            if policy == "uds":
                eps.append(Endpoint(
                    "uds", path=uds_path_for_port(self._port)))
            elif policy == "loopback":
                eps.append(Endpoint("loopback", key=str(self._port)))
            eps.extend(parse_endpoint(u) for u in self._extra_endpoints)
        for ep in eps:
            listener = await get_transport(ep.scheme).accept(
                ep, self._serve_connection)
            self._extra_listeners.append(listener)

    def stop(self, drain_timeout: float = 0.0) -> None:
        """Stop serving. ``drain_timeout`` > 0 gives in-flight requests
        that long to complete before connections are cancelled (the
        reference's graceful-shutdown contract: stop accepting, drain,
        then tear down — common/tests/graceful_shutdown_test.cpp)."""
        try:
            self._ioloop.run_sync(
                self._stop_async(drain_timeout), timeout=drain_timeout + 5.0
            )
        except Exception:
            pass
        if self._ssl_manager is not None and self._ssl_claimed:
            # drop this server's claim on the refresh thread (refcounted:
            # the manager may be shared with other servers/pools; the
            # thread stops when the last user releases). Only if THIS
            # server holds a claim — double stop() or stop() without
            # start() must not release someone else's.
            self._ssl_claimed = False
            self._ssl_manager.release_auto_refresh()

    async def _stop_async(self, drain_timeout: float = 0.0) -> None:
        # Stop accepting new connections AND new work: frames arriving on
        # existing connections during the drain get a typed SHUTDOWN error
        # instead of a handler dispatch (a busy client must not defeat the
        # drain window).
        self._draining = True
        if self._server is not None:
            self._server.close()
        for listener in self._extra_listeners:
            listener.close()
        if drain_timeout > 0:
            deadline = asyncio.get_running_loop().time() + drain_timeout
            while (
                any(self._connections.values())
                and asyncio.get_running_loop().time() < deadline
            ):
                await asyncio.sleep(0.02)
        # Cancel remaining connections before wait_closed(): since Python
        # 3.12 wait_closed() also waits for connection handlers to finish,
        # and ours loop until cancelled.
        for task in list(self._connections):
            if task is not None:
                task.cancel()
        for listener in self._extra_listeners:
            await listener.wait_closed()
        self._extra_listeners = []
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    # -- connection handling ---------------------------------------------

    async def _on_tcp_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if self._ssl_manager is not None:
            # role binding: a connecting peer presenting a cert must hold
            # a CLIENT cert (utils/ssl_context_manager.check_peer_role)
            from ..utils.ssl_context_manager import (
                PeerRoleError, check_peer_role)

            try:
                check_peer_role(
                    writer.get_extra_info("ssl_object"), "client")
            except PeerRoleError as e:
                log.warning("rejecting connection: %s", e)
                writer.close()
                return
        await self._serve_connection(TcpConnection(reader, writer))

    # methods a peer's best-effort ``cancel`` frame may abort mid-flight:
    # idempotent reads only — cancelling a write task could leave the
    # commit half-acked (the client-side hedger only hedges reads, but
    # the wire frame is untrusted input and must not widen that contract)
    _CANCELLABLE = frozenset({"read"})

    async def _serve_connection(self, conn: Connection) -> None:
        """Transport-agnostic per-connection serve loop (every transport's
        accept path funnels here)."""
        task = asyncio.current_task()
        inflight: set = set()
        # req_id -> (dispatch task, method) for cancel-frame lookup
        by_id: Dict[Any, tuple] = {}
        self._connections[task] = inflight
        loop = asyncio.get_running_loop()
        try:
            while True:
                frames = await conn.recv_frames()
                # one receipt stamp per batch: queue wait measured in
                # _dispatch is (dispatch start - receipt), i.e. the
                # event-loop backlog a request sat behind — the signal
                # the deadline check charges against the budget
                recv_ts = loop.time()
                for header, payload in frames:
                    msg = decode_message(header, payload)
                    if "cancel" in msg and "method" not in msg:
                        # control frame, never replied to: abort the
                        # matching in-flight dispatch if it is still
                        # running AND its method is cancellable
                        entry = by_id.get(msg.get("cancel"))
                        if entry is not None:
                            t, m = entry
                            if m in self._CANCELLABLE and not t.done():
                                t.cancel()
                                Stats.get().incr(
                                    tagged("rpc.cancelled", method=m))
                        continue
                    # Each request runs as its own task so slow handlers
                    # (e.g. long-poll replicate) don't block the
                    # connection.
                    t = asyncio.ensure_future(
                        self._dispatch(msg, conn, recv_ts))
                    inflight.add(t)
                    req_id = msg.get("id")
                    if req_id is not None:
                        by_id[req_id] = (t, msg.get("method", ""))
                        t.add_done_callback(
                            lambda _f, rid=req_id: by_id.pop(rid, None))
                    t.add_done_callback(inflight.discard)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("rpc server connection error")
        finally:
            for t in inflight:
                t.cancel()
            self._connections.pop(task, None)
            conn.close()
            try:
                await conn.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _dispatch(self, msg: Dict[str, Any], conn: Connection,
                        recv_ts: Optional[float] = None) -> None:
        req_id = msg.get("id")
        method = msg.get("method", "")
        args = msg.get("args") or {}
        stats = Stats.get()
        stats.incr(f"rpc.{method}.received")
        # Tail armor (killswitch RSTPU_TAIL_ARMOR=0 restores
        # the bare pre-armor dispatch): measure the event-loop backlog
        # this request sat behind, then run the admission edge —
        # deadline-vs-queue-wait shedding and per-tenant token buckets
        # — BEFORE the handler, so dead or over-quota work is never
        # computed.
        armored = armor_enabled()
        tenant = msg.get(TENANT_KEY) if armored else None
        deadline: Optional[Deadline] = None
        queue_wait_ms = 0.0
        if armored and recv_ts is not None:
            queue_wait_ms = max(
                0.0,
                (asyncio.get_running_loop().time() - recv_ts) * 1e3)
        # Reattach the caller's trace context (injected by RpcClient.call
        # into the JSON frame header): the server span joins the caller's
        # trace; without a header it rolls local head sampling. This task
        # was just created, so the contextvar set inside start_span is
        # scoped to this request.
        with start_span("rpc.server", remote=msg.get(TRACE_KEY),
                        method=method) as sp:
            t0 = time.monotonic()
            try:
                if self._draining:
                    raise RpcApplicationError("SHUTDOWN", "server draining")
                if armored:
                    deadline = await self._admission_check(
                        method, msg, tenant, queue_wait_ms, stats)
                fn = self._find_handler(method)
                with request_scope(deadline=deadline, tenant=tenant):
                    result = await fn(**args)
                if deadline is not None and deadline.expired:
                    # the budget ran out while the handler was working:
                    # nobody is waiting for this reply — skip the
                    # serialization and ship the typed error instead
                    stats.incr(tagged("rpc.deadline_shed", method=method,
                                      stage="post"))
                    raise RpcApplicationError(
                        DEADLINE_EXCEEDED,
                        f"{method}: deadline expired during service "
                        f"({-deadline.remaining_ms():.1f}ms ago)")
                reply = {"id": req_id, "ok": True, "result": result}
                stats.incr(f"rpc.{method}.success")
                if tenant is not None:
                    tname = sanitize_tenant(tenant)
                    stats.incr(tagged("rpc.tenant_served", tenant=tname))
                    stats.add_metric(tagged("rpc.tenant_ms", tenant=tname),
                                     (time.monotonic() - t0) * 1e3)
            except RpcApplicationError as e:
                reply = {
                    "id": req_id,
                    "ok": False,
                    "error": {"code": e.code, "message": e.message, "data": e.data},
                }
                sp.annotate(error_code=e.code)
                stats.incr(f"rpc.{method}.app_error")
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.exception("handler %s failed", method)
                reply = {
                    "id": req_id,
                    "ok": False,
                    "error": {"code": "INTERNAL", "message": repr(e), "data": {}},
                }
                sp.annotate(error_code="INTERNAL")
                stats.incr(f"rpc.{method}.internal_error")
            header, chunks = encode_message(reply)
            if armored and tenant is not None:
                # response bytes are only known after encode: post-hoc
                # debit lets an oversized scan answer push the tenant's
                # byte bucket negative, deferring its next admission
                TenantAdmission.get().debit_bytes(
                    tenant, len(header) + sum(len(c) for c in chunks))
            try:
                # replies from concurrent dispatches coalesce in the
                # transport (no per-connection write lock needed)
                await conn.send_frames([(header, chunks)])
            except (ConnectionError, OSError):
                pass

    async def _admission_check(self, method: str, msg: Dict[str, Any],
                         tenant: Optional[str], queue_wait_ms: float,
                         stats) -> Optional[Deadline]:
        """The admission edge, run before handler dispatch.
        Raises typed errors (DEADLINE_EXCEEDED / RETRY_LATER) to shed;
        returns the re-anchored request Deadline (or None) to scope
        around the handler. Order matters: the deadline verdict first —
        a dead request must not spend tenant tokens."""
        deadline: Optional[Deadline] = None
        budget_ms = msg.get(DEADLINE_KEY)
        if budget_ms is not None:
            stats.add_metric("rpc.queue_wait_ms", queue_wait_ms)
            forced_expired = False
            try:
                await fp.async_hit("rpc.deadline.check")
            except fp.FailpointError:
                # an armed seam forces the expired verdict — chaos
                # drives the shed path itself, not an INTERNAL error
                forced_expired = True
            remaining = float(budget_ms) - queue_wait_ms
            if forced_expired or remaining <= 0.0:
                stats.incr(tagged("rpc.deadline_shed", method=method))
                raise RpcApplicationError(
                    DEADLINE_EXCEEDED,
                    f"{method}: deadline spent before dispatch (budget "
                    f"{float(budget_ms):.1f}ms, queue "
                    f"{queue_wait_ms:.1f}ms)")
            if queue_wait_ms > remaining:
                # backlog trend: we already queued longer than the whole
                # budget that is left, so service + response would land
                # dead — shed EARLY with a hint sized to the measured
                # wait (the jittered consumption lives in retry_policy)
                stats.incr(tagged("rpc.retry_later", method=method,
                                  reason="backlog"))
                raise RpcApplicationError(
                    RETRY_LATER,
                    f"{method}: queued {queue_wait_ms:.1f}ms with only "
                    f"{remaining:.1f}ms of budget left",
                    {"retry_after_ms": round(queue_wait_ms, 1)})
            deadline = Deadline.after_ms(remaining)
        if tenant is not None:
            # only TAGGED requests are metered: internal plane traffic
            # (replication pulls, coordinator RPCs) carries no tenant
            # and must never be shed by a product tenant's bucket
            adm = TenantAdmission.get()
            forced_shed = False
            try:
                # armed even with no quotas configured: chaos forces the
                # quota-shed path without env manipulation
                await fp.async_hit("admission.shed")
            except fp.FailpointError:
                forced_shed = True
            if adm.configured or forced_shed:
                ok, retry_after_ms = (
                    adm.admit(tenant,
                              _request_cost_bytes(msg.get("args") or {}))
                    if adm.configured else (True, None))
                if forced_shed or not ok:
                    tname = sanitize_tenant(tenant)
                    stats.incr(tagged("rpc.tenant_shed", tenant=tname,
                                      reason="quota"))
                    raise RpcApplicationError(
                        RETRY_LATER,
                        f"{method}: tenant {tname} over quota",
                        {"retry_after_ms":
                         round(retry_after_ms or 10.0, 1)})
        return deadline

    def _find_handler(self, method: str):
        for handler in self._handlers:
            fn = getattr(handler, f"handle_{method}", None)
            if fn is not None:
                return fn
        raise RpcApplicationError("NO_SUCH_METHOD", method)
