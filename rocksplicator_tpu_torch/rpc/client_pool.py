"""RpcClientPool: addr → healthy client cache with reconnect throttling.
(The port's copy of ``rocksplicator_tpu/rpc/client_pool.py``.)

Reference: common/thrift_client_pool.h:104-479 — per-IO-thread addr→channel
maps with health callbacks, reconnect throttling, and stale-channel cleanup.
Here one pool per process (single IO loop), same contract: ``get_client``
returns a connected client, reuses healthy ones, throttles reconnect storms
to a bad host, and evicts dead clients.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional, Tuple

from .client import RpcClient
from .errors import RpcConnectionError, RpcTransportConfigError
from ..observability.span import start_span

RECONNECT_THROTTLE_SEC = 1.0


class RpcClientPool:
    def __init__(self, connect_timeout: float = 5.0, ssl_manager=None):
        self._clients: Dict[Tuple[str, int], RpcClient] = {}
        self._connect_timeout = connect_timeout
        self._locks: Dict[Tuple[str, int], asyncio.Lock] = {}
        # client-side SslContextManager: enables TLS (and presents the
        # client cert for mutual-TLS auth) on every pooled connection.
        # The pool claims the manager's background refresh thread so that
        # get() on the event loop never does cert-file IO inline.
        self._ssl_manager = ssl_manager
        self._ssl_claimed = ssl_manager is not None
        if ssl_manager is not None:
            ssl_manager.ensure_auto_refresh()

    async def get_client(self, host: str, port: int) -> RpcClient:
        addr = (host, port)
        client = self._clients.get(addr)
        if client is not None and client.is_good:
            # healthy-client fast path stays span-free: this is the per-call
            # hot path; only the slow (lock + connect) path is attributed
            return client
        lock = self._locks.setdefault(addr, asyncio.Lock())
        # The acquire span splits the slow path into queue wait (callers
        # serialized behind a peer's connect/throttle) vs the connect
        # itself — the "queue wait vs connect vs RTT" breakdown
        # (RTT lives in RpcClient.call).
        with start_span("rpc.pool.acquire", peer=host, port=port) as sp:
            t0 = time.monotonic()
            async with lock:
                sp.annotate(
                    queue_wait_ms=round((time.monotonic() - t0) * 1e3, 3))
                client = self._clients.get(addr)
                if client is not None and client.is_good:
                    sp.annotate(reused=True)
                    return client
                # Reconnect throttling: if we very recently failed to
                # connect to this addr, fail fast instead of hammering it.
                if (
                    client is not None
                    and time.monotonic() - client.last_connect_attempt
                    < RECONNECT_THROTTLE_SEC
                ):
                    # the throttle must not re-classify the failure: a
                    # remembered misconfig stays RpcTransportConfigError
                    # (callers like the pull loop route it away from the
                    # leader-resolver escalation path)
                    if client.last_connect_config_error is not None:
                        raise RpcTransportConfigError(
                            f"{host}:{port} throttled after transport "
                            f"misconfig: {client.last_connect_config_error}")
                    raise RpcConnectionError(
                        f"{host}:{port} recently failed; throttled"
                    )
                if client is not None:
                    await client.close()
                client = RpcClient(host, port, self._connect_timeout,
                                   ssl_manager=self._ssl_manager)
                # Register before connecting so a failed attempt is
                # remembered for throttling.
                self._clients[addr] = client
                with start_span("rpc.pool.connect"):
                    await client.connect()
                return client

    async def call(self, host: str, port: int, method: str, args=None,
                   timeout: Optional[float] = 30.0,
                   tail_exempt: bool = False,
                   deadline_ms: Optional[float] = None,
                   tenant: Optional[str] = None):
        client = await self.get_client(host, port)
        return await client.call(method, args, timeout,
                                 tail_exempt=tail_exempt,
                                 deadline_ms=deadline_ms, tenant=tenant)

    def peek(self, host: str, port: int) -> Optional[RpcClient]:
        return self._clients.get((host, port))

    async def close(self) -> None:
        for client in list(self._clients.values()):
            await client.close()
        self._clients.clear()
        if self._ssl_manager is not None and self._ssl_claimed:
            # claim released exactly once even if close() is called again
            self._ssl_claimed = False
            self._ssl_manager.release_auto_refresh()
