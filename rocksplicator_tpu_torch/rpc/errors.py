"""RPC error taxonomy.
(The port's copy of ``rocksplicator_tpu/rpc/errors.py``.)"""

from __future__ import annotations

from typing import Any, Dict, Optional


class RpcError(Exception):
    """Base class for transport-level RPC failures."""


class RpcTimeout(RpcError):
    pass


class RpcConnectionError(RpcError):
    pass


class RpcTransportConfigError(RpcError):
    """A transport misconfiguration — unknown ``RSTPU_TRANSPORT`` value,
    an endpoint URL with an unregistered scheme, or a transport that
    cannot apply (e.g. TLS over a non-TCP byte layer). Deliberately NOT
    a connection error: retry/reconnect machinery must not mask it."""


class RpcApplicationError(RpcError):
    """A typed error raised by the remote handler (thrift exception
    equivalent). ``code`` is an application-defined error code; ``data``
    carries structured detail."""

    def __init__(self, code: str, message: str = "", data: Optional[Dict[str, Any]] = None):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message
        self.data = data or {}
