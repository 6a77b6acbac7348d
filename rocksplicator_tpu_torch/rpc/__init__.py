"""Typed async RPC — the fbthrift-equivalent transport layer.
(The port's copy of ``rocksplicator_tpu/rpc/__init__.py``.)

Reference: the fbthrift header protocol over TCP with zero-copy IOBuf
payloads (rocksdb_replicator/thrift/replicator.thrift:44-49), client pools
with per-connection health tracking (common/thrift_client_pool.h), and a
shard-map-driven router (common/thrift_router.h).

Design: a single asyncio event loop in a dedicated IO thread
drives all connections (vs. the reference's N IO threads × EventBase); the
wire format is a length-prefixed frame with a JSON header and a raw binary
payload region so WAL update bytes travel without copies or base64.
"""

from .framing import FrameBuffer, FrameReader, write_frame
from .serde import encode_message, decode_message
from .errors import (RpcError, RpcTimeout, RpcConnectionError,
                     RpcApplicationError, RpcTransportConfigError)
from .ioloop import IoLoop
from .transport import (Endpoint, Connection, Transport, get_transport,
                        parse_endpoint, resolve_endpoint, transport_policy,
                        uds_path_for_port)
from .client import RpcClient
from .client_pool import RpcClientPool
from .server import RpcServer
from .router import RpcRouter, ClusterLayout, Role, Quantity

__all__ = [
    "FrameBuffer", "FrameReader", "write_frame",
    "encode_message", "decode_message",
    "RpcError", "RpcTimeout", "RpcConnectionError", "RpcApplicationError",
    "RpcTransportConfigError",
    "Endpoint", "Connection", "Transport", "get_transport",
    "parse_endpoint", "resolve_endpoint", "transport_policy",
    "uds_path_for_port",
    "IoLoop", "RpcClient", "RpcClientPool", "RpcServer",
    "RpcRouter", "ClusterLayout", "Role", "Quantity",
]
