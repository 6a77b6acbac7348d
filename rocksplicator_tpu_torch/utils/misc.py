"""Small host helpers — the port's copy of the part of
``rocksplicator_tpu/utils/misc.py`` that the storage engine, the RPC
transport, the coordinator, replication, the file watcher and the counter
service use."""

from __future__ import annotations

import os
import socket
import time
from typing import Optional


def availability_zone(default: str = "us-east-1a") -> str:
    """AZ of this host. Env override RSTPU_AZ; else default (the reference
    queries EC2 instance metadata, which a sealed host does not have)."""
    return os.environ.get("RSTPU_AZ", default)


def local_ip() -> str:
    """Best-effort local routable IP (reference common/network_util)."""
    env = os.environ.get("RSTPU_LOCAL_IP")
    if env:
        return env
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        # No packets are sent for a UDP connect; this just picks the
        # interface the kernel would route through.
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def now_ms() -> int:
    return int(time.time() * 1000)


def read_file(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def write_file_atomic(path: str, data: bytes) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # fsync the directory so the rename itself survives power loss
    # (file fsync alone does not make the new directory entry durable)
    try:
        dfd = os.open(parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # some filesystems disallow dir fsync; best effort
