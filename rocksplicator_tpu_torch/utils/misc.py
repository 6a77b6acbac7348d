"""Small file helpers — the port's copy of the part of
``rocksplicator_tpu/utils/misc.py`` that the storage engine uses."""

from __future__ import annotations

import os


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
