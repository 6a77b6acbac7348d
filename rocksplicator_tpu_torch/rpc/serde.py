"""Wire serialization: JSON header + raw binary payload region.
(The port's copy of ``rocksplicator_tpu/rpc/serde.py``.)

The encoded message is ``header_json || payload`` where any ``bytes`` /
``memoryview`` value nested in the message is replaced in the header by
``{"$bin": [offset, length]}`` referencing the payload region. Decoding
returns ``memoryview`` slices into the received buffer — the zero-copy
analog of the reference's IOBuf payloads (replicator.thrift:44-49 declares
``raw_data`` as IOBuf specifically to avoid copying WAL bytes).
"""

from __future__ import annotations

import json
from typing import Any, List, Tuple

_BIN_KEY = "$bin"


def encode_message(obj: Any) -> Tuple[bytes, List[bytes]]:
    """Returns (header_json_bytes, payload_chunks)."""
    chunks: List[bytes] = []
    offset = 0

    def walk(value: Any) -> Any:
        nonlocal offset
        if isinstance(value, (bytes, bytearray, memoryview)):
            b = bytes(value) if not isinstance(value, bytes) else value
            ref = {_BIN_KEY: [offset, len(b)]}
            chunks.append(b)
            offset += len(b)
            return ref
        if isinstance(value, dict):
            if _BIN_KEY in value:
                raise ValueError(f"reserved key {_BIN_KEY!r} in message")
            return {k: walk(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return [walk(v) for v in value]
        return value

    header = json.dumps(walk(obj), separators=(",", ":")).encode("utf-8")
    return header, chunks


def decode_message(header: memoryview, payload: memoryview) -> Any:
    obj = json.loads(bytes(header).decode("utf-8"))

    def walk(value: Any) -> Any:
        if isinstance(value, dict):
            if _BIN_KEY in value and len(value) == 1:
                ref = value[_BIN_KEY]
                if (
                    not isinstance(ref, list)
                    or len(ref) != 2
                    or not all(isinstance(x, int) and x >= 0 for x in ref)
                    or ref[0] + ref[1] > len(payload)
                ):
                    raise ValueError(f"invalid binary ref: {ref!r}")
                off, length = ref
                return payload[off:off + length]
            return {k: walk(v) for k, v in value.items()}
        if isinstance(value, list):
            return [walk(v) for v in value]
        return value

    return walk(obj)
