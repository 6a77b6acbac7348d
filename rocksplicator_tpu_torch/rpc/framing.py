"""Length-prefixed framing over asyncio streams.
(The port's copy of ``rocksplicator_tpu/rpc/framing.py``.)

Frame layout (all little-endian):
    magic   u16  = 0x5254 ("RT")
    flags   u16  (bit 0 = payload zlib-compressed)
    hlen    u32  header length
    plen    u32  payload length (on-wire, i.e. compressed when flagged)
    header  [hlen] JSON
    payload [plen] raw binary region

The reference's analog is the fbthrift header protocol with optional
snappy/zstd channel transforms (common/thrift_client_pool.h:277-284);
payloads above a threshold are transparently zlib-compressed here (zlib is
the in-image codec; the flag word leaves room for others).

The JSON header doubles as the out-of-band metadata channel (the fbthrift
THeader analog): sampled trace context rides it under the reserved
top-level ``"trace"`` key (observability/context.py) — injected by
rpc/client.py, restored by rpc/server.py, and printed by tools/rpcgrep.py
so wire captures join in-process traces on one id.
"""

from __future__ import annotations

import asyncio
import struct
import zlib
from typing import List, Tuple

from ..storage import rlz
from ..testing import failpoints as fp

MAGIC = 0x5254
FLAG_PAYLOAD_ZLIB = 1
# RLZ1 transform (storage/rlz.py): snappy-class speed — the preferred
# codec when the native module is loaded; receivers always handle both.
FLAG_PAYLOAD_RLZ = 2
_HEADER = struct.Struct("<HHII")
MAX_FRAME_BYTES = 256 * 1024 * 1024
# payloads in this size band are compressed (WAL batches and other mid-size
# messages); tiny ones aren't worth the CPU and huge ones would stall the
# event loop with synchronous zlib (bulk data rides the object store, not
# RPC frames)
COMPRESS_THRESHOLD = 4096
COMPRESS_MAX = 8 * 1024 * 1024
# frames at or below this size are sent as ONE transport write (single
# send syscall) instead of one write per header/chunk
_JOIN_MAX = 256 * 1024


def _maybe_compress(
    payload_chunks: List[bytes], plen: int
) -> Tuple[List[bytes], int, int]:
    """The channel transform: returns (chunks, plen, flags)."""
    if COMPRESS_THRESHOLD <= plen <= COMPRESS_MAX:
        raw = b"".join(payload_chunks)
        # rlz only with the native codec: the pure-Python encoder would
        # stall the event loop far longer than zlib's C one
        if rlz.native_available():
            compressed, flag = rlz.compress(raw), FLAG_PAYLOAD_RLZ
        else:
            compressed, flag = zlib.compress(raw, 1), FLAG_PAYLOAD_ZLIB
        if len(compressed) < plen:
            return [compressed], len(compressed), flag
    return payload_chunks, plen, 0


def encode_wire_parts(
    header: bytes, payload_chunks: List[bytes]
) -> Tuple[List[bytes], int]:
    """One frame as a list of wire buffers (length-prefix struct, header,
    payload chunks) plus the total on-wire length — WITHOUT joining them,
    so a vectored transport can hand the list straight to ``sendmsg`` as
    an iovec (headers interleaved zero-copy) and a stream transport can
    decide whether a join is worth one memcpy."""
    plen = sum(len(c) for c in payload_chunks)
    payload_chunks, plen, flags = _maybe_compress(payload_chunks, plen)
    parts = [_HEADER.pack(MAGIC, flags, len(header), plen), header,
             *payload_chunks]
    return parts, _HEADER.size + len(header) + plen


def _decode_payload(flags: int, payload: memoryview) -> memoryview:
    if flags & FLAG_PAYLOAD_ZLIB:
        # bounded decompression: never materialize more than the frame
        # cap no matter what the peer claims (zip-bomb guard)
        d = zlib.decompressobj()
        raw = d.decompress(bytes(payload), MAX_FRAME_BYTES + 1)
        if len(raw) > MAX_FRAME_BYTES or d.unconsumed_tail or d.unused_data:
            raise ValueError("malformed or oversized compressed frame")
        return memoryview(raw)
    if flags & FLAG_PAYLOAD_RLZ:
        # rlz.decompress is bounded by construction (same guard)
        return memoryview(rlz.decompress(bytes(payload), MAX_FRAME_BYTES))
    return payload


def _check_frame_head(magic: int, flags: int, hlen: int, plen: int) -> None:
    if magic != MAGIC:
        raise ValueError(f"bad frame magic: {magic:#x}")
    if flags & ~(FLAG_PAYLOAD_ZLIB | FLAG_PAYLOAD_RLZ):
        # a transform this reader doesn't know: fail loudly instead
        # of handing compressed bytes up as a valid payload
        raise ValueError(f"unknown frame flags: {flags:#x}")
    if hlen + plen > MAX_FRAME_BYTES:
        raise ValueError(f"frame too large: {hlen + plen}")


async def write_frame(
    writer: asyncio.StreamWriter, header: bytes, payload_chunks: List[bytes]
) -> None:
    parts, wire_len = encode_wire_parts(header, payload_chunks)
    plen = wire_len - _HEADER.size - len(header)
    await fp.async_hit("rpc.frame.send")
    cut = fp.torn_point("rpc.frame.send", wire_len)
    if cut is not None:
        # torn frame: a prefix reaches the peer (short/desynced stream →
        # clean decode error + reconnect there), the sender sees a
        # failed send (OSError) and must treat the connection as dead
        writer.write(b"".join(parts)[:cut])
        await writer.drain()
        raise fp.FailpointError(f"torn frame at +{cut}B")
    # ONE transport write: each StreamWriter.write() attempts an eager
    # send syscall when the buffer is empty, so the old 3..N-write frame
    # cost 3..N sends. Joining costs one memcpy of an already-small
    # (usually compressed) frame; on sandboxed/virtualized kernels where
    # a syscall is micro-seconds, this is a large share of RPC latency.
    # Frames above the join cap keep per-chunk writes (no big copies).
    if plen <= _JOIN_MAX:
        writer.write(b"".join(parts))
    else:
        for part in parts:
            writer.write(part)
    await writer.drain()


class FrameReader:
    def __init__(self, reader: asyncio.StreamReader):
        self._reader = reader

    async def read_frame(self) -> Tuple[memoryview, memoryview]:
        """Returns (header, payload) memoryviews. Raises
        asyncio.IncompleteReadError on clean EOF."""
        await fp.async_hit("rpc.frame.recv")
        head = await self._reader.readexactly(_HEADER.size)
        magic, flags, hlen, plen = _HEADER.unpack(head)
        _check_frame_head(magic, flags, hlen, plen)
        body = await self._reader.readexactly(hlen + plen)
        view = memoryview(body)
        return view[:hlen], _decode_payload(flags, view[hlen:])


class FrameBuffer:
    """Reusable receive buffer decoding MULTIPLE frames per ``recv_into``
    (the vectored-transport receive half: one syscall can complete many
    coalesced frames). Usage per receive round::

        view = fb.recv_view()          # writable tail of the buffer
        n = await loop.sock_recv_into(sock, view)
        view.release()                 # allow the bytearray to grow later
        fb.advance(n)
        frames = fb.pop_frames()       # [] if no complete frame yet

    Each popped frame's header/payload views reference a per-frame copy,
    so the underlying buffer is immediately reusable (the same ownership
    contract as ``FrameReader``'s readexactly result)."""

    def __init__(self, capacity: int = 64 * 1024):
        self._buf = bytearray(max(capacity, _HEADER.size))
        self._start = 0
        self._end = 0

    def pending(self) -> int:
        return self._end - self._start

    def recv_view(self, min_free: int = 16 * 1024) -> memoryview:
        """A writable view of the free tail, compacting/growing so at
        least ``min_free`` bytes (or the known remainder of a partially
        received frame) are available."""
        need = min_free
        avail = self.pending()
        if avail >= _HEADER.size:
            _magic, _flags, hlen, plen = _HEADER.unpack_from(
                self._buf, self._start)
            # size the buffer for the in-progress frame (validation is
            # pop_frames' job; a bogus length fails there, and the cap
            # bounds what we would ever allocate)
            total = _HEADER.size + min(hlen + plen, MAX_FRAME_BYTES)
            need = max(need, total - avail)
        if len(self._buf) - self._end < need:
            if self._start:
                self._buf[0:avail] = self._buf[self._start:self._end]
                self._start, self._end = 0, avail
            shortfall = need - (len(self._buf) - self._end)
            if shortfall > 0:
                self._buf.extend(bytes(shortfall))
        return memoryview(self._buf)[self._end:]

    def advance(self, n: int) -> None:
        self._end += n

    def feed(self, data: bytes) -> None:
        """Test/compat convenience: append already-received bytes."""
        view = self.recv_view(min_free=len(data))
        view[: len(data)] = data
        view.release()
        self.advance(len(data))

    def pop_frames(self) -> List[Tuple[memoryview, memoryview]]:
        """Decode every complete frame currently buffered. Raises
        ValueError on a corrupt head (desynced/torn stream) — the
        connection must be treated as dead, same as ``FrameReader``."""
        frames: List[Tuple[memoryview, memoryview]] = []
        while True:
            avail = self._end - self._start
            if avail < _HEADER.size:
                break
            magic, flags, hlen, plen = _HEADER.unpack_from(
                self._buf, self._start)
            _check_frame_head(magic, flags, hlen, plen)
            if avail < _HEADER.size + hlen + plen:
                break
            a = self._start + _HEADER.size
            body = bytes(memoryview(self._buf)[a:a + hlen + plen])
            view = memoryview(body)
            frames.append((view[:hlen], _decode_payload(flags, view[hlen:])))
            self._start = a + hlen + plen
        if self._start == self._end:
            self._start = self._end = 0
        return frames
