"""RLZ1 block codec — counterpart of ``rocksplicator_tpu/storage/rlz.py``.

As there, the native library's codec (``storage/native``,
``rlz_compress``/``rlz_decompress``) is the path wherever it is loaded,
and this file holds the format and the pure-Python fallback. The two
encoders write different, equally valid bytes where the native hashed
gram table collides (the Python one keeps an exact dict); each decodes
the other's output.

Format (little-endian)::

    u32 raw_len
    tokens until raw_len output bytes:
      0x01..0x7F          literal run of <tag> bytes, bytes follow inline
      0x80|L, u16 dist    match: copy L+4 bytes (4..131) starting <dist>
                          bytes back in the OUTPUT (1..65535); may overlap
                          itself (run encoding), copied front-to-back

Worst case (incompressible input): 4 + n + ceil(n/127) bytes — callers
size buffers with :func:`max_compressed_len`.
"""

from __future__ import annotations

_MIN_MATCH = 4
_MAX_MATCH = 131
_MAX_DIST = 65535


def max_compressed_len(n: int) -> int:
    return 4 + n + (n + 126) // 127 + 3


def _literals(out: bytearray, data: bytes, start: int, end: int) -> None:
    while start < end:
        take = min(127, end - start)
        out.append(take)
        out += data[start:start + take]
        start += take


def _py_compress(data: bytes) -> bytes:
    """Greedy LZ77 with a depth-1 table of 4-byte grams."""
    n = len(data)
    if n > 0xFFFFFFFF:
        raise ValueError("rlz: input exceeds the u32 raw_len field")
    out = bytearray(n.to_bytes(4, "little"))
    table: dict = {}
    i = 0
    lit_start = 0
    while i + _MIN_MATCH <= n:
        gram = data[i:i + 4]
        cand = table.get(gram)
        table[gram] = i
        if cand is not None and i - cand <= _MAX_DIST:
            max_len = min(_MAX_MATCH, n - i)
            length = 4
            while (length < max_len
                   and data[cand + length] == data[i + length]):
                length += 1
            _literals(out, data, lit_start, i)
            dist = i - cand
            out.append(0x80 | (length - _MIN_MATCH))
            out += dist.to_bytes(2, "little")
            i += length
            lit_start = i
            if i + _MIN_MATCH <= n:
                table[data[i - 1:i + 3]] = i - 1
        else:
            i += 1
    _literals(out, data, lit_start, n)
    return bytes(out)


def _py_decompress(data: bytes, max_out: int) -> bytes:
    """Bounded decode: raises ValueError if the declared output exceeds
    ``max_out`` or the stream is malformed."""
    if len(data) < 4:
        raise ValueError("rlz: truncated header")
    raw_len = int.from_bytes(data[:4], "little")
    if raw_len > max_out:
        raise ValueError(f"rlz: declared length {raw_len} > cap {max_out}")
    out = bytearray()
    r, n = 4, len(data)
    while len(out) < raw_len:
        if r >= n:
            raise ValueError("rlz: truncated stream")
        tag = data[r]
        r += 1
        if tag & 0x80:
            length = (tag & 0x7F) + _MIN_MATCH
            if r + 2 > n:
                raise ValueError("rlz: truncated match")
            dist = int.from_bytes(data[r:r + 2], "little")
            r += 2
            w = len(out)
            if dist == 0 or dist > w or w + length > raw_len:
                raise ValueError("rlz: bad match")
            if dist >= length:
                out += out[w - dist:w - dist + length]
            else:
                # overlapping run: replicate the period in slices
                pattern = bytes(out[w - dist:w])
                out += (pattern * (length // dist + 1))[:length]
        else:
            if tag == 0:
                raise ValueError("rlz: zero literal tag")
            if r + tag > n or len(out) + tag > raw_len:
                raise ValueError("rlz: bad literal run")
            out += data[r:r + tag]
            r += tag
    return bytes(out)


def _native():
    from .native.binding import get_native

    lib = get_native()
    if lib is not None and lib.has_rlz:
        return lib
    return None


def compress(data: bytes) -> bytes:
    if len(data) > 0xFFFFFFFF:
        raise ValueError("rlz: input exceeds the u32 raw_len field")
    lib = _native()
    if lib is not None:
        return lib.rlz_compress(data)
    return _py_compress(data)


def decompress(data: bytes, max_out: int) -> bytes:
    """Bounded decode: raises ValueError if the declared output exceeds
    ``max_out`` (zip-bomb guard) or the stream is malformed."""
    lib = _native()
    if lib is not None:
        out = lib.rlz_decompress(data, max_out)
        if out is None:
            raise ValueError("rlz: malformed stream (native)")
        return out
    return _py_decompress(data, max_out)


def native_available() -> bool:
    return _native() is not None
