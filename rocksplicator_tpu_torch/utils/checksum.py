"""Polynomial block checksum, numpy side — counterpart of
``rocksplicator_tpu/utils/checksum.py``.

H = Σ (x_i + 1) · r^(i+1) mod 2^32 over the zero-padded canonical block
length, r = the odd FNV prime. ``powers`` is the wrapping power vector the
torch path (``ops/block_encode.py``) moves to the device: numpy's uint32
``cumprod`` wraps mod 2^32, torch's int64 ``cumprod`` does not.
"""

from __future__ import annotations

import functools

import numpy as np

CHK_R = np.uint32(0x01000193)


@functools.lru_cache(maxsize=64)
def powers(length: int) -> np.ndarray:
    """r^1..r^length (wrapping u32). Cached per length (block sizes are
    few); the returned array is read-only because every caller shares it."""
    with np.errstate(over="ignore"):
        arr = np.cumprod(np.full(length, CHK_R, np.uint32), dtype=np.uint32)
    arr.setflags(write=False)
    return arr


def poly_checksum(data: bytes, length: int | None = None) -> int:
    """Checksum of ``data`` zero-padded to ``length`` bytes."""
    buf = np.frombuffer(data, dtype=np.uint8)
    if length is not None and len(buf) < length:
        buf = np.pad(buf, (0, length - len(buf)))
    with np.errstate(over="ignore"):
        return int(((buf.astype(np.uint32) + np.uint32(1))
                    * powers(len(buf))).sum(dtype=np.uint32))


def poly_checksum_words(words: np.ndarray, length: int | None = None) -> int:
    """Word-domain variant for planar blocks: H = Σ (w_i + 1) · r^(i+1)
    mod 2^32 over u32 plane words zero-padded to ``length`` words."""
    buf = np.asarray(words, dtype=np.uint32).ravel()
    if length is not None and len(buf) < length:
        buf = np.pad(buf, (0, length - len(buf)))
    with np.errstate(over="ignore"):
        return int(((buf + np.uint32(1)) * powers(len(buf))).sum(
            dtype=np.uint32))
