"""PLANAR (struct-of-arrays) TSST block codec — counterpart of
``rocksplicator_tpu/storage/planar.py``.

A planar data block holds the kernel's u32 lanes as planes. Block layout
(all little-endian), after the 16-byte header:

    u32 n_entries | u8 klen | u8 vlen_lo | u8 flags | u8 vlen_hi | u64 0
    key planes   ceil(klen/4) × n u32   (big-endian WORD VALUES — the
                                         kernel's key_words_be lanes)
    seq_lo plane n u32
    seq_hi plane n u32                  (omitted when flags & SEQ32)
    vtype plane  ceil(n/4) u32          (4 entries packed per word, LE)
    val planes   ceil(vlen/4) × n u32   (the kernel's val_words lanes)

Entries within a block are key-ascending; klen/vlen are uniform per file.
DELETE rows carry no value: their val_len derives from the vtype on read.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from .errors import Corruption

# n, klen, vlen_lo, flags, vlen_hi, reserved
PLANAR_HEADER = struct.Struct("<IBBBBQ")
PLANAR_FLAG_SEQ32 = 1
PLANAR_MAX_KLEN = 24
PLANAR_MAX_VLEN = 0xFFFF


def pack_planar_header(n: int, klen: int, vlen: int, flags: int) -> bytes:
    """The one planar-header packer: it enforces the klen/vlen bounds."""
    if not (0 < klen <= PLANAR_MAX_KLEN):
        raise ValueError(f"planar klen out of range: {klen}")
    if not (0 <= vlen <= PLANAR_MAX_VLEN):
        raise ValueError(f"planar vlen out of range: {vlen}")
    return PLANAR_HEADER.pack(n, klen, vlen & 0xFF, flags, vlen >> 8, 0)


def unpack_planar_header(raw: bytes) -> Tuple[int, int, int, int]:
    """(n, klen, vlen, flags); raises Corruption on a bad header."""
    if len(raw) < PLANAR_HEADER.size:
        raise Corruption(f"planar block: {len(raw)} bytes < header")
    n, klen, vlen_lo, flags, vlen_hi, _ = PLANAR_HEADER.unpack_from(raw, 0)
    if not (0 < klen <= PLANAR_MAX_KLEN):
        raise Corruption(f"planar block: klen {klen} out of range")
    return n, klen, vlen_lo | (vlen_hi << 8), flags


def plane_words(n: int, klen: int, vlen: int, seq32: bool) -> int:
    """u32 words of plane data for a planar block of n entries."""
    kw = (klen + 3) // 4
    vw = (vlen + 3) // 4
    return n * (kw + 1 + (0 if seq32 else 1) + vw) + (n + 3) // 4


def pack_vtype_plane(vtype: np.ndarray) -> np.ndarray:
    """(n,) u32 vtype values -> (ceil(n/4),) u32, 4 per word LE."""
    pad = (-len(vtype)) % 4
    return np.pad(vtype.astype(np.uint8), (0, pad)).view("<u4").copy()


def unpack_vtype_plane(words: np.ndarray, n: int) -> np.ndarray:
    return words.view(np.uint8)[:n].astype(np.uint32)


def encode_planar_block(arrays: Dict[str, np.ndarray], start: int, end: int,
                        klen: int, vlen: int, seq32: bool) -> bytes:
    """Kernel-output lanes [start, end) -> planar block bytes."""
    n = end - start
    kw = (klen + 3) // 4
    vw = (vlen + 3) // 4
    parts: List[np.ndarray] = [
        np.ascontiguousarray(
            arrays["key_words_be"][start:end, :kw].T).reshape(-1),
        arrays["seq_lo"][start:end].astype(np.uint32),
    ]
    if not seq32:
        parts.append(arrays["seq_hi"][start:end].astype(np.uint32))
    parts.append(pack_vtype_plane(arrays["vtype"][start:end]))
    if vw:
        parts.append(np.ascontiguousarray(
            arrays["val_words"][start:end, :vw].T).reshape(-1))
    words = np.concatenate(parts).astype("<u4")
    header = pack_planar_header(
        n, klen, vlen, PLANAR_FLAG_SEQ32 if seq32 else 0)
    return header + words.tobytes()


def decode_planar_block(raw: bytes) -> Dict[str, np.ndarray]:
    """Planar block bytes -> lane arrays."""
    n, klen, vlen, flags = unpack_planar_header(raw)
    seq32 = bool(flags & PLANAR_FLAG_SEQ32)
    kw = (klen + 3) // 4
    vw = (vlen + 3) // 4
    want = PLANAR_HEADER.size + 4 * plane_words(n, klen, vlen, seq32)
    if len(raw) != want:
        raise Corruption(
            f"planar block: {len(raw)} bytes, layout wants {want}")
    words = np.frombuffer(raw, dtype="<u4", offset=PLANAR_HEADER.size)
    pos = 0
    kw_lanes = words[pos:pos + kw * n].reshape(kw, n)
    pos += kw * n
    seq_lo = words[pos:pos + n]
    pos += n
    if seq32:
        seq_hi = np.zeros(n, dtype=np.uint32)
    else:
        seq_hi = words[pos:pos + n]
        pos += n
    nv = (n + 3) // 4
    vtype = unpack_vtype_plane(words[pos:pos + nv], n)
    pos += nv
    val_lanes = words[pos:pos + vw * n].reshape(vw, n)

    key_buf = np.zeros((n, 24), dtype=np.uint8)
    kb = np.ascontiguousarray(
        kw_lanes.T.astype(">u4")).view(np.uint8).reshape(n, kw * 4)
    key_buf[:, :klen] = kb[:, :klen]
    val_words = np.zeros((n, max(2, vw)), dtype=np.uint32)
    if vw:
        val_words[:, :vw] = val_lanes.T
    return {
        "key_words_be": key_buf.view(">u4").astype(np.uint32).reshape(n, 6),
        "key_words_le": key_buf.view("<u4").reshape(n, 6).copy(),
        "key_len": np.full(n, klen, dtype=np.uint32),
        "seq_hi": seq_hi.astype(np.uint32),
        "seq_lo": seq_lo.astype(np.uint32),
        "vtype": vtype,
        "val_words": val_words,
        "val_len": np.where(vtype == 2, 0, vlen).astype(np.uint32),
    }


def iter_planar_block(raw: bytes) -> Iterator[Tuple[bytes, int, int, bytes]]:
    """Planar block -> (key, seq, vtype, value) tuples."""
    lanes = decode_planar_block(raw)
    n = len(lanes["key_len"])
    klen = int(lanes["key_len"][0]) if n else 0
    kb = (np.ascontiguousarray(lanes["key_words_be"].astype(">u4"))
          .view(np.uint8).reshape(n, 24))
    vb = (np.ascontiguousarray(lanes["val_words"].astype("<u4"))
          .view(np.uint8).reshape(n, -1))
    seqs = (lanes["seq_hi"].astype(np.uint64) << np.uint64(32)) | lanes[
        "seq_lo"].astype(np.uint64)
    vtypes = lanes["vtype"]
    vlens = lanes["val_len"]
    for i in range(n):
        yield (kb[i, :klen].tobytes(), int(seqs[i]), int(vtypes[i]),
               vb[i, :int(vlens[i])].tobytes())


def planar_props(klen: int, vlen: int, seq32: bool) -> List[int]:
    """The "planar" props value: [klen, vlen, seq32] (ints for JSON)."""
    return [int(klen), int(vlen), int(bool(seq32))]
