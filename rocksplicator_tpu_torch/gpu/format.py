"""Array ↔ SST sink and source — counterpart of
``rocksplicator_tpu/tpu/format.py``.

The merge-resolve emits struct-of-array lanes. ``write_sst_from_arrays``
turns them into a TSST file without per-entry Python: PLANAR blocks
(``storage/planar.py``, the lanes as u32 planes with word-domain block
checksums) or uniform-stride entry rows, and a bloom bitmap that may come
prebuilt from kernel K3. ``read_sst_arrays`` is the source side: a
sink-written or uniform-stride file decodes straight back into lanes;
``SstBlockLaneSource`` decodes such a file a block range at a time for the
streaming merge (``storage/stream_merge.py``). The files are
byte-identical to those the JAX package writes from the same lanes.
Everything here is numpy on the host.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np

from ..ops.kv_format import UnsupportedBatch
from ..storage import rlz
from ..storage.bloom import BloomFilter
from ..storage.planar import (PLANAR_HEADER, PLANAR_MAX_VLEN,
                              decode_planar_block, encode_planar_block,
                              planar_props, plane_words)
from ..storage.sst import (BLOCK_PLANAR, BLOCK_PLANAR_RLZ,
                           BLOCK_PLANAR_ZLIB, COMPRESSION_RLZ,
                           COMPRESSION_ZLIB, ENTRY_FIXED_OVERHEAD,
                           SSTWriter)
from ..utils.checksum import poly_checksum_words

_DELETE = 2


def uniform_widths(arrays: Dict[str, np.ndarray], count: int):
    """(key_len, val_len) if all live rows share widths, else None."""
    if count == 0:
        return None
    kl = arrays["key_len"][:count]
    vl = arrays["val_len"][:count]
    k0, v0 = int(kl[0]), int(vl[0])
    if (kl == k0).all() and (vl == v0).all() and 0 < k0 <= 24:
        return k0, v0
    return None


def _key_bytes(arrays: Dict[str, np.ndarray], count: int,
               klen: int) -> np.ndarray:
    """(count, klen) u8 key bytes of the first ``count`` rows."""
    return (np.ascontiguousarray(arrays["key_words_be"][:count].astype(">u4"))
            .view(np.uint8).reshape(count, 24)[:, :klen])


def _seqs(arrays: Dict[str, np.ndarray], count: int) -> np.ndarray:
    return (arrays["seq_hi"][:count].astype(np.uint64) << np.uint64(32)) | (
        arrays["seq_lo"][:count].astype(np.uint64))


def encode_uniform_block(arrays: Dict[str, np.ndarray], start: int, end: int,
                         klen: int, vlen: int) -> bytes:
    """Entry-stream bytes of rows [start, end) with fixed widths."""
    n = end - start
    stride = ENTRY_FIXED_OVERHEAD + klen + vlen
    out = np.zeros((n, stride), dtype=np.uint8)
    pos = 0
    out[:, pos:pos + 4] = (
        np.full(n, klen, dtype="<u4").view(np.uint8).reshape(n, 4))
    pos += 4
    key_bytes = (
        np.ascontiguousarray(arrays["key_words_be"][start:end].astype(">u4"))
        .view(np.uint8).reshape(n, 24))
    out[:, pos:pos + klen] = key_bytes[:, :klen]
    pos += klen
    seqs = (arrays["seq_hi"][start:end].astype(np.uint64) << np.uint64(32)) | (
        arrays["seq_lo"][start:end].astype(np.uint64))
    out[:, pos:pos + 8] = seqs.astype("<u8").view(np.uint8).reshape(n, 8)
    pos += 8
    out[:, pos] = arrays["vtype"][start:end].astype(np.uint8)
    pos += 1
    out[:, pos:pos + 4] = (
        np.full(n, vlen, dtype="<u4").view(np.uint8).reshape(n, 4))
    pos += 4
    if vlen:
        val_bytes = (
            np.ascontiguousarray(arrays["val_words"][start:end].astype("<u4"))
            .view(np.uint8).reshape(n, -1))
        out[:, pos:pos + vlen] = val_bytes[:, :vlen]
    return out.tobytes()


def _with_global_seqno(lanes: Dict[str, np.ndarray],
                       seqno: Optional[int]) -> Dict[str, np.ndarray]:
    """An ingested file's global seqno overrides every per-entry seq."""
    if seqno is not None:
        n = len(lanes["seq_lo"])
        lanes["seq_lo"] = np.full(n, seqno & 0xFFFFFFFF, dtype=np.uint32)
        lanes["seq_hi"] = np.full(n, seqno >> 32, dtype=np.uint32)
    return lanes


def read_sst_arrays(reader) -> Optional[Dict[str, np.ndarray]]:
    """Decode a planar or uniform-stride TSST file straight into lanes.
    Returns the lane dict (its rows are the entries), or None for a file
    without a uniform layout (the caller takes the tuple path).

    ``reader`` is either package's ``SSTReader``: this reads its
    ``props``, ``_index``, ``num_entries``, ``global_seqno`` and
    ``_read_block``."""
    if reader.props.get("planar"):
        return _read_planar_arrays(reader)
    widths = reader.props.get("uniform")
    if widths:
        klen, vlen = int(widths[0]), int(widths[1])
        if not (0 < klen <= 24) or vlen < 0:
            return None  # foreign prop: the tuple path validates
        blocks = [reader._read_block(i, fill_cache=False)
                  for i in range(len(reader._index))]
    else:
        # no sink prop (a flush-written file): infer the stride from
        # block 0; the per-row width checks validate it on every row
        if not reader.num_entries or not reader._index:
            return None
        b0 = reader._read_block(0, fill_cache=False)
        inferred = _infer_uniform_widths(b0)
        if inferred is None:
            return None
        klen, vlen = inferred
        blocks = [b0] + [reader._read_block(i, fill_cache=False)
                         for i in range(1, len(reader._index))]
    try:
        lanes = _decode_uniform_rows(b"".join(blocks), klen, vlen)
    except UnsupportedBatch:
        return None
    return _with_global_seqno(lanes, reader.global_seqno)


class SstBlockLaneSource:
    """Block-granular lane decoder over ONE streamable TSST file: the
    source side of the streaming merge. Where ``read_sst_arrays`` decodes
    the whole file, this decodes a block range on demand, so a
    compaction's working set stays one window per input run.

    ``reader`` is either package's ``SSTReader`` (``_index``, ``props``,
    ``num_entries``, ``global_seqno``, ``_read_block(i, fill_cache=False)``:
    block reads never fill a block cache). ``probe`` returns None for a
    file the lanes cannot stream; a block that later breaks the probed
    layout raises UnsupportedBatch and the stream declines."""

    def __init__(self, reader, kind: str, klen: int, vlen: int):
        self.reader = reader
        self.kind = kind  # "planar" | "uniform"
        self.klen = klen
        self.vlen = vlen  # non-delete value width
        self.num_blocks = len(reader._index)
        self.num_entries = int(reader.num_entries)

    @classmethod
    def probe(cls, reader) -> Optional["SstBlockLaneSource"]:
        props = reader.props
        if not reader.num_entries or not reader._index:
            return None
        for kind in ("planar", "uniform"):
            widths = props.get(kind)
            if not widths:
                continue
            try:
                klen, vlen = int(widths[0]), int(widths[1])
            except (TypeError, ValueError, IndexError, KeyError):
                return None
            if not (0 < klen <= 24) or vlen < 0:
                return None
            return cls(reader, kind, klen, vlen)
        # no sink prop (a flush-written file): infer the stride from block
        # 0; decode_blocks checks every later block against it
        b0 = reader._read_block(0, fill_cache=False)
        inferred = _infer_uniform_widths(b0)
        if inferred is None:
            return None
        return cls(reader, "uniform", *inferred)

    def decode_blocks(self, b0: int, b1: int) -> Dict[str, np.ndarray]:
        """Lanes of blocks [b0, b1). Raises UnsupportedBatch when a block
        breaks the probed layout."""
        if self.kind == "planar":
            try:
                parts = [decode_planar_block(
                    self.reader._read_block(i, fill_cache=False))
                    for i in range(b0, b1)]
            except Exception as e:
                raise UnsupportedBatch(f"planar stream decode: {e}")
            lanes = {f: np.concatenate([p[f] for p in parts])
                     for f in parts[0]}
            kl = lanes["key_len"]
            if len(kl) and not (kl == self.klen).all():
                raise UnsupportedBatch("planar stream: klen drift")
            vl = lanes["val_len"][lanes["vtype"] != _DELETE]
            if len(vl) and not (vl == self.vlen).all():
                raise UnsupportedBatch("planar stream: vlen drift")
        else:
            lanes = _decode_uniform_rows(b"".join(
                self.reader._read_block(i, fill_cache=False)
                for i in range(b0, b1)), self.klen, self.vlen)
        return _with_global_seqno(lanes, self.reader.global_seqno)


def _infer_uniform_widths(b0: bytes):
    """(klen, vlen) of a uniform-stride file from its first block, or
    None when block 0 cannot carry a uniform stride."""
    if len(b0) < ENTRY_FIXED_OVERHEAD:
        return None
    klen = int.from_bytes(b0[:4], "little")
    if not (0 < klen <= 24) or len(b0) < ENTRY_FIXED_OVERHEAD + klen:
        return None
    # the first entry's vlen field sits after klen|key|seq|vtype
    vlen = int.from_bytes(b0[klen + 13:klen + 17], "little")
    if len(b0) % (ENTRY_FIXED_OVERHEAD + klen + vlen):
        return None
    return klen, vlen


def _decode_uniform_rows(raw: bytes, klen: int,
                         vlen: int) -> Dict[str, np.ndarray]:
    """Uniform-stride entry bytes → lanes. Raises UnsupportedBatch on a
    row whose widths differ."""
    stride = ENTRY_FIXED_OVERHEAD + klen + vlen
    if len(raw) % stride:
        raise UnsupportedBatch("uniform rows: stride drift")
    n = len(raw) // stride
    mat = np.frombuffer(raw, dtype=np.uint8).reshape(n, stride)
    pos = 0
    klens = mat[:, pos:pos + 4].copy().view("<u4").reshape(n)
    pos += 4
    key_bytes = mat[:, pos:pos + klen]
    pos += klen
    seqs = mat[:, pos:pos + 8].copy().view("<u8").reshape(n)
    pos += 8
    vtypes = mat[:, pos].astype(np.uint32)
    pos += 1
    vlens = mat[:, pos:pos + 4].copy().view("<u4").reshape(n)
    pos += 4
    val_bytes = mat[:, pos:pos + vlen]
    if not (klens == klen).all() or not (vlens == vlen).all():
        raise UnsupportedBatch("uniform rows: row width drift")
    key_buf = np.zeros((n, 24), dtype=np.uint8)
    key_buf[:, :klen] = key_bytes
    vw = max(2, (vlen + 3) // 4)
    val_buf = np.zeros((n, vw * 4), dtype=np.uint8)
    if vlen:
        val_buf[:, :vlen] = val_bytes
    return {
        "key_words_be": key_buf.view(">u4").astype(np.uint32).reshape(n, 6),
        "key_words_le": key_buf.view("<u4").reshape(n, 6).copy(),
        "key_len": klens.astype(np.uint32),
        "seq_hi": (seqs >> np.uint64(32)).astype(np.uint32),
        "seq_lo": (seqs & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        "vtype": vtypes,
        "val_words": val_buf.view("<u4").reshape(n, vw).copy(),
        "val_len": vlens.astype(np.uint32),
    }


def planar_stride(klen: int, vlen: int) -> int:
    """Approximate PLANAR bytes per entry (seq32 layout: key + seq_lo +
    vtype + value), for block and file sizing."""
    return klen + vlen + 9


def planar_widths(arrays: Dict[str, np.ndarray], count: int):
    """(klen, vlen) for the PLANAR sink, or None. DELETE rows carry no
    value in the planar layout, so kept tombstones coexist with
    fixed-width values."""
    if count == 0:
        return None
    kl = arrays["key_len"][:count]
    k0 = int(kl[0])
    if not ((kl == k0).all() and 0 < k0 <= 24):
        return None
    vt = arrays["vtype"][:count]
    vl = arrays["val_len"][:count]
    non_del = vl[vt != _DELETE]
    v0 = int(non_del[0]) if len(non_del) else 0
    if len(non_del) and not (non_del == v0).all():
        return None
    if not (vl[vt == _DELETE] == 0).all():
        return None
    if v0 > PLANAR_MAX_VLEN:  # the header holds a u16 vlen
        return None
    return k0, v0


def _block_codec(raw: bytes, compression: int, zlib_codec: int,
                 rlz_codec: int, plain_codec: int):
    """(codec, payload): the compressed block where it is smaller."""
    if compression == COMPRESSION_ZLIB:
        z = zlib.compress(raw, 1)
        if len(z) < len(raw):
            return zlib_codec, z
    elif compression == COMPRESSION_RLZ:
        z = rlz.compress(raw)
        if len(z) < len(raw):
            return rlz_codec, z
    return plain_codec, raw


def _finish(writer: SSTWriter, bloom_words: Optional[np.ndarray],
            key_bytes: np.ndarray, bits_per_key: int,
            extra_props: dict) -> dict:
    """Close the file with the prebuilt bitmap, or a host-built one."""
    if bloom_words is not None:
        bloom = BloomFilter(len(bloom_words),
                            np.asarray(bloom_words, dtype=np.uint32))
    else:
        bloom = BloomFilter.build(
            [key_bytes[i].tobytes() for i in range(len(key_bytes))],
            bits_per_key)
    return writer.finish(precomputed_bloom=bloom, extra_props=extra_props)


def _write_planar(arrays: Dict[str, np.ndarray], count: int, path: str,
                  bloom_words: Optional[np.ndarray], block_entries: int,
                  compression: int, bits_per_key: int, klen: int,
                  vlen: int) -> dict:
    """PLANAR sink: per-block plane bytes and word-domain checksums."""
    seq32 = bool((arrays["seq_hi"][:count] == 0).all())
    full_words = plane_words(block_entries, klen, vlen, seq32)
    writer = SSTWriter(path, compression=compression,
                       bits_per_key=bits_per_key)
    try:
        key_bytes = _key_bytes(arrays, count, klen)
        seqs = _seqs(arrays, count)
        chks: List[int] = []
        for start in range(0, count, block_entries):
            end = min(start + block_entries, count)
            raw = encode_planar_block(arrays, start, end, klen, vlen, seq32)
            chks.append(poly_checksum_words(
                np.frombuffer(raw, dtype="<u4", offset=PLANAR_HEADER.size),
                full_words))
            codec, payload = _block_codec(raw, compression, BLOCK_PLANAR_ZLIB,
                                          BLOCK_PLANAR_RLZ, BLOCK_PLANAR)
            writer.add_encoded_block(
                payload, last_key=key_bytes[end - 1].tobytes(),
                num_entries=end - start, keys=[],
                min_key=key_bytes[start].tobytes(),
                max_key=key_bytes[end - 1].tobytes(),
                min_seq=int(seqs[start:end].min()),
                max_seq=int(seqs[start:end].max()), compressed=False,
                codec=codec)
        return _finish(writer, bloom_words, key_bytes, bits_per_key, {
            "num_keys": int(count),
            "planar": planar_props(klen, vlen, seq32),
            "block_chk": {"algo": "poly1w", "block_words": int(full_words),
                          "values": chks},
        })
    except BaseException:
        writer.abandon()
        raise


def _read_planar_arrays(reader) -> Optional[Dict[str, np.ndarray]]:
    """PLANAR source: per-block plane decode, lanes concatenated."""
    try:
        parts = [decode_planar_block(reader._read_block(i, fill_cache=False))
                 for i in range(len(reader._index))]
    except Exception:
        return None  # foreign or corrupt planar props: the tuple path
    if not parts:
        return None
    lanes = {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}
    return _with_global_seqno(lanes, reader.global_seqno)


def write_sst_from_arrays(
    arrays: Dict[str, np.ndarray],
    count: int,
    path: str,
    bloom_words: Optional[np.ndarray] = None,
    block_entries: int = 1024,
    compression: int = COMPRESSION_ZLIB,
    bits_per_key: int = 10,
    planar: bool = False,
) -> Optional[dict]:
    """Write the first ``count`` rows of kernel-output lanes as a TSST
    file. Returns the props, or None when the rows lack the uniform
    widths the layout needs (the caller takes the tuple path).
    ``bloom_words`` is a prebuilt bitmap (K3's); without it the bloom is
    built on the host. ``planar`` picks PLANAR blocks over entry rows."""
    if planar:
        widths = planar_widths(arrays, count)
        if widths is None:
            return None
        return _write_planar(arrays, count, path, bloom_words, block_entries,
                             compression, bits_per_key, *widths)
    widths = uniform_widths(arrays, count)
    if widths is None:
        return None
    klen, vlen = widths
    writer = SSTWriter(path, compression=compression,
                       bits_per_key=bits_per_key)
    try:
        key_bytes = _key_bytes(arrays, count, klen)
        seqs = _seqs(arrays, count)
        for start in range(0, count, block_entries):
            end = min(start + block_entries, count)
            raw = encode_uniform_block(arrays, start, end, klen, vlen)
            codec, payload = _block_codec(raw, compression, COMPRESSION_ZLIB,
                                          COMPRESSION_RLZ, 0)
            writer.add_encoded_block(
                payload, last_key=key_bytes[end - 1].tobytes(),
                num_entries=end - start, keys=[],
                min_key=key_bytes[start].tobytes(),
                max_key=key_bytes[end - 1].tobytes(),
                min_seq=int(seqs[start:end].min()),
                max_seq=int(seqs[start:end].max()), compressed=False,
                codec=codec)
        # the uniform prop lets read_sst_arrays decode the file back
        return _finish(writer, bloom_words, key_bytes, bits_per_key, {
            "num_keys": int(count), "uniform": [int(klen), int(vlen)]})
    except BaseException:
        writer.abandon()
        raise
