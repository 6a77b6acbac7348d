"""TSST, the sorted-string-table file format — counterpart of
``rocksplicator_tpu/storage/sst.py``: the writer of pre-encoded blocks
the array sink uses (``gpu/format.py``) and a reader of whole files.

Layout (all little-endian):

    [data block 0] ... [data block N-1]
    [bloom block]
    [index block]     per block: u32 klen, last_key, u64 offset, u32 size,
                      u8 codec
    [props JSON]
    [footer]          see _FOOTER

Entry-stream block entry: u32 key_len, key, u64 seq, u8 vtype, u32
val_len, val; planar blocks are ``storage/planar.py``'s. A file-level
``global_seqno`` overrides per-entry seqs at read time.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import rlz
from .bloom import BloomFilter
from .errors import Corruption, InvalidArgument
from .planar import PLANAR_HEADER, iter_planar_block
from ..utils.checksum import poly_checksum, poly_checksum_words

MAGIC = b"TSSTv1\x00\x00"
# bloom_off, index_off, props_off, global_seqno, num_blocks, num_entries,
# flags, magic
_FOOTER = struct.Struct("<QQQQIQB8s")
_ENTRY_HEAD = struct.Struct("<I")
_ENTRY_META = struct.Struct("<QBI")
_INDEX_ENTRY = struct.Struct("<QIB")

COMPRESSION_NONE = 0
COMPRESSION_ZLIB = 1
BLOCK_PLANAR = 2
BLOCK_PLANAR_ZLIB = 3
COMPRESSION_RLZ = 4
BLOCK_PLANAR_RLZ = 5
_PLANAR_CODECS = (BLOCK_PLANAR, BLOCK_PLANAR_ZLIB, BLOCK_PLANAR_RLZ)

# bytes per entry besides key+value: u32 klen, u64 seq, u8 vtype, u32 vlen
ENTRY_FIXED_OVERHEAD = _ENTRY_HEAD.size + _ENTRY_META.size

FLAG_HAS_GLOBAL_SEQNO = 1
# an RLZ block decodes to a few block_bytes at most; the cap guards a
# crafted header
_RLZ_MAX_BLOCK = 64 << 20


class SSTWriter:
    """Writes pre-encoded data blocks in key order, then the bloom, index,
    props and footer."""

    def __init__(self, path: str):
        self._path = path
        self._file = open(path, "wb")
        self._index: List[Tuple[bytes, int, int, int]] = []
        self._offset = 0
        self._num_entries = 0
        self._min_key: Optional[bytes] = None
        self._max_key: Optional[bytes] = None
        self._min_seq: Optional[int] = None
        self._max_seq = 0
        self._raw_bytes = 0
        self._finished = False

    def add_encoded_block(self, block_payload: bytes, last_key: bytes,
                          num_entries: int, min_key: bytes, max_key: bytes,
                          min_seq: int, max_seq: int, codec: int) -> None:
        """Append one encoded (and possibly compressed) data block whose
        index entry carries ``codec``."""
        self._file.write(block_payload)
        self._index.append((last_key, self._offset, len(block_payload),
                            codec))
        self._offset += len(block_payload)
        self._num_entries += num_entries
        # the reference counts a block's stored bytes here
        self._raw_bytes += len(block_payload)
        if self._min_key is None:
            self._min_key = min_key
        self._max_key = max_key
        if self._min_seq is None or min_seq < self._min_seq:
            self._min_seq = min_seq
        self._max_seq = max(self._max_seq, max_seq)

    def finish(self, bloom: BloomFilter,
               extra_props: Optional[Dict] = None) -> Dict:
        """Write bloom, index, props and footer, fsync and close; returns
        the props."""
        if self._finished:
            raise InvalidArgument("finish() called twice")
        bloom_off = self._offset
        bloom_bytes = bloom.to_bytes()
        self._file.write(bloom_bytes)
        index_off = bloom_off + len(bloom_bytes)
        index_parts = []
        for last_key, off, size, codec in self._index:
            index_parts.append(struct.pack("<I", len(last_key)))
            index_parts.append(last_key)
            index_parts.append(_INDEX_ENTRY.pack(off, size, codec))
        index_bytes = b"".join(index_parts)
        self._file.write(index_bytes)
        props_off = index_off + len(index_bytes)
        # the reference's key order; its block-level key list is empty
        # for pre-encoded blocks, so "num_keys" is 0 until extra_props sets
        # it
        props = {
            "num_entries": self._num_entries,
            "num_keys": 0,
            "raw_bytes": self._raw_bytes,
            "min_key": (self._min_key.hex() if self._min_key is not None
                        else None),
            "max_key": (self._max_key.hex() if self._max_key is not None
                        else None),
            "min_seq": self._min_seq or 0,
            "max_seq": self._max_seq,
        }
        if extra_props:
            props.update(extra_props)
        self._file.write(json.dumps(props).encode("utf-8"))
        self._file.write(_FOOTER.pack(
            bloom_off, index_off, props_off, 0, len(self._index),
            self._num_entries, 0, MAGIC))
        # durable before a manifest can name the file
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        self._finished = True
        return props

    def abandon(self) -> None:
        if not self._finished:
            self._file.close()
            try:
                os.remove(self._path)
            except OSError:
                pass


class SSTReader:
    """Reads a TSST file: footer, index and props at open, data blocks on
    demand (decoded and checked against the "block_chk" prop)."""

    def __init__(self, path: str):
        self._path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            file_size = os.fstat(self._fd).st_size
            if file_size < _FOOTER.size:
                raise Corruption(f"{path}: too small for footer")
            (_bloom_off, index_off, props_off, global_seqno, num_blocks,
             num_entries, flags, magic) = _FOOTER.unpack(
                os.pread(self._fd, _FOOTER.size, file_size - _FOOTER.size))
            if magic != MAGIC:
                raise Corruption(f"{path}: bad magic")
            self.global_seqno: Optional[int] = (
                global_seqno if flags & FLAG_HAS_GLOBAL_SEQNO else None)
            self.num_entries = num_entries
            index_raw = os.pread(self._fd, props_off - index_off, index_off)
            self._index: List[Tuple[bytes, int, int, int]] = []
            pos = 0
            for _ in range(num_blocks):
                (klen,) = struct.unpack_from("<I", index_raw, pos)
                pos += 4
                last_key = index_raw[pos:pos + klen]
                pos += klen
                off, size, codec = _INDEX_ENTRY.unpack_from(index_raw, pos)
                pos += _INDEX_ENTRY.size
                self._index.append((last_key, off, size, codec))
            props_raw = os.pread(
                self._fd, file_size - _FOOTER.size - props_off, props_off)
            self.props: Dict = (json.loads(props_raw.decode("utf-8"))
                                if props_raw else {})
        except BaseException:
            os.close(self._fd)
            raise

    def _read_block(self, block_idx: int, fill_cache: bool = False) -> bytes:
        """The decoded bytes of one data block. ``fill_cache`` is accepted
        for the reference reader's signature; this reader has no cache."""
        _last_key, off, size, codec = self._index[block_idx]
        payload = os.pread(self._fd, size, off)
        if codec in (COMPRESSION_ZLIB, BLOCK_PLANAR_ZLIB):
            raw = zlib.decompress(payload)
        elif codec in (COMPRESSION_RLZ, BLOCK_PLANAR_RLZ):
            raw = rlz.decompress(payload, _RLZ_MAX_BLOCK)
        elif codec in (COMPRESSION_NONE, BLOCK_PLANAR):
            raw = payload
        else:
            raise Corruption(f"unsupported block codec {codec}")
        self._verify_block_chk(block_idx, raw)
        return raw

    def _verify_block_chk(self, block_idx: int, raw: bytes) -> None:
        """Checks a block against the "block_chk" prop where the file has
        one; a prop of a shape this reader does not know counts as absent."""
        chk = self.props.get("block_chk")
        try:
            if (not isinstance(chk, dict)
                    or chk.get("algo") not in ("poly1", "poly1w")
                    or block_idx >= len(chk["values"])):
                return
            algo = chk["algo"]
            want = int(chk["values"][block_idx]) & 0xFFFFFFFF
            block_len = int(chk["block_words" if algo == "poly1w"
                                else "block_bytes"])
        except (KeyError, TypeError, ValueError):
            return
        if algo == "poly1w":
            if (len(raw) < PLANAR_HEADER.size
                    or (len(raw) - PLANAR_HEADER.size) % 4):
                raise Corruption(f"block {block_idx}: truncated planar "
                                 f"block ({len(raw)} bytes)")
            got = poly_checksum_words(
                np.frombuffer(raw, dtype="<u4", offset=PLANAR_HEADER.size),
                length=block_len)
        else:
            got = poly_checksum(raw, length=block_len)
        if got != want:
            raise Corruption(f"block {block_idx} checksum mismatch: "
                             f"{got:#010x} != {want:#010x}")

    @staticmethod
    def _iter_entries(raw: bytes) -> Iterator[Tuple[bytes, int, int, bytes]]:
        pos = 0
        while pos < len(raw):
            (klen,) = _ENTRY_HEAD.unpack_from(raw, pos)
            pos += _ENTRY_HEAD.size
            key = raw[pos:pos + klen]
            pos += klen
            seq, vtype, vlen = _ENTRY_META.unpack_from(raw, pos)
            pos += _ENTRY_META.size
            yield key, seq, vtype, raw[pos:pos + vlen]
            pos += vlen

    def iterate(self) -> Iterator[Tuple[bytes, int, int, bytes]]:
        """Every entry (key, seq, vtype, value) in file order."""
        for i, (_key, _off, _size, codec) in enumerate(self._index):
            raw = self._read_block(i)
            entries = (iter_planar_block(raw) if codec in _PLANAR_CODECS
                       else self._iter_entries(raw))
            for key, seq, vtype, value in entries:
                yield (key, seq if self.global_seqno is None
                       else self.global_seqno, vtype, value)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
