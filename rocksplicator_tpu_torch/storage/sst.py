"""TSST — the sorted-string-table file format; the port's copy of
``rocksplicator_tpu/storage/sst.py``.

Reference: RocksDB SST files (the engine's persistent sorted runs), incl.
the properties the admin plane reads and the ``global_seqno`` mechanism
used by ``IngestExternalFile`` (admin_handler.cpp:1819-1827 ingests with
``allow_global_seqno``).

Layout (all little-endian):

    [data block 0] ... [data block N-1]
    [bloom block]
    [index block]     per block: varstr last_key, u64 offset, u32 size, u8 compressed
    [props JSON]
    [footer]          fixed size, see _FOOTER

Data block entry: u32 key_len, key, u64 seq, u8 vtype, u32 val_len, val —
entries strictly sorted by (key asc, seq desc). Blocks optionally
zlib-compressed (standing in for the reference's Snappy/ZSTD block
compression; the codec byte keeps the format open for a device-side
encoder).

A file-level ``global_seqno`` overrides per-entry seqs at read time —
exactly how ingestion assigns sequence numbers without rewriting the file.
"""

from __future__ import annotations

import bisect
import itertools
import json
import os
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

from ..testing import failpoints as fp
from ..utils.stats import Stats
from . import rlz
from .bloom import BloomFilter
from .errors import Corruption, InvalidArgument
from .records import OpType

MAGIC = b"TSSTv1\x00\x00"
_FOOTER = struct.Struct("<QQQQIQB8s")  # bloom_off, index_off, props_off,
# global_seqno, num_blocks, num_entries, flags, magic
_ENTRY_HEAD = struct.Struct("<I")
_ENTRY_META = struct.Struct("<QBI")
_INDEX_ENTRY = struct.Struct("<QIB")

COMPRESSION_NONE = 0
COMPRESSION_ZLIB = 1
# PLANAR block encodings (storage/planar.py): struct-of-array u32 planes
# instead of an entry byte stream. Same index/footer container; the codec
# nibble selects decoding per block.
BLOCK_PLANAR = 2
BLOCK_PLANAR_ZLIB = 3
# RLZ1 (storage/rlz.py + native rlz_compress): the fast owned codec —
# snappy-class speed for the ingest path where zlib's CPU cost bites
# (the reference's Snappy/ZSTD block compression analog)
COMPRESSION_RLZ = 4
BLOCK_PLANAR_RLZ = 5

# bytes per entry besides key+value: u32 klen, u64 seq, u8 vtype, u32 vlen
ENTRY_FIXED_OVERHEAD = _ENTRY_HEAD.size + _ENTRY_META.size

FLAG_HAS_GLOBAL_SEQNO = 1

# ---------------------------------------------------------------------------
# Decoded-block cache
# ---------------------------------------------------------------------------

# Default budget for the process-global decoded-block LRU. Every `get`
# that touches an SST used to re-read AND re-decompress its block from
# disk; the cache holds decompressed (checksum-verified) block payloads.
# Env-tunable: RSTPU_BLOCK_CACHE_BYTES=0 disables, any other value is the
# byte budget. (rocksdb analog: block_cache / LRUCache.)
BLOCK_CACHE_DEFAULT_BYTES = 32 << 20
_BLOCK_CACHE_ENV = "RSTPU_BLOCK_CACHE_BYTES"

_cache_tokens = itertools.count(1)


class BlockCache:
    """Byte-budgeted process-global LRU of decompressed data blocks,
    keyed by (reader token, block index). Per-reader tokens — not paths —
    key the entries, so a file GC'd and a new file reusing its name can
    never alias; SSTReader.close() drops its token's entries (file GC
    closes readers, which is the invalidation hook).

    Counters on /stats: ``storage.block_cache.hit`` for every cache-served
    block, ``storage.block_cache.miss`` for point-read fills. Bulk scans
    (compaction sources, iterators) probe the cache but do not fill or
    count misses — they would evict the working set and skew the rate
    (rocksdb's fill_cache=false convention)."""

    _instance: Optional["BlockCache"] = None
    _disabled = False
    _instance_lock = threading.Lock()

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self._lock = threading.Lock()
        self._blocks: "OrderedDict[Tuple[int, int], bytes]" = OrderedDict()
        self._bytes = 0
        self._by_token: Dict[int, set] = {}

    # -- singleton --------------------------------------------------------

    @classmethod
    def get_instance(cls) -> Optional["BlockCache"]:
        if cls._instance is None and not cls._disabled:
            with cls._instance_lock:
                if cls._instance is None and not cls._disabled:
                    try:
                        cap = int(os.environ.get(
                            _BLOCK_CACHE_ENV, BLOCK_CACHE_DEFAULT_BYTES))
                    except ValueError:
                        cap = BLOCK_CACHE_DEFAULT_BYTES
                    if cap > 0:
                        cls._instance = cls(cap)
                    else:
                        cls._disabled = True
        return cls._instance

    @classmethod
    def reset_for_test(cls, capacity: Optional[int] = None) -> None:
        """Drop the singleton; next use re-reads the env (or uses the
        explicit ``capacity``)."""
        with cls._instance_lock:
            cls._disabled = False
            if capacity is None:
                cls._instance = None
            elif capacity > 0:
                cls._instance = cls(capacity)
            else:
                cls._instance = None
                cls._disabled = True

    # -- cache ops --------------------------------------------------------

    def get(self, token: int, idx: int) -> Optional[bytes]:
        with self._lock:
            raw = self._blocks.get((token, idx))
            if raw is not None:
                self._blocks.move_to_end((token, idx))
            return raw

    def put(self, token: int, idx: int, raw: bytes) -> None:
        size = len(raw)
        if size > self.capacity:
            return
        with self._lock:
            key = (token, idx)
            if key in self._blocks:
                self._blocks.move_to_end(key)
                return
            self._blocks[key] = raw
            self._bytes += size
            self._by_token.setdefault(token, set()).add(idx)
            while self._bytes > self.capacity and self._blocks:
                (t, i), v = self._blocks.popitem(last=False)
                self._bytes -= len(v)
                idxs = self._by_token.get(t)
                if idxs is not None:
                    idxs.discard(i)
                    if not idxs:
                        del self._by_token[t]

    def drop(self, token: int) -> None:
        """Invalidate every block of one reader (close/file-GC hook)."""
        with self._lock:
            idxs = self._by_token.pop(token, None)
            if not idxs:
                return
            for i in idxs:
                raw = self._blocks.pop((token, i), None)
                if raw is not None:
                    self._bytes -= len(raw)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"bytes": self._bytes, "blocks": len(self._blocks),
                    "capacity": self.capacity}


def _encode_entry(key: bytes, seq: int, vtype: int, value: bytes) -> bytes:
    return (
        _ENTRY_HEAD.pack(len(key))
        + key
        + _ENTRY_META.pack(seq, vtype, len(value))
        + value
    )


class SSTWriter:
    """Writes entries in strictly ascending (key, -seq) order."""

    def __init__(
        self,
        path: str,
        block_bytes: int = 32 * 1024,
        compression: int = COMPRESSION_ZLIB,
        bits_per_key: int = 10,
    ):
        self._path = path
        self._block_bytes = block_bytes
        self._compression = compression
        self._bits_per_key = bits_per_key
        self._file = open(path, "wb")
        self._block: List[bytes] = []
        self._block_size = 0
        self._index: List[Tuple[bytes, int, int, int]] = []
        self._offset = 0
        self._keys: List[bytes] = []
        self._last_key: Optional[bytes] = None
        self._last_seq = 0
        self._num_entries = 0
        self._min_key: Optional[bytes] = None
        self._max_key: Optional[bytes] = None
        self._min_seq: Optional[int] = None
        self._max_seq = 0
        self._raw_bytes = 0
        self._finished = False

    def add(self, key: bytes, seq: int, vtype: int, value: bytes) -> None:
        if self._last_key is not None and (
            key < self._last_key or (key == self._last_key and seq >= self._last_seq)
        ):
            raise InvalidArgument(
                f"keys out of order: {key!r}@{seq} after {self._last_key!r}@{self._last_seq}"
            )
        if self._last_key != key:
            self._keys.append(key)
        self._last_key, self._last_seq = key, seq
        # entries buffer as tuples; the whole block encodes in ONE native
        # call at flush (tsst_encode_block) instead of per-entry Python
        esize = ENTRY_FIXED_OVERHEAD + len(key) + len(value)
        self._block.append((key, seq, int(vtype), value))
        self._block_size += esize
        self._raw_bytes += esize
        self._num_entries += 1
        if self._min_key is None:
            self._min_key = key
        self._max_key = key
        if self._min_seq is None or seq < self._min_seq:
            self._min_seq = seq
        self._max_seq = max(self._max_seq, seq)
        if self._block_size >= self._block_bytes:
            self._flush_block()

    def add_encoded_block(self, block_payload: bytes, last_key: bytes,
                          num_entries: int, keys: List[bytes],
                          min_key: bytes, max_key: bytes,
                          min_seq: int, max_seq: int,
                          compressed: bool, codec: Optional[int] = None
                          ) -> None:
        """Accepts a pre-encoded data block — the array sink's output
        path (``gpu/format.py``): blocks arrive already packed (and optionally compressed) and
        are appended without re-serialization. ``codec`` overrides the
        compressed flag for non-entry-stream encodings (BLOCK_PLANAR*)."""
        if self._block:
            self._flush_block()
        self._file.write(block_payload)
        if codec is None:
            codec = COMPRESSION_ZLIB if compressed else COMPRESSION_NONE
        self._index.append(
            (last_key, self._offset, len(block_payload), codec)
        )
        self._offset += len(block_payload)
        self._keys.extend(keys)
        self._num_entries += num_entries
        self._raw_bytes += len(block_payload)
        if self._min_key is None:
            self._min_key = min_key
        self._max_key = max_key
        if self._min_seq is None or min_seq < self._min_seq:
            self._min_seq = min_seq
        self._max_seq = max(self._max_seq, max_seq)
        self._last_key = max_key
        self._last_seq = 0

    def _flush_block(self) -> None:
        if not self._block:
            return
        from .native.binding import NATIVE

        if NATIVE is not None:
            raw = NATIVE.encode_block(
                [e[0] for e in self._block], [e[1] for e in self._block],
                [e[2] for e in self._block], [e[3] for e in self._block],
            )
        else:
            raw = b"".join(_encode_entry(*e) for e in self._block)
        codec = self._compression
        if codec == COMPRESSION_ZLIB:
            payload = zlib.compress(raw, 1)
        elif codec == COMPRESSION_RLZ:
            payload = rlz.compress(raw)
        else:
            payload = raw
        if len(payload) >= len(raw):
            codec, payload = COMPRESSION_NONE, raw
        assert self._last_key is not None
        self._index.append((self._last_key, self._offset, len(payload), codec))
        self._file.write(payload)
        self._offset += len(payload)
        self._block = []
        self._block_size = 0

    def finish(self, global_seqno: Optional[int] = None,
               extra_props: Optional[Dict] = None,
               precomputed_bloom: Optional[BloomFilter] = None) -> Dict:
        """``precomputed_bloom`` lets a kernel-built bitmap (byte-identical
        format) be written directly — the device pipeline's sink path."""
        if self._finished:
            raise InvalidArgument("finish() called twice")
        self._flush_block()
        bloom_off = self._offset
        bloom = (
            precomputed_bloom if precomputed_bloom is not None
            else BloomFilter.build(self._keys, self._bits_per_key)
        )
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
        props = {
            "num_entries": self._num_entries,
            "num_keys": len(self._keys),
            "raw_bytes": self._raw_bytes,
            "min_key": self._min_key.hex() if self._min_key is not None else None,
            "max_key": self._max_key.hex() if self._max_key is not None else None,
            "min_seq": self._min_seq or 0,
            "max_seq": self._max_seq,
        }
        if extra_props:
            props.update(extra_props)
        props_bytes = json.dumps(props).encode("utf-8")
        self._file.write(props_bytes)
        flags = FLAG_HAS_GLOBAL_SEQNO if global_seqno is not None else 0
        self._file.write(
            _FOOTER.pack(
                bloom_off, index_off, props_off,
                global_seqno if global_seqno is not None else 0,
                len(self._index), self._num_entries, flags, MAGIC,
            )
        )
        # fsync BEFORE the manifest can reference this file: the engine
        # purges WAL once the manifest is durable, so an un-fsynced SST
        # would leave a durable manifest pointing at pages power loss
        # can drop, with no WAL left to replay. (The dirent rides the
        # manifest writer's directory fsync, which happens after this.)
        self._file.flush()
        fp.hit("sst.fsync")
        os.fsync(self._file.fileno())
        self._file.close()
        # Only now is the file complete — a failure anywhere above leaves
        # _finished False so abandon() still closes and removes it.
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
    """Thread-safe reader: block reads use positioned pread so concurrent
    gets/iterators never race on a shared file offset."""

    def __init__(self, path: str):
        self._path = path
        self._fd = os.open(path, os.O_RDONLY)
        file_size = os.fstat(self._fd).st_size
        if file_size < _FOOTER.size:
            os.close(self._fd)
            raise Corruption(f"{path}: too small for footer")
        try:
            footer_raw = os.pread(self._fd, _FOOTER.size, file_size - _FOOTER.size)
            (
                bloom_off, index_off, props_off, global_seqno,
                num_blocks, num_entries, flags, magic,
            ) = _FOOTER.unpack(footer_raw)
            if magic != MAGIC:
                raise Corruption(f"{path}: bad magic")
        except Corruption:
            os.close(self._fd)
            raise
        self.global_seqno: Optional[int] = (
            global_seqno if flags & FLAG_HAS_GLOBAL_SEQNO else None
        )
        self.num_entries = num_entries
        # cached once at open: the engine's level-bytes / write-amp
        # gauges sum these under the DB lock without touching the fs
        self.file_size = file_size
        self._bloom = BloomFilter.from_bytes(
            os.pread(self._fd, index_off - bloom_off, bloom_off)
        )
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
            self._fd, file_size - _FOOTER.size - props_off, props_off
        )
        self.props: Dict = json.loads(props_raw.decode("utf-8")) if props_raw else {}
        self._verified_blocks: set = set()
        self._cache_token = next(_cache_tokens)
        # block last_keys for bisect (get_entries_many groups keys/block)
        self._last_keys: List[bytes] = [e[0] for e in self._index]

    # -- reads ------------------------------------------------------------

    def _read_block(self, block_idx: int, fill_cache: bool = True) -> bytes:
        cache = BlockCache.get_instance()
        if cache is not None:
            raw = cache.get(self._cache_token, block_idx)
            if raw is not None:
                Stats.get().incr("storage.block_cache.hit")
                return raw
        _last_key, off, size, codec = self._index[block_idx]
        payload = os.pread(self._fd, size, off)
        if codec in (COMPRESSION_ZLIB, BLOCK_PLANAR_ZLIB):
            raw = zlib.decompress(payload)
        elif codec in (COMPRESSION_RLZ, BLOCK_PLANAR_RLZ):
            # bound: a block decodes to at most a handful of block_bytes
            # (the writer flushes at the threshold); 64 MiB is far above
            # any legitimate block and guards a crafted header
            raw = rlz.decompress(payload, 64 << 20)
        elif codec in (COMPRESSION_NONE, BLOCK_PLANAR):
            raw = payload
        else:
            # a file from a newer writer (future codec) must fail LOUDLY,
            # not parse compressed bytes as entries
            raise Corruption(
                f"unsupported block codec {codec} (newer writer?)")
        self._verify_block_chk(block_idx, raw)
        if cache is not None and fill_cache:
            # only verified payloads enter the cache (a cached block skips
            # re-verification, like the _verified_blocks memo)
            Stats.get().incr("storage.block_cache.miss")
            cache.put(self._cache_token, block_idx, raw)
        return raw

    def _block_is_planar(self, block_idx: int) -> bool:
        return self._index[block_idx][3] in (
            BLOCK_PLANAR, BLOCK_PLANAR_ZLIB, BLOCK_PLANAR_RLZ)

    def _verify_block_chk(self, block_idx: int, raw: bytes) -> None:
        """Device-computed per-block integrity checksums (props
        "block_chk", written by the array sink — ops/block_encode.py).
        Files without the prop (v1 / flush-written) skip verification;
        crafted/foreign prop shapes degrade to no verification rather
        than raising arbitrary exceptions (same convention as the
        'uniform' prop). A verified block index is cached so repeated
        point lookups don't recompute the checksum."""
        chk = self.props.get("block_chk")
        try:
            if (
                not isinstance(chk, dict)
                or chk.get("algo") not in ("poly1", "poly1w")
                or block_idx >= len(chk["values"])
                or block_idx in self._verified_blocks
            ):
                return
            algo = chk["algo"]
            want = int(chk["values"][block_idx]) & 0xFFFFFFFF
            if algo == "poly1w":
                block_len = int(chk["block_words"])
            else:
                block_len = int(chk["block_bytes"])
        except (KeyError, TypeError, ValueError):
            return  # foreign/crafted prop — treat as absent
        if algo == "poly1w":
            # word-domain MAC over a planar block's plane words (the
            # 16-byte header is host-written and excluded)
            import numpy as np

            from .planar import PLANAR_HEADER
            from ..utils.checksum import poly_checksum_words

            if (
                len(raw) < PLANAR_HEADER.size
                or (len(raw) - PLANAR_HEADER.size) % 4
            ):
                raise Corruption(
                    f"block {block_idx}: truncated planar block "
                    f"({len(raw)} bytes)"
                )
            words = np.frombuffer(raw, dtype="<u4",
                                  offset=PLANAR_HEADER.size)
            got = poly_checksum_words(words, length=block_len)
        else:
            from ..utils.checksum import poly_checksum

            got = poly_checksum(raw, length=block_len)
        if got != want:
            raise Corruption(
                f"block {block_idx} checksum mismatch: "
                f"{got:#010x} != {want:#010x}"
            )
        self._verified_blocks.add(block_idx)

    @staticmethod
    def _iter_block(raw: bytes) -> Iterator[Tuple[bytes, int, int, bytes]]:
        from .native.binding import NATIVE

        if NATIVE is not None:
            yield from NATIVE.decode_block(raw)
            return
        pos = 0
        while pos < len(raw):
            (klen,) = _ENTRY_HEAD.unpack_from(raw, pos)
            pos += _ENTRY_HEAD.size
            key = raw[pos:pos + klen]
            pos += klen
            seq, vtype, vlen = _ENTRY_META.unpack_from(raw, pos)
            pos += _ENTRY_META.size
            value = raw[pos:pos + vlen]
            pos += vlen
            yield key, seq, vtype, value

    def _block_iter(
        self, block_idx: int, raw: bytes
    ) -> Iterator[Tuple[bytes, int, int, bytes]]:
        """Per-block decode dispatch: planar blocks (codec nibble) decode
        via the plane codec; entry-stream blocks via _iter_block."""
        if self._block_is_planar(block_idx):
            from .planar import iter_planar_block

            return iter_planar_block(raw)
        return self._iter_block(raw)

    def _effective_seq(self, seq: int) -> int:
        return self.global_seqno if self.global_seqno is not None else seq

    def may_contain(self, key: bytes) -> bool:
        return self._bloom.may_contain(key)

    def get_entries(self, key: bytes) -> List[Tuple[int, int, bytes]]:
        """ALL entries for key, newest first: [(seq, vtype, value)].
        Multiple entries occur for stacked MERGE operands — callers must
        fold through the whole stack, not just the newest."""
        if not self._bloom.may_contain(key):
            return []
        # binary search over block last_keys for the first candidate block
        lo, hi = 0, len(self._index) - 1
        block = None
        while lo <= hi:
            mid = (lo + hi) // 2
            if self._index[mid][0] < key:
                lo = mid + 1
            else:
                block = mid
                hi = mid - 1
        if block is None:
            return []
        from .native.binding import NATIVE

        out: List[Tuple[int, int, bytes]] = []
        # Entries for one key are contiguous and (seq desc)-ordered but may
        # span a block boundary.
        for b in range(block, len(self._index)):
            raw = self._read_block(b)
            done = False
            if NATIVE is None:
                native_res = None
            elif self._block_is_planar(b):
                native_res = NATIVE.planar_get_entries(raw, key)
            else:
                native_res = NATIVE.get_entries(raw, key)
            if native_res is not None:
                matches, past_end = native_res
                out.extend(
                    (self._effective_seq(seq), vtype, value)
                    for seq, vtype, value in matches
                )
                done = past_end
            else:
                for k, seq, vtype, value in self._block_iter(b, raw):
                    if k == key:
                        out.append((self._effective_seq(seq), vtype, value))
                    elif k > key:
                        done = True
                        break
            if done or (out and b < len(self._index) - 1
                        and self._index[b][0] > key):
                break
        return out

    def get(self, key: bytes) -> Optional[Tuple[int, int, bytes]]:
        """Newest entry for key: (seq, vtype, value) or None."""
        entries = self.get_entries(key)
        return entries[0] if entries else None

    def get_entries_many(
        self, keys: List[bytes], hashes=None
    ) -> Dict[bytes, List[Tuple[int, int, bytes]]]:
        """Entry stacks (newest first, as get_entries) for MANY keys:
        blooms checked in one batch, keys sorted and grouped per block so
        each touched block is read (or cache-hit) and decoded ONCE —
        the multi_get path. Keys with no entries are absent from the
        result. ``hashes`` is an optional ``(row_of_key, h1, mask)``
        triple from ``bloom.hash_many`` so a multi-SST read hashes each
        key once, not once per file."""
        import numpy as np

        out: Dict[bytes, List[Tuple[int, int, bytes]]] = {}
        if not self._index or not keys:
            return out
        cand = sorted(set(keys))
        if hashes is not None:
            rows_of, h1_all, mask_all = hashes
            rows = np.fromiter((rows_of[k] for k in cand),
                               dtype=np.intp, count=len(cand))
            mask = self._bloom.may_contain_hashed(
                h1_all[rows], mask_all[rows])
        else:
            mask = self._bloom.may_contain_many(cand)
        per_block: Dict[int, List[bytes]] = {}
        for k, ok in zip(cand, mask):
            if not ok:
                continue
            b = bisect.bisect_left(self._last_keys, k)
            if b < len(self._index):
                per_block.setdefault(b, []).append(k)
        heap = sorted(per_block)
        pos = 0
        while pos < len(heap):
            b = heap[pos]
            pos += 1
            want = per_block[b]
            raw = self._read_block(b)
            entries = list(self._block_iter(b, raw))
            ekeys = [e[0] for e in entries]
            for k in want:
                j = bisect.bisect_left(ekeys, k)
                while j < len(entries) and ekeys[j] == k:
                    _k, seq, vtype, value = entries[j]
                    out.setdefault(k, []).append(
                        (self._effective_seq(seq), vtype, value))
                    j += 1
                if j == len(entries) and b + 1 < len(self._index):
                    # the key's stack may continue into the next block
                    # (same continuation rule as get_entries)
                    nxt = per_block.get(b + 1)
                    if nxt is None:
                        per_block[b + 1] = [k]
                        # keep the worklist ordered: b+1 precedes any
                        # later scheduled block or is processed next
                        heap.insert(pos, b + 1)
                    elif k not in nxt:
                        nxt.append(k)
        return out

    def iterate(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, int, int, bytes]]:
        """All entries (key, seq, vtype, value) in order, [start, end)."""
        for i, (last_key, _off, _size, _codec) in enumerate(self._index):
            if start is not None and last_key < start:
                continue
            # bulk scan: probe the cache but don't fill it (a compaction
            # or full iteration would evict the point-read working set)
            for key, seq, vtype, value in self._block_iter(
                    i, self._read_block(i, fill_cache=False)):
                if start is not None and key < start:
                    continue
                if end is not None and key >= end:
                    return
                yield key, self._effective_seq(seq), vtype, value

    def min_key(self) -> Optional[bytes]:
        mk = self.props.get("min_key")
        return bytes.fromhex(mk) if mk else None

    def max_key(self) -> Optional[bytes]:
        mk = self.props.get("max_key")
        return bytes.fromhex(mk) if mk else None

    def max_seq(self) -> int:
        if self.global_seqno is not None:
            return self.global_seqno
        return self.props.get("max_seq", 0)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
            cache = BlockCache.get_instance()
            if cache is not None:
                # file GC closes readers — cached blocks die with them
                cache.drop(self._cache_token)
