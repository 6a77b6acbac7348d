"""ctypes binding for the port's copy of the native host library — the
counterpart of ``rocksplicator_tpu/storage/native/binding.py``.

``tsst_native.cc`` (a copy of the JAX package's source) is host C++: the
block codec, RLZ1, the WAL scan, the bloom build and the CPU
merge-resolve. It is not a CUDA kernel. It compiles with the JAX
package's flags (``g++ -O3 -fPIC -shared -std=c++17 -Wall``; ``CXX``
overrides the compiler) into ``rocksplicator_tpu_torch/_build/native/
<digest>/``, keyed on a hash of the source and the flags, on first use
(never at import) and under a lock. ``RSTPU_DISABLE_NATIVE`` set, or a
build that fails, leaves the pure-Python paths, as in the JAX package.
Arrays cross the boundary as numpy buffers.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..errors import Corruption
from ..planar import unpack_planar_header

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "tsst_native.cc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build",
                          "native")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)


def library_path() -> str:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libtsst_native.so")


def _compile(cmd: List[str]) -> None:
    """Run the compiler; raises on failure."""
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)


def _build(so: str) -> bool:
    """Compile the library into ``so`` through a file of this process, so
    a concurrent build by another process never leaves a partial file
    under the name a loader opens."""
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, _SRC]
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        _compile(cmd)
        os.replace(tmp, so)
        return True
    except Exception as e:
        log.info("native build unavailable: %s", e)
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


class NativeLib:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.tsst_crc32.restype = ctypes.c_uint32
        lib.tsst_crc32.argtypes = [_u8p, ctypes.c_uint64]
        lib.tsst_encode_block.restype = ctypes.c_int64
        lib.tsst_encode_block.argtypes = [
            _u8p, _u64p, _u64p, _u8p, _u8p, _u64p,
            ctypes.c_uint64, _u8p, ctypes.c_uint64,
        ]
        lib.tsst_decode_block.restype = ctypes.c_int64
        lib.tsst_decode_block.argtypes = [
            _u8p, ctypes.c_uint64, ctypes.c_uint64,
            _u64p, _u64p, _u64p, _u8p, _u64p, _u64p,
        ]
        lib.tsst_get_entries.restype = ctypes.c_int64
        lib.tsst_get_entries.argtypes = [
            _u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64, ctypes.c_uint64,
            _u64p, _u8p, _u64p, _u64p, ctypes.POINTER(ctypes.c_int32),
        ]
        # planar lookup may be absent in stale builds; probe and gate
        try:
            lib.tsst_planar_get_entries.restype = ctypes.c_int64
            lib.tsst_planar_get_entries.argtypes = [
                _u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64,
                ctypes.c_uint64, _u64p, _u8p, _u8p, ctypes.c_uint64,
                _u64p, ctypes.POINTER(ctypes.c_int32),
            ]
            self._has_planar = True
        except AttributeError:
            self._has_planar = False
        # CPU merge-resolve may be absent in stale builds; probe and gate
        try:
            lib.cpu_merge_resolve.restype = ctypes.c_int64
            lib.cpu_merge_resolve.argtypes = [
                _u32p, _u32p, _u64p, _u8p, _u32p, _u32p,
                ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_int32, ctypes.c_int32,
                _u32p, _u32p, _u64p, _u8p, _u32p, _u32p,
            ]
            self.has_merge_resolve = True
        except AttributeError:
            self.has_merge_resolve = False
        try:
            lib.cpu_merge_resolve_runs.restype = ctypes.c_int64
            lib.cpu_merge_resolve_runs.argtypes = [
                _u32p, _u32p, _u64p, _u8p, _u32p, _u32p, _u64p,
                ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32,
                _u32p, _u32p, _u64p, _u8p, _u32p, _u32p,
            ]
            self.has_merge_resolve_runs = True
        except AttributeError:
            self.has_merge_resolve_runs = False
        # RLZ codec may be absent in stale builds; probe and gate
        try:
            lib.rlz_compress.restype = ctypes.c_int64
            lib.rlz_compress.argtypes = [
                _u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64,
            ]
            lib.rlz_decompress.restype = ctypes.c_int64
            lib.rlz_decompress.argtypes = [
                _u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64,
            ]
            self.has_rlz = True
        except AttributeError:
            self.has_rlz = False
        lib.wal_scan.restype = ctypes.c_int64
        lib.wal_scan.argtypes = [
            _u8p, ctypes.c_uint64, ctypes.c_uint64,
            _u64p, _u64p, _u64p, _i64p,
        ]
        lib.wal_count_records.restype = ctypes.c_int64
        lib.wal_count_records.argtypes = [_u8p, ctypes.c_uint64]
        lib.bloom_add_many.restype = None
        lib.bloom_add_many.argtypes = [
            _u32p, ctypes.c_uint32, _u8p, _u64p, ctypes.c_uint64,
        ]
        lib.bloom_may_contain.restype = ctypes.c_int32
        lib.bloom_may_contain.argtypes = [
            _u32p, ctypes.c_uint32, _u8p, ctypes.c_uint64,
        ]

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _u8(arr: np.ndarray):
        return arr.ctypes.data_as(_u8p)

    @staticmethod
    def _u64(arr: np.ndarray):
        return arr.ctypes.data_as(_u64p)

    # -- API ---------------------------------------------------------------

    def crc32(self, data: bytes) -> int:
        buf = np.frombuffer(data, dtype=np.uint8)
        return int(self._lib.tsst_crc32(self._u8(buf), len(buf)))

    def encode_block(
        self, keys: List[bytes], seqs: List[int], vtypes: List[int],
        vals: List[bytes],
    ) -> bytes:
        n = len(keys)
        key_buf = np.frombuffer(b"".join(keys), dtype=np.uint8)
        val_buf = np.frombuffer(b"".join(vals), dtype=np.uint8)
        key_off = np.zeros(n + 1, dtype=np.uint64)
        val_off = np.zeros(n + 1, dtype=np.uint64)
        np.cumsum([len(k) for k in keys], out=key_off[1:])
        np.cumsum([len(v) for v in vals], out=val_off[1:])
        seq_arr = np.asarray(seqs, dtype=np.uint64)
        vt_arr = np.asarray(vtypes, dtype=np.uint8)
        cap = int(key_off[-1] + val_off[-1] + n * 17)
        out = np.empty(cap, dtype=np.uint8)
        if n == 0:
            return b""
        wrote = self._lib.tsst_encode_block(
            self._u8(key_buf if len(key_buf) else np.zeros(1, np.uint8)),
            self._u64(key_off),
            self._u64(seq_arr), self._u8(vt_arr),
            self._u8(val_buf if len(val_buf) else np.zeros(1, np.uint8)),
            self._u64(val_off),
            n, self._u8(out), cap,
        )
        if wrote < 0:
            raise ValueError("encode_block overflow")
        return out[:wrote].tobytes()

    def decode_block(self, raw: bytes) -> List[Tuple[bytes, int, int, bytes]]:
        data = np.frombuffer(raw, dtype=np.uint8)
        max_entries = max(1, len(raw) // 17)
        key_off = np.empty(max_entries, dtype=np.uint64)
        key_len = np.empty(max_entries, dtype=np.uint64)
        seqs = np.empty(max_entries, dtype=np.uint64)
        vtypes = np.empty(max_entries, dtype=np.uint8)
        val_off = np.empty(max_entries, dtype=np.uint64)
        val_len = np.empty(max_entries, dtype=np.uint64)
        n = self._lib.tsst_decode_block(
            self._u8(data), len(raw), max_entries,
            self._u64(key_off), self._u64(key_len),
            self._u64(seqs), self._u8(vtypes),
            self._u64(val_off), self._u64(val_len),
        )
        if n < 0:
            from ..errors import Corruption

            raise Corruption("native block decode failed")
        out = []
        for i in range(n):
            ko, kl = int(key_off[i]), int(key_len[i])
            vo, vl = int(val_off[i]), int(val_len[i])
            out.append((raw[ko:ko + kl], int(seqs[i]), int(vtypes[i]),
                        raw[vo:vo + vl]))
        return out

    def get_entries(self, raw: bytes, key: bytes,
                    max_matches: int = 64) -> Optional[Tuple[list, bool]]:
        """(entries, past_end) for ``key`` in one block: entries are
        (seq, vtype, value) newest-first as stored; past_end means the scan
        proved no later block can hold this key. None = slow path needed."""
        data = np.frombuffer(raw, dtype=np.uint8)
        kbuf = (np.frombuffer(key, dtype=np.uint8) if key
                else np.zeros(1, np.uint8))
        seqs = np.empty(max_matches, dtype=np.uint64)
        vtypes = np.empty(max_matches, dtype=np.uint8)
        val_off = np.empty(max_matches, dtype=np.uint64)
        val_len = np.empty(max_matches, dtype=np.uint64)
        past_end = ctypes.c_int32(0)
        n = self._lib.tsst_get_entries(
            self._u8(data), len(raw), self._u8(kbuf), len(key), max_matches,
            self._u64(seqs), self._u8(vtypes), self._u64(val_off),
            self._u64(val_len), ctypes.byref(past_end),
        )
        if n == -1:
            # overflow, not corruption: retry with room for a deeper merge
            # stack instead of falling back to a full block re-decode
            bound = max(1, len(raw) // 17)
            if max_matches < bound:
                return self.get_entries(raw, key, min(bound, max_matches * 8))
            return None
        if n < 0:
            return None
        return (
            [
                (int(seqs[i]), int(vtypes[i]),
                 raw[int(val_off[i]):int(val_off[i]) + int(val_len[i])])
                for i in range(n)
            ],
            bool(past_end.value),
        )

    def planar_get_entries(self, raw: bytes, key: bytes,
                           max_matches: int = 64
                           ) -> Optional[Tuple[list, bool]]:
        """get_entries over a PLANAR block (storage/planar.py): binary
        search in C over the key planes, values reassembled from the
        value planes. None = slow path needed."""
        if not self._has_planar:
            return None
        data = np.frombuffer(raw, dtype=np.uint8)
        kbuf = (np.frombuffer(key, dtype=np.uint8) if key
                else np.zeros(1, np.uint8))
        try:
            _, _, vlen_cap, _ = unpack_planar_header(raw)
        except Corruption:
            return None  # slow path will raise the descriptive error
        seqs = np.empty(max_matches, dtype=np.uint64)
        vtypes = np.empty(max_matches, dtype=np.uint8)
        vals = np.zeros((max_matches, max(1, vlen_cap)), dtype=np.uint8)
        val_len = np.empty(max_matches, dtype=np.uint64)
        past_end = ctypes.c_int32(0)
        n = self._lib.tsst_planar_get_entries(
            self._u8(data), len(raw), self._u8(kbuf), len(key),
            max_matches, self._u64(seqs), self._u8(vtypes),
            self._u8(vals), max(1, vlen_cap), self._u64(val_len),
            ctypes.byref(past_end),
        )
        if n == -1:
            if len(raw) >= 16:
                total = int.from_bytes(raw[:4], "little")
                if max_matches < total:
                    return self.planar_get_entries(
                        raw, key, min(total, max_matches * 8))
            return None
        if n < 0:
            return None
        return (
            [
                (int(seqs[i]), int(vtypes[i]),
                 vals[i, :int(val_len[i])].tobytes())
                for i in range(n)
            ],
            bool(past_end.value),
        )

    def merge_resolve(self, kw, klen, seq, vtype, vw, vlen,
                      uint64_add: bool, drop_tombstones: bool):
        """Native LSM merge-resolve (cpu_merge_resolve): inputs are the
        valid-prefix KVBatch lanes; returns (out_kw, out_klen, out_seq,
        out_vtype, out_vw, out_vlen, count). Semantics parity-pinned to
        numpy_merge_resolve (tests/test_native.py)."""
        n = len(klen)
        kwn = kw.shape[1]
        vwn = vw.shape[1]
        kw = np.ascontiguousarray(kw, dtype=np.uint32)
        klen = np.ascontiguousarray(klen, dtype=np.uint32)
        seq = np.ascontiguousarray(seq, dtype=np.uint64)
        vtype = np.ascontiguousarray(vtype, dtype=np.uint8)
        vw = np.ascontiguousarray(vw, dtype=np.uint32)
        vlen = np.ascontiguousarray(vlen, dtype=np.uint32)
        out_kw = np.empty((n, kwn), dtype=np.uint32)
        out_klen = np.empty(n, dtype=np.uint32)
        out_seq = np.empty(n, dtype=np.uint64)
        out_vtype = np.empty(n, dtype=np.uint8)
        out_vw = np.empty((n, vwn), dtype=np.uint32)
        out_vlen = np.empty(n, dtype=np.uint32)
        count = self._lib.cpu_merge_resolve(
            kw.ctypes.data_as(_u32p), klen.ctypes.data_as(_u32p),
            self._u64(seq), self._u8(vtype),
            vw.ctypes.data_as(_u32p), vlen.ctypes.data_as(_u32p),
            n, kwn, vwn, int(uint64_add), int(drop_tombstones),
            out_kw.ctypes.data_as(_u32p), out_klen.ctypes.data_as(_u32p),
            self._u64(out_seq), self._u8(out_vtype),
            out_vw.ctypes.data_as(_u32p), out_vlen.ctypes.data_as(_u32p),
        )
        if count < 0:
            raise ValueError("cpu_merge_resolve failed")
        return (out_kw, out_klen, out_seq, out_vtype, out_vw, out_vlen,
                int(count))

    def merge_resolve_runs(self, kw, klen, seq, vtype, vw, vlen,
                           run_offsets, uint64_add: bool,
                           drop_tombstones: bool):
        """Native k-way merge-resolve over PRE-SORTED runs
        (cpu_merge_resolve_runs): O(n log k) instead of the full-sort
        path's O(n log n). Caller must have verified each run is sorted
        in (key words asc, klen asc, seq desc) order."""
        n = len(klen)
        kwn = kw.shape[1]
        vwn = vw.shape[1]
        kw = np.ascontiguousarray(kw, dtype=np.uint32)
        klen = np.ascontiguousarray(klen, dtype=np.uint32)
        seq = np.ascontiguousarray(seq, dtype=np.uint64)
        vtype = np.ascontiguousarray(vtype, dtype=np.uint8)
        vw = np.ascontiguousarray(vw, dtype=np.uint32)
        vlen = np.ascontiguousarray(vlen, dtype=np.uint32)
        run_offsets = np.ascontiguousarray(run_offsets, dtype=np.uint64)
        out_kw = np.empty((n, kwn), dtype=np.uint32)
        out_klen = np.empty(n, dtype=np.uint32)
        out_seq = np.empty(n, dtype=np.uint64)
        out_vtype = np.empty(n, dtype=np.uint8)
        out_vw = np.empty((n, vwn), dtype=np.uint32)
        out_vlen = np.empty(n, dtype=np.uint32)
        count = self._lib.cpu_merge_resolve_runs(
            kw.ctypes.data_as(_u32p), klen.ctypes.data_as(_u32p),
            self._u64(seq), self._u8(vtype),
            vw.ctypes.data_as(_u32p), vlen.ctypes.data_as(_u32p),
            self._u64(run_offsets),
            n, len(run_offsets) - 1, kwn, vwn,
            int(uint64_add), int(drop_tombstones),
            out_kw.ctypes.data_as(_u32p), out_klen.ctypes.data_as(_u32p),
            self._u64(out_seq), self._u8(out_vtype),
            out_vw.ctypes.data_as(_u32p), out_vlen.ctypes.data_as(_u32p),
        )
        if count < 0:
            raise ValueError("cpu_merge_resolve_runs failed")
        return (out_kw, out_klen, out_seq, out_vtype, out_vw, out_vlen,
                int(count))

    def rlz_compress(self, data: bytes) -> bytes:
        from ..rlz import max_compressed_len

        src = (np.frombuffer(data, dtype=np.uint8) if data
               else np.zeros(1, np.uint8))
        cap = max_compressed_len(len(data))
        out = np.empty(cap, dtype=np.uint8)
        wrote = self._lib.rlz_compress(
            self._u8(src), len(data), self._u8(out), cap)
        if wrote < 0:  # sized by max_compressed_len — cannot happen
            raise ValueError("rlz_compress overflow")
        return out[:wrote].tobytes()

    def rlz_decompress(self, data: bytes, max_out: int) -> Optional[bytes]:
        """Decoded bytes, or None on malformed/oversized input (the
        Python wrapper raises the descriptive error)."""
        src = (np.frombuffer(data, dtype=np.uint8) if data
               else np.zeros(1, np.uint8))
        if len(data) >= 4:
            declared = int.from_bytes(data[:4], "little")
            if declared > max_out:
                return None
        else:
            return None
        # +32 slack enables the decoder's 16-byte wildcopy fast path
        # (it may scribble up to 15 bytes past the logical end)
        out = np.empty(declared + 32, dtype=np.uint8)
        n = self._lib.rlz_decompress(
            self._u8(src), len(data), self._u8(out), declared + 32)
        if n < 0:
            return None
        return out[:n].tobytes()

    def wal_scan(self, raw: bytes) -> Tuple[List[Tuple[int, int, int]], int]:
        """Returns ([(start_seq, body_off, body_len)], bad_crc_at)."""
        data = np.frombuffer(raw, dtype=np.uint8)
        # exact-size output arrays via a cheap structural pre-count (a
        # len/16 upper bound would allocate ~96MB for a 64MiB segment)
        max_records = max(
            1, int(self._lib.wal_count_records(self._u8(data), len(raw)))
        )
        seqs = np.empty(max_records, dtype=np.uint64)
        offs = np.empty(max_records, dtype=np.uint64)
        lens = np.empty(max_records, dtype=np.uint64)
        bad = ctypes.c_int64(-1)
        n = self._lib.wal_scan(
            self._u8(data), len(raw), max_records,
            self._u64(seqs), self._u64(offs), self._u64(lens),
            ctypes.byref(bad),
        )
        return (
            [(int(seqs[i]), int(offs[i]), int(lens[i])) for i in range(n)],
            int(bad.value),
        )

    def bloom_add_many(self, words: np.ndarray, keys: List[bytes]) -> None:
        n = len(keys)
        if n == 0:
            return
        key_buf = np.frombuffer(b"".join(keys), dtype=np.uint8)
        key_off = np.zeros(n + 1, dtype=np.uint64)
        np.cumsum([len(k) for k in keys], out=key_off[1:])
        self.bloom_add_concat(words, key_buf, key_off, n)

    def bloom_add_concat(self, words: np.ndarray, key_buf: np.ndarray,
                         key_off: np.ndarray, n: int) -> None:
        """bloom_add_many over an already-concatenated key buffer +
        (n+1,) u64 offsets — the no-Python-objects bulk path."""
        key_buf = np.ascontiguousarray(key_buf, dtype=np.uint8)
        key_off = np.ascontiguousarray(key_off, dtype=np.uint64)
        self._lib.bloom_add_many(
            words.ctypes.data_as(_u32p), len(words),
            self._u8(key_buf if len(key_buf) else np.zeros(1, np.uint8)),
            self._u64(key_off), n,
        )

    def bloom_may_contain(self, words: np.ndarray, key: bytes) -> bool:
        buf = np.frombuffer(key, dtype=np.uint8) if key else np.zeros(1, np.uint8)
        return bool(self._lib.bloom_may_contain(
            words.ctypes.data_as(_u32p), len(words), self._u8(buf), len(key)
        ))


def _load() -> Optional[NativeLib]:
    if os.environ.get("RSTPU_DISABLE_NATIVE"):
        return None
    so = library_path()
    if not os.path.isfile(so) and not _build(so):
        log.warning("native build failed; using the pure-Python paths")
        return None
    try:
        return NativeLib(ctypes.CDLL(so))
    except (OSError, AttributeError) as e:
        log.warning("native lib load failed: %s", e)
        return None


_UNSET = object()
_native: object = _UNSET
_native_lock = threading.Lock()


def get_native() -> Optional[NativeLib]:
    """Lazily build+load the native library on first use (not at import).
    Locked: first use happens on hot paths from multiple threads, and two
    concurrent builds could dlopen a partially written .so."""
    global _native
    if _native is _UNSET:
        with _native_lock:
            if _native is _UNSET:
                _native = _load()
    return _native  # type: ignore[return-value]


def native_available() -> bool:
    return get_native() is not None


def __getattr__(name: str):
    # PEP 562: keep `binding.NATIVE` working without import-time side effects.
    if name == "NATIVE":
        return get_native()
    raise AttributeError(name)
