"""In-memory write buffer (memtable).

(The port's copy of ``rocksplicator_tpu/storage/memtable.py``.)

Reference: RocksDB memtable. Stores per-key op stacks (newest first) so
MERGE operands accumulate correctly before a flush; iteration yields
entries in (key asc, seq desc) order — the SST writer's required order.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from .merge import MergeOperator
from .records import OpType

# entry: (seq, vtype, value), newest first
_Entry = Tuple[int, int, bytes]


class MemTable:
    def __init__(self) -> None:
        self._data: Dict[bytes, List[_Entry]] = {}
        self._bytes = 0
        self.min_seq: Optional[int] = None
        self.max_seq = 0
        # Flat append-order columns mirroring _data — the vectorized
        # flush drain reads THESE (byte joins + np.fromiter, no dict
        # walk); ~4 list appends per write buy back ~70 ms per 200k-entry
        # flush. References only, no copies.
        self._flat_keys: List[bytes] = []
        self._flat_vals: List[bytes] = []
        self._flat_seqs: List[int] = []
        self._flat_vtypes: List[int] = []

    def apply(self, key: bytes, seq: int, vtype: int, value: bytes) -> None:
        self._data.setdefault(key, []).insert(0, (seq, vtype, value))
        self._flat_keys.append(key)
        self._flat_vals.append(value)
        self._flat_seqs.append(seq)
        self._flat_vtypes.append(vtype)
        self._bytes += len(key) + len(value) + 16
        if self.min_seq is None:
            self.min_seq = seq
        self.max_seq = max(self.max_seq, seq)

    def get(
        self, key: bytes, merge_op: Optional[MergeOperator]
    ) -> Tuple[bool, Optional[bytes], List[bytes]]:
        """Returns (resolved, value_or_None, pending_operands).

        resolved=True: value_or_None is the final answer (None = deleted).
        resolved=False: pending_operands are MERGE operands (newest last)
        still awaiting a base value from older levels.
        """
        entries = self._data.get(key)
        if not entries:
            return False, None, []
        operands: List[bytes] = []
        for seq, vtype, value in entries:  # newest -> oldest
            if vtype == OpType.PUT:
                if operands and merge_op:
                    return True, merge_op.merge(key, value, list(reversed(operands))), []
                return True, value, []
            if vtype == OpType.DELETE:
                if operands and merge_op:
                    return True, merge_op.merge(key, None, list(reversed(operands))), []
                return True, None, []
            if vtype == OpType.MERGE:
                operands.append(value)
        return False, None, list(reversed(operands))

    def absorb_older(self, older: "MemTable") -> None:
        """Fold an OLDER memtable's entries beneath this one's (flush-failure
        recovery path): older entries append after newer ones per key."""
        for key, entries in older._data.items():
            self._data.setdefault(key, []).extend(entries)
        self._flat_keys.extend(older._flat_keys)
        self._flat_vals.extend(older._flat_vals)
        self._flat_seqs.extend(older._flat_seqs)
        self._flat_vtypes.extend(older._flat_vtypes)
        self._bytes += older._bytes
        if older.min_seq is not None:
            self.min_seq = (
                older.min_seq if self.min_seq is None
                else min(self.min_seq, older.min_seq)
            )
        self.max_seq = max(self.max_seq, older.max_seq)

    def approximate_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._data)

    def entries(self) -> Iterator[Tuple[bytes, int, int, bytes]]:
        """(key, seq, vtype, value) in (key asc, seq desc) order."""
        for key in sorted(self._data):
            for seq, vtype, value in self._data[key]:
                yield key, seq, vtype, value

    def drain_lanes(self):
        """All entries as UNSORTED fixed-width lane arrays — the
        vectorized flush path (the caller lexsorts once over the key
        words, replacing the pure-Python ``sorted(self._data)`` +
        per-entry repack). Returns ``(lanes, key_bytes_matrix)`` or
        None when the planar lane representation can't express this
        memtable: non-uniform or zero/over-wide key length, non-uniform
        non-DELETE value widths, value wider than the planar u16 vlen
        field, or a DELETE carrying a value. Width checks run inline
        during collection so a disqualifying entry bails before any
        large buffer is built.

        ``lanes`` is the kernel lane dict (key_words_be, key_len,
        seq_hi/lo, vtype, val_words, val_len); the (n, klen) u8 key
        matrix rides along for bulk bloom construction. The columns come
        from the flat per-apply mirror lists, so no dict walk or
        per-entry tuple unpack happens here."""
        import numpy as np

        from .planar import PLANAR_MAX_KLEN, PLANAR_MAX_VLEN

        key_parts = self._flat_keys
        val_parts = self._flat_vals
        n = len(key_parts)
        if n == 0:
            return None
        # Width checks run VECTORIZED over the (cheap, 4n-byte) length
        # lanes before any value-byte buffer is built — one oversized
        # value among a million small ones bails here, not after a giant
        # transient allocation.
        klen = len(key_parts[0])
        if not (0 < klen <= PLANAR_MAX_KLEN):
            return None
        klens = np.fromiter(map(len, key_parts), dtype=np.uint32, count=n)
        if not bool((klens == klen).all()):
            return None
        vtype_arr = np.fromiter(
            self._flat_vtypes, dtype=np.uint32, count=n)
        vlens = np.fromiter(map(len, val_parts), dtype=np.uint32, count=n)
        is_del = vtype_arr == 2  # DELETE: no value in the planar layout
        if bool(vlens[is_del].any()):
            return None
        live_vlens = vlens[~is_del]
        vlen = int(live_vlens[0]) if len(live_vlens) else 0
        if vlen > PLANAR_MAX_VLEN or not bool((live_vlens == vlen).all()):
            return None
        key_mat = np.frombuffer(
            b"".join(key_parts), dtype=np.uint8).reshape(n, klen)
        seq = np.fromiter(self._flat_seqs, dtype=np.uint64, count=n)
        key_buf = np.zeros((n, 24), dtype=np.uint8)
        key_buf[:, :klen] = key_mat
        vw = max(2, (vlen + 3) // 4)
        val_buf = np.zeros((n, vw * 4), dtype=np.uint8)
        if vlen:
            if is_del.any():
                pad = bytes(vlen)
                joined = b"".join(v if v else pad for v in val_parts)
            else:
                joined = b"".join(val_parts)
            val_buf[:, :vlen] = np.frombuffer(
                joined, dtype=np.uint8).reshape(n, vlen)
        lanes = {
            "key_words_be": key_buf.view(">u4").astype(
                np.uint32).reshape(n, 6),
            "key_len": np.full(n, klen, dtype=np.uint32),
            "seq_hi": (seq >> np.uint64(32)).astype(np.uint32),
            "seq_lo": (seq & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            "vtype": vtype_arr,
            "val_words": val_buf.view("<u4").reshape(n, vw),
            "val_len": np.where(is_del, 0, vlen).astype(np.uint32),
        }
        return lanes, key_mat
