"""Merge operators — counterpart of ``rocksplicator_tpu/storage/merge.py``.

``resolve_entry_group`` is the scalar per-key fold of the tuple compaction
path (``storage/compaction.resolve_stream``); ``uint64_wrap`` and
``uint64add_segment_sums`` are the wraparound arithmetic of the array
resolve (``gpu/backend.numpy_merge_resolve``). The engine hands backends
its own operator object, so the port recognises the counter operator by
name (``is_uint64_add``) and calls any other operator by duck typing.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .records import OpType

_U64 = struct.Struct("<q")
_PUT, _DELETE, _MERGE = OpType.PUT, OpType.DELETE, OpType.MERGE

UINT64_ADD_NAME = "uint64add"


def is_uint64_add(op) -> bool:
    """True for the counter operator, whichever package defined it: the
    key of the reference's ``MERGE_OPERATORS`` registry is its ``name``."""
    return getattr(op, "name", None) == UINT64_ADD_NAME


def uint64_wrap(total: int) -> int:
    """uint64-add overflow semantics → signed int64 range."""
    total &= (1 << 64) - 1
    if total >= 1 << 63:
        total -= 1 << 64
    return total


def uint64add_segment_sums(vals, contrib, bounds):
    """Per-segment sums of ``vals`` (int64) where ``contrib`` is True,
    segments starting at ``bounds``; numpy int64 wraparound equals
    :func:`uint64_wrap`."""
    with np.errstate(over="ignore"):
        return np.add.reduceat(np.where(contrib, vals, 0), bounds)


class MergeOperator:
    name = "base"

    def merge(self, key: bytes, existing: Optional[bytes],
              operands: List[bytes]) -> bytes:
        raise NotImplementedError

    def partial_merge(self, key: bytes,
                      operands: List[bytes]) -> Optional[bytes]:
        """Associative collapse of operands without the base value; None if
        not supported."""
        return None


class UInt64AddOperator(MergeOperator):
    """Counter bump: values are little-endian int64; merge sums base +
    operands. Values that are not 8 bytes long count as 0."""

    name = UINT64_ADD_NAME

    @staticmethod
    def _parse(v: Optional[bytes]) -> int:
        if v is None or len(v) != _U64.size:
            return 0
        return _U64.unpack(v)[0]

    def merge(self, key: bytes, existing: Optional[bytes],
              operands: List[bytes]) -> bytes:
        total = self._parse(existing)
        for op in operands:
            total += self._parse(op)
        return _U64.pack(uint64_wrap(total))

    def partial_merge(self, key: bytes,
                      operands: List[bytes]) -> Optional[bytes]:
        return self.merge(key, None, operands)


def resolve_entry_group(
    group: List[Tuple[bytes, int, int, bytes]],
    merge_op,
    drop_tombstones: bool,
) -> List[Tuple[bytes, int, int, bytes]]:
    """Fold one key's entry stack — newest (highest seq) first — to its
    surviving entries: the newest PUT/DELETE wins, MERGE operands above it
    fold in, tombstones drop at the bottom level. An unresolved MERGE
    chain without a partial-merge-capable operator survives whole."""
    key = group[0][0]
    top_seq = group[0][1]
    operands: List[bytes] = []
    for _key, _seq, vtype, value in group:
        if vtype == _PUT:
            if operands and merge_op:
                return [(key, top_seq, _PUT,
                         merge_op.merge(key, value, list(reversed(operands))))]
            return [(key, top_seq, _PUT, value)]
        if vtype == _DELETE:
            if operands and merge_op:
                return [(key, top_seq, _PUT,
                         merge_op.merge(key, None, list(reversed(operands))))]
            if drop_tombstones:
                return []
            return [(key, top_seq, _DELETE, b"")]
        if vtype == _MERGE:
            operands.append(value)
    # only MERGE records for this key
    if drop_tombstones and merge_op:
        # bottom level: no older data can exist — fold to a final value
        return [(key, top_seq, _PUT,
                 merge_op.merge(key, None, list(reversed(operands))))]
    if merge_op:
        partial = merge_op.partial_merge(key, list(reversed(operands)))
        if partial is not None:
            return [(key, top_seq, _MERGE, partial)]
    return [e for e in group if e[2] == _MERGE]
