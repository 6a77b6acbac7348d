"""The heap-merge compaction path — counterpart of
``rocksplicator_tpu/storage/compaction.py`` (``Entry``,
``CpuCompactionBackend.merge_runs``, ``resolve_stream``).

A run is an iterable of (key, seq, vtype, value) in (key asc, seq desc)
order; the merged stream keeps one resolved entry per key
(``storage/merge.resolve_entry_group``). It is the fallback of the array
backends for custom merge operators and for batches the lanes cannot hold.
"""

from __future__ import annotations

import heapq
from typing import Iterable, Iterator, List, Optional, Tuple

from .merge import resolve_entry_group

Entry = Tuple[bytes, int, int, bytes]  # key, seq, vtype, value


class CpuCompactionBackend:
    """Heap-based k-way merge. ``merge_op`` is any object with ``merge``
    and ``partial_merge`` (the engine passes its own operators)."""

    name = "cpu"

    def merge_runs(self, runs: List[Iterable[Entry]], merge_op,
                   drop_tombstones: bool) -> Iterator[Entry]:
        merged = heapq.merge(*runs, key=lambda e: (e[0], -e[1]))
        return resolve_stream(merged, merge_op, drop_tombstones)


def resolve_stream(merged: Iterable[Entry], merge_op,
                   drop_tombstones: bool) -> Iterator[Entry]:
    """Collapse a (key asc, seq desc)-ordered stream to one entry per key."""
    cur_key: Optional[bytes] = None
    group: List[Entry] = []
    for entry in merged:
        if entry[0] != cur_key:
            if group:
                yield from resolve_entry_group(group, merge_op,
                                               drop_tombstones)
            cur_key = entry[0]
            group = [entry]
        else:
            group.append(entry)
    if group:
        yield from resolve_entry_group(group, merge_op, drop_tombstones)
