"""The compaction seam and the heap-merge path — counterpart of
``rocksplicator_tpu/storage/compaction.py`` (``Entry``,
``CompactionBackend``, ``CpuCompactionBackend``, ``resolve_stream``).

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


class CompactionBackend:
    """The engine's backend seam. The engine finds the optional parts by
    duck typing: ``merge_runs_to_files`` (a direct file sink),
    ``supports_subcompactions`` (it takes ``max_subcompactions`` and
    ``io_budget``) and ``supports_memory_budget`` (``mem_tracker`` and
    ``memory_budget_bytes``)."""

    name = "base"
    supports_subcompactions = False
    supports_memory_budget = False

    def merge_runs(self, runs: List[Iterable[Entry]], merge_op,
                   drop_tombstones: bool) -> Iterator[Entry]:
        raise NotImplementedError


class CpuCompactionBackend(CompactionBackend):
    """Heap-based k-way merge, and the direct array sink
    (``merge_runs_to_files``) shared with the native backend. ``merge_op``
    is any object with ``merge`` and ``partial_merge``."""

    name = "cpu"
    supports_subcompactions = True
    supports_memory_budget = True

    def merge_runs(self, runs: List[Iterable[Entry]], merge_op,
                   drop_tombstones: bool) -> Iterator[Entry]:
        merged = heapq.merge(*runs, key=lambda e: (e[0], -e[1]))
        return resolve_stream(merged, merge_op, drop_tombstones)

    def merge_runs_to_files(self, runs: List, merge_op,
                            drop_tombstones: bool, path_factory,
                            block_bytes: int, compression: int,
                            bits_per_key: int, target_file_bytes: int,
                            max_subcompactions: int = 1, io_budget=None,
                            mem_tracker=None, memory_budget_bytes: int = 0):
        """[(path, props)], [] for an all-tombstoned result, or None →
        the engine's tuple path
        (``storage/native_compaction.direct_merge_runs_to_files``)."""
        from .native_compaction import direct_merge_runs_to_files

        return direct_merge_runs_to_files(
            runs, merge_op, drop_tombstones, path_factory, block_bytes,
            compression, bits_per_key, target_file_bytes,
            max_subcompactions=max_subcompactions, io_budget=io_budget,
            mem_tracker=mem_tracker,
            memory_budget_bytes=memory_budget_bytes)


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
