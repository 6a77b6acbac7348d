"""Chunk sizing under admission stalls — the port's copy of the part of
``rocksplicator_tpu/storage/compaction_scheduler.py`` that the streaming
merge (``storage/stream_merge.py``) reads.

The scheduler itself (priorities, the IO budget, valley drains) is not
ported: the engine that drives a compaction hands its own IO budget in,
and this module reads only its ``stall_pressure()``.
"""

from __future__ import annotations

# Stall boost: write-debt scores multiply by 1 + min(cap, pressure/ms); the
# same pressure shrinks the streaming merge's chunk.
STALL_BOOST_MS = 50.0


def adaptive_chunk_entries(base_entries: int, io_budget) -> int:
    """The streaming merge's chunk size under foreground pressure: while
    the delayed-write controller stalls admissions the memtables grow, so
    the compaction holds less lane memory. Halves per stall-pressure
    doubling over STALL_BOOST_MS, floored at a quarter of the configured
    chunk."""
    if io_budget is None:
        return base_entries
    pressure = io_budget.stall_pressure()
    if pressure <= STALL_BOOST_MS:
        return base_entries
    shrink = min(4.0, pressure / STALL_BOOST_MS)
    return max(base_entries // 4, int(base_entries / shrink))
