"""Segment / db-name helpers.
(The port's copy of ``rocksplicator_tpu/utils/segment_utils.py``.)

Reference: common/segment_utils.h:16-33 — ``SegmentToDbName`` ("seg" +
zero-padded 5-digit shard → ``seg00042``), ``DbNameToSegment``,
``ExtractShardId``, ``DbNameToHelixPartitionName`` (``test00100`` →
``test_100``).
"""

from __future__ import annotations

SHARD_DIGITS = 5


def segment_to_db_name(segment: str, shard_id: int) -> str:
    """``("seg", 42)`` → ``"seg00042"``."""
    if shard_id < 0 or shard_id >= 10 ** SHARD_DIGITS:
        raise ValueError(f"shard_id out of range: {shard_id}")
    return f"{segment}{shard_id:0{SHARD_DIGITS}d}"


def db_name_to_segment(db_name: str) -> str:
    """``"seg00042"`` → ``"seg"``."""
    if len(db_name) <= SHARD_DIGITS:
        raise ValueError(f"db name too short: {db_name!r}")
    return db_name[:-SHARD_DIGITS]


def extract_shard_id(db_name: str) -> int:
    """``"seg00042"`` → ``42``; returns -1 on malformed names (matches the
    reference's tolerant behavior)."""
    if len(db_name) <= SHARD_DIGITS:
        return -1
    tail = db_name[-SHARD_DIGITS:]
    if not tail.isdigit():
        return -1
    return int(tail)


def db_name_to_partition_name(db_name: str) -> str:
    """``"test00100"`` → ``"test_100"`` (Helix partition naming)."""
    seg = db_name_to_segment(db_name)
    shard = extract_shard_id(db_name)
    if shard < 0:
        raise ValueError(f"malformed db name: {db_name!r}")
    return f"{seg}_{shard}"


def partition_name_to_db_name(partition: str) -> str:
    """``"test_100"`` → ``"test00100"``."""
    seg, _, shard = partition.rpartition("_")
    return segment_to_db_name(seg, int(shard))
