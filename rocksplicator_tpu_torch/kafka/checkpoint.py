"""CDC consumer-offset checkpoints that ride the engine WAL.
(The port's copy of ``rocksplicator_tpu/kafka/checkpoint.py``.)

The exactly-once contract: the (topic, partition, offset) watermark is a
reserved key PUT into the *same* WriteBatch as the records it covers.
One batch = one WAL record = crash-atomic, so after any crash the
durable watermark names exactly the prefix of the partition log whose
effects are present — the consumer reopens, reads the watermark, seeks
to ``offset``, and skips any re-delivered message below it. Dedup is
keyed on the watermark, never on record contents.

Two reserved keys per (topic, partition):

- the **watermark** (``wm``): ``{"offset": next-offset-to-consume,
  "applied": records-applied-total, "ts_ms": last-record-timestamp}`` —
  the checkpoint the consumer resumes from;
- the **applies counter** (``ap``): a plain integer incremented by the
  record count of every apply batch (read-modify-write by the single
  consumer thread, committed atomically with the records). With the
  checkpoint riding the batch the two can never diverge; a checkpoint
  decoupled from its batch (the ``cdc_dedup`` chaos tooth) leaves the
  counter ahead of the watermark after a kill/resume — the witness the
  exactly-once invariant checks, robust even though record applies are
  idempotent upserts.

Keys live under the reserved ``\\x00cdc\\x00`` prefix (the engine's
internal-metadata namespace: range trims — retain_lo/retain_hi — never
drop reserved-prefix keys, so a split child keeps its CDC state).
"""

from __future__ import annotations

import json
from typing import Optional

# keys below \x01 are the engine's reserved metadata namespace; range
# filters (DBOptions.retain_lo/hi) always retain them
CDC_KEY_PREFIX = b"\x00cdc\x00"


def watermark_key(topic: str, partition: int) -> bytes:
    return CDC_KEY_PREFIX + b"wm\x00" + topic.encode("utf-8") + \
        b"\x00%d" % partition


def applies_key(topic: str, partition: int) -> bytes:
    return CDC_KEY_PREFIX + b"ap\x00" + topic.encode("utf-8") + \
        b"\x00%d" % partition


def encode_watermark(offset: int, applied: int, ts_ms: int) -> bytes:
    return json.dumps(
        {"offset": int(offset), "applied": int(applied),
         "ts_ms": int(ts_ms)},
        sort_keys=True).encode("utf-8")


def decode_watermark(raw: Optional[bytes]) -> Optional[dict]:
    """None for a missing/garbled watermark (treated as 'never
    checkpointed' — the consumer falls back to the timestamp seek)."""
    if not raw:
        return None
    try:
        d = json.loads(bytes(raw).decode("utf-8"))
        return {"offset": int(d["offset"]), "applied": int(d["applied"]),
                "ts_ms": int(d.get("ts_ms", 0))}
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None


def read_watermark(engine_db, topic: str, partition: int
                   ) -> Optional[dict]:
    return decode_watermark(engine_db.get(watermark_key(topic, partition)))


def read_applies(engine_db, topic: str, partition: int) -> int:
    raw = engine_db.get(applies_key(topic, partition))
    if not raw:
        return 0
    try:
        return int(bytes(raw).decode("ascii"))
    except (ValueError, UnicodeDecodeError):
        return 0
