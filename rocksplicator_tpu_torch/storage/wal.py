"""Write-ahead log with sequence numbers and update shipping.

(The port's copy of ``rocksplicator_tpu/storage/wal.py``.)

Reference contracts (pinned by the reference's rocksdb_assumption_test.cpp
and relied on by the replicator):
- every seq-consuming op gets a sequence number; a batch occupies the range
  [start_seq, start_seq + count - 1]
- ``get_updates_since(seq)`` returns every batch whose range intersects
  [seq, ∞), in order, as (start_seq, raw_batch_bytes) — the replicator ships
  the raw bytes (replicated_db.cpp:486-540)
- WAL history survives memtable flushes for ``wal_ttl_seconds`` so followers
  can catch up (performance.cpp uses WAL TTL 1h)

Record format per entry (little-endian):
    u64 start_seq
    u32 batch_len
    u32 crc32(batch)
    batch bytes

Segments roll at ``segment_bytes``; file names are ``wal-<first_seq>.log``.
Torn tails (crash mid-append) are truncated on recovery.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib
from typing import Iterator, List, Optional, Tuple

from ..testing import failpoints as fp
from .errors import Corruption, StorageError

_REC_HEAD = struct.Struct("<QII")


def _fsync_file(f) -> None:
    """All WAL data/segment fsyncs funnel through the ``wal.fsync``
    failpoint (delay = a stalling device, fail = a dying one)."""
    fp.hit("wal.fsync")
    os.fsync(f.fileno())


class WalWriter:
    """Appender with GROUP-COMMIT durability (rocksdb write-group
    analog). ``append`` (serialized by the engine's DB lock) buffers +
    flushes to the OS and returns a monotonically increasing token;
    ``sync_to(token)`` — called OUTSIDE the DB lock — makes every
    append up to that token durable with ONE fsync shared by all
    concurrently-waiting sync writers: the first waiter in becomes the
    leader, snapshots the published append token, fsyncs once, and
    every writer whose token that snapshot covers returns without
    touching the disk. Readers never block on an fsync."""

    def __init__(
        self,
        wal_dir: str,
        segment_bytes: int = 64 * 1024 * 1024,
    ):
        self._dir = wal_dir
        self._segment_bytes = segment_bytes
        self._file = None
        self._file_size = 0
        # group-commit state: tokens are published under the appender's
        # lock; _sync_lock serializes fsync leaders and file swaps
        self._sync_lock = threading.Lock()  # rstpu-check: io-mutex group-commit fsync leader lock — fsync under it IS the mechanism
        self._append_token = 0
        self._synced_token = 0
        # non-sync workloads pay no roll-time fsync; the first sync
        # request catches up any segments closed un-fsynced before it
        self._sync_used = False
        self._closed_unsynced = False
        # False whenever a segment dirent was created without a
        # directory fsync; set True only by a SUCCESSFUL dir fsync, so
        # a failed attempt is retried by the next sync instead of the
        # durability claim silently standing
        self._dir_synced = False
        # Optional compaction_scheduler.IoBudget (set by the engine when
        # adaptive compaction scheduling is on): foreground group-commit
        # fsyncs register in-flight so compaction output writes yield to
        # them instead of queueing the latency-critical fsync behind a
        # large background write.
        self.io_budget = None
        os.makedirs(wal_dir, exist_ok=True)

    def append(self, start_seq: int, batch_bytes: bytes) -> int:
        """Buffer one record and flush it to the OS. Returns the sync
        token covering it — pass to ``sync_to`` for durability. Must be
        externally serialized (the engine holds the DB lock)."""
        fp.hit("wal.append")
        if self._file is None or self._file_size >= self._segment_bytes:
            self._roll(start_seq)
        rec = _REC_HEAD.pack(
            start_seq, len(batch_bytes), zlib.crc32(batch_bytes) & 0xFFFFFFFF
        )
        assert self._file is not None
        try:
            cut = fp.torn_point("wal.append", len(rec) + len(batch_bytes))
            if cut is not None:
                # torn write: a prefix of the record reaches the OS and
                # the writer sees a failed append (crash-shaped fault)
                self._file.write((rec + batch_bytes)[:cut])
                self._file.flush()
                raise fp.FailpointError(f"torn WAL append at +{cut}B")
            self._file.write(rec)
            self._file.write(batch_bytes)
            # flush BEFORE publishing the token: a sync leader snapshotting
            # the token must find these bytes already in the OS, so its
            # fsync alone durably covers them
            self._file.flush()
        except BaseException:
            # A record that failed part-way (torn injection, ENOSPC, EIO)
            # would corrupt every LATER append in this still-live process:
            # scans stop at the first bad CRC, so subsequent committed
            # records become unreachable. Truncate back to the record
            # boundary so the log stays hole-free; if even that fails the
            # reopen-time torn-tail truncation is the backstop.
            try:
                if not self._file.closed:
                    self._file.truncate(self._file_size)
                    self._file.flush()
            except (OSError, ValueError):
                pass
            raise
        self._file_size += len(rec) + len(batch_bytes)
        self._append_token += 1
        return self._append_token

    def append_many(self, records: List[Tuple[int, bytes]]) -> int:
        """Buffer a GROUP of records with ONE flush (and one token
        publish) at the end — the follower apply path commits a whole
        pull response per call, so the per-record flush syscall (the
        dominant cost of per-record append on the apply hot path) is
        paid once per response instead of once per update. Same
        serialization contract as ``append``; rolls mid-group flush the
        outgoing segment first."""
        assert records
        fp.hit("wal.append")
        pending = 0
        # rollback point if the group fails part-way: the last offset
        # covered by a PUBLISHED token, valid only for published_file —
        # truncate() on a DIFFERENT (fresh post-roll) file would
        # zero-EXTEND it, and 16 zero bytes decode as a valid empty
        # record (seq 0, len 0, crc32(b"")==0): phantom records
        published_file = self._file
        published_size = self._file_size if self._file is not None else 0
        try:
            for start_seq, batch_bytes in records:
                if (self._file is None
                        or self._file_size >= self._segment_bytes):
                    if pending:
                        # flush + publish the group's records in the
                        # outgoing segment BEFORE rolling: _roll decides
                        # sync coverage (and _closed_unsynced) from the
                        # published token
                        self._file.flush()
                        self._append_token += pending
                        pending = 0
                        # the rollback boundary must advance WITH the
                        # publish: if _roll itself fails, truncating
                        # below this point would delete records whose
                        # tokens are already claimable by sync_to
                        published_size = self._file_size
                    self._roll(start_seq)
                    published_file = self._file
                    published_size = self._file_size
                rec = _REC_HEAD.pack(
                    start_seq, len(batch_bytes),
                    zlib.crc32(batch_bytes) & 0xFFFFFFFF,
                )
                cut = fp.torn_point(
                    "wal.append", len(rec) + len(batch_bytes))
                if cut is not None:
                    # torn group append: same crash-shaped fault as the
                    # single-record path (the follower batched-apply WAL
                    # is hit through HERE, not append)
                    self._file.write((rec + batch_bytes)[:cut])
                    self._file.flush()
                    raise fp.FailpointError(
                        f"torn WAL group append at +{cut}B")
                self._file.write(rec)
                self._file.write(batch_bytes)
                self._file_size += len(rec) + len(batch_bytes)
                pending += 1
            # one flush covers the group; publish AFTER it (sync leaders
            # snapshotting the token must find every covered byte in the OS)
            self._file.flush()
            self._append_token += pending
            return self._append_token
        except BaseException:
            # The group failed part-way: unpublished records (complete or
            # torn) must not linger — the caller never committed them, so
            # on replay/serve they would be phantoms under seqs the engine
            # will reassign to DIFFERENT content. Truncate back to the
            # published boundary; reopen-time torn-tail truncation is the
            # backstop if even this fails. Only the file the boundary
            # belongs to may be truncated: after a failed _roll the
            # current file is a fresh segment with nothing unpublished
            # in it (rolls publish first), so it is left alone.
            try:
                if (self._file is not None
                        and self._file is published_file
                        and not self._file.closed):
                    self._file.truncate(published_size)
                    self._file.flush()
                    self._file_size = published_size
            except (OSError, ValueError):
                # ValueError: the file closed under us (a failed _roll);
                # the original fault must propagate, not this cleanup
                pass
            raise

    def sync_to(self, token: int) -> None:
        """Group commit: durable up to ``token`` (and opportunistically
        everything appended by the time the leader's fsync starts).
        Safe to call concurrently from many writers without the DB
        lock; appends may proceed in parallel (BufferedWriter is
        internally locked, and unsynced appends simply ride a later
        fsync)."""
        if token <= self._synced_token:
            return
        with self._sync_lock:
            self._sync_used = True
            if token <= self._synced_token:
                return  # a leader's fsync covered us while we waited
            f = self._file
            if f is None:
                return
            cover = self._append_token
            self._catchup_closed_segments_locked()
            if not self._dir_synced:
                # segment dirents created before sync was in use
                self._fsync_dir_locked()
            budget = self.io_budget
            if budget is not None:
                budget.fg_fsync_begin()
            try:
                _fsync_file(f)
            finally:
                if budget is not None:
                    budget.fg_fsync_end()
            if cover > self._synced_token:
                self._synced_token = cover

    def _catchup_closed_segments_locked(self) -> None:
        """One-time sweep: fsync segments that rolled closed before the
        first sync request (rolls skip the fsync until sync is in use,
        so plain workloads never stall on it). Caller holds _sync_lock."""
        if not self._closed_unsynced:
            return
        for _seq, path in _segments(self._dir):
            try:
                fd = os.open(path, os.O_RDONLY)
            except FileNotFoundError:
                continue  # purged — durability is moot
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        self._fsync_dir_locked()  # their dirents too
        self._closed_unsynced = False

    def _fsync_dir_locked(self) -> None:
        # a failing open/fsync on our own directory must PROPAGATE: the
        # caller is mid-durability-claim, and the sticky flag stays
        # False so the next sync retries
        fd = os.open(self._dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        self._dir_synced = True

    def _roll(self, first_seq: int) -> None:
        fp.hit("wal.roll")
        # the sync lock pins the outgoing file against a concurrent
        # leader's fsync on its (about-to-be-closed) descriptor
        with self._sync_lock:
            if self._file is not None:
                if self._append_token > self._synced_token:
                    if self._sync_used:
                        # a later sync_to can only fsync the NEW file;
                        # make the outgoing segment durable now so its
                        # tokens are honestly covered (one fsync per
                        # segment roll, only once sync is in use)
                        self._file.flush()
                        _fsync_file(self._file)
                        self._synced_token = self._append_token
                    else:
                        # plain workload: skip the stall, remember that
                        # a first sync request must sweep closed
                        # segments before claiming coverage
                        self._closed_unsynced = True
                self._file.close()
            path = os.path.join(self._dir, f"wal-{first_seq:020d}.log")
            self._file = open(path, "ab")
            self._file_size = self._file.tell()
            if self._sync_used:
                # persist the new segment's directory entry: an fsynced
                # FILE is not durable if power loss drops its dirent
                self._fsync_dir_locked()
            else:
                self._dir_synced = False  # new dirent, not yet durable

    def sync(self) -> None:
        """Unconditional full sync (flush + fsync of the active
        segment, catching up any segments closed un-fsynced)."""
        with self._sync_lock:
            self._sync_used = True
            f = self._file
            if f is None:
                return
            cover = self._append_token
            self._catchup_closed_segments_locked()
            if not self._dir_synced:
                self._fsync_dir_locked()
            f.flush()
            _fsync_file(f)
            if cover > self._synced_token:
                self._synced_token = cover

    def close(self) -> None:
        # the sync lock pins the descriptor against an in-flight group
        # leader's fsync (same rule as _roll). A dirty tail — data OR
        # dirents — is made fully durable before closing and claiming
        # coverage: a sync writer that appended but has not yet reached
        # sync_to must find its bytes durable (its sync_to no-ops after
        # close), and a cleanly closed WAL survives power loss outright.
        with self._sync_lock:
            if self._file is not None:
                if (self._append_token > self._synced_token
                        or self._closed_unsynced):
                    self._catchup_closed_segments_locked()
                    if not self._dir_synced:
                        self._fsync_dir_locked()
                    self._file.flush()
                    _fsync_file(self._file)
                    self._synced_token = self._append_token
                self._file.close()
                self._file = None


def _segments(wal_dir: str) -> List[Tuple[int, str]]:
    """Sorted (first_seq, path) of WAL segments."""
    out = []
    try:
        names = os.listdir(wal_dir)
    except FileNotFoundError:
        return []
    for name in names:
        if name.startswith("wal-") and name.endswith(".log"):
            try:
                first_seq = int(name[4:-4])
            except ValueError:
                continue
            out.append((first_seq, os.path.join(wal_dir, name)))
    return sorted(out)


def _iter_segment(
    path: str, truncate_torn: bool = False, tolerate_tail: bool = False
) -> Iterator[Tuple[int, bytes]]:
    """Yields (start_seq, batch_bytes) from one segment.

    ``truncate_torn`` truncates a torn tail in place (recovery path).
    ``tolerate_tail`` treats a bad/incomplete record as end-of-data without
    raising — used on the ACTIVE segment, which a concurrent writer may be
    mid-appending.
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return  # segment purged between listing and open — fine, it was
        # fully persisted (purge never removes unpersisted segments)

    from .native.binding import NATIVE

    if NATIVE is not None:
        records, bad_crc_at = NATIVE.wal_scan(data)
        if bad_crc_at >= 0 and not (truncate_torn or tolerate_tail):
            raise Corruption(f"WAL crc mismatch in {path} at offset {bad_crc_at}")
        good_end = (
            records[-1][1] + records[-1][2] if records else 0
        )
        for seq, off, ln in records:
            yield seq, data[off:off + ln]
        if good_end < len(data) and truncate_torn:
            with open(path, "r+b") as f:
                f.truncate(good_end)
        return

    pos = 0
    good_end = 0
    while pos + _REC_HEAD.size <= len(data):
        start_seq, blen, crc = _REC_HEAD.unpack_from(data, pos)
        body_start = pos + _REC_HEAD.size
        body_end = body_start + blen
        if body_end > len(data):
            break  # torn / still-being-written tail
        body = data[body_start:body_end]
        if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            if truncate_torn or tolerate_tail:
                break  # treat as torn from here
            raise Corruption(f"WAL crc mismatch in {path} at offset {pos}")
        yield start_seq, body
        pos = body_end
        good_end = pos
    if good_end < len(data) and truncate_torn:
        with open(path, "r+b") as f:
            f.truncate(good_end)


def oldest_seq(wal_dir: str) -> Optional[int]:
    """First sequence number the WAL can still serve (the oldest
    surviving segment's name seq), or None for an empty/missing WAL.
    The needRebuildDB check uses this: a replica whose local seq is
    BELOW a donor's oldest WAL seq can never catch up over the
    replication plane (the serve path raises "WAL gap … puller must
    rebuild") and must rebuild from a snapshot instead."""
    segs = _segments(wal_dir)
    return segs[0][0] if segs else None


def iter_updates(
    wal_dir: str, since_seq: int = 0, truncate_torn: bool = False
) -> Iterator[Tuple[int, bytes]]:
    """Every batch whose seq range intersects [since_seq, ∞), in order, as
    (start_seq, batch_bytes).

    GetUpdatesSince parity: a batch straddling ``since_seq`` IS returned
    (callers normally pass latest_local+1, a batch boundary, but the
    contract holds regardless). Safe against concurrent append (active
    segment tail tolerated) and concurrent purge (missing segments skipped).
    """
    from .records import decode_batch

    segs = _segments(wal_dir)
    yielded_any = False
    for i, (first_seq, path) in enumerate(segs):
        # Skip segments that end before since_seq (next segment's first_seq
        # bounds this one).
        if i + 1 < len(segs) and segs[i + 1][0] <= since_seq:
            continue
        is_last = i + 1 == len(segs)
        # Torn tails are only legitimate in the LAST segment (crash mid-
        # append). A CRC mismatch mid-log is real corruption and must raise,
        # not silently truncate committed records.
        for start_seq, body in _iter_segment(
            path,
            truncate_torn=truncate_torn and is_last,
            tolerate_tail=is_last,
        ):
            if start_seq >= since_seq:
                yielded_any = True
                yield start_seq, body
            elif not yielded_any:
                # Possible straddler: include iff its range reaches since_seq.
                if start_seq + decode_batch(body).count() - 1 >= since_seq:
                    yielded_any = True
                    yield start_seq, body


class WalTailCursor:
    """Resumable streaming cursor over the WAL tail.

    ``iter_updates`` is a one-shot generator: once it reaches the live
    tail it is exhausted for good, so a serve path that drains to the
    tail must re-open — re-reading and re-CRC-ing the ENTIRE active
    segment per pull (quadratic in segment fill; measured as the
    dominant serve cost once leader writes pipeline). This cursor stays
    valid at the tail: iterating raises StopIteration when it runs out
    of complete records, and iterating AGAIN later continues from the
    remembered (segment, offset) — new appends stream with zero
    re-scanning. Segment rolls are followed automatically (a newer
    segment file means the current one is final).

    Iterator of (start_seq, batch_bytes) with the same contract as
    ``iter_updates``: every batch whose seq range intersects
    [since_seq, ∞), in order, including a straddler batch.

    Single-consumer; not thread-safe. ``resumable`` marks the contract
    for cursor caches that would otherwise drop exhausted iterators.
    """

    resumable = True

    # read-ahead chunk: one pread per ~chunk of records instead of three
    # small reads per record
    _CHUNK = 1 << 20

    def __init__(self, wal_dir: str, since_seq: int = 0,
                 segment_bytes: Optional[int] = None):
        self._dir = wal_dir
        self._since = since_seq
        self._f = None
        self._first_seq: Optional[int] = None  # current segment's name seq
        self._offset = 0
        self._positioned = False
        self._yielded_any = False
        # roll-check guard: a segment never rolls before reaching
        # segment_bytes, so tail hits below that size skip the listdir
        # entirely (the dominant cursor cost when serves drain to the
        # tail every pull)
        self._segment_bytes = segment_bytes
        self._eof_hits = 0  # consecutive tail hits since last real roll check
        self._buf = b""
        self._buf_off = 0  # file offset corresponding to _buf[0]

    def __iter__(self) -> "WalTailCursor":
        return self

    def __next__(self) -> Tuple[int, bytes]:
        rec = self.read_next()
        if rec is None:
            raise StopIteration
        return rec

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            finally:
                self._f = None

    # -- internals ---------------------------------------------------------

    def _position(self) -> bool:
        """First use: pick the starting segment (same skip rule as
        iter_updates) and skip-scan record HEADERS to since_seq — no CRC
        work, no body copies — so even the one-time cold cost is far
        below a full-segment re-read."""
        segs = _segments(self._dir)
        if not segs:
            return False
        start_i = 0
        for i in range(len(segs)):
            if i + 1 < len(segs) and segs[i + 1][0] <= self._since:
                start_i = i + 1
        self._open_segment(segs[start_i])
        self._skip_to_since()
        self._positioned = True
        return True

    def _open_segment(self, seg: Tuple[int, str]) -> None:
        self.close()
        first_seq, path = seg
        try:
            self._f = open(path, "rb")
        except FileNotFoundError:
            # purged between listing and open: the records it held were
            # persisted; signal a gap and let the puller rebuild
            raise ValueError(
                f"WAL gap: segment {path} purged under cursor"
            ) from None
        self._first_seq = first_seq
        self._offset = 0
        self._buf = b""
        self._buf_off = 0

    def _skip_to_since(self) -> None:
        """Header-jump within the opened segment to the first record with
        start_seq >= since, handling the straddler (previous record whose
        range reaches since) by rewinding one record when needed. Reads
        go through the chunked read-ahead buffer: the unbuffered version
        paid two syscalls per skipped record, which made every cursor
        reposition O(segment records) in syscalls."""
        assert self._f is not None
        size = os.fstat(self._f.fileno()).st_size
        prev_off: Optional[int] = None
        while True:
            hdr = self._read_at(self._offset, _REC_HEAD.size)
            if len(hdr) < _REC_HEAD.size:
                break  # tail — nothing at/after since yet
            start_seq, blen, _crc = _REC_HEAD.unpack(hdr)
            if start_seq >= self._since:
                if start_seq > self._since and prev_off is not None:
                    # possible straddler: include the previous record iff
                    # its range reaches since (one body decode, once)
                    p_hdr = self._read_at(prev_off, _REC_HEAD.size)
                    p_seq, p_blen, _ = _REC_HEAD.unpack(p_hdr)
                    body = self._read_at(prev_off + _REC_HEAD.size, p_blen)
                    if len(body) == p_blen:
                        from .records import decode_batch

                        if p_seq + decode_batch(body).count() - 1 >= self._since:
                            self._offset = prev_off
                break
            if self._offset + _REC_HEAD.size + blen > size:
                break  # torn/in-flight tail record
            prev_off = self._offset
            self._offset += _REC_HEAD.size + blen

    def _roll_if_closed(self) -> bool:
        """At EOF: if the writer rolled to a newer segment, the current
        one is final — advance. Returns True when a new segment was
        opened (caller should retry reading). Guarded so the common
        live-tail hit costs one fstat, NOT a directory listing: a
        SIZE-triggered roll never happens below segment_bytes. A
        re-created WalWriter on an existing dir, however, starts a new
        segment regardless of the old one's size, so every 32nd
        consecutive tail hit does the real listing anyway — bounded
        staleness instead of a silently parked-forever cursor."""
        if self._first_seq is None or self._f is None:
            return False
        if self._segment_bytes is not None:
            self._eof_hits += 1
            if self._eof_hits & 0x1F:
                try:
                    size = os.fstat(self._f.fileno()).st_size
                    if size < self._segment_bytes:
                        return False
                except OSError:
                    pass
        segs = _segments(self._dir)
        newer = [s for s in segs if s[0] > self._first_seq]
        if not newer:
            return False
        self._open_segment(min(newer))
        return True

    def _read_at(self, off: int, n: int) -> bytes:
        """Bytes [off, off+n) of the current segment through the
        read-ahead buffer (one big read per ~chunk of records instead of
        seek+read syscalls per record). Short result = live tail; a
        later call from the same offset re-reads and sees new appends."""
        end = off + n
        if off < self._buf_off or end > self._buf_off + len(self._buf):
            f = self._f
            f.seek(off)
            self._buf = f.read(max(n, self._CHUNK))
            self._buf_off = off
        rel = off - self._buf_off
        return self._buf[rel:rel + n]

    def read_next(self) -> Optional[Tuple[int, bytes]]:
        """Next complete record, or None at the live tail (cursor stays
        valid — call again after more appends)."""
        if not self._positioned and not self._position():
            return None
        while True:
            if self._f is None:
                return None
            hdr = self._read_at(self._offset, _REC_HEAD.size)
            if len(hdr) < _REC_HEAD.size:
                if self._roll_if_closed():
                    continue
                return None
            start_seq, blen, crc = _REC_HEAD.unpack(hdr)
            body = self._read_at(self._offset + _REC_HEAD.size, blen)
            if len(body) < blen:
                # in-flight append (writer flushed header before body);
                # only legitimate at the ACTIVE tail — if the writer
                # already rolled onward, it's a truncated closed segment
                if self._roll_if_closed():
                    continue
                return None
            if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
                raise Corruption(
                    f"WAL crc mismatch under tail cursor in segment "
                    f"wal-{self._first_seq}.log at offset {self._offset}"
                )
            self._offset += _REC_HEAD.size + blen
            self._yielded_any = True
            self._eof_hits = 0
            return start_seq, body

    def read_many(self, max_records: int) -> List[Tuple[int, bytes]]:
        """Up to ``max_records`` complete records in one call. Records
        already resident in the read-ahead buffer are parsed in a tight
        loop (one struct unpack + one slice per record) instead of two
        ``_read_at`` round-trips each — the replication serve path reads
        whole responses at a time, and the per-record call overhead was
        a measurable share of serve CPU under pipelined load. Falls back
        to ``read_next`` for refills, rolls, and the live tail."""
        out: List[Tuple[int, bytes]] = []
        head = _REC_HEAD
        hsize = head.size
        while len(out) < max_records:
            buf = self._buf
            end = len(buf)
            rel = self._offset - self._buf_off
            if self._f is not None and 0 <= rel < end:
                while len(out) < max_records and rel + hsize <= end:
                    start_seq, blen, crc = head.unpack_from(buf, rel)
                    if rel + hsize + blen > end:
                        break  # record straddles the buffer edge
                    body = buf[rel + hsize:rel + hsize + blen]
                    if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
                        self._offset = self._buf_off + rel
                        raise Corruption(
                            f"WAL crc mismatch under tail cursor in segment "
                            f"wal-{self._first_seq}.log at offset {self._offset}"
                        )
                    rel += hsize + blen
                    out.append((start_seq, body))
                self._offset = self._buf_off + rel
                if out:
                    self._yielded_any = True
                    self._eof_hits = 0
                if len(out) >= max_records:
                    break
            rec = self.read_next()  # refill / roll / tail
            if rec is None:
                break
            out.append(rec)
        return out


def purge_obsolete(
    wal_dir: str,
    persisted_seq: int,
    ttl_seconds: float,
    now: Optional[float] = None,
    archive_sink=None,
) -> int:
    """Delete segments that are (a) fully persisted into SSTs AND (b) older
    than the TTL. Keeping flushed WAL for the TTL is what lets followers
    catch up from the leader's log (reference WAL TTL). Returns count.

    ``archive_sink(path)`` (storage.archive.WalArchiver.sink) is called on
    each sealed segment BEFORE deletion — point-in-time restore replays
    the archive over a checkpoint. A sink failure stops the purge and
    keeps the segment: history is never destroyed un-archived."""
    now = time.time() if now is None else now
    segs = _segments(wal_dir)
    removed = 0
    for i, (first_seq, path) in enumerate(segs):
        if i + 1 >= len(segs):
            break  # never delete the active (last) segment
        next_first = segs[i + 1][0]
        if next_first - 1 > persisted_seq:
            break  # contains unpersisted updates
        if now - os.path.getmtime(path) < ttl_seconds:
            break
        if archive_sink is not None:
            try:
                archive_sink(path)
            except Exception:
                logging.getLogger(__name__).exception(
                    "WAL archive of %s failed; keeping segment", path)
                break
        os.remove(path)
        removed += 1
    return removed


def latest_seq(wal_dir: str) -> int:
    """Highest sequence number present in the WAL (0 if empty)."""
    last = 0
    for start_seq, body in iter_updates(wal_dir, 0, truncate_torn=False):
        from .records import decode_batch

        last = start_seq + decode_batch(body).count() - 1
    return last
