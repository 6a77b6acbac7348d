"""Workload-adaptive compaction scheduling (RESYSTANCE-style).

(The port's copy of ``rocksplicator_tpu/storage/compaction_scheduler.py``.)

Two cooperating pieces the engine plugs into its background compaction
thread, replacing the fixed "L0 >= trigger" loop:

- :class:`CompactionScheduler` — per-db candidate ranking from the
  engine's pressure signals. Candidates are scored in comparable
  "pressure" units (1.0 = at-trigger): L0 file count vs the compaction/
  slowdown triggers (write-stall risk), per-level bytes vs the
  rocksdb-style level targets (compaction debt), and a WINDOWED
  read-amp (files consulted per get since the last pick) that drains L0
  early when the get path is paying for it. The delayed-write
  controller's stall signal multiplies the write-debt scores, so debt
  reduction accelerates precisely when admissions are being delayed.
  Ranking is event-driven: every flush install, compaction install,
  ingest, and set_options already notifies the engine's condition
  variable, and the compaction thread re-ranks on each wake instead of
  scanning on a timer. A manual queue carries post-ingest full
  compactions (``DB.schedule_compaction``; the admin BatchCompactor
  submits through it) so they obey the same priority order.

- :class:`IoBudget` — a token bucket pacing compaction OUTPUT writes so
  background IO yields to foreground latency. Shared with the
  delayed-write controller two ways: foreground WAL group-commit fsyncs
  register in-flight (compaction file writes briefly yield to them —
  the fsync the write path is waiting on should not queue behind a
  64 MB compaction write), and the controller's admission stalls feed
  ``note_stall`` (stall pressure OPENS the budget: when writes are
  being delayed by debt, compaction is the cure, not the disease).
  When the workload goes read-heavy (no foreground fsync recently) the
  budget opens up too. Rate 0 (the default) meters nothing — only the
  yield-to-foreground behavior is active. The foreground-activity
  register is class-level (process-wide): shard A's compaction yields
  to shard B's foreground fsync, because they share the disk.

Env knobs (see README "Tuning"): ``RSTPU_COMPACTION_SCHED=0`` reverts
to the fixed trigger loop, ``RSTPU_COMPACT_BUDGET_BYTES`` sets the
budget rate (bytes/s), ``RSTPU_MAX_SUBCOMPACTIONS`` caps key-range
subcompaction parallelism (storage/native_compaction.py).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional

from ..testing import failpoints as fp
from ..utils.stats import Stats

# Pressure score at or above which a candidate is runnable (L0 exactly
# at level0_compaction_trigger scores 1.0 — legacy-trigger parity).
PICK_THRESHOLD = 1.0
# Windowed read-amp (files consulted per get since the last pick) at
# which an L0 drain is worth running BELOW the file-count trigger.
# An L0 drain rewrites the L1 overlap, so it must not fire for a
# read-amp L0 can't explain: the bar is high (6 files per get) and at
# least 3 L0 files must exist — firing at 2 files under a fat L1 was
# measured to double compaction write-amp for ~1 file of read-amp.
READ_AMP_TRIGGER = 6.0
# ... and only with this many gets in the window (a handful of cold
# reads must not schedule a compaction).
READ_AMP_MIN_GETS = 128
READ_AMP_MIN_L0_FILES = 3
# Stall boost: write-debt scores multiply by 1 + min(cap, pressure/ms).
STALL_BOOST_MS = 50.0
STALL_BOOST_CAP = 2.0
# Level-debt compactions are BATCH work (they move whole levels): under
# live foreground load they compete with serving for CPU and only pay
# off indirectly, so they run when the foreground has been idle this
# long (valley drain) — or immediately once the stall-boosted debt
# score crosses LEVEL_URGENT_SCORE (debt so deep it is slowing the L0
# drain chain; the boost means admission stalls pull this forward,
# which is the RESYSTANCE feedback loop). Measured in the JAX package:
# without this gate the level mover cost ~3x get p99 BELOW the knee
# while buying nothing.
IDLE_DRAIN_SEC = 2.0
LEVEL_URGENT_SCORE = 4.0
# Stall-pressure EWMA decay constant (seconds).
STALL_DECAY_SEC = 5.0
# IoBudget: foreground considered "recent" within this window; outside
# it the mix is read-heavy and the budget opens by READ_HEAVY_FACTOR.
READ_HEAVY_AFTER_SEC = 1.0
READ_HEAVY_FACTOR = 8.0
# Stall pressure above STALL_BOOST_MS opens the budget up to this much.
BUDGET_STALL_FACTOR_CAP = 4.0
# Bound any single yield/pacing sleep so a compaction can't park long.
# The fg yield is sized for one fsync (~1ms on a healthy disk): under
# continuous group-commit traffic a longer bound let the compaction
# thread spend whole drains waiting while L0 climbed to the stop
# trigger — the death spiral measured in the JAX package (p99 spikes only
# in the scheduler-on arm).
MAX_YIELD_SEC = 0.005
MAX_PACE_SEC = 0.25


@dataclass
class Pick:
    """One runnable compaction candidate. ``kind`` is ``l0`` (L0→L1
    drain), ``level`` (debt-driven level→level+1, ``level`` = source),
    or ``manual`` (queued full compaction)."""

    kind: str
    level: int
    score: float
    reason: str = ""


class IoBudget:
    """Token-bucket pacing for compaction output IO, with a process-wide
    foreground-fsync register compaction writes yield to. One instance
    per DB (its rate knob is per-db; the fg register is class-level)."""

    # process-wide foreground activity (all shards share the disk)
    _fg_lock = threading.Lock()
    _fg_cv = threading.Condition(_fg_lock)
    _fg_inflight = 0
    _fg_last = 0.0

    def __init__(self, rate_bytes_per_sec: int = 0):
        self._lock = threading.Lock()
        self._rate = max(0, int(rate_bytes_per_sec))
        self._tokens = float(self._rate)
        self._refilled = time.monotonic()
        self._stall_pressure = 0.0
        self._stall_at = time.monotonic()

    # -- foreground side (WalWriter.sync_to) ---------------------------

    @classmethod
    def fg_fsync_begin(cls) -> None:
        with cls._fg_lock:
            IoBudget._fg_inflight += 1
            IoBudget._fg_last = time.monotonic()

    @classmethod
    def fg_fsync_end(cls) -> None:
        with cls._fg_cv:
            IoBudget._fg_inflight -= 1
            IoBudget._fg_last = time.monotonic()
            cls._fg_cv.notify_all()

    # -- delayed-write-controller side (engine admission stalls) -------

    def note_stall(self, stall_ms: float) -> None:
        """An admission paid ``stall_ms`` in the delayed-write
        controller: raise the decayed stall-pressure signal (read by
        the scheduler's priority boost AND the budget's rate)."""
        now = time.monotonic()
        with self._lock:
            self._decay_locked(now)
            self._stall_pressure += max(0.0, stall_ms)

    def stall_pressure(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._decay_locked(now)
            return self._stall_pressure

    def _decay_locked(self, now: float) -> None:
        dt = now - self._stall_at
        if dt > 0:
            self._stall_pressure *= 2.718281828 ** (-dt / STALL_DECAY_SEC)
            self._stall_at = now

    # -- rate knob -----------------------------------------------------

    def set_rate(self, rate_bytes_per_sec: int) -> None:
        with self._lock:
            self._rate = max(0, int(rate_bytes_per_sec))
            self._tokens = min(self._tokens, float(self._rate))

    @property
    def rate(self) -> int:
        return self._rate

    def _effective_rate_locked(self, now: float) -> float:
        """The metered rate after the two opening factors: read-heavy
        mix (no recent foreground fsync) and delayed-write stall
        pressure (debt reduction is what un-delays writes)."""
        eff = float(self._rate)
        if now - IoBudget._fg_last > READ_HEAVY_AFTER_SEC:
            eff *= READ_HEAVY_FACTOR
        self._decay_locked(now)
        if self._stall_pressure > STALL_BOOST_MS:
            eff *= min(BUDGET_STALL_FACTOR_CAP,
                       self._stall_pressure / STALL_BOOST_MS)
        return eff

    # -- compaction side -----------------------------------------------

    def throttle(self, nbytes: int) -> float:
        """Account ``nbytes`` of compaction output IO; sleep as needed.
        Called by the compaction write sinks after each output file.
        Returns seconds slept. Two tiers:

        1. yield-to-foreground: if a foreground WAL fsync is in flight
           RIGHT NOW, wait (bounded) for it to finish before eating
           more disk bandwidth — this is the tail-latency tier.
        2. token pacing: consume from the bucket at the effective rate;
           a dry bucket sleeps the shortfall (bounded). Rate 0 skips
           this tier entirely.
        """
        slept = 0.0
        # Yield ONLY while the foreground is healthy: once admissions
        # are being delayed, compaction IS the cure — waiting for every
        # group-commit fsync would throttle the drain precisely when
        # the write path most needs it (the stall signal instead OPENS
        # the budget below).
        if IoBudget._fg_inflight > 0 \
                and self.stall_pressure() < STALL_BOOST_MS:
            fp.hit("compact.yield")
            Stats.get().incr("compaction.yields")
            deadline = time.monotonic() + MAX_YIELD_SEC
            with self._fg_cv:
                while IoBudget._fg_inflight > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._fg_cv.wait(remaining)
            slept += max(0.0, time.monotonic() - deadline + MAX_YIELD_SEC)
        if self._rate <= 0 or nbytes <= 0:
            return slept
        sleep_for = 0.0
        now = time.monotonic()
        with self._lock:
            eff = self._effective_rate_locked(now)
            self._tokens = min(
                float(self._rate),
                self._tokens + (now - self._refilled) * eff)
            self._refilled = now
            self._tokens -= float(nbytes)
            if self._tokens < 0 and eff > 0:
                sleep_for = min(MAX_PACE_SEC, -self._tokens / eff)
        if sleep_for > 0:
            fp.hit("compact.yield")
            Stats.get().incr("compaction.yields")
            time.sleep(sleep_for)
            slept += sleep_for
        return slept


def adaptive_chunk_entries(base_entries: int, io_budget) -> int:
    """Workload-adaptive chunk sizing for the streaming bounded-memory
    merge (storage/stream_merge.py) — the same stall signal that boosts
    debt-drain priority SHRINKS the merge's working set: while the
    delayed-write controller is stalling admissions the memtables are
    growing, so the compaction should hold less lane memory and hit its
    refill/yield seams more often. Halves per stall-pressure doubling
    over STALL_BOOST_MS, floored at a quarter of the configured chunk.
    The chunk cuts this sizes are the streaming analog of the
    subcompaction slice boundaries: both are key-aligned partitions of
    one compaction's merge, sized by foreground pressure."""
    if io_budget is None:
        return base_entries
    pressure = io_budget.stall_pressure()
    if pressure <= STALL_BOOST_MS:
        return base_entries
    shrink = min(4.0, pressure / STALL_BOOST_MS)
    return max(base_entries // 4, int(base_entries / shrink))


class CompactionScheduler:
    """Per-db compaction candidate ranking. All ``*_locked`` methods
    run under the engine's DB lock (the engine's compaction thread and
    submitters both hold it); the scheduler itself adds no locks."""

    def __init__(self, db) -> None:
        self._db = db
        self._manual: List[Future] = []  # guarded by db._lock
        # read-amp window base: (gets_total, files_consulted_total) at
        # the last executed pick
        self._ra_base = (0, 0)

    # -- manual queue (post-ingest / BatchCompactor submissions) -------

    def submit_manual_locked(self, fut: Future) -> None:
        self._manual.append(fut)

    def take_manual_locked(self) -> List[Future]:
        futs, self._manual = self._manual, []
        return futs

    def fail_pending_locked(self, exc: BaseException) -> None:
        for f in self.take_manual_locked():
            if not f.done():
                f.set_exception(exc)

    def has_manual_locked(self) -> bool:
        return bool(self._manual)

    # -- ranking -------------------------------------------------------

    def note_picked_locked(self) -> None:
        """Reset the read-amp window at every executed pick."""
        db = self._db
        self._ra_base = (db._gets_total, db._files_consulted_total)

    def _stall_boost(self) -> float:
        budget = getattr(self._db, "_io_budget", None)
        if budget is None:
            return 1.0
        return 1.0 + min(STALL_BOOST_CAP,
                         budget.stall_pressure() / STALL_BOOST_MS)

    def pick_locked(self) -> Optional[Pick]:
        """The best runnable candidate, or None when nothing is worth
        compacting. Caller holds the DB lock."""
        db = self._db
        opts = db.options
        best: Optional[Pick] = None
        if not opts.disable_auto_compaction:
            boost = self._stall_boost()
            best = self._l0_candidate(boost)
            lvl = self._level_candidate(boost)
            if lvl is not None and (best is None or lvl.score > best.score):
                best = lvl
        if self._manual:
            # A queued full compaction subsumes every per-level
            # candidate (it drains L0 AND all level debt), so it ranks
            # at the head whenever anything is runnable — including
            # when nothing else is (its submitter is waiting on it).
            score = max(PICK_THRESHOLD, best.score if best else 0.0)
            return Pick("manual", -1, score, "queued full compaction")
        return best

    def _l0_candidate(self, boost: float) -> Optional[Pick]:
        db = self._db
        opts = db.options
        files0 = len(db._levels[0])
        trigger = max(1, opts.level0_compaction_trigger)
        score = files0 / trigger
        reason = f"l0_files={files0}/{trigger}"
        # approaching the slowdown/stop triggers is write-stall risk:
        # escalate so an L0 pile-up outranks mere level debt
        slowdown = max(trigger, opts.level0_slowdown_writes_trigger)
        if files0 >= slowdown:
            score += 2.0 * (files0 - slowdown + 1)
            reason += " at-slowdown"
        score *= boost
        # windowed read-amp: the get path is consulting many files per
        # lookup — draining L0 (the overlap driver) is the cure even
        # below the file-count trigger
        gets0, consulted0 = self._ra_base
        dget = db._gets_total - gets0
        if dget >= READ_AMP_MIN_GETS and files0 >= READ_AMP_MIN_L0_FILES:
            ra = (db._files_consulted_total - consulted0) / dget
            if ra >= READ_AMP_TRIGGER:
                ra_score = ra / READ_AMP_TRIGGER
                if ra_score > score:
                    score = ra_score
                    reason = f"read_amp={ra:.1f}"
        if score >= PICK_THRESHOLD and files0 >= READ_AMP_MIN_L0_FILES:
            return Pick("l0", 0, score, reason)
        if files0 >= max(1, opts.level0_compaction_trigger):
            # legacy-trigger parity (covers trigger <= 1 configs)
            return Pick("l0", 0, max(score, PICK_THRESHOLD), reason)
        return None

    def _level_candidate(self, boost: float) -> Optional[Pick]:
        """Debt-driven level→level+1: score = level bytes / target
        (rocksdb's compaction score), boosted by stall pressure.
        Deferred while the foreground is busy unless the boosted score
        is URGENT (see IDLE_DRAIN_SEC/LEVEL_URGENT_SCORE above)."""
        db = self._db
        opts = db.options
        idle = (time.monotonic() - db._last_write_mono) > IDLE_DRAIN_SEC
        # Eligibility compares the RAW score (the boost would otherwise
        # promote any modest debt to "urgent" whenever soft-tier
        # admission delays are ticking — measured to cost ~3x get p99
        # below the knee for zero stall benefit); the boost still
        # raises an ELIGIBLE candidate's rank vs other work.
        floor = PICK_THRESHOLD if idle else LEVEL_URGENT_SCORE
        target = float(opts.max_bytes_for_level_base)
        best: Optional[Pick] = None
        # the last level has nowhere to compact into; allow_ingest_behind
        # additionally reserves the TRUE bottom level for ingested-behind
        # files (same reservation as compact_range), so the deepest
        # eligible source must install one level above it
        top = len(db._levels) - 1
        if opts.allow_ingest_behind:
            top -= 1
        for lvl in range(1, top):
            files = db._levels[lvl]
            if files:
                level_bytes = sum(
                    db._readers[n].file_size for n in files
                    if n in db._readers)
                raw = level_bytes / target
                score = raw * boost
                if raw >= floor and (
                        best is None or score > best.score):
                    best = Pick("level", lvl, score,
                                f"L{lvl}={level_bytes}B/target={int(target)}"
                                + ("" if idle else " urgent"))
            target *= max(1, opts.max_bytes_for_level_multiplier)
        return best
