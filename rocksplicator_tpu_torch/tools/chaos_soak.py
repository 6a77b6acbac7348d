#!/usr/bin/env python
"""Seeded chaos harness: randomized failpoint schedules vs. the standing
invariants.
(The port's copy of ``tools/chaos_soak.py``: the data-plane deck with its
ingest and remote-compaction fixtures, ``--failover``, ``--reshard``,
``--rebalance`` and ``--cdc``, and every tooth.)

Each schedule arms 1-3 deterministic failpoints (testing/failpoints.py)
from a seeded menu — torn frames, stuck connects, failing fsyncs,
mid-ingest faults — runs a semi-sync write workload against a 3-node
replication cluster (leader + 2 followers over real TCP loopback, the
test_replication Host shape) plus periodic SST bulk-ingests through the
real AdminHandler path, clears the faults, waits for recovery, and
checks the three standing invariants:

1. **hole-free WAL prefix** on every node — seq ranges tile with no gap;
2. **zero acked-write loss** — every write whose ack future resolved
   ``acked`` is readable on the leader AND both followers once the
   cluster reconverges;
3. **ingest atomicity / no partial meta** — a fault anywhere in the
   ingest pipeline leaves either no meta claim, or a meta claim with
   every ingested key readable; a clean retry then always completes.

Everything is derived from ``--seed``: the fault menu draws, the torn
offsets and probability rolls (per-site seeded RNGs), the jittered
retry backoffs (RSTPU_RETRY_SEED / RSTPU_PULL_RETRY_SEED). A violation
prints the reproducing command line and exits 1.

``--break-guard`` deliberately breaks a guard to prove the harness has
teeth (the acceptance demo):

- ``wal_hole``    — WalWriter.append claims a durability token for every
  5th record without writing it (an ack-without-WAL bug): invariant 1
  must catch the hole;
- ``meta_first``  — the ingest handler writes DBMetaData BEFORE the
  engine ingest (the crash-ordering bug the ingest seam exists to
  prevent): invariant 3 must catch meta-without-data.

With ``--expect-violation`` the run exits 0 iff a violation WAS caught.

``--failover`` switches to the COORDINATOR-BACKED schedule menu: a
durable coordinator primary + replicated standby, a Controller, a
Spectator publishing the shard map, and 3 participant hosts running one
replicas=3 semi-sync shard. Seeded schedules kill the acting leader
while it holds a full AckWindow (heartbeats wedged, data plane alive —
the classic deposed-but-running leader), expire participant sessions
mid-write via the ``coordinator.heartbeat`` seam, kill the coordinator
primary, torn-write the coordinator WAL (``coordinator.wal.append``),
and blip the ``participant.transition`` / ``controller.assign`` /
``shardmap.publish`` / ``coordinator.reap`` seams. After EVERY schedule
the harness holds the **fourth standing invariant**:

4. **failover under fault** — exactly one LEADER per shard (current
   states AND the published shard map), zero acked-write loss across
   the handoff (strict ledger: pre-fault + post-promotion acks; acks
   landing inside the visibility window are counted separately), zero
   stale acks (a deposed leader must not ack a single write after the
   new leader's epoch is visible — enforced by the end-to-end fencing
   epochs), and shard-map convergence within a bounded number of
   controller passes.

5. **bounded-staleness + lineage reads** — after every healed schedule,
   reads with a ``max_lag`` bound are issued at every replica: ZERO
   served reads may violate the bound (checked exactly: the workload is
   quiesced, the read-info TTL slept out, and the leader's committed seq
   sampled BEFORE the reads — any served read must have
   ``applied_seq >= L0 - bound``) and ZERO reads may be served from a
   deposed lineage (the leader-crash schedule probes the fenced
   ex-leader directly: reads there must raise STALE_EPOCH, with and
   without the new epoch on the request). Bounces are always legal;
   wrong serves never are.

``--reshard`` runs LIVE SHARD MOVES under fault: a 4-node /
3-replica coordinator-backed cluster where seeded schedules drive the
resumable move step machine (``cluster/shard_move.py``: snapshot →
bulk-ingest → WAL-tail catch-up → epoch-bumped pinned flip → retire)
with continuous write load riding through every phase, and kill every
actor at every seam — the move coordinator at each of its failpoint
phases (``move.record/snapshot/restore/catchup/flip/retire``), the
source and target participants mid-move, the coordinator primary
(kill + torn WAL during the flip), plus cluster-wide session expiry
mid-catch-up and data-plane faults riding a whole move. After EVERY
schedule the harness holds the **sixth standing invariant**:

6. **live moves under fault** — exactly ONE serving lineage per shard
   (current states, the published shard map, and the data plane agree
   on one unfenced leader; two coexisting unfenced leaders at any
   sampled instant is a violation), zero acked-write loss across the
   move (every acked key readable on every CURRENT host — the hosting
   set itself moved; plus the sharp probe: the instant a cutover
   claims completion, every already-acked write must be readable on
   the NEW leader), bounded convergence (controller-pass bound), and
   no stranded replicas (a non-host still holding the db is un-swept
   move garbage — aborts must sweep the target, retires the source).
   A killed mover must leave the move either cleanly aborted or
   resumable to completion — a move that can do neither is the
   half-flipped-map state and a violation by itself.

``--rebalance`` runs the AUTONOMOUS REBALANCER: a 4-node /
2-hash-shard cluster where the harness only drives SKEWED write load —
it never names a source, target, or split key. The policy loop
(``cluster/rebalancer.py``) must sense the sustained hot shard from
real per-db rates (EWMA + hysteresis + consecutive-tick sustain),
plan, and dispatch the live move — or, past the split threshold, the
hot-shard RANGE SPLIT (``cluster/shard_split.py``: snapshot → hidden
observer → catch-up → paused-drain fenced cutover renaming the parent
into range children). Schedules blip every rebalancer seam
(``rebalance.decide/plan/dispatch`` — the tick's work re-derives from
durable ledgers on the next tick), kill a dispatched move mid-catch-up,
and kill the splitter AT ``split.cutover``; both must finish via
resume. After EVERY schedule the harness holds the **seventh standing
invariant**:

7. **policy-initiated placement** — every LEAF of the split forest
   converges (one unfenced leader per child in the current states, the
   published map — including its ``__splits__`` routing records — and
   the data plane), zero acked-write loss where each acked key is
   checked on the child OWNING its range (resolved through the split
   records exactly as the router resolves it), the split-retired
   parent lineage gone from every node, and bounded convergence. The
   sharp probe runs WAITLESS once converged: an acked tail lost at a
   split cutover can never heal and must be caught, not outwaited.

``--cdc`` runs the CDC STREAMING INGEST deck (``cdc_burst``): an
embedded broker feeds the exactly-once consumer (``kafka/ingestion.py``)
applying into a 3-replica semi-sync group, while seeded schedules kill
the consumer at every registered seam (``kafka.fetch`` /
``kafka.apply`` / ``kafka.checkpoint``) mid-batch, run multi-kill
bursts, and depose the leader mid-consume (the consumer restarted
against the promoted follower resumes from ITS replicated watermark).
After EVERY schedule the harness holds the **eighth standing
invariant**:

8. **CDC exactly-once** — applied records == the produced prefix,
   exactly once, per partition, on every replica of the serving
   lineage: the durable watermark equals the produced count, the
   applies-counter witness equals it too (record applies are idempotent
   upserts, so a re-apply is INVISIBLE to state-compare — only the
   counter riding the records batches can see a duplicate), and the
   readable state equals the fold of the produced log (catching drops,
   doubled deletes, and lost overwrites).

- ``fencing`` (``--failover`` only) — the leader IGNORES epochs
  (``ReplicatedDB._reject_stale_epoch`` patched to a no-op): the
  stale-frame probes in the leader-crash schedule must catch it acking
  writes after deposition (SPLIT BRAIN).
- ``move_flip`` (``--reshard`` only) — the naive cutover: no write
  pause, no tail drain, no two-phase demote — force-promote the
  target's data plane the moment catch-up is "close": the lineage
  probes must catch the two coexisting serving lineages / the acked
  tail missing on the new leader.
- ``split_cutover`` (``--rebalance`` only) — the naive SPLIT cutover:
  "the snapshot is good enough" — the hidden observer's WAL-tail pull
  severed, catch-up skipped, and the paused drain-to-exact-equality
  no-op'd before the rename. The REAL cutover refuses to flip a
  non-drained child; the naive one renames a frozen snapshot into the
  high child — keys at/above the split key acked after the snapshot
  are absent from the child that owns them FOREVER: the per-child
  acked-readability probe must catch the loss.
- ``remote_install`` (data-plane only) — the leader installs a remote
  compaction result without the epoch gate: the remote-compaction
  fixture's deposition probe must catch a deposed leader's job
  installing.
- ``cdc_dedup`` (``--cdc`` only) — the at-least-once consumer a naive
  port would ship: the offset checkpoint DECOUPLED from its apply batch
  (records commit first, the watermark follows in a separate write). A
  kill between the two leaves applied records above a stale watermark;
  resume re-applies them. The re-apply is invisible to state-compare
  (idempotent upserts) — the applies-counter witness must catch
  ``applies_total > produced`` at quiesce.
- ``mux_misroute`` (data-plane only; forces ``RSTPU_PULL_MUX=1``) — the
  session-demux bug class: the mux serve files one shard's updates
  under its sibling's section key, seqs restamped off the victim's
  cursor (the index-off-by-one a mux serve loop can ship). The batch is
  perfectly continuous, so the apply-side guard cannot reject it — the
  zero-acked-loss / reconvergence invariants over BOTH chaos shards
  must catch the cross-shard bleed.

Every DB of every deck compacts on the card (``--device``, default
``cuda``; without CUDA the run raises); ``--device cpu`` runs the plain
PyTorch path. On the card a compaction whose direct sink fails under an
injected fault raises where the CPU path would retry it on the tuple
path; the engine's background loop records the failure and compacts
again. The data-plane, reshard, rebalance and CDC decks set the chaos
scale (subcompaction slices of 256 entries, the streaming merge always
on in 512-entry chunks) for their run only and restore the saved
settings after it.

Usage::

    python -m rocksplicator_tpu_torch.tools.chaos_soak --schedules 20 \
        --seed 1                                                # soak
    python -m rocksplicator_tpu_torch.tools.chaos_soak --break-guard \
        wal_hole --expect-violation                             # teeth
    python -m rocksplicator_tpu_torch.tools.chaos_soak --failover \
        --schedules 15 --seed 1
    python -m rocksplicator_tpu_torch.tools.chaos_soak --failover \
        --break-guard fencing --expect-violation                # tooth
    python -m rocksplicator_tpu_torch.tools.chaos_soak --reshard \
        --schedules 15 --seed 1
    python -m rocksplicator_tpu_torch.tools.chaos_soak --reshard \
        --break-guard move_flip --expect-violation              # tooth
    python -m rocksplicator_tpu_torch.tools.chaos_soak --rebalance \
        --schedules 3 --seed 1
    python -m rocksplicator_tpu_torch.tools.chaos_soak --rebalance \
        --break-guard split_cutover --expect-violation          # tooth
    python -m rocksplicator_tpu_torch.tools.chaos_soak --cdc \
        --schedules 5 --seed 1
    python -m rocksplicator_tpu_torch.tools.chaos_soak --cdc \
        --break-guard cdc_dedup --expect-violation              # tooth
    RSTPU_PULL_MUX=1 python -m rocksplicator_tpu_torch.tools.chaos_soak \
        --schedules 6                                           # mux deck
    python -m rocksplicator_tpu_torch.tools.chaos_soak --break-guard \
        mux_misroute --expect-violation                         # tooth
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import os
import random
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from rocksplicator_tpu_torch.device import resolve_device
from rocksplicator_tpu_torch.replication import (
    ReplicaRole,
    ReplicationFlags,
    Replicator,
    StorageDbWrapper,
)
from rocksplicator_tpu_torch.storage import DB, DBOptions, WriteBatch
from rocksplicator_tpu_torch.storage import wal as wal_mod
from rocksplicator_tpu_torch.storage.records import OpType, scan_batch_meta
from rocksplicator_tpu_torch.storage.sst import SSTWriter
from rocksplicator_tpu_torch.testing import failpoints as fp
from rocksplicator_tpu_torch.utils.objectstore import LocalObjectStore


# ---------------------------------------------------------------------------
# the data-plane deck: a semi-sync cluster, SST ingests, the remote tier
# ---------------------------------------------------------------------------

DB_NAME = "seg00001"
# sibling shard on the same 3 hosts: with RSTPU_PULL_MUX=1
# every follower's pull session to the leader carries BOTH shards'
# sections, so session-level faults and the mux_misroute tooth exercise
# real multi-shard demux — and the standing invariants cover
# cross-shard bleed
DB2_NAME = "seg00002"

# quick-recovery flags: chaos wants many fault→heal cycles per minute,
# not the reference's production 5-10s backoffs
FLAGS = ReplicationFlags(
    server_long_poll_ms=300,
    pull_error_delay_min_ms=30,
    pull_error_delay_max_ms=250,
    ack_timeout_ms=800,
    consecutive_timeouts_to_degrade=1000,
    empty_pulls_before_reset=1 << 30,
    write_window=32,
)

DB_OPTS = dict(
    memtable_bytes=32 * 1024,  # continuous flush/compaction churn
    background_compaction=True,
    level0_compaction_trigger=3,
)

# Make key-range subcompactions REACHABLE at chaos scale: the
# production threshold (32k entries per slice) would never slice the
# tiny chaos memtables, leaving the compact.subcompact seam unarmed in
# every schedule. Same for the streaming bounded-memory merge:
# chaos-scale compactions are a few thousand entries, far under the auto
# threshold, so force streaming as the default full-compaction path with
# chunk windows small enough that every compaction crosses multiple
# compact.stream.chunk/refill seams. A stream fault mid-chunk sweeps the
# partial outputs and the engine falls back (or retries) — the
# ingest-atomicity invariant rides every schedule.
#
# The three knobs are module-wide, so they are set for a deck's run only
# (``_chaos_scale``) and restored after it, never at import: any later
# user of the package in the same process compacts as it would have.
CHAOS_MIN_SLICE_ENTRIES = 256
CHAOS_STREAM_MODE = "always"
CHAOS_CHUNK_ENTRIES = 512


@contextlib.contextmanager
def _chaos_scale():
    """Set ``native_compaction.MIN_SLICE_ENTRIES``,
    ``stream_merge.STREAM_MODE_OVERRIDE`` and ``CHUNK_ENTRIES_OVERRIDE``
    to the chaos scale for the body, and restore the saved values after
    it, whatever it raised."""
    from rocksplicator_tpu_torch.storage import native_compaction as _nc
    from rocksplicator_tpu_torch.storage import stream_merge as _sm

    saved = (_nc.MIN_SLICE_ENTRIES, _sm.STREAM_MODE_OVERRIDE,
             _sm.CHUNK_ENTRIES_OVERRIDE)
    _nc.MIN_SLICE_ENTRIES = CHAOS_MIN_SLICE_ENTRIES
    _sm.STREAM_MODE_OVERRIDE = CHAOS_STREAM_MODE
    _sm.CHUNK_ENTRIES_OVERRIDE = CHAOS_CHUNK_ENTRIES
    try:
        yield
    finally:
        (_nc.MIN_SLICE_ENTRIES, _sm.STREAM_MODE_OVERRIDE,
         _sm.CHUNK_ENTRIES_OVERRIDE) = saved


def _backend(device):
    """A fresh compaction backend on ``device`` (None means ``cuda``)."""
    from rocksplicator_tpu_torch.gpu.backend import GpuCompactionBackend

    return GpuCompactionBackend(device=device)


def _fault_menu(rng: random.Random) -> List[Tuple[str, str]]:
    """The schedule's candidate faults — every parameter drawn from the
    schedule RNG, every probabilistic policy pinned to a drawn seed."""
    s = rng.randrange(1 << 16)
    return [
        ("wal.fsync", f"delay_ms:{rng.randint(5, 40)}"),
        ("wal.append", f"torn:{rng.uniform(0.02, 0.15):.3f}@seed{s}"),
        ("sst.fsync", f"delay_ms:{rng.randint(5, 40)}"),
        ("manifest.persist", f"fail_nth:{rng.randint(1, 4)}"),
        ("manifest.persist", f"delay_ms:{rng.randint(5, 30)}"),
        ("rpc.frame.send", f"torn:{rng.uniform(0.01, 0.08):.3f}@seed{s}"),
        ("rpc.frame.send",
         f"fail_prob:{rng.uniform(0.01, 0.08):.3f}@seed{s}"),
        ("rpc.frame.recv",
         f"fail_prob:{rng.uniform(0.005, 0.04):.3f}@seed{s}"),
        ("rpc.connect", f"fail_first:{rng.randint(1, 3)}"),
        ("rpc.connect",
         f"delay_ms:{rng.randint(20, 120)}:{rng.uniform(0.1, 0.4):.2f}"
         f"@seed{s}"),
        ("repl.pull", f"fail_prob:{rng.uniform(0.02, 0.10):.3f}@seed{s}"),
        ("repl.apply", f"fail_nth:{rng.randint(1, 3)}"),
        ("ack.expire", f"delay_ms:{rng.randint(5, 50)}"),
        # the workload-adaptive compaction scheduler's seams —
        # the chaos DBs run background compaction with the scheduler
        # active, so pick faults (loop retries), subcompaction slice
        # faults (on the card: the compaction raises and the loop
        # retries), and IO-budget yield delays all ride the standing
        # data-plane invariants
        ("compact.pick", f"fail_prob:{rng.uniform(0.05, 0.25):.3f}@seed{s}"),
        ("compact.subcompact", f"fail_nth:{rng.randint(1, 3)}"),
        ("compact.yield", f"delay_ms:{rng.randint(5, 30)}"),
        # the streaming bounded-memory merge runs as the
        # default full-compaction path at chaos scale (see
        # ``_chaos_scale`` above) — kill it mid-chunk and
        # mid-refill; outputs are swept, nothing installs, the
        # invariants must hold
        ("compact.stream.chunk", f"fail_nth:{rng.randint(1, 4)}"),
        ("compact.stream.refill",
         f"fail_prob:{rng.uniform(0.02, 0.15):.3f}@seed{s}"),
        # the mux session seams — a serve fault fails the
        # WHOLE multiplexed response (every section of the session
        # retries together, the torn-session shape), an apply fault
        # kills ONE section's client-side demux handoff. With
        # RSTPU_PULL_MUX=1 the decks cross them on every pull round;
        # with mux off they arm but the per-shard path never trips them
        ("repl.mux.serve",
         f"fail_prob:{rng.uniform(0.02, 0.10):.3f}@seed{s}"),
        ("repl.mux.apply", f"fail_nth:{rng.randint(1, 3)}"),
    ]


_INGEST_FAULTS = [
    None,
    ("admin.ingest.engine", "fail_nth:1"),
    ("admin.ingest.meta", "fail_nth:1"),
    ("engine.ingest", "fail_nth:1"),
    ("sst.ingest_footer", "fail_nth:1"),
    ("objectstore.get", "fail_first:1"),  # absorbed by the batch retry
    ("objectstore.get", "fail_first:6"),  # outlasts it — RPC must fail
]


class ChaosCluster:
    """Leader + 2 followers over TCP loopback, semi-sync (mode 1), two
    shards per host (DB_NAME + DB2_NAME) so muxed pull sessions carry
    multiple sections. Every DB compacts on ``device`` (None means
    ``cuda``)."""

    def __init__(self, root: str, device=None):
        self.root = root
        self.hosts: List[Replicator] = [
            Replicator(port=0, flags=FLAGS) for _ in range(3)]
        self.dbs: List[DB] = []
        self.dbs2: List[DB] = []
        self.rdbs = []
        self.rdbs2 = []
        leader_addr = ("127.0.0.1", self.hosts[0].port)
        for i, rep in enumerate(self.hosts):
            role = ReplicaRole.LEADER if i == 0 else ReplicaRole.FOLLOWER
            db = DB(os.path.join(root, f"n{i}", DB_NAME),
                    DBOptions(**DB_OPTS,
                              compaction_backend=_backend(device)))
            self.dbs.append(db)
            self.rdbs.append(rep.add_db(
                DB_NAME, StorageDbWrapper(db), role,
                upstream_addr=None if i == 0 else leader_addr,
                replication_mode=1,
            ))
            db2 = DB(os.path.join(root, f"n{i}", DB2_NAME),
                     DBOptions(**DB_OPTS,
                               compaction_backend=_backend(device)))
            self.dbs2.append(db2)
            self.rdbs2.append(rep.add_db(
                DB2_NAME, StorageDbWrapper(db2), role,
                upstream_addr=None if i == 0 else leader_addr,
                replication_mode=1,
            ))

    @property
    def leader(self):
        return self.rdbs[0]

    @property
    def leader2(self):
        return self.rdbs2[0]

    def converged(self) -> bool:
        for group in (self.dbs, self.dbs2):
            lat = group[0].latest_sequence_number_relaxed()
            if any(db.latest_sequence_number_relaxed() != lat
                   for db in group[1:]):
                return False
        return True

    def wait_converged(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.converged():
                return True
            time.sleep(0.05)
        return self.converged()

    def stop(self) -> None:
        for rep in self.hosts:
            rep.stop()
        for db in self.dbs + self.dbs2:
            db.close()


def check_wal_contiguous(db: DB) -> Optional[str]:
    """Invariant 1: the WAL's surviving records tile seq space with no
    hole (purge only ever trims a fully-persisted prefix)."""
    prev_end = None
    for start_seq, raw in wal_mod.iter_updates(
            os.path.join(db.path, "wal"), 0):
        count, _ts = scan_batch_meta(raw)
        if prev_end is not None and start_seq != prev_end + 1:
            return (f"WAL hole: record at seq {start_seq} follows "
                    f"seq {prev_end} (gap of {start_seq - prev_end - 1})")
        prev_end = start_seq + count - 1
    return None


class IngestFixture:
    """SST bulk-ingest through the real AdminHandler path, one fresh db
    per step, with one ingest-class fault armed per step. The handler's
    DBs compact on ``device`` (None means ``cuda``)."""

    def __init__(self, root: str, replicator: Replicator, device=None):
        from rocksplicator_tpu_torch.admin.handler import AdminHandler

        self.bucket = os.path.join(root, "bucket")
        self.store = LocalObjectStore(self.bucket)
        self.handler = AdminHandler(
            os.path.join(root, "admin"), replicator, device=device)
        self.counter = 0

    def step(self, rng: random.Random, violations: List[str],
             tag: str) -> None:
        self.counter += 1
        db_name = f"ing{self.counter:05d}"
        prefix = f"set{self.counter:05d}"
        items = [
            (b"k%05d" % j, b"v%05d" % (j % 997))
            for j in range(rng.randint(40, 120))
        ]
        tmp_sst = os.path.join(self.bucket, "_mk.tsst")
        w = SSTWriter(tmp_sst)
        for k, v in items:
            w.add(k, 0, OpType.PUT, v)
        w.finish()
        self.store.put_object(tmp_sst, f"{prefix}/bulk.tsst")
        os.remove(tmp_sst)
        asyncio.run(self.handler.handle_add_db(
            db_name=db_name, role="NOOP"))
        fault = rng.choice(_INGEST_FAULTS)
        if fault is not None:
            fp.activate(*fault)
        ok, err = True, None
        try:
            asyncio.run(self.handler.handle_add_s3_sst_files_to_db(
                db_name=db_name, s3_bucket=self.bucket, s3_path=prefix,
                compact_db_after_load=rng.random() < 0.5))
        except Exception as e:
            ok, err = False, e
        finally:
            if fault is not None:
                fp.deactivate(fault[0])
        msg = self._check(db_name, prefix, items, must_claim=ok)
        if msg:
            violations.append(f"{tag}: ingest fault={fault}: {msg}")
            return
        if not ok:
            # faults cleared: one clean retry must complete the load
            try:
                asyncio.run(self.handler.handle_add_s3_sst_files_to_db(
                    db_name=db_name, s3_bucket=self.bucket,
                    s3_path=prefix))
            except Exception as e:
                violations.append(
                    f"{tag}: ingest retry after fault={fault} "
                    f"(first error {err!r}) failed: {e!r}")
                return
            msg = self._check(db_name, prefix, items, must_claim=True)
            if msg:
                violations.append(
                    f"{tag}: ingest fault={fault} post-retry: {msg}")

    def _check(self, db_name: str, prefix: str, items,
               must_claim: bool) -> Optional[str]:
        """Invariant 3: meta claims the set ⇒ every key is readable
        (never partial meta); a successful RPC ⇒ meta claims it."""
        meta = self.handler.get_meta_data(db_name)
        claims = (meta.s3_bucket == self.bucket
                  and meta.s3_path == prefix)
        if must_claim and not claims:
            return "ingest RPC succeeded but meta does not claim the set"
        if not claims:
            return None  # fully pre-ingest (data may exist un-claimed)
        app_db = self.handler.db_manager.get_db(db_name)
        for k, v in items:
            got = app_db.db.get(k)
            if got != v:
                return (f"meta claims {prefix} but key {k!r} reads "
                        f"{got!r} (want {v!r}) — partial meta")
        return None

    def close(self) -> None:
        self.handler.close()


# seams the remote-compaction fixture arms one-at-a-time (registration
# asserted by the registry pass like the ingest menu): leader-side
# faults must fall back to the local merge; worker-side faults must
# fail the job or look like a dead worker (reap → republish)
_REMOTE_COMPACT_FAULTS = [
    ("compact.remote.publish", "fail_nth:1"),
    ("compact.remote.claim", "fail_nth:1"),
    ("compact.remote.fetch", "fail_nth:1"),
    ("compact.remote.upload", "fail_nth:1"),
    ("compact.remote.install", "fail_nth:1"),
    ("compact.remote.heartbeat", "fail_nth:1"),
]


class RemoteCompactionFixture:
    """Disaggregated compaction tier under chaos: one fresh
    db + leader-side manager per step, a persistent worker draining the
    job ledger. Every step runs ONE rotating scenario (a seam fault, a
    worker kill mid-job, or a leader kill mid-job) and then ALWAYS the
    deposition probe: a job whose epoch goes stale in flight must come
    back "fenced" with the file generation untouched — the invariant
    the ``remote_install`` break-guard demonstrably violates. The worker
    and the leaders' DBs compact on ``device`` (None means ``cuda``)."""

    def __init__(self, root: str, device=None):
        from rocksplicator_tpu_torch.cluster.coordinator import (
            CoordinatorClient, CoordinatorServer)
        from rocksplicator_tpu_torch.compaction_remote import (
            CompactionWorker, RemoteDispatchPolicy)

        self.root = root
        self.device = device
        self.server = CoordinatorServer(port=0, session_ttl=5.0)
        self._clients = []

        def client():
            c = CoordinatorClient("127.0.0.1", self.server.port)
            self._clients.append(c)
            return c

        self._client = client
        self.store_uri = f"local://{os.path.join(root, 'compact_store')}"
        self.policy = RemoteDispatchPolicy(
            enabled=True, size_floor_bytes=0, deadline_s=20.0,
            claim_wait_s=2.0, heartbeat_timeout_s=0.5)
        self._worker_stop = threading.Event()
        self.worker = CompactionWorker(
            client(), os.path.join(root, "compact_wk"),
            worker_id="chaos-worker", backend=_backend(device),
            poll_interval=0.05)
        threading.Thread(target=self.worker.serve_forever,
                         args=(self._worker_stop,), daemon=True).start()
        self.counter = 0  # fresh-db namer
        self.steps = 0  # scenario rotation
        self.outcomes: Dict[str, int] = {}

    def _db_options(self) -> DBOptions:
        return DBOptions(memtable_bytes=4 * 1024,
                         level0_compaction_trigger=100,
                         background_compaction=False,
                         compaction_backend=_backend(self.device))

    def _fresh_db(self, epoch_provider):
        from rocksplicator_tpu_torch.compaction_remote import \
            RemoteCompactionManager

        self.counter += 1
        name = f"rc{self.counter:05d}"
        db = DB(os.path.join(self.root, "compact_dbs", name),
                self._db_options())
        for j in range(120):
            db.write(WriteBatch().put(b"c%05d" % j, b"v%05d" % (j % 97)))
            if j % 40 == 0:
                db.flush()
        for j in range(0, 120, 9):
            db.write(WriteBatch().delete(b"c%05d" % j))
        db.flush()
        mgr = RemoteCompactionManager(
            name, db, self._client(), self.store_uri,
            policy=self.policy, epoch_provider=epoch_provider)
        want = {b"c%05d" % j: db.get(b"c%05d" % j) for j in range(120)}
        return name, db, mgr, want

    class _Pick:
        kind, level, score, reason = "l0", 0, 2.0, "chaos"

    def _note(self, outcome: str) -> None:
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1

    def step(self, rng: random.Random, violations: List[str],
             tag: str) -> None:
        scenarios = ["clean", "worker_kill", "leader_kill"] + [
            f"seam:{site}" for site, _ in _REMOTE_COMPACT_FAULTS]
        scenario = scenarios[self.steps % len(scenarios)]
        self.steps += 1
        try:
            self._run_scenario(scenario, rng, violations, tag)
            # the standing probe, every step: a deposed leader's job
            # must fence, and fencing must leave the generation alone
            self._probe_deposition(violations, tag)
        except Exception as e:
            violations.append(
                f"{tag}: remote-compaction fixture crashed "
                f"({scenario}): {e!r}")

    def _run_scenario(self, scenario: str, rng: random.Random,
                      violations: List[str], tag: str) -> None:
        name, db, mgr, want = self._fresh_db(lambda: 1)
        fault = None
        if scenario.startswith("seam:"):
            fault = scenario.split(":", 1)[1]
            fp.activate(fault, "fail_nth:1")
        try:
            if scenario == "worker_kill":
                outcome = self._worker_kill(name, db, mgr)
            elif scenario == "leader_kill":
                outcome = self._leader_kill(name, db, mgr, want,
                                            violations, tag)
                self._note(f"{scenario}:{outcome}")
                return  # db already reopened+closed inside
            else:
                outcome = mgr.maybe_offload(self._Pick())
            self._note(f"{scenario}:{outcome}")
            if outcome == "fenced":
                violations.append(
                    f"{tag}: remote {scenario}: unexpected fence at "
                    f"stable epoch")
                return
            if outcome == "declined":
                # the automatic local fallback must be intact
                db.compact_range()
            got = {k: db.get(k) for k in want}
            if got != want:
                bad = next(k for k in want if got[k] != want[k])
                violations.append(
                    f"{tag}: remote {scenario} ({outcome}): data "
                    f"diverged at {bad!r}")
                return
            if fault:
                # retry after clear: the tier must work again
                fp.deactivate(fault)
                fault = None
                retry = mgr.maybe_offload(self._Pick())
                if retry not in ("installed", "declined"):
                    violations.append(
                        f"{tag}: remote {scenario}: retry after clear "
                        f"→ {retry}")
                got = {k: db.get(k) for k in want}
                if got != want:
                    violations.append(
                        f"{tag}: remote {scenario}: data diverged "
                        f"after clean retry")
        finally:
            if fault:
                fp.deactivate(fault)
            db.close()

    def _worker_kill(self, name: str, db, mgr) -> str:
        """A claimer that dies instantly: claims the job the moment it
        appears, never heartbeats, never merges. The leader must reap
        on heartbeat expiry and the live worker must finish the job."""
        from rocksplicator_tpu_torch.compaction_remote import \
            CompactionJobQueue

        dead_q = CompactionJobQueue(self._client())
        stop = threading.Event()

        def dead_claimer():
            while not stop.is_set():
                try:
                    open_dbs = dead_q.list_open_jobs()
                    if name in open_dbs:
                        dead_q.claim(name, "dead-chaos-worker")
                        return
                except Exception:
                    pass
                time.sleep(0.01)

        t = threading.Thread(target=dead_claimer, daemon=True)
        t.start()
        try:
            return mgr.maybe_offload(self._Pick())
        finally:
            stop.set()
            t.join(timeout=2.0)

    def _leader_kill(self, name: str, db, mgr, want,
                     violations: List[str], tag: str) -> str:
        """Leader killed between publish and install: reopen must be
        exactly pre-compaction, recover() sweeps the orphan, and the
        next pick completes clean."""
        files_before = sorted(
            n for level in db._levels for n in level)
        plan = db.plan_full_compaction()
        if plan is None:
            db.close()
            return "noplan"
        mgr._publish(plan, f"chaoskill{self.counter:05d}", 1)
        db.abort_full_compaction(plan)  # the crash drops the mutex
        db.close()

        db2 = DB(db.path, self._db_options())
        try:
            files_after = sorted(
                n for level in db2._levels for n in level)
            if files_after != files_before:
                violations.append(
                    f"{tag}: remote leader_kill: reopen NOT exactly "
                    f"pre-compaction ({files_before} → {files_after})")
                return "diverged"
            got = {k: db2.get(k) for k in want}
            if got != want:
                violations.append(
                    f"{tag}: remote leader_kill: reopened data "
                    f"diverged")
                return "diverged"
            mgr._db = db2
            mgr.recover()
            if mgr._queue.get_job(name) is not None:
                violations.append(
                    f"{tag}: remote leader_kill: recover() left the "
                    f"orphan job in the ledger")
                return "orphan"
            outcome = mgr.maybe_offload(self._Pick())
            if outcome == "declined":
                db2.compact_range()
            got = {k: db2.get(k) for k in want}
            if got != want:
                violations.append(
                    f"{tag}: remote leader_kill: post-recovery "
                    f"compaction diverged")
            return outcome
        finally:
            db2.close()

    def _probe_deposition(self, violations: List[str], tag: str) -> None:
        """Publish at epoch 1, mint epoch 2 mid-job: the install MUST
        fence, and the file generation must be byte-for-byte untouched.
        With --break-guard remote_install the epoch gate is patched
        out, the stale job installs, and THIS probe is what catches
        it. A transient "declined" (worker hiccup: the result never
        arrived, so there was nothing to fence) is retried once before
        judging."""
        for attempt in (0, 1):
            epoch = {"cur": 1}
            name, db, mgr, want = self._fresh_db(lambda: epoch["cur"])
            files_before = sorted(
                n for level in db._levels for n in level)
            orig_publish = mgr._queue.publish

            def publish_then_depose(job, _pub=orig_publish):
                _pub(job)
                epoch["cur"] = 2  # a new leader was elected mid-job

            mgr._queue.publish = publish_then_depose
            try:
                outcome = mgr.maybe_offload(self._Pick())
                self._note(f"deposed:{outcome}")
                files_after = sorted(
                    n for level in db._levels for n in level)
                if outcome == "installed" or (
                        outcome == "fenced"
                        and files_after != files_before):
                    violations.append(
                        f"{tag}: DEPOSED LEADER'S JOB INSTALLED: "
                        f"stale-epoch result came back {outcome!r}, "
                        f"generation {files_before} → {files_after} "
                        f"(epoch gate broken?)")
                    return
                if outcome == "fenced":
                    return  # the expected path: discarded, untouched
                # declined = the result never arrived to be fenced
                # (worker hiccup) — inconclusive, retry once
            finally:
                db.close()
        violations.append(
            f"{tag}: deposition probe inconclusive twice: no result "
            f"ever reached the epoch gate (worker wedged?)")

    def close(self) -> None:
        self._worker_stop.set()
        for c in self._clients:
            try:
                c.close()
            except Exception:
                pass
        self.server.stop()


# ---------------------------------------------------------------------------
# coordinator-backed failover chaos (the control-plane schedule menu)
# ---------------------------------------------------------------------------

# faults the failover schedules arm (registration asserted by tests the
# same way the data-plane menu is)
_FAILOVER_FAULT_SITES = [
    "coordinator.heartbeat", "coordinator.reap", "coordinator.wal.append",
    "participant.transition", "shardmap.publish", "controller.assign",
    "repl.pull",
    # the tail-armor shed/hedge seams the overload schedule arms
    "rpc.deadline.check", "admission.shed", "router.hedge.fire",
    "repl.read",
]

FAILOVER_SESSION_TTL = 1.0
FAILOVER_FLAGS = ReplicationFlags(
    server_long_poll_ms=300,
    pull_error_delay_min_ms=30,
    pull_error_delay_max_ms=200,
    ack_timeout_ms=800,
    consecutive_timeouts_to_degrade=1000,
    write_window=16,
    # bounded-staleness reads: small TTL so the read
    # invariant's quiesce-then-check window stays fast; a follower
    # whose estimate aged past this must prove its lag with an
    # upstream probe before serving — or bounce
    read_info_ttl_ms=300,
    read_probe_timeout_ms=500,
)
# "shard-map convergence within a bounded number of controller passes":
# the reconcile loop runs every 0.25 s, so this bound also caps heal time
FAILOVER_PASS_BOUND = 80
# reshard heals ride a longer window (deposed resync + drops + rejoin
# storms settle through MORE passes, at the same 0.25 s cadence): the
# bound scales with the 30 s heal timeout the reshard checks use
RESHARD_PASS_BOUND = 160
_LEADERLIKE = {"LEADER", "MASTER"}
# how long a schedule waits, before its first write, for every replica's
# state to equal the controller's published assignment (_wait_settled)
SETTLE_TIMEOUT_S = 30.0


def _settled(cluster: "FailoverCluster") -> bool:
    """Every node's participant holds each partition in the state its
    published assignment gives it (and holds no other), and every
    assigned partition has a leader among the assignments."""
    from rocksplicator_tpu_torch.cluster.model import (cluster_path,
                                                       decode_assignments)

    led, assigned = set(), set()
    for n in cluster.nodes:
        raw = cluster.client.get_or_none(cluster_path(
            cluster.cluster, "assignments", n.instance.instance_id))
        want = {p: t.state for p, t in decode_assignments(
            bytes(raw or b"")).items()}
        if n.participant.current_states != want:
            return False
        assigned |= set(want)
        led |= {p for p, st in want.items() if st in _LEADERLIKE}
    return assigned <= led


def _wait_settled(cluster: "FailoverCluster") -> None:
    """Wait until the cluster is settled (``_settled``): a schedule that
    starts writing while a previous heal or a lapsed session still moves
    leadership finds a closing DB or no leader (F22). Port-only; a
    cluster that does not settle in ``SETTLE_TIMEOUT_S`` is logged and
    left to the schedule's own checks."""
    t0 = time.monotonic()
    if not cluster.wait(lambda: _settled(cluster), SETTLE_TIMEOUT_S):
        logging.getLogger(__name__).warning(
            "cluster not settled after %.1f s", time.monotonic() - t0)


class FailoverNode:
    """One 'host': replicator + admin service + participant. Its admin
    service compacts on ``device`` (None means ``cuda``)."""

    def __init__(self, root: str, name: str, coord_port: int, cluster: str,
                 fallbacks, store_uri: str, device=None):
        from rocksplicator_tpu_torch.admin.handler import AdminHandler
        from rocksplicator_tpu_torch.cluster.model import InstanceInfo
        from rocksplicator_tpu_torch.cluster.participant import Participant
        from rocksplicator_tpu_torch.rpc.server import RpcServer

        self.name = name
        self.replicator = Replicator(port=0, flags=FAILOVER_FLAGS)
        self.handler = AdminHandler(
            os.path.join(root, "admin", name), self.replicator,
            device=device)
        self.server = RpcServer(port=0, ioloop=self.replicator.ioloop)
        self.server.add_handler(self.handler)
        self.server.start()
        self.instance = InstanceInfo(
            instance_id=f"127.0.0.1_{self.server.port}",
            host="127.0.0.1",
            admin_port=self.server.port,
            repl_port=self.replicator.port,
            az=f"az-{name}",
        )
        self.participant = Participant(
            "127.0.0.1", coord_port, cluster, self.instance,
            backup_store_uri=store_uri, catch_up_timeout=10.0,
            error_retry_backoff=0.2, coord_fallbacks=fallbacks,
            # chaos-scale 3-node-failure guard: the default 100k slack
            # is scale-blind at these workload sizes — a data-poor
            # candidate must refuse promotion past a checkpointed
            # lineage and rebuild first
            promotion_seq_slack=64,
        )
        # data-plane self-healing: followers can repoint from the pull
        # loop's forced-reset path without waiting on a controller write
        self.handler.set_leader_resolver(
            self.participant.make_leader_resolver())

    def state_of(self, partition: str):
        return self.participant.current_states.get(partition)

    def rdb(self, db_name: str):
        return self.replicator.get_db(db_name)

    def stop(self) -> None:
        try:
            self.participant.stop()
        except Exception:
            pass
        self.server.stop()
        self.handler.close()
        self.replicator.stop()


class FailoverCluster:
    """Coordinator primary + standby (durable, replicated), a Controller,
    a Spectator publishing the shard map, and N participant hosts running
    one replicas=3 LeaderFollower resource in semi-sync mode — the
    reference Helix topology in one process, chaos-sized. ``num_nodes``
    above the replica count leaves spare hosts for the reshard
    schedules' live shard moves (3 of 4 host the shard; moves relocate
    replicas onto the free node). ``num_shards`` above 1 gives the
    rebalance schedules a fleet MEAN to compare hot shards against.
    Every node compacts on ``device`` (None means ``cuda``)."""

    def __init__(self, root: str, num_nodes: int = 3,
                 num_shards: int = 1, device=None):
        import itertools as _it

        from rocksplicator_tpu_torch.cluster.controller import Controller
        from rocksplicator_tpu_torch.cluster.coordinator import (
            CoordinatorClient, CoordinatorServer)
        from rocksplicator_tpu_torch.cluster.model import ResourceDef
        from rocksplicator_tpu_torch.cluster.publishers import \
            CallbackPublisher
        from rocksplicator_tpu_torch.cluster.spectator import Spectator
        from rocksplicator_tpu_torch.rpc.client_pool import RpcClientPool
        from rocksplicator_tpu_torch.rpc.ioloop import IoLoop
        from rocksplicator_tpu_torch.utils.segment_utils import \
            segment_to_db_name

        self.root = root
        self.cluster = "chaos"
        self.segment = "seg"
        self.num_shards = num_shards
        self.partitions = [f"{self.segment}_{s}"
                           for s in range(self.num_shards)]
        self.db_names = [segment_to_db_name(self.segment, s)
                         for s in range(self.num_shards)]
        self._coord_seq = _it.count()
        # the failover invariants are about SEMI-SYNC acks (mode 1): an
        # ack means a follower received the write. Participant-created
        # dbs take their mode from the per-segment config.
        from rocksplicator_tpu_torch.utils.dbconfig import DBConfigManager

        mgr = DBConfigManager.get()
        self._saved_dbconfig = dict(mgr.config.raw)
        mgr.load_from_dict({self.segment: {"replication_mode": 1}})
        self.primary = CoordinatorServer(
            port=0, session_ttl=FAILOVER_SESSION_TTL,
            data_dir=self._coord_dir())
        self.standby = CoordinatorServer(
            port=0, session_ttl=FAILOVER_SESSION_TTL,
            data_dir=self._coord_dir(),
            replica_of=("127.0.0.1", self.primary.port))
        fallbacks = [("127.0.0.1", self.standby.port)]
        store_uri = os.path.join(root, "bucket")
        LocalObjectStore(store_uri)
        self.store_uri = store_uri
        self.nodes = [
            FailoverNode(root, f"n{i}", self.primary.port, self.cluster,
                         fallbacks, store_uri, device=device)
            for i in range(num_nodes)
        ]
        self.controller = Controller(
            "127.0.0.1", self.primary.port, self.cluster, "ctrl-1",
            reconcile_interval=0.25, coord_fallbacks=fallbacks)
        self.maps: List[Dict] = []
        self.spectator = Spectator(
            "127.0.0.1", self.primary.port, self.cluster,
            [CallbackPublisher(self.maps.append)],
            coord_fallbacks=fallbacks)
        self.client = CoordinatorClient("127.0.0.1", self.primary.port,
                                        fallbacks=fallbacks)
        self.controller.add_resource(
            ResourceDef(self.segment, num_shards=self.num_shards,
                        replicas=3))
        self._ioloop = IoLoop.default()
        self._pool = RpcClientPool()
        # the reshard schedules drive real AdminClient RPCs (the shard-
        # move step machine's snapshot/restore/pause calls)
        from rocksplicator_tpu_torch.cluster.helix_utils import AdminClient

        self.admin = AdminClient()

    def _coord_dir(self) -> str:
        return os.path.join(self.root, f"coord{next(self._coord_seq)}")

    # -- RPC straight at a node's replication plane (the follower frame
    # -- a harness probe fakes rides the REAL wire path)
    def rpc(self, port: int, method: str, args: dict, timeout: float = 5.0,
            **kw):
        async def go():
            return await self._pool.call("127.0.0.1", port, method, args,
                                         timeout=timeout, **kw)

        return self._ioloop.run_sync(go(), timeout=timeout + 5)

    # -- views ------------------------------------------------------------

    def leader_node(self, partition: str,
                    exclude=()) -> Optional[FailoverNode]:
        for n in self.nodes:
            if n in exclude:
                continue
            if n.state_of(partition) in _LEADERLIKE:
                return n
        return None

    def states(self, partition: str) -> Dict[str, str]:
        return {n.name: n.state_of(partition) for n in self.nodes}

    def seqs(self, db_name: str) -> List[Optional[int]]:
        out = []
        for n in self.nodes:
            app = n.handler.db_manager.get_db(db_name)
            out.append(
                app.db.latest_sequence_number_relaxed()
                if app is not None else None)
        return out

    def wait(self, pred, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.05)
        return pred()

    def wait_initial_convergence(self, timeout: float = 30.0) -> None:
        def ready():
            for partition in self.partitions:
                st = sorted(s for s in self.states(partition).values() if s)
                if st != ["FOLLOWER", "FOLLOWER", "LEADER"]:
                    return False
            return True

        if not self.wait(ready, timeout):
            raise RuntimeError(
                f"failover cluster never converged: "
                f"{[self.states(p) for p in self.partitions]}")

    # -- workload ---------------------------------------------------------

    def write_some(self, rng: random.Random, tag: str, n: int,
                   acked: List[Tuple[bytes, bytes]],
                   deadline_per_write: float = 3.0, exclude=()) -> int:
        """n writes through the current leader; waits the ack futures and
        appends acked (key, value) pairs. Returns how many writes errored
        (fenced / no leader / mid-handoff)."""
        errors = 0
        waiters = []
        for i in range(n):
            key = f"{tag}-k{i:04d}".encode()
            val = f"{tag}-v{i:04d}".encode()
            node = self.leader_node(self.partitions[0], exclude=exclude)
            if node is None:
                errors += 1
                continue
            app = node.handler.db_manager.get_db(self.db_names[0])
            if app is None:
                errors += 1
                continue
            try:
                waiters.append((key, val, app.write_async(
                    WriteBatch().put(key, val))))
            except Exception:
                errors += 1
        for key, val, w in waiters:
            try:
                w.future.result(deadline_per_write)
            except Exception:
                continue
            if w.acked:
                acked.append((key, val))
        return errors

    def stop(self) -> None:
        # the spectator, the controller and the nodes stop side by side:
        # the spectator and each participant wait out a poll interval,
        # about 9 s in series a cluster (the port's difference; the
        # reference stops them one by one)
        def quietly(stop):
            try:
                stop()
            except Exception:
                pass

        stoppers = [threading.Thread(target=quietly, args=(f,))
                    for f in [self.spectator.stop, self.controller.stop]
                    + [n.stop for n in self.nodes]]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join()
        for closer in (self.client.close, self.admin.close):
            quietly(closer)
        try:
            self._ioloop.run_sync(self._pool.close(), timeout=5)
        except Exception:
            pass
        for srv in (self.primary, self.standby):
            try:
                srv.stop()
            except Exception:
                pass
        from rocksplicator_tpu_torch.utils.dbconfig import DBConfigManager

        DBConfigManager.get().load_from_dict(self._saved_dbconfig)


# ---------------------------------------------------------------------------
# deliberately-broken guards (harness-teeth demonstration)
# ---------------------------------------------------------------------------


def _break_guard(kind: str):
    """Returns an undo callable."""
    if kind == "wal_hole":
        from rocksplicator_tpu_torch.storage.wal import WalWriter

        orig = WalWriter.append
        state = {"n": 0}

        def broken_append(self, start_seq, batch_bytes):
            state["n"] += 1
            if state["n"] % 5 == 0:
                # claim a durability token without writing the record —
                # the ack-before-durability bug class
                self._append_token += 1
                return self._append_token
            return orig(self, start_seq, batch_bytes)

        WalWriter.append = broken_append
        return lambda: setattr(WalWriter, "append", orig)
    if kind == "meta_first":
        from rocksplicator_tpu_torch.admin.handler import AdminHandler

        orig_do = AdminHandler._do_ingest

        def broken_do(self, sp, db_name, store, s3_bucket, s3_path,
                      *args):
            self.write_meta_data(db_name, s3_bucket, s3_path)
            return orig_do(self, sp, db_name, store, s3_bucket, s3_path,
                           *args)

        AdminHandler._do_ingest = broken_do
        return lambda: setattr(AdminHandler, "_do_ingest", orig_do)
    if kind == "move_flip":
        # the naive shard-move cutover a lazy implementation would ship:
        # no write pause, no tail drain, no two-phase handoff — just
        # bump the ledger and force-promote the target's data plane the
        # moment catch-up is "close enough". This leaves TWO unfenced
        # serving lineages (the source still leads its follower set;
        # the target leads alone at a higher epoch, missing the acked
        # tail) — the sixth invariant's lineage probes must catch it.
        import json as _json

        from rocksplicator_tpu_torch.cluster.model import cluster_path
        from rocksplicator_tpu_torch.cluster.shard_move import ShardMove

        orig_cutover = ShardMove._phase_cutover

        def broken_cutover(self):
            rec = self.rec
            rec.moving_leader = True
            target = self._target_info()
            path = cluster_path(self.cluster, "epochs", rec.partition)
            raw = self.coord.get_or_none(path)
            cur = 0
            if raw:
                try:
                    cur = int(_json.loads(bytes(raw).decode())
                              .get("epoch", 0))
                except (ValueError, UnicodeDecodeError):
                    cur = 0
            self.coord.put(path, _json.dumps(
                {"epoch": cur + 1, "leader": rec.target}).encode())
            self.admin.change_db_role_and_upstream(
                self._admin_addr(target), rec.db_name, "LEADER",
                epoch=cur + 1)

        ShardMove._phase_cutover = broken_cutover
        return lambda: setattr(
            ShardMove, "_phase_cutover", orig_cutover)
    if kind == "split_cutover":
        # the naive split cutover: "the snapshot is good enough" — the
        # hidden observer's WAL-tail pull severed (self-upstream), the
        # catch-up wait skipped, the paused drain-to-exact-equality
        # no-op'd. The REAL cutover refuses to flip a non-drained child
        # (the drain polls lag==0 under the pause and times out); the
        # naive one renames a frozen snapshot into the high child, so
        # every key >= split_key acked after the snapshot seq is absent
        # from the child that now OWNS it — the rebalance harness's
        # per-child acked-readability probe must catch the loss.
        from rocksplicator_tpu_torch.cluster.shard_split import ShardSplit

        orig_catchup = ShardSplit._phase_catchup
        orig_drain = ShardSplit._cutover_drain

        def naive_catchup(self):
            target = self._instances().get(self.rec.target_instance)
            if target is not None:
                self.admin.change_db_role_and_upstream(
                    self._admin_addr(target), self.parent_db, "OBSERVER",
                    upstream=(target.host, target.repl_port))

        ShardSplit._phase_catchup = naive_catchup
        ShardSplit._cutover_drain = lambda self, leader: None

        def undo():
            ShardSplit._phase_catchup = orig_catchup
            ShardSplit._cutover_drain = orig_drain

        return undo
    if kind == "remote_install":
        # a leader that installs a remote compaction result WITHOUT the
        # epoch gate: a deposed leader's in-flight job comes back and
        # swaps a generation into a db that a higher-epoch leader now
        # owns. The remote-compaction fixture's standing deposition
        # probe must catch the install that should have fenced.
        from rocksplicator_tpu_torch.compaction_remote import \
            install as rc_install

        orig_gate = rc_install._epoch_is_current
        rc_install._epoch_is_current = \
            lambda job_epoch, current_epoch: True
        return lambda: setattr(
            rc_install, "_epoch_is_current", orig_gate)
    if kind == "mux_misroute":
        # the session-demux bug class: the server drains the
        # right WALs but files one shard's updates under its SIBLING's
        # section key — cursor bookkeeping intact, seqs restamped off
        # the victim's cursor, which is exactly what an index-off-by-one
        # in the serve loop produces. The apply side sees a perfectly
        # CONTINUOUS batch of the wrong shard's bytes, so the
        # seq-continuity guard cannot reject it — only the standing
        # invariants can catch it: acked writes on the donor shard never
        # reach the followers (zero-acked-loss), and the victim shard
        # runs ahead of its leader (reconvergence never lands). Forces
        # RSTPU_PULL_MUX=1 for the run — the tooth targets the mux path.
        from rocksplicator_tpu_torch.replication.pull_mux import \
            MuxServerState

        saved_mux = os.environ.get("RSTPU_PULL_MUX")
        os.environ["RSTPU_PULL_MUX"] = "1"
        orig_serve = MuxServerState.serve
        state = {"n": 0}

        def _restamp(updates, start):
            out, seq = [], start
            for u in updates:
                u2 = dict(u)
                u2["seq_no"] = seq
                seq += int(u.get("count") or 1)
                out.append(u2)
            return out

        async def misrouting_serve(self, db_map, sections,
                                   max_wait_ms=None, budget=None):
            resp = await orig_serve(self, db_map, sections,
                                    max_wait_ms=max_wait_ms,
                                    budget=budget)
            out = resp.get("sections") or {}
            live = sorted(n for n, sec in out.items()
                          if isinstance(sec, dict) and "error" not in sec)
            state["n"] += 1
            if len(live) >= 2 and state["n"] % 2 == 0:
                a, b = live[0], live[1]
                ua = out[a].get("updates") or []
                ub = out[b].get("updates") or []
                if ua or ub:
                    out[a]["updates"] = _restamp(
                        ub, int(sections[a].get("seq_no", 0)) + 1)
                    out[b]["updates"] = _restamp(
                        ua, int(sections[b].get("seq_no", 0)) + 1)
            return resp

        MuxServerState.serve = misrouting_serve

        def undo():
            MuxServerState.serve = orig_serve
            if saved_mux is None:
                os.environ.pop("RSTPU_PULL_MUX", None)
            else:
                os.environ["RSTPU_PULL_MUX"] = saved_mux

        return undo
    if kind == "fencing":
        # a leader that IGNORES epochs: stale-epoch frames are served and
        # acked, a deposed leader never fences — the no-split-brain
        # invariant must catch the acked-on-deposed-leader writes
        from rocksplicator_tpu_torch.replication.replicated_db import \
            ReplicatedDB

        orig_reject = ReplicatedDB._reject_stale_epoch
        ReplicatedDB._reject_stale_epoch = (
            lambda self, remote_epoch: False)
        return lambda: setattr(
            ReplicatedDB, "_reject_stale_epoch", orig_reject)
    if kind == "cdc_dedup":
        # the at-least-once bug class: the consumer-offset checkpoint
        # DECOUPLED from the apply batch — records commit first, the
        # watermark follows in a separate write (what a naive port of
        # the reference's commit()-after-apply would do). The
        # kafka.checkpoint seam moves with it: it now fires BETWEEN the
        # records commit and the watermark write, so a seam kill leaves
        # applied records above a stale watermark; resume re-applies
        # them. State-compare can't see it (applies are idempotent
        # upserts) — the applies-counter witness must catch
        # ``applies_total > watermark.offset`` at quiesce.
        from rocksplicator_tpu_torch.kafka.checkpoint import (
            encode_watermark, watermark_key)
        from rocksplicator_tpu_torch.kafka.ingestion import \
            IngestionWatcher
        from rocksplicator_tpu_torch.storage.records import (
            WriteBatch as _WriteBatch)

        orig_fold = IngestionWatcher._fold_checkpoint
        orig_apply = IngestionWatcher._apply_group

        def naive_fold(self, batch, partition, next_offset, applied,
                       ts_ms):
            pending = getattr(self, "_naive_pending", None)
            if pending is None:
                pending = self._naive_pending = []
            pending.append((partition, next_offset, applied, ts_ms))

        def naive_apply(self, batches):
            orig_apply(self, batches)
            pending, self._naive_pending = \
                getattr(self, "_naive_pending", []) or [], []
            for p, off, applied, ts in pending:
                fp.hit("kafka.checkpoint")
                wb = _WriteBatch()
                wb.put(watermark_key(self._topic, p),
                       encode_watermark(off, applied, ts))
                self._write_many([wb])

        IngestionWatcher._fold_checkpoint = naive_fold
        IngestionWatcher._apply_group = naive_apply

        def undo():
            IngestionWatcher._fold_checkpoint = orig_fold
            IngestionWatcher._apply_group = orig_apply

        return undo
    raise ValueError(f"unknown break-guard: {kind}")


# ---------------------------------------------------------------------------
# failover schedules (every parameter drawn from the schedule RNG)
# ---------------------------------------------------------------------------


def _wait_replicas_equal(cluster: FailoverCluster, timeout: float = 10.0,
                         replicas: int = 3) -> bool:
    """Baseline writes are only held to the zero-loss invariant once they
    are on EVERY replica — then any single survivor carries them through
    arbitrary later flaps. Hosting-aware: with spare nodes (reshard
    mode), exactly ``replicas`` nodes must host the db at equal seqs —
    nodes without the db (the move's free node) are not required to."""
    def equal():
        for db in cluster.db_names:
            seqs = [s for s in cluster.seqs(db) if s is not None]
            if len(seqs) != replicas or len(set(seqs)) != 1:
                return False
        return True

    return cluster.wait(equal, timeout)


def _schedule_leader_crash(cluster, rng, acked, violations, tag, timings):
    """Crash the acting leader while it holds a full AckWindow, then
    prove the no-split-brain invariant: after the new leader's epoch is
    visible, the deposed leader cannot ack a single write. Follower
    pulls are blocked for the whole window so NO ack can legitimately
    land between fill and promotion."""
    partition, db = cluster.partitions[0], cluster.db_names[0]
    leader = cluster.leader_node(partition)
    if leader is None:
        violations.append(f"{tag}: no leader before the fault")
        return
    cluster.write_some(rng, tag + "-pre", rng.randint(6, 12), acked)
    if not _wait_replicas_equal(cluster):
        violations.append(f"{tag}: baseline never converged")
        return
    rdb = leader.rdb(db)
    app = leader.handler.db_manager.get_db(db)
    fp.activate("repl.pull",
                f"fail_prob:1.0@seed{rng.randrange(1 << 16)}")
    # drain pulls already PARKED in the leader's long-poll (they predate
    # the failpoint and would legitimately serve+ack the fill writes)
    time.sleep(FAILOVER_FLAGS.server_long_poll_ms / 1000.0 + 0.2)
    base_seq = app.db.latest_sequence_number_relaxed()
    # fill the window: none of these can ack while pulls are blocked
    # (they expire un-acked on the 800 ms timeout — either way, zero acks)
    pending = []
    for i in range(min(rdb.ack_window_free, rng.randint(6, 16))):
        key = f"{tag}-pend{i:03d}".encode()
        try:
            pending.append(
                (key, key, app.write_async(WriteBatch().put(key, key))))
        except Exception:
            break
    t_fault = time.monotonic()
    leader.participant.coord.suspend_heartbeats()  # the wedge: data plane
    # stays alive and thinks it leads — the classic deposed-but-running
    # belt-and-braces: a fill write that somehow acked BEFORE the wedge
    # (a straggler pull) is a legitimate pre-crash ack, not a stale one
    pre_wedge: List = []
    still_pending: List = []
    for item in pending:
        w = item[2]
        if w.future.done() and w.acked:
            pre_wedge.append(item)
        else:
            still_pending.append(item)
    acked.extend((k, v) for k, v, _w in pre_wedge)
    pending = still_pending
    if not cluster.wait(
            lambda: cluster.leader_node(partition, exclude=(leader,))
            is not None, 12.0):
        violations.append(
            f"{tag}: no new leader within 12s of the wedge "
            f"({cluster.states(partition)})")
        fp.deactivate("repl.pull")
        leader.participant.coord.resume_heartbeats()
        return
    t_one_leader = time.monotonic()
    new_leader = cluster.leader_node(partition, exclude=(leader,))
    fp.deactivate("repl.pull")
    nrdb = new_leader.rdb(db)
    new_epoch = nrdb.epoch if nrdb is not None else 0
    # THE stale frame: a late follower pull carrying the new epoch hits
    # the deposed leader over the real wire. Fencing: STALE_EPOCH, the
    # pending window fails un-acked, writes refused. --break-guard
    # fencing: the pull is served and mode-1 acks it.
    try:
        cluster.rpc(leader.replicator.port, "replicate",
                    dict(db_name=db, seq_no=base_seq, max_wait_ms=0,
                         max_updates=1024, role="FOLLOWER",
                         epoch=new_epoch))
    except Exception:
        pass  # STALE_EPOCH is the expected outcome with the guard intact
    # post-visibility write probes at the DEPOSED leader: with fencing
    # they are refused outright; without it they commit locally and the
    # second stale pull acks them — the split brain the harness must see
    probe_waiters = []
    for i in range(3):
        key = f"{tag}-stale{i}".encode()
        try:
            probe_waiters.append(
                (key, key, rdb.write_async(WriteBatch().put(key, key))))
        except Exception:
            pass
    try:
        cluster.rpc(leader.replicator.port, "replicate",
                    dict(db_name=db, seq_no=base_seq + len(pending),
                         max_wait_ms=0, max_updates=1024, role="FOLLOWER",
                         epoch=new_epoch))
    except Exception:
        pass
    # DEPOSED-LINEAGE READ PROBES: once the new epoch is
    # visible, the deposed leader must refuse reads exactly as it
    # refuses stale-epoch pulls — with the new epoch on the request
    # (the fencing trigger) AND without one (it is already fenced).
    for probe_epoch in (new_epoch, None):
        try:
            resp = cluster.rpc(
                leader.replicator.port, "read",
                dict(db_name=db, op="get", keys=[b"probe"],
                     max_lag=0, epoch=probe_epoch))
        except Exception:
            timings["read_bounces"] += 1
            continue  # STALE_EPOCH is the required outcome
        violations.append(
            f"{tag}: READ SERVED FROM DEPOSED LINEAGE — fenced leader "
            f"answered a read (epoch on request: {probe_epoch}, "
            f"response epoch {resp.get('epoch')})")
    # failover-time metric: fault → first acked write on the new leader
    ack2: List[Tuple[bytes, bytes]] = []
    deadline = time.monotonic() + 10.0
    seq = 0
    while time.monotonic() < deadline and not ack2:
        cluster.write_some(rng, f"{tag}-post{seq}", 2, ack2,
                           exclude=(leader,))
        seq += 1
    if ack2:
        t_first_ack = time.monotonic()
        timings["first_ack_ms"].append((t_first_ack - t_fault) * 1000.0)
        acked.extend(ack2)
    else:
        violations.append(
            f"{tag}: no acked write on the new leader within 10s")
    timings["failover_ms"].append((t_one_leader - t_fault) * 1000.0)
    # zero stale acks: nothing written at/after the wedge may ack on the
    # deposed leader once the new epoch was visible
    stale = []
    for key, val, w in pending + probe_waiters:
        try:
            w.future.result(3.0)
        except Exception:
            continue
        if w.acked:
            stale.append(key)
            acked.append((key, val))  # it claimed durability: hold it to it
    if stale:
        violations.append(
            f"{tag}: SPLIT BRAIN — deposed leader acked {len(stale)} "
            f"write(s) after epoch {new_epoch} was visible "
            f"(first {stale[0]!r})")
    # heal: resume heartbeats → session re-establishes → participant
    # rejoins → controller demotes it → deposed resync from the new
    # lineage (the _check_failover_invariants wait covers all of it)
    leader.participant.coord.resume_heartbeats()


def _schedule_session_expiry(cluster, rng, acked, violations, tag,
                             timings):
    """Expire participant sessions mid-write by dropping heartbeats at
    the coordinator.heartbeat seam (real server-side TTL lapses, mass
    ephemeral teardown, rejoin storm). Writes issued DURING the outage
    ride the semi-sync window (availability over durability — the
    reference contract) and are counted but not held to the strict
    ledger; pre-fault and post-heal acks are."""
    cluster.write_some(rng, tag + "-pre", rng.randint(6, 12), acked)
    if not _wait_replicas_equal(cluster):
        violations.append(f"{tag}: baseline never converged")
        return
    n = rng.randint(25, 45)  # ~1.5-2.5 TTLs of failed beats, all clients
    fp.activate("coordinator.heartbeat", f"fail_first:{n}")
    window: List[Tuple[bytes, bytes]] = []
    cluster.write_some(rng, tag + "-mid", rng.randint(3, 6), window)
    timings["window_acked"] += len(window)
    time.sleep(FAILOVER_SESSION_TTL * 1.7)
    fp.deactivate("coordinator.heartbeat")
    cluster.write_some(rng, tag + "-post", rng.randint(3, 6), acked)


def _schedule_follower_expiry(cluster, rng, acked, violations, tag,
                              timings):
    """Wedge a FOLLOWER past its session TTL (leadership must NOT move),
    optionally with a transition/assignment fault armed, then prove the
    reaped participant re-registers and resumes FOLLOWER without a
    restart."""
    from rocksplicator_tpu_torch.cluster.model import cluster_path

    partition = cluster.partitions[0]
    followers = [n for n in cluster.nodes
                 if n.state_of(partition) in ("FOLLOWER", "SLAVE")]
    if not followers:
        violations.append(f"{tag}: no follower to expire")
        return
    cluster.write_some(rng, tag + "-pre", rng.randint(4, 8), acked)
    if not _wait_replicas_equal(cluster):
        violations.append(f"{tag}: baseline never converged")
        return
    victim = rng.choice(followers)
    extra = rng.choice([None,
                        ("participant.transition", "fail_nth:1"),
                        ("controller.assign", "fail_nth:1")])
    if extra is not None:
        fp.activate(*extra)
    victim.participant.coord.suspend_heartbeats()
    node_path = cluster_path(cluster.cluster, "instances",
                             victim.instance.instance_id)
    if not cluster.wait(lambda: not cluster.client.exists(node_path), 8.0):
        violations.append(f"{tag}: {victim.name} session never expired")
    # leader untouched: these acks ride the surviving follower — safe
    cluster.write_some(rng, tag + "-mid", rng.randint(3, 6), acked)
    victim.participant.coord.resume_heartbeats()
    if not cluster.wait(lambda: cluster.client.exists(node_path), 8.0):
        violations.append(
            f"{tag}: {victim.name} never re-registered after expiry "
            f"(rejoin gap)")
    if extra is not None:
        fp.deactivate(extra[0])


def _coordinator_failover(cluster, tag, violations):
    """Kill the primary, promote the standby, spin up a fresh standby,
    and teach every client the new standby's endpoint (stands in for
    ensemble discovery, which needs routable IPs — loopback standbys
    advertise nothing)."""
    from rocksplicator_tpu_torch.cluster.coordinator import CoordinatorServer

    old_primary = cluster.primary
    old_primary.stop()
    cluster.standby.promote()
    cluster.primary = cluster.standby
    cluster.standby = CoordinatorServer(
        port=0, session_ttl=FAILOVER_SESSION_TTL,
        data_dir=cluster._coord_dir(),
        replica_of=("127.0.0.1", cluster.primary.port))
    ep = ("127.0.0.1", cluster.standby.port)
    for coord_client in [n.participant.coord for n in cluster.nodes] + [
            cluster.controller.coord, cluster.spectator.coord,
            cluster.client]:
        if ep not in coord_client._endpoints:
            coord_client._endpoints.append(ep)


def _schedule_coordinator_failover(cluster, rng, acked, violations, tag,
                                   timings):
    """Kill the coordinator primary mid-write. Sessions survive on the
    promoted standby (replicated, TTL grace), clients rotate, and the
    data plane never blinks — leadership must NOT move."""
    cluster.write_some(rng, tag + "-pre", rng.randint(4, 8), acked)
    if not _wait_replicas_equal(cluster):
        violations.append(f"{tag}: baseline never converged")
        return
    _coordinator_failover(cluster, tag, violations)
    # a coordinator failover is invisible to the data plane: these acks
    # are strict-ledger safe
    cluster.write_some(rng, tag + "-mid", rng.randint(4, 8), acked)


def _schedule_coordinator_wal_torn(cluster, rng, acked, violations, tag,
                                   timings):
    """Torn-write the coordinator WAL: the primary fail-stops for
    mutations (every pending and future mutation fenced — the
    coordinator.py _Wal contract), and the cluster heals by failing over
    to the standby."""
    cluster.write_some(rng, tag + "-pre", rng.randint(4, 8), acked)
    if not _wait_replicas_equal(cluster):
        violations.append(f"{tag}: baseline never converged")
        return
    fp.activate("coordinator.wal.append",
                f"torn:1.0@seed{rng.randrange(1 << 16)},one_shot")
    # poke durable mutations until the one-shot policy is consumed — a
    # single put can die on a stale endpoint (mutations never blind-
    # retry after a connection error) without ever reaching a WAL
    for attempt in range(6):
        try:
            cluster.client.put(f"/chaos/poke/{tag}/{attempt}", b"x")
        except Exception:
            pass  # the poke itself may be the torn mutation
        if not fp.is_active("coordinator.wal.append"):
            break  # one_shot consumed: the tear landed
    fp.deactivate("coordinator.wal.append")
    primary_fenced = (cluster.primary._wal is not None
                     and cluster.primary._wal.failed is not None)
    standby_fenced = (cluster.standby._wal is not None
                      and cluster.standby._wal.failed is not None)
    if primary_fenced:
        # fail-stop contract: NOTHING mutates after the fence
        try:
            cluster.client.put(f"/chaos/poke2/{tag}", b"y")
            violations.append(
                f"{tag}: mutation SUCCEEDED on a fenced coordinator WAL")
        except Exception:
            pass
        _coordinator_failover(cluster, tag, violations)
    elif standby_fenced:
        # the replicated append tripped on the standby first: its durable
        # persistence stopped (promote would refuse) — replace it
        from rocksplicator_tpu_torch.cluster.coordinator import \
            CoordinatorServer

        cluster.standby.stop()
        cluster.standby = CoordinatorServer(
            port=0, session_ttl=FAILOVER_SESSION_TTL,
            data_dir=cluster._coord_dir(),
            replica_of=("127.0.0.1", cluster.primary.port))
    else:
        violations.append(f"{tag}: torn WAL append fenced neither "
                          f"coordinator")
    cluster.write_some(rng, tag + "-post", rng.randint(3, 6), acked)


def _schedule_blip(kind):
    def run(cluster, rng, acked, violations, tag, timings):
        s = rng.randrange(1 << 16)
        if kind == "hb_delay":
            fp.activate("coordinator.heartbeat",
                        f"delay_ms:{rng.randint(40, 120)}:"
                        f"{rng.uniform(0.2, 0.5):.2f}@seed{s}")
        elif kind == "reap_blip":
            fp.activate("coordinator.reap",
                        f"fail_first:{rng.randint(1, 3)}")
        elif kind == "shardmap_blip":
            fp.activate("shardmap.publish",
                        f"fail_first:{rng.randint(1, 2)}")
        elif kind == "read_blip":
            # the read seam: failing reads mid-schedule must only ever
            # surface as errors/bounces at the client, never as a
            # served-but-wrong read (the post-schedule invariant check)
            fp.activate("repl.read",
                        f"fail_prob:{rng.uniform(0.3, 0.7):.2f}@seed{s}")
        cluster.write_some(rng, tag, rng.randint(6, 12), acked)
        if kind == "read_blip":
            # drive reads THROUGH the armed seam at every replica
            db = cluster.db_names[0]
            for node in cluster.nodes:
                for _ in range(rng.randint(2, 4)):
                    try:
                        cluster.rpc(node.replicator.port, "read",
                                    dict(db_name=db, op="get",
                                         keys=[b"probe"], max_lag=5))
                    except Exception:
                        timings["read_bounces"] += 1
        time.sleep(rng.uniform(0.1, 0.4))
        fp.clear()

    return run


def _schedule_overload_shed(cluster, rng, acked, violations, tag, timings):
    """Overload schedule: tail-armor sheds and hedges fire
    while acked writes keep landing. The armed seams force the TYPED
    degrade paths — ``rpc.deadline.check`` forces expired verdicts,
    ``admission.shed`` forces tenant RETRY_LATER sheds, and
    ``router.hedge.fire`` makes hedge launches fall back to the primary
    arm — while ``repl.read`` delays make real hedges (and their
    loser-cancel frames, the obvious new race) actually fire. A shed is
    a typed refusal, never damage: the standing invariants (zero
    acked-write loss, bounded staleness) must hold unchanged."""
    from rocksplicator_tpu_torch.rpc.errors import RpcApplicationError
    from rocksplicator_tpu_torch.rpc.router import (ClusterLayout, ReadPolicy,
                                              RpcRouter)

    s = rng.randrange(1 << 16)
    fp.activate("rpc.deadline.check",
                f"fail_prob:{rng.uniform(0.2, 0.5):.2f}@seed{s}")
    fp.activate("admission.shed",
                f"fail_prob:{rng.uniform(0.2, 0.5):.2f}@seed{s + 1}")
    fp.activate("router.hedge.fire",
                f"fail_prob:{rng.uniform(0.2, 0.4):.2f}@seed{s + 2}")
    # stall ~half the read serves so the p95-floored hedge delay is
    # actually beaten and backup arms launch (then get cancelled)
    fp.activate("repl.read",
                f"delay_ms:{rng.randint(15, 30)}:0.5@seed{s + 3}")
    saved_floor = os.environ.get("RSTPU_HEDGE_FLOOR_MS")
    os.environ["RSTPU_HEDGE_FLOOR_MS"] = "2"
    router = RpcRouter(pool=cluster._pool)
    sheds = 0
    try:
        cluster.write_some(rng, tag, rng.randint(6, 12), acked)
        db = cluster.db_names[0]
        for node in cluster.nodes:
            # one zero-budget probe per node guarantees the deadline
            # shed fires even if every probability roll misses
            for deadline_ms in [0.0] + [
                    rng.choice([50.0, 2000.0])
                    for _ in range(rng.randint(2, 4))]:
                try:
                    cluster.rpc(node.replicator.port, "read",
                                dict(db_name=db, op="get", keys=[b"probe"],
                                     max_lag=5),
                                deadline_ms=deadline_ms,
                                tenant=rng.choice(["noisy", "quiet"]))
                except RpcApplicationError as e:
                    if e.code in ("DEADLINE_EXCEEDED", "RETRY_LATER"):
                        sheds += 1
                    timings["read_bounces"] += 1
                except Exception:
                    timings["read_bounces"] += 1
        if cluster.maps:
            router.update_layout(ClusterLayout.parse(
                json.dumps(cluster.maps[-1]).encode()))
            router._hedge_credit = router._hedge_credit_cap  # prime budget

            async def hedged():
                return await router.read(
                    cluster.segment, 0, op="get", keys=[b"probe"],
                    policy=ReadPolicy.follower_ok(max_lag=5), timeout=5.0)

            for _ in range(rng.randint(6, 10)):
                try:
                    cluster._ioloop.run_sync(hedged(), timeout=10)
                except Exception:
                    timings["read_bounces"] += 1
        # writes must keep landing while the serving path is shedding
        cluster.write_some(rng, tag + "-during", rng.randint(4, 8), acked)
    finally:
        if saved_floor is None:
            os.environ.pop("RSTPU_HEDGE_FLOOR_MS", None)
        else:
            os.environ["RSTPU_HEDGE_FLOOR_MS"] = saved_floor
        fp.clear()
    if sheds == 0:
        violations.append(
            f"{tag}: overload schedule armed shed seams but ZERO typed "
            f"sheds fired (the zero-budget probes must shed)")
    time.sleep(rng.uniform(0.1, 0.3))


_FAILOVER_SCHEDULES = {
    "leader_crash": _schedule_leader_crash,
    "session_expiry": _schedule_session_expiry,
    "follower_expiry": _schedule_follower_expiry,
    "coordinator_failover": _schedule_coordinator_failover,
    "coordinator_wal_torn": _schedule_coordinator_wal_torn,
    "hb_delay": _schedule_blip("hb_delay"),
    "reap_blip": _schedule_blip("reap_blip"),
    "shardmap_blip": _schedule_blip("shardmap_blip"),
    "read_blip": _schedule_blip("read_blip"),
    "overload_shed": _schedule_overload_shed,
}
_HEAVY_KINDS = ["leader_crash", "session_expiry", "coordinator_failover",
                "coordinator_wal_torn", "follower_expiry"]
_LIGHT_KINDS = ["hb_delay", "reap_blip", "shardmap_blip", "read_blip",
                "overload_shed"]


def _failover_deck(rng: random.Random, schedules: int,
                   break_guard: Optional[str]) -> List[str]:
    """Seeded schedule deck: every heavy kind appears at least once when
    the run is long enough; the rest is a light-weighted draw. The
    fencing tooth leads with the schedule that carries the stale-frame
    probes."""
    deck: List[str] = []
    if break_guard == "fencing":
        deck.append("leader_crash")
    core = list(_HEAVY_KINDS)
    rng.shuffle(core)
    deck.extend(core[:max(0, schedules - len(deck))])
    while len(deck) < schedules:
        deck.append(rng.choice(_HEAVY_KINDS + _LIGHT_KINDS * 4))
    return deck[:schedules]


def _check_failover_invariants(cluster: FailoverCluster, acked, tag,
                               violations, timeout: float = 15.0) -> int:
    """The fourth standing invariant, checked after EVERY schedule:
    exactly one LEADER per shard (current states AND the published shard
    map), zero acked-write loss (every strict-ledger ack readable on
    every replica), and convergence within a bounded number of
    controller passes."""
    passes0 = cluster.controller.passes
    detail = {}

    def healthy():
        for partition in cluster.partitions:
            states = [s for s in cluster.states(partition).values() if s]
            if sorted(states) != ["FOLLOWER", "FOLLOWER", "LEADER"]:
                detail["states"] = cluster.states(partition)
                return False
        for db in cluster.db_names:
            seqs = cluster.seqs(db)
            if None in seqs or len(set(seqs)) != 1:
                detail["seqs"] = seqs
                return False
        for db in cluster.db_names:
            for n in cluster.nodes:
                app = n.handler.db_manager.get_db(db)
                if app is None:  # mid-repoint reopen
                    detail["lost"] = (n.name, "db closed")
                    return False
                for key, val in acked:
                    if app.db.get(key) != val:
                        detail["lost"] = (n.name, key)
                        return False
        if not cluster.maps:
            detail["map"] = "never published"
            return False
        seg = cluster.maps[-1].get(cluster.segment) or {}
        for s in range(cluster.num_shards):
            mark = f"{s:05d}:M"
            leaders = sum(
                1 for host, entries in seg.items()
                if host != "num_shards" for e in entries if e == mark)
            if leaders != 1:
                detail["map"] = f"shard {s}: {leaders} leaders in map"
                return False
        return True

    ok = cluster.wait(healthy, timeout)
    passes = cluster.controller.passes - passes0
    if not ok:
        violations.append(
            f"{tag}: NO HEAL within {timeout}s / {passes} controller "
            f"passes — {detail}")
    elif passes > FAILOVER_PASS_BOUND:
        violations.append(
            f"{tag}: healed but took {passes} controller passes "
            f"(bound {FAILOVER_PASS_BOUND})")
    return passes


def _check_read_invariants(cluster: FailoverCluster, acked, tag,
                           violations, timings) -> None:
    """The fifth standing invariant, checked after every healed schedule:
    ZERO reads violate the client's staleness bound and ZERO reads are
    served from a deposed lineage.

    Method (race-free by construction): the workload is quiesced here,
    so after sleeping out ``read_info_ttl_ms`` every estimate a serving
    follower may rely on was heard AFTER the last commit — sampling the
    leader's committed seq L0 then makes ``applied_seq >= L0 - bound``
    an EXACT requirement for any served bounded read, not a heuristic.
    Bounces (STALE_READ / STALE_EPOCH) are always legal; serving outside
    the bound or from a stale lineage never is."""
    partition, db = cluster.partitions[0], cluster.db_names[0]
    leader = cluster.leader_node(partition)
    if leader is None:
        return  # heal already failed; invariant 4 reported it
    lrdb = leader.rdb(db)
    if lrdb is None:
        return
    epoch = lrdb.epoch
    time.sleep(FAILOVER_FLAGS.read_info_ttl_ms / 1000.0 + 0.05)
    lapp = leader.handler.db_manager.get_db(db)
    if lapp is None:
        return
    l0 = lapp.db.latest_sequence_number_relaxed()
    key, val = acked[-1] if acked else (b"probe", None)
    for node in cluster.nodes:
        for bound in (0, 5):
            timings["reads_checked"] += 1
            try:
                resp = cluster.rpc(
                    node.replicator.port, "read",
                    dict(db_name=db, op="get", keys=[key],
                         max_lag=bound, epoch=epoch))
            except Exception:
                timings["read_bounces"] += 1
                continue  # bouncing is always legal
            timings["reads_served"] += 1
            applied = int(resp.get("applied_seq") or 0)
            resp_epoch = int(resp.get("epoch") or 0)
            if applied < l0 - bound:
                violations.append(
                    f"{tag}: STALENESS BOUND VIOLATED — {node.name} "
                    f"served a max_lag={bound} read at applied_seq "
                    f"{applied} with leader committed {l0}")
            if resp_epoch < epoch:
                violations.append(
                    f"{tag}: READ SERVED FROM DEPOSED LINEAGE — "
                    f"{node.name} served at epoch {resp_epoch} < "
                    f"current {epoch}")
            if val is not None:
                got = resp["values"][0]
                got = bytes(got) if got is not None else None
                if got != val:
                    violations.append(
                        f"{tag}: read of acked key {key!r} on "
                        f"{node.name} returned {got!r} (want {val!r})")


def _gauge_snapshot(tag: str) -> Dict:
    """State picture recorded in the artifact after each
    schedule: per-shard replication lag, ack-window occupancy, and
    compaction debt (the chaos clusters are in-process, so the gauges
    live on this process's Stats registry). An invariant violation now
    ships WITH the cluster's load/debt state at check time instead of
    leaving the reproducer to re-derive it."""
    from rocksplicator_tpu_torch.utils.stats import Stats

    gauges = Stats.get().gauge_values(prefixes=(
        "replicator.applied_seq_lag",
        "replicator.ack_window_depth",
        "storage.compaction_debt_bytes",
        "storage.memtable_bytes",
    ))
    # debt gauges are per level — drop the all-zero ones so the
    # snapshot stays readable at 7 levels x N shards
    return {
        "schedule": tag,
        "gauges": {k: round(v, 1) for k, v in sorted(gauges.items())
                   if v or not k.startswith("storage.compaction_debt")},
    }


def run_failover_chaos(
    root: str,
    schedules: int = 15,
    seed: int = 1,
    break_guard: Optional[str] = None,
    heal_timeout: float = 15.0,
    log=print,
    device=None,
) -> Dict:
    """Coordinator-backed chaos: seeded control-plane fault schedules
    against a full Controller + Spectator + 3-participant cluster,
    holding the fourth standing invariant after every schedule. The
    nodes compact on ``device`` (None means ``cuda``)."""
    saved_env = {
        k: os.environ.get(k)
        for k in ("RSTPU_RETRY_SEED", "RSTPU_PULL_RETRY_SEED")
    }
    os.environ["RSTPU_RETRY_SEED"] = str(seed)
    os.environ["RSTPU_PULL_RETRY_SEED"] = str(seed)
    undo = _break_guard(break_guard) if break_guard else None
    violations: List[str] = []
    acked: List[Tuple[bytes, bytes]] = []
    timings: Dict = {"failover_ms": [], "first_ack_ms": [],
                     "passes_used": [], "window_acked": 0,
                     "reads_checked": 0, "reads_served": 0,
                     "read_bounces": 0}
    gauge_snapshots: List[Dict] = []
    fp.clear()
    t_setup = time.monotonic()
    cluster = FailoverCluster(root, device=device)
    deck: List[str] = []
    try:
        cluster.wait_initial_convergence()
        setup_sec = round(time.monotonic() - t_setup, 1)
        deck = _failover_deck(random.Random(seed), schedules, break_guard)
        log(f"  cluster up in {setup_sec}s; deck: {deck}")
        for si, kind in enumerate(deck):
            rng = random.Random(seed * 1_000_003 + si)
            tag = f"s{si:02d}-{kind}/seed {seed}"
            try:
                _FAILOVER_SCHEDULES[kind](
                    cluster, rng, acked, violations, tag, timings)
            finally:
                fp.clear()  # no fault outlives its schedule
            timings["passes_used"].append(
                _check_failover_invariants(cluster, acked, tag, violations,
                                           timeout=heal_timeout))
            # fifth standing invariant: bounded-staleness + lineage
            # rules hold on every replica once the schedule healed
            _check_read_invariants(cluster, acked, tag, violations,
                                   timings)
            gauge_snapshots.append(_gauge_snapshot(tag))
            log(f"  [{si + 1}/{len(deck)}] {kind}: acked={len(acked)} "
                f"reads={timings['reads_served']}"
                f"/{timings['reads_checked']} "
                f"violations={len(violations)}")
            if violations and break_guard:
                break  # teeth demonstrated
    finally:
        fp.clear()
        if undo:
            undo()
        cluster.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def _med(xs):
        return round(sorted(xs)[len(xs) // 2], 1) if xs else None

    return {
        "mode": "failover",
        "schedules": len(deck),
        "deck": deck,
        "seed": seed,
        "acked": len(acked),
        "window_acked": timings["window_acked"],
        "violations": violations,
        "failover_ms": [round(x, 1) for x in timings["failover_ms"]],
        "failover_ms_median": _med(timings["failover_ms"]),
        "first_ack_ms": [round(x, 1) for x in timings["first_ack_ms"]],
        "first_ack_ms_median": _med(timings["first_ack_ms"]),
        "passes_used": timings["passes_used"],
        "reads_checked": timings["reads_checked"],
        "reads_served": timings["reads_served"],
        "read_bounces": timings["read_bounces"],
        "gauge_snapshots": gauge_snapshots,
        "failpoint_trips": fp.trip_counts(),
        "break_guard": break_guard,
    }


# ---------------------------------------------------------------------------
# the reshard deck: live shard moves under fault
# ---------------------------------------------------------------------------

# the move step machine's failpoint seams: arming fail_nth on one IS the
# "kill the move coordinator at this phase" schedule (registration
# asserted by tests like the other menus)
_RESHARD_FAULT_SITES = [
    "move.record", "move.snapshot", "move.restore", "move.catchup",
    "move.flip", "move.retire",
    "coordinator.heartbeat", "coordinator.wal.append", "repl.pull",
    "rpc.frame.send",
]

# every actor × phase: the mover killed at each of its five seams (+ the
# ledger-write seam), the source/target participants killed mid-move,
# cluster-wide session expiry, the coordinator torn/killed, a data-plane
# fault riding the whole move, plus clean leader/follower moves and a
# whole-node drain
_RESHARD_KINDS = [
    "move_clean_leader", "move_clean_follower", "move_drain",
    "move_crash_record", "move_crash_snapshot", "move_crash_restore",
    "move_crash_catchup", "move_crash_flip", "move_crash_retire",
    "move_kill_source", "move_kill_target", "move_session_expiry",
    "move_coord_torn", "move_coord_failover", "move_fault_dataplane",
]


def _move_flags():
    """Chaos-sized move pacing: many move→fault→heal cycles per minute."""
    from rocksplicator_tpu_torch.cluster.shard_move import MoveFlags

    return MoveFlags(
        catchup_lag_threshold=16, catchup_timeout=40.0,
        cutover_pause_ms=4000.0, cutover_attempts=3,
        flip_timeout=25.0, retire_timeout=25.0,
        poll_interval=0.05, record_update_interval=0.25,
    )


class _BgWriter:
    """Continuous write load riding THROUGH every move phase — the acked
    ledger the zero-loss-across-the-move invariant is checked against.
    Writes go to whichever node currently claims leadership; errors
    (WRITE_PAUSED during cutover, NOT_LEADER mid-flip, no leader) are
    expected and counted, never acked."""

    def __init__(self, cluster: FailoverCluster, tag: str,
                 interval: float = 0.02):
        self.cluster = cluster
        self.tag = tag
        self.interval = interval
        self.errors = 0
        self.window_acked = 0
        # participant-kill / session-expiry schedules flip this ON at
        # the kill: from that instant leadership may churn with a
        # deposed-but-uninformed leader still granting acks — the
        # documented semi-sync visibility-window residual. Writes
        # SUBMITTED while the window is open are counted but not held
        # to the strict ledger (exactly the failover deck's session-expiry
        # accounting); pre-kill acks stay strict.
        self.window_mode = False
        self._waiters: List = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="chaos-move-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        partition = self.cluster.partitions[0]
        db = self.cluster.db_names[0]
        i = 0
        while not self._stop.wait(self.interval):
            i += 1
            key = f"{self.tag}-bg{i:05d}".encode()
            node = self.cluster.leader_node(partition)
            app = (node.handler.db_manager.get_db(db)
                   if node is not None else None)
            if app is None:
                self.errors += 1
                continue
            strict = not self.window_mode
            try:
                w = app.write_async(WriteBatch().put(key, key))
            except Exception:
                self.errors += 1
                continue
            with self._lock:
                self._waiters.append((key, key, w, strict))

    def _collect_one(self, item, acked) -> None:
        key, val, w, strict = item
        if not w.acked:
            return
        if strict:
            acked.append((key, val))
        else:
            self.window_acked += 1

    def harvest(self, acked: List[Tuple[bytes, bytes]]) -> None:
        """Move already-resolved acks into the ledger NOW — the sharp
        post-flip probes check against writes acked before the flip."""
        with self._lock:
            pending = []
            for item in self._waiters:
                if item[2].future.done():
                    self._collect_one(item, acked)
                else:
                    pending.append(item)
            self._waiters = pending

    def stop_collect(self, acked: List[Tuple[bytes, bytes]]) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        with self._lock:
            waiters, self._waiters = self._waiters, []
        for item in waiters:
            try:
                item[2].future.result(3.0)
            except Exception:
                continue
            self._collect_one(item, acked)


def _start_move_bg(cluster: FailoverCluster, source_iid: str,
                   target_iid: str, flags) -> Dict:
    """Run one coordinated move in a background thread (the 'move
    coordinator' actor the schedules kill) against the harness's shared
    coordinator/admin clients."""
    from rocksplicator_tpu_torch.cluster.shard_move import ShardMove

    box: Dict = {"mover": None, "error": None, "record": None,
                 "done": threading.Event()}
    partition = cluster.partitions[0]

    def go():
        try:
            mv = ShardMove.start(
                cluster.client, cluster.cluster, partition, source_iid,
                target_iid, cluster.store_uri, admin=cluster.admin,
                flags=flags)
            box["mover"] = mv
            box["record"] = mv.run()
        except BaseException as e:
            box["error"] = e
        finally:
            box["done"].set()

    t = threading.Thread(target=go, name="chaos-mover", daemon=True)
    t.start()
    box["thread"] = t
    return box


def _start_drain_bg(cluster: FailoverCluster, node, flags) -> Dict:
    from rocksplicator_tpu_torch.cluster.shard_move import drain_node

    box: Dict = {"mover": None, "error": None, "record": None,
                 "done": threading.Event()}

    def go():
        try:
            box["record"] = drain_node(
                cluster.client, cluster.cluster,
                node.instance.instance_id, cluster.store_uri,
                admin=cluster.admin, flags=flags,
                log_fn=lambda *_a, **_k: None)
        except BaseException as e:
            box["error"] = e
        finally:
            box["done"].set()

    t = threading.Thread(target=go, name="chaos-drainer", daemon=True)
    t.start()
    box["thread"] = t
    return box


def _wait_move_phase(box: Dict, phase: str, timeout: float = 30.0) -> bool:
    """Wait until the mover has ENTERED ``phase`` (or finished/crashed —
    both mean the seam was passed or will never be reached)."""
    from rocksplicator_tpu_torch.cluster.shard_move import PHASES

    order = {p: i for i, p in enumerate(PHASES)}
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if box["done"].is_set():
            return True
        mv = box.get("mover")
        if mv is not None and order.get(mv.rec.phase, -1) >= order[phase]:
            return True
        time.sleep(0.02)
    return False


def _finish_move(cluster: FailoverCluster, box: Dict, rng: random.Random,
                 tag: str, violations: List[str], flags,
                 timeout: float = 90.0) -> str:
    """Drive the move to a TERMINAL state: completed as launched, or —
    after a crash — either resumed to completion or cleanly aborted
    (seeded choice where both are legal). A move that can do neither is
    the 'half-flipped map' state the step machine exists to prevent:
    a violation."""
    from rocksplicator_tpu_torch.cluster.model import cluster_path
    from rocksplicator_tpu_torch.cluster.shard_move import MoveRecord, \
        ShardMove

    if not box["done"].wait(timeout):
        violations.append(f"{tag}: move wedged (no exit in {timeout}s)")
        return "wedged"
    partition = cluster.partitions[0]
    if box["error"] is None:
        return "completed"
    raw = cluster.client.get_or_none(
        cluster_path(cluster.cluster, "moves", partition))
    if raw is None:
        # crashed before the ledger write landed (or after the final
        # delete): nothing half-done exists to resume
        return "no_record"
    rec = MoveRecord.decode(raw)
    abortable = rec.phase in ("planned", "snapshot", "restore", "catchup")
    if abortable and rng.random() < 0.5:
        try:
            ShardMove.resume(cluster.client, cluster.cluster, partition,
                             admin=cluster.admin, flags=flags).abort()
            return "aborted"
        except Exception as e:
            violations.append(
                f"{tag}: ABORT FAILED from phase {rec.phase}: {e!r}")
            return "abort_failed"
    last: Optional[BaseException] = None
    for _attempt in range(2):
        try:
            ShardMove.resume(cluster.client, cluster.cluster, partition,
                             admin=cluster.admin, flags=flags).run()
            return "resumed"
        except Exception as e:
            last = e
            time.sleep(0.5)
    violations.append(
        f"{tag}: RESUME FAILED from phase {rec.phase} (half-flipped "
        f"state left behind): {last!r}")
    return "resume_failed"


def _probe_serving_lineages(cluster: FailoverCluster, tag: str,
                            violations: List[str],
                            duration: float = 1.5) -> None:
    """Sharp lineage check sampled across the flip window: at NO instant
    may two unfenced data-plane LEADERs coexist — the pinned two-phase
    flip demotes the source before the target may promote, and the
    ``move_flip`` tooth (force-promote without drain/demote) is exactly
    what this catches."""
    db = cluster.db_names[0]
    deadline = time.monotonic() + duration
    while time.monotonic() < deadline:
        leaders = []
        for n in cluster.nodes:
            rdb = n.rdb(db)
            if (rdb is not None and rdb.role is ReplicaRole.LEADER
                    and not rdb.fenced and not rdb.removed):
                leaders.append(n.name)
        if len(leaders) > 1:
            violations.append(
                f"{tag}: TWO SERVING LINEAGES — unfenced leaders "
                f"{leaders} coexist (flip before demote)")
            return
        time.sleep(0.03)


def _probe_new_lineage(cluster: FailoverCluster, box: Dict,
                       acked: List[Tuple[bytes, bytes]], tag: str,
                       violations: List[str]) -> None:
    """The moment the cutover claims completion (phase → retire), every
    write acked so far must be readable on the NEW leader — a flip that
    beat catch-up shows up here as a hole in the acked ledger."""
    mv = box.get("mover")
    if mv is None or not mv.rec.moving_leader:
        return
    node = next((n for n in cluster.nodes
                 if n.instance.instance_id == mv.rec.target), None)
    if node is None:
        return
    db = cluster.db_names[0]
    deadline = time.monotonic() + 2.0
    app = None
    while time.monotonic() < deadline and app is None:
        app = node.handler.db_manager.get_db(db)
        if app is None:
            time.sleep(0.05)
    if app is None:
        return  # mid-reopen; the post-schedule invariant check covers it
    for key, val in list(acked)[-20:]:
        try:
            got = app.db.get(key)
        except Exception:
            return
        if got != val:
            violations.append(
                f"{tag}: ACKED WRITE {key!r} MISSING ON NEW LINEAGE "
                f"{mv.rec.target} (flip before catch-up completed)")
            return


def _reshard_schedule(kind: str):
    def run(cluster: FailoverCluster, rng: random.Random, acked,
            violations: List[str], tag: str, timings: Dict) -> None:
        from rocksplicator_tpu_torch.cluster.model import cluster_path

        partition = cluster.partitions[0]
        _wait_settled(cluster)
        cluster.write_some(rng, tag + "-pre", rng.randint(4, 8), acked)
        # generous window: the PREVIOUS schedule's healed participants
        # (rejoins, deposed resyncs, late drops) may still be settling
        if not _wait_replicas_equal(cluster, timeout=25.0):
            violations.append(f"{tag}: baseline never converged")
            return
        move_leader = kind != "move_clean_follower"
        leader = cluster.leader_node(partition)
        followers = [n for n in cluster.nodes
                     if n.state_of(partition) in ("FOLLOWER", "SLAVE")]
        free = [n for n in cluster.nodes if not n.state_of(partition)]
        if leader is None or not free or (
                not move_leader and not followers):
            violations.append(f"{tag}: no legal move endpoints "
                              f"({cluster.states(partition)})")
            return
        source = leader if move_leader else rng.choice(followers)
        target = rng.choice(free)
        flags = _move_flags()
        writer = _BgWriter(cluster, tag)
        healers: List[FailoverNode] = []
        t0 = time.monotonic()
        outcome = "?"
        try:
            if kind == "move_coord_torn":
                # the flip's durable writes (move ledger, pin, epoch)
                # hit a torn coordinator WAL: the primary fail-stops and
                # the mover's mutation dies mid-flight
                fp.activate(
                    "coordinator.wal.append",
                    f"torn:1.0@seed{rng.randrange(1 << 16)},one_shot")
            crash_site = {
                "move_crash_record": ("move.record", "fail_nth:2"),
                "move_crash_snapshot": ("move.snapshot", "fail_nth:1"),
                "move_crash_restore": ("move.restore", "fail_nth:1"),
                "move_crash_catchup": ("move.catchup", "fail_nth:1"),
                "move_crash_flip": ("move.flip", "fail_nth:1"),
                "move_crash_retire": ("move.retire", "fail_nth:1"),
            }.get(kind)
            if crash_site:
                fp.activate(*crash_site)
            if kind == "move_fault_dataplane":
                s = rng.randrange(1 << 16)
                fp.activate(
                    rng.choice(["repl.pull", "rpc.frame.send"]),
                    f"fail_prob:{rng.uniform(0.03, 0.10):.3f}@seed{s}")
            if kind == "move_drain":
                box = _start_drain_bg(cluster, source, flags)
            else:
                box = _start_move_bg(
                    cluster, source.instance.instance_id,
                    target.instance.instance_id, flags)
            if kind == "move_kill_source":
                if _wait_move_phase(box, "catchup"):
                    # from here leadership may churn with deposed-but-
                    # uninformed claimers: acks ride the documented
                    # visibility window, not the strict ledger
                    writer.window_mode = True
                    source.participant.coord.suspend_heartbeats()
                    healers.append(source)
            elif kind == "move_kill_target":
                if _wait_move_phase(box,
                                    rng.choice(["restore", "catchup"])):
                    writer.window_mode = True
                    target.participant.coord.suspend_heartbeats()
                    healers.append(target)
            elif kind == "move_session_expiry":
                if _wait_move_phase(
                        box, rng.choice(["snapshot", "restore",
                                         "catchup"])):
                    writer.window_mode = True
                    fp.activate("coordinator.heartbeat",
                                f"fail_first:{rng.randint(25, 45)}")
                    time.sleep(FAILOVER_SESSION_TTL * 1.7)
                    fp.deactivate("coordinator.heartbeat")
            elif kind == "move_coord_failover":
                if _wait_move_phase(box,
                                    rng.choice(["restore", "catchup"])):
                    _coordinator_failover(cluster, tag, violations)
            # sharp flip-window probes — only where every participant
            # stays responsive, so the two-phase demote-before-promote
            # discipline is actually observable: under participant
            # kills / session expiry / coordinator faults a wedged
            # deposed leader legitimately lingers as an unfenced zombie
            # (the documented failover state — it cannot ACK and cannot
            # serve lineage-valid reads, which invariants 4/5 check;
            # it fences on first contact)
            probing = kind in (
                "move_clean_leader", "move_clean_follower", "move_drain",
                "move_crash_record", "move_crash_snapshot",
                "move_crash_restore", "move_crash_catchup",
                "move_crash_flip", "move_crash_retire",
                "move_fault_dataplane")
            if probing and _wait_move_phase(box, "retire", timeout=60.0):
                writer.harvest(acked)
                _probe_serving_lineages(cluster, tag, violations)
                _probe_new_lineage(cluster, box, acked, tag, violations)
            if violations and timings.get("fast_fail"):
                # teeth run: the broken guard is caught — don't spend a
                # minute trying to recover a deliberately-broken flip
                return
            if crash_site:
                fp.deactivate(crash_site[0])
            if kind == "move_coord_torn":
                # the tear fail-stopped a coordinator (the mover's
                # ledger write died with it): heal the control plane
                # BEFORE terminal recovery, exactly like the failover deck's
                # coordinator_wal_torn schedule
                box["done"].wait(30.0)
                fp.deactivate("coordinator.wal.append")
                primary_fenced = (cluster.primary._wal is not None
                                  and cluster.primary._wal.failed
                                  is not None)
                standby_fenced = (cluster.standby._wal is not None
                                  and cluster.standby._wal.failed
                                  is not None)
                if primary_fenced:
                    _coordinator_failover(cluster, tag, violations)
                elif standby_fenced:
                    from rocksplicator_tpu_torch.cluster.coordinator import \
                        CoordinatorServer

                    cluster.standby.stop()
                    cluster.standby = CoordinatorServer(
                        port=0, session_ttl=FAILOVER_SESSION_TTL,
                        data_dir=cluster._coord_dir(),
                        replica_of=("127.0.0.1", cluster.primary.port))
            # a killed participant must heal BEFORE terminal recovery:
            # resume/abort legitimately need its admin plane back
            if healers:
                box["done"].wait(60.0)
                for n in healers:
                    n.participant.coord.resume_heartbeats()
                for n in healers:
                    node_path = cluster_path(
                        cluster.cluster, "instances",
                        n.instance.instance_id)
                    cluster.wait(
                        lambda: cluster.client.exists(node_path), 10.0)
                healers.clear()
            outcome = _finish_move(cluster, box, rng, tag, violations,
                                   flags)
            if probing and outcome in ("completed", "resumed"):
                _probe_serving_lineages(cluster, tag, violations,
                                        duration=0.5)
        finally:
            for n in healers:
                n.participant.coord.resume_heartbeats()
            fp.clear()
            writer.stop_collect(acked)
        timings["move_outcomes"][outcome] = \
            timings["move_outcomes"].get(outcome, 0) + 1
        timings["move_ms"].append(
            round((time.monotonic() - t0) * 1000.0, 1))
        timings["write_errors"] += writer.errors
        timings["window_acked"] += writer.window_acked

    return run


def _reshard_deck(rng: random.Random, schedules: int,
                  break_guard: Optional[str]) -> List[str]:
    """Every kind at least once when the run is long enough; the
    move_flip tooth leads with the clean leader move it breaks."""
    deck: List[str] = []
    if break_guard == "move_flip":
        deck.append("move_clean_leader")
    core = list(_RESHARD_KINDS)
    rng.shuffle(core)
    deck.extend(core[:max(0, schedules - len(deck))])
    while len(deck) < schedules:
        deck.append(rng.choice(_RESHARD_KINDS))
    return deck[:schedules]


def _check_reshard_invariants(cluster: FailoverCluster, acked, tag: str,
                              violations: List[str],
                              timeout: float = 30.0) -> int:
    """The SIXTH standing invariant, after EVERY reshard schedule:
    exactly one serving lineage per shard (current states, the
    published map, AND the data plane agree on one unfenced leader),
    zero acked-write loss across the move (every acked key readable on
    every CURRENT host — the hosting set itself may have moved), no
    stranded replicas (a non-host holding the db = un-swept move
    garbage), and convergence within the controller-pass bound."""
    partition, db = cluster.partitions[0], cluster.db_names[0]
    passes0 = cluster.controller.passes
    detail: Dict = {}

    def healthy():
        from rocksplicator_tpu_torch.storage.errors import StorageError

        hosts = [n for n in cluster.nodes if n.state_of(partition)]
        states = sorted(n.state_of(partition) for n in hosts)
        if states != ["FOLLOWER", "FOLLOWER", "LEADER"]:
            detail["states"] = cluster.states(partition)
            return False
        seqs = []
        apps = {}
        try:
            for n in hosts:
                app = n.handler.db_manager.get_db(db)
                if app is None:
                    detail["lost"] = (n.name, "db closed")
                    return False
                apps[n.name] = app
                seqs.append(app.db.latest_sequence_number_relaxed())
            if len(set(seqs)) != 1:
                detail["seqs"] = seqs
                return False
            host_names = {n.name for n in hosts}
            for n in cluster.nodes:
                if n.name not in host_names and \
                        n.handler.db_manager.get_db(db) is not None:
                    detail["garbage"] = n.name  # un-swept move replica
                    return False
            for n in hosts:
                app = apps[n.name]
                for key, val in acked:
                    if app.db.get(key) != val:
                        detail["lost"] = (n.name, key)
                        return False
        except StorageError as e:
            # a handle we resolved raced a reopen (repoint/rejoin
            # transition mid-sample): not healthy YET, re-sample
            detail["transition"] = repr(e)
            return False
        if not cluster.maps:
            detail["map"] = "never published"
            return False
        seg = cluster.maps[-1].get(cluster.segment) or {}
        for s in range(cluster.num_shards):
            mark = f"{s:05d}:M"
            leaders = sum(
                1 for host, entries in seg.items()
                if host != "num_shards" for e in entries if e == mark)
            if leaders != 1:
                detail["map"] = f"shard {s}: {leaders} leaders in map"
                return False
        dp_leaders = []
        for n in cluster.nodes:
            rdb = n.rdb(db)
            if (rdb is not None and rdb.role is ReplicaRole.LEADER
                    and not rdb.fenced and not rdb.removed):
                dp_leaders.append(n.name)
        if len(dp_leaders) != 1:
            detail["lineages"] = dp_leaders
            return False
        return True

    def stable_healthy():
        # a rejoining participant can look healthy for an instant while
        # its re-applied assignment is about to reopen a db — require
        # the state to hold across a short window
        if not healthy():
            return False
        time.sleep(0.35)
        return healthy()

    ok = cluster.wait(stable_healthy, timeout)
    passes = cluster.controller.passes - passes0
    if not ok:
        violations.append(
            f"{tag}: NO HEAL within {timeout}s / {passes} controller "
            f"passes — {detail}")
    elif passes > RESHARD_PASS_BOUND:
        violations.append(
            f"{tag}: healed but took {passes} controller passes "
            f"(bound {RESHARD_PASS_BOUND})")
    return passes


def run_reshard_chaos(
    root: str,
    schedules: int = 15,
    seed: int = 1,
    break_guard: Optional[str] = None,
    heal_timeout: float = 30.0,
    log=print,
    device=None,
) -> Dict:
    """Live shard moves under fault: seeded schedules kill the move
    coordinator at every step-machine seam, kill the source/target
    participants mid-move, tear the coordinator WAL during the flip,
    and expire sessions mid-catch-up — holding the SIXTH standing
    invariant after every schedule, with continuous write load riding
    through every move. The four nodes compact on ``device`` (None
    means ``cuda``; raises without CUDA) at the chaos scale
    (``_chaos_scale``)."""
    resolve_device(device)
    with _chaos_scale():
        return _run_reshard_deck(root, schedules, seed, break_guard,
                                 heal_timeout, log, device)


def _run_reshard_deck(root, schedules, seed, break_guard, heal_timeout,
                      log, device) -> Dict:
    saved_env = {
        k: os.environ.get(k)
        for k in ("RSTPU_RETRY_SEED", "RSTPU_PULL_RETRY_SEED")
    }
    os.environ["RSTPU_RETRY_SEED"] = str(seed)
    os.environ["RSTPU_PULL_RETRY_SEED"] = str(seed)
    undo = _break_guard(break_guard) if break_guard else None
    violations: List[str] = []
    acked: List[Tuple[bytes, bytes]] = []
    timings: Dict = {"move_ms": [], "move_outcomes": {},
                     "passes_used": [], "write_errors": 0,
                     "window_acked": 0,
                     "reads_checked": 0, "reads_served": 0,
                     "read_bounces": 0,
                     "fast_fail": bool(break_guard)}
    gauge_snapshots: List[Dict] = []
    fp.clear()
    t_setup = time.monotonic()
    cluster = FailoverCluster(root, num_nodes=4, device=device)
    deck: List[str] = []
    try:
        cluster.wait_initial_convergence()
        setup_sec = round(time.monotonic() - t_setup, 1)
        deck = _reshard_deck(random.Random(seed), schedules, break_guard)
        log(f"  cluster up in {setup_sec}s (4 nodes / 3 replicas); "
            f"deck: {deck}")
        for si, kind in enumerate(deck):
            rng = random.Random(seed * 1_000_003 + si)
            tag = f"s{si:02d}-{kind}/seed {seed}"
            try:
                _reshard_schedule(kind)(
                    cluster, rng, acked, violations, tag, timings)
            finally:
                fp.clear()
            if violations and break_guard:
                break  # teeth demonstrated — skip the 30 s heal wait
            timings["passes_used"].append(
                _check_reshard_invariants(cluster, acked, tag, violations,
                                          timeout=heal_timeout))
            _check_read_invariants(cluster, acked, tag, violations,
                                   timings)
            gauge_snapshots.append(_gauge_snapshot(tag))
            log(f"  [{si + 1}/{len(deck)}] {kind}: acked={len(acked)} "
                f"moves={timings['move_outcomes']} "
                f"violations={len(violations)}")
            if violations and break_guard:
                break
    finally:
        fp.clear()
        if undo:
            undo()
        cluster.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def _med(xs):
        return round(sorted(xs)[len(xs) // 2], 1) if xs else None

    return {
        "mode": "reshard",
        "schedules": len(deck),
        "deck": deck,
        "seed": seed,
        "acked": len(acked),
        "window_acked": timings["window_acked"],
        "write_errors": timings["write_errors"],
        "violations": violations,
        "move_outcomes": timings["move_outcomes"],
        "move_ms": timings["move_ms"],
        "move_ms_median": _med(timings["move_ms"]),
        "passes_used": timings["passes_used"],
        "reads_checked": timings["reads_checked"],
        "reads_served": timings["reads_served"],
        "read_bounces": timings["read_bounces"],
        "gauge_snapshots": gauge_snapshots,
        "failpoint_trips": fp.trip_counts(),
        "break_guard": break_guard,
    }


# ---------------------------------------------------------------------------
# the rebalance deck: the POLICY decides — the harness only
# drives skewed load and checks the aftermath
# ---------------------------------------------------------------------------

# 2 policy-initiated moves + 1 policy-initiated split per 3-schedule
# smoke: the harness never names a source/target/split key — it offers
# a hot shard and the rebalancer's sense→decide→plan→dispatch loop does
# the rest (the faulted variant blips every rebalancer seam —
# "rebalance.decide" / "rebalance.plan" / "rebalance.dispatch" — plus
# the dispatched move's catch-up, and the split schedule kills the
# splitter AT "split.cutover"; both must recover via resume)
_REBALANCE_KINDS = [
    "rebalance_move_hot", "rebalance_split_hot", "rebalance_move_faulted",
]


def _rebalance_flags(split: bool):
    """Chaos-sized policy knobs: fast EWMA, 2-tick sustain, thresholds
    scaled to a 2-shard fleet (with N=2 the reference hot_factor=2.0 is
    unreachable — hot > 2x mean needs hot > hot + cold)."""
    from rocksplicator_tpu_torch.cluster.rebalancer import RebalancerFlags

    return RebalancerFlags(
        interval=0.0, ewma_alpha=0.7, hot_factor=1.2, cool_factor=1.05,
        sustain=2, max_concurrent=1,
        split_factor=(1.5 if split else 100.0), min_rate=2.0)


class _SeqRateLoad:
    """db_name -> write rate measured from the data plane's OWN sequence
    numbers (per-db max across nodes, delta over wall time). The
    rebalancer's production load_fn scrapes /cluster_stats; the chaos
    cluster runs no status servers, so the harness feeds the policy the
    same signal from the source those rates are derived from — real
    load, never a synthesized number."""

    def __init__(self, cluster: FailoverCluster):
        self.cluster = cluster
        self._prev: Dict[str, Tuple[int, float]] = {}

    def __call__(self) -> Optional[Dict[str, float]]:
        from rocksplicator_tpu_torch.utils.segment_utils import \
            partition_name_to_db_name

        now = time.monotonic()
        dbs = set()
        for n in self.cluster.nodes:
            for partition, st in list(
                    n.participant.current_states.items()):
                if st in ("LEADER", "MASTER", "FOLLOWER", "SLAVE"):
                    dbs.add(partition_name_to_db_name(partition))
        rates: Dict[str, float] = {}
        for db in dbs:
            seqs = [s for s in self.cluster.seqs(db) if s is not None]
            if not seqs:
                continue
            seq = max(seqs)
            prev = self._prev.get(db)
            self._prev[db] = (seq, now)
            if prev is None:
                continue  # first sighting (fresh split child): no rate
            rates[db] = max(0.0, (seq - prev[0]) / max(1e-3,
                                                       now - prev[1]))
        for db in list(self._prev):
            if db not in dbs:
                del self._prev[db]  # renamed away mid-split / retired
        return rates or None


class _ShardWriter:
    """Write load aimed at ONE partition's current leader — the hot (or
    cold) side of the skew the policy observes. Acked (key, val) pairs
    land in a per-hash-shard ledger; after a split the checker resolves
    each key to its OWNING child by range, so the acked-readability
    probe follows the keys across the cutover."""

    def __init__(self, cluster: FailoverCluster, shard: int, tag: str,
                 interval: float, acked_by_shard: Dict[int, List],
                 prefix: bytes = b"k"):
        from rocksplicator_tpu_torch.utils.segment_utils import (
            db_name_to_partition_name, segment_to_db_name)

        self.cluster = cluster
        self.shard = shard
        self.db = segment_to_db_name(cluster.segment, shard)
        self.partition = db_name_to_partition_name(self.db)
        self.tag = tag
        self.interval = interval
        self.prefix = prefix
        self.errors = 0
        self._ledger = acked_by_shard.setdefault(shard, [])
        self._waiters: List = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"chaos-rebalance-writer-{shard}",
            daemon=True)
        self._thread.start()

    def _run(self) -> None:
        i = 0
        while not self._stop.wait(self.interval):
            i += 1
            key = self.prefix + (b"%s-%05d" % (self.tag.encode(), i))
            node = self.cluster.leader_node(self.partition)
            app = (node.handler.db_manager.get_db(self.db)
                   if node is not None else None)
            if app is None:
                self.errors += 1  # paused / renamed mid-split: expected
                continue
            try:
                w = app.write_async(WriteBatch().put(key, key))
            except Exception:
                self.errors += 1
                continue
            with self._lock:
                self._waiters.append((key, w))

    def stop_collect(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        with self._lock:
            waiters, self._waiters = self._waiters, []
        for key, w in waiters:
            try:
                w.future.result(3.0)
            except Exception:
                continue
            if w.acked:
                self._ledger.append((key, key))


def _split_leaves(cluster: FailoverCluster) -> List[int]:
    """The serving frontier: every hash slot chased through ACTIVE
    split records to its leaf children (the controller's
    effective_shards over the live ledger)."""
    from rocksplicator_tpu_torch.cluster.shard_split import list_splits

    by_parent = {
        r.parent_shard: r
        for r in list_splits(cluster.client, cluster.cluster)
        if r.segment == cluster.segment and r.phase == "active"}
    leaves: List[int] = []

    def chase(s: int) -> None:
        r = by_parent.get(s)
        if r is None:
            leaves.append(s)
        else:
            chase(r.low_shard)
            chase(r.high_shard)

    for s in range(cluster.num_shards):
        chase(s)
    return leaves


def _owning_leaf(cluster: FailoverCluster, shard: int, key: bytes) -> int:
    """Which leaf serves ``key`` under hash slot ``shard`` — the same
    transitive range chase the router runs."""
    from rocksplicator_tpu_torch.cluster.shard_split import list_splits

    by_parent = {
        r.parent_shard: r
        for r in list_splits(cluster.client, cluster.cluster)
        if r.segment == cluster.segment and r.phase == "active"}
    while shard in by_parent:
        r = by_parent[shard]
        shard = (r.low_shard if key < r.split_key_bytes
                 else r.high_shard)
    return shard


def _tick_rebalancer(reb, timings: Dict, tag: str,
                     violations: List[str], want_kind: str,
                     timeout: float = 30.0) -> List[dict]:
    """Drive sense→decide→plan→dispatch ticks until a plan of
    ``want_kind`` dispatches. Armed rebalancer seams raise out of a
    tick; the next tick re-derives everything from the durable ledgers
    (exactly what run_forever's catch-all rides on)."""
    dispatched: List[dict] = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            dispatched += reb.once()
        except Exception:
            timings["tick_errors"] += 1
        if any(p["kind"] == want_kind for p in dispatched):
            return dispatched
        time.sleep(0.3)
    violations.append(
        f"{tag}: rebalancer never dispatched a {want_kind} "
        f"(policy {reb.policy.snapshot()}, dispatched {dispatched})")
    return dispatched


def _join_rebalance_workers(reb, tag: str, violations: List[str],
                            timeout: float = 90.0) -> None:
    deadline = time.monotonic() + timeout
    for t in list(reb._workers):
        t.join(max(0.1, deadline - time.monotonic()))
        if t.is_alive():
            violations.append(f"{tag}: actuator {t.name} wedged "
                              f"(no exit in {timeout}s)")


def _rebalance_schedule(kind: str):
    def run(cluster: FailoverCluster, rng: random.Random,
            acked_by_shard: Dict[int, List], violations: List[str],
            tag: str, timings: Dict) -> None:
        from rocksplicator_tpu_torch.cluster.model import cluster_path
        from rocksplicator_tpu_torch.cluster.rebalancer import Rebalancer
        from rocksplicator_tpu_torch.cluster.shard_move import MoveRecord, \
            ShardMove
        from rocksplicator_tpu_torch.cluster.shard_split import ShardSplit
        from rocksplicator_tpu_torch.utils.segment_utils import (
            db_name_to_partition_name, segment_to_db_name)

        want_split = kind == "rebalance_split_hot"
        _wait_settled(cluster)
        leaves = _split_leaves(cluster)
        hot, cold = leaves[0], leaves[1:]
        hot_db = segment_to_db_name(cluster.segment, hot)
        hot_partition = db_name_to_partition_name(hot_db)
        if want_split:
            # enough keys on BOTH sides of the eventual median that
            # choose_split_key has a real keyspace to bisect and both
            # children inherit acked history to be checked against
            pre = acked_by_shard.setdefault(hot, [])
            node = cluster.leader_node(hot_partition)
            app = (node.handler.db_manager.get_db(hot_db)
                   if node is not None else None)
            if app is None:
                violations.append(f"{tag}: no leader to preload")
                return
            waiters = []
            for i in range(120):
                for prefix in (b"a", b"z"):
                    key = prefix + (b"%05d" % i)
                    try:
                        waiters.append((key, app.write_async(
                            WriteBatch().put(key, key))))
                    except Exception:
                        # the leader's DB closed under the preload (a
                        # leadership change): not acked, as write_some
                        # counts a raise (F22)
                        continue
            for key, w in waiters:
                try:
                    w.future.result(5.0)
                except Exception:
                    continue
                if w.acked:
                    pre.append((key, key))
        reb = Rebalancer(
            cluster.client, cluster.cluster, cluster.store_uri,
            flags=_rebalance_flags(split=want_split),
            move_flags=_move_flags(), admin=cluster.admin,
            load_fn=_SeqRateLoad(cluster))
        # the durable pause flag gates the tick before any sensing
        Rebalancer.set_paused(cluster.client, cluster.cluster, True)
        if not reb.paused:
            violations.append(f"{tag}: durable pause flag not visible")
        Rebalancer.set_paused(cluster.client, cluster.cluster, False)
        if kind == "rebalance_move_faulted":
            # every rebalancer seam blipped once + the dispatched
            # move killed mid-catch-up: the loop must ride the seam
            # faults and the harness must RESUME the crashed move
            fp.activate("rebalance.decide", "fail_nth:2")
            fp.activate("rebalance.plan", "fail_nth:1")
            fp.activate("rebalance.dispatch", "fail_nth:1")
            fp.activate("move.catchup", "fail_nth:1")
        elif want_split and not timings.get("fast_fail"):
            # kill the splitter AT the fenced flip: the durable record
            # holds phase=cutover; resume finishes it idempotently
            fp.activate("split.cutover", "fail_nth:1")
        # the skew: one shard driven hard, the rest trickling — fleet
        # mean stays low, the hot EWMA must clear the enter band for
        # `sustain` consecutive ticks before the policy may act
        writers = [_ShardWriter(cluster, hot, tag, interval=0.004,
                                acked_by_shard=acked_by_shard,
                                prefix=b"zz")]
        writers += [_ShardWriter(cluster, s, tag, interval=0.25,
                                 acked_by_shard=acked_by_shard)
                    for s in cold[:2]]
        t0 = time.monotonic()
        try:
            plans = _tick_rebalancer(
                reb, timings, tag, violations,
                want_kind="split" if want_split else "move")
            _join_rebalance_workers(reb, tag, violations)
            for p in plans:
                timings["dispatched"][p["kind"]] = \
                    timings["dispatched"].get(p["kind"], 0) + 1
            fp.clear()
            # a crashed actuator left its durable record mid-phase:
            # finish the job the way an operator (or the next tick's
            # budget accounting + resume tooling) would
            if kind == "rebalance_move_faulted":
                raw = cluster.client.get_or_none(cluster_path(
                    cluster.cluster, "moves", hot_partition))
                if raw is not None:
                    rec = MoveRecord.decode(raw)
                    try:
                        ShardMove.resume(
                            cluster.client, cluster.cluster,
                            hot_partition, admin=cluster.admin,
                            flags=_move_flags()).run()
                        timings["resumes"] += 1
                    except Exception as e:
                        violations.append(
                            f"{tag}: RESUME FAILED from phase "
                            f"{rec.phase}: {e!r}")
            elif want_split:
                from rocksplicator_tpu_torch.cluster.model import SplitRecord

                raw = cluster.client.get_or_none(cluster_path(
                    cluster.cluster, "splits", hot_partition))
                rec = SplitRecord.decode(raw) if raw is not None else None
                if rec is not None and rec.phase != "active":
                    try:
                        ShardSplit.resume(
                            cluster.client, cluster.cluster,
                            hot_partition, admin=cluster.admin,
                            flags=_move_flags()).run()
                        timings["resumes"] += 1
                    except Exception as e:
                        violations.append(
                            f"{tag}: SPLIT RESUME FAILED from phase "
                            f"{rec.phase}: {e!r}")
                elif rec is None:
                    violations.append(
                        f"{tag}: split dispatched but no record left")
        finally:
            fp.clear()
            for w in writers:
                w.stop_collect()
                timings["write_errors"] += w.errors
            reb.stop(timeout=5.0)
        timings["schedule_ms"].append(
            round((time.monotonic() - t0) * 1000.0, 1))

    return run


def _check_rebalance_invariants(cluster: FailoverCluster,
                                acked_by_shard: Dict[int, List],
                                tag: str, violations: List[str],
                                timeout: float = 45.0) -> int:
    """The SEVENTH standing invariant, after EVERY rebalance schedule:
    every leaf partition of the split forest converges (one leader +
    full replica set at equal seqs; the shard map and the data plane
    agree on exactly one unfenced leader each), NO node holds a db
    outside the leaf set (the split-retired parent must be gone
    everywhere), active splits are published in the map's __splits__
    section, every acked write is readable on every current host of
    the child that OWNS its key range, and the heal stays inside the
    controller-pass bound."""
    from rocksplicator_tpu_torch.cluster.shard_split import list_splits
    from rocksplicator_tpu_torch.utils.segment_utils import (
        db_name_to_partition_name, segment_to_db_name)

    passes0 = cluster.controller.passes
    detail: Dict = {}

    def leaf_view():
        leaves = _split_leaves(cluster)
        return leaves, {
            s: (segment_to_db_name(cluster.segment, s),
                db_name_to_partition_name(
                    segment_to_db_name(cluster.segment, s)))
            for s in leaves}

    def healthy():
        from rocksplicator_tpu_torch.storage.errors import StorageError

        leaves, names = leaf_view()
        expected_dbs = {db for db, _p in names.values()}
        splits = list_splits(cluster.client, cluster.cluster)
        try:
            for s in leaves:
                db, partition = names[s]
                hosts = [n for n in cluster.nodes
                         if n.state_of(partition)]
                states = sorted(n.state_of(partition) for n in hosts)
                if states != ["FOLLOWER", "FOLLOWER", "LEADER"]:
                    detail[partition] = cluster.states(partition)
                    return False
                seqs = []
                for n in hosts:
                    app = n.handler.db_manager.get_db(db)
                    if app is None:
                        detail[partition] = (n.name, "db closed")
                        return False
                    seqs.append(app.db.latest_sequence_number_relaxed())
                if len(set(seqs)) != 1:
                    detail[partition] = ("seqs", seqs)
                    return False
                host_names = {n.name for n in hosts}
                for n in cluster.nodes:
                    if n.name not in host_names and \
                            n.handler.db_manager.get_db(db) is not None:
                        detail[partition] = ("garbage", n.name)
                        return False
                dp_leaders = [
                    n.name for n in cluster.nodes
                    if (lambda rdb: rdb is not None
                        and rdb.role is ReplicaRole.LEADER
                        and not rdb.fenced
                        and not rdb.removed)(n.rdb(db))]
                if len(dp_leaders) != 1:
                    detail[partition] = ("lineages", dp_leaders)
                    return False
            # the split-retired parent is gone EVERYWHERE: its lineage
            # was closed to writers by the leader rename at cutover and
            # every replica was renamed into a child — a parent-named
            # db still open anywhere is a stranded pre-split lineage a
            # router retry could read stale data from
            for r in splits:
                if r.phase != "active":
                    continue
                parent_db = segment_to_db_name(cluster.segment,
                                               r.parent_shard)
                if parent_db in expected_dbs:
                    continue  # re-split child reusing a leaf id
                for n in cluster.nodes:
                    if n.handler.db_manager.get_db(parent_db) \
                            is not None:
                        detail["parent"] = (parent_db, n.name)
                        return False
        except StorageError as e:
            detail["transition"] = repr(e)
            return False
        if not cluster.maps:
            detail["map"] = "never published"
            return False
        seg = cluster.maps[-1].get(cluster.segment) or {}
        active = [r for r in splits if r.phase == "active"]
        published = seg.get("__splits__") or {}
        for r in active:
            if str(r.parent_shard) not in published:
                detail["map"] = f"split of {r.parent_shard} unpublished"
                return False
        for s in leaves:
            mark = f"{s:05d}:M"
            n_leaders = sum(
                1 for host, entries in seg.items()
                if host not in ("num_shards", "__splits__")
                for e in entries if e == mark)
            if n_leaders != 1:
                detail["map"] = f"shard {s}: {n_leaders} leaders in map"
                return False
        return True

    def stable_healthy():
        if not healthy():
            return False
        time.sleep(0.35)
        return healthy()

    ok = cluster.wait(stable_healthy, timeout)
    passes = cluster.controller.passes - passes0
    if not ok:
        violations.append(
            f"{tag}: NO HEAL within {timeout}s / {passes} controller "
            f"passes — {detail}")
        # fall through to the acked probe anyway: when the cluster is
        # wedged BECAUSE data went missing (the split_cutover tooth),
        # the loss itself is the diagnosis, not the non-convergence
    elif passes > RESHARD_PASS_BOUND:
        violations.append(
            f"{tag}: healed but took {passes} controller passes "
            f"(bound {RESHARD_PASS_BOUND})")
    # the sharp probe, strict and waitless once converged: every acked
    # key readable on every current host of the child OWNING its range
    # — what the split_cutover tooth (rename without pause/drain) loses
    _leaves, names = leaf_view()
    for shard, ledger in sorted(acked_by_shard.items()):
        for key, val in ledger:
            leaf = _owning_leaf(cluster, shard, key)
            db, partition = names.get(leaf, (None, None))
            if db is None:
                violations.append(
                    f"{tag}: acked key {key!r} resolves to unserved "
                    f"leaf {leaf}")
                return passes
            for n in cluster.nodes:
                if not n.state_of(partition):
                    continue
                if not ok and n.state_of(partition) not in _LEADERLIKE:
                    # unconverged cluster: a follower mid-rebuild is
                    # legitimately incomplete — only the child LEADER's
                    # copy is the can-never-heal truth
                    continue
                app = n.handler.db_manager.get_db(db)
                if app is None or app.db.get(key) != val:
                    violations.append(
                        f"{tag}: ACKED WRITE {key!r} MISSING ON CHILD "
                        f"{db} host {n.name} (lost across the split "
                        f"cutover)")
                    return passes
    return passes


def _rebalance_deck(rng: random.Random, schedules: int,
                    break_guard: Optional[str]) -> List[str]:
    """move, split, faulted-move in order (the smoke's 2 moves + 1
    split); the split_cutover tooth leads with the split it breaks."""
    if break_guard == "split_cutover":
        deck = ["rebalance_split_hot"]
    else:
        deck = []
    core = list(_REBALANCE_KINDS)
    while len(deck) < schedules:
        deck.extend(core)
    return deck[:schedules]


def run_rebalance_chaos(
    root: str,
    schedules: int = 3,
    seed: int = 1,
    break_guard: Optional[str] = None,
    heal_timeout: float = 45.0,
    log=print,
    device=None,
) -> Dict:
    """Autonomous-rebalancer schedules: the harness drives SKEWED load
    at a 4-node / 2-hash-shard cluster and the policy loop must sense
    the sustained hot spot, plan, and dispatch the move — or, past the
    split threshold, the range split — on its own. Seam faults
    ("rebalance.decide/plan/dispatch", "split.cutover",
    move.catchup) kill the loop and its actuators mid-flight; durable
    ledgers + resume must finish every job. After every schedule the
    SEVENTH standing invariant is checked. The four nodes compact on
    ``device`` (None means ``cuda``; raises without CUDA) at the chaos
    scale (``_chaos_scale``)."""
    resolve_device(device)
    with _chaos_scale():
        return _run_rebalance_deck(root, schedules, seed, break_guard,
                                   heal_timeout, log, device)


def _run_rebalance_deck(root, schedules, seed, break_guard, heal_timeout,
                        log, device) -> Dict:
    saved_env = {
        k: os.environ.get(k)
        for k in ("RSTPU_RETRY_SEED", "RSTPU_PULL_RETRY_SEED")
    }
    os.environ["RSTPU_RETRY_SEED"] = str(seed)
    os.environ["RSTPU_PULL_RETRY_SEED"] = str(seed)
    undo = _break_guard(break_guard) if break_guard else None
    violations: List[str] = []
    acked_by_shard: Dict[int, List[Tuple[bytes, bytes]]] = {}
    timings: Dict = {"schedule_ms": [], "dispatched": {}, "resumes": 0,
                     "tick_errors": 0, "write_errors": 0,
                     "passes_used": [],
                     "fast_fail": bool(break_guard)}
    gauge_snapshots: List[Dict] = []
    fp.clear()
    t_setup = time.monotonic()
    cluster = FailoverCluster(root, num_nodes=4, num_shards=2,
                              device=device)
    deck: List[str] = []
    try:
        cluster.wait_initial_convergence()
        setup_sec = round(time.monotonic() - t_setup, 1)
        deck = _rebalance_deck(random.Random(seed), schedules,
                               break_guard)
        log(f"  cluster up in {setup_sec}s (4 nodes / 2 hash shards); "
            f"deck: {deck}")
        for si, kind in enumerate(deck):
            rng = random.Random(seed * 1_000_003 + si)
            tag = f"s{si:02d}-{kind}/seed {seed}"
            try:
                _rebalance_schedule(kind)(
                    cluster, rng, acked_by_shard, violations, tag,
                    timings)
            finally:
                fp.clear()
            if violations and break_guard:
                break
            timings["passes_used"].append(
                _check_rebalance_invariants(
                    cluster, acked_by_shard, tag, violations,
                    timeout=heal_timeout))
            gauge_snapshots.append(_gauge_snapshot(tag))
            acked = sum(len(v) for v in acked_by_shard.values())
            log(f"  [{si + 1}/{len(deck)}] {kind}: acked={acked} "
                f"dispatched={timings['dispatched']} "
                f"resumes={timings['resumes']} "
                f"violations={len(violations)}")
            if violations and break_guard:
                break
    finally:
        fp.clear()
        if undo:
            undo()
        cluster.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {
        "mode": "rebalance",
        "schedules": len(deck),
        "deck": deck,
        "seed": seed,
        "acked": sum(len(v) for v in acked_by_shard.values()),
        "write_errors": timings["write_errors"],
        "violations": violations,
        "dispatched": timings["dispatched"],
        "resumes": timings["resumes"],
        "tick_errors": timings["tick_errors"],
        "schedule_ms": timings["schedule_ms"],
        "passes_used": timings["passes_used"],
        "gauge_snapshots": gauge_snapshots,
        "failpoint_trips": fp.trip_counts(),
        "break_guard": break_guard,
    }


# ---------------------------------------------------------------------------
# the CDC deck (cdc_burst): the exactly-once consumer under kills
# ---------------------------------------------------------------------------

CDC_TOPIC = "cdc_events"

# the deck rotates one scenario per schedule; kills land at every
# consumer seam mid-batch, plus a multi-kill burst and a leader
# failover mid-consume. Order matters for the tooth: schedule 0 is the
# checkpoint seam, where the cdc_dedup break-guard must be caught.
_CDC_DECK = [
    "seam:kafka.checkpoint",
    "seam:kafka.apply",
    "seam:kafka.fetch",
    "burst",
    "leader_failover",
]


class _CdcApplyTarget:
    """ApplicationDB-shaped shim over a ReplicatedDB: ``.db`` exposes
    the local engine (watermark reads, pacing gauges), ``write_many``
    routes each batch through semi-sync replication — the watermark PUT
    replicates with the records it covers, and fencing surfaces as a
    write error exactly as on the serving stack."""

    def __init__(self, engine: DB, rdb):
        self.db = engine
        self._rdb = rdb

    def write_many(self, batches):
        for b in batches:
            self._rdb.write(b)


def _cdc_deck_msgs(n: int) -> Tuple[List[Tuple[bytes, bytes]], Dict]:
    """Deterministic produce history with overwrites and deletes: the
    expected final state is the FOLD of the log, so a dropped or
    doubled delete would surface even without the applies witness."""
    msgs: List[Tuple[bytes, bytes]] = []
    expect: Dict[bytes, bytes] = {}
    for i in range(n):
        key = b"c%03d" % (i % 120)
        value = b"" if (i % 29 == 7) else b"v%d" % i
        msgs.append((key, value))
        if value:
            expect[key] = value
        else:
            expect.pop(key, None)
    return msgs, expect


def _cdc_produce_bg(kafka, msgs, base_ts: int, pace_sec: float):
    done = threading.Event()

    def run():
        for i, (k, v) in enumerate(msgs):
            kafka.produce(CDC_TOPIC, 0, k, v, timestamp_ms=base_ts + i)
            if pace_sec:
                time.sleep(pace_sec)
        done.set()

    t = threading.Thread(target=run, name="cdc-producer", daemon=True)
    t.start()
    return t, done


def _check_cdc_invariant(tag: str, kafka, engines: List[DB], expect,
                         violations: List[str]) -> None:
    """Invariant 8: applied records == produced prefix, EXACTLY once,
    per partition — on every replica of the serving lineage. The
    watermark names the prefix; the applies counter is the duplicate
    witness (idempotent upserts make state-compare blind to re-applies,
    the counter is not); the fold check catches drops."""
    from rocksplicator_tpu_torch.kafka.checkpoint import (read_applies,
                                                          read_watermark)

    produced = kafka.high_watermark(CDC_TOPIC, 0)
    for i, engine in enumerate(engines):
        wm = read_watermark(engine, CDC_TOPIC, 0)
        off = None if wm is None else wm["offset"]
        if off != produced:
            violations.append(
                f"{tag}: replica {i}: watermark {off} != produced "
                f"{produced} — the applied prefix is not the produced "
                f"prefix")
            continue
        applies = read_applies(engine, CDC_TOPIC, 0)
        if applies != produced:
            violations.append(
                f"{tag}: replica {i}: applies_total {applies} != "
                f"produced {produced} — records were NOT applied "
                f"exactly once (duplicate applies survive state-compare; "
                f"the counter witness does not)")
        for k, v in expect.items():
            got = engine.get(k)
            if got != v:
                violations.append(
                    f"{tag}: replica {i}: fold mismatch at {k!r}: "
                    f"read {got!r}, want {v!r}")
                break


def _run_cdc_schedule(root: str, si: int, rng: random.Random,
                      scenario: str, violations: List[str],
                      counters: Dict, heal_timeout: float,
                      device=None) -> None:
    from rocksplicator_tpu_torch.kafka.broker import (MockConsumer,
                                                      MockKafkaCluster)
    from rocksplicator_tpu_torch.kafka.ingestion import IngestionWatcher

    kafka = MockKafkaCluster()
    kafka.create_topic(CDC_TOPIC, 1)
    n = rng.randint(150, 300)
    msgs, expect = _cdc_deck_msgs(n)
    counters["produced"] += n
    cluster = ChaosCluster(os.path.join(root, f"cdc{si}"), device=device)
    tag = f"cdc schedule {si} [{scenario}]"
    watchers = []

    def start_watcher(node_idx: int, rdb) -> "IngestionWatcher":
        w = IngestionWatcher(
            None, DB_NAME,
            _CdcApplyTarget(cluster.dbs[node_idx], rdb),
            MockConsumer(kafka), CDC_TOPIC, [0], 0)
        w.start()
        watchers.append(w)
        counters["consumer_starts"] += 1
        return w

    def wait(pred, timeout=20.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.02)
        return pred()

    try:
        if not cluster.wait_converged(20.0):
            raise RuntimeError(f"{tag}: cluster never converged at start")
        producer, prod_done = _cdc_produce_bg(
            kafka, msgs, base_ts=1_000 + si, pace_sec=0.002)
        engines: List[DB] = list(cluster.dbs)
        if scenario.startswith("seam:"):
            site = scenario[len("seam:"):]
            fp.activate(site, f"fail_nth:{rng.randint(2, 6)}")
            w = start_watcher(0, cluster.leader)
            died = wait(lambda: w.error is not None
                        or (prod_done.is_set() and w.watermark(0) == n))
            fp.deactivate(site)
            if w.error is not None:
                counters["kills"] += 1
            elif not died:
                violations.append(
                    f"{tag}: consumer neither died nor finished")
            w.stop()
            w2 = start_watcher(0, cluster.leader)
            if not wait(lambda: w2.watermark(0) == n):
                violations.append(
                    f"{tag}: resumed consumer stalled at watermark "
                    f"{w2.watermark(0)}/{n} (error {w2.error!r})")
            w2.stop()
        elif scenario == "burst":
            # kill/restart at a random seam, repeatedly, racing the
            # producer — then one clean pass to quiesce
            for _cycle in range(3):
                site = rng.choice(["kafka.fetch", "kafka.apply",
                                   "kafka.checkpoint"])
                fp.activate(site, f"fail_nth:{rng.randint(1, 4)}")
                w = start_watcher(0, cluster.leader)
                if wait(lambda: w.error is not None
                        or (prod_done.is_set()
                            and w.watermark(0) == n), timeout=10.0) \
                        and w.error is not None:
                    counters["kills"] += 1
                fp.deactivate(site)
                w.stop()
            w = start_watcher(0, cluster.leader)
            if not wait(lambda: w.watermark(0) == n):
                violations.append(
                    f"{tag}: post-burst consumer stalled at "
                    f"{w.watermark(0)}/{n} (error {w.error!r})")
            w.stop()
        elif scenario == "leader_failover":
            old_leader = cluster.leader
            w = start_watcher(0, old_leader)
            wait(lambda: w.watermark(0) >= n // 3)
            # the controller's promotion at the data plane: follower 1
            # takes epoch 2; follower 2's next pull (still aimed at the
            # old leader) fences the deposed lineage — the consumer's
            # next replicated write dies loudly
            cluster.hosts[1].remove_db(DB_NAME)
            new_leader = cluster.hosts[1].add_db(
                DB_NAME, StorageDbWrapper(cluster.dbs[1]),
                ReplicaRole.LEADER, replication_mode=1, epoch=2)
            cluster.rdbs[1] = new_leader
            cluster.rdbs[2].adopt_epoch(2)
            if not wait(lambda: old_leader.fenced, timeout=10.0):
                violations.append(f"{tag}: deposed leader never fenced")
            if not wait(lambda: w.error is not None, timeout=15.0):
                violations.append(
                    f"{tag}: consumer survived its leader's deposition")
            counters["kills"] += 1
            w.stop()
            cluster.rdbs[2].reset_upstream(
                ("127.0.0.1", cluster.hosts[1].port))
            prod_done.wait(20.0)
            # resume against the promoted follower: its own replicated
            # watermark names the resume point
            w2 = start_watcher(1, new_leader)
            if not wait(lambda: w2.watermark(0) == n):
                violations.append(
                    f"{tag}: post-failover consumer stalled at "
                    f"{w2.watermark(0)}/{n} (error {w2.error!r})")
            w2.stop()
            engines = [cluster.dbs[1], cluster.dbs[2]]
        else:
            raise ValueError(f"unknown cdc scenario: {scenario}")
        producer.join(20.0)
        # quiesce: the serving lineage reconverges, then invariant 8
        # holds on EVERY replica of it (watermark + counter rode the
        # replicated batches)
        lead = engines[0]
        if not wait(lambda: all(
                e.latest_sequence_number_relaxed()
                == lead.latest_sequence_number_relaxed()
                for e in engines), timeout=heal_timeout):
            violations.append(
                f"{tag}: lineage did not reconverge in {heal_timeout}s")
        _check_cdc_invariant(tag, kafka, engines, expect, violations)
    finally:
        fp.clear()
        for w in watchers:
            try:
                w.stop()
            except Exception:
                pass
        cluster.stop()


def run_cdc_chaos(
    root: str,
    schedules: int = 5,
    seed: int = 1,
    break_guard: Optional[str] = None,
    heal_timeout: float = 15.0,
    log=print,
    device=None,
) -> Dict:
    """The ``cdc_burst`` chaos mode: kill/restart the CDC consumer at
    every seam mid-batch (plus a multi-kill burst and a leader failover
    mid-consume), asserting invariant 8 after every schedule. The
    three-replica group compacts on ``device`` (None means ``cuda``;
    raises without CUDA) at the chaos scale (``_chaos_scale``)."""
    resolve_device(device)
    with _chaos_scale():
        return _run_cdc_deck(root, schedules, seed, break_guard,
                             heal_timeout, log, device)


def _run_cdc_deck(root, schedules, seed, break_guard, heal_timeout, log,
                  device) -> Dict:
    from rocksplicator_tpu_torch.kafka import ingestion as ingestion_mod

    saved_shape = (ingestion_mod.MAX_DRAIN, ingestion_mod.BATCH_RECORDS,
                   ingestion_mod.POLL_SEC)
    # chaos scale: small drains/batches so every schedule crosses many
    # batch boundaries (a kill always has partial progress to tear)
    ingestion_mod.MAX_DRAIN = 48
    ingestion_mod.BATCH_RECORDS = 16
    ingestion_mod.POLL_SEC = 0.05
    undo = _break_guard(break_guard) if break_guard else None
    violations: List[str] = []
    counters: Dict = {"kills": 0, "consumer_starts": 0, "produced": 0}
    scenarios: List[str] = []
    fp.clear()
    try:
        for si in range(schedules):
            rng = random.Random(seed * 1_000_003 + si)
            scenario = _CDC_DECK[si % len(_CDC_DECK)]
            scenarios.append(scenario)
            _run_cdc_schedule(root, si, rng, scenario, violations,
                              counters, heal_timeout, device=device)
            log(f"  [{si + 1}/{schedules}] {scenario} "
                f"kills={counters['kills']} "
                f"starts={counters['consumer_starts']} "
                f"violations={len(violations)}")
            if violations and break_guard:
                break
    finally:
        fp.clear()
        if undo:
            undo()
        (ingestion_mod.MAX_DRAIN, ingestion_mod.BATCH_RECORDS,
         ingestion_mod.POLL_SEC) = saved_shape
    return {
        "schedules": schedules,
        "seed": seed,
        "scenarios": scenarios,
        "produced": counters["produced"],
        "kills": counters["kills"],
        "consumer_starts": counters["consumer_starts"],
        "violations": violations,
        "failpoint_trips": fp.trip_counts(),
        "break_guard": break_guard,
    }


# ---------------------------------------------------------------------------
# the data-plane deck's driver
# ---------------------------------------------------------------------------


def run_chaos(
    root: str,
    schedules: int = 20,
    seed: int = 1,
    writes: int = 80,
    ingest_every: int = 4,
    remote_every: int = 3,
    break_guard: Optional[str] = None,
    conv_timeout: float = 30.0,
    transport: Optional[str] = None,
    log=print,
    device=None,
) -> Dict:
    """The data-plane deck: seeded fault schedules against
    ``ChaosCluster`` with periodic SST ingests (``IngestFixture``) and
    remote-compaction scenarios (``RemoteCompactionFixture``), holding
    invariants 1-3 after every schedule. Every DB, the ingest handler
    and the remote worker compact on ``device`` (None means ``cuda``;
    raises without CUDA) at the chaos scale (``_chaos_scale``, restored
    on return or raise)."""
    resolve_device(device)
    with _chaos_scale():
        return _run_data_plane(root, schedules, seed, writes, ingest_every,
                               remote_every, break_guard, conv_timeout,
                               transport, log, device)


def _run_data_plane(root, schedules, seed, writes, ingest_every,
                    remote_every, break_guard, conv_timeout, transport,
                    log, device) -> Dict:
    saved_env = {
        k: os.environ.get(k)
        for k in ("RSTPU_RETRY_SEED", "RSTPU_PULL_RETRY_SEED",
                  "RSTPU_TRANSPORT")
    }
    os.environ["RSTPU_RETRY_SEED"] = str(seed)
    os.environ["RSTPU_PULL_RETRY_SEED"] = str(seed)
    if transport:
        # the same seeded schedules must hold the same invariants on
        # every byte layer: the policy reroutes the cluster's RPC plane
        # (leader/followers are colocated in-process, so even loopback
        # applies) while the fault sites arm identically
        os.environ["RSTPU_TRANSPORT"] = transport
    undo = _break_guard(break_guard) if break_guard else None
    violations: List[str] = []
    gauge_snapshots: List[Dict] = []
    acked_total = 0
    write_total = 0
    fp.clear()
    cluster = ingest = remote = None
    try:
        cluster = ChaosCluster(root, device=device)
        ingest = IngestFixture(root, cluster.hosts[0], device=device)
        remote = (RemoteCompactionFixture(root, device=device)
                  if remote_every else None)
        if not cluster.wait_converged(20.0):
            raise RuntimeError("cluster never converged at start")
        for si in range(schedules):
            rng = random.Random(seed * 1_000_003 + si)
            faults = rng.sample(_fault_menu(rng), k=rng.randint(1, 3))
            tag = f"schedule {si}/seed {seed}"
            for site, spec in faults:
                fp.activate(site, spec)
            # -- workload under fault -------------------------------------
            waiters = []
            n_writes = rng.randint(writes // 2, writes)
            write_errors = 0
            for i in range(n_writes):
                key = b"s%03dk%04d" % (si, i)
                val = b"s%03dv%04d" % (si, i)
                try:
                    waiters.append(
                        (key, val,
                         cluster.leader.write_async(
                             WriteBatch().put(key, val))))
                except Exception:
                    write_errors += 1  # injected fault; write not acked
            # sibling-shard load: smaller but concurrent, so with mux on
            # the session interleaves both shards' backlogs in one
            # response stream under the same armed faults
            waiters2 = []
            n_writes2 = rng.randint(6, 14)
            for i in range(n_writes2):
                key = b"x%03dk%04d" % (si, i)
                val = b"x%03dv%04d" % (si, i)
                try:
                    waiters2.append(
                        (key, val,
                         cluster.leader2.write_async(
                             WriteBatch().put(key, val))))
                except Exception:
                    write_errors += 1
            write_total += n_writes + n_writes2
            acked: List[Tuple[bytes, bytes]] = []
            for key, val, w in waiters:
                try:
                    w.future.result(5.0)
                except Exception:
                    continue
                if w.acked:
                    acked.append((key, val))
            acked2: List[Tuple[bytes, bytes]] = []
            for key, val, w in waiters2:
                try:
                    w.future.result(5.0)
                except Exception:
                    continue
                if w.acked:
                    acked2.append((key, val))
            acked_total += len(acked) + len(acked2)
            # -- heal + verify --------------------------------------------
            for site, _spec in faults:
                fp.deactivate(site)
            if not cluster.wait_converged(conv_timeout):
                lat = [db.latest_sequence_number_relaxed()
                       for db in cluster.dbs]
                violations.append(
                    f"{tag}: no reconvergence {conv_timeout}s after "
                    f"faults cleared (seqs {lat}, faults {faults})")
            for i, db in enumerate(cluster.dbs + cluster.dbs2):
                msg = check_wal_contiguous(db)
                if msg:
                    violations.append(
                        f"{tag}: node {i % 3} "
                        f"({DB_NAME if i < 3 else DB2_NAME}): {msg} "
                        f"(faults {faults})")
            lost = []
            for key, val in acked:
                for i, db in enumerate(cluster.dbs):
                    if db.get(key) != val:
                        lost.append((i, key))
            for key, val in acked2:
                for i, db in enumerate(cluster.dbs2):
                    if db.get(key) != val:
                        lost.append((i, key))
            if lost:
                violations.append(
                    f"{tag}: {len(lost)} acked writes missing after "
                    f"reconvergence, first {lost[0]} (faults {faults})")
            if ingest_every and si % ingest_every == ingest_every - 1:
                ingest.step(rng, violations, tag)
            if remote is not None and si % remote_every == 0:
                # disaggregated compaction tier: rotating
                # seam/worker-kill/leader-kill scenario + the standing
                # deposed-install probe — runs on si=0 so a broken
                # remote_install guard is caught on the first schedule
                remote.step(rng, violations, tag)
            gauge_snapshots.append(_gauge_snapshot(tag))
            log(f"  [{si + 1}/{schedules}] faults={faults} "
                f"writes={n_writes + n_writes2} "
                f"acked={len(acked) + len(acked2)} "
                f"errors={write_errors} "
                f"violations={len(violations)}")
            if violations and break_guard:
                break  # teeth demonstrated; no need to keep going
    finally:
        fp.clear()
        if undo:
            undo()
        if ingest is not None:
            ingest.close()
        if remote is not None:
            remote.close()
        if cluster is not None:
            cluster.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {
        "schedules": schedules,
        "seed": seed,
        "transport": transport or os.environ.get("RSTPU_TRANSPORT", "tcp")
        or "tcp",
        "writes": write_total,
        "acked": acked_total,
        "violations": violations,
        "gauge_snapshots": gauge_snapshots,
        "failpoint_trips": fp.trip_counts(),
        "break_guard": break_guard,
        "remote_outcomes": dict(remote.outcomes) if remote else {},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schedules", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--writes", type=int, default=80,
                    help="max writes per schedule")
    ap.add_argument("--ingest-every", type=int, default=4)
    ap.add_argument("--remote-every", type=int, default=3,
                    help="run a disaggregated-compaction scenario every "
                         "N schedules (0 disables; data-plane mode "
                         "only): seam faults, worker kill mid-job, "
                         "leader kill mid-job, plus the standing "
                         "deposed-install fence probe")
    ap.add_argument("--failover", action="store_true",
                    help="coordinator-backed control-plane schedules "
                         "(Controller + Spectator + 3 participants): "
                         "leader crash with a full AckWindow, session "
                         "expiry, coordinator kill/WAL torn — holding "
                         "the fourth standing invariant")
    ap.add_argument("--reshard", action="store_true",
                    help="live-shard-move schedules (4 nodes / 3 "
                         "replicas): the move coordinator killed at "
                         "every step-machine seam, source/target kills "
                         "mid-move, torn coordinator WAL during the "
                         "flip, session expiry mid-catch-up — holding "
                         "the SIXTH standing invariant (exactly one "
                         "serving lineage, zero acked-write loss across "
                         "the move, bounded convergence)")
    ap.add_argument("--rebalance", action="store_true",
                    help="autonomous-rebalancer schedules (4 nodes / 2 "
                         "hash shards): skewed load only — the policy "
                         "loop itself must sense the sustained hot "
                         "shard and dispatch the move (or, past the "
                         "split threshold, the RANGE SPLIT), riding "
                         "decide/plan/dispatch seam faults and a "
                         "splitter killed AT the fenced cutover — "
                         "holding the SEVENTH standing invariant")
    ap.add_argument("--cdc", action="store_true",
                    help="CDC streaming-ingest schedules (the cdc_burst "
                         "deck): kill/restart the exactly-once consumer "
                         "at every seam mid-batch, a multi-kill burst, "
                         "and a leader failover mid-consume — holding "
                         "the EIGHTH standing invariant (applied "
                         "records == produced prefix, exactly once, "
                         "per partition, on every replica of the "
                         "serving lineage)")
    ap.add_argument("--transport", choices=["tcp", "uds", "loopback"],
                    help="run the cluster's RPC plane on this byte layer "
                         "(RSTPU_TRANSPORT for the run; default: ambient "
                         "policy, i.e. tcp; data-plane mode only)")
    ap.add_argument("--break-guard",
                    choices=["wal_hole", "meta_first", "fencing",
                             "move_flip", "remote_install",
                             "split_cutover", "cdc_dedup",
                             "mux_misroute"])
    ap.add_argument("--expect-violation", action="store_true",
                    help="exit 0 iff a violation WAS caught")
    ap.add_argument("--conv-timeout", type=float, default=30.0)
    ap.add_argument("--device", default="cuda",
                    help="where every DB compacts (cuda or cpu)")
    ap.add_argument("--out", help="write the result JSON here")
    args = ap.parse_args(argv)
    if args.break_guard == "fencing" and not args.failover:
        ap.error("--break-guard fencing requires --failover")
    if args.break_guard == "move_flip" and not args.reshard:
        ap.error("--break-guard move_flip requires --reshard")
    if args.break_guard == "split_cutover" and not args.rebalance:
        ap.error("--break-guard split_cutover requires --rebalance")
    if args.break_guard == "cdc_dedup" and not args.cdc:
        ap.error("--break-guard cdc_dedup requires --cdc")
    if args.break_guard == "mux_misroute" and (
            args.failover or args.reshard or args.rebalance or args.cdc):
        ap.error("--break-guard mux_misroute is data-plane only "
                 "(drop --failover/--reshard/--rebalance/--cdc)")
    if args.break_guard == "remote_install":
        if args.failover or args.reshard:
            ap.error("--break-guard remote_install is data-plane only "
                     "(drop --failover/--reshard)")
        if not args.remote_every:
            ap.error("--break-guard remote_install requires "
                     "--remote-every > 0")
    if sum(map(bool, (args.failover, args.reshard, args.rebalance,
                      args.cdc))) > 1:
        ap.error("--failover / --reshard / --rebalance / --cdc are "
                 "mutually exclusive")

    root = tempfile.mkdtemp(prefix="rstpu-chaos-")
    t0 = time.monotonic()
    try:
        if args.cdc:
            result = run_cdc_chaos(
                root, schedules=args.schedules, seed=args.seed,
                break_guard=args.break_guard, device=args.device,
            )
        elif args.rebalance:
            result = run_rebalance_chaos(
                root, schedules=args.schedules, seed=args.seed,
                break_guard=args.break_guard, device=args.device,
            )
        elif args.reshard:
            result = run_reshard_chaos(
                root, schedules=args.schedules, seed=args.seed,
                break_guard=args.break_guard, device=args.device,
            )
        elif args.failover:
            result = run_failover_chaos(
                root, schedules=args.schedules, seed=args.seed,
                break_guard=args.break_guard, device=args.device,
            )
        else:
            result = run_chaos(
                root, schedules=args.schedules, seed=args.seed,
                writes=args.writes, ingest_every=args.ingest_every,
                remote_every=args.remote_every,
                break_guard=args.break_guard,
                conv_timeout=args.conv_timeout,
                transport=args.transport, device=args.device,
            )
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result["elapsed_sec"] = round(time.monotonic() - t0, 1)
    if args.cdc:
        print(f"chaos[cdc]: {result['schedules']} schedules "
              f"({', '.join(sorted(set(result['scenarios'])))}), "
              f"{result['produced']} records produced, "
              f"{result['kills']} consumer kills / "
              f"{result['consumer_starts']} starts, "
              f"{result['elapsed_sec']}s")
    elif args.rebalance:
        print(f"chaos[rebalance]: {result['schedules']} schedules, "
              f"{result['acked']} acked writes through policy-driven "
              f"placement ({result['write_errors']} refused), "
              f"{result['elapsed_sec']}s")
        print(f"chaos[rebalance]: dispatched {result['dispatched']}, "
              f"{result['resumes']} resumed after kills, "
              f"{result['tick_errors']} seam-faulted ticks, controller "
              f"passes {result['passes_used']}")
    elif args.reshard:
        print(f"chaos[reshard]: {result['schedules']} schedules, "
              f"{result['acked']} acked writes through live moves "
              f"({result['write_errors']} refused), "
              f"{result['elapsed_sec']}s")
        print(f"chaos[reshard]: move outcomes "
              f"{result['move_outcomes']}, move median "
              f"{result['move_ms_median']} ms, controller passes "
              f"{result['passes_used']}")
        print(f"chaos[reshard]: reads {result['reads_served']} served / "
              f"{result['reads_checked']} checked "
              f"({result['read_bounces']} bounces)")
    elif args.failover:
        print(f"chaos[failover]: {result['schedules']} schedules, "
              f"{result['acked']} strict-ledger acks "
              f"(+{result['window_acked']} window), "
              f"{result['elapsed_sec']}s")
        print(f"chaos[failover]: fault→one-leader median "
              f"{result['failover_ms_median']} ms, fault→first-ack "
              f"median {result['first_ack_ms_median']} ms, "
              f"controller passes {result['passes_used']}")
        print(f"chaos[failover]: reads {result['reads_served']} served / "
              f"{result['reads_checked']} checked "
              f"({result['read_bounces']} bounces) — zero staleness-"
              f"bound or deposed-lineage violations required")
    else:
        print(f"chaos: {result['schedules']} schedules "
              f"[{result['transport']}], "
              f"{result['writes']} writes ({result['acked']} acked), "
              f"{result['elapsed_sec']}s")
        if result.get("remote_outcomes"):
            print(f"chaos: remote-compaction outcomes "
                  f"{result['remote_outcomes']}")
    print(f"chaos: failpoint trips: {result['failpoint_trips']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
    if result["violations"]:
        for v in result["violations"]:
            print(f"VIOLATION: {v}")
        print(f"REPRO: python -m rocksplicator_tpu_torch.tools.chaos_soak "
              f"--schedules {args.schedules} --seed {args.seed}"
              + (" --failover" if args.failover else "")
              + (" --reshard" if args.reshard else "")
              + (" --rebalance" if args.rebalance else "")
              + (" --cdc" if args.cdc else "")
              + (f" --transport {args.transport}"
                 if args.transport else "")
              + (f" --break-guard {args.break_guard}"
                 if args.break_guard else "")
              + f" --device {args.device}")
        return 0 if args.expect_violation else 1
    print("chaos: all invariants held"
          + ((" (CDC exactly-once: applied records == produced prefix "
              "per partition on every serving replica — watermark, "
              "applies-counter witness, and log-fold all agree)"
              if args.cdc else
              " (policy-initiated placement: one unfenced leader per "
              "CHILD, zero acked loss resolved per owning range, "
              "parent retired everywhere, bounded convergence)"
              if args.rebalance else
              " (exactly one serving lineage per shard, zero acked "
              "loss across the move, bounded convergence, no stranded "
              "replicas)" if args.reshard else
              " (exactly-one-leader, zero acked loss across handoff, "
              "bounded shard-map convergence, bounded-staleness + "
              "lineage reads)" if args.failover else
              " (hole-free WAL prefix, zero acked loss, ingest "
              "atomicity)")
             if not args.break_guard else ""))
    if args.expect_violation:
        print("ERROR: --expect-violation but the broken guard was "
              "NOT caught — the harness has lost its teeth")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
