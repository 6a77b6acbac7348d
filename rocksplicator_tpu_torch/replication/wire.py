"""Replication wire protocol types.
(The port's copy of ``rocksplicator_tpu/replication/wire.py``.)

Reference: rocksdb_replicator/thrift/replicator.thrift:21-92 —
``ReplicateRequest{seq_no, db_name, max_wait_ms, max_updates, role}``,
``Update{raw_data (zero-copy IOBuf), timestamp, seq_no}``,
``ReplicaRole{NOOP, FOLLOWER, LEADER, OBSERVER}``,
``ErrorCode{SOURCE_NOT_FOUND, SOURCE_READ_ERROR, SOURCE_REMOVED}``.

On the wire these travel as the RPC layer's dict messages; raw_data rides
the binary payload region (no copies, no base64).
"""

from __future__ import annotations

import enum


class ReplicaRole(str, enum.Enum):
    NOOP = "NOOP"          # serve locally, no replication
    FOLLOWER = "FOLLOWER"  # pull from upstream, ACK counts (mode 1/2)
    LEADER = "LEADER"      # accept writes, serve updates
    OBSERVER = "OBSERVER"  # pull from upstream, ACK does NOT count (CDC)


class ReplicateErrorCode(str, enum.Enum):
    SOURCE_NOT_FOUND = "SOURCE_NOT_FOUND"
    SOURCE_READ_ERROR = "SOURCE_READ_ERROR"
    SOURCE_REMOVED = "SOURCE_REMOVED"
    # Fencing (the ZK-zxid-epoch analog, threaded end to end from the
    # controller's assignment epoch): a replicate/ack frame carrying a
    # NEWER epoch than the serving db proves a newer leader was promoted
    # — the server is deposed and must reject the frame, fail its
    # pending ack window, and refuse further writes. A frame carrying an
    # OLDER epoch than the puller's known epoch marks a stale (deposed)
    # upstream whose updates must not be applied.
    STALE_EPOCH = "STALE_EPOCH"
    # Bounded-staleness follower reads: the serving replica's
    # applied position is (or cannot be proven to be) within the
    # client's lag bound of the leader's committed sequence. NOT a
    # lineage error — the client should bounce the read to the leader
    # (or another replica); the router's follower-ok policy does exactly
    # that.
    STALE_READ = "STALE_READ"
    # The write/read entry was asked of a non-leader (reads with a
    # leader-only requirement, writes anywhere but the leader).
    NOT_LEADER = "NOT_LEADER"
    # The puller's position predates the oldest WAL record this server
    # can still serve (purge outran the puller): WAL catch-up can NEVER
    # succeed — the puller must flag itself stalled so the control
    # plane rebuilds it from a snapshot (rocksdb GetUpdatesSince
    # NotFound parity, found by the reshard chaos).
    WAL_GAP = "WAL_GAP"
    # Live shard move: the leader briefly refuses NEW writes
    # while a move's cutover drains the WAL tail to the target — the
    # write-pause that BOUNDS catch-up on a hot shard. Always
    # auto-expiring (a crashed move coordinator can never wedge the
    # shard); clients retry after the pause window, reads are unaffected.
    WRITE_PAUSED = "WRITE_PAUSED"


# Read-path counters (bounded-staleness follower reads).
# Names follow the tools/rstpu_check.py dotted.name grammar.
READ_METRICS = dict(
    leader_served="reads.leader_served",
    follower_served="reads.follower_served",
    # lag-bound bounce (the follower is too far behind the client's
    # max_lag, or its view of the leader's commit point is too old to
    # verify the bound) — distinct from the fencing rejection below
    stale_rejected="reads.stale_rejected",
    # lineage (fencing) rejection: the read carried a newer epoch than
    # the serving replica knows — the replica is on a deposed lineage
    stale_epoch_rejected="reads.stale_epoch_rejected",
    # upstream commit-point probes issued by bounded follower reads
    # whose cached estimate was older than read_info_ttl_ms
    probes="reads.upstream_probes",
)


# Counter/metric names (reference rocksdb_replicator/replicator_stats.{h,cpp})
REPLICATOR_METRICS = dict(
    leader_writes="replicator.leader_writes",
    leader_write_bytes="replicator.leader_write_bytes",
    leader_write_ms="replicator.leader_write_ms",
    ack_waits="replicator.ack_waits",
    ack_timeouts="replicator.ack_timeouts",
    ack_degraded="replicator.ack_degraded_mode",
    replicate_requests="replicator.replicate_requests",
    replicate_updates_sent="replicator.replicate_updates_sent",
    replicate_bytes_sent="replicator.replicate_bytes_sent",
    pull_requests="replicator.pull_requests",
    pull_updates_applied="replicator.pull_updates_applied",
    pull_bytes_applied="replicator.pull_bytes_applied",
    pull_errors="replicator.pull_errors",
    upstream_resets="replicator.upstream_resets",
    stale_epoch_rejects="replicator.stale_epoch_rejects",
    fenced="replicator.fenced",
    write_window_full="replicator.write_window_full_rejects",
    write_paused="replicator.write_paused_rejects",
    wal_gap_stalls="replicator.wal_gap_stalls",
    diverged_stalls="replicator.diverged_stalls",
    replication_lag_ms="replicator.replication_lag_ms",
    iter_cache_hits="replicator.iter_cache_hits",
    iter_cache_misses="replicator.iter_cache_misses",
    # Multiplexed per-peer pull sessions. A mux pull is ONE
    # long-poll frame carrying every shard this node pulls from that
    # peer; the park counters are the fleet-density A/B's primary
    # signal — at 100 idle shards the per-shard path parks 100 serves
    # per poll window, the mux path parks one per peer session.
    mux_pulls="replicator.mux_pulls",                # client: mux rounds
    mux_requests="replicator.mux_requests",          # server: mux serves
    mux_sections="replicator.mux_sections_served",   # server: sections
    mux_parks="replicator.mux_parks",                # server: session parks
    longpoll_parks="replicator.longpoll_parks",      # server: per-shard parks
    mux_fallbacks="replicator.mux_fallbacks",        # legacy-peer fallbacks
)
