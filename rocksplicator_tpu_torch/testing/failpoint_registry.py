"""The checked-in failpoint site registry — single source of truth. A
copy of ``rocksplicator_tpu/testing/failpoint_registry.py``, whole: a
``RSTPU_FAILPOINTS`` spec names sites of every layer, and ``activate``
rejects unknown names, so a partial registry would make the import fail.
Entries whose seams live in layers the port has not taken over yet have
no call site here.

Every ``failpoints.hit/async_hit/pending_delay/torn_point`` call site in
the package must name an entry here, every entry must have at least one
call site, and every entry must be referenced by at least one test or
chaos schedule; ``tools/rstpu_check.py`` (pass 3) enforces all three, so
a seam can neither arm silently under a typo'd name nor rot uncovered.
``failpoints.SITES`` derives from this dict, so activate()'s
unknown-site rejection can never drift from the registry.

Adding a seam = add its fp.hit()/torn_point() call, add the entry here,
and reference it from a test or a chaos schedule (make check fails on
any of the three missing).

Value = one line saying what fault the site injects, for humans reading
`rstpu-check --json` output or a chaos schedule.
"""

from __future__ import annotations

REGISTRY = {
    "wal.append": "WAL record append failure / torn tail",
    "wal.fsync": "WAL group-commit fsync failure or stall",
    "wal.roll": "WAL segment roll failure",
    "manifest.persist": "manifest atomic-write failure",
    "sst.fsync": "SST data/footer fsync failure or stall",
    "sst.ingest_footer": "global-seqno footer rewrite failure mid-ingest",
    "engine.ingest": "engine external-file ingest failure",
    "compact.install": "compaction result install failure",
    "compact.dispatch": "batch-compactor dispatch failure",
    # workload-adaptive compaction scheduler
    "compact.pick": "scheduler pick failure (compaction loop retries)",
    "compact.subcompact": "key-range subcompaction slice failure",
    "compact.yield": "IO-budget yield delay / failure on a compaction write",
    # streaming bounded-memory merge: a fault at either seam
    # kills the pipeline mid-stream — every written output is swept and
    # nothing was installed, so reopen is exactly pre-compaction
    "compact.stream.chunk": "streaming merge chunk resolve failure",
    "compact.stream.refill": "streaming merge window refill failure",
    "objectstore.get": "object-store download failure",
    "objectstore.put": "object-store upload failure",
    "s3.request": "S3 request transient failure",
    "hdfs.request": "WebHDFS request transient failure",
    "rpc.connect": "RPC connect failure or stall",
    "rpc.frame.send": "RPC frame send failure / torn frame",
    "rpc.frame.recv": "RPC frame receive failure",
    "repl.pull": "replication pull RPC failure",
    "repl.apply": "follower apply failure",
    # multiplexed per-peer pull sessions: serve is the
    # server-side session seam (a fault fails the WHOLE mux response —
    # the torn-session shape; per-SECTION faults ride the per-shard
    # serve path's existing seams), apply is the client-side demux seam
    # hit once per non-empty section before its apply is scheduled
    "repl.mux.serve": "mux session serve failure (whole response)",
    "repl.mux.apply": "mux per-section apply handoff failure",
    "repl.read": "bounded-staleness read-path failure at the replica",
    "router.read_pick": "router read host-pick failure",
    "ack.expire": "ack-window expiry timer blip",
    "coordinator.heartbeat": "coordinator session heartbeat failure",
    "coordinator.reap": "coordinator ephemeral-node reap blip",
    "coordinator.wal.append": "coordinator WAL append failure / torn tail",
    "participant.transition": "participant state-transition failure",
    "shardmap.publish": "spectator shard-map publish failure",
    "controller.assign": "controller assignment-pass failure",
    "admin.ingest.engine": "admin ingest fault before engine ingest",
    "admin.ingest.meta": "admin ingest fault between engine and meta",
    # live shard moves: one seam per step-machine phase —
    # arming fail_nth:1 on any of them IS the "kill the move
    # coordinator at this phase" chaos schedule (the raise unwinds the
    # mover, leaving the durable record for resume/abort)
    "move.record": "shard-move ledger write failure (any phase entry)",
    "move.snapshot": "shard-move snapshot (backup) phase failure",
    "move.restore": "shard-move bulk-ingest (restore) phase failure",
    "move.catchup": "shard-move WAL-tail catch-up phase failure",
    "move.flip": "shard-move epoch-bumped cutover phase failure",
    "move.retire": "shard-move source-retire phase failure",
    # disaggregated compaction tier: one seam per handoff —
    # arming fail_nth:1 kills the exchange at that boundary. Leader-side
    # faults (publish/install) fall back to the unchanged local merge;
    # worker-side faults (claim/fetch/upload/heartbeat) fail the job or
    # make the worker look dead, so the leader reaps + republishes.
    "compact.remote.publish": "compaction job ledger publish failure",
    "compact.remote.claim": "worker job-claim failure at the ledger",
    "compact.remote.fetch": "worker input-SST fetch failure",
    "compact.remote.upload": "worker output-SST upload failure",
    "compact.remote.install": "leader-side verified-install failure",
    "compact.remote.heartbeat": "worker liveness heartbeat failure",
    # tail armor: arming these drives the SHED/DEGRADE paths
    # themselves, not INTERNAL errors — a tripped deadline check forces
    # the DEADLINE_EXCEEDED verdict, a tripped admission check forces a
    # RETRY_LATER shed, and a tripped hedge launch falls back to the
    # plain primary chain (hedging is never a correctness dependency)
    "rpc.deadline.check": "server deadline check forces expired verdict",
    "admission.shed": "tenant admission forces a RETRY_LATER shed",
    "router.hedge.fire": "hedged-read backup launch failure",
    # autonomous rebalancer + hot-shard range splits: the
    # decide/plan/dispatch seams kill the policy loop between sensing
    # and acting (the tick's work is re-derived from durable ledgers on
    # the next tick); split.cutover kills the splitter AT the fenced
    # flip — the recorded cutover phase resumes idempotently, and the
    # chaos harness's split_cutover break-guard tooth lives on the same
    # seam
    "rebalance.decide": "rebalancer hot-spot decision failure",
    # executor-side sibling of repl.read: a delay policy here holds a
    # dispatch-executor slot while sleeping (no CPU), giving benches a
    # deterministic per-read service cost — the hot-shift A/B's
    # structural serving knee
    "repl.read.serve": "engine-side read execution failure / stall",
    "rebalance.plan": "rebalancer move/split planning failure",
    "rebalance.dispatch": "rebalancer actuator dispatch failure",
    "split.cutover": "shard-split fenced cutover phase failure",
    # CDC streaming ingest: the three consumer seams — a
    # fail_nth at any of them kills the consumer thread mid-batch; a
    # restart must resume from the WAL-riding watermark exactly-once
    # (the batch either committed with its watermark or neither did)
    "kafka.fetch": "CDC consumer fetch-round failure (pre-drain)",
    "kafka.apply": "CDC grouped-commit apply failure (pre-write)",
    "kafka.checkpoint": "CDC watermark fold failure (pre-checkpoint)",
}
