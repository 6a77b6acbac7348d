"""Replication throughput benchmark harness.
(The port's copy of ``rocksplicator_tpu/replication/performance.py``.)

Reference: rocksdb_replicator/performance.cpp:57-207 — a two-process
benchmark (leader + follower binaries) writing N shards × M writer threads
× K keys of fixed-size values, reporting bytes/s and a stats dump.

Run the follower first, then the leader:

    python -m rocksplicator_tpu_torch.replication.performance \
        --role follower --port 9092 --upstream_port 9091 --db_dir /tmp/f
    python -m rocksplicator_tpu_torch.replication.performance \
        --role leader --port 9091 --db_dir /tmp/l \
        --num_shards 200 --num_write_threads 2 \
        --num_keys_per_shard_thread 10240 --value_size 1024

Where the port differs: its DBs compact on the card (``--device``, default
``cuda``; ``cpu`` runs the plain PyTorch path), and the device is resolved
before anything opens, so without CUDA it raises unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

from ..device import resolve_device
from ..gpu.backend import GpuCompactionBackend
from ..storage import DB, DBOptions, WriteBatch
from ..utils.stats import Stats
from .db_wrapper import StorageDbWrapper
from .replicated_db import ReplicationFlags
from .replicator import Replicator
from .wire import ReplicaRole


def _print_slowest_write_trace() -> None:
    """Print the slowest sampled write's span tree (the bench's --trace
    deliverable: per-phase attribution of ONE acked write — wal fsync vs
    ack wait — instead of only an aggregate writes/s). Emitted BEFORE the
    throughput line so harnesses that stop relaying output at that line
    still capture it; markers make it machine-extractable."""
    from ..observability.collector import SpanCollector, render_trace

    snap = SpanCollector.get().snapshot()  # one consistent ring view
    # repl.write = single pipelined/blocking write; repl.write_group =
    # one batched write_async_many commit (its ack_wait children are the
    # per-batch waits)
    writes = [s for s in snap
              if s["name"] in ("repl.write", "repl.write_group")]
    if not writes:
        print("TRACE-SLOWEST-WRITE-BEGIN none sampled", flush=True)
        print("TRACE-SLOWEST-WRITE-END", flush=True)
        _print_ack_window_depth(snap)
        return
    slowest = max(writes, key=lambda s: s["duration_ms"])
    trace = [s for s in snap if s["trace_id"] == slowest["trace_id"]]
    print(
        f"TRACE-SLOWEST-WRITE-BEGIN trace_id={slowest['trace_id']} "
        f"duration_ms={slowest['duration_ms']:.3f} "
        f"sampled_writes={len(writes)}",
        flush=True,
    )
    for line in render_trace(trace):
        print(line, flush=True)
    print("TRACE-SLOWEST-WRITE-END", flush=True)
    _print_ack_window_depth(snap)


def _print_ack_window_depth(snap) -> None:
    """Report the max number of OVERLAPPING sampled repl.ack_wait spans
    (sweep over the span intervals): pipelining proof. The serial write
    path can never exceed depth 1 per shard — depth > 1 means multiple
    writes were genuinely in flight awaiting acks at once."""
    acks = [s for s in snap if s["name"] == "repl.ack_wait"]
    events = []
    for s in acks:
        events.append((s["start_ms"], 1))
        events.append((s["start_ms"] + s["duration_ms"], -1))
    events.sort()
    depth = max_depth = 0
    for _t, d in events:
        depth += d
        max_depth = max(max_depth, depth)
    # registration-time window depth annotated on each span: per-shard
    # view (the sweep above spans all shards)
    per_shard = max(
        (int(s["annotations"].get("window_depth") or 0) for s in acks),
        default=0,
    )
    print(
        f"TRACE-ACK-WINDOW sampled_ack_waits={len(acks)} "
        f"max_overlapping={max_depth} max_window_depth={per_shard}",
        flush=True,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--role", choices=["leader", "follower", "cluster"],
                   required=True,
                   help="cluster = leader + 2 followers COLOCATED in this "
                        "process (one IoLoop): the in-process loopback "
                        "transport's deployment shape, also a syscall-"
                        "free ceiling for uds/tcp on noisy hosts")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--upstream_ip", default="127.0.0.1")
    p.add_argument("--upstream_port", type=int, default=0)
    p.add_argument("--db_dir", required=True)
    # defaults mirror performance.cpp:57-66
    p.add_argument("--num_shards", type=int, default=200)
    p.add_argument("--num_write_threads", type=int, default=2)
    p.add_argument("--num_keys_per_shard_thread", type=int, default=10240)
    p.add_argument("--value_size", type=int, default=1024)
    p.add_argument("--replication_mode", type=int, default=0)
    p.add_argument("--write_window", type=int, default=64,
                   help="leader: max in-flight (unacked) writes per shard "
                        "(ReplicationFlags.write_window). 1 = the old "
                        "serial blocking write path, for A/B comparison")
    p.add_argument("--wait_sec", type=int, default=3600,
                   help="follower: how long to serve before exiting")
    p.add_argument("--warmup_wait_sec", type=float, default=20.0,
                   help="leader, ack modes only: wait until followers are "
                        "actually pulling (≥1 replicate request per shard) "
                        "before the timed write phase. Followers spawned "
                        "before the leader sit in 5-10s connect backoff; "
                        "the serial write path hid that race by blocking "
                        "on the first ack, a pipelined write phase would "
                        "otherwise complete before any puller connects "
                        "and measure nothing but timeouts")
    p.add_argument("--linger_sec", type=int, default=30,
                   help="leader: keep serving WAL after the write phase so "
                        "followers (possibly in connect backoff) catch up")
    p.add_argument("--trace", action="store_true",
                   help="sample per-write traces (observability/) and print "
                        "the slowest sampled write's span tree after the "
                        "write phase")
    p.add_argument("--trace_rate", type=float, default=1.0 / 64.0,
                   help="head-sampling rate for --trace")
    p.add_argument("--executor_threads", type=int, default=8,
                   help="replicator CPU executor size. The library "
                        "default (16, reference parity) thrashes the GIL "
                        "on small benchmark hosts: executor work here is "
                        "short WAL reads/applies, so a few threads keep "
                        "the disk busy without starving the IO loop")
    p.add_argument("--gil_switch_interval_ms", type=float, default=20.0,
                   help="sys.setswitchinterval for this process (0 = "
                        "leave Python's 5ms default). Write/serve/apply "
                        "threads are all short-quantum GIL contenders; "
                        "a longer quantum trades fairness for fewer "
                        "forced handoffs on the hot paths")
    p.add_argument("--device", default="cuda",
                   help="where the DBs compact: cuda (the card, the "
                        "default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)

    # the card first: without CUDA nothing is opened
    device = resolve_device(args.device)

    def db_options() -> DBOptions:
        return DBOptions(wal_ttl_seconds=3600.0,
                         compaction_backend=GpuCompactionBackend(device))

    if args.gil_switch_interval_ms > 0:
        sys.setswitchinterval(args.gil_switch_interval_ms / 1000.0)

    if args.trace:
        from ..observability.collector import SpanCollector

        # capacity sized so a default run's sampled spans survive to the
        # report (they'd otherwise rotate out of the 4096-slot ring)
        SpanCollector.get().configure(
            sample_rate=args.trace_rate, capacity=1 << 15,
            process=f"{args.role}:{args.port}")

    is_cluster = args.role == "cluster"
    replicator = Replicator(
        port=args.port,
        flags=ReplicationFlags(write_window=max(1, args.write_window)),
        executor_threads=max(1, args.executor_threads),
    )
    dbs = {}
    role = (ReplicaRole.FOLLOWER if args.role == "follower"
            else ReplicaRole.LEADER)
    upstream = (
        (args.upstream_ip, args.upstream_port) if args.upstream_port else None
    )
    leader_dir = os.path.join(args.db_dir, "l") if is_cluster else args.db_dir
    for shard in range(args.num_shards):
        name = f"perf{shard:05d}"
        db = DB(os.path.join(leader_dir, name), db_options())
        dbs[name] = db
        replicator.add_db(
            name, StorageDbWrapper(db), role,
            upstream_addr=upstream, replication_mode=args.replication_mode,
        )
    print(f"{args.role}: {args.num_shards} shards on :{replicator.port}",
          flush=True)

    # colocated followers AFTER the leader is serving: their pullers
    # connect immediately instead of sitting in connect backoff (all
    # three replicators share IoLoop.default(), which is what makes the
    # in-process loopback transport resolvable between them)
    follower_reps = []
    follower_dbs = []
    if is_cluster:
        for fi in (1, 2):
            rep = Replicator(
                port=args.port + fi,
                flags=ReplicationFlags(
                    write_window=max(1, args.write_window)),
                executor_threads=max(1, args.executor_threads),
            )
            fdbs = {}
            for shard in range(args.num_shards):
                name = f"perf{shard:05d}"
                db = DB(os.path.join(args.db_dir, f"f{fi}", name),
                        db_options())
                fdbs[name] = db
                rep.add_db(
                    name, StorageDbWrapper(db), ReplicaRole.FOLLOWER,
                    upstream_addr=("127.0.0.1", args.port),
                    replication_mode=args.replication_mode,
                )
            follower_reps.append(rep)
            follower_dbs.append(fdbs)
        print(f"cluster: 2 colocated followers on "
              f":{args.port + 1} :{args.port + 2}", flush=True)

    if args.role == "follower":
        try:
            end = time.monotonic() + args.wait_sec
            while time.monotonic() < end:
                time.sleep(5)
                total = sum(db.latest_sequence_number() for db in dbs.values())
                print(f"follower total seq: {total}", flush=True)
        except KeyboardInterrupt:
            pass
        replicator.stop()
        return 0

    if args.replication_mode in (1, 2) and args.warmup_wait_sec > 0:
        # PER-SHARD gate: every shard must have served ≥1 pull. A global
        # request count lets the write phase start while a few shards'
        # pullers are still in 5-10s connect backoff (the follower
        # processes race the leader's sequential add_db); those shards
        # then time out their entire first write window.
        rdb_list = [replicator.get_db(f"perf{s:05d}")
                    for s in range(args.num_shards)]
        deadline = time.monotonic() + args.warmup_wait_sec
        while (time.monotonic() < deadline
               and not all(r.serve_count > 0 for r in rdb_list)):
            time.sleep(0.1)
        live = sum(1 for r in rdb_list if r.serve_count > 0)
        print(
            f"leader warmup: {live}/{args.num_shards} shards have live "
            f"pullers before write phase",
            flush=True,
        )

    # leader: shard-striped writer threads (performance.cpp write loop).
    # With write_window > 1 the writers PIPELINE — and they TOP UP: each
    # pass issues only as many writes per shard as that shard's window
    # has free slots (non-blocking depth check), so a writer never
    # head-of-line blocks on one full window while its other shards'
    # windows drain to empty and their followers park in long-polls.
    # Only when EVERY owned shard is at capacity does the writer wait —
    # on the earliest pending futures, not on a sleep.
    value = b"v" * args.value_size
    total_keys = args.num_keys_per_shard_thread
    pipelined = args.write_window > 1
    acked_counts = [0] * args.num_write_threads

    def writer(tid: int) -> None:
        from collections import deque
        from concurrent.futures import FIRST_COMPLETED, wait as fwait

        my_shards = list(range(tid, args.num_shards, args.num_write_threads))
        names = {s: f"perf{s:05d}" for s in my_shards}
        rdbs = {s: replicator.get_db(names[s]) for s in my_shards}
        acked = 0

        if not pipelined:
            # write_async + immediate result() = the serial blocking
            # path (window 1 allows one in-flight write), but the waiter
            # exposes .acked — the bare write() returns the seq whether
            # the ack landed or timed out, which would count timed-out
            # writes as acked and inflate the serial A/B baseline
            for i in range(total_keys):
                for shard in my_shards:
                    batch = WriteBatch().put(
                        f"t{tid}-k{i:08d}".encode(), value)
                    w = replicator.write_async(names[shard], batch)
                    w.result()
                    if w.acked:
                        acked += 1
            acked_counts[tid] = acked
            return

        next_key = {s: 0 for s in my_shards}
        pending = {s: deque() for s in my_shards}

        def drain_done(shard) -> None:
            nonlocal acked
            dq = pending[shard]
            while dq and dq[0].future.done():
                if dq.popleft().acked:
                    acked += 1

        remaining = set(my_shards)
        while remaining or any(pending[s] for s in my_shards):
            progress = 0
            for shard in list(remaining):
                drain_done(shard)
                free = rdbs[shard].ack_window_free
                i = next_key[shard]
                n = min(free, total_keys - i)
                # don't dribble: a 1-2 write top-up pays a full WAL
                # flush + wakeup + (later) pull response for almost no
                # pipelining gain. Wait for a quarter-window of free
                # slots (or the tail) before topping up.
                if 0 < n < min(args.write_window // 4, total_keys - i):
                    n = 0
                if n:
                    # one write_async_many per top-up: the whole group
                    # commits with one WAL flush / wakeup / stats update
                    batches = [
                        WriteBatch().put(f"t{tid}-k{k:08d}".encode(), value)
                        for k in range(i, i + n)
                    ]
                    pending[shard].extend(
                        replicator.write_async_many(names[shard], batches))
                    next_key[shard] = i + n
                    progress += n
                    if next_key[shard] >= total_keys:
                        remaining.discard(shard)
            if progress:
                continue
            # every unfinished shard is at capacity (or all writes are
            # issued): park on the heads of the pending queues
            heads = [pending[s][0].future for s in my_shards if pending[s]]
            if heads:
                fwait(heads, timeout=0.5, return_when=FIRST_COMPLETED)
            for shard in my_shards:
                drain_done(shard)
        acked_counts[tid] = acked

    start = time.monotonic()
    threads = [
        threading.Thread(target=writer, args=(t,))
        for t in range(args.num_write_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # elapsed INCLUDES the final ack drain: with pipelining the write
    # phase isn't over until every in-flight write resolved, so the
    # writes/s numbers stay acked-write honest
    elapsed = time.monotonic() - start
    if args.trace:
        _print_slowest_write_trace()
    total_writes = total_keys * args.num_shards
    # exact byte count (each shard is written by exactly one thread, keys
    # times); the old mirrored formula used num_shards//num_write_threads
    # for every thread, undercounting when shards % threads != 0
    total_bytes = total_writes * args.value_size
    print(
        f"leader acked {sum(acked_counts)}/{total_writes} writes "
        f"window={args.write_window} mode={args.replication_mode}",
        flush=True,
    )
    print(
        f"leader wrote ~{total_bytes / 1e6:.1f} MB in {elapsed:.3f}s = "
        f"{total_bytes / elapsed / 1e6:.2f} MB/s",
        flush=True,
    )
    print(Stats.get().dump_text(), flush=True)
    if is_cluster:
        # colocated followers: poll convergence in-process instead of
        # lingering blind; the printed lines match what the 3-process
        # bench parses from separate follower stdouts
        want = total_writes
        deadline = time.monotonic() + max(1, args.linger_sec)
        while time.monotonic() < deadline:
            totals = [
                sum(db.latest_sequence_number() for db in fdbs.values())
                for fdbs in follower_dbs
            ]
            for i, tot in enumerate(totals):
                print(f"follower{i} total seq: {tot}", flush=True)
            if all(tot >= want for tot in totals):
                print("cluster converged", flush=True)
                break
            time.sleep(0.2)
        for rep in follower_reps:
            rep.stop()
        for fdbs in follower_dbs:
            for db in fdbs.values():
                db.close()
    elif args.linger_sec:
        print(f"leader lingering {args.linger_sec}s for follower catch-up",
              flush=True)
        time.sleep(args.linger_sec)
    replicator.stop()
    for db in dbs.values():
        db.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
