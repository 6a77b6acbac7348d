#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's compaction pipeline on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA GPU, nvcc and
PyTorch built for CUDA. It

1. builds the three kernels (K1 lane sort, K2 fused merge-resolve, K3
   bloom build) from ``rocksplicator_tpu_torch/ops/csrc`` — one nvcc per
   source, all started together;
2. holds each kernel against its plain PyTorch version on the card, element
   for element (tolerance 0: these are integer lanes), K1 on tied keys too
   (it is stable), and checks the CUDA launches that K1's and K2's C entry
   points count per call against the wrappers' plans; values of any width
   (``parity`` F6: 16-byte keys with W = 16 and W = 64 value words); the
   shard axis (``parity`` batched: K2 over 8 shards of 2^17 under both
   flag sets with one overflow shard, K1 segmented, K3 batched, each
   against the plain version shard by shard); K3 by both of its routes
   (global, the plan's for a batch of bitmaps; rowwise, the plan's for
   one) at the bench's 8 x 2^17, one 2^17 bitmap, the service's 8 x 2^20,
   one file's bloom of 2^21 rows and a batch with one shard at count 0
   and one at its capacity;
3. drives the main path through the entry points — ``entry()``, the bench
   configuration as ONE batched forward over 8 shards of 2^17 entries
   (``jax.vmap(model.forward)`` in the JAX package), and one 2^22-entry job
   with every fast-path flag off — under both ``sort_backend``s, with every
   launch count set to 0 just before and read just after, and compares
   every output with the plain pipeline on the card (shard by shard);
4. checks a small hand-made batch against known answers;
4b. drives the engine seam, ``gpu.GpuCompactionBackend``, each path with
   the launch counts set to 0 just before it and read just after:
   ``merge_runs`` on the known answers under both sort backends and on
   two CPU routes that must launch nothing; ``merge_runs_to_files`` on the
   counter service's compaction job at the single-launch limit (4 planar
   SST runs of 2^20 entries, DBOptions' defaults), whose output files
   must equal byte for byte those the same sink writes from
   ``numpy_merge_resolve``'s output with a host-built bloom (K2 or K1
   launched, K3 once per file; the host-clock time split by stage); and
   ``gpu.chunked.chunked_merge`` over 8 runs of 2^20 entries against
   ``numpy_merge_resolve``; the same job with ``max_subcompactions = 4``
   (``engine_seam_subcompact``: one batched K2 call over the key-range
   slices, the same files); planar runs with 64-byte values and no
   operator (``engine_seam_wide``); these phases pin the streaming merge
   off. Then the streaming merge in auto mode: the same 2^22 job under a
   32 MiB budget (``engine_seam_stream_budget``: the in-RAM files, the
   peak within the budget plus the sink's one-file buffer) and 4 planar
   runs of 2^21 entries, twice the single-launch limit, under the default
   256 MiB budget and both sort backends (``engine_seam_stream``: no
   decline, one K2 (or K1) call per chunk, the peak within the budget,
   the files of the same stream resolved on the host by numpy);
4c. drives the batched service, ``gpu.compaction_service``:
   ``compact_shard_batch`` over 8 shards of 2^20 counter entries
   (``service_batch``: one K2 and one K3 call, each shard equal to
   ``numpy_merge_resolve`` and the host bloom) and ``compact_dbs_batched``
   over 12 stub DBs of 4 planar runs of 2^17 entries (``service_dbs``: a
   group of 8 and a padded group of 4 on the stream path, every file
   byte-identical to the numpy-resolved sink's);
4d. drives the post-ingest caller, ``admin.BatchCompactor``, over the same
   12 stub DBs submitted from 12 threads at once (``batch_compactor``:
   the leader's batches, one K2 call a launch group and one K3 call a
   group and a file, every file byte-identical to the numpy-resolved
   sink's, no DB compacted by the per-DB fallback, no error logged by the
   port's admin logger);
4f. drives the port's storage engine, ``storage.DB``, in the
   environment's stream mode: the counter traffic (4 x 2^17 ops in
   WriteBatches of 1024) through ``DB.write`` into a DB that compacts on
   the card (fused) and one on the host (``NativeCompactionBackend``), and
   run 4 into a third, on the card (bitonic), opened from the host DB's
   checkpoint after run 3, each run's last batch flushing 2^17
   entries and the fourth flush compacting L0 inline, then
   ``compact_range`` (``engine_db``: files byte for byte against the
   host DB's, one K2 (K1) call a compaction and one K3 call a file, every
   key of the fused DB read back through ``multi_get`` and a full scan
   against a numpy oracle, the native library loaded, host-clock seconds
   of each write run, flush and compaction); the same traffic
   (4 x 2^18 ops, under a quarter of the default memory
   budget) from 4 writer threads into a DB with background flush and compaction and its
   default backend, the card (``engine_db_background``: K2 launched from
   the compaction thread before ``compact_range``, no background failure,
   every write read back, write() p50 and p99); and the 12 DBs of
   ``service_dbs`` filled by ``ingest_external_file`` and compacted by
   ``BatchCompactor(device=cuda)`` from 12 threads
   (``engine_db_ingest``: files byte for byte against the same DBs
   compacted on the host, no per-DB fallback, sampled reads equal);
4e. before each engine-seam and service call zeroes the port's Stats,
   empties its span collector (every root kept) and disarms its
   failpoints, and after it checks them: the stream counters
   (``compaction.stream_chunks`` = the chunks = the K2 (K1) calls, one
   ``stream_merges``, no ``stream_declines``) and one ``compact.stream``
   span a streamed call, ``compaction.subcompactions`` = the non-empty
   slices, ``service_batch``'s ``tpu.compact_batch`` root with its
   ``tpu.stage``, ``tpu.kernel`` and ``tpu.unpack`` children and no
   ``cpu_fallbacks``, ``service_dbs``'s ``admin.compact_stage`` and
   ``admin.compact_install`` spans; and times the instrumentation's calls
   on the host (``instrumented_seconds``);
5. times each kernel and each forward (median of CUDA-event timed runs
   after warm-up: 10 at the 2^22 and batched 8 x 2^20 shapes, 50 at the
   host-bound small shapes, whose medians move most from call to call)
   beside its plain version and its memory bound, and each kernel's device
   time per call from torch.profiler; K1 and K2 at 2^17 and 2^22 over the
   sort tiles the plan could choose, K3 at its four timed shapes over the
   routes, thread counts and grid sizes its plan could choose
   (``k3_sweep``, each against the plain version); the batched shapes and
   W = 16; and profiles the batched bench forward and the 8 single-shard
   forwards it replaces.

4g. drives the remote compaction tier with the card as its worker: a
   port coordinator, a port ``CompactionWorker`` on
   ``GpuCompactionBackend(device=cuda)`` in a thread, and host leaders
   (port DBs on ``NativeCompactionBackend``) holding the counter traffic
   (``remote_worker``: job A, the leader's own L0 pick at the trigger over
   a local store under a 1 GiB budget, in RAM: one K2 call and one K3
   call a file; job B, ``maybe_offload`` over the port's S3 stub under
   a 64 MiB budget, a quarter of the default, streamed: one K2 call a
   chunk and no K3;
   each installed generation sha256-identical to the same data compacted
   by ``compact_range`` on a host DB under the same budget, every key of
   A and a sample of B read back against the numpy oracle, one claim a
   job, no failover, reap or local compaction, every launch from the
   worker's thread, the ledger and objects swept; host-clock seconds by
   stage and bytes moved); and the worker CLI as its own process
   (``remote_worker_cli``: ``python -m
   rocksplicator_tpu_torch.tools.compaction_worker --backend gpu --once``
   over 4 runs of 2^18 entries: exit 0, the job installed, files equal
   to the host's, its own launch counts);
4h. drives the replicated shard through the port's admin plane
   (``replicated_counter``): four nodes, each a port ``Replicator`` and
   ``AdminHandler`` on a port ``RpcServer``; A leads on the card, B
   follows on the card, C follows with ``gpu_compaction=False`` (the
   host's comparator), D starts empty on the card; the counter service's
   options, ack mode 1; DBs opened by ``add_db`` RPCs; 4 x 2^18 counter
   ops pipelined through A's ``ApplicationDB.write_async``; ``compact_db``
   on A, B and C, ``backup_db_to_s3`` of B into the port's S3 stub and
   ``restore_db_from_s3`` into D. Every key reads back from A and B equal
   to the numpy oracle, A's, B's and C's files are sha256-equal, D's equal
   B's backup; A's and B's K2 calls = in-RAM compactions + stream chunks
   (the port's Stats, by replica), K3 calls = their in-RAM files, C
   launches nothing, no compaction raises (write() ack p50 / p99, ops/s,
   the followers' lag, each replica's compactions and compact_db
   seconds, backup and restore seconds);
4i. drives the counter service as the README's quick start starts it
   (``counter_service``): two port node processes (``python -m
   rocksplicator_tpu_torch.examples.counter_service.counter_service``,
   the default device, the card) from one static shard map of 2 shards,
   each leading one and following the other; 2^19 counters bulk-loaded
   by ``add_s3_sst_files_to_db(compact_db_after_load=True)`` on every
   replica; the port's ``stress_test`` (8 threads x 2048 routed gets and
   bumps) against one node with 0 errors; ``compact_db`` on every
   replica; every bumped counter and a seeded sample read back from
   every replica equal to the numpy oracle; both status servers'
   ``/stats.txt`` and ``/hotkeys.txt``; SIGTERM, exit 0 and each
   process's launch counts (K2 and K3 at least 2 each); each replica's
   directory scanned on the host, leader equal to follower and to the
   oracle; then the replication harness as two processes
   (``performance``: its throughput line and launch counts);
4j. drives the CDC ingestion stack (``cdc_ingest``): 2^16 CDC records
   (11-byte keys from a space of 2^15, 256-byte values, a tenth deletes)
   from an embedded topic through A's ``start_message_ingestion`` into a
   three-replica shard in ack mode 1 (A leading and B following on the
   card, C following on the host) with a CDC observer D on A, the first
   2^14 produced before the start and the rest offered at 100,000 a
   second; ``compact_db`` on C, B, A at half and on each after the drain:
   every key against the oracle on A, B and C, watermarks and applies
   counters, sha256-equal files, D's batches replaying to A's state, K2
   once per compaction of A and B (the tuple path: the reserved watermark
   keys differ in width), no K1 or K3, C launching nothing; then the
   networked broker and the consumer app as processes under the lock-order
   watchdog (``cdc_network``: 8 producers, 2^14 records ingested by
   ``broker://`` into an unreplicated shard on A, read back before and
   after ``compact_db``, the app printing every record, DB_ADMIN_ERROR for
   an unknown topic, exit 0 on SIGINT);
4k. drives the cluster control plane over card nodes
   (``cluster_failover``: 16 semi-sync shards, a leader host's crash and
   a replacement host's catch-up under a storm of 2^18 counter ops);
4l. drives shard movement as an operator does (``cluster_reshape``: the
   same control plane over nodes A, B, D on the card and C on the host;
   ``admin_cli move-shard`` and ``split-shard`` as processes under live
   writers, compact_db trimming the split's children through K2 on the
   tuple path, then the port's ``Rebalancer`` moving a shard that runs
   hot; every key read back through a router over the published map,
   every replica scanned against the numpy oracle);
4m. drives the chaos harness's decks with every DB on the card
   (``chaos_dataplane``: the port's ``run_chaos`` at the Makefile's 20
   schedules and seed 1, its mux deck under RSTPU_PULL_MUX=1 (6
   schedules, seed 3), its ``wal_hole``, ``meta_first``,
   ``mux_misroute`` and ``remote_install`` teeth at the Makefile's
   arguments, and the ingest fixture's ``compact_db_after_load`` branch
   once a fault of its menu; ``chaos_cdc``: ``run_cdc_chaos`` at 2
   schedules and seed 1 and its ``cdc_dedup`` tooth): no violation in a
   healthy deck, every tooth caught, K2 and K3 launched, the remote
   fixture both installing and fencing, no tuple-path fallback, the
   background compactions the loop retried counted (and among them the
   card's raises), the failpoints cleared and the chaos scale restored
   however the phase ends;
4n. drives the chaos harness's reshard and rebalance decks on card nodes
   (``chaos_reshard``: ``run_reshard_chaos`` at the Makefile's 3
   schedules and seed 1, every move ending completed, resumed or aborted
   within the controller-pass bound, then its ``move_flip`` tooth;
   ``chaos_rebalance``: ``run_rebalance_chaos`` at 3 schedules and seed 1
   with a move and a split dispatched by the policy, its
   ``split_cutover`` tooth, then one move and one split built from the
   decks' schedules and ``compact_db`` on every replica of the moved
   shard and of both children: K2 on the tuple path at least once a
   replica, no host path, no key outside a child's retain range, and the
   sixth, seventh and read invariants held again after the compactions);

Every phase raises on failure and the script then exits non-zero. Without
CUDA, or without the package beside it, it exits non-zero and prints no
result. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import faulthandler
import json
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BENCH_SHARDS = 8
BIG_N = 1 << 22
DEVICE = "cuda"
REPS = 10
STACKS_AFTER_S = 1140
SHORT_REPS = 50  # host-bound shapes (< ~10 ms a call)
# the engine seam: runs of 2^20 entries, four of which fill one launch
# (the backend's MAX_LAUNCH_ENTRIES), and DBOptions' target_file_bytes
SEAM_RUN_ENTRIES = 1 << 20
# the streaming phases: 4 runs of this many entries, twice the single-launch
# limit in all; engine_seam_job's runs under this budget
STREAM_RUN_ENTRIES = 1 << 21
STREAM_BUDGET_BYTES = 32 << 20
SEAM_TARGET_FILE_BYTES = 64 << 20
# rows of each parity case of the new shapes (F6, batched shards)
PARITY_N = 1 << 17
# the batched service: shards of compact_shard_batch (the JAX package's
# MAX_BATCHED_DB_ENTRIES at its default group of 8), and the runs of each
# stub DB of compact_dbs_batched (four fill half such a shard, to keep the
# command's time)
SERVICE_ENTRIES = 1 << 20
DBS_RUN_ENTRIES = 1 << 17
DBS_SHARDS = 12
WIDE_RUN_ENTRIES = 1 << 18
# K3 on one output file's bloom: the seam's per-file shape
K3_FILE_ROWS = 1 << 21


_STARTED = time.time()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries the host-clock seconds
    since the script started (``elapsed_s``), so a run shows where its
    time went."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.time() - _STARTED, 1)}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 5):
    """Device time of one call of ``fn``: the time of every CUDA kernel,
    memset and copy torch.profiler records over ``calls`` calls after a
    warm-up, divided by ``calls``; None when it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / calls / 1e3 if total_us else None


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two lane tensors compared as unsigned."""
    import torch

    from rocksplicator_tpu_torch.ops.lanes import widen

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    if a.dtype == torch.bool:
        return int((a != b).any())
    if a.dtype == torch.int32:
        return int((widen(a) - widen(b)).abs().max())
    return int((a.long() - b.long()).abs().max())


def compare_outputs(got: dict, want: dict, what: str) -> int:
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys {sorted(got)} vs {sorted(want)}")
    worst = 0
    for k in want:
        err = max_abs_err(got[k], want[k])
        if err:
            raise AssertionError(f"{what}: output {k!r} differs from the "
                                 f"plain version (max abs err {err})")
        worst = max(worst, err)
    return worst


def _kernel_group(name: str) -> str:
    if "tile_sort" in name or "merge_pass" in name:
        return "K2 sort (tile sort, merge passes)"
    if "build_keys" in name:
        return "K2 key build"
    if "resolve_compact" in name:
        return "K2 resolve + scans + compact"
    if "bloom_global_kernel" in name or "bloom_rowwise_kernel" in name:
        return "K3 bloom build"
    if "memset" in name.lower():
        return "memsets (K2 status words, torch fills)"
    return "torch ops (planar encode, checksums, fills)"


def profile_shards(shards, forward_ms: float) -> dict:
    """torch.profiler over one forward of each bench shard (fused
    backend): device time by kernel name and group, and the device's idle
    share twice: between the first kernel start and the last kernel end of
    the profiled window (the profiler's own host work widens the gaps), and
    against ``forward_ms``, one forward's CUDA-event time without the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for model, args in shards:
        model.sort_backend = "fused"
        model(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for model, args in shards:
            model(*args)
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    if not spans:
        return {"device_time_us": "not measured"}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    groups: dict = {}
    for n, t in by_name.items():
        g = _kernel_group(n)
        groups[g] = groups.get(g, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy_per_forward_ms = busy / len(shards) / 1e3
    return {"forwards": len(shards), "device_kernels": len(spans),
            "device_busy_us": busy, "device_window_us": window,
            "device_idle_share_profiled": (1 - busy / window if window
                                           else None),
            "forward_event_ms": forward_ms,
            "device_idle_share_event": 1 - busy_per_forward_ms / forward_ms,
            "groups_us": groups,
            "top_kernels_us": [[n[:80], t] for n, t in top]}


def counter_runs(n_runs: int, run_entries: int, key_space: int, seed: int):
    """Lanes of ``n_runs`` sorted runs of the counter service's traffic:
    ``run_entries`` distinct 16-byte keys each ("counter:" + a big-endian
    id below ``key_space``), 60% MERGE / 30% PUT / 10% DELETE, 8-byte
    little-endian values, and disjoint seq ranges, newer runs later (the
    engine's run invariant)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    runs = []
    for r in range(n_runs):
        n = run_entries
        ids = np.sort(rng.choice(key_space, n, replace=False)).astype(
            np.uint64)
        kw_be = np.zeros((n, 6), dtype=np.uint32)
        kw_be[:, 0], kw_be[:, 1] = 0x636F756E, 0x7465723A  # b"counter:"
        kw_be[:, 2] = (ids >> np.uint64(32)).astype(np.uint32)
        kw_be[:, 3] = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        vtype = rng.choice(np.array([3, 1, 2], dtype=np.uint32), n,
                           p=[0.6, 0.3, 0.1])
        vals = np.where(vtype == 3, rng.integers(0, 1000, n),
                        rng.integers(0, 1 << 40, n)).astype(np.int64)
        vals[vtype == 2] = 0
        runs.append({
            "key_words_be": kw_be,
            "key_words_le": kw_be.byteswap(),
            "key_len": np.full(n, 16, dtype=np.uint32),
            "seq_hi": np.zeros(n, dtype=np.uint32),
            "seq_lo": (r * n + 1 + rng.permutation(n)).astype(np.uint32),
            "vtype": vtype,
            "val_words": np.stack([vals & 0xFFFFFFFF, vals >> 32],
                                  axis=1).astype(np.uint32),
            "val_len": np.where(vtype == 2, 0, 8).astype(np.uint32),
        })
    return runs


def _kv_batch(lanes: dict):
    import numpy as np

    from rocksplicator_tpu_torch.ops.kv_format import KVBatch

    n = lanes["key_len"].shape[0]
    return KVBatch(valid=np.ones(n, dtype=bool), val_bytes=8, **lanes)


def _concat_lanes(runs) -> dict:
    import numpy as np

    return {f: np.concatenate([r[f] for r in runs]) for f in runs[0]}


def _sort_flag(flag) -> None:
    """Set the ``sort_backend`` flag the engine seam and the batched
    service read (None: its default)."""
    from rocksplicator_tpu_torch.ops import compaction_kernel  # noqa: F401
    from rocksplicator_tpu_torch.utils.flags import FLAGS

    if flag is None:
        FLAGS.reset("sort_backend")
    else:
        FLAGS.set("sort_backend", flag)


SEAM_FLAGS = {"fused": "pallas_fused", "bitonic": "pallas"}


def engine_seam_known_answers(dev, entries, expect) -> dict:
    """GpuCompactionBackend.merge_runs on the hand-made entries under both
    sort backends, then on the two CPU routes (a 32-byte key, MERGE
    without an operator), which must launch no kernel."""
    import torch

    from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.records import OpType

    pk = struct.Struct("<q").pack
    backend = GpuCompactionBackend(device=dev)
    launches = {}
    for name, flag in SEAM_FLAGS.items():
        _sort_flag(flag)
        torch.cuda.synchronize()
        _build.reset_launches()
        got = [(k, vt, v) for k, _s, vt, v in backend.merge_runs(
            [entries[0::2], entries[1::2]], UInt64AddOperator(), True)]
        launches[name] = dict(_build.LAUNCHES)
        if got != expect:
            raise AssertionError(f"engine seam known answers [{name}]: {got}")
    if not (launches["fused"]["fused_resolve"] >= 1
            and launches["bitonic"]["bitonic_sort"] >= 1):
        raise AssertionError(f"engine seam known answers: {launches}")
    long_key = b"k" * 32
    cpu_routes = {
        "key_over_24_bytes": (
            [[(long_key, 2, OpType.MERGE, pk(2))],
             [(long_key, 1, OpType.PUT, pk(1))]], UInt64AddOperator(),
            [(long_key, OpType.PUT, pk(3))]),
        "merge_without_operator": (
            [[(b"m", 2, OpType.MERGE, b"b"), (b"p", 4, OpType.MERGE, b"d")],
             [(b"m", 1, OpType.PUT, b"a"), (b"p", 3, OpType.MERGE, b"c")]],
            None, [(b"m", OpType.PUT, b"a"), (b"p", OpType.MERGE, b"d"),
                   (b"p", OpType.MERGE, b"c")]),
    }
    for route, (runs, op, want) in cpu_routes.items():
        _build.reset_launches()
        got = [(k, vt, v) for k, _s, vt, v in backend.merge_runs(
            runs, op, True)]
        if got != want:
            raise AssertionError(f"engine seam CPU route {route}: {got}")
        if any(_build.LAUNCHES.values()):
            raise AssertionError(f"engine seam CPU route {route} launched "
                                 f"{_build.LAUNCHES}")
    return {"launches": launches, "cpu_routes": sorted(cpu_routes)}


def engine_seam_job(dev, work_dir: str, card: str) -> tuple:
    """The counter service's compaction job at the single-launch limit:
    4 runs of 2^20 entries written as planar SST files, merged by
    GpuCompactionBackend.merge_runs_to_files under both sort backends at
    DBOptions' defaults, and once more with max_subcompactions = 4 (K2
    over the four key-range slices in one batched call). Every output file
    must equal, byte for byte, the file the same sink writes from
    numpy_merge_resolve's output with a host-built bloom. Returns (report,
    launches by backend, the subcompaction's report, its launches)."""
    import os

    import torch

    from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
    from rocksplicator_tpu_torch.gpu import compaction_service
    from rocksplicator_tpu_torch.gpu.backend import numpy_merge_resolve
    from rocksplicator_tpu_torch.gpu.compaction_service import (
        GpuCompactionService)
    from rocksplicator_tpu_torch.gpu.format import (planar_stride,
                                                    write_sst_from_arrays)
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.sst import (COMPRESSION_ZLIB,
                                                     SSTReader)

    block_bytes, bits_per_key = 32 * 1024, 10
    target = SEAM_TARGET_FILE_BYTES
    block_entries = block_bytes // planar_stride(16, 8)
    n_in = 4 * SEAM_RUN_ENTRIES
    t0 = time.time()
    # a key space as large as the job: about 68% of the keys are distinct
    # and most of those survive, more than one output file holds
    runs = counter_runs(4, SEAM_RUN_ENTRIES, n_in, seed=42)
    inputs = []
    for r, lanes in enumerate(runs):
        path = os.path.join(work_dir, f"in{r}.tsst")
        write_sst_from_arrays(lanes, lanes["key_len"].shape[0], path,
                              block_entries=block_entries,
                              compression=COMPRESSION_ZLIB,
                              bits_per_key=bits_per_key, planar=True)
        inputs.append(path)
    write_inputs_s = time.time() - t0

    t0 = time.time()
    out, count = numpy_merge_resolve(_kv_batch(_concat_lanes(runs)), True,
                                     True)
    fields = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
              "val_words", "val_len")
    want = dict(zip(fields, out))
    per_file = max(1024, target // planar_stride(16, 8))
    want_files = []
    for i, start in enumerate(range(0, count, per_file)):
        end = min(start + per_file, count)
        path = os.path.join(work_dir, f"want{i}.tsst")
        write_sst_from_arrays({f: a[start:end] for f, a in want.items()},
                              end - start, path,
                              block_entries=block_entries,
                              compression=COMPRESSION_ZLIB,
                              bits_per_key=bits_per_key, planar=True)
        want_files.append(path)
    reference_s = time.time() - t0
    if len(want_files) < 2:
        raise AssertionError(f"engine seam job: {count} entries fit one file")

    report = {"entries_in": n_in, "runs": 4, "entries_out": count,
              "files": len(want_files), "block_entries": block_entries,
              "write_inputs_s": write_inputs_s,
              "numpy_reference_s": reference_s, "backends": {}}
    launches = {}
    variants = [(name, flag, 1) for name, flag in SEAM_FLAGS.items()]
    variants.append(("subcompact", SEAM_FLAGS["fused"], 4))
    # the slices the backend hands the service, counted as they pass, to
    # hold the port's compaction.subcompactions counter against
    resolve_on_device = compaction_service.resolve_slices_on_device
    slices_seen = []

    def counting_resolve(slices, *args, **kwargs):
        slices_seen.append(sum(
            1 for pieces in slices
            if sum(p["key_len"].shape[0] for p in pieces)))
        return resolve_on_device(slices, *args, **kwargs)

    for name, flag, subcompactions in variants:
        _sort_flag(flag)
        readers = [SSTReader(p) for p in inputs]
        made = []

        def path_factory():
            made.append(os.path.join(work_dir, f"{name}{len(made)}.tsst"))
            return made[-1]

        backend = GpuCompactionBackend(device=dev)
        compaction_service.resolve_slices_on_device = counting_resolve
        try:
            torch.cuda.synchronize()
            reset_observability()
            _build.reset_launches()
            t0 = time.time()
            outs = backend.merge_runs_to_files(
                readers, UInt64AddOperator(), True, path_factory,
                block_bytes, COMPRESSION_ZLIB, bits_per_key, target,
                max_subcompactions=subcompactions)
            torch.cuda.synchronize()
            seconds = time.time() - t0
            launches[name] = dict(_build.LAUNCHES)
            subcompactions_counted = read_counters(
                ("compaction.subcompactions",))["subcompactions"]
        finally:
            compaction_service.resolve_slices_on_device = resolve_on_device
            for r in readers:
                r.close()
        if outs is None or [p for p, _ in outs] != made:
            raise AssertionError(f"engine seam job [{name}]: sink declined "
                                 f"({outs})")
        for (path, props), ref in zip(outs, want_files):
            with open(path, "rb") as a, open(ref, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"engine seam job [{name}]: {path} "
                                         f"differs from {ref}")
        if len(outs) != len(want_files) or sum(
                p["num_entries"] for _, p in outs) != count:
            raise AssertionError(f"engine seam job [{name}]: {len(outs)} "
                                 f"files, want {len(want_files)}")
        merge_kernel = "bitonic_sort" if name == "bitonic" else (
            "fused_resolve")
        if (launches[name][merge_kernel] < 1
                or launches[name]["bloom_build"] != len(outs)):
            raise AssertionError(f"engine seam job [{name}]: launches "
                                 f"{launches[name]}")
        if name == "subcompact" and (
                launches[name]["fused_resolve"] != 1
                or "subcompact" not in backend.last_stage_seconds):
            raise AssertionError(f"engine seam subcompact: not one batched "
                                 f"K2 call ({launches[name]}, "
                                 f"{backend.last_stage_seconds})")
        # no slice may reach the file through the host recompute
        if name == "subcompact" and GpuCompactionService.instance(
                dev).last_host_recomputes:
            raise AssertionError("engine seam subcompact: a slice was "
                                 "recomputed on the host")
        # the port's counter: one a non-empty slice, none unsliced
        want_counted = slices_seen[0] if name == "subcompact" else 0
        if (name == "subcompact" and (len(slices_seen) != 1
                                      or slices_seen[0] < 2)) \
                or subcompactions_counted != want_counted:
            raise AssertionError(
                f"engine seam job [{name}]: compaction.subcompactions "
                f"{subcompactions_counted}, non-empty slices {slices_seen}")
        for path in made:
            os.remove(path)
        report["backends"][name] = {
            "launches": launches[name], "seconds": seconds,
            "entries_per_s": n_in / seconds,
            "stage_seconds": backend.last_stage_seconds,
            "subcompactions_counted": subcompactions_counted,
            "identical_files": len(outs)}
    sub = report["backends"].pop("subcompact")
    sub_launches = launches.pop("subcompact")
    return ({"card": card, **report}, launches,
            {"card": card, "entries_in": n_in, "entries_out": count,
             "max_subcompactions": 4, **sub}, sub_launches)


def engine_seam_chunked(dev, card: str) -> tuple:
    """gpu.chunked.chunked_merge over 8 runs of 2^20 entries at the
    backend's shapes (chunks of 2^20, launches of 2^22), against
    numpy_merge_resolve over the concatenation."""
    import numpy as np
    import torch

    from rocksplicator_tpu_torch.gpu import backend as gpu_backend
    from rocksplicator_tpu_torch.gpu.backend import numpy_merge_resolve
    from rocksplicator_tpu_torch.gpu.chunked import chunked_merge
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.ops.compaction_kernel import MergeKind

    # a key space of two runs: four runs' summary fits half a launch, so
    # the two folds of four runs each meet in one last launch
    runs = counter_runs(8, SEAM_RUN_ENTRIES, 2 * SEAM_RUN_ENTRIES, seed=43)
    batches = [_kv_batch(r) for r in runs]
    _sort_flag(SEAM_FLAGS["fused"])
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    result = chunked_merge(batches, MergeKind.UINT64_ADD, True,
                           chunk_entries=gpu_backend.MAX_LAUNCH_ENTRIES // 4,
                           launch_entries=gpu_backend.MAX_LAUNCH_ENTRIES,
                           device=dev)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(_build.LAUNCHES)
    if result is None:
        raise AssertionError("engine seam chunked: no result")
    got, count = result
    t0 = time.time()
    want, want_count = numpy_merge_resolve(_kv_batch(_concat_lanes(runs)),
                                           True, True)
    reference_s = time.time() - t0
    if count != want_count:
        raise AssertionError(f"engine seam chunked: {count} entries, want "
                             f"{want_count}")
    fields = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
              "val_words", "val_len")
    for f, w in zip(fields, want):
        if not np.array_equal(got[f], w):
            raise AssertionError(f"engine seam chunked: {f} differs")
    if not np.array_equal(got["key_words_le"], got["key_words_be"].byteswap()):
        raise AssertionError("engine seam chunked: key_words_le differs")
    if launches["fused_resolve"] < 3:
        raise AssertionError(f"engine seam chunked: launches {launches}")
    return {"card": card, "runs": 8, "entries_in": 8 * SEAM_RUN_ENTRIES,
            "entries_out": count, "launches": launches, "seconds": seconds,
            "entries_per_s": 8 * SEAM_RUN_ENTRIES / seconds,
            "numpy_reference_s": reference_s, "max_abs_err": 0}, launches


def wide_runs(n_runs: int, run_entries: int, key_space: int, seed: int,
              val_words: int) -> list:
    """Lanes of ``n_runs`` sorted runs with no merge operator: distinct
    16-byte keys per run, 85% PUT of ``4 * val_words``-byte values and 15%
    DELETE, disjoint seq ranges, newer runs later."""
    import numpy as np

    runs = counter_runs(n_runs, run_entries, key_space, seed)
    rng = np.random.default_rng(seed + 1)
    for lanes in runs:
        n = lanes["key_len"].shape[0]
        vtype = np.where(rng.random(n) < 0.85, 1, 2).astype(np.uint32)
        words = rng.integers(0, 1 << 32, (n, val_words),
                             dtype=np.uint64).astype(np.uint32)
        words[vtype == 2] = 0
        lanes.update(vtype=vtype, val_words=words,
                     val_len=np.where(vtype == 2, 0, 4 * val_words).astype(
                         np.uint32))
    return runs


def _write_runs(runs, work_dir: str, tag: str, block_entries: int) -> list:
    import os

    from rocksplicator_tpu_torch.gpu.format import write_sst_from_arrays
    from rocksplicator_tpu_torch.storage.sst import COMPRESSION_ZLIB

    paths = []
    for r, lanes in enumerate(runs):
        path = os.path.join(work_dir, f"{tag}_in{r}.tsst")
        write_sst_from_arrays(lanes, lanes["key_len"].shape[0], path,
                              block_entries=block_entries,
                              compression=COMPRESSION_ZLIB, bits_per_key=10,
                              planar=True)
        paths.append(path)
    return paths


def _numpy_files(lanes: dict, uint64_add: bool, work_dir: str, tag: str,
                 target: int, block_bytes: int) -> tuple:
    """The files the planar sink writes from numpy_merge_resolve's output
    over ``lanes``, each with a host-built bloom: (paths, count)."""
    import os

    from rocksplicator_tpu_torch.gpu.backend import numpy_merge_resolve
    from rocksplicator_tpu_torch.gpu.format import (planar_stride,
                                                    planar_widths,
                                                    write_sst_from_arrays)
    from rocksplicator_tpu_torch.storage.sst import COMPRESSION_ZLIB

    out, count = numpy_merge_resolve(_kv_batch(lanes), uint64_add, True)
    fields = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
              "val_words", "val_len")
    want = dict(zip(fields, out))
    stride = planar_stride(*planar_widths(want, count))
    per_file = max(1024, target // stride)
    block_entries = max(64, block_bytes // stride)
    paths = []
    for i, start in enumerate(range(0, count, per_file)):
        end = min(start + per_file, count)
        path = os.path.join(work_dir, f"{tag}_want{i}.tsst")
        write_sst_from_arrays({f: a[start:end] for f, a in want.items()},
                              end - start, path, block_entries=block_entries,
                              compression=COMPRESSION_ZLIB, bits_per_key=10,
                              planar=True)
        paths.append(path)
    return paths, count


def _same_files(got: list, want: list, what: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} files, want {len(want)}")
    for g, w in zip(got, want):
        with open(g, "rb") as a, open(w, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{what}: {g} differs from {w}")


def engine_seam_wide(dev, work_dir: str, card: str) -> tuple:
    """Planar runs with 16-byte keys and 64-byte values (W = 16 value words
    through the sort) and no merge operator, merged by
    GpuCompactionBackend.merge_runs_to_files: the planar files must equal
    the numpy-resolved sink's byte for byte, and nothing may raise."""
    import os

    import torch

    from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
    from rocksplicator_tpu_torch.gpu.format import planar_stride
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.storage.sst import (COMPRESSION_ZLIB,
                                                     SSTReader)

    block_bytes, target = 32 * 1024, SEAM_TARGET_FILE_BYTES
    n_in = 4 * WIDE_RUN_ENTRIES
    runs = wide_runs(4, WIDE_RUN_ENTRIES, n_in, seed=44, val_words=16)
    inputs = _write_runs(runs, work_dir, "wide",
                         block_bytes // planar_stride(16, 64))
    want, count = _numpy_files(_concat_lanes(runs), False, work_dir, "wide",
                               target, block_bytes)
    _sort_flag(SEAM_FLAGS["fused"])
    readers = [SSTReader(p) for p in inputs]
    made = []

    def path_factory():
        made.append(os.path.join(work_dir, f"wide_out{len(made)}.tsst"))
        return made[-1]

    backend = GpuCompactionBackend(device=dev)
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.time()
        outs = backend.merge_runs_to_files(
            readers, None, True, path_factory, block_bytes,
            COMPRESSION_ZLIB, 10, target)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        for r in readers:
            r.close()
    if outs is None or [p for p, _ in outs] != made:
        raise AssertionError(f"engine seam wide: sink declined ({outs})")
    if any(not p["planar"] for _, p in outs):
        raise AssertionError("engine seam wide: a row-format file")
    _same_files(made, want, "engine seam wide")
    if launches["fused_resolve"] != 1 or launches["bloom_build"] != len(outs):
        raise AssertionError(f"engine seam wide: launches {launches}")
    return {"card": card, "runs": 4, "entries_in": n_in,
            "entries_out": count, "key_bytes": 16, "value_bytes": 64,
            "files": len(outs), "identical_files": len(outs),
            "launches": launches, "seconds": seconds,
            "stage_seconds": backend.last_stage_seconds}, launches


def _stream_mode(mode) -> None:
    """Set the port's streaming-merge mode (None: its environment's)."""
    from rocksplicator_tpu_torch.storage import stream_merge

    stream_merge.STREAM_MODE_OVERRIDE = mode


def reset_observability() -> None:
    """Before a phase: zero the port's Stats, empty its span collector
    (every root sampled, so a phase's spans are all kept) and disarm its
    failpoints."""
    from rocksplicator_tpu_torch.observability.collector import SpanCollector
    from rocksplicator_tpu_torch.testing import failpoints as fp
    from rocksplicator_tpu_torch.utils.stats import Stats

    Stats.reset_for_test()
    SpanCollector.reset_for_test()
    SpanCollector.get().configure(sample_rate=1.0)
    fp.reset_for_test()


STREAM_COUNTERS = ("compaction.stream_chunks", "compaction.stream_merges",
                   "compaction.stream_refills", "compaction.stream_declines")


def read_counters(names=STREAM_COUNTERS) -> dict:
    """The port's Stats counters of ``names``, as ints."""
    from rocksplicator_tpu_torch.utils.stats import Stats

    stats = Stats.get()
    return {n.split(".", 1)[1]: int(stats.get_counter(n)) for n in names}


def read_spans() -> list:
    """Every span the port's collector kept, oldest first."""
    from rocksplicator_tpu_torch.observability.collector import SpanCollector

    return SpanCollector.get().snapshot()


def instrumentation_cost(calls: int = 200_000) -> dict:
    """Host microseconds a call of the instrumentation the port's
    streaming merge runs per chunk and per refill: an unarmed
    ``fp.hit``, a ``Stats.incr``, and a kept child span under a kept
    root."""
    from rocksplicator_tpu_torch.observability.span import start_span
    from rocksplicator_tpu_torch.testing import failpoints as fp
    from rocksplicator_tpu_torch.utils.stats import Stats

    reset_observability()
    stats = Stats.get()
    out = {}
    t0 = time.perf_counter()
    for _ in range(calls):
        fp.hit("compact.stream.chunk")
    out["fp_hit_us"] = (time.perf_counter() - t0) / calls * 1e6
    t0 = time.perf_counter()
    for _ in range(calls):
        stats.incr("compaction.stream_chunks")
    out["stats_incr_us"] = (time.perf_counter() - t0) / calls * 1e6
    spans = calls // 100
    with start_span("cost.root", always=True):
        t0 = time.perf_counter()
        for _ in range(spans):
            with start_span("cost.child"):
                pass
        out["child_span_us"] = (time.perf_counter() - t0) / spans * 1e6
    reset_observability()
    return out


def _streamed(backend, readers, path_factory, tracker, budget: int = 0):
    """One merge_runs_to_files call that must stream: (outputs, seconds,
    launches, the port's stream counters of the call)."""
    import torch

    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.sst import COMPRESSION_ZLIB

    torch.cuda.synchronize()
    reset_observability()
    _build.reset_launches()
    t0 = time.time()
    outs = backend.merge_runs_to_files(
        readers, UInt64AddOperator(), True, path_factory, 32 * 1024,
        COMPRESSION_ZLIB, 10, SEAM_TARGET_FILE_BYTES, mem_tracker=tracker,
        memory_budget_bytes=budget)
    torch.cuda.synchronize()
    return outs, time.time() - t0, dict(_build.LAUNCHES), read_counters()


def _check_stream(what: str, outs, made: list, want: list, backend,
                  tracker, peak_limit: int, launches: dict,
                  merge_kernel: str, counters: dict) -> None:
    """Streamed with no decline, one merge launch per chunk, the port's
    counters agreeing (a chunk and a launch per stream_chunks, one
    stream_merges, no stream_declines), the peak within ``peak_limit``,
    the files of the reference."""
    if outs is None or [p for p, _ in outs] != made:
        raise AssertionError(f"{what}: the stream declined ({outs})")
    chunks = backend.last_stream_chunks
    if chunks < 2 or launches[merge_kernel] != chunks:
        raise AssertionError(f"{what}: {chunks} chunks, launches {launches}")
    if (counters["stream_chunks"] != chunks or counters["stream_merges"] != 1
            or counters["stream_declines"] != 0
            or counters["stream_refills"] < 4):
        raise AssertionError(f"{what}: counters {counters}, {chunks} chunks")
    spans = [d for d in read_spans() if d["name"] == "compact.stream"]
    if len(spans) != 1 or spans[0]["annotations"]["runs"] != 4:
        raise AssertionError(f"{what}: compact.stream spans {spans}")
    if not 0 < tracker.peak <= peak_limit:
        raise AssertionError(f"{what}: peak {tracker.peak} bytes, limit "
                             f"{peak_limit}")
    _same_files(made, want, what)


def engine_seam_stream(dev, work_dir: str, card: str) -> tuple:
    """A job the in-RAM route cannot take: 4 planar SST runs of 2^21
    counter entries (2^23 entries, twice the single-launch limit) merged
    by GpuCompactionBackend.merge_runs_to_files in auto mode under the
    default 256 MiB budget, under both sort backends. It must stream with
    no decline, one K2 call (K1 under pallas) per chunk, a peak within the
    budget, and files byte-identical to the same stream resolved by
    CpuChunkResolver (numpy). Returns (report, launches by backend)."""
    import os

    from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
    from rocksplicator_tpu_torch.gpu.format import planar_stride
    from rocksplicator_tpu_torch.storage import stream_merge
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.sst import (COMPRESSION_ZLIB,
                                                     SSTReader)

    n_in = 4 * STREAM_RUN_ENTRIES
    t0 = time.time()
    runs = counter_runs(4, STREAM_RUN_ENTRIES, n_in, seed=45)
    inputs = _write_runs(runs, work_dir, "stream",
                         32 * 1024 // planar_stride(16, 8))
    del runs
    write_inputs_s = time.time() - t0
    budget = stream_merge.CompactionMemoryBudget.get().budget_bytes

    def outputs(tag):
        made = []

        def path_factory():
            made.append(os.path.join(work_dir, f"{tag}{len(made)}.tsst"))
            return made[-1]

        return made, path_factory

    readers = [SSTReader(p) for p in inputs]
    try:
        want, pf = outputs("stream_want")
        tracker = stream_merge.CompactionMemoryBudget.get().tracker()
        report = {}
        reset_observability()
        t0 = time.time()
        got = stream_merge.maybe_stream_merge(
            readers, UInt64AddOperator(), True, pf, 32 * 1024,
            COMPRESSION_ZLIB, 10, SEAM_TARGET_FILE_BYTES,
            mem_tracker=tracker, resolver=stream_merge.CpuChunkResolver(),
            report=report)
        reference_s = time.time() - t0
        if got is None or len(want) < 2:
            raise AssertionError(f"engine seam stream: the numpy stream "
                                 f"wrote {want}")
        numpy_counters = read_counters()
        if (numpy_counters["stream_chunks"] != report["chunks"]
                or numpy_counters["stream_merges"] != 1):
            raise AssertionError(f"engine seam stream: the numpy stream's "
                                 f"counters {numpy_counters}, "
                                 f"{report['chunks']} chunks")
        result = {"card": card, "runs": 4, "entries_in": n_in,
                  "entries_out": sum(p["num_entries"] for _, p in got),
                  "files": len(want), "budget_bytes": budget,
                  "write_inputs_s": write_inputs_s,
                  "numpy_stream_s": reference_s,
                  "numpy_stream_chunks": report["chunks"],
                  "numpy_stream_counters": numpy_counters,
                  "numpy_stream_peak_bytes": tracker.peak, "backends": {}}
        launches = {}
        for name, flag in SEAM_FLAGS.items():
            _sort_flag(flag)
            made, pf = outputs(f"stream_{name}")
            backend = GpuCompactionBackend(device=dev)
            tracker = stream_merge.CompactionMemoryBudget.get().tracker()
            outs, seconds, launches[name], counters = _streamed(
                backend, readers, pf, tracker)
            merge_kernel = ("bitonic_sort" if name == "bitonic"
                            else "fused_resolve")
            _check_stream(f"engine seam stream [{name}]", outs, made, want,
                          backend, tracker, budget, launches[name],
                          merge_kernel, counters)
            result["backends"][name] = {
                "chunks": backend.last_stream_chunks, "counters": counters,
                "peak_bytes": tracker.peak, "seconds": seconds,
                "entries_per_s": n_in / seconds,
                "stage_seconds": backend.last_stage_seconds,
                "launches": launches[name], "identical_files": len(made)}
            for path in made:
                os.remove(path)
    finally:
        for r in readers:
            r.close()
    return result, launches


def engine_seam_stream_budget(dev, work_dir: str, card: str) -> tuple:
    """engine_seam_job's four 2^20-entry runs (its inputs and in-RAM
    reference files, left in ``work_dir``) under a 32 MiB budget: the
    stream must write the in-RAM route's files. The sink holds one output
    file's lanes before it writes the file (the reference's sink does
    too), about 100 MB for a 64 MiB planar file of 16-byte keys, more than
    the budget: the windows degrade to their floor and the peak may pass
    the budget by that buffer and no more."""
    import os

    from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
    from rocksplicator_tpu_torch.gpu.format import planar_stride
    from rocksplicator_tpu_torch.storage import stream_merge
    from rocksplicator_tpu_torch.storage.sst import SSTReader

    budget = STREAM_BUDGET_BYTES
    # the sink's file buffer: one file's rows of the CPU lanes (6 key
    # words, 5 scalar lanes, 2 value words)
    file_rows = max(1024, SEAM_TARGET_FILE_BYTES // planar_stride(16, 8))
    sink_bytes = file_rows * 4 * (6 + 5 + 2)
    inputs = [os.path.join(work_dir, f"in{r}.tsst") for r in range(4)]
    want = sorted((os.path.join(work_dir, f) for f in os.listdir(work_dir)
                   if f.startswith("want")),
                  key=lambda p: int(p[len(work_dir) + 5:-5]))
    made = []

    def path_factory():
        made.append(os.path.join(work_dir, f"budget{len(made)}.tsst"))
        return made[-1]

    _sort_flag(SEAM_FLAGS["fused"])
    backend = GpuCompactionBackend(device=dev)
    tracker = stream_merge.CompactionMemoryBudget.get().tracker()
    readers = [SSTReader(p) for p in inputs]
    try:
        outs, seconds, launches, counters = _streamed(
            backend, readers, path_factory, tracker, budget)
    finally:
        for r in readers:
            r.close()
    _check_stream("engine seam stream budget", outs, made, want, backend,
                  tracker, budget + sink_bytes, launches, "fused_resolve",
                  counters)
    for path in made:
        os.remove(path)
    return {"card": card, "runs": 4, "entries_in": 4 * SEAM_RUN_ENTRIES,
            "budget_bytes": budget, "sink_file_buffer_bytes": sink_bytes,
            "peak_bytes": tracker.peak,
            "peak_over_budget_bytes": tracker.peak - budget,
            "chunks": backend.last_stream_chunks, "counters": counters,
            "seconds": seconds,
            "entries_per_s": 4 * SEAM_RUN_ENTRIES / seconds,
            "stage_seconds": backend.last_stage_seconds,
            "launches": launches, "identical_files": len(made)}, launches


def service_batch(dev, card: str) -> tuple:
    """GpuCompactionService.compact_shard_batch over 8 shards of 2^20
    counter entries (return_arrays): one K2 and one K3 call; every shard's
    lanes, count and bloom words equal to numpy_merge_resolve's and the
    host bloom's."""
    import numpy as np
    import torch

    from rocksplicator_tpu_torch.gpu.backend import numpy_merge_resolve
    from rocksplicator_tpu_torch.gpu.compaction_service import (
        GpuCompactionService)
    from rocksplicator_tpu_torch.models.compaction_model import (
        synth_counter_batch)
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.ops.kv_format import KVBatch
    from rocksplicator_tpu_torch.storage.bloom import (hash_words,
                                                      num_words_for)

    batches = [KVBatch(val_bytes=8, **synth_counter_batch(
        SERVICE_ENTRIES, seed=300 + s)) for s in range(BENCH_SHARDS)]
    svc = GpuCompactionService(device=dev, sort_backend="fused")
    svc.compact_shard_batch(batches[:1], return_arrays=True)  # warm-up
    torch.cuda.synchronize()
    reset_observability()
    _build.reset_launches()
    t0 = time.time()
    results = svc.compact_shard_batch(batches, return_arrays=True)
    seconds = time.time() - t0
    launches = dict(_build.LAUNCHES)
    stages = dict(svc.last_stage_seconds)
    if launches["fused_resolve"] != 1 or launches["bloom_build"] != 1:
        raise AssertionError(f"service batch: launches {launches}")
    # the JAX package's trace shape: one always-kept root and its three
    # stage children, no cpu_fallbacks annotation
    spans = read_spans()
    roots = [d for d in spans if d["name"] == "tpu.compact_batch"]
    if len(roots) != 1 or roots[0]["parent_id"] is not None or roots[0][
            "annotations"] != {"shards": len(batches),
                               "capacity": SERVICE_ENTRIES}:
        raise AssertionError(f"service batch: root spans {roots}")
    children = sorted(d["name"] for d in spans
                      if d["parent_id"] == roots[0]["span_id"])
    if children != ["tpu.kernel", "tpu.stage", "tpu.unpack"] \
            or len(spans) != 4:
        raise AssertionError(f"service batch: spans {spans}")
    # every shard must come from K2, none from the host recompute
    if svc.last_host_recomputes:
        raise AssertionError(f"service batch: {svc.last_host_recomputes} "
                             f"shards recomputed on the host")
    t0 = time.time()
    num_words = num_words_for(SERVICE_ENTRIES, 10)
    fields = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
              "val_words", "val_len")
    counts = []
    for s, (batch, res) in enumerate(zip(batches, results)):
        out, count = numpy_merge_resolve(batch, True, True)
        words = np.zeros(num_words, dtype=np.uint32)
        h1, mask = hash_words(out[0].byteswap(), out[1])
        np.bitwise_or.at(words, h1 % np.uint32(num_words), mask)
        if res["count"] != count:
            raise AssertionError(f"service batch shard {s}: count "
                                 f"{res['count']}, want {count}")
        for f, w in zip(fields, out):
            if not np.array_equal(res["arrays"][f], w):
                raise AssertionError(f"service batch shard {s}: {f}")
        if not np.array_equal(res["arrays"]["key_words_le"],
                              out[0].byteswap()):
            raise AssertionError(f"service batch shard {s}: key_words_le")
        if not np.array_equal(res["bloom_words"], words):
            raise AssertionError(f"service batch shard {s}: bloom words")
        counts.append(count)
    return {"card": card, "shards": len(batches),
            "entries_per_shard": SERVICE_ENTRIES, "counts": counts,
            "launches": launches, "seconds": seconds,
            "entries_per_s": len(batches) * SERVICE_ENTRIES / seconds,
            "stage_seconds": stages,
            "spans": {d["name"]: d["duration_ms"] for d in spans},
            "numpy_reference_s": time.time() - t0, "max_abs_err": 0}, launches


class _StubDB:
    """The methods compact_dbs_batched calls on a DB (the JAX package's
    storage/engine.py:1784-1950: plan_full_compaction, allocate_sst,
    install_full_compaction, abort_full_compaction) over the port's SST
    reader, for a shard whose runs are planar files on disk; and a
    ``compact_range`` that raises, so a BatchCompactor's per-DB fallback
    cannot pass for the batched path."""

    def __init__(self, root: str, runs: list, options):
        self.options = options
        self._root = root
        self._runs = runs
        self.files = None
        self.aborted = False
        self._allocated = 0

    def plan_full_compaction(self) -> dict:
        from rocksplicator_tpu_torch.storage.sst import SSTReader

        return {"runs": [SSTReader(p) for p in self._runs],
                "drop_tombstones": True}

    def allocate_sst(self) -> tuple:
        import os

        self._allocated += 1
        name = f"out{self._allocated}.tsst"
        return name, os.path.join(self._root, name)

    def _close(self, plan) -> None:
        for r in plan["runs"]:
            r.close()

    def install_full_compaction(self, plan, files=None, entries=None):
        self._close(plan)
        if entries is not None:
            raise AssertionError("the tuple sink was taken")
        self.files = files

    def abort_full_compaction(self, plan):
        self._close(plan)
        self.aborted = True

    def compact_range(self):
        raise AssertionError(f"{self._root}: the per-DB fallback was taken")


def stub_db_inputs(work_dir: str) -> tuple:
    """12 stub DBs' inputs, each 4 planar SST runs of 2^17 counter entries
    (half a shard at MAX_BATCHED_DB_ENTRIES), and the files the numpy-resolved
    sink writes from them: ({name: (root, input paths)}, {name: reference
    files}, {name: entries out}, DB options, seconds)."""
    import os
    from types import SimpleNamespace

    from rocksplicator_tpu_torch.gpu.format import planar_stride
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.sst import COMPRESSION_ZLIB

    block_bytes, target = 32 * 1024, SEAM_TARGET_FILE_BYTES
    options = SimpleNamespace(
        merge_operator=UInt64AddOperator(), target_file_bytes=target,
        block_bytes=block_bytes, compression=COMPRESSION_ZLIB,
        bits_per_key=10)
    t0 = time.time()
    inputs, want, counts = {}, {}, {}
    for s in range(DBS_SHARDS):
        root = os.path.join(work_dir, f"db{s}")
        os.makedirs(root)
        runs = counter_runs(4, DBS_RUN_ENTRIES, 4 * DBS_RUN_ENTRIES,
                            seed=500 + s)
        inputs[f"db{s}"] = (root, _write_runs(
            runs, root, "run", block_bytes // planar_stride(16, 8)))
        want[f"db{s}"], counts[f"db{s}"] = _numpy_files(
            _concat_lanes(runs), True, root, "ref", target, block_bytes)
    return inputs, want, counts, options, time.time() - t0


def _stub_dbs(inputs: dict, options, tag: str) -> list:
    """Fresh stub DBs over ``inputs``, writing into ``<root>/<tag>``."""
    import os

    dbs = []
    for name, (root, runs) in inputs.items():
        os.makedirs(os.path.join(root, tag))
        dbs.append((name, _StubDB(os.path.join(root, tag), runs, options)))
    return dbs


def _check_db_files(dbs: list, want: dict, what: str) -> int:
    """Every DB's installed files equal its reference files; the count."""
    import os

    files = 0
    for name, db in dbs:
        if db.files is None:
            raise AssertionError(f"{what} {name}: nothing installed")
        got = [os.path.join(db._root, f) for f in db.files]
        _same_files(got, want[name], f"{what} {name}")
        files += len(got)
    return files


def service_dbs(dev, prepared: tuple, card: str) -> tuple:
    """compact_dbs_batched over the 12 stub DBs of ``stub_db_inputs``: the
    stream path runs a group of 8 and a group of 4 padded to 8, K2 twice.
    Every output file must equal the numpy-resolved sink's byte for byte;
    the port's trace holds one admin.compact_stage span, and one
    admin.compact_install span for the one (merge kind, tombstones) group
    of DBs."""
    import torch

    from rocksplicator_tpu_torch.gpu.compaction_service import (
        GpuCompactionService, compact_dbs_batched)
    from rocksplicator_tpu_torch.ops import _build

    inputs, want, counts, options, prepare_s = prepared
    dbs = _stub_dbs(inputs, options, "out")
    _sort_flag(SEAM_FLAGS["fused"])
    torch.cuda.synchronize()
    reset_observability()
    _build.reset_launches()
    t0 = time.time()
    handled, remaining = compact_dbs_batched(dbs, group_size=BENCH_SHARDS,
                                             device=dev)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(_build.LAUNCHES)
    if sorted(handled) != sorted(want) or remaining:
        raise AssertionError(f"service dbs: handled {handled}, remaining "
                             f"{[n for n, _ in remaining]}")
    files = _check_db_files(dbs, want, "service dbs")
    if launches["fused_resolve"] != 2 or launches["bloom_build"] != 2 + files:
        raise AssertionError(f"service dbs: launches {launches}")
    recomputes = GpuCompactionService.instance(dev).last_host_recomputes
    if recomputes:
        raise AssertionError(f"service dbs: {recomputes} shards recomputed "
                             f"on the host")
    spans = {}
    for d in read_spans():
        spans.setdefault(d["name"], []).append(d["annotations"])
    want_spans = {"admin.compact_stage": [{"shards": len(dbs)}],
                  "admin.compact_install": [{"shards": len(dbs)}],
                  "tpu.compact_stream": [{"shards": len(dbs),
                                          "group_size": BENCH_SHARDS}]}
    if spans != want_spans:
        raise AssertionError(f"service dbs: spans {spans}")
    return {"card": card, "dbs": len(dbs), "runs_per_db": 4,
            "entries_per_db": 4 * DBS_RUN_ENTRIES, "groups": [8, 4],
            "entries_out": sum(counts.values()), "files": files,
            "identical_files": files, "launches": launches,
            "seconds": seconds, "spans": spans,
            "entries_per_s": len(dbs) * 4 * DBS_RUN_ENTRIES / seconds,
            "prepare_s": prepare_s}, launches


def batch_compactor(dev, prepared: tuple, card: str) -> tuple:
    """The post-ingest caller: the same 12 stub DBs submitted to the port's
    BatchCompactor from 12 threads at once. The leader drains the queue in
    batches; each batch is one compact_dbs_batched call, a batch of more
    than 8 DBs two launch groups. K2 is called once a launch group and K3
    once a group plus once a file; every file equals the numpy-resolved
    sink's; no DB takes the per-DB fallback (the stubs' compact_range
    raises) and the port's admin logger records no error."""
    import logging
    import threading

    import torch

    from rocksplicator_tpu_torch.admin import BatchCompactor
    from rocksplicator_tpu_torch.ops import _build

    inputs, want, counts, options, _prepare_s = prepared
    dbs = _stub_dbs(inputs, options, "bc")
    errors = []

    class Errors(logging.Handler):
        def emit(self, record):
            errors.append(self.format(record))

    handler = Errors(logging.ERROR)
    admin_log = logging.getLogger("rocksplicator_tpu_torch.admin")
    admin_log.addHandler(handler)
    compactor = BatchCompactor(device=dev)
    start = threading.Barrier(len(dbs))
    rode, failed = {}, {}

    def submit(name, db):
        start.wait()
        try:
            rode[name] = compactor.compact(name, db)
        except Exception as exc:  # the phase fails on it below
            failed[name] = repr(exc)

    _sort_flag(SEAM_FLAGS["fused"])
    threads = [threading.Thread(target=submit, args=item) for item in dbs]
    try:
        torch.cuda.synchronize()
        reset_observability()
        _build.reset_launches()
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        compactor.close()
        admin_log.removeHandler(handler)
    if any(t.is_alive() for t in threads):
        raise AssertionError("batch compactor: a submitter still waits")
    if failed or errors or sorted(rode) != sorted(want):
        raise AssertionError(f"batch compactor: failed {failed}, admin "
                             f"errors {errors}, compacted {sorted(rode)}")
    sizes = list(compactor.batch_sizes)
    if sum(sizes) != len(dbs) or compactor.dispatch_count != len(sizes):
        raise AssertionError(f"batch compactor: batches {sizes}, dispatches "
                             f"{compactor.dispatch_count}")
    files = _check_db_files(dbs, want, "batch compactor")
    groups = sum(-(-b // BENCH_SHARDS) for b in sizes)
    if launches["fused_resolve"] != groups \
            or launches["bloom_build"] != groups + files:
        raise AssertionError(f"batch compactor: launches {launches}, "
                             f"batches {sizes}, {files} files")
    dispatches = [d["annotations"] for d in read_spans()
                  if d["name"] == "admin.compact_dispatch"]
    if sorted(a["shards"] for a in dispatches) != sorted(sizes):
        raise AssertionError(f"batch compactor: dispatch spans {dispatches}")
    return {"card": card, "dbs": len(dbs), "threads": len(dbs),
            "dispatch_count": compactor.dispatch_count,
            "batch_sizes": sizes, "launch_groups": groups, "files": files,
            "identical_files": files, "launches": launches,
            "entries_out": sum(counts.values()), "seconds": seconds,
            "entries_per_s": len(dbs) * 4 * DBS_RUN_ENTRIES / seconds,
            "per_db_fallbacks": 0}, launches


# ---- the port's storage engine on the card ---------------------------------
# engine_db (and remote_worker): 4 runs of this many counter ops, written
# through DB.write in WriteBatches of ENGINE_BATCH ops, one memtable flush
# a run; an eighth of one launch (MAX_TPU_ENTRIES) in all, to keep the
# command's time (half until the chip check stopped a command of 888.3 s
# at 1,200 s on a slower host of the same kind; a quarter until the chaos
# harness's reshard and rebalance decks came)
ENGINE_RUN_ENTRIES = 1 << 17
# remote_worker's job B: a quarter of the default 256 MiB compaction
# budget, so that the worker streams the eighth-launch job as it streamed
# the half-launch one under the default
REMOTE_B_BUDGET_BYTES = 64 << 20
# engine_db_background's runs: a quarter of MAX_TPU_ENTRIES, to keep the
# command's time, under a quarter of the default 256 MiB compaction
# budget, so that its compactions stream as they do at full depth under
# the default
ENGINE_BG_RUN_ENTRIES = 1 << 18
ENGINE_BG_BUDGET_BYTES = 64 << 20
ENGINE_BATCH = 1024
ENGINE_WRITERS = 4
# multi_get read-back in slices of this many keys
ENGINE_READ_SLICE = 1 << 16


def engine_traffic(seed: int = 700, run_entries: int = 0,
                   key_space: int = 0) -> dict:
    """The counter service's traffic of ``counter_runs`` as DB operations,
    4 runs of ``run_entries`` (default ENGINE_RUN_ENTRIES) each, over
    ``key_space`` ids (default twice a run):
    per run, 16-byte keys ("counter:" + a big-endian id), the op type
    (3 MERGE, 1 PUT, 2 DELETE) and 8-byte little-endian values, each run
    in a seeded random order; the memtable_bytes at which the engine
    flushes after each run's last batch; and the numpy oracle of every
    touched key's final value."""
    import numpy as np

    run_entries = run_entries or ENGINE_RUN_ENTRIES
    key_space = key_space or 2 * run_entries
    runs = counter_runs(4, run_entries, key_space, seed)
    rng = np.random.default_rng(seed + 1)
    ops = []
    oracle = _oracle(key_space)
    for lanes in runs:
        order = rng.permutation(run_entries)
        kw = lanes["key_words_be"][order]
        ids = ((kw[:, 2].astype(np.uint64) << np.uint64(32))
               | kw[:, 3].astype(np.uint64))
        vtype = lanes["vtype"][order]
        vals = ((lanes["val_words"][order, 1].astype(np.uint64)
                 << np.uint64(32))
                | lanes["val_words"][order, 0].astype(np.uint64))
        key_bytes = np.ascontiguousarray(kw[:, :4].astype(">u4")).tobytes()
        ops.append((ids, vtype, vals, key_bytes))
        _oracle_apply(oracle, ids, vtype, vals)
    # MemTable.approximate_bytes: key + value + 16 a record
    run_bytes = [int((32 + np.where(v == 2, 0, 8)).sum())
                 for _i, v, _x, _k in ops]
    last_batch = [int((32 + np.where(v[-ENGINE_BATCH:] == 2, 0, 8)).sum())
                  for _i, v, _x, _k in ops]
    memtable_bytes = min(run_bytes)
    if not all(b - last < memtable_bytes
               for b, last in zip(run_bytes, last_batch)):
        raise AssertionError("engine traffic: no memtable size flushes "
                             "once a run")
    return {"ops": ops, "memtable_bytes": memtable_bytes,
            "run_entries": run_entries,
            "touched": np.flatnonzero(oracle["touched"]).astype(np.uint64),
            "exists": oracle["exists"], "value": oracle["value"]}


def _oracle(key_space: int) -> dict:
    """A numpy oracle of the counter traffic over ``key_space`` ids."""
    import numpy as np

    return {"exists": np.zeros(key_space, dtype=bool),
            "touched": np.zeros(key_space, dtype=bool),
            "value": np.zeros(key_space, dtype=np.uint64)}


def _oracle_apply(state: dict, ids, vtype, vals) -> None:
    """Fold the ops of one run (keys distinct within a run) into an
    oracle."""
    import numpy as np

    exists, value = state["exists"], state["value"]
    put, dele, mrg = vtype == 1, vtype == 2, vtype == 3
    value[ids[put]] = vals[put]
    with np.errstate(over="ignore"):
        value[ids[mrg]] = np.where(exists[ids[mrg]], value[ids[mrg]],
                                   np.uint64(0)) + vals[mrg]
    exists[ids[put | mrg]] = True
    exists[ids[dele]] = False
    state["touched"][ids] = True


def _card_backend(dev):
    """A DB's compaction backend on ``dev``: None (the port's default, the
    card) for a CUDA device; named where the script is rehearsed on the
    CPU."""
    from rocksplicator_tpu_torch.gpu import GpuCompactionBackend

    return None if str(dev).startswith("cuda") else GpuCompactionBackend(
        device=dev)


def _key_of(i) -> bytes:
    return b"counter:" + int(i).to_bytes(8, "big")


def _counter_batch(vt, vbytes, key_bytes, rows):
    """A WriteBatch of ``rows`` of one run: ``vt`` the op types as a list,
    ``vbytes`` the little-endian values, ``key_bytes`` the 16-byte keys."""
    from rocksplicator_tpu_torch.storage import WriteBatch

    batch = WriteBatch()
    for i in rows:
        key = key_bytes[16 * i:16 * i + 16]
        t = vt[i]
        if t == 3:
            batch.merge(key, vbytes[8 * i:8 * i + 8])
        elif t == 1:
            batch.put(key, vbytes[8 * i:8 * i + 8])
        else:
            batch.delete(key)
    return batch


def _write_ops(db, ids, vtype, vals, key_bytes, rows, latencies=None):
    """Write ``rows`` of one run through ``db.write`` in WriteBatches of
    ENGINE_BATCH ops; ``latencies`` collects each write()'s seconds."""
    vbytes = vals.astype("<u8").tobytes()
    vt = vtype.tolist()
    for s in range(0, len(rows), ENGINE_BATCH):
        batch = _counter_batch(vt, vbytes, key_bytes,
                               rows[s:s + ENGINE_BATCH])
        t0 = time.perf_counter()
        db.write(batch)
        if latencies is not None:
            latencies.append(time.perf_counter() - t0)


def check_read_back(db, traffic: dict, what: str, ids=None,
                    scan: bool = True) -> dict:
    """Every touched key (or those of ``ids``) read back through multi_get
    equals the oracle, and (``scan``) one full iterator scan yields
    exactly the live keys and values, in order. Returns host-clock
    seconds."""
    import numpy as np

    ids = traffic["touched"] if ids is None else ids
    exists, value = traffic["exists"], traffic["value"]
    t0 = time.time()
    for s in range(0, len(ids), ENGINE_READ_SLICE):
        part = ids[s:s + ENGINE_READ_SLICE]
        got = db.multi_get([_key_of(i) for i in part.tolist()])
        want = [int(value[i]).to_bytes(8, "little") if exists[i] else None
                for i in part.tolist()]
        if got != want:
            bad = next(j for j, (g, w) in enumerate(zip(got, want))
                       if g != w)
            raise AssertionError(f"{what}: key {int(part[bad])} reads "
                                 f"{got[bad]!r}, want {want[bad]!r}")
    t1 = time.time()
    if not scan:
        return {"multi_get_s": t1 - t0, "keys_read": int(len(ids))}
    live = ids[exists[ids]]
    live.sort()
    n = 0
    for key, val in db.new_iterator():
        if n >= len(live) or key != _key_of(live[n]) \
                or val != int(value[live[n]]).to_bytes(8, "little"):
            raise AssertionError(f"{what}: scan entry {n} is {key!r}")
        n += 1
    if n != len(live):
        raise AssertionError(f"{what}: scan gave {n} keys, want {len(live)}")
    return {"multi_get_s": t1 - t0, "scan_s": time.time() - t1,
            "keys_read": int(len(ids)), "live_keys": int(len(live))}


def _db_files(path: str) -> dict:
    """{file number: bytes} of a DB's .tsst files."""
    import os

    return {f.rsplit("-", 1)[1]: open(os.path.join(path, f), "rb").read()
            for f in os.listdir(path) if f.endswith(".tsst")}


def _masked_manifest(path: str) -> dict:
    import os

    with open(os.path.join(path, "MANIFEST")) as f:
        text = f.read()
    return json.loads(text.replace(json.loads(text)["incarnation"], "INC"))


def _same_db_files(a: str, b: str, what: str) -> int:
    """Two DBs hold byte-identical .tsst files, matched by file number,
    and equal levels; the file count."""
    fa, fb = _db_files(a), _db_files(b)
    if sorted(fa) != sorted(fb):
        raise AssertionError(f"{what}: files {sorted(fa)} vs {sorted(fb)}")
    for num in fa:
        if fa[num] != fb[num]:
            raise AssertionError(f"{what}: file {num} differs")
    if _masked_manifest(a) != _masked_manifest(b):
        raise AssertionError(f"{what}: levels differ")
    return len(fa)


def _timed_db(db, backend, log: list) -> None:
    """Time each flush and each inline L0 compaction of ``db`` on the host
    clock, with the kernel launches and the backend's stage seconds of
    each compaction."""
    from rocksplicator_tpu_torch.ops import _build

    write_mem_sst, compact_l0 = db._write_mem_sst, db._compact_level0_locked

    def flush(path, mem):
        t0 = time.time()
        write_mem_sst(path, mem)
        log.append({"what": "flush", "entries": len(mem._flat_keys),
                    "seconds": time.time() - t0})

    def compact():
        before = dict(_build.LAUNCHES)
        outs = len(db._levels[0]) + len(db._levels[1])
        t0 = time.time()
        compact_l0()
        log.append({"what": "l0_compaction", "inputs": outs,
                    "outputs": len(db._levels[1]),
                    "seconds": time.time() - t0,
                    "launches": {k: _build.LAUNCHES[k] - before[k]
                                 for k in before},
                    "stages": dict(getattr(backend, "last_stage_seconds",
                                           {}))})

    db._write_mem_sst, db._compact_level0_locked = flush, compact


def engine_db(dev, traffic: dict, work_dir: str, card: str,
              run3_checkpoint: str = "") -> tuple:
    """The port's DB at an eighth of MAX_TPU_ENTRIES: the counter traffic written
    through DB.write into a DB that compacts on the card under the fused
    sort backend (K2) and one that compacts on the host (the port's
    NativeCompactionBackend); a third DB, on the card under the bitonic
    sort backend (K1 and the torch resolve), starts from the host DB's
    checkpoint after its third run and takes run 4's writes, so it
    compacts the same 2^20 entries without writing runs 1-3 again.
    DBOptions' defaults otherwise (32 KiB blocks, zlib, 10 bits a key, 64 MiB files),
    UInt64AddOperator, level0_compaction_trigger 4, inline flushes and
    compactions. Each run's last batch flushes 2^18 entries; the fourth
    flush compacts L0 into L1 (2^20 entries), then compact_range()
    compacts everything into the bottom level. ``max_subcompactions`` is
    1 (the host's slices write a file set each, the card's one), and the
    memory budget 1 GiB (the in-RAM route: one K2 call a compaction).
    Each card DB's files must be byte-identical to the host DB's, K2 (K1)
    run once a compaction and K3 once an output file, and every key of
    the fused card DB read back equal to the oracle. With
    ``run3_checkpoint``, the host DB is checkpointed there after its third
    run (three L0 files; the memtable is empty after a run's last batch,
    so the checkpoint adds no flush), for ``remote_worker``."""
    import os

    import torch

    from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.storage import DB, DBOptions
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.native import binding
    from rocksplicator_tpu_torch.storage.native_compaction import (
        NativeCompactionBackend)

    report = {"card": card, "ops": 4 * ENGINE_RUN_ENTRIES,
              "memtable_bytes": traffic["memtable_bytes"], "dbs": {}}
    launches = {}
    paths = {name: os.path.join(work_dir, f"engine_{name}")
             for name in ("fused", "host", "bitonic")}
    for name, backend in (("fused", GpuCompactionBackend(device=dev)),
                          ("host", NativeCompactionBackend()),
                          ("bitonic", GpuCompactionBackend(device=dev))):
        _sort_flag(SEAM_FLAGS.get(name))
        path = paths[name]
        # the bitonic DB opens the host DB's checkpoint after run 3
        first_run = 3 if name == "bitonic" else 0
        db = DB(path, DBOptions(
            merge_operator=UInt64AddOperator(), compaction_backend=backend,
            level0_compaction_trigger=4,
            memtable_bytes=traffic["memtable_bytes"], max_subcompactions=1,
            compaction_memory_budget_bytes=1 << 30))
        log: list = []
        _timed_db(db, backend, log)
        try:
            torch.cuda.synchronize()
            _build.reset_launches()
            write_s = []
            for r, (ids, vtype, vals, key_bytes) in enumerate(
                    traffic["ops"][first_run:], first_run):
                t0 = time.time()
                _write_ops(db, ids, vtype, vals, key_bytes,
                           range(len(ids)))
                write_s.append(time.time() - t0)
                if name == "host" and r == 2:
                    db.checkpoint(paths["bitonic"])
                    if run3_checkpoint:
                        db.checkpoint(run3_checkpoint)
            l0 = dict(_build.LAUNCHES)
            before = dict(_build.LAUNCHES)
            t0 = time.time()
            db.compact_range()
            torch.cuda.synchronize()
            log.append({"what": "compact_range", "seconds": time.time() - t0,
                        "outputs": len(db._levels[-1]),
                        "launches": {k: _build.LAUNCHES[k] - before[k]
                                     for k in before},
                        "stages": dict(getattr(
                            backend, "last_stage_seconds", {}))})
            launches[name] = dict(_build.LAUNCHES)
            flushes = [e for e in log if e["what"] == "flush"]
            compactions = [e for e in log if e["what"] != "flush"]
            if [e["entries"] for e in flushes] \
                    != [ENGINE_RUN_ENTRIES] * (4 - first_run):
                raise AssertionError(f"engine db {name}: flushes {flushes}")
            if [e["what"] for e in compactions] != ["l0_compaction",
                                                    "compact_range"]:
                raise AssertionError(f"engine db {name}: {compactions}")
            if name in SEAM_FLAGS:
                sort = {"fused": "fused_resolve", "bitonic": "bitonic_sort"}
                for e in compactions:
                    got = e["launches"]
                    if got[sort[name]] != 1 or sum(got.values()) \
                            != 1 + e["outputs"] \
                            or got["bloom_build"] != e["outputs"]:
                        raise AssertionError(
                            f"engine db {name}: {e['what']} launches "
                            f"{got}, {e['outputs']} files")
            elif any(launches[name].values()):
                raise AssertionError(f"engine db host launched "
                                     f"{launches[name]}")
            report["dbs"][name] = {
                "write_s_per_run": write_s, "flushes": flushes,
                "compactions": compactions, "l0_launches": l0,
                "levels": [len(f) for f in db._levels]}
            if name == "fused":
                report["dbs"][name]["read_back"] = check_read_back(
                    db, traffic, "engine db card")
        finally:
            db.close()
    _sort_flag(None)
    if binding.get_native() is None:
        raise AssertionError("engine db: the native library is not loaded")
    report["identical_files"] = {
        name: _same_db_files(paths[name], paths["host"], f"engine db {name}")
        for name in SEAM_FLAGS}
    total = {k: launches["fused"][k] + launches["bitonic"][k]
             for k in launches["fused"]}
    report["launches"] = total
    return report, total


def engine_db_background(dev, traffic: dict, work_dir: str,
                         card: str) -> tuple:
    """The counter traffic (``traffic``: 4 runs of ENGINE_BG_RUN_ENTRIES,
    half engine_db's depth, under ENGINE_BG_BUDGET_BYTES, a quarter of the
    default budget) from ENGINE_WRITERS threads on disjoint key ranges into one
    DB with background flush and compaction threads, the scheduler on and
    the default backend (the card). Then flush(), wait
    for the compaction thread to go idle, and compact_range(). Every
    acknowledged write reads back equal to the oracle, no background job
    failed, and the compaction thread launched K2 before compact_range."""
    import os
    import threading

    import numpy as np
    import torch

    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.storage import DB, DBOptions
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator

    _sort_flag(SEAM_FLAGS["fused"])
    db = DB(os.path.join(work_dir, "engine_bg"), DBOptions(
        merge_operator=UInt64AddOperator(), level0_compaction_trigger=4,
        compaction_backend=_card_backend(dev),
        memtable_bytes=traffic["memtable_bytes"],
        background_compaction=True, compaction_scheduler=True,
        compaction_memory_budget_bytes=ENGINE_BG_BUDGET_BYTES))
    threads_of = []
    count_launch = _build.count_launch

    def counted(name, cuda_launches=None):
        threads_of.append((name, threading.current_thread().name))
        count_launch(name, cuda_launches)

    key_space = 2 * traffic["run_entries"]
    latencies = [[] for _ in range(ENGINE_WRITERS)]
    failed = []

    def writer(w):
        lo = key_space * w // ENGINE_WRITERS
        hi = key_space * (w + 1) // ENGINE_WRITERS
        try:
            for ids, vtype, vals, key_bytes in traffic["ops"]:
                rows = np.flatnonzero((ids >= lo) & (ids < hi)).tolist()
                _write_ops(db, ids, vtype, vals, key_bytes, rows,
                           latencies[w])
        except Exception as exc:  # the phase fails on it below
            failed.append(repr(exc))

    _build.count_launch = counted
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(ENGINE_WRITERS)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        write_s = time.time() - t0
        if failed:
            raise AssertionError(f"engine db background: {failed}")
        db.flush()
        flush_s = time.time() - t0 - write_s
        deadline = time.time() + 600
        while True:
            idle = db._compaction_mutex.acquire(blocking=False)
            if idle:
                db._compaction_mutex.release()
            if idle and len(db._levels[0]) < 4:
                break
            if time.time() > deadline:
                raise AssertionError("engine db background: the "
                                     "compaction thread never went idle")
            time.sleep(0.05)
        idle_s = time.time() - t0 - write_s - flush_s
        bg = list(threads_of)
        before = dict(_build.LAUNCHES)
        t1 = time.time()
        db.compact_range()
        torch.cuda.synchronize()
        compact_s = time.time() - t1
        launches = dict(_build.LAUNCHES)
        read = check_read_back(db, traffic, "engine db background")
        failures = (db._bg_flush_failures, db._bg_compaction_failures)
        levels = [len(f) for f in db._levels]
    finally:
        _build.count_launch = count_launch
        db.close()
    bg_k2 = [t for k, t in bg if k == "fused_resolve"]
    if not bg_k2 or not all(t.startswith("lsm-compact-") for t in bg_k2):
        raise AssertionError(f"engine db background: K2 before "
                             f"compact_range from {bg_k2}")
    if failures != (0, 0):
        raise AssertionError(f"engine db background: failures {failures}")
    lat = sorted(x for per in latencies for x in per)
    return {"card": card, "writers": ENGINE_WRITERS,
            "ops": 4 * traffic["run_entries"], "write_s": write_s,
            "flush_s": flush_s, "wait_idle_s": idle_s,
            "compact_range_s": compact_s, "read_back": read,
            "writes": len(lat),
            "write_p50_ms": 1e3 * lat[len(lat) // 2],
            "write_p99_ms": 1e3 * lat[min(len(lat) - 1,
                                          (99 * len(lat)) // 100)],
            "background_launches": {
                k: sum(1 for n, _t in bg if n == k) for k in before},
            "compact_range_launches": {k: launches[k] - before[k]
                                       for k in before},
            "bg_failures": list(failures), "levels": levels,
            "launches": launches}, launches


def engine_db_ingest(dev, prepared: tuple, work_dir: str, card: str) -> tuple:
    """The post-ingest path on real DBs: the 12 DBs' runs of
    ``stub_db_inputs`` ingested into 12 port DBs (ingest_external_file, a
    run a call, so newer runs take higher global seqnos), submitted from
    12 threads to BatchCompactor(device=cuda). Each DB's files must equal
    those of the same DB ingested again and compacted by compact_range on
    the host (NativeCompactionBackend, one slice); no DB may take the
    per-DB fallback; a sample of keys reads back the same from both."""
    import os
    import threading

    import numpy as np
    import torch

    from rocksplicator_tpu_torch.admin import BatchCompactor
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.storage import DB, DBOptions
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.native_compaction import (
        NativeCompactionBackend)

    inputs, _want, _counts, _options, _s = prepared
    fallbacks = []

    def opened(name, tag, backend):
        root = inputs[name][0]
        db = DB(os.path.join(root, tag), DBOptions(
            merge_operator=UInt64AddOperator(), compaction_backend=backend,
            max_subcompactions=1))
        t0 = time.time()
        for run in inputs[name][1]:
            db.ingest_external_file([run])
        return db, time.time() - t0

    t0 = time.time()
    cards, hosts = {}, {}
    for name in inputs:
        cards[name], _ = opened(name, "eng_card", _card_backend(dev))
        hosts[name], _ = opened(name, "eng_host", NativeCompactionBackend())
    ingest_s = time.time() - t0
    for name, db in cards.items():
        def fallback(name=name):
            fallbacks.append(name)
            raise AssertionError(f"{name}: the per-DB fallback was taken")
        db.compact_range = fallback
    compactor = BatchCompactor(device=dev)
    start = threading.Barrier(len(cards))
    failed = {}

    def submit(name, db):
        start.wait()
        try:
            compactor.compact(name, db)
        except Exception as exc:  # the phase fails on it below
            failed[name] = repr(exc)

    _sort_flag(SEAM_FLAGS["fused"])
    threads = [threading.Thread(target=submit, args=item)
               for item in cards.items()]
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = dict(_build.LAUNCHES)
        sizes = list(compactor.batch_sizes)
    finally:
        compactor.close()
    t0 = time.time()
    for db in hosts.values():
        db.compact_range()
    host_s = time.time() - t0
    rng = np.random.default_rng(900)
    sample = [b"counter:" + int(i).to_bytes(8, "big")
              for i in rng.choice(4 * DBS_RUN_ENTRIES, 4096, replace=False)]
    files = found = 0
    try:
        if failed or fallbacks or any(t.is_alive() for t in threads):
            raise AssertionError(f"engine db ingest: failed {failed}, "
                                 f"fallbacks {fallbacks}")
        for name in inputs:
            files += _same_db_files(cards[name].path, hosts[name].path,
                                    f"engine db ingest {name}")
            got = cards[name].multi_get(sample)
            if got != hosts[name].multi_get(sample):
                raise AssertionError(f"engine db ingest {name}: reads")
            found += sum(v is not None for v in got)
    finally:
        for db in list(cards.values()) + list(hosts.values()):
            db.close()
    groups = sum(-(-b // BENCH_SHARDS) for b in sizes)
    if sum(sizes) != len(cards) or launches["fused_resolve"] != groups \
            or launches["bloom_build"] != groups + files:
        raise AssertionError(f"engine db ingest: batches {sizes}, launches "
                             f"{launches}, {files} files")
    if not found:
        raise AssertionError("engine db ingest: no sampled key was found")
    return {"card": card, "dbs": len(cards), "runs_per_db": 4,
            "entries_per_db": 4 * DBS_RUN_ENTRIES, "ingest_s": ingest_s,
            "batch_sizes": sizes, "launch_groups": groups,
            "seconds": seconds, "host_compact_range_s": host_s,
            "files": files, "identical_files": files,
            "sampled_keys": len(sample) * len(cards), "found": found,
            "per_db_fallbacks": len(fallbacks),
            "launches": launches}, launches


# ---- the remote compaction tier: the card as the worker ---------------

REMOTE_WORKER_THREAD = "remote-worker"


def _generation(db) -> list:
    """sha256 of a DB's live files, in level order."""
    import hashlib
    import os

    return [hashlib.sha256(open(os.path.join(db.path, name), "rb").read())
            .hexdigest() for level in db._levels for name in level]


def _remote_counters(stats_mod, dbs) -> dict:
    """The port's ``compaction.remote.*`` counters of ``dbs``."""
    st = stats_mod.Stats.get()
    st.flush()
    out = {}
    for name in ("published", "claimed", "installed", "failed_over",
                 "fenced", "reaped", "stale"):
        out[name] = {db: st.get_counter(stats_mod.tagged(
            f"compaction.remote.{name}", db=db)) for db in dbs}
    out["worker_done"] = st.get_counter(stats_mod.tagged(
        "compaction.remote.worker_done", worker=REMOTE_WORKER_THREAD))
    return out


class _Timed:
    """Records a leader's offloads: each ``maybe_offload`` (the pick's
    kind, its outcome, host-clock seconds) and the seconds of its publish
    and its verify + install."""

    def __init__(self, mgr):
        self.offloads, self.publish_s, self.install_s = [], [], []
        for attr, log in (("_publish", self.publish_s),
                          ("_install", self.install_s)):
            setattr(mgr, attr, self._timed(getattr(mgr, attr), log))
        offload = mgr.maybe_offload

        def maybe_offload(pick):
            t0 = time.time()
            outcome = offload(pick)
            self.offloads.append((getattr(pick, "kind", None), outcome,
                                  time.time() - t0))
            return outcome

        mgr.maybe_offload = maybe_offload

    @staticmethod
    def _timed(fn, log):
        def call(*args, **kwargs):
            t0 = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                log.append(time.time() - t0)
        return call


def _job_report(timed: _Timed, worker_job: dict, launches: dict) -> dict:
    """One offloaded job's host-clock seconds by stage, bytes and kernel
    launches."""
    kind, outcome, total = timed.offloads[-1]
    return {"pick": kind, "outcome": outcome, "total_s": total,
            "publish_s": timed.publish_s[-1],
            "publish_to_claim_s": worker_job["claim_after_publish"],
            "fetch_s": worker_job["fetch"], "merge_s": worker_job["merge"],
            "merge_stages_s": worker_job["backend_stages"],
            "upload_s": worker_job["upload"],
            "verify_install_s": timed.install_s[-1],
            "bytes_fetched": worker_job["bytes_fetched"],
            "bytes_uploaded": worker_job["bytes_uploaded"],
            "launches": launches}


def remote_worker(dev, traffic: dict, base3: str, work_dir: str,
                  card: str) -> tuple:
    """The remote compaction tier with the card as its worker: a port
    CoordinatorServer, a port CompactionWorker on GpuCompactionBackend(
    device=cuda) (fused sort backend) serving in a thread, and leaders
    that are port DBs on the host (NativeCompactionBackend, engine_db's
    options), each with a RemoteCompactionManager. The counter traffic's
    runs 1-3 come from ``base3`` (engine_db's host DB checkpointed after
    its third run, a flush a run); run 4 is written into it with
    compaction off, and the states are copied with checkpoint.

    Job A (local store, leader budget 1 GiB): a leader holding runs 1-3
    with background compaction (the legacy L0 trigger, 4) takes run 4's
    writes; its own L0 pick reaches maybe_offload, and the worker merges
    the 2^20 entries in RAM: one K2 call and one K3 call a file. Job B
    (the port's S3 stub, REMOTE_B_BUDGET_BYTES): maybe_offload on a
    leader holding the 4 runs; the worker streams: K2 calls = chunks, no
    K3. Each installed generation must be sha256-identical, file for file,
    to the same data compacted by compact_range on a host DB under the
    same budget; A reads back every key equal to the numpy oracle, B a
    sample; one claim a job, no failover, reap or fence, no local
    compaction on either leader; every launch from the worker's thread;
    the ledger and the transfer objects swept."""
    import os
    import threading

    import numpy as np
    import torch

    from rocksplicator_tpu_torch.cluster import (CoordinatorClient,
                                                 CoordinatorServer)
    from rocksplicator_tpu_torch.compaction_remote import (
        CompactionJobQueue, CompactionWorker, RemoteCompactionManager,
        RemoteDispatchPolicy)
    from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.storage import DB, DBOptions
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.native_compaction import (
        NativeCompactionBackend)
    from rocksplicator_tpu_torch.utils import objectstore, stats
    from rocksplicator_tpu_torch.utils.s3_stub import S3StubServer

    root = os.path.join(work_dir, "remote")
    os.makedirs(root)

    def options(budget=0, **over):
        opts = dict(merge_operator=UInt64AddOperator(),
                    compaction_backend=NativeCompactionBackend(),
                    level0_compaction_trigger=4,
                    memtable_bytes=traffic["memtable_bytes"],
                    max_subcompactions=1,
                    compaction_memory_budget_bytes=budget)
        opts.update(over)
        return DBOptions(**opts)

    def write_run(db, r):
        ids, vtype, vals, key_bytes = traffic["ops"][r]
        _write_ops(db, ids, vtype, vals, key_bytes, range(len(ids)))

    t0 = time.time()
    # the base: a flush a run, never a compaction
    base = DB(base3, options(level0_compaction_trigger=1 << 30))
    try:
        base.checkpoint(os.path.join(root, "A"))
        write_run(base, 3)
        if [len(f) for f in base._levels][0] != 4:
            raise AssertionError(f"remote worker: base levels "
                                 f"{[len(f) for f in base._levels]}")
        for tag in ("B", "comp_A", "comp_B"):
            base.checkpoint(os.path.join(root, tag))
    finally:
        base.close()
    setup_s = time.time() - t0

    # the comparators: the same data compacted on the host, one a budget
    comparators = {}
    for tag, budget in (("A", 1 << 30), ("B", REMOTE_B_BUDGET_BYTES)):
        db = DB(os.path.join(root, f"comp_{tag}"), options(budget))
        try:
            t1 = time.time()
            db.compact_range()
            comparators[tag] = {"generation": _generation(db),
                                "levels": [len(f) for f in db._levels],
                                "seconds": time.time() - t1}
        finally:
            db.close()

    server = CoordinatorServer(port=0, data_dir=os.path.join(root, "coord"))
    clients = []

    def client():
        clients.append(CoordinatorClient("127.0.0.1", server.port))
        return clients[-1]

    _sort_flag(SEAM_FLAGS["fused"])
    backend = GpuCompactionBackend(device=dev)
    worker = CompactionWorker(client(), os.path.join(root, "worker"),
                              worker_id=REMOTE_WORKER_THREAD,
                              backend=backend)
    stop = threading.Event()
    serving = threading.Thread(target=worker.serve_forever, args=(stop,),
                               name=REMOTE_WORKER_THREAD)
    threads_of = []
    count_launch = _build.count_launch

    def counted(name, cuda_launches=None):
        threads_of.append((name, threading.current_thread().name))
        count_launch(name, cuda_launches)

    saved_env = {k: os.environ.get(k) for k in (
        "AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "RSTPU_S3_ENDPOINT")}
    s3 = S3StubServer(access_key="remote-access", secret_key="remote-secret")
    os.environ.update(AWS_ACCESS_KEY_ID="remote-access",
                      AWS_SECRET_ACCESS_KEY="remote-secret",
                      RSTPU_S3_ENDPOINT=s3.start())
    stores = {"A": f"local://{root}/store", "B": "s3://remote-b"}
    policy = RemoteDispatchPolicy(enabled=True, size_floor_bytes=0)
    report = {"card": card, "ops": 4 * ENGINE_RUN_ENTRIES,
              "setup_s": setup_s, "policy": dict(vars(policy)),
              "stores": {"A": "local", "B": "s3 stub"}, "jobs": {}}
    leaders, mgrs = {}, {}
    stats.Stats.reset_for_test()
    _build.count_launch = counted
    serving.start()
    try:
        # ---- job A: the engine's own L0 pick at the trigger -----------
        leaders["A"] = DB(os.path.join(root, "A"), options(
            1 << 30, background_compaction=True,
            compaction_scheduler=False))
        mgrs["A"] = RemoteCompactionManager(
            "remote-A", leaders["A"], client(), stores["A"], policy=policy)
        timed = {"A": _Timed(mgrs["A"])}
        leaders["A"].set_remote_compactor(mgrs["A"])
        torch.cuda.synchronize()
        _build.reset_launches()
        t1 = time.time()
        write_run(leaders["A"], 3)
        write_a_s = time.time() - t1
        deadline = time.time() + 900
        while not timed["A"].offloads:
            if time.time() > deadline:
                raise AssertionError("remote worker: job A never offered")
            time.sleep(0.05)
        torch.cuda.synchronize()
        launches_a = dict(_build.LAUNCHES)
        job_a = _job_report(timed["A"], dict(worker.last_job), launches_a)
        job_a["leader_write_run4_s"] = write_a_s
        report["jobs"]["A"] = job_a
        # ---- job B: maybe_offload on the 4 runs, streamed -------------
        leaders["B"] = DB(os.path.join(root, "B"),
                          options(REMOTE_B_BUDGET_BYTES))
        mgrs["B"] = RemoteCompactionManager(
            "remote-B", leaders["B"], client(), stores["B"], policy=policy)
        timed["B"] = _Timed(mgrs["B"])

        class Pick:
            kind = "l0"

        torch.cuda.synchronize()
        _build.reset_launches()
        mgrs["B"].maybe_offload(Pick())
        torch.cuda.synchronize()
        launches_b = dict(_build.LAUNCHES)
        job_b = _job_report(timed["B"], dict(worker.last_job), launches_b)
        job_b["stream_chunks"] = backend.last_stream_chunks
        report["jobs"]["B"] = job_b
    finally:
        stop.set()
        serving.join(600)
        _build.count_launch = count_launch
        if leaders.get("A") is not None:
            leaders["A"].set_remote_compactor(None)
    try:
        counters = _remote_counters(stats, ("remote-A", "remote-B"))
        queue = CompactionJobQueue(clients[0])
        summary = queue.read_summary()
        for tag, db in leaders.items():
            job = report["jobs"][tag]
            got = _generation(db)
            if got != comparators[tag]["generation"] or [
                    len(f) for f in db._levels] != comparators[tag]["levels"]:
                raise AssertionError(
                    f"remote worker job {tag}: generation {got} levels "
                    f"{[len(f) for f in db._levels]}, comparator "
                    f"{comparators[tag]}")
            job["files"] = len(got)
            snap = db.metrics_snapshot(max_age=0)
            job["bytes_compacted_local_total"] = snap[
                "bytes_compacted_local_total"]
            job["remote_offloaded_bytes_total"] = snap[
                "remote_offloaded_bytes_total"]
            if job["outcome"] != "installed" or job["pick"] != "l0" \
                    or len(timed[tag].offloads) != 1:
                raise AssertionError(f"remote worker job {tag}: offloads "
                                     f"{timed[tag].offloads}")
            if snap["bytes_compacted_local_total"] != 0 \
                    or not snap["remote_offloaded_bytes_total"]:
                raise AssertionError(f"remote worker job {tag}: {snap}")
            name = mgrs[tag].db_name
            if queue.get_job(name) is not None or mgrs[tag]._store \
                    .list_objects(f"compactions/{name}/"):
                raise AssertionError(f"remote worker job {tag}: not swept")
            if mgrs[tag].counters() != {"installed": 1, "failed_over": 0,
                                        "fenced": 0, "republished": 0}:
                raise AssertionError(f"remote worker job {tag}: "
                                     f"{mgrs[tag].counters()}")
            if (counters["claimed"][name], counters["installed"][name],
                    counters["failed_over"][name], counters["reaped"][name],
                    counters["fenced"][name], counters["stale"][name]) \
                    != (1, 1, 0, 0, 0, 0):
                raise AssertionError(f"remote worker job {tag}: counters "
                                     f"{counters}")
        if db_errors := [str(db._bg_compaction_error) for db in
                         leaders.values() if db._bg_compaction_error]:
            raise AssertionError(f"remote worker: {db_errors}")
        a, b = report["jobs"]["A"], report["jobs"]["B"]
        if a["launches"]["fused_resolve"] != 1 \
                or a["launches"]["bloom_build"] != a["files"] \
                or a["launches"]["bitonic_sort"] != 0:
            raise AssertionError(f"remote worker job A: launches "
                                 f"{a['launches']}, {a['files']} files")
        if b["stream_chunks"] < 2 \
                or b["launches"]["fused_resolve"] != b["stream_chunks"] \
                or b["launches"]["bloom_build"] != 0 \
                or b["launches"]["bitonic_sort"] != 0:
            raise AssertionError(f"remote worker job B: launches "
                                 f"{b['launches']}, {b['stream_chunks']} "
                                 "chunks")
        if (worker.jobs_done, worker.jobs_failed) != (2, 0) \
                or counters["worker_done"] != 2:
            raise AssertionError(f"remote worker: done {worker.jobs_done}, "
                                 f"failed {worker.jobs_failed}")
        if summary.get("reaped", 0) or summary.get("failed_over", 0) \
                or summary.get("claimed") != 2 \
                or summary.get("installed") != 2:
            raise AssertionError(f"remote worker: ledger summary {summary}")
        strays = sorted({t for _k, t in threads_of
                         if t != REMOTE_WORKER_THREAD})
        if strays:
            raise AssertionError(f"remote worker: launches from {strays}")
        report["read_back_A"] = check_read_back(
            leaders["A"], traffic, "remote worker job A", scan=False)
        rng = np.random.default_rng(801)
        sample = np.sort(rng.choice(
            traffic["touched"], min(1 << 16, len(traffic["touched"]) // 2),
            replace=False))
        report["read_back_B"] = check_read_back(
            leaders["B"], traffic, "remote worker job B", ids=sample,
            scan=False)
    finally:
        for db in leaders.values():
            db.close()
        for c in clients:
            c.close()
        server.stop()
        s3.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        with objectstore._store_cache_lock:
            objectstore._store_cache.clear()
    report.update(comparators={k: {"seconds": v["seconds"],
                                   "levels": v["levels"]}
                               for k, v in comparators.items()},
                  counters=counters, ledger_summary=summary,
                  worker={"jobs_done": worker.jobs_done,
                          "jobs_failed": worker.jobs_failed})
    total = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    report["launches"] = total
    return report, total


def remote_worker_cli(dev, prepared: tuple, work_dir: str,
                      card: str) -> tuple:
    """The port's worker CLI as its own process: a port coordinator, a
    host leader (NativeCompactionBackend) holding 4 runs of 2^17 counter
    entries ingested from ``service_dbs``' first DB, its offload waiting
    in a thread, and ``python -m rocksplicator_tpu_torch.tools.
    compaction_worker --coord 127.0.0.1:<port> --backend gpu --once``,
    which claims the job, merges it on the card and exits 0. The leader
    installs it; its files equal the same DB compacted by compact_range
    on the host; the CLI's own launch counts (RSTPU_LAUNCH_COUNTS_FILE)
    show one K2 call and one K3 call a file."""
    import os
    import threading

    from rocksplicator_tpu_torch.cluster import (CoordinatorClient,
                                                 CoordinatorServer)
    from rocksplicator_tpu_torch.compaction_remote import (
        CompactionJobQueue, RemoteCompactionManager, RemoteDispatchPolicy)
    from rocksplicator_tpu_torch.storage import DB, DBOptions
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.native_compaction import (
        NativeCompactionBackend)

    inputs = prepared[0]
    _root, runs = inputs["db0"]
    root = os.path.join(work_dir, "remote_cli")
    os.makedirs(root)

    def opened(tag):
        db = DB(os.path.join(root, tag), DBOptions(
            merge_operator=UInt64AddOperator(),
            compaction_backend=NativeCompactionBackend(),
            max_subcompactions=1))
        for run in runs:
            db.ingest_external_file([run])
        return db

    leader, comparator = opened("leader"), opened("comparator")
    server = CoordinatorServer(port=0)
    clients = [CoordinatorClient("127.0.0.1", server.port)
               for _ in range(2)]
    outcome = []
    counts_path = os.path.join(root, "cli_launches.json")
    try:
        comparator.compact_range()
        mgr = RemoteCompactionManager(
            "remote-cli", leader, clients[0], f"local://{root}/store",
            policy=RemoteDispatchPolicy(enabled=True, size_floor_bytes=0,
                                        claim_wait_s=300.0,
                                        deadline_s=600.0))

        class Pick:
            kind = "l0"

        offload = threading.Thread(
            target=lambda: outcome.append(mgr.maybe_offload(Pick())))
        offload.start()
        queue = CompactionJobQueue(clients[1])
        deadline = time.time() + 300
        while queue.list_open_jobs() != ["remote-cli"]:
            if time.time() > deadline or not offload.is_alive():
                raise AssertionError("remote worker cli: no job published")
            time.sleep(0.05)
        env = dict(os.environ, RSTPU_LAUNCH_COUNTS_FILE=counts_path,
                   RSTPU_FLAG_SORT_BACKEND="pallas_fused")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m",
             "rocksplicator_tpu_torch.tools.compaction_worker",
             "--coord", f"127.0.0.1:{server.port}", "--backend", "gpu",
             "--once", "--workdir", os.path.join(root, "cli_work"),
             "--worker-id", "remote-cli-worker"],
            env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.time() - t0
        offload.join(600)
        if proc.returncode != 0:
            raise AssertionError(f"remote worker cli: rc {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        if outcome != ["installed"]:
            raise AssertionError(f"remote worker cli: {outcome}: "
                                 f"{proc.stderr[-3000:]}")
        got, want = _generation(leader), _generation(comparator)
        if got != want or [len(f) for f in leader._levels] != [
                len(f) for f in comparator._levels]:
            raise AssertionError(f"remote worker cli: {got} vs {want}")
        with open(counts_path) as f:
            launches = json.load(f)
        if launches["fused_resolve"] != 1 \
                or launches["bloom_build"] != len(got) \
                or launches["bitonic_sort"] != 0:
            raise AssertionError(f"remote worker cli: launches {launches}, "
                                 f"{len(got)} files")
        if leader.metrics_snapshot(max_age=0)[
                "bytes_compacted_local_total"] != 0:
            raise AssertionError("remote worker cli: the leader compacted")
        if "1 jobs, 0 failed" not in proc.stderr:
            raise AssertionError(f"remote worker cli: {proc.stderr[-3000:]}")
        sample = [b"counter:" + int(i).to_bytes(8, "big")
                  for i in range(0, 4 * DBS_RUN_ENTRIES, 61)]
        if leader.multi_get(sample) != comparator.multi_get(sample):
            raise AssertionError("remote worker cli: reads differ")
    finally:
        for c in clients:
            c.close()
        server.stop()
        leader.close()
        comparator.close()
    return {"card": card, "entries": 4 * DBS_RUN_ENTRIES, "runs": 4,
            "cli_seconds": cli_s, "files": len(got),
            "identical_files": len(got), "outcome": outcome[0],
            "launches": launches}, launches


# ---- the replicated shard and its admin plane on the card -----------------
# replicated_counter: 4 runs of this many counter ops (2^20 in all, a
# quarter of MAX_TPU_ENTRIES: the one cut, of depth), pipelined through the
# leader's
# ApplicationDB.write_async in WriteBatches of ENGINE_BATCH ops
REPL_RUN_ENTRIES = 1 << 18
REPL_DB = "counter00000"
REPL_SAMPLE_KEYS = 1 << 16
# the engine's default memtable (named so a rehearsal can shrink it)
REPL_MEMTABLE_BYTES = 8 << 20


class _CompactionLog:
    """Attributes the compactions of the replicated shard to its replicas.

    During the phase, ``merge_runs_to_files`` (the direct sink) and
    ``merge_runs`` (the engine's tuple path, taken where the sink
    declines) of the card's and the host's backends are wrapped at the
    class: each call runs under the replica's tag (a thread-local, the
    backend instance's owner), and is logged with its thread, output files
    (None: declined), streamed chunks and stage seconds; an exception is
    counted and re-raised. Each kernel launch and each
    ``compaction.stream_*`` increment of the port's Stats is attributed to
    the tag it ran under (``None`` outside every compaction), and so is
    each K2 call's CUDA-event time (the wrapper's launches; host gaps
    between them included)."""

    def __init__(self):
        import threading

        self.tls = threading.local()
        self.owner = {}
        # backends tagged in ``owner`` by id, held so that no id is reused
        self.backends = []
        self.calls, self.errors, self.launches = [], [], []
        self.tuple_calls, self.k2_ms = [], []
        self.stream = []

    def tag(self):
        return getattr(self.tls, "tag", None)

    def install(self):
        import threading

        from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
        from rocksplicator_tpu_torch.ops import _build
        from rocksplicator_tpu_torch.storage.native_compaction import (
            NativeCompactionBackend)
        from rocksplicator_tpu_torch.utils.stats import Stats

        log = self
        self._saved = [(cls, name, getattr(cls, name))
                       for cls in (GpuCompactionBackend,
                                   NativeCompactionBackend)
                       for name in ("merge_runs_to_files", "merge_runs")]
        for cls, name, real in self._saved:
            def wrapped(backend, *args, _real=real, _name=name, **kwargs):
                tag = log.owner.get(id(backend), "unowned")
                log.tls.tag = tag
                thread = threading.current_thread().name
                t0 = time.time()
                try:
                    outs = _real(backend, *args, **kwargs)
                except BaseException as exc:
                    log.errors.append((tag, thread, repr(exc)))
                    raise
                finally:
                    log.tls.tag = None
                if _name == "merge_runs":
                    # the engine's tuple path, after the direct sink
                    # declined (the card's backend merges here, eagerly)
                    log.tuple_calls.append({
                        "replica": tag, "thread": thread,
                        "seconds": time.time() - t0})
                    return outs
                log.calls.append({
                    "replica": tag, "thread": thread,
                    "seconds": time.time() - t0,
                    "files": None if outs is None else len(outs),
                    "chunks": getattr(backend, "last_stream_chunks", None),
                    "stages": dict(getattr(backend, "last_stage_seconds",
                                           {}))})
                return outs
            setattr(cls, name, wrapped)
        from rocksplicator_tpu_torch.ops import fused_resolve

        self._k2 = fused_resolve.fused_merge_resolve

        def timed_k2(*args, **kwargs):
            # the K2 wrapper's device time (CUDA events; the compaction
            # reads the result back right after)
            import torch

            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = log._k2(*args, **kwargs)
            end.record()
            end.synchronize()
            log.k2_ms.append((log.tag(), threading.current_thread().name,
                              start.elapsed_time(end)))
            return out

        fused_resolve.fused_merge_resolve = timed_k2
        self._count_launch = _build.count_launch

        def counted(name, cuda_launches=None):
            log.launches.append((name, log.tag(),
                                 threading.current_thread().name))
            log._count_launch(name, cuda_launches)

        _build.count_launch = counted
        self._stats = Stats.get()
        incr = self._stats.incr

        def counted_incr(name, value=1.0):
            if name.startswith("compaction.stream_"):
                log.stream.append((name, log.tag(), value))
            incr(name, value)

        self._stats.incr = counted_incr

    def uninstall(self):
        from rocksplicator_tpu_torch.ops import _build, fused_resolve

        for cls, name, real in self._saved:
            setattr(cls, name, real)
        fused_resolve.fused_merge_resolve = self._k2
        _build.count_launch = self._count_launch
        del self._stats.incr

    def of(self, tag) -> dict:
        """One replica's compactions: calls by thread kind, in-RAM calls
        and their files, the Stats' stream chunks and merges, launches by
        kernel and by thread kind."""
        calls = [c for c in self.calls if c["replica"] == tag]
        chunks = sum(v for n, t, v in self.stream
                     if t == tag and n == "compaction.stream_chunks")
        merges = sum(v for n, t, v in self.stream
                     if t == tag and n == "compaction.stream_merges")

        def kind(thread):
            return ("background" if thread.startswith("lsm-compact-")
                    else "compact_db" if thread.startswith("admin")
                    else thread)

        launches = {}
        for name, t, thread in self.launches:
            if t == tag:
                key = f"{name}@{kind(thread)}"
                launches[key] = launches.get(key, 0) + 1
        # a direct sink that declined (None) left the compaction to the
        # engine's tuple path; the card's backend reports its chunks a
        # call, the host's not
        declined = sum(1 for c in calls if c["files"] is None)
        in_ram = [c for c in calls
                  if c["chunks"] == 0 and c["files"] is not None]
        tuples = [c for c in self.tuple_calls if c["replica"] == tag]
        return {"calls": len(calls),
                "by_thread": {k: sum(1 for c in calls
                                     if kind(c["thread"]) == k)
                              for k in ("background", "compact_db")},
                "declined": declined, "tuple_calls": len(tuples),
                "in_ram": len(calls) - declined - int(merges),
                "in_ram_by_backend": len(in_ram),
                "in_ram_files": sum(c["files"] or 0 for c in in_ram),
                "stream_chunks": int(chunks), "stream_merges": int(merges),
                "backend_chunks": sum(c["chunks"] or 0 for c in calls),
                "launches": launches,
                "k2_device_ms": [(kind(th), ms) for t, th, ms in self.k2_ms
                                 if t == tag],
                "seconds": [c["seconds"] for c in calls],
                "tuple_seconds": [c["seconds"] for c in tuples],
                "stages": [c["stages"] for c in calls]}


def replicated_counter(dev, traffic: dict, work_dir: str,
                       card: str) -> tuple:
    """One counter shard replicated over the port's admin plane: four
    nodes in this process, each a port Replicator and AdminHandler on a
    port RpcServer. A leads on the card; B follows A on the card; C
    follows A with gpu_compaction=False (the host's NativeCompactionBackend,
    the comparator); D starts empty on the card. The counter service's
    options (UInt64AddOperator, WAL TTL 3600 s, 10 bits a key, background
    flush and compaction; the engine's defaults otherwise, but one slice a
    compaction so the card's files compare with the host's), ack mode 1.

    DBs open by add_db RPCs through a port RpcClientPool; ``traffic``
    (4 x REPL_RUN_ENTRIES ops, key space 2^19) is pipelined through A's
    ApplicationDB.write_async in WriteBatches of ENGINE_BATCH under the
    default write window, each replica flushing once a run's last op has
    reached it; B and C catch up to A's sequence number; once A's and
    B's background compactions have run, compact_db runs on A, B and C;
    B is backed up by backup_db_to_s3 into the port's S3 stub and
    restored into D by restore_db_from_s3.
    Every key reads back from A and B equal to the numpy oracle; A's, B's
    and C's live files are sha256-equal as a multiset and their sequence
    numbers equal; D's files equal B's at the backup, its sequence number
    B's, and a seeded sample of REPL_SAMPLE_KEYS keys the oracle. A's and
    B's compactions launched K2 from their background compaction threads
    and from compact_db; K2 calls = in-RAM compactions + stream chunks
    (the port's Stats, by replica), K3 calls = the in-RAM compactions'
    files, no K1; C launched nothing; no compaction raised and no replica
    is left in background error."""
    import hashlib
    import os
    import threading

    import numpy as np
    import torch

    from rocksplicator_tpu_torch.admin import AdminHandler
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.replication import (ReplicationFlags,
                                                     Replicator)
    from rocksplicator_tpu_torch.rpc import IoLoop, RpcClientPool, RpcServer
    from rocksplicator_tpu_torch.storage import DBOptions
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.utils import objectstore
    from rocksplicator_tpu_torch.utils.s3_stub import S3StubServer

    def counter_options(segment):
        return DBOptions(merge_operator=UInt64AddOperator(),
                         wal_ttl_seconds=3600.0, bits_per_key=10,
                         background_compaction=True, max_subcompactions=1,
                         memtable_bytes=REPL_MEMTABLE_BYTES)

    root = os.path.join(work_dir, "replicated")
    os.makedirs(root)
    _sort_flag(SEAM_FLAGS["fused"])
    flags = ReplicationFlags()
    nodes = {}
    log = _CompactionLog()
    pool, ioloop = RpcClientPool(), IoLoop.default()
    saved_env = {k: os.environ.get(k) for k in (
        "AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "RSTPU_S3_ENDPOINT")}
    s3 = S3StubServer(access_key="repl-access", secret_key="repl-secret")
    os.environ.update(AWS_ACCESS_KEY_ID="repl-access",
                      AWS_SECRET_ACCESS_KEY="repl-secret",
                      RSTPU_S3_ENDPOINT=s3.start())

    def call(tag, method, **args):
        async def go():
            return await pool.call("127.0.0.1", nodes[tag][2].port, method,
                                   args, timeout=900)
        return ioloop.run_sync(go())

    def app_db(tag):
        return nodes[tag][1].db_manager.get_db(REPL_DB)

    def digests(tag):
        db = app_db(tag).db
        return sorted(hashlib.sha256(open(os.path.join(db.path, n),
                                          "rb").read()).hexdigest()
                      for level in db._levels for n in level)

    def seq(tag):
        return call(tag, "get_sequence_number", db_name=REPL_DB)["seq_num"]

    report = {"card": card, "ops": 4 * traffic["run_entries"],
              "batch": ENGINE_BATCH, "mode": 1,
              "write_window": flags.write_window,
              "ack_timeout_ms": flags.ack_timeout_ms}
    t_setup = time.time()
    log.install()
    try:
        for tag, kw in (("A", {"device": dev}), ("B", {"device": dev}),
                        ("C", {"gpu_compaction": False}),
                        ("D", {"device": dev})):
            replicator = Replicator(port=0, flags=flags)
            handler = AdminHandler(os.path.join(root, tag), replicator,
                                   options_generator=counter_options, **kw)
            server = RpcServer(port=0, ioloop=replicator.ioloop)
            server.add_handler(handler)
            server.start()
            nodes[tag] = (replicator, handler, server)
        call("A", "add_db", db_name=REPL_DB, role="LEADER",
             replication_mode=1)
        for tag in ("B", "C"):
            call(tag, "add_db", db_name=REPL_DB, role="FOLLOWER",
                 upstream_ip="127.0.0.1", upstream_port=nodes["A"][0].port,
                 replication_mode=1)
        for tag in ("A", "B", "C"):
            log.owner[id(app_db(tag).db._backend)] = tag
        backends = {t: type(app_db(t).db._backend).__name__
                    for t in ("A", "B", "C")}
        if backends != {"A": "GpuCompactionBackend",
                        "B": "GpuCompactionBackend",
                        "C": "NativeCompactionBackend"}:
            raise AssertionError(f"replicated counter: backends {backends}")
        report["setup_s"] = time.time() - t_setup
        leader = app_db("A")
        waiters, acks = [], []

        class Pipelined:
            """write() as the counter service writes: write_async, the
            ack awaited later; the window's flow control bounds the
            writes in flight."""

            @staticmethod
            def write(batch):
                t = time.perf_counter()
                w = leader.write_async(batch)
                w.future.add_done_callback(
                    lambda _f, t=t: acks.append(time.perf_counter() - t))
                waiters.append(w)

        # A, B and C each flush once a run's last op has reached them, in
        # a thread of their own: the background flush merges memtables
        # that queue behind a slow flush into one L0 file, so the four
        # runs left as few as 2 files a replica, and the background pick
        # (the L0 trigger, 4) then raced compact_db's flush and merge,
        # which won once on the card
        seq0 = leader.latest_sequence_number()
        run_ends = [seq0 + sum(len(r[0]) for r in traffic["ops"][:k + 1])
                    for k in range(len(traffic["ops"]))]
        flush_errors, stop_flush = [], threading.Event()

        def flush_at_run_ends(tag):
            db = app_db(tag).db
            try:
                for end in run_ends:
                    while db.latest_sequence_number() < end:
                        if stop_flush.wait(0.02):
                            return
                    db.flush()
            except Exception as exc:
                flush_errors.append((tag, repr(exc)))

        flushers = [threading.Thread(target=flush_at_run_ends, args=(t,),
                                     daemon=True, name=f"repl-flush-{t}")
                    for t in ("A", "B", "C")]
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.time()
        for t in flushers:
            t.start()
        try:
            for ids, vtype, vals, key_bytes in traffic["ops"]:
                _write_ops(Pipelined, ids, vtype, vals, key_bytes,
                           range(len(ids)))
            submit_s = time.time() - t0
            for w in waiters:
                w.result(timeout=900)
            write_s = time.time() - t0
            want = leader.latest_sequence_number()
            lag = {t: want - app_db(t).latest_sequence_number()
                   for t in ("B", "C")}
            deadline = time.time() + 900
            while seq("B") != want or seq("C") != want:
                if time.time() > deadline:
                    raise AssertionError(f"replicated counter: followers "
                                         f"at {seq('B')}, {seq('C')} of "
                                         f"{want}")
                time.sleep(0.05)
            catch_up_s = time.time() - t0 - write_s
            for t in flushers:
                t.join(300)
        finally:
            stop_flush.set()
        if flush_errors or any(t.is_alive() for t in flushers):
            raise AssertionError(f"replicated counter: flushes "
                                 f"{flush_errors}")

        def background_calls(tag):
            return sum(1 for c in list(log.calls) if c["replica"] == tag
                       and c["thread"].startswith("lsm-compact-"))

        # at least 4 L0 files: each card replica's background compaction
        # runs, and is let finish before compact_db (the check below
        # fails if it never comes)
        deadline = time.time() + 300
        while (background_calls("A") < 1 or background_calls("B") < 1) \
                and time.time() < deadline:
            time.sleep(0.05)
        acked = sum(1 for w in waiters if w.acked)
        lat = sorted(acks)
        report.update(
            batches=len(waiters), acked=acked, seq=want,
            submit_s=submit_s, write_s=write_s,
            ops_per_s=4 * traffic["run_entries"] / write_s,
            ack_p50_ms=1e3 * lat[len(lat) // 2],
            ack_p99_ms=1e3 * lat[min(len(lat) - 1, (99 * len(lat)) // 100)],
            follower_lag_seqs_at_end=lag, follower_catch_up_s=catch_up_s,
            levels_before_compact_db={
                t: [len(f) for f in app_db(t).db._levels]
                for t in ("A", "B", "C")})
        compact_s = {}
        for tag in ("A", "B", "C"):
            t1 = time.time()
            call(tag, "compact_db", db_name=REPL_DB)
            compact_s[tag] = time.time() - t1
        torch.cuda.synchronize()
        report["compact_db_s"] = compact_s
        files = {t: digests(t) for t in ("A", "B", "C")}
        seqs = {t: seq(t) for t in ("A", "B", "C")}
        if not files["A"] or files["A"] != files["B"] \
                or files["A"] != files["C"]:
            raise AssertionError(f"replicated counter: files differ {files}")
        if len(set(seqs.values())) != 1 or seqs["A"] != want:
            raise AssertionError(f"replicated counter: seqs {seqs}")
        report["files"] = len(files["A"])
        report["read_back"] = {
            t: check_read_back(app_db(t), traffic,
                               f"replicated counter {t}", scan=False)
            for t in ("A", "B")}
        t1 = time.time()
        backup = call("B", "backup_db_to_s3", db_name=REPL_DB,
                      s3_bucket="s3://replicated",
                      s3_backup_dir=f"backups/{REPL_DB}")
        report["backup_s"] = time.time() - t1
        t1 = time.time()
        restored = call("D", "restore_db_from_s3", db_name=REPL_DB,
                        s3_bucket="s3://replicated",
                        s3_backup_dir=f"backups/{REPL_DB}")
        report["restore_s"] = time.time() - t1
        log.owner[id(app_db("D").db._backend)] = "D"
        if digests("D") != files["B"] or backup["seq"] != seqs["B"] \
                or restored["seq"] != seqs["B"] or seq("D") != seqs["B"]:
            raise AssertionError(f"replicated counter: restore {restored} "
                                 f"of backup {backup}")
        rng = np.random.default_rng(901)
        sample = np.sort(rng.choice(traffic["touched"], min(
            REPL_SAMPLE_KEYS, len(traffic["touched"])), replace=False))
        report["read_back"]["D"] = check_read_back(
            app_db("D"), traffic, "replicated counter D", ids=sample,
            scan=False)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        bg = {t: (app_db(t).db._bg_compaction_error,
                  app_db(t).db._bg_compaction_failures,
                  app_db(t).db._bg_flush_failures) for t in ("A", "B", "C")}
    finally:
        log.uninstall()
        ioloop.run_sync(pool.close())
        for replicator, handler, server in nodes.values():
            server.stop()
            handler.close()
            replicator.stop()
        s3.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        with objectstore._store_cache_lock:
            objectstore._store_cache.clear()
        _sort_flag(None)
    if log.errors:
        raise AssertionError(f"replicated counter: compactions raised "
                             f"{log.errors}")
    if any(err is not None or fails for err, fails, _fl in bg.values()) \
            or any(fl for _e, _f, fl in bg.values()):
        raise AssertionError(f"replicated counter: background errors {bg}")
    per = {t: log.of(t) for t in ("A", "B", "C", "D")}
    stray = [x for x in log.launches if x[1] not in ("A", "B", "D")]
    if stray:
        raise AssertionError(f"replicated counter: launches outside the "
                             f"card replicas' compactions {stray[:8]}")
    for tag in ("A", "B"):
        p = per[tag]
        k2 = {k: v for k, v in p["launches"].items()
              if k.startswith("fused_resolve@")}
        if k2.get("fused_resolve@background", 0) < 1 \
                or k2.get("fused_resolve@compact_db", 0) < 1:
            raise AssertionError(f"replicated counter {tag}: K2 from "
                                 f"{p['launches']}")
        n_k2 = sum(k2.values())
        n_k3 = sum(v for k, v in p["launches"].items()
                   if k.startswith("bloom_build@"))
        n_k1 = sum(v for k, v in p["launches"].items()
                   if k.startswith("bitonic_sort@"))
        if n_k2 != p["in_ram"] + p["stream_chunks"] \
                or p["stream_chunks"] != p["backend_chunks"] \
                or p["in_ram"] != p["in_ram_by_backend"] \
                or n_k3 != p["in_ram_files"] or n_k1 != 0:
            raise AssertionError(f"replicated counter {tag}: K2 {n_k2}, K3 "
                                 f"{n_k3}, K1 {n_k1} against {p}")
    if per["C"]["launches"] or per["C"]["calls"] < 1:
        raise AssertionError(f"replicated counter C: {per['C']}")
    report["compactions"] = per
    report["launches"] = launches
    return report, launches


# ---- the counter service as the README's quick start starts it ------------
# counter_service: two port node processes from the quick start's static
# shard map (segment "counter", 2 shards), bulk-loaded with COUNTERS
# counters through add_s3_sst_files_to_db on every replica, then the
# port's stress_test, compact_db, reads, the status plane and SIGTERM.
# The counters halved (2^21 before) once a card run of the whole command,
# at 1,062.0 s on one H100 host, went past its 1,200 s limit on another;
# halved again (2^20 before), with the stress requests and the read sample,
# once the whole command, at 888.3 s on one H100 host, went past its limit
# on another, where the host-bound phases ran up to 1.9 times as long;
# halved again (2^19 before), with the stress requests and the read sample,
# to pay for the chaos harness's reshard and rebalance decks (about 100 s)
# inside the command's time
COUNTERS = 1 << 18
COUNTER_SHARDS = 2
COUNTER_FILES = 4  # SST files a shard's bulk load
COUNTER_SEED = 1010
STRESS_THREADS = 8
# the stress requests and the read sample halved (16,384 each before) for
# the command's time once cluster_reshape came: with them and that phase's
# own two cuts the command took 1363.9 s on the card; the requests halved
# again with the counters, twice
STRESS_REQUESTS = 1024
COUNTER_SAMPLE = 2048  # loaded counters read back from every replica
COUNTER_READ_WINDOW = 512  # get_counter calls in flight at once
COUNTER_DRAIN_S = 10.0  # GracefulShutdownHandler's default drain timeout
# the nodes run the quick start's command; the device is its default,
# the card (a rehearsal on the CPU adds "--device", "cpu" and lowers the
# launch floor)
COUNTER_NODE_ARGS: tuple = ()
COUNTER_MIN_LAUNCHES = 2
# the performance harness's sub-phase, warm-up and linger cut to seconds;
# the keys a shard's thread writes 4,096 → 2,048 for the chaos harness's
# reshard and rebalance decks
PERF_ARGS = ("--num_shards", "8", "--num_keys_per_shard_thread", "2048",
             "--value_size", "1024")
PERF_WARMUP_S = 3
PERF_LINGER_S = 3


def _free_port(pair: bool = False) -> int:
    """A free TCP port on 127.0.0.1 (``pair``: the one above it is free
    too, for the service port + 1 replication convention)."""
    import socket

    for _ in range(200):
        socks = []
        try:
            s = socket.socket()
            socks.append(s)
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            if pair:
                t = socket.socket()
                socks.append(t)
                t.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError("no free port pair")


def _child_env(**extra) -> dict:
    """The environment of a child process of the port: the checkout on
    its path, this host's loopback as its address."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RSTPU_LOCAL_IP="127.0.0.1")
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update(extra)
    return env


def _wait_line(proc, log_path: str, prefix: str, timeout: float) -> str:
    """The first line of ``log_path`` that starts with ``prefix``; raises
    when the process exits or the time runs out first."""
    deadline = time.time() + timeout
    while True:
        with open(log_path) as f:
            for line in f:
                if line.startswith(prefix):
                    return line.strip()
        if proc.poll() is not None:
            raise AssertionError(f"{prefix}: the process exited "
                                 f"{proc.returncode}: {_tail(log_path)}")
        if time.time() > deadline:
            raise AssertionError(f"{prefix}: no such line in {timeout} s: "
                                 f"{_tail(log_path)}")
        time.sleep(0.1)


def _tail(path: str, n: int = 3000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def _http_get(port: int, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read().decode()


def _stats_counters(text: str) -> dict:
    """{name with tags: total} of the counter lines of /stats.txt."""
    out = {}
    for line in text.splitlines():
        if line.startswith("counter "):
            name, rest = line[8:].rsplit(" total=", 1)
            out[name] = float(rest.split()[0])
    return out


def stress_streams(threads: int, requests: int, counters: int,
                   read_ratio: float):
    """The stress test's requests replayed from its seeded streams
    (``random.Random(tid)`` a thread): the bumps per counter index, and
    the count of gets."""
    import collections
    import random

    bumps, gets = collections.Counter(), 0
    for tid in range(threads):
        rng = random.Random(tid)
        for _ in range(requests):
            i = rng.randrange(counters)
            if rng.random() < read_ratio:
                gets += 1
            else:
                bumps[i] += 1
    return bumps, gets


def counter_service(work_dir: str, card: str) -> tuple:
    """The README's quick start on the card: two port counter-service
    processes (``python -m rocksplicator_tpu_torch.examples.
    counter_service.counter_service --rocksdb_dir ... --port ...
    --status_port ... --shard_map_path ...``, the default device, the
    card) from one static shard map: A leads shard 00000 and follows
    00001, B the reverse. Each writes its launch counts at exit
    (RSTPU_LAUNCH_COUNTS_FILE).

    1. bulk load: COUNTERS counters ``counter-<i>`` with seeded int64
       values, each in the shard the port's ``shard_for`` names, written
       per shard as COUNTER_FILES SST files by the port's SSTWriter
       (10 bits a key) into a local object store; add_s3_sst_files_to_db(
       compact_db_after_load=True) on every replica at once, each ending
       in its node's BatchCompactor (K2, K3);
    2. the port's stress_test against A (STRESS_THREADS threads of
       STRESS_REQUESTS routed gets and bumps over every counter): rc 0,
       errors=0;
    3. compact_db by RPC on every replica, timed, with the admin span
       tree from /traces;
    4. once each follower's sequence number equals its leader's,
       get_counter without routing from the leader and the follower of
       each shard, for COUNTER_SAMPLE seeded loaded counters and then
       every counter the stress run bumped (its streams replayed): each
       equals the numpy oracle, load + bumps;
    5. /stats.txt and /hotkeys.txt of both status servers: the port's
       compaction counters nonzero, the hot keys non-empty and the top
       ones among the bumped counters;
    6. SIGTERM to both: each exits 0 within the drain timeout, its launch
       counts written, K2 and K3 at least COUNTER_MIN_LAUNCHES each;
    7. each replica's directory reopened by a port DB on the host backend
       and scanned: a shard's leader and follower hold the same pairs,
       equal to the oracle.
    """
    import os
    import signal
    import struct

    import numpy as np

    from rocksplicator_tpu_torch.examples.counter_service.counter_router \
        import shard_for
    from rocksplicator_tpu_torch.rpc import IoLoop, RpcClientPool
    from rocksplicator_tpu_torch.storage import DB, DBOptions
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.native_compaction import (
        NativeCompactionBackend)
    from rocksplicator_tpu_torch.storage.records import OpType
    from rocksplicator_tpu_torch.storage.sst import SSTWriter
    from rocksplicator_tpu_torch.utils.segment_utils import (
        segment_to_db_name)

    root = os.path.join(work_dir, "counter_service")
    os.makedirs(root)
    report = {"card": card, "counters": COUNTERS, "shards": COUNTER_SHARDS,
              "files_per_shard": COUNTER_FILES, "seed": COUNTER_SEED}
    seconds = {}
    t_phase = time.time()

    # ---- the data and the shard map ------------------------------------
    t0 = time.time()
    rng = np.random.default_rng(COUNTER_SEED)
    values = rng.integers(-(1 << 40), 1 << 40, COUNTERS, dtype=np.int64)
    names = [f"counter-{i}" for i in range(COUNTERS)]
    shard_of = np.fromiter((shard_for(n, COUNTER_SHARDS) for n in names),
                           dtype=np.int64, count=COUNTERS)
    store = os.path.join(root, "store")
    pack = struct.Struct("<q").pack
    sst_bytes = 0
    for s in range(COUNTER_SHARDS):
        ids = sorted(np.nonzero(shard_of == s)[0].tolist(),
                     key=lambda i: names[i].encode())
        prefix = os.path.join(store, "counter", f"{s:05d}")
        os.makedirs(prefix)
        for f in range(COUNTER_FILES):
            path = os.path.join(prefix, f"part-{f}.tsst")
            w = SSTWriter(path, bits_per_key=10)
            for i in ids[f::COUNTER_FILES]:
                w.add(names[i].encode(), 0, OpType.PUT, pack(int(values[i])))
            w.finish()
            sst_bytes += os.path.getsize(path)
    report["per_shard"] = np.bincount(shard_of,
                                      minlength=COUNTER_SHARDS).tolist()
    report["sst_bytes"] = sst_bytes
    seconds["write_ssts"] = time.time() - t0
    ports = {t: _free_port(pair=True) for t in ("A", "B")}
    status = {t: _free_port() for t in ("A", "B")}
    shard_map = {"counter": {
        "num_shards": COUNTER_SHARDS,
        f"127.0.0.1:{ports['A']}:az1": ["00000:M", "00001:S"],
        f"127.0.0.1:{ports['B']}:az1": ["00000:S", "00001:M"]}}
    map_path = os.path.join(root, "shard_map.json")
    with open(map_path, "w") as f:
        json.dump(shard_map, f)
    roles = {0: ("A", "B"), 1: ("B", "A")}  # shard -> (leader, follower)

    procs, logs, counts = {}, {}, {}
    pool, ioloop = RpcClientPool(), IoLoop.default()

    def call(tag, method, timeout=600, **args):
        async def go():
            return await pool.call("127.0.0.1", ports[tag], method, args,
                                   timeout=timeout)
        return ioloop.run_sync(go())

    def calls(requests, timeout=600):
        """(tag, method, args) requests, COUNTER_READ_WINDOW in flight at
        once; their results in order, each with its host seconds."""
        import asyncio

        async def one(t, m, a):
            t0 = time.time()
            out = await pool.call("127.0.0.1", ports[t], m, a,
                                  timeout=timeout)
            return out, time.time() - t0

        async def go(part):
            return await asyncio.gather(*(one(*r) for r in part))
        out = []
        for s in range(0, len(requests), COUNTER_READ_WINDOW):
            out += ioloop.run_sync(go(requests[s:s + COUNTER_READ_WINDOW]))
        return out

    try:
        # ---- start: the quick start's two commands -----------------------
        t0 = time.time()
        for tag in ("A", "B"):
            logs[tag] = os.path.join(root, f"node_{tag}.log")
            counts[tag] = os.path.join(root, f"launches_{tag}.json")
            with open(logs[tag], "w") as out:
                procs[tag] = subprocess.Popen(
                    [sys.executable, "-m", "rocksplicator_tpu_torch."
                     "examples.counter_service.counter_service",
                     "--rocksdb_dir", os.path.join(root, f"node_{tag}"),
                     "--port", str(ports[tag]),
                     "--status_port", str(status[tag]),
                     "--shard_map_path", map_path, *COUNTER_NODE_ARGS],
                    stdout=out, stderr=subprocess.STDOUT,
                    env=_child_env(RSTPU_LAUNCH_COUNTS_FILE=counts[tag]))
        up = {t: _wait_line(procs[t], logs[t], "counter_service up:", 300)
              for t in ("A", "B")}
        for tag, line in up.items():
            if not line.endswith("dbs=2"):
                raise AssertionError(f"counter service {tag}: {line}")
        report["up"] = up
        seconds["start"] = time.time() - t0

        # ---- 1. bulk load on every replica ------------------------------
        t0 = time.time()
        loads = calls([
            (tag, "add_s3_sst_files_to_db",
             {"db_name": segment_to_db_name("counter", s),
              "s3_bucket": "local://" + store,
              "s3_path": f"counter/{s:05d}/",
              "compact_db_after_load": True})
            for s in range(COUNTER_SHARDS) for tag in roles[s]],
            timeout=900)
        seconds["load"] = time.time() - t0
        report["load_results"] = [r for r, _s in loads]
        report["load_s"] = [s for _r, s in loads]

        def seqs():
            return {s: tuple(call(t, "get_sequence_number",
                                  db_name=segment_to_db_name("counter", s))
                             ["seq_num"] for t in roles[s])
                    for s in range(COUNTER_SHARDS)}
        report["seqs_after_load"] = seqs()

        # ---- 2. the port's stress_test against A -------------------------
        t0 = time.time()
        stress = subprocess.run(
            [sys.executable, "-m", "rocksplicator_tpu_torch.examples."
             "counter_service.stress_test", "--port", str(ports["A"]),
             "--threads", str(STRESS_THREADS),
             "--requests", str(STRESS_REQUESTS),
             "--counters", str(COUNTERS), "--read_ratio", "0.5"],
            env=_child_env(), capture_output=True, text=True, timeout=1200)
        seconds["stress"] = time.time() - t0
        line = [ln for ln in stress.stdout.splitlines()
                if ln.startswith("stress:")]
        if stress.returncode != 0 or not line \
                or not line[-1].endswith("errors=0"):
            raise AssertionError(f"stress_test: rc {stress.returncode}: "
                                 f"{stress.stdout[-2000:]}"
                                 f"{stress.stderr[-2000:]}")
        report["stress_line"] = line[-1]
        report["qps"] = float(line[-1].split(" = ")[1].split()[0])
        bumps, gets = stress_streams(STRESS_THREADS, STRESS_REQUESTS,
                                     COUNTERS, 0.5)
        bumped = sorted(bumps)
        report["stress"] = {
            "requests": STRESS_THREADS * STRESS_REQUESTS, "gets": gets,
            "bumps": sum(bumps.values()), "counters_bumped": len(bumped),
            "bumps_forwarded": sum(v for i, v in bumps.items()
                                   if shard_of[i] != 0)}

        # ---- 3. compact_db on every replica: the leaders, one a process,
        #         then the followers -----------------------------------
        t0 = time.time()
        compact_s = {}
        for r in range(2):
            batch = [(roles[s][r], segment_to_db_name("counter", s))
                     for s in range(COUNTER_SHARDS)]
            done = calls([(tag, "compact_db", {"db_name": db})
                          for tag, db in batch], timeout=900)
            for (tag, db), (_out, secs) in zip(batch, done):
                compact_s[f"{tag}/{db}"] = secs
        report["compact_db_s"] = compact_s
        seconds["compact_db"] = time.time() - t0
        report["compact_db_spans"] = {
            t: _compact_spans(_http_get(status[t], "/traces"))
            for t in ("A", "B")}

        # ---- 4. read back through the service ----------------------------
        t0 = time.time()
        deadline = time.time() + 300
        while True:
            now = seqs()
            if all(a == b for a, b in now.values()):
                break
            if time.time() > deadline:
                raise AssertionError(f"counter service: seqs {now}")
            time.sleep(0.05)
        report["seqs"] = now
        oracle = values.copy()
        for i, v in bumps.items():
            oracle[i] += v
        sample = np.sort(np.random.default_rng(COUNTER_SEED + 1).choice(
            COUNTERS, COUNTER_SAMPLE, replace=False)).tolist()
        # each node reads its replicas of both shards, the sampled
        # counters first and the bumped ones last; the two nodes' reads
        # interleave, so both serve at once
        per_node = {tag: [(tag, i) for ids in (sample, bumped) for i in ids]
                    for tag in ("A", "B")}
        order = [r for pair in zip(per_node["A"], per_node["B"])
                 for r in pair]
        got = calls([(tag, "get_counter", {"counter_name": names[i],
                                           "need_routing": False})
                     for tag, i in order])
        for (tag, i), (r, _secs) in zip(order, got):
            if r["counter_value"] != int(oracle[i]):
                raise AssertionError(
                    f"counter service {tag}: {names[i]} reads "
                    f"{r['counter_value']}, want {int(oracle[i])}")
        lat = sorted(secs for _r, secs in got)
        report["reads"] = len(order)
        report["read_ms_p50_p99"] = [1e3 * lat[len(lat) // 2],
                                     1e3 * lat[(99 * len(lat)) // 100]]
        seconds["reads"] = time.time() - t0

        # ---- 5. the status plane -----------------------------------------
        t0 = time.time()
        report["status"] = {}
        bumped_names = {names[i] for i in bumped}
        for tag in ("A", "B"):
            ctrs = _stats_counters(_http_get(status[tag], "/stats.txt"))
            compaction = {k: v for k, v in ctrs.items()
                          if k.startswith("compaction.")}
            if not compaction or not all(compaction.values()):
                raise AssertionError(f"counter service {tag}: compaction "
                                     f"counters {compaction}")
            hot = [ln.split()[0] for ln in _http_get(
                status[tag], "/hotkeys.txt").splitlines() if ln.strip()]
            if not hot or not set(hot[:10]) <= bumped_names:
                raise AssertionError(f"counter service {tag}: hot keys "
                                     f"{hot[:10]}")
            report["status"][tag] = {"compaction_counters": compaction,
                                     "hot_keys": len(hot),
                                     "top_hot_keys": hot[:5]}
        seconds["status"] = time.time() - t0

        # ---- 6. graceful shutdown ----------------------------------------
        t0 = time.time()
        exits = {}
        for tag in ("A", "B"):
            procs[tag].send_signal(signal.SIGTERM)
        for tag in ("A", "B"):
            try:
                rc = procs[tag].wait(COUNTER_DRAIN_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"counter service {tag}: no exit "
                                     f"{COUNTER_DRAIN_S} s after SIGTERM: "
                                     f"{_tail(logs[tag])}")
            exits[tag] = {"rc": rc, "seconds": time.time() - t0}
            if rc != 0:
                raise AssertionError(f"counter service {tag}: rc {rc}: "
                                     f"{_tail(logs[tag])}")
        seconds["shutdown"] = time.time() - t0
        report["exits"] = exits
        launches = {}
        for tag in ("A", "B"):
            if not os.path.exists(counts[tag]):
                raise AssertionError(f"counter service {tag}: no launch "
                                     f"counts written")
            with open(counts[tag]) as f:
                launches[tag] = json.load(f)
            if launches[tag]["fused_resolve"] < COUNTER_MIN_LAUNCHES \
                    or launches[tag]["bloom_build"] < COUNTER_MIN_LAUNCHES:
                raise AssertionError(f"counter service {tag}: launches "
                                     f"{launches[tag]}")
        report["launches_by_process"] = launches
    finally:
        ioloop.run_sync(pool.close())
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # ---- 7. scan every replica on the host -------------------------------
    t0 = time.time()
    for s in range(COUNTER_SHARDS):
        want = sorted((names[i].encode(), pack(int(oracle[i])))
                      for i in np.nonzero(shard_of == s)[0].tolist())
        scans = {}
        for tag in roles[s]:
            db = DB(os.path.join(root, f"node_{tag}",
                                 segment_to_db_name("counter", s)),
                    DBOptions(merge_operator=UInt64AddOperator(),
                              compaction_backend=NativeCompactionBackend()))
            try:
                scans[tag] = list(db.new_iterator())
            finally:
                db.close()
        leader, follower = (scans[t] for t in roles[s])
        if leader != follower:
            raise AssertionError(f"counter service shard {s}: leader and "
                                 f"follower scans differ")
        if leader != want:
            raise AssertionError(f"counter service shard {s}: scan differs "
                                 f"from the oracle")
    seconds["scan"] = time.time() - t0
    seconds["phase"] = time.time() - t_phase
    report["seconds"] = seconds
    total = {k: sum(c[k] for c in launches.values())
             for k in ("bitonic_sort", "fused_resolve", "bloom_build")}
    return report, total


def _compact_spans(traces_json: str) -> list:
    """The admin.compact_db spans of /traces with their descendants:
    (name, ms) per span of each such trace."""
    doc = json.loads(traces_json)
    out = []
    for trace in doc["traces"]:
        spans = trace["spans"]
        if not any(s["name"] == "admin.compact_db" for s in spans):
            continue
        out.append([(s["name"], round(s["duration_ms"], 3))
                    for s in spans])
    return out


def performance(work_dir: str, card: str) -> tuple:
    """The port's replication throughput harness as two processes, a
    follower and then a leader, by the module docstring's commands at
    PERF_ARGS, warm-up and linger cut to seconds: the leader exits 0 and
    prints its throughput line; the follower, stopped by SIGINT, exits 0
    (the seqs it last reported are recorded: in ack mode 0 a follower in
    connect backoff may not catch up within the cut linger). Both write
    their launch counts."""
    import os
    import signal

    root = os.path.join(work_dir, "performance")
    os.makedirs(root)
    lp, fp_ = _free_port(), _free_port()
    counts = {r: os.path.join(root, f"launches_{r}.json")
              for r in ("leader", "follower")}
    log = os.path.join(root, "follower.log")
    mod = "rocksplicator_tpu_torch.replication.performance"
    t0 = time.time()
    with open(log, "w") as out:
        follower = subprocess.Popen(
            [sys.executable, "-m", mod, "--role", "follower", "--port",
             str(fp_), "--upstream_port", str(lp), "--db_dir",
             os.path.join(root, "f"), *PERF_ARGS, *COUNTER_NODE_ARGS],
            stdout=out, stderr=subprocess.STDOUT,
            env=_child_env(RSTPU_LAUNCH_COUNTS_FILE=counts["follower"]))
    try:
        _wait_line(follower, log, "follower:", 300)
        leader = subprocess.run(
            [sys.executable, "-m", mod, "--role", "leader", "--port",
             str(lp), "--db_dir", os.path.join(root, "l"), *PERF_ARGS,
             "--warmup_wait_sec", str(PERF_WARMUP_S),
             "--linger_sec", str(PERF_LINGER_S), *COUNTER_NODE_ARGS],
            env=_child_env(RSTPU_LAUNCH_COUNTS_FILE=counts["leader"]),
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in leader.stdout.splitlines()
                 if ln.startswith("leader ")]
        if leader.returncode != 0 or len(lines) < 2:
            raise AssertionError(f"performance leader: rc "
                                 f"{leader.returncode}: "
                                 f"{leader.stdout[-2000:]}"
                                 f"{leader.stderr[-2000:]}")
        follower.send_signal(signal.SIGINT)
        rc = follower.wait(60)
        if rc != 0:
            raise AssertionError(f"performance follower: rc {rc}: "
                                 f"{_tail(log)}")
    finally:
        if follower.poll() is None:
            follower.kill()
            follower.wait()
    launches = {}
    for role, path in counts.items():
        with open(path) as f:
            launches[role] = json.load(f)
    totals = [ln for ln in open(log).read().splitlines()
              if ln.startswith("follower total seq:")]
    report = {"card": card, "args": list(PERF_ARGS),
              "follower_last_total_seq": totals[-1] if totals else None,
              "warmup_wait_sec": PERF_WARMUP_S,
              "linger_sec": PERF_LINGER_S, "acked_line": lines[0],
              "throughput_line": lines[1],
              "mb_per_s": float(lines[1].split(" = ")[1].split()[0]),
              "seconds": time.time() - t0,
              "launches_by_process": launches}
    total = {k: sum(c[k] for c in launches.values())
             for k in ("bitonic_sort", "fused_resolve", "bloom_build")}
    return report, total


# ---- the CDC ingestion stack: a Kafka topic into a semi-sync shard ---------
# cdc_ingest: BASELINE.json configs[3] ("cdc_admin Kafka WAL-tail, 3-replica
# semi-sync, sustained 100K writes/s -> rolling compaction"): CDC_RECORDS
# records from partition 0 of an embedded topic into a three-replica shard
# in ack mode 1, with a CDC observer on the leader. The cuts, of depth,
# for the command's time: 2^19 records (the phase took 469 s at 2^20, most
# of it the consumer's backpressure sleeps), then 2^18 once cluster_reshape
# came (the command took 1363.9 s at 2^19 with that phase's own two cuts),
# then 2^17 with the counter service's counters, then 2^16 and 2^15 with
# them again, the key space halved each time and the preload kept at a
# quarter
CDC_RECORDS = 1 << 15
CDC_KEY_SPACE = 1 << 14  # each key written about twice
CDC_VALUE_BYTES = 256  # the macro bench's --cdc_value_bytes default
CDC_DELETE_SHARE = 0.1  # empty values, applied as DELETEs
CDC_PRELOAD = CDC_RECORDS // 4  # produced before start_message_ingestion
CDC_RATE = 100_000  # records/s offered after it, open loop
CDC_SEED = 1111
CDC_DB = "seg00000"  # shard 0 reads partition 0
CDC_MEMTABLE_BYTES = 8 << 20  # the engine's default
CDC_READ_SLICE = 1 << 14
# cdc_network: the networked broker and the consumer app as processes;
# 2^13 records (2^14 until the reshard and rebalance decks came, for the
# command's time: its producers and the app printing every record took
# 30 of its 45 s)
CDC_NET_RECORDS = 1 << 13
CDC_NET_PRODUCERS = 8
CDC_NET_DB = "seg00001"  # unreplicated, on the leader's node; partition 1


def cdc_stream(n: int, key_space: int, seed: int) -> dict:
    """A seeded CDC stream: record i writes key ``b"cdc%08d" % ids[i]``
    with a CDC_VALUE_BYTES value, or deletes it (``deletes[i]``); and the
    numpy oracle, last write in stream order wins: each touched key's last
    record, and the keys it leaves live."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, key_space, n)
    deletes = rng.random(n) < CDC_DELETE_SHARE
    values = rng.integers(0, 256, (n, CDC_VALUE_BYTES), dtype=np.uint8)
    last = np.full(key_space, -1, dtype=np.int64)
    np.maximum.at(last, ids, np.arange(n))
    touched = np.flatnonzero(last >= 0)
    live = touched[~deletes[last[touched]]]
    return {"n": n, "ids": ids, "deletes": deletes, "values": values,
            "last": last, "touched": touched, "live": live,
            "bytes": int(n * 11 + (~deletes).sum() * CDC_VALUE_BYTES)}


def cdc_record(stream: dict, i: int) -> tuple:
    return (b"cdc%08d" % stream["ids"][i],
            b"" if stream["deletes"][i] else stream["values"][i].tobytes())


def check_cdc_read_back(db, stream: dict, what: str,
                        order=None) -> dict:
    """Every touched key through multi_get and one full scan against the
    oracle (``order``: the records' positions in topic order, when that
    is not stream order). Returns host seconds and the reserved keys."""
    last = stream["last"]
    if order is not None:
        import numpy as np

        last = np.full(len(last), -1, dtype=np.int64)
        np.maximum.at(last, stream["ids"], order)
        pos = np.argsort(order)  # topic offset -> stream index
        last = np.where(last >= 0, pos[np.maximum(last, 0)], -1)
    touched = stream["touched"]

    def want(i):
        j = int(last[i])
        return None if stream["deletes"][j] \
            else stream["values"][j].tobytes()

    t0 = time.time()
    for s in range(0, len(touched), CDC_READ_SLICE):
        part = touched[s:s + CDC_READ_SLICE].tolist()
        got = db.multi_get([b"cdc%08d" % i for i in part])
        for i, g in zip(part, got):
            if g != want(i):
                raise AssertionError(f"{what}: cdc{i:08d} reads "
                                     f"{g!r:.40}, want {want(i)!r:.40}")
    t1 = time.time()
    live = [i for i in touched.tolist() if want(i) is not None]
    n, reserved = 0, {}
    for key, val in db.new_iterator():
        if key.startswith(b"\x00"):
            reserved[key] = val
            continue
        if n >= len(live) or key != b"cdc%08d" % live[n] \
                or val != want(live[n]):
            raise AssertionError(f"{what}: scan entry {n} is {key!r}")
        n += 1
    if n != len(live):
        raise AssertionError(f"{what}: scan gave {n} keys, want {len(live)}")
    return {"multi_get_s": t1 - t0, "scan_s": time.time() - t1,
            "keys_read": len(touched), "live_keys": n,
            "reserved_keys": sorted(k.decode("latin-1") for k in reserved)}


class _CdcTimes:
    """Host seconds and calls of the consumer's stages, wrapped at the
    class for the phase: fetch (``IngestionWatcher._drain``), batch build,
    the leader's commit (``ReplicatedDB.write_async_many``: WAL and
    memtable) and the grouped write (``ApplicationDB.write_many``: the
    commit and the wait for each batch's ack)."""

    def __init__(self):
        from rocksplicator_tpu_torch.admin.application_db import (
            ApplicationDB)
        from rocksplicator_tpu_torch.kafka.ingestion import IngestionWatcher
        from rocksplicator_tpu_torch.replication.replicated_db import (
            ReplicatedDB)

        self.totals = {}
        self._saved = []
        for key, cls, name in (
                ("fetch", IngestionWatcher, "_drain"),
                ("build", IngestionWatcher, "_build_batches"),
                ("commit", ReplicatedDB, "write_async_many"),
                ("write_many", ApplicationDB, "write_many")):
            real = getattr(cls, name)
            self._saved.append((cls, name, real))
            self.totals[key] = [0.0, 0]

            def timed(*args, _real=real, _key=key, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _real(*args, **kwargs)
                finally:
                    tot = self.totals[_key]
                    tot[0] += time.perf_counter() - t0
                    tot[1] += 1
            setattr(cls, name, timed)

    def reset(self):
        for tot in self.totals.values():
            tot[:] = [0.0, 0]

    def report(self) -> dict:
        out = {f"{k}_s": v[0] for k, v in self.totals.items()}
        out.update({f"{k}_calls": v[1] for k, v in self.totals.items()})
        # write_many waits each batch's ack after the commit
        out["ack_wait_s"] = out["write_many_s"] - out["commit_s"]
        return out

    def uninstall(self):
        for cls, name, real in self._saved:
            setattr(cls, name, real)


def cdc_ingest(dev, work_dir: str, card: str) -> tuple:
    """The CDC ingestion stack through the port's entry points: three
    nodes in this process, each a port Replicator and AdminHandler on a
    port RpcServer, shard CDC_DB in ack mode 1: A leads on the card, B
    follows on the card, C follows with gpu_compaction=False (the host's
    comparator); D, a port CdcAdminHandler on its own Replicator and
    RpcServer, observes A from before the first record and publishes
    every replicated batch through a QueuePublisher into topic
    ``cdc_out``. The engine's defaults (8 MiB memtable, L0 trigger 4, the
    256 MiB budget, auto stream) with background compaction and one slice
    a compaction; no merge operator.

    CDC_RECORDS records go into partition 0 of topic ``cdc_in`` on the
    port's embedded broker (``embedded://cdc``): the first CDC_PRELOAD
    before A's start_message_ingestion RPC (the watcher replays, then
    tails), the rest open loop at CDC_RATE a second. Once A has applied
    half, compact_db runs on C, B, A in turn while the stream goes on;
    after the drain, on each once more.

    Checks: every key reads back from A, B and C equal to the oracle
    (multi_get and a scan); the watermark and the applies counter equal
    CDC_RECORDS on each; ``kafka.cdc.records_applied`` equals it with no
    duplicate skipped and no consumer error; the replicas' live files are
    sha256-equal and their seqs equal; D published every seq of A once, in
    order, and its batches replayed give A's state; A's and B's K2 calls
    equal their compactions, every one of which took the engine's tuple
    path (CDC keys and the reserved watermark keys differ in width, so the
    direct sinks decline), with no K1 or K3; C launches nothing; no
    compaction raised and no replica is left in background error.

    Then ``cdc_network`` (see there) on A's node. Returns (cdc_ingest's
    report, its launches, cdc_network's report, its launches)."""
    import hashlib
    import os
    import threading

    import torch

    from rocksplicator_tpu_torch.admin import AdminHandler, CdcAdminHandler
    from rocksplicator_tpu_torch.kafka.broker import (MockConsumer,
                                                      get_cluster)
    from rocksplicator_tpu_torch.kafka.checkpoint import (read_applies,
                                                          read_watermark)
    from rocksplicator_tpu_torch.kafka.publisher import QueuePublisher
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.replication import (ReplicationFlags,
                                                     Replicator)
    from rocksplicator_tpu_torch.rpc import IoLoop, RpcClientPool, RpcServer
    from rocksplicator_tpu_torch.storage import DBOptions
    from rocksplicator_tpu_torch.storage.records import OpType, decode_batch
    from rocksplicator_tpu_torch.utils.stats import Stats

    def cdc_options(segment):
        return DBOptions(background_compaction=True, max_subcompactions=1,
                         memtable_bytes=CDC_MEMTABLE_BYTES)

    t_phase = time.time()
    root = os.path.join(work_dir, "cdc")
    os.makedirs(root)
    _sort_flag(SEAM_FLAGS["fused"])
    stream = cdc_stream(CDC_RECORDS, CDC_KEY_SPACE, CDC_SEED)
    broker = get_cluster("cdc")
    broker.create_topic("cdc_in", 1)
    flags = ReplicationFlags()
    nodes, servers = {}, []
    log = _CompactionLog()
    times = None
    pool, ioloop = RpcClientPool(), IoLoop.default()

    def call(port, method, **args):
        async def go():
            return await pool.call("127.0.0.1", port, method, args,
                                   timeout=900)
        return ioloop.run_sync(go())

    def admin(tag, method, **args):
        return call(nodes[tag][2].port, method, **args)

    def app_db(tag, name=CDC_DB):
        return nodes[tag][1].db_manager.get_db(name)

    def digests(tag):
        db = app_db(tag).db
        return sorted(hashlib.sha256(open(os.path.join(db.path, n),
                                          "rb").read()).hexdigest()
                      for level in db._levels for n in level)

    def applied():
        wm = read_watermark(app_db("A").db, "cdc_in", 0)
        return 0 if wm is None else wm["offset"]

    def produce(lo, hi, rate, base):
        t0 = time.perf_counter()
        for s in range(lo, hi, 1024):
            for i in range(s, min(s + 1024, hi)):
                key, val = cdc_record(stream, i)
                broker.produce("cdc_in", 0, key, val, timestamp_ms=base + i)
            if rate:
                due = t0 + (min(s + 1024, hi) - lo) / rate
                pause = due - time.perf_counter()
                if pause > 0:
                    time.sleep(pause)
        return time.perf_counter() - t0

    report = {"card": card, "records": CDC_RECORDS,
              "key_space": CDC_KEY_SPACE, "value_bytes": CDC_VALUE_BYTES,
              "delete_share": CDC_DELETE_SHARE, "preload": CDC_PRELOAD,
              "offered_rate": CDC_RATE, "mode": 1,
              "stream_bytes": stream["bytes"],
              "touched_keys": int(len(stream["touched"])),
              "live_keys": int(len(stream["live"]))}
    Stats.reset_for_test()
    log.install()
    try:
        t0 = time.time()
        for tag, kw in (("A", {"device": dev}), ("B", {"device": dev}),
                        ("C", {"gpu_compaction": False})):
            replicator = Replicator(port=0, flags=flags)
            handler = AdminHandler(os.path.join(root, tag), replicator,
                                   options_generator=cdc_options, **kw)
            server = RpcServer(port=0, ioloop=replicator.ioloop)
            server.add_handler(handler)
            server.start()
            nodes[tag] = (replicator, handler, server)
        observer_host = Replicator(port=0, flags=flags)
        observer = CdcAdminHandler(observer_host, QueuePublisher(
            "cdc_out", broker, num_partitions=1))
        observer_server = RpcServer(port=0, ioloop=observer_host.ioloop)
        observer_server.add_handler(observer)
        observer_server.start()
        servers.append((observer_server, observer, observer_host))
        admin("A", "add_db", db_name=CDC_DB, role="LEADER",
              replication_mode=1)
        for tag in ("B", "C"):
            admin(tag, "add_db", db_name=CDC_DB, role="FOLLOWER",
                  upstream_ip="127.0.0.1", upstream_port=nodes["A"][0].port,
                  replication_mode=1)
        for tag in ("A", "B", "C"):
            log.owner[id(app_db(tag).db._backend)] = tag
        backends = {t: type(app_db(t).db._backend).__name__
                    for t in ("A", "B", "C")}
        if backends != {"A": "GpuCompactionBackend",
                        "B": "GpuCompactionBackend",
                        "C": "NativeCompactionBackend"}:
            raise AssertionError(f"cdc ingest: backends {backends}")
        observed = call(observer_server.port, "add_observer", db_name=CDC_DB,
                        upstream_ip="127.0.0.1",
                        upstream_port=nodes["A"][0].port)
        if observed["start_seq"] != 0:
            raise AssertionError(f"cdc ingest: observer {observed}")
        report["preload_s"] = produce(0, CDC_PRELOAD, 0, 1000)
        report["setup_s"] = time.time() - t0
        times = _CdcTimes()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.time()
        admin("A", "start_message_ingestion", db_name=CDC_DB,
              topic_name="cdc_in", kafka_broker_serverset_path="embedded://cdc")
        tail = {}
        producer = threading.Thread(
            target=lambda: tail.update(seconds=produce(
                CDC_PRELOAD, CDC_RECORDS, CDC_RATE, 1000)),
            name="cdc-producer")
        producer.start()
        deadline = time.time() + 1800
        while applied() < CDC_RECORDS // 2:
            if time.time() > deadline:
                raise AssertionError(f"cdc ingest: {applied()} applied")
            time.sleep(0.05)
        report["half_applied_s"] = time.time() - t0
        rolling = {}
        for tag in ("C", "B", "A"):
            t1 = time.time()
            admin(tag, "compact_db", db_name=CDC_DB)
            rolling[tag] = time.time() - t1
        report["rolling_compact_db_s"] = rolling
        report["applied_after_rolling"] = applied()
        while applied() < CDC_RECORDS:
            if time.time() > deadline or not producer.is_alive() \
                    and broker.high_watermark("cdc_in", 0) < CDC_RECORDS:
                raise AssertionError(f"cdc ingest: {applied()} applied")
            time.sleep(0.02)
        apply_s = time.time() - t0
        want = app_db("A").latest_sequence_number()
        lag = {t: want - app_db(t).latest_sequence_number()
               for t in ("B", "C")}
        producer.join(60)
        stage = times.report()
        admin("A", "stop_message_ingestion", db_name=CDC_DB)
        while any(app_db(t).latest_sequence_number() != want
                  for t in ("B", "C")):
            if time.time() > deadline:
                raise AssertionError(f"cdc ingest: followers behind {want}")
            time.sleep(0.05)
        catch_up_s = time.time() - t0 - apply_s
        stats = Stats.get()
        counters = {n: stats.get_counter(f"kafka.cdc.{n}") for n in (
            "records_applied", "bytes_applied", "batches", "dup_skipped",
            "consumer_errors", "paced_sleeps", "paced_ms", "resumes",
            "retry_later")}
        report.update(
            apply_s=apply_s, apply_records_per_s=CDC_RECORDS / apply_s,
            apply_mb_per_s=stream["bytes"] / apply_s / 1e6,
            produce_tail_s=tail.get("seconds"),
            produce_records_per_s=(CDC_RECORDS - CDC_PRELOAD)
            / tail["seconds"],
            produce_mb_per_s=stream["bytes"] * (CDC_RECORDS - CDC_PRELOAD)
            / CDC_RECORDS / tail["seconds"] / 1e6,
            stages=stage, counters=counters, seq=want,
            follower_lag_seqs_at_drain=lag, follower_catch_up_s=catch_up_s,
            levels_before_final_compact_db={
                t: [len(f) for f in app_db(t).db._levels]
                for t in ("A", "B", "C")})
        compact_s = {}
        for tag in ("A", "B", "C"):
            t1 = time.time()
            admin(tag, "compact_db", db_name=CDC_DB)
            compact_s[tag] = time.time() - t1
        torch.cuda.synchronize()
        report["final_compact_db_s"] = compact_s
        launches = dict(_build.LAUNCHES)
        files = {t: digests(t) for t in ("A", "B", "C")}
        seqs = {t: app_db(t).latest_sequence_number()
                for t in ("A", "B", "C")}
        if not files["A"] or files["A"] != files["B"] \
                or files["A"] != files["C"]:
            raise AssertionError(f"cdc ingest: files differ {files}")
        if len(set(seqs.values())) != 1 or seqs["A"] != want:
            raise AssertionError(f"cdc ingest: seqs {seqs}")
        report["files"] = len(files["A"])
        marks = {t: (read_watermark(app_db(t).db, "cdc_in", 0)["offset"],
                     read_applies(app_db(t).db, "cdc_in", 0))
                 for t in ("A", "B", "C")}
        if any(m != (CDC_RECORDS, CDC_RECORDS) for m in marks.values()):
            raise AssertionError(f"cdc ingest: watermarks {marks}")
        if counters["records_applied"] != CDC_RECORDS \
                or counters["dup_skipped"] or counters["consumer_errors"]:
            raise AssertionError(f"cdc ingest: counters {counters}")
        report["read_back"] = {
            t: check_cdc_read_back(app_db(t), stream, f"cdc ingest {t}")
            for t in ("A", "B", "C")}
        # D: every seq of A once, in order; its batches replayed give A
        wrapper = observer._observers[CDC_DB][0]
        while wrapper.latest_sequence_number() != want:
            if time.time() > deadline:
                raise AssertionError(f"cdc ingest: observer at "
                                     f"{wrapper.latest_sequence_number()}")
            time.sleep(0.05)
        consumer = MockConsumer(broker)
        consumer.assign("cdc_out", [0])
        state, next_seq, published = {}, 1, 0
        t1 = time.time()
        while True:
            m = consumer.consume(0.0)
            if m is None:
                break
            published += 1
            if int(m.key.split(b":")[1]) != next_seq:
                raise AssertionError(f"cdc ingest: observer batch {m.key!r}"
                                     f" where seq {next_seq} was next")
            for vtype, key, val in decode_batch(m.value).ops():
                if vtype == OpType.PUT:
                    state[key] = val
                elif vtype == OpType.DELETE:
                    state.pop(key, None)
                elif vtype != OpType.LOG_DATA:
                    raise AssertionError(f"cdc ingest: observer op {vtype}")
                if vtype != OpType.LOG_DATA:
                    next_seq += 1
        if next_seq != want + 1:
            raise AssertionError(f"cdc ingest: observer published through "
                                 f"{next_seq - 1} of {want}")
        if state != dict(app_db("A").db.new_iterator()):
            raise AssertionError("cdc ingest: the observer's batches do not "
                                 "replay to A's state")
        report["observer"] = {"batches": published, "seqs": want,
                              "replay_s": time.time() - t1}
        bg = {t: (app_db(t).db._bg_compaction_error,
                  app_db(t).db._bg_compaction_failures,
                  app_db(t).db._bg_flush_failures) for t in ("A", "B", "C")}
        if log.errors:
            raise AssertionError(f"cdc ingest: compactions raised "
                                 f"{log.errors}")
        if any(err is not None or fails or fl
               for err, fails, fl in bg.values()):
            raise AssertionError(f"cdc ingest: background errors {bg}")
        per = {t: log.of(t) for t in ("A", "B", "C")}
        stray = [x for x in log.launches if x[1] not in ("A", "B")]
        if stray:
            raise AssertionError(f"cdc ingest: launches outside the card "
                                 f"replicas' compactions {stray[:8]}")
        for tag in ("A", "B"):
            p = per[tag]
            n_k2 = sum(v for k, v in p["launches"].items()
                       if k.startswith("fused_resolve@"))
            others = {k: v for k, v in p["launches"].items()
                      if not k.startswith("fused_resolve@")}
            if n_k2 < 1 or n_k2 != p["calls"] or p["calls"] != p["declined"] \
                    or p["tuple_calls"] != p["calls"] or others \
                    or p["by_thread"]["compact_db"] != 2:
                raise AssertionError(f"cdc ingest {tag}: K2 {n_k2} against "
                                     f"{p}")
        if per["C"]["launches"] or per["C"]["calls"] < 2:
            raise AssertionError(f"cdc ingest C: {per['C']}")
        report["compactions"] = {
            t: {k: v for k, v in p.items() if k != "stages"}
            for t, p in per.items()}
        report["launches"] = launches
        report["seconds"] = time.time() - t_phase
        # ---- cdc_network, on A's node ----
        times.reset()
        net, net_launches = cdc_network(admin, app_db, work_dir, card)
        net["stages"] = times.report()
    finally:
        if times is not None:
            times.uninstall()
        log.uninstall()
        ioloop.run_sync(pool.close())
        for server, handler, replicator in servers:
            server.stop()
            handler.close()
            replicator.stop()
        for replicator, handler, server in nodes.values():
            server.stop()
            handler.close()
            replicator.stop()
        from rocksplicator_tpu_torch.kafka.broker import (
            reset_clusters_for_test)

        reset_clusters_for_test()
        _sort_flag(None)
    return report, launches, net, net_launches


def cdc_network(admin, app_db, work_dir: str, card: str) -> tuple:
    """The networked broker as its own process (``python -m
    rocksplicator_tpu_torch.kafka.network``, RSTPU_LOCKWATCH=1):
    CDC_NET_PRODUCERS NetworkProducer threads write CDC_NET_RECORDS
    records of the CDC shapes into partition 1 of ``cdc_net``; A's
    start_message_ingestion with ``broker://127.0.0.1:<port>`` ingests
    them into an unreplicated CDC_NET_DB (on the card), whose watermark
    reaches CDC_NET_RECORDS and whose every key reads back (against the
    records in the broker's offset order) before and after compact_db;
    stop_message_ingestion stops the watcher; the port's consumer app as
    its own process (RSTPU_LOCKWATCH=1) prints every record and exits 0;
    an unknown topic answers DB_ADMIN_ERROR; the broker stops on SIGINT
    with exit 0, and neither process logged a lock-order violation."""
    import os
    import signal
    import threading

    import numpy as np
    import torch

    from rocksplicator_tpu_torch.kafka.checkpoint import read_watermark
    from rocksplicator_tpu_torch.kafka.network import NetworkProducer
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.rpc.errors import RpcApplicationError

    t_phase = time.time()
    stream = cdc_stream(CDC_NET_RECORDS, CDC_NET_RECORDS // 2, CDC_SEED + 1)
    data = os.path.join(work_dir, "cdc_broker")
    blog = os.path.join(work_dir, "cdc_broker.log")
    port = _free_port()
    env = _child_env(RSTPU_LOCKWATCH="1")
    torch.cuda.synchronize()
    _build.reset_launches()
    with open(blog, "w") as out:
        broker = subprocess.Popen(
            [sys.executable, "-m", "rocksplicator_tpu_torch.kafka.network",
             "--port", str(port), "--data_dir", data],
            stdout=out, stderr=subprocess.STDOUT, env=env)
    report = {"card": card, "records": CDC_NET_RECORDS,
              "producers": CDC_NET_PRODUCERS, "stream_bytes": stream["bytes"]}
    try:
        _wait_line(broker, blog, "broker up:", 120)
        report["broker_start_s"] = time.time() - t_phase
        admin_prod = NetworkProducer("127.0.0.1", port)
        admin_prod.create_topic("cdc_net", 2)
        admin_prod.close()
        order = np.zeros(CDC_NET_RECORDS, dtype=np.int64)
        errors = []

        def produce(k):
            try:
                prod = NetworkProducer("127.0.0.1", port)
                for i in range(k, CDC_NET_RECORDS, CDC_NET_PRODUCERS):
                    key, val = cdc_record(stream, i)
                    order[i] = prod.produce("cdc_net", 1, key, val,
                                            timestamp_ms=1000 + i)
                prod.close()
            except Exception as exc:  # reported and raised below
                errors.append(repr(exc))

        t0 = time.time()
        threads = [threading.Thread(target=produce, args=(k,))
                   for k in range(CDC_NET_PRODUCERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        report["produce_s"] = time.time() - t0
        if errors or sorted(order.tolist()) != list(range(CDC_NET_RECORDS)):
            raise AssertionError(f"cdc network: producers {errors[:3]}")
        report["produce_records_per_s"] = CDC_NET_RECORDS / report[
            "produce_s"]
        admin("A", "add_db", db_name=CDC_NET_DB, role="LEADER")
        t0 = time.time()
        admin("A", "start_message_ingestion", db_name=CDC_NET_DB,
              topic_name="cdc_net",
              kafka_broker_serverset_path=f"broker://127.0.0.1:{port}")
        db = app_db("A", CDC_NET_DB)
        deadline = time.time() + 600
        while (read_watermark(db.db, "cdc_net", 1) or {}).get(
                "offset") != CDC_NET_RECORDS:
            if time.time() > deadline:
                raise AssertionError("cdc network: the watermark stalled")
            time.sleep(0.05)
        report["apply_s"] = time.time() - t0
        report["apply_records_per_s"] = CDC_NET_RECORDS / report["apply_s"]
        report["read_back"] = check_cdc_read_back(db, stream, "cdc network",
                                                  order=order)
        admin("A", "stop_message_ingestion", db_name=CDC_NET_DB)
        t0 = time.time()
        admin("A", "compact_db", db_name=CDC_NET_DB)
        report["compact_db_s"] = time.time() - t0
        report["read_back_compacted"] = check_cdc_read_back(
            db, stream, "cdc network compacted", order=order)
        try:
            admin("A", "start_message_ingestion", db_name=CDC_NET_DB,
                  topic_name="cdc_missing",
                  kafka_broker_serverset_path=f"broker://127.0.0.1:{port}")
        except RpcApplicationError as exc:
            report["unknown_topic"] = exc.code
        if report.get("unknown_topic") != "DB_ADMIN_ERROR":
            raise AssertionError(f"cdc network: unknown topic answered "
                                 f"{report.get('unknown_topic')}")
        app_out = os.path.join(work_dir, "cdc_consumer_app.log")
        t0 = time.time()
        with open(app_out, "w") as out:
            rc = subprocess.run(
                [sys.executable, "-m", "rocksplicator_tpu_torch.examples."
                 "kafka_consumer_app.kafka_consumer_app",
                 "--broker", f"127.0.0.1:{port}", "--topic", "cdc_net",
                 "--partitions", "1", "--max_messages",
                 str(CDC_NET_RECORDS)],
                stdout=out, stderr=subprocess.STDOUT, env=env,
                timeout=600).returncode
        report["consumer_app_s"] = time.time() - t0
        with open(app_out) as f:
            text = f.read()
        printed = sum(1 for line in text.splitlines()
                      if line.startswith(("[replay] ", "[live] ")))
        report["consumer_app"] = {"rc": rc, "printed": printed}
        if rc != 0 or printed != CDC_NET_RECORDS \
                or "lock-order violation" in text or "Traceback" in text:
            raise AssertionError(f"cdc network: consumer app rc {rc}, "
                                 f"{printed} printed: {text[-2000:]}")
        broker.send_signal(signal.SIGINT)
        report["broker_rc"] = broker.wait(60)
        text = _tail(blog, 20000)
        if report["broker_rc"] != 0 or "lock-order violation" in text \
                or "Traceback" in text:
            raise AssertionError(f"cdc network: broker rc "
                                 f"{report['broker_rc']}: {text[-2000:]}")
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        if broker.poll() is None:
            broker.kill()
            broker.wait()
    report["launches"] = launches
    report["seconds"] = time.time() - t_phase
    return report, launches


# ---- the cluster control plane on card nodes -------------------------------
# cluster_failover: BASELINE.json configs[4] ("Helix-managed 3-AZ cluster,
# 4000 shards mixed R/W, compaction storm + replica catch-up") at the shard
# count and storm options of benchmarks/soak_bench.py (--cluster_shards 32,
# :173-176), as tools/chaos_soak.py FailoverCluster builds the topology

CLUSTER_SHARDS = 32
# cluster_failover's shards: half of soak_bench's 32, once the chip check
# stopped a command of 888.3 s at 1,200 s on a slower host of the same kind
# (the replacement's catch-up, compact_db and the checks go shard by shard)
FAILOVER_SHARDS = 16
CLUSTER_SEGMENT = "seg"
# a shard's storm halved (32,768 ops before) for the command's time, with
# the counter service's counters
CLUSTER_RUN_ENTRIES = 1 << 12  # 4 x 2^12 = 16,384 ops a shard
CLUSTER_KEY_SPACE = 1 << 15  # twice a shard's ops
CLUSTER_SEED = 1212
CLUSTER_WRITERS = 4
CLUSTER_READERS = 2
CLUSTER_MEMTABLE_BYTES = 64 * 1024  # soak_bench's storm
CLUSTER_L0_TRIGGER = 3
# the coordinator's default session TTL (DEFAULT_SESSION_TTL, 6 s): at
# soak_bench's 1.5 s (CLUSTER_SOAK_TTL) live participants' sessions lapsed
# 16-28 times a run on the card, and once a joining host's fresh session
# lapsed before Participant.__init__ registered it, which raised NO_SESSION
# and failed the phase (ROADMAP.md Queue 3, F13, a fault of both
# packages). _HeartbeatProbe measures where the beats wait.
CLUSTER_SESSION_TTL = 6.0
CLUSTER_SOAK_TTL = 1.5
CLUSTER_RECONCILE_S = 0.3
CLUSTER_SCRAPE_S = 2.0
CLUSTER_WAIT_S = 300.0  # the ceiling of every wait of the phase
CLUSTER_CRASH_PUT_TIMEOUT_S = 5.0
CLUSTER_READ_PAUSE_S = 0.005  # a reader's pause between gets


def _cluster_partition(shard: int) -> str:
    return f"{CLUSTER_SEGMENT}_{shard}"


def _cluster_db(shard: int) -> str:
    return f"{CLUSTER_SEGMENT}{shard:05d}"


def _coordinator_process(root: str, name: str, replica_of=None,
                         port: int = 0) -> tuple:
    """A port coordinator as its own process (``python -m
    rocksplicator_tpu_torch.cluster.coordinator``, the zkServer analog),
    durable in ``root/name``, on ``port`` (0: any), a standby of
    ``replica_of`` where given; returns the process and its port."""
    import os
    import subprocess
    import sys

    log_path = os.path.join(root, f"{name}.log")
    cmd = [sys.executable, "-m", "rocksplicator_tpu_torch.cluster.coordinator",
           "--port", str(port), "--data_dir", os.path.join(root, name),
           "--session_ttl", str(CLUSTER_SESSION_TTL)]
    if replica_of is not None:
        cmd += ["--replica_of", f"127.0.0.1:{replica_of}"]
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                env=_child_env())
    line = _wait_line(proc, log_path, "coordinator up:", 120)
    return proc, int(line.split("port=")[1].split()[0])


def _crash_key(writer: int, i: int) -> bytes:
    """A crash-window key: 16 bytes like a storm key, outside its space."""
    return b"crashwin" + ((writer << 32) | i).to_bytes(8, "big")


class _ClusterNode:
    """One host of the cluster: a port Replicator, AdminHandler (the card,
    or the host for the comparator) on an RpcServer, and a Participant
    with a backup store; every DB it opens is tagged with ``tag`` in the
    compaction log."""

    def __init__(self, tag, root, dev, host_only, coord_port, fallbacks,
                 store_uri, options, log, cluster="failover"):
        import os

        from rocksplicator_tpu_torch.admin import AdminHandler
        from rocksplicator_tpu_torch.cluster.model import InstanceInfo
        from rocksplicator_tpu_torch.cluster.participant import Participant
        from rocksplicator_tpu_torch.replication import (ReplicationFlags,
                                                         Replicator)
        from rocksplicator_tpu_torch.rpc import IoLoop, RpcServer

        self.tag = tag
        # a host's RPC servers and pull loops on an event loop of its own,
        # as on a host of its own
        self.ioloop = IoLoop(name=f"rpc-io-{tag}")
        # tests/test_cluster.py's fast pull flags; the ack timeout wide, so
        # that a slow ack is measured instead of turned into an unacked
        # write
        self.replicator = Replicator(port=0, ioloop=self.ioloop,
                                     flags=ReplicationFlags(
            server_long_poll_ms=300, pull_error_delay_min_ms=50,
            pull_error_delay_max_ms=120, ack_timeout_ms=60_000))
        kw = {"gpu_compaction": False} if host_only else {"device": dev}
        self.handler = AdminHandler(os.path.join(root, tag), self.replicator,
                                    options_generator=options, **kw)
        real = self.handler._install_backend

        def install(opts, _real=real):
            out = _real(opts)
            log.backends.append(out.compaction_backend)
            log.owner[id(out.compaction_backend)] = tag
            return out

        self.handler._install_backend = install
        self.server = RpcServer(port=0, ioloop=self.replicator.ioloop)
        self.server.add_handler(self.handler)
        self.server.start()
        self.instance = InstanceInfo(
            f"127.0.0.1_{self.server.port}", "127.0.0.1", self.server.port,
            self.replicator.port, f"az-{tag.lower()}")
        self.participant = Participant(
            "127.0.0.1", coord_port, cluster, self.instance,
            backup_store_uri=store_uri, coord_fallbacks=fallbacks)
        self.handler.set_leader_resolver(
            self.participant.make_leader_resolver())
        self.alive = True  # False once clients should leave it
        self._stopped = False

    @property
    def host_key(self) -> str:
        i = self.instance
        return f"{i.host}:{i.admin_port}:{i.az}:{i.repl_port}"

    def state(self, shard: int):
        return self.participant.current_states.get(_cluster_partition(shard))

    def app_db(self, shard: int):
        return self.handler.db_manager.get_db(_cluster_db(shard))

    def stop(self, graceful: bool = True) -> None:
        """``graceful=False`` crashes the host as tests/test_cluster.py's
        ServiceNode.stop does: heartbeats stop, the session expires on the
        coordinator, the data plane goes away."""
        if self._stopped:
            return
        self._stopped = True
        self.alive = False
        if graceful:
            self.participant.stop()
        else:
            self.participant._stopped = True
            self.participant.coord._stop.set()
        self.server.stop()
        self.handler.close()
        self.replicator.stop()
        self.ioloop.stop()


class _HeartbeatProbe:
    """Where the coordinator sessions' heartbeats wait in this process.

    Each watched client's calls on its heartbeat thread are timed: a
    beat's wake lateness (its start less the end of the thread's last
    call less the beat interval: the wait for the interpreter lock and a
    core) and its RPC (the shared default event loop, the wire and the
    coordinator). Beside them, a thread that only sleeps PERIOD_S (its
    lateness: the interpreter lock and a core alone) and a coroutine on
    IoLoop.default() that does the same (the loop's lag on top)."""

    PERIOD_S = 0.1

    def __init__(self):
        import threading

        self.calls = []  # one list of (method, start, end) a client
        self.interval = None
        self.thread_lag, self.loop_lag = [], []
        self._stop = threading.Event()
        self._threads = []

    def watch(self, client) -> None:
        import threading

        calls, real = [], client._call
        self.calls.append(calls)
        self.interval = client._ttl / 3

        def timed(method, *args, **kw):
            if threading.current_thread() is not client._hb_thread:
                return real(method, *args, **kw)
            t0 = time.perf_counter()
            try:
                return real(method, *args, **kw)
            finally:
                calls.append((method, t0, time.perf_counter()))

        client._call = timed

    def start(self) -> None:
        import asyncio
        import threading

        from rocksplicator_tpu_torch.rpc import IoLoop

        def sleeper():
            while not self._stop.is_set():
                t0 = time.perf_counter()
                time.sleep(self.PERIOD_S)
                self.thread_lag.append(time.perf_counter() - t0
                                       - self.PERIOD_S)

        async def loop_probe():
            while not self._stop.is_set():
                t0 = time.perf_counter()
                await asyncio.sleep(self.PERIOD_S)
                self.loop_lag.append(time.perf_counter() - t0
                                     - self.PERIOD_S)

        self._threads.append(threading.Thread(
            target=sleeper, name="heartbeat-probe", daemon=True))
        self._threads[-1].start()
        self._loop_done = IoLoop.default().run_coro(loop_probe())

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        if self._threads:
            self._loop_done.result(timeout=10)

    def report(self, late_s: float) -> dict:
        """The beats' wake lateness and RPC times, the two probes' lags,
        and the beats that came more than ``late_s`` after the interval
        (end to end from the beat before; split by whether the wake or
        the RPCs took most of it)."""
        wake, rpc, late = [], [], []
        for calls in self.calls:
            last_end, last_beat = None, None
            for method, t0, t1 in calls:
                if method == "heartbeat":
                    if last_end is not None:
                        wake.append(t0 - last_end - self.interval)
                    rpc.append(t1 - t0)
                    if last_beat is not None:
                        over = t1 - last_beat - self.interval
                        if over > late_s:
                            late.append((wake[-1], over - wake[-1]))
                    last_beat = t1
                last_end = t1

        def ms(xs):
            xs = sorted(xs)
            if not xs:
                return None
            return {"p50": 1e3 * xs[len(xs) // 2],
                    "p99": 1e3 * xs[min(len(xs) - 1, 99 * len(xs) // 100)],
                    "max": 1e3 * xs[-1], "n": len(xs)}

        return {"interval_s": self.interval, "clients": len(self.calls),
                "wake_late_ms": ms(wake), "rpc_ms": ms(rpc),
                "thread_lag_ms": ms(self.thread_lag),
                "loop_lag_ms": ms(self.loop_lag),
                "late_over_s": late_s, "late_beats": len(late),
                "late_beats_mostly_wake": sum(w > r for w, r in late),
                "late_max_wake_rpc_ms": [1e3 * max(w for w, _r in late),
                                         1e3 * max(r for _w, r in late)]
                if late else None}


def _percentiles(xs) -> tuple:
    xs = sorted(xs)
    if not xs:
        return None, None
    return (1e3 * xs[len(xs) // 2],
            1e3 * xs[min(len(xs) - 1, (99 * len(xs)) // 100)])


def _scan_replica(db, traffic: dict, what: str) -> tuple:
    """One host scan of a replica: the storm keys (prefix ``counter:``)
    must be exactly the oracle's live keys and values, in order; the
    crash-window keys come back as a dict."""
    import numpy as np

    exists, value = traffic["exists"], traffic["value"]
    live = traffic["touched"][exists[traffic["touched"]]]
    live = np.sort(live)
    want_keys = [_key_of(i) for i in live.tolist()]
    want_vals = [int(value[i]).to_bytes(8, "little") for i in live.tolist()]
    n, crash = 0, {}
    for key, val in db.new_iterator():
        if key.startswith(b"crashwin"):
            crash[key] = val
            continue
        if n >= len(want_keys) or key != want_keys[n] or val != want_vals[n]:
            raise AssertionError(f"{what}: scan entry {n} is {key!r} = "
                                 f"{val!r}")
        n += 1
    if n != len(want_keys):
        raise AssertionError(f"{what}: scan gave {n} storm keys, want "
                             f"{len(want_keys)}")
    return n, crash


def _coordinator_pair(root: str) -> tuple:
    """A port coordinator primary and its standby, started side by side
    (the standby retries its primary until it answers); returns the two
    processes and their ports."""
    import concurrent.futures

    port = _free_port()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        primary = ex.submit(_coordinator_process, root, "coord0",
                            port=port)
        standby = ex.submit(_coordinator_process, root, "coord1",
                            replica_of=port)
        return primary.result(), standby.result()


def _cluster_hosts(nodes: dict, shard: int,
                   states=("LEADER", "FOLLOWER")) -> list:
    """The live nodes whose participant holds ``shard`` in one of
    ``states`` (None: in any state)."""
    out = []
    for n in nodes.values():
        st = n.state(shard) if n.alive else None
        if st and (states is None or st in states):
            out.append(n)
    return out


def _cluster_leader_of(nodes: dict, shard: int):
    hosts = _cluster_hosts(nodes, shard, ("LEADER",))
    return hosts[0] if hosts else None


def _cluster_converged(nodes: dict, leaves, replicas: int = 3,
                       same_seq: bool = False,
                       states=("LEADER", "FOLLOWER")) -> bool:
    """Each leaf held by one leader and ``replicas - 1`` followers among
    the nodes holding it in ``states``; with ``same_seq``, each of them
    with the leaf's DB open at one sequence number."""
    want = sorted(["LEADER"] + ["FOLLOWER"] * (replicas - 1))
    for leaf in leaves:
        hosts = _cluster_hosts(nodes, leaf, states)
        if sorted(n.state(leaf) for n in hosts) != want:
            return False
        if same_seq:
            seqs = set()
            for n in hosts:
                app = n.app_db(leaf)
                if app is None:
                    return False
                seqs.add(app.db.latest_sequence_number())
            if len(seqs) != 1:
                return False
    return True


def _map_leaders(maps: list) -> dict:
    """shard -> the host keys the last published map marks leader."""
    if not maps:
        return {}
    seg = maps[-1].get(CLUSTER_SEGMENT) or {}
    out = {}
    for host, entries in seg.items():
        if host in ("num_shards", "__splits__"):
            continue
        for e in entries:
            sh, mark = e.split(":")
            if mark == "M":
                out.setdefault(int(sh), []).append(host)
    return out


def _cluster_wait(pred, what: str, detail, timeout: float = CLUSTER_WAIT_S,
                  poll: float = 0.1) -> None:
    """Poll ``pred`` until it holds; past ``timeout`` raise with ``what``
    and the JSON of ``detail()``."""
    import json

    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"{what} not within {timeout} s: "
                                 + json.dumps(detail())[:3000])
        time.sleep(poll)


def _cluster_reader(seed: int, key_space: int, pick_app, reads: dict,
                    stop, shards: int = CLUSTER_SHARDS) -> None:
    """A reader thread's loop: a get of a random key of one of ``shards``
    slots from the ApplicationDB ``pick_app(rng, slot, key)`` names, its
    latency and outcome counted in ``reads``, until ``stop`` is set."""
    import random

    rng = random.Random(seed)
    while not stop.is_set():
        slot = rng.randrange(shards)
        key = _key_of(rng.randrange(key_space))
        t_r = time.perf_counter()
        try:
            app = pick_app(rng, slot, key)
            if app is None:
                raise KeyError(slot)
            app.get(key)
            reads["lat"].append(time.perf_counter() - t_r)
            reads["ok"] += 1
        except Exception:
            reads["errors"] += 1
        time.sleep(CLUSTER_READ_PAUSE_S)


def _cluster_teardown(others, nodes: dict, ioloop, pool,
                      coordinators) -> None:
    """Stop a one-process cluster: the spectator, controller and clients
    side by side, then the nodes side by side (each waits out its
    participant's poll), the RPC client pool, then the coordinator
    processes (SIGINT, killed after 30 s)."""
    import concurrent.futures
    import signal
    import subprocess

    def quiet(stop):
        try:
            stop()
        except Exception:
            pass

    for group in (list(others), [n.stop for n in nodes.values()]):
        if group:
            with concurrent.futures.ThreadPoolExecutor(len(group)) as ex:
                list(ex.map(quiet, group))
    ioloop.run_sync(pool.close())
    for proc in coordinators:
        proc.send_signal(signal.SIGINT)
    for proc in reversed(coordinators):
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def cluster_failover(dev, work_dir: str, card: str) -> tuple:
    """The port's cluster control plane, driving card nodes.

    A port coordinator primary and a standby, each its own process (the
    zkServer analog; the default session TTL), a port Controller (reconcile
    every 0.3 s), a port Spectator
    publishing through LocalFilePublisher and CallbackPublisher with its
    stats scrape on, and one LeaderFollower resource ``seg`` of
    FAILOVER_SHARDS shards, 3 replicas, semi-sync (ack mode 1 from the
    port's DBConfigManager). Nodes A, B (the card) and C (the host, the
    comparator) join at the start, each a port Replicator + AdminHandler
    + RpcServer + Participant with a backup store, its RPC on an event
    loop of its own; D (the card) joins
    later as the replacement host. Their DBs take the counter options
    with soak_bench's storm (64 KiB memtables, L0 trigger 3, background
    compaction) and one slice a compaction.

    Storm: 2^18 ops of the counter mix (engine_traffic's 4 runs of distinct
    keys a shard, key space twice a shard's ops), CLUSTER_WRITERS writer
    threads sending WriteBatches of ENGINE_BATCH through the leaders'
    ApplicationDB.write_async, CLUSTER_READERS reader threads on random
    replicas. At half, once every batch is acked, the card node leading
    the most shards crashes; until every shard is led again in the
    participants' states and the spectator's published map, the writers
    send crash-window PUTs of unique keys, each recorded acked or not;
    then the storm finishes on the new leaders. D, the replacement, joins
    as the storm resumes and catches up on all shards; compact_db runs on
    every replica of every shard.

    Checks (each raises): every batch acked; every storm key equal to
    the oracle (multi_get on the leader, host scans on all three
    replicas); every acked crash-window key on every replica, every
    unacked one on all three or none; each shard's files sha256-equal
    and its seqs equal across the card replicas and C; the published
    map's leader of each shard the one the participants report;
    /cluster_stats with every shard and the move and split sections; one
    offline_to_follower_success event of D's for each shard; K2 launched
    at least once a compaction on each card node, K3 launched, C
    launching nothing, no compaction or background error."""
    import functools
    import hashlib
    import json
    import os
    import threading

    import torch

    from rocksplicator_tpu_torch.cluster import eventstore
    from rocksplicator_tpu_torch.cluster.controller import Controller
    from rocksplicator_tpu_torch.cluster.coordinator import CoordinatorClient
    from rocksplicator_tpu_torch.cluster.model import ResourceDef
    from rocksplicator_tpu_torch.cluster.publishers import (
        CallbackPublisher, LocalFilePublisher)
    from rocksplicator_tpu_torch.cluster.spectator import Spectator
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.rpc import IoLoop, RpcClientPool
    from rocksplicator_tpu_torch.storage import DBOptions, WriteBatch
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.utils.dbconfig import DBConfigManager
    from rocksplicator_tpu_torch.utils.objectstore import LocalObjectStore
    from rocksplicator_tpu_torch.utils.stats import Stats

    t_phase = time.time()
    root = os.path.join(work_dir, "cluster")
    os.makedirs(root)
    _sort_flag(SEAM_FLAGS["fused"])
    shards = range(FAILOVER_SHARDS)

    def options(segment):
        return DBOptions(merge_operator=UInt64AddOperator(),
                         wal_ttl_seconds=3600.0, bits_per_key=10,
                         background_compaction=True,
                         memtable_bytes=CLUSTER_MEMTABLE_BYTES,
                         level0_compaction_trigger=CLUSTER_L0_TRIGGER,
                         max_subcompactions=1)

    traffic = [engine_traffic(CLUSTER_SEED + s, CLUSTER_RUN_ENTRIES,
                              key_space=CLUSTER_KEY_SPACE)
               for s in shards]
    batches_per_shard = (len(traffic[0]["ops"]) * CLUSTER_RUN_ENTRIES
                         // ENGINE_BATCH)
    mgr = DBConfigManager.get()
    saved_config = dict(mgr.config.raw)
    mgr.load_from_dict({CLUSTER_SEGMENT: {"replication_mode": 1}})
    log = _CompactionLog()
    rejoins0 = Stats.get().get_counter("participant.rejoins")
    nodes, others = {}, []
    maps = []
    report = {"card": card, "shards": FAILOVER_SHARDS,
              "ops": FAILOVER_SHARDS * batches_per_shard * ENGINE_BATCH,
              "batch": ENGINE_BATCH, "writers": CLUSTER_WRITERS,
              "readers": CLUSTER_READERS, "mode": 1}
    (primary_proc, primary_port), (standby_proc, standby_port) = \
        _coordinator_pair(root)
    coordinators = [primary_proc, standby_proc]
    fallbacks = [("127.0.0.1", standby_port)]
    store_uri = os.path.join(root, "bucket")
    LocalObjectStore(store_uri)
    pool, ioloop = RpcClientPool(), IoLoop.default()

    def call(node, method, **args):
        async def go():
            return await pool.call("127.0.0.1", node.server.port, method,
                                   args, timeout=600)
        return ioloop.run_sync(go())

    def add_node(tag, host_only=False):
        nodes[tag] = _ClusterNode(tag, root, dev, host_only, primary_port,
                                  fallbacks, store_uri, options, log)
        probe.watch(nodes[tag].participant.coord)
        return nodes[tag]

    def live():
        return [n for n in nodes.values() if n.alive]

    leader_of = functools.partial(_cluster_leader_of, nodes)

    def wait(pred, what, timeout=CLUSTER_WAIT_S, poll=0.1):
        _cluster_wait(pred, f"cluster failover: {what}", lambda: {
            t: n.participant.current_states for t, n in nodes.items()
            if n.alive}, timeout, poll)

    def converged(replicas):
        return _cluster_converged(nodes, shards, replicas, states=None)

    def led_everywhere():
        by_map = _map_leaders(maps)
        for sh in shards:
            n = leader_of(sh)
            if n is None or by_map.get(sh) != [n.host_key]:
                return False
        return True

    # the phase's threads, released on every way out of it
    barrier = threading.Barrier(CLUSTER_WRITERS + 1)
    led_again, stop_reads = threading.Event(), threading.Event()
    threads = []
    probe = _HeartbeatProbe()
    log.install()
    try:
        probe.start()
        t0 = time.time()
        for tag, host_only in (("A", False), ("B", False), ("C", True)):
            add_node(tag, host_only)
        controller = Controller("127.0.0.1", primary_port, "failover",
                                "ctrl-1",
                                reconcile_interval=CLUSTER_RECONCILE_S,
                                coord_fallbacks=fallbacks)
        others.append(controller.stop)
        spectator = Spectator(
            "127.0.0.1", primary_port, "failover",
            [LocalFilePublisher(os.path.join(root, "shard_map.json")),
             CallbackPublisher(maps.append)],
            coord_fallbacks=fallbacks, scrape_interval=CLUSTER_SCRAPE_S)
        others.insert(0, spectator.stop)
        coord = CoordinatorClient("127.0.0.1", primary_port,
                                  fallbacks=fallbacks)
        others.append(coord.close)
        for client in (controller.coord, spectator.coord, coord):
            probe.watch(client)
        controller.add_resource(ResourceDef(
            CLUSTER_SEGMENT, num_shards=FAILOVER_SHARDS, replicas=3))
        wait(lambda: converged(3) and led_everywhere(),
             "the initial assignment")
        report["setup_s"] = time.time() - t0
        report["leaders_at_start"] = {
            t: sum(n.state(sh) == "LEADER" for sh in shards)
            for t, n in nodes.items()}

        # ---- storm, crash, crash window, storm --------------------------
        torch.cuda.synchronize()
        _build.reset_launches()
        acks, storm_errors = [], []
        crash_log = []  # (writer, key, shard or None, acked)
        reads = {"ok": 0, "errors": 0, "lat": []}
        half = batches_per_shard // 2

        # each run's op types and value bytes, as _counter_batch takes them
        runs = [[(vtype.tolist(), vals.astype("<u8").tobytes(), key_bytes)
                 for _ids, vtype, vals, key_bytes in tr["ops"]]
                for tr in traffic]

        def storm_batches(w, lo, hi):
            waiters = []
            mine = [sh for sh in shards if sh % CLUSTER_WRITERS == w]
            for b in range(lo, hi):
                for sh in mine:
                    run, off = divmod(b * ENGINE_BATCH, CLUSTER_RUN_ENTRIES)
                    batch = _counter_batch(*runs[sh][run],
                                           range(off, off + ENGINE_BATCH))
                    node = leader_of(sh)
                    try:
                        t_w = time.perf_counter()
                        waiter = node.app_db(sh).write_async(batch)
                        waiter.future.add_done_callback(
                            lambda _f, t_w=t_w: acks.append(
                                time.perf_counter() - t_w))
                        waiters.append((sh, b, waiter))
                    except Exception as exc:
                        storm_errors.append((sh, b, repr(exc)))
            for sh, b, waiter in waiters:
                try:
                    waiter.result(timeout=CLUSTER_WAIT_S)
                except Exception as exc:
                    storm_errors.append((sh, b, repr(exc)))
                    continue
                if not waiter.acked:
                    storm_errors.append((sh, b, "not acked"))

        def crash_window(w):
            mine = [sh for sh in shards if sh % CLUSTER_WRITERS == w]
            i = 0
            while not led_again.is_set():
                sh = mine[i % len(mine)]
                key = _crash_key(w, i)
                i += 1
                node = leader_of(sh)
                app = node.app_db(sh) if node is not None else None
                if app is None:
                    crash_log.append((w, key, None, False))
                    time.sleep(0.005)
                    continue
                try:
                    waiter = app.write_async(WriteBatch().put(key, key[8:]))
                    waiter.result(timeout=CLUSTER_CRASH_PUT_TIMEOUT_S)
                    crash_log.append((w, key, sh, bool(waiter.acked)))
                except Exception:
                    crash_log.append((w, key, sh, False))

        def writer(w):
            storm_batches(w, 0, half)
            barrier.wait()  # every batch of the first half acked
            barrier.wait()  # the crash is done
            crash_window(w)
            storm_batches(w, half, batches_per_shard)

        def on_any_replica(rng, sh, _key):
            nodes_now = live()
            return nodes_now[rng.randrange(len(nodes_now))].app_db(sh)

        def reader(r):
            _cluster_reader(CLUSTER_SEED + 100 + r, CLUSTER_KEY_SPACE,
                            on_any_replica, reads, stop_reads,
                            FAILOVER_SHARDS)

        threads += ([threading.Thread(target=writer, args=(w,),
                                      name=f"cluster-writer-{w}",
                                      daemon=True)
                     for w in range(CLUSTER_WRITERS)]
                    + [threading.Thread(target=reader, args=(r,),
                                        name=f"cluster-reader-{r}",
                                        daemon=True)
                       for r in range(CLUSTER_READERS)])
        t_storm = time.time()
        for t in threads:
            t.start()
        barrier.wait(timeout=CLUSTER_WAIT_S)
        first_half_s = time.time() - t_storm
        victim = max((nodes["A"], nodes["B"]), key=lambda n: sum(
            n.state(sh) == "LEADER" for sh in shards))
        passes0 = controller.passes
        t_crash = time.time()
        # the host dies at once for its clients; its shutdown runs beside
        # the crash window
        victim.alive = False
        crash = threading.Thread(target=victim.stop, args=(False,),
                                 name="cluster-crash", daemon=True)
        crash.start()
        barrier.wait(timeout=CLUSTER_WAIT_S)
        wait(lambda: converged(2) and led_everywhere(),
             "every shard led again after the crash", poll=0.02)
        relead_s = time.time() - t_crash
        crash.join(timeout=CLUSTER_WAIT_S)
        report["crash"] = {
            "victim": victim.tag,
            "victim_led": report["leaders_at_start"][victim.tag],
            "relead_s": relead_s,
            "controller_passes": controller.passes - passes0}
        led_again.set()
        t_resume = time.time()
        # the replacement host joins as the storm resumes: it catches up
        # on the first half and follows the second, flushing and
        # compacting as it applies
        t_join = time.time()
        d = add_node("D")
        for t in threads[:CLUSTER_WRITERS]:
            t.join(timeout=CLUSTER_WAIT_S)
        second_half_s = time.time() - t_resume
        # storm start to last ack, the crash window included
        whole_s = time.time() - t_storm
        stop_reads.set()
        for t in threads[CLUSTER_WRITERS:]:
            t.join(timeout=CLUSTER_WAIT_S)
        if any(t.is_alive() for t in threads):
            raise AssertionError("cluster failover: a writer or reader "
                                 "did not finish")
        storm_s = first_half_s + second_half_s
        if storm_errors:
            raise AssertionError(f"cluster failover: {len(storm_errors)} "
                                 f"storm batches failed: "
                                 f"{storm_errors[:8]}")
        ack_p50, ack_p99 = _percentiles(acks)
        read_p50, read_p50_99 = _percentiles(reads["lat"])
        report["storm"] = {
            "batches": len(acks), "errors": len(storm_errors),
            "first_half_s": first_half_s, "second_half_s": second_half_s,
            "whole_s": whole_s,
            "ops_per_s_excl_crash": report["ops"] / storm_s,
            "ops_per_s_whole": report["ops"] / whole_s,
            "ack_p50_ms": ack_p50, "ack_p99_ms": ack_p99,
            "reads": reads["ok"], "read_errors": reads["errors"],
            "read_p50_ms": read_p50, "read_p99_ms": read_p50_99}
        acked_crash = [x for x in crash_log if x[3]]
        report["crash"].update(
            window_puts=len(crash_log), window_acked=len(acked_crash),
            window_unsent=sum(1 for x in crash_log if x[2] is None))

        # ---- the replacement host's catch-up -----------------------------
        def d_caught_up():
            if not converged(3) or not led_everywhere():
                return False
            for sh in shards:
                if d.state(sh) != "FOLLOWER":
                    return False
                lead, mine = leader_of(sh).app_db(sh), d.app_db(sh)
                if mine is None or mine.latest_sequence_number() \
                        != lead.latest_sequence_number():
                    return False
            return True

        wait(d_caught_up, "D's catch-up")
        report["d_catch_up_s"] = time.time() - t_join
        replicas = [n for n in live()]
        report["replicas"] = sorted(n.tag for n in replicas)

        # ---- compact_db on every replica of every shard ------------------
        compact_s = {}
        errors = []

        def compact_all(node):
            times = []
            for sh in shards:
                t1 = time.time()
                try:
                    call(node, "compact_db", db_name=_cluster_db(sh))
                except Exception as exc:
                    errors.append((node.tag, sh, repr(exc)))
                times.append(time.time() - t1)
            compact_s[node.tag] = times

        ts = [threading.Thread(target=compact_all, args=(n,))
              for n in replicas]
        t1 = time.time()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        report["compact_db_wall_s"] = time.time() - t1
        torch.cuda.synchronize()
        if errors:
            raise AssertionError(f"cluster failover: compact_db {errors[:4]}")
        report["compact_db_s"] = {
            t: {"sum": sum(v), "median": sorted(v)[len(v) // 2],
                "max": max(v)} for t, v in compact_s.items()}

        # ---- checks -------------------------------------------------------
        def digests(node, sh):
            db = node.app_db(sh).db
            return sorted(hashlib.sha256(open(os.path.join(db.path, n),
                                              "rb").read()).hexdigest()
                          for level in db._levels for n in level)

        files = 0
        t1 = time.time()
        crash_on = {n.tag: {} for n in replicas}
        for sh in shards:
            seqs = {n.tag: n.app_db(sh).latest_sequence_number()
                    for n in replicas}
            got = {n.tag: digests(n, sh) for n in replicas}
            first = got[replicas[0].tag]
            if not first or any(g != first for g in got.values()) \
                    or len(set(seqs.values())) != 1:
                raise AssertionError(f"cluster failover: shard {sh} "
                                     f"files {got}, seqs {seqs}")
            files += len(first)
            check_read_back(leader_of(sh).app_db(sh), traffic[sh],
                            f"cluster failover shard {sh} leader",
                            scan=False)
            for n in replicas:
                _n, crash = _scan_replica(n.app_db(sh).db, traffic[sh],
                                          f"cluster failover shard {sh} "
                                          f"{n.tag}")
                crash_on[n.tag].update(crash)
        report["files"] = files
        report["check_s"] = time.time() - t1
        lost, partial = [], []
        for w, key, sh, acked in crash_log:
            present = [key in crash_on[n.tag] and crash_on[n.tag][key]
                       == key[8:] for n in replicas]
            if acked and not all(present):
                lost.append((key.hex(), sh, present))
            elif not acked and any(present) and not all(present):
                partial.append((key.hex(), sh, present))
            elif sh is None and any(present):
                partial.append((key.hex(), sh, present))
        sent = {key for _w, key, _sh, _a in crash_log}
        stray = [k.hex() for v in crash_on.values() for k in v
                 if k not in sent]
        if lost or partial or stray:
            raise AssertionError(f"cluster failover: crash window lost "
                                 f"{lost[:4]}, partial {partial[:4]}, "
                                 f"stray {stray[:4]}")
        report["crash"]["window_present_unacked"] = sum(
            1 for w, key, sh, acked in crash_log
            if not acked and key in crash_on[replicas[0].tag])

        wait(led_everywhere, "the published map's leaders", timeout=30)
        wait(lambda: len(spectator.cluster_stats.get("per_shard") or {})
             == FAILOVER_SHARDS and all(
                 len((spectator.cluster_stats["per_shard"].get(
                     _cluster_db(sh)) or {}).get("roles", {})) > 0
                 for sh in shards),
             "the spectator's /cluster_stats", timeout=60)
        stats = json.loads(spectator.cluster_stats_json())
        if "shard_moves" not in stats or "shard_splits" not in stats:
            raise AssertionError(f"cluster failover: /cluster_stats "
                                 f"sections {sorted(stats)}")
        report["cluster_stats"] = {
            "replicas_scraped": stats.get("replicas_scraped"),
            "shards": len(stats["per_shard"]),
            "shard_moves": stats["shard_moves"],
            "shard_splits": stats["shard_splits"]}
        d_iid = d.instance.instance_id
        events, d_events = {}, {}
        for sh in shards:
            evs = eventstore.read_events(coord, "failover",
                                         _cluster_partition(sh))
            events[sh] = sum(1 for e in evs
                             if e["type"] == "offline_to_follower_success"
                             and e["originator"] == d_iid)
            for e in evs:
                if e["originator"] == d_iid:
                    d_events[e["type"]] = d_events.get(e["type"], 0) + 1
        report["d_events"] = d_events
        if any(v != 1 for v in events.values()):
            raise AssertionError(f"cluster failover: D's "
                                 f"offline_to_follower_success {events}")
        report["published_maps"] = len(maps)
        # live participants whose session lapsed under load and rejoined
        report["participant_rejoins"] = Stats.get().get_counter(
            "participant.rejoins") - rejoins0
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        bg = {(n.tag, sh): (n.app_db(sh).db._bg_compaction_error,
                            n.app_db(sh).db._bg_compaction_failures,
                            n.app_db(sh).db._bg_flush_failures)
              for n in replicas for sh in shards}
    finally:
        stop_reads.set()
        led_again.set()
        barrier.abort()
        for t in threads:
            t.join(timeout=60)
        probe.stop()
        log.uninstall()
        _cluster_teardown(others, nodes, ioloop, pool, coordinators)
        mgr.load_from_dict(saved_config)
        _sort_flag(None)
    if log.errors:
        raise AssertionError(f"cluster failover: compactions raised "
                             f"{log.errors[:4]}")
    bad = {k: v for k, v in bg.items()
           if v[0] is not None or v[1] or v[2]}
    if bad:
        raise AssertionError(f"cluster failover: background errors "
                             f"{list(bad.items())[:4]}")
    per = {t: log.of(t) for t in ("A", "B", "C", "D")}
    stray = [x for x in log.launches if x[1] not in ("A", "B", "D")]
    if stray:
        raise AssertionError(f"cluster failover: launches outside the "
                             f"card nodes' compactions {stray[:8]}")
    k3 = 0
    for tag in ("A", "B", "D"):
        p = per[tag]
        n_k2 = sum(v for k, v in p["launches"].items()
                   if k.startswith("fused_resolve@"))
        k3 += sum(v for k, v in p["launches"].items()
                  if k.startswith("bloom_build@"))
        if n_k2 < max(1, p["calls"]):
            raise AssertionError(
                f"cluster failover {tag}: K2 {n_k2} for {p['calls']} "
                f"compactions: {p}; calls by node "
                f"{ {t: (q['calls'], q['launches']) for t, q in per.items()} }"
                f"; crash {report.get('crash')}")
    if k3 < 1 or per["C"]["launches"] or per["C"]["calls"] < 1:
        raise AssertionError(f"cluster failover: K3 {k3}, C {per['C']}")
    report["compactions"] = {
        t: {k: p[k] for k in ("calls", "by_thread", "declined",
                              "tuple_calls", "in_ram", "stream_chunks",
                              "launches")}
        | {"seconds_sum": sum(p["seconds"])}
        for t, p in per.items()}
    # a beat later than this past its interval lets a session of
    # soak_bench's TTL lapse
    report["heartbeats"] = probe.report(CLUSTER_SOAK_TTL * 2 / 3)
    report["launches"] = launches
    report["seconds"] = time.time() - t_phase
    return report, launches


# ---- shard movement on card nodes ------------------------------------------
# cluster_reshape: the topology of the reference's reshard and rebalance
# harness, tools/chaos_soak.py FailoverCluster(num_nodes=4) (:875-948,
# :2588-2620), at soak_bench's shard count and storm options. An
# operator moves a shard and splits the hot one through the port's
# admin_cli, and the port's Rebalancer moves the next hot one.

RESHAPE_SEED = 1414
# base and hot loads cut from 2^19 to 2^18 ops each, then to 2^17 and 2^16
# with the counter service's counters, for the command's time, and the hot
# load to 2^15 for the chaos harness's reshard and rebalance decks (a run
# is at least one batch of ENGINE_BATCH ops)
RESHAPE_BASE_RUN = 1 << 10  # 4 runs a shard: 2^17 ops over 32 shards
RESHAPE_KEY_SPACE = 1 << 13  # twice a shard's base ops
RESHAPE_HOT_RUN = 1 << 13  # 4 runs into H: 2^15 ops
RESHAPE_HOT_KEY_SPACE = 1 << 18
RESHAPE_COLD_RUN = 1 << 10  # 4 runs into each other shard: 126,976 ops
RESHAPE_POLICY_RUN = 1 << 10  # 4 runs a shard in the policy step, sent twice
RESHAPE_READ_KEYS = 1 << 13  # keys of the routed multi_get across the split
RESHAPE_POLICY_HOT = 3  # P takes this many times a shard's share
# the policy step's writers keep a pace, one round of batches (one of P's)
# every RESHAPE_POLICY_ROUND_S, in small batches, so that every shard's
# write rate reads steadily off a 2 s scrape while the move has the host:
# flat out in 1024-op batches the step took 88.9 s, the move 62.9 s of it
RESHAPE_POLICY_BATCH = 64
RESHAPE_POLICY_ROUND_S = 0.25
RESHAPE_WRITE_RETRY_S = 0.005  # a writer's pause after a refused batch
RESHAPE_WINDOW = 16  # a writer's unacked batches
RESHAPE_HEAL_PAUSE_S = 0.2  # between the heal writer's PUTs


class _SeqRates:
    """The rebalancer's sensor in this one-process cluster: db_name -> write
    rate from the data plane's sequence numbers (the highest seq over a
    shard's serving replicas, its rise over the tick), the signal the
    reference's rebalance harness feeds the same policy
    (tools/chaos_soak.py _SeqRateLoad). Each call is one scrape."""

    def __init__(self, nodes):
        self.nodes = nodes
        self.prev = {}
        self.calls = []  # (monotonic time, rates or None)

    def __call__(self):
        from rocksplicator_tpu_torch.utils.segment_utils import \
            partition_name_to_db_name

        now = time.monotonic()
        seqs = {}
        for n in self.nodes:
            if not n.alive:
                continue
            for partition, st in list(
                    n.participant.current_states.items()):
                if st not in ("LEADER", "FOLLOWER"):
                    continue
                db = partition_name_to_db_name(partition)
                app = n.handler.db_manager.get_db(db)
                if app is not None:
                    seqs[db] = max(seqs.get(db, 0),
                                   app.db.latest_sequence_number_relaxed())
        rates = {}
        for db, seq in seqs.items():
            prev = self.prev.get(db)
            if prev is not None:
                rates[db] = max(0.0, (seq - prev[0]) / max(1e-3,
                                                            now - prev[1]))
        self.prev = {db: (seq, now) for db, seq in seqs.items()}
        out = rates or None
        self.calls.append((now, out))
        return out


def cluster_reshape(dev, work_dir: str, card: str) -> tuple:
    """Shard movement on card nodes, driven as an operator drives it.

    Two port coordinator processes (the default session TTL), a port
    Controller (0.3 s) and a port Spectator (file and callback publishers,
    scrape on); one LeaderFollower resource ``seg`` of CLUSTER_SHARDS
    shards, 3 replicas, ack mode 1; nodes A, B and D on the card and C on
    the host (the comparator), each a port Replicator + AdminHandler +
    RpcServer + Participant; the counter options with cluster_failover's
    storm (64 KiB memtables, L0 trigger 3, background compaction, one
    slice a compaction); a local object store. Rendezvous places each
    shard on 3 of the 4 nodes, so each shard has one node free of it.

    Writers (CLUSTER_WRITERS threads, WriteBatches of ENGINE_BATCH, but
    in the policy step, through the current leader's
    ApplicationDB.write_async, split by key across a split's children,
    at most RESHAPE_WINDOW unacked a writer and each
    shard's batches spread over the step; a refused batch, WRITE_PAUSED or
    NOT_LEADER or a DB renamed away, is counted and sent again, never
    counted as acked) and CLUSTER_READERS readers ride through three
    steps:

    1. base load, 4 runs of RESHAPE_BASE_RUN counter ops a shard; at its
       half an operator runs ``python -m rocksplicator_tpu_torch.admin.tool.
       admin_cli move-shard`` for M, a shard led by a card node, from its
       leader to the card node free of it; then compact_db on every
       replica of M;
    2. hot load, 4 runs of RESHAPE_HOT_RUN ops into H (key space
       RESHAPE_HOT_KEY_SPACE) and of RESHAPE_COLD_RUN into each other
       shard; at its half ``admin_cli split-shard --shard H`` (no key:
       the leader's sampled median) onto the card node free of H, whose
       exit before the record reads active fails the phase; once it
       does, a heal writer PUTs unique keys into the high child until
       all of both children's replicas hold data (ROADMAP F15);
       then compact_db on every replica of both children (the trims);
    3. policy load, in batches of RESHAPE_POLICY_BATCH at one round every
       RESHAPE_POLICY_ROUND_S, P taking RESHAPE_POLICY_HOT times a shard's
       share until the rebalancer acts on it, a shard's share after: a port
       Rebalancer (RebalancerFlags.from_env with
       RSTPU_REBALANCE_INTERVAL = CLUSTER_SCRAPE_S, the policy's
       defaults otherwise; sensor _SeqRates) runs until it has
       dispatched and finished a move of P; ``admin_cli rebalance
       status`` reads its decision back and ``rebalance pause`` stops it.

    Checks (each raises): every batch acked; every shard's rows read back
    through a port RpcRouter over the spectator's last map (with its
    __splits__ section), one routed scan a slot, equal to the numpy
    oracle's live keys, and one routed multi_get across H's split key;
    every shard's and child's replicas at one seq, their scans over the
    shard's range equal to the oracle (C's too); no replica holding a
    split child's retain range keeps a key outside it after the trims,
    and compaction.retain_trims rose by the card child replicas that hold
    one; a child replica the controller rebuilt (no retain range,
    ROADMAP F14) keeps outside its range only rows H held at the cutover,
    at their values then; K2 launched by each card child replica's
    compact_db and by the moved shard's target, C launching nothing;
    /cluster_stats with both
    moves and the split; no background compaction error."""
    import asyncio
    import collections
    import contextlib
    import functools
    import io
    import json
    import os
    import subprocess
    import sys
    import threading

    import numpy as np
    import torch

    from rocksplicator_tpu_torch.admin.tool import admin_cli
    from rocksplicator_tpu_torch.cluster.controller import Controller
    from rocksplicator_tpu_torch.cluster.coordinator import CoordinatorClient
    from rocksplicator_tpu_torch.cluster.model import (ResourceDef,
                                                       cluster_path)
    from rocksplicator_tpu_torch.cluster.publishers import (
        CallbackPublisher, LocalFilePublisher)
    from rocksplicator_tpu_torch.cluster.rebalancer import (Rebalancer,
                                                            RebalancerFlags)
    from rocksplicator_tpu_torch.cluster.shard_split import list_splits
    from rocksplicator_tpu_torch.cluster.spectator import Spectator
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.rpc import (ClusterLayout, IoLoop,
                                             RpcClientPool, RpcRouter)
    from rocksplicator_tpu_torch.rpc.router import ReadPolicy
    from rocksplicator_tpu_torch.storage import DBOptions, WriteBatch
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.utils.dbconfig import DBConfigManager
    from rocksplicator_tpu_torch.utils.objectstore import LocalObjectStore
    from rocksplicator_tpu_torch.utils.stats import Stats

    t_phase = time.time()
    cluster = "reshape"
    root = os.path.join(work_dir, "reshape")
    os.makedirs(root)
    _sort_flag(SEAM_FLAGS["fused"])
    slots = range(CLUSTER_SHARDS)

    def options(segment):
        return DBOptions(merge_operator=UInt64AddOperator(),
                         wal_ttl_seconds=3600.0, bits_per_key=10,
                         background_compaction=True,
                         memtable_bytes=CLUSTER_MEMTABLE_BYTES,
                         level0_compaction_trigger=CLUSTER_L0_TRIGGER,
                         max_subcompactions=1)

    mgr = DBConfigManager.get()
    saved_config = dict(mgr.config.raw)
    mgr.load_from_dict({CLUSTER_SEGMENT: {"replication_mode": 1}})
    log = _CompactionLog()
    nodes, others, maps, coordinators = {}, [], [], []
    report = {"card": card, "shards": CLUSTER_SHARDS, "mode": 1,
              "timeline": {},
              "batch": ENGINE_BATCH, "writers": CLUSTER_WRITERS,
              "readers": CLUSTER_READERS}
    (primary_proc, primary_port), (standby_proc, standby_port) = \
        _coordinator_pair(root)
    coordinators += [primary_proc, standby_proc]
    fallbacks = [("127.0.0.1", standby_port)]
    store_uri = os.path.join(root, "bucket")
    LocalObjectStore(store_uri)
    pool, ioloop = RpcClientPool(), IoLoop.default()
    cli_args = ["--coord", f"127.0.0.1:{primary_port}", "--cluster", cluster]

    def call(node, method, **args):
        async def go():
            return await pool.call("127.0.0.1", node.server.port, method,
                                   args, timeout=600)
        return ioloop.run_sync(go())

    hosts_of = functools.partial(_cluster_hosts, nodes)
    leader_of = functools.partial(_cluster_leader_of, nodes)

    def wait(pred, what, timeout=CLUSTER_WAIT_S, poll=0.1):
        _cluster_wait(pred, f"cluster reshape: {what}", unconverged,
                      timeout, poll)

    def unconverged():
        """Each leaf short of one leader and two followers at one seq:
        its replicas' states and seqs."""
        out = {}
        for s in leaves():
            got = {}
            for n in nodes.values():
                st, app = n.state(s), n.app_db(s)
                if st or app is not None:
                    got[n.tag] = [st, None if app is None
                                  else app.db.latest_sequence_number(),
                                  None if app is None
                                  else app.replicated_db.introspect()]
            states = sorted(v[0] or "" for v in got.values())
            if [x for x in states if x] != ["FOLLOWER", "FOLLOWER",
                                             "LEADER"] \
                    or len({v[1] for v in got.values() if v[0]}) != 1:
                out[s] = got
        return out or {"map_led": map_led()}

    # split routing: slot -> (split key, low child, high child), filled
    # from the split ledger once a split reads active
    routes = {}

    def leaves():
        out = []
        for s in slots:
            r = routes.get(s)
            out += [s] if r is None else [r[1], r[2]]
        return out

    def converged():
        return _cluster_converged(nodes, leaves(), 3, same_seq=True)

    def map_led():
        """Every leaf's leader in the last published map is the node the
        participants report, and the map holds every active split."""
        if not maps:
            return False
        marks = _map_leaders(maps)
        for s in leaves():
            n = leader_of(s)
            if n is None or marks.get(s) != [n.host_key]:
                return False
        seg = maps[-1].get(CLUSTER_SEGMENT) or {}
        return all(str(p) in (seg.get("__splits__") or {}) for p in routes)

    def free_node(shard):
        held = {n.tag for n in hosts_of(shard)}
        free = [t for t in nodes if t not in held]
        return nodes[free[0]] if len(free) == 1 else None

    # ---- traffic -----------------------------------------------------------
    oracle = {s: _oracle(RESHAPE_KEY_SPACE) for s in slots}
    acks, errors, pauses, stop_reads = [], [], [], threading.Event()
    reads = {"ok": 0, "errors": 0, "lat": []}
    threads, failed, heal_keys, heal_tried = [], [], [], []
    ack_lock = threading.Lock()
    # (step, slot) -> the slot's first batches of the step, each written
    # whole to the slot's own shard (before its split activated)
    unsplit = collections.Counter()

    def acked_in(step):
        return sum(1 for st, _x in list(acks) if st == step)

    def step_plan(runs_by_slot, size=ENGINE_BATCH):
        """slot -> [(ids, vt list, value bytes, key bytes, rows), ...] a
        batch of ``size`` ops, in the order each slot's batches are
        sent."""
        plan = {}
        for s, runs in runs_by_slot.items():
            batches = []
            for ids, vtype, vals, key_bytes in runs:
                vt, vb = vtype.tolist(), vals.astype("<u8").tobytes()
                for off in range(0, len(ids), size):
                    batches.append((ids, vtype, vals, vt, vb, key_bytes,
                                    range(off, off + size)))
            plan[s] = batches
        return plan

    def route(slot, key_bytes, rows):
        """The leaf and rows of each part of a batch of ``slot``."""
        r = routes.get(slot)
        if r is None:
            return [(slot, rows)]
        split_key, low, high = r
        lo_rows = [i for i in rows
                   if key_bytes[16 * i:16 * i + 16] < split_key]
        hi_rows = [i for i in rows
                   if key_bytes[16 * i:16 * i + 16] >= split_key]
        return [(leaf, part) for leaf, part in ((low, lo_rows),
                                                (high, hi_rows)) if part]

    def send(slot, item, step, deadline):
        """Write one batch of ``slot``, each part to its leaf's leader,
        sending a refused part again; returns the parts' waiters."""
        _ids, _vtype, _vals, vt, vb, key_bytes, rows = item
        waiters, pending = [], None
        while True:
            parts = route(slot, key_bytes, rows) if pending is None \
                else pending
            pending = []
            for leaf, part in parts:
                node = leader_of(leaf)
                app = (node.handler.db_manager.get_db(_cluster_db(leaf))
                       if node is not None else None)
                if app is None:
                    errors.append((step, leaf, "no leader db"))
                    pending.append((leaf, part))
                    continue
                batch = _counter_batch(vt, vb, key_bytes, part)
                t_w = time.perf_counter()
                try:
                    waiter = app.write_async(batch)
                except Exception as exc:
                    # refused before the WAL: nothing of it was applied
                    code = getattr(exc, "code", type(exc).__name__)
                    errors.append((step, leaf, code))
                    if code == "WRITE_PAUSED":
                        pauses.append((leaf, time.monotonic()))
                    pending.append((leaf, part))
                    continue
                waiter.future.add_done_callback(
                    lambda _f, t_w=t_w: acks.append(
                        (step, time.perf_counter() - t_w)))
                waiters.append((leaf, waiter))
            if not pending:
                if all(leaf == slot for leaf, _w in waiters):
                    unsplit[(step, slot)] += 1
                return waiters
            if time.time() > deadline:
                raise AssertionError(f"cluster reshape: slot {slot} batch "
                                     f"refused until {CLUSTER_WAIT_S} s: "
                                     f"{errors[-4:]}")
            time.sleep(RESHAPE_WRITE_RETRY_S)
            # a refused part is routed again (a split may have activated)
            pending = [(leaf2, p2) for leaf, part in pending
                       for leaf2, p2 in route(slot, key_bytes, part)]

    def run_step(plan, step, stop=None, calm=None, round_s=0.0):
        """The writers send ``plan`` (stopping early at ``stop``; once the
        event of ``calm`` = (slot, event) is set, that slot's batches go
        out at RESHAPE_POLICY_HOT times less its planned share; with
        ``round_s``, round b of the plan goes out no sooner than b *
        round_s after the start); returns each slot's count of acked
        batches. Every batch sent must be acked: anything else fails the
        phase."""
        done = {s: 0 for s in plan}
        depth = max(len(v) for v in plan.values())
        t_start = time.monotonic()

        def settle(s, waiters):
            for leaf, waiter in waiters:
                waiter.result(timeout=CLUSTER_WAIT_S)
                if not waiter.acked:
                    raise AssertionError(f"slot {s} leaf {leaf} batch "
                                         f"not acked")
            with ack_lock:
                done[s] += 1

        def writer(w):
            try:
                mine = [s for s in plan if s % CLUSTER_WRITERS == w]
                deadline = time.time() + CLUSTER_WAIT_S
                inflight, nxt = collections.deque(), {s: 0 for s in mine}
                # each shard's batches spread over the step and at most
                # RESHAPE_WINDOW of a writer's batches unacked, so that a
                # shard's write rate follows its share of the step's ops
                calm_at = None
                for b in range(depth):
                    ahead = t_start + b * round_s - time.monotonic()
                    if ahead > 0:
                        time.sleep(ahead)
                    if stop is not None and stop.is_set():
                        break
                    if calm is not None and calm_at is None \
                            and calm[1].is_set():
                        calm_at = b
                    for s in mine:
                        due = b
                        if calm_at is not None and s == calm[0]:
                            due = calm_at + (b - calm_at) // RESHAPE_POLICY_HOT
                        while nxt[s] < len(plan[s]) and \
                                nxt[s] * depth // len(plan[s]) <= due:
                            inflight.append((s, send(
                                s, plan[s][nxt[s]], step, deadline)))
                            nxt[s] += 1
                            while len(inflight) > RESHAPE_WINDOW:
                                settle(*inflight.popleft())
                while inflight:
                    settle(*inflight.popleft())
            except BaseException as exc:
                failed.append(repr(exc))
                raise

        ts = [threading.Thread(target=writer, args=(w,), daemon=True,
                               name=f"reshape-writer-{w}")
              for w in range(CLUSTER_WRITERS)]
        for t in ts:
            t.start()
        return ts, done

    def apply_batches(state, batches):
        for ids, vtype, vals, _vt, _vb, _kb, rows in batches:
            sel = np.asarray(rows)
            _oracle_apply(state, ids[sel], vtype[sel], vals[sel])

    def apply_done(plan, done):
        for s, n in done.items():
            apply_batches(oracle[s], plan[s][:n])

    def on_a_replica(rng, s, key):
        leaf = route(s, key, [0])[0][0]
        hosts = hosts_of(leaf)
        return hosts[rng.randrange(len(hosts))].app_db(leaf)

    def reader(r):
        _cluster_reader(RESHAPE_SEED + 100 + r, RESHAPE_KEY_SPACE,
                        on_a_replica, reads, stop_reads)

    def step_report(step, t0, t1, ops):
        lat = [x for st, x in acks if st == step]
        p50, p99 = _percentiles(lat)
        errs = {}
        for st, _leaf, code in errors:
            if st == step:
                errs[code] = errs.get(code, 0) + 1
        return {"ops": ops, "seconds": t1 - t0,
                "ops_per_s": ops / max(1e-9, t1 - t0),
                "batches_acked": len(lat), "refused": errs,
                "ack_p50_ms": p50, "ack_p99_ms": p99}

    def ledger_poller(path_of, box, stop):
        """Each phase of a move or split record: when it was first seen
        (host clock), and the record's last fields; ``gone`` when a seen
        record is deleted."""
        coord_p = CoordinatorClient("127.0.0.1", primary_port,
                                    fallbacks=fallbacks)
        try:
            while not stop.is_set():
                raw = coord_p.get_or_none(path_of())
                now = time.monotonic()
                if raw:
                    doc = json.loads(bytes(raw).decode())
                    box["record"] = doc
                    box["phases"].setdefault(doc.get("phase"), now)
                elif box["record"] is not None and "gone" not in box:
                    box["gone"] = now
                time.sleep(0.05)
        finally:
            coord_p.close()

    def phase_seconds(box, order, end):
        seen = [(p, box["phases"][p]) for p in order if p in box["phases"]]
        out = {}
        for (p, t), nxt in zip(seen, seen[1:] + [(None, end)]):
            out[p] = nxt[1] - t
        return out

    def pause_window(leaf, t0, t1):
        ts = [t for lf, t in pauses if lf == leaf and t0 <= t <= t1]
        return {"refusals": len(ts),
                "window_ms": 1e3 * (max(ts) - min(ts)) if ts else 0.0}

    def operator(argv, name):
        """``admin_cli`` as its own process, as an operator runs it."""
        path = os.path.join(root, f"{name}.log")
        with open(path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "rocksplicator_tpu_torch.admin.tool.admin_cli", *argv],
                stdout=out, stderr=subprocess.STDOUT, env=_child_env())
        return proc, path

    def finish_operator(proc, path, what):
        try:
            rc = proc.wait(CLUSTER_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"cluster reshape: {what} did not finish: "
                                 f"{_tail(path)}")
        text = _tail(path, 20000)
        if rc != 0:
            raise AssertionError(f"cluster reshape: {what} rc {rc}: "
                                 f"{text[-3000:]}")
        last = [ln for ln in text.splitlines() if ln.startswith("{")]
        return json.loads(last[-1]) if last else {}

    def compact(targets):
        """compact_db on each (node, leaf), one call at a time a node, the
        nodes side by side; each call's seconds, K2 launches and tuple-path
        merges from the compaction log."""
        out, errs = [], []

        def run(node, jobs):
            for leaf in jobs:
                n0, u0 = len(log.launches), len(log.tuple_calls)
                t1 = time.time()
                try:
                    call(node, "compact_db", db_name=_cluster_db(leaf))
                except Exception as exc:
                    errs.append((node.tag, leaf, repr(exc)))
                    continue
                secs = time.time() - t1
                k2 = sum(1 for name, tag, th in log.launches[n0:]
                         if tag == node.tag and th.startswith("admin")
                         and name == "fused_resolve")
                k3 = sum(1 for name, tag, th in log.launches[n0:]
                         if tag == node.tag and th.startswith("admin")
                         and name == "bloom_build")
                tup = sum(1 for c in log.tuple_calls[u0:]
                          if c["replica"] == node.tag
                          and c["thread"].startswith("admin"))
                out.append({"node": node.tag, "shard": leaf,
                            "seconds": secs, "k2": k2, "k3": k3,
                            "tuple_merges": tup})

        by_node = {}
        for node, leaf in targets:
            by_node.setdefault(node, []).append(leaf)
        ts = [threading.Thread(target=run, args=(n, j))
              for n, j in by_node.items()]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        torch.cuda.synchronize()
        if errs:
            raise AssertionError(f"cluster reshape: compact_db {errs[:4]}")
        return out

    def mark(step):
        """The phase's timeline: host seconds since its start at the end
        of each step, printed as it goes."""
        report["timeline"][step] = time.time() - t_phase
        emit({"phase": "cluster_reshape_step", "step": step,
              "s": report["timeline"][step]})

    def entries(node, leaf):
        db = node.handler.db_manager.get_db(_cluster_db(leaf)).db
        return sum(db._readers[n].num_entries for level in db._levels
                   for n in level if n in db._readers)

    probe = _HeartbeatProbe()
    log.install()
    stops = []
    reb = None
    try:
        probe.start()
        t0 = time.time()
        for tag, host_only in (("A", False), ("B", False), ("C", True),
                               ("D", False)):
            nodes[tag] = _ClusterNode(tag, root, dev, host_only,
                                      primary_port, fallbacks, store_uri,
                                      options, log, cluster=cluster)
            probe.watch(nodes[tag].participant.coord)
        controller = Controller("127.0.0.1", primary_port, cluster, "ctrl-1",
                                reconcile_interval=CLUSTER_RECONCILE_S,
                                coord_fallbacks=fallbacks)
        others.append(controller.stop)
        spectator = Spectator(
            "127.0.0.1", primary_port, cluster,
            [LocalFilePublisher(os.path.join(root, "shard_map.json")),
             CallbackPublisher(maps.append)],
            coord_fallbacks=fallbacks, scrape_interval=CLUSTER_SCRAPE_S)
        others.insert(0, spectator.stop)
        coord = CoordinatorClient("127.0.0.1", primary_port,
                                  fallbacks=fallbacks)
        others.append(coord.close)
        for client in (controller.coord, spectator.coord, coord):
            probe.watch(client)
        controller.add_resource(ResourceDef(
            CLUSTER_SEGMENT, num_shards=CLUSTER_SHARDS, replicas=3))
        wait(lambda: converged() and map_led(), "the initial assignment")
        report["setup_s"] = time.time() - t0
        mark("setup")
        card_tags = ("A", "B", "D")

        def pick(exclude, led_by_card):
            for s in slots:
                f = free_node(s)
                lead = leader_of(s)
                if s in exclude or f is None or f.tag not in card_tags:
                    continue
                if led_by_card and (lead is None
                                    or lead.tag not in card_tags):
                    continue
                return s
            raise AssertionError("cluster reshape: no shard fits the step")

        m = pick((), True)
        h = pick((m,), False)
        p = pick((m, h), False)
        report["shards_picked"] = {"M": m, "H": h, "P": p}
        torch.cuda.synchronize()
        _build.reset_launches()
        threads += [threading.Thread(target=reader, args=(r,), daemon=True,
                                     name=f"reshape-reader-{r}")
                    for r in range(CLUSTER_READERS)]
        for t in threads:
            t.start()

        # ---- step 1: base load, the operator's move of M -----------------
        base = {s: engine_traffic(RESHAPE_SEED + s, RESHAPE_BASE_RUN,
                                  key_space=RESHAPE_KEY_SPACE)["ops"]
                for s in slots}
        plan = step_plan(base)
        total = sum(len(v) for v in plan.values())
        src, dst = leader_of(m), free_node(m)
        move_box = {"record": None, "phases": {}}
        t_step = time.time()
        writers, done = run_step(plan, "base")
        wait(lambda: acked_in("base") >= total // 2 or failed,
             "half the base load")
        stop_poll = threading.Event()
        stops.append(stop_poll)
        poller = threading.Thread(target=ledger_poller, args=(
            lambda: cluster_path(cluster, "moves", _cluster_partition(m)),
            move_box, stop_poll), daemon=True)
        poller.start()
        t_move = time.monotonic()
        proc, path = operator(
            ["move-shard", *cli_args, "--segment", CLUSTER_SEGMENT,
             "--shard", str(m), "--source", src.instance.instance_id,
             "--target", dst.instance.instance_id, "--store_uri",
             store_uri], "move_shard")
        moved = finish_operator(proc, path, "move-shard")
        t_moved = time.monotonic()
        for t in writers:
            t.join(CLUSTER_WAIT_S)
        t_end = time.time()
        if failed or any(t.is_alive() for t in writers):
            raise AssertionError(f"cluster reshape: base load {failed[:4]}")
        apply_done(plan, done)
        stop_poll.set()
        poller.join(10)
        report["base"] = step_report("base", t_step, t_end,
                                     total * ENGINE_BATCH)
        wait(lambda: converged() and map_led(), "M's replicas after the move")
        if dst not in hosts_of(m) or src in hosts_of(m):
            raise AssertionError(f"cluster reshape: M on "
                                 f"{[n.tag for n in hosts_of(m)]}")
        mark("base_and_move")
        move_compact = compact([(n, m) for n in hosts_of(m)])
        mark("move_compact_db")
        report["operator_move"] = {
            "shard": m, "source": src.tag, "target": dst.tag,
            "seconds": t_moved - t_move,
            "phase_s": phase_seconds(move_box, (
                "planned", "snapshot", "restore", "catchup", "cutover",
                "retire"), move_box.get("gone", t_moved)),
            "cli": moved, "bytes_ingested": moved.get("bytes_ingested"),
            "write_pause": pause_window(m, t_move, t_moved),
            "compact_db": move_compact}
        k2_target = sum(c["k2"] for c in move_compact
                        if c["node"] == dst.tag)
        if k2_target < 1:
            raise AssertionError(f"cluster reshape: M's target {dst.tag} "
                                 f"compact_db launched no K2: "
                                 f"{move_compact}")

        # ---- step 2: hot load into H, the operator's split ---------------
        hot_runs = {s: engine_traffic(
            RESHAPE_SEED + 1000 + s,
            RESHAPE_HOT_RUN if s == h else RESHAPE_COLD_RUN,
            key_space=(RESHAPE_HOT_KEY_SPACE if s == h
                       else RESHAPE_KEY_SPACE))["ops"] for s in slots}
        grown = _oracle(RESHAPE_HOT_KEY_SPACE)
        for k in grown:
            grown[k][:RESHAPE_KEY_SPACE] = oracle[h][k]
        oracle[h] = grown
        plan = step_plan(hot_runs)
        total = sum(len(v) for v in plan.values())
        target_h = free_node(h)
        split_box = {"record": None, "phases": {}}
        trims0 = Stats.get().get_counter("compaction.retain_trims")
        t_step = time.time()
        writers, done = run_step(plan, "hot")
        wait(lambda: acked_in("hot") >= total // 2 or failed,
             "half the hot load")
        stop_poll = threading.Event()
        stops.append(stop_poll)
        poller = threading.Thread(target=ledger_poller, args=(
            lambda: cluster_path(cluster, "splits", _cluster_partition(h)),
            split_box, stop_poll), daemon=True)
        poller.start()
        t_split = time.monotonic()
        split_argv = ["split-shard", *cli_args, "--segment", CLUSTER_SEGMENT,
                      "--shard", str(h), "--target",
                      target_h.instance.instance_id, "--store_uri",
                      store_uri]
        split_proc = operator(split_argv, "split_shard")

        def split_active():
            for rec in list_splits(coord, cluster):
                if rec.parent_shard == h and rec.phase == "active":
                    routes[h] = (rec.split_key_bytes, rec.low_shard,
                                 rec.high_shard)
                    return True
            # the CLI failing before the record reads active fails the
            # phase (finish_operator raises with its output)
            return split_proc[0].poll() not in (None, 0)

        wait(split_active, "the split's active record", poll=0.02)
        t_active = time.monotonic()
        split = finish_operator(*split_proc, "split-shard")
        t_split_done = time.monotonic()

        def children_joined():
            for leaf in routes[h][1:]:
                hosts = hosts_of(leaf)
                if len(hosts) != 3:
                    return False
                for n in hosts:
                    app = n.handler.db_manager.get_db(_cluster_db(leaf))
                    if app is None or app.db.latest_sequence_number() == 0:
                        return False
            return True

        def heal_writer():
            """PUTs of unique keys into the high child, one at a time,
            until every replica of both children holds data: a child
            follower that joined before its leader published its state
            pulls nothing until a write reaches the leader's WAL past its
            seq (ROADMAP Queue 3, F15)."""
            high = routes[h][2]
            deadline = time.time() + CLUSTER_WAIT_S
            pending = []
            while not children_joined() and time.time() < deadline:
                # 16-byte keys and 8-byte values like the counters', so
                # the child's compactions keep to the card's paths
                i = len(heal_tried)
                key = b"heal:\0\0\0" + i.to_bytes(8, "big")
                heal_tried.append(key)
                node = leader_of(high)
                app = (node.handler.db_manager.get_db(_cluster_db(high))
                       if node is not None else None)
                try:
                    pending.append((key, app.write_async(WriteBatch().put(
                        key, i.to_bytes(8, "little")))))
                except Exception as exc:
                    errors.append(("heal", high, getattr(
                        exc, "code", type(exc).__name__)))
                # a PUT's ack waits for a follower that holds data: the
                # next PUT goes out meanwhile
                time.sleep(RESHAPE_HEAL_PAUSE_S)
            # a PUT still unacked here may never be: a follower rebuilt
            # from a snapshot that holds it pulls from past it. Such keys
            # must be on all the child's replicas or on none
            heal_keys.extend(key for key, waiter in pending
                             if waiter.future.done() and waiter.acked)

        heal = threading.Thread(target=heal_writer, daemon=True,
                                name="reshape-heal-writer")
        heal.start()
        heal.join(CLUSTER_WAIT_S)
        if not children_joined():
            raise AssertionError(f"cluster reshape: the children's "
                                 f"replicas never all held data: "
                                 f"{json.dumps(unconverged())[:3000]}")
        t_joined = time.monotonic()
        for t in writers:
            t.join(CLUSTER_WAIT_S)
        t_end = time.time()
        if failed or any(t.is_alive() for t in writers):
            raise AssertionError(f"cluster reshape: hot load {failed[:4]}")
        # H as the parent held it at the cutover: what the split's target
        # took, and what a replica rebuilt from the target before its
        # trim keeps of the other half (ROADMAP F14)
        at_cutover = {k: v.copy() for k, v in oracle[h].items()}
        apply_batches(at_cutover, plan[h][:unsplit[("hot", h)]])
        apply_done(plan, done)
        stop_poll.set()
        poller.join(10)
        report["hot"] = step_report("hot", t_step, t_end, sum(
            done.values()) * ENGINE_BATCH)
        report["hot"]["h_ops"] = done[h] * ENGINE_BATCH
        split_key, low, high = routes[h]
        mark("hot_and_split")
        wait(lambda: converged() and map_led(), "the children's replicas")
        children = [(n, leaf) for leaf in (low, high)
                    for n in hosts_of(leaf)]
        metas = {(n.tag, leaf): n.handler.get_meta_data(_cluster_db(leaf))
                 for n, leaf in children}
        retained = {k: bool(v.retain_lo or v.retain_hi)
                    for k, v in metas.items()}
        before = {f"{n.tag}:{leaf}": entries(n, leaf) for n, leaf in children}
        trims = compact(children)
        mark("trims")
        after = {f"{n.tag}:{leaf}": entries(n, leaf) for n, leaf in children}
        trims_done = Stats.get().get_counter("compaction.retain_trims") \
            - trims0
        card_trims = [c for c in trims if c["node"] in card_tags
                      and retained[(c["node"], c["shard"])]]
        report["operator_split"] = {
            "shard": h, "target": target_h.tag, "low": low, "high": high,
            "split_key": split_key.hex(), "split_key_id": int.from_bytes(
                split_key[8:16], "big") if len(split_key) == 16 else None,
            "cli": split,
            "seconds": t_split_done - t_split,
            "to_active_s": t_active - t_split,
            "active_to_children_joined_s": t_joined - t_active,
            "heal_puts": [len(heal_tried), len(heal_keys)],
            "phase_s": phase_seconds(split_box, (
                "planned", "snapshot", "restore", "catchup", "cutover"),
                t_active),
            "cutover_pause": pause_window(h, t_split, t_active),
            "replicas": {f"{n.tag}:{leaf}": "retain range"
                         if retained[(n.tag, leaf)] else "rebuilt"
                         for n, leaf in children},
            "entries_before_trim": before, "entries_after_trim": after,
            "trims": trims, "retain_trims": trims_done}
        if trims_done < len(card_trims) or any(
                c["k2"] < 1 or c["tuple_merges"] < 1 for c in card_trims) \
                or {c["node"] for c in card_trims} != set(card_tags):
            raise AssertionError(f"cluster reshape: trims {trims}, "
                                 f"retain_trims {trims_done}")
        if any(c["k2"] < 1 for c in trims if c["node"] in card_tags):
            raise AssertionError(f"cluster reshape: a card child replica's "
                                 f"compact_db launched no K2: {trims}")

        # ---- step 3: P runs hot, the rebalancer moves it -----------------
        pol_runs = {s: engine_traffic(
            RESHAPE_SEED + 2000 + s,
            RESHAPE_POLICY_RUN * (RESHAPE_POLICY_HOT if s == p else 1),
            key_space=RESHAPE_KEY_SPACE)["ops"] for s in slots}
        # the traffic twice over: the step ends with the rebalancer's move,
        # whenever it comes
        plan = {s: v * 2 for s, v in step_plan(
            pol_runs, RESHAPE_POLICY_BATCH).items()}
        p_hosts = {n.tag for n in hosts_of(p)}
        p_target = free_node(p)
        saved_interval = os.environ.get("RSTPU_REBALANCE_INTERVAL")
        os.environ["RSTPU_REBALANCE_INTERVAL"] = str(CLUSTER_SCRAPE_S)
        try:
            flags = RebalancerFlags.from_env()
        finally:
            if saved_interval is None:
                del os.environ["RSTPU_REBALANCE_INTERVAL"]
            else:
                os.environ["RSTPU_REBALANCE_INTERVAL"] = saved_interval
        sensor = _SeqRates(list(nodes.values()))
        reb = Rebalancer(coord, cluster, store_uri, flags=flags,
                         load_fn=sensor)
        ticks = []
        real_once = reb.once
        # P's writes fall to a plain shard's share once the rebalancer has
        # acted on it: the policy forgets a shard it acted on, and P kept
        # hot would earn a second move before the operator pauses it
        p_calm = threading.Event()

        def once():
            plans = real_once()
            ticks.append((time.monotonic(), plans))
            if plans:
                p_calm.set()
            return plans

        reb.once = once
        stop_policy = threading.Event()
        stops.append(stop_policy)
        p_box = {"record": None, "phases": {}}
        poller = threading.Thread(target=ledger_poller, args=(
            lambda: cluster_path(cluster, "moves", _cluster_partition(p)),
            p_box, stop_policy), daemon=True)
        poller.start()
        t_step = time.time()
        writers, done = run_step(plan, "policy", stop=stop_policy,
                                 calm=(p, p_calm),
                                 round_s=RESHAPE_POLICY_ROUND_S)
        reb.start()
        t_reb = time.monotonic()

        def moved_p():
            return any(pl for _t, pl in ticks) and not any(
                w.is_alive() for w in reb._workers)

        wait(lambda: moved_p() or failed, "the rebalancer's move of P")
        t_p_moved = time.monotonic()
        stop_policy.set()
        poller.join(10)
        for t in writers:
            t.join(CLUSTER_WAIT_S)
        t_end = time.time()
        if failed or any(t.is_alive() for t in writers):
            raise AssertionError(f"cluster reshape: policy load "
                                 f"{failed[:4]}")
        apply_done(plan, done)
        sent_ops = sum(done.values()) * RESHAPE_POLICY_BATCH
        report["policy"] = step_report("policy", t_step, t_end, sent_ops)
        report["policy"].update(batch=RESHAPE_POLICY_BATCH,
                                round_s=RESHAPE_POLICY_ROUND_S)
        mark("policy_move")
        t_dec, plans = next((t, pl) for t, pl in ticks if pl)
        out, out2 = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_status = admin_cli.main(["rebalance", "status", *cli_args])
        with contextlib.redirect_stdout(out2):
            rc_pause = admin_cli.main(["rebalance", "pause", *cli_args])
        status_doc = json.loads(out.getvalue())
        if rc_status or rc_pause or not status_doc.get("last_decisions") \
                or out2.getvalue().strip() != "rebalancer paused":
            raise AssertionError(f"cluster reshape: rebalance status "
                                 f"{rc_status} pause {rc_pause}: "
                                 f"{out.getvalue()[:2000]}")
        reb.stop()
        if plans != [{"kind": "move", "partition": _cluster_partition(p),
                      "source": plans[0]["source"],
                      "target": p_target.instance.instance_id}] \
                or reb._dispatched != {"moves": 1, "splits": 0,
                                       "failed": 0}:
            raise AssertionError(f"cluster reshape: the rebalancer "
                                 f"dispatched {plans}, {reb._dispatched}: "
                                 f"{status_doc}")
        wait(lambda: converged() and map_led(), "P's replicas after the move")
        if p_target not in hosts_of(p):
            raise AssertionError(f"cluster reshape: P on "
                                 f"{[n.tag for n in hosts_of(p)]}")
        report["policy_move"] = {
            "shard": p, "hosts_before": sorted(p_hosts),
            "target": p_target.tag,
            "scrapes_to_decision": sum(1 for t, _r in sensor.calls
                                       if t <= t_dec),
            "ticks_to_decision": sum(1 for t, _pl in ticks if t <= t_dec),
            "decision_s_from_start": t_dec - t_reb,
            "decision_to_moved_s": t_p_moved - t_dec,
            "phase_s": phase_seconds(p_box, (
                "planned", "snapshot", "restore", "catchup", "cutover",
                "retire"), p_box.get("gone", t_p_moved)),
            "decision": status_doc.get("last_decisions")}

        # ---- checks --------------------------------------------------------
        stop_reads.set()
        for t in threads:
            t.join(CLUSTER_WAIT_S)
        report["reads"] = {"ok": reads["ok"], "errors": reads["errors"],
                           "p50_p99_ms": list(_percentiles(reads["lat"]))}
        wait(lambda: converged() and map_led(), "the final convergence")
        t1 = time.time()
        layout = maps[-1]
        if str(h) not in (layout[CLUSTER_SEGMENT].get("__splits__") or {}):
            raise AssertionError("cluster reshape: the map has no split")
        router = RpcRouter(local_az="az-check")
        router.update_layout(ClusterLayout.parse(json.dumps(
            layout).encode()))
        def oracle_rows(state, lo_k=None, hi_k=None):
            """The live (key, value) rows of an oracle, in key order,
            those in [lo_k, hi_k) where given."""
            rows = [(_key_of(i), int(state["value"][i]).to_bytes(
                8, "little")) for i in np.flatnonzero(
                    state["exists"]).tolist()]
            return [(k, v) for k, v in rows
                    if (lo_k is None or k >= lo_k)
                    and (hi_k is None or k < hi_k)]

        async def read_slot(s):
            """Slot ``s``'s rows through the router: one routed scan past
            the reserved keys (a split slot's low child, then its high
            child; an engine scan walks the whole DB, so it is not paged),
            room for one row more than the oracle's live keys and, on H,
            the heal keys sent; against those rows. Returns the rows
            read."""
            want = oracle_rows(oracle[s])
            got = await router.read(
                CLUSTER_SEGMENT, s, op="scan", start=b"\x01",
                count=len(want) + (len(heal_tried) if s == h else 0) + 1,
                policy=ReadPolicy.leader_only(), timeout=120)
            rows = [(bytes(k), bytes(v)) for k, v in got["values"]]
            heal = {k: v for k, v in rows if k.startswith(b"heal:")}
            rows = [r for r in rows if not r[0].startswith(b"heal:")]
            if rows != want:
                bad = next((j for j, (g, w) in enumerate(zip(rows, want))
                            if g != w), min(len(rows), len(want)))
                raise AssertionError(
                    f"cluster reshape: slot {s} row {bad} of {len(rows)} "
                    f"through the router {rows[bad:bad + 1]!r}, of "
                    f"{len(want)} want {want[bad:bad + 1]!r}")
            if (heal and s != h) or s == h and not (
                    set(heal_keys) <= set(heal) <= set(heal_tried)
                    and all(v == k[8:][::-1] for k, v in heal.items())):
                raise AssertionError(f"cluster reshape: slot {s} reads "
                                     f"{len(heal)} heal keys, "
                                     f"{len(heal_keys)} acked")
            return len(rows) + len(heal)

        async def read_all():
            # the slots side by side: their leaders are spread over the
            # nodes, each serving on its own loop
            return sum(await asyncio.gather(*[read_slot(s) for s in slots]))

        keys_read = ioloop.run_sync(read_all(), timeout=CLUSTER_WAIT_S)
        # one routed multi_get across H's split key: the router splits
        # it between the children and stitches the values back
        ids = np.flatnonzero(oracle[h]["touched"]).tolist()
        below = [i for i in ids if _key_of(i) < split_key]
        above = [i for i in ids if _key_of(i) >= split_key]
        part = below[-RESHAPE_READ_KEYS // 2:] + above[:RESHAPE_READ_KEYS // 2]
        if not below or not above:
            raise AssertionError(f"cluster reshape: H's touched keys "
                                 f"{len(below)} below its split key, "
                                 f"{len(above)} above")
        got = ioloop.run_sync(router.read(
            CLUSTER_SEGMENT, h, op="multi_get",
            keys=[_key_of(i) for i in part],
            policy=ReadPolicy.leader_only(), timeout=60))
        want = [int(oracle[h]["value"][i]).to_bytes(8, "little")
                if oracle[h]["exists"][i] else None for i in part]
        if [bytes(v) if v is not None else None
                for v in got["values"]] != want:
            raise AssertionError("cluster reshape: a routed multi_get "
                                 "across H's split differs from the oracle")
        keys_read += len(part)
        router.close()
        report["router_read_back"] = {"keys": keys_read,
                                      "seconds": time.time() - t1}
        mark("router_read_back")
        t1 = time.time()
        strays, heal_on = {}, {}
        for leaf in leaves():
            other = {}
            if leaf in (low, high):
                lo_k, hi_k = (None, split_key) if leaf == low \
                    else (split_key, None)
                want = oracle_rows(oracle[h], lo_k, hi_k)
                # the other child's rows as H held them at the cutover
                other = dict(oracle_rows(at_cutover, hi_k, lo_k))
            else:
                lo_k = hi_k = None
                want = oracle_rows(oracle[leaf])
            seqs = set()
            for n in hosts_of(leaf):
                db = n.handler.db_manager.get_db(_cluster_db(leaf)).db
                seqs.add(db.latest_sequence_number())
                rows, outside, heal_seen = [], [], set()
                for k, v in db.new_iterator():
                    if k.startswith(b"\x00"):
                        continue
                    if k.startswith(b"heal:") and leaf == high:
                        heal_seen.add(k)
                        continue
                    if (lo_k is not None and k < lo_k) or \
                            (hi_k is not None and k >= hi_k):
                        outside.append((k, v))
                        continue
                    rows.append((k, v))
                if rows != want:
                    raise AssertionError(
                        f"cluster reshape: shard {leaf} on {n.tag}: "
                        f"{len(rows)} keys in range, want {len(want)}")
                if leaf == high:
                    if not set(heal_keys) <= heal_seen <= set(heal_tried) \
                            or heal_seen != heal_on.setdefault(
                                "first", heal_seen):
                        raise AssertionError(
                            f"cluster reshape: {n.tag} holds "
                            f"{len(heal_seen)} heal keys of "
                            f"{len(heal_tried)} sent, {len(heal_keys)} "
                            f"acked, another replica "
                            f"{len(heal_on['first'])}")
                if outside and retained.get((n.tag, leaf), False):
                    raise AssertionError(
                        f"cluster reshape: {n.tag}'s child {leaf} keeps "
                        f"{len(outside)} keys outside its range after the "
                        f"trim")
                if outside:
                    # a rebuilt replica (F14) keeps a copy of the target's
                    # rows of the other half: H's at the cutover, less
                    # what the target trimmed before the copy
                    foreign = [(k, v) for k, v in outside
                               if other.get(k) != v]
                    if foreign:
                        raise AssertionError(
                            f"cluster reshape: {n.tag}'s rebuilt child "
                            f"{leaf} keeps {len(foreign)} of {len(outside)} "
                            f"rows outside its range that H did not hold at "
                            f"the cutover: {foreign[:2]!r}")
                    strays[f"{n.tag}:{leaf}"] = {
                        "rows": len(outside), "at_cutover": len(other)}
            if len(seqs) != 1:
                raise AssertionError(f"cluster reshape: shard {leaf} seqs "
                                     f"{seqs}")
        report["scan_check_s"] = time.time() - t1
        mark("scan_check")
        # rows of the other half on a child replica the controller rebuilt
        # from a peer's snapshot (no retain range; ROADMAP Queue 3, F14),
        # beside the other half's rows at the cutover
        report["out_of_range_on_rebuilt"] = strays
        wait(lambda: len(spectator.cluster_stats.get("per_shard") or {})
             >= len(leaves()), "the spectator's /cluster_stats", timeout=60)
        stats = json.loads(spectator.cluster_stats_json())
        moves_c = stats.get("shard_moves", {}).get("counters", {})
        splits_s = stats.get("shard_splits", {})
        if moves_c.get("completed") != 2 or _cluster_partition(h) not in \
                splits_s.get("active", {}):
            raise AssertionError(f"cluster reshape: /cluster_stats moves "
                                 f"{stats.get('shard_moves')}, splits "
                                 f"{splits_s}")
        report["cluster_stats"] = {"shard_moves": stats["shard_moves"],
                                   "shard_splits": splits_s,
                                   "rebalancer": stats.get("rebalancer")}
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        bg = {}
        for leaf in leaves():
            for n in hosts_of(leaf):
                db = n.handler.db_manager.get_db(_cluster_db(leaf)).db
                bg[(n.tag, leaf)] = (db._bg_compaction_error,
                                     db._bg_compaction_failures,
                                     db._bg_flush_failures)
    finally:
        stop_reads.set()
        for ev in stops:
            ev.set()
        for t in threads:
            t.join(timeout=60)
        if reb is not None:
            reb.stop(timeout=30)
        probe.stop()
        log.uninstall()
        _cluster_teardown(others, nodes, ioloop, pool, coordinators)
        mgr.load_from_dict(saved_config)
        _sort_flag(None)
    if log.errors:
        raise AssertionError(f"cluster reshape: compactions raised "
                             f"{log.errors[:4]}")
    bad = {k: v for k, v in bg.items() if v[0] is not None or v[1] or v[2]}
    if bad:
        raise AssertionError(f"cluster reshape: background errors "
                             f"{list(bad.items())[:4]}")
    per = {t: log.of(t) for t in ("A", "B", "C", "D")}
    stray = [x for x in log.launches if x[1] not in card_tags]
    if stray or per["C"]["launches"]:
        raise AssertionError(f"cluster reshape: launches outside the card "
                             f"nodes' compactions {stray[:8]}")
    report["compactions"] = {
        t: {k: q[k] for k in ("calls", "by_thread", "declined",
                              "tuple_calls", "launches")}
        | {"seconds_sum": sum(q["seconds"]),
           "tuple_seconds_sum": sum(q["tuple_seconds"])}
        for t, q in per.items()}
    report["heartbeats"] = probe.report(CLUSTER_SOAK_TTL * 2 / 3)
    report["launches"] = launches
    report["seconds"] = time.time() - t_phase
    return report, launches


# ---------------------------------------------------------------------------
# chaos_dataplane, chaos_cdc: the chaos harness's data-plane and CDC decks
# (rocksplicator_tpu_torch/tools/chaos_soak.py) with every DB on the card.
# The decks keep the reference's shapes (tools/chaos_soak.py:221-265: 32 KiB
# memtables, L0 trigger 3, background compaction, subcompaction slices of
# 256 entries, the streaming merge always on in 512-entry chunks), which
# are the harness's own setting for fault-and-heal density; real data scale
# is carried by the earlier phases. Arguments are the Makefile's:
# chaos-smoke (:346-364), compaction-remote-smoke (:149) and cdc-smoke
# (:416-422).
# ---------------------------------------------------------------------------

CHAOS_SCHEDULES = 20  # make chaos-smoke's soak
CHAOS_SEED = 1
CHAOS_MUX_SCHEDULES = 6  # the mux deck under RSTPU_PULL_MUX=1
CHAOS_MUX_SEED = 3
# (break guard, run_chaos arguments beside the defaults, a phrase one of
# its violations must hold; None: any violation)
CHAOS_TEETH = (
    ("wal_hole", {"conv_timeout": 3.0}, "WAL hole"),
    ("meta_first", {"ingest_every": 1, "conv_timeout": 10.0}, "meta"),
    ("mux_misroute", {"conv_timeout": 3.0}, None),
    ("remote_install", {"remote_every": 1, "conv_timeout": 3.0},
     "DEPOSED LEADER'S JOB INSTALLED"),
)
CHAOS_TOOTH_SCHEDULES = 1
CHAOS_TOOTH_SEED = 7
CDC_CHAOS_SCHEDULES = 2  # make cdc-smoke
CDC_CHAOS_SEED = 1
CDC_TOOTH_SEED = 7


class _BgFailures:
    """Counts, from the port's engine logger, the background compactions
    that failed and were retried by the loop (``storage/engine.py``: log,
    sleep 1 s, pick again), and among them the card's raises: a direct
    sink (``merge_runs_to_files``) failing inside ``_write_merged``,
    which on the card raises where the CPU path takes the tuple path.
    Also counts the tuple-path fallbacks, which the card never takes."""

    FAILED = "background compaction failed"
    FALLBACK = "direct merge sink failed"

    def __init__(self):
        import logging
        import threading

        self._lock = threading.Lock()
        self.failures = 0
        self.card_raises: dict = {}
        self.fallbacks = 0
        self._logger = logging.getLogger(
            "rocksplicator_tpu_torch.storage.engine")
        outer = self

        class _Handler(logging.Handler):
            def emit(self, record):
                outer._record(record)

        self._handler = _Handler(level=logging.ERROR)

    def __enter__(self):
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)

    def _record(self, record) -> None:
        import re

        msg = str(record.msg)
        with self._lock:
            if self.FALLBACK in msg:
                self.fallbacks += 1
                return
            if self.FAILED not in msg:
                return
            self.failures += 1
            exc = record.exc_info[1] if record.exc_info else None
            frames, tb = set(), getattr(exc, "__traceback__", None)
            while tb is not None:
                frames.add(tb.tb_frame.f_code.co_name)
                tb = tb.tb_next
            if {"_write_merged", "merge_runs_to_files"} <= frames:
                found = re.search(r"failpoint (\S+) tripped", str(exc))
                site = found.group(1) if found else type(exc).__name__
                self.card_raises[site] = self.card_raises.get(site, 0) + 1

    def report(self) -> dict:
        with self._lock:
            return {"bg_failures_retried": self.failures,
                    "card_raises_retried": sum(self.card_raises.values()),
                    "card_raises_by_site": dict(self.card_raises),
                    "tuple_fallbacks": self.fallbacks}


def _chaos_knobs() -> tuple:
    """The three module-wide settings the decks scope to their runs."""
    from rocksplicator_tpu_torch.storage import native_compaction, stream_merge

    return (native_compaction.MIN_SLICE_ENTRIES,
            stream_merge.STREAM_MODE_OVERRIDE,
            stream_merge.CHUNK_ENTRIES_OVERRIDE)


def _set_chaos_knobs(knobs: tuple) -> None:
    from rocksplicator_tpu_torch.storage import native_compaction, stream_merge

    (native_compaction.MIN_SLICE_ENTRIES, stream_merge.STREAM_MODE_OVERRIDE,
     stream_merge.CHUNK_ENTRIES_OVERRIDE) = knobs


def _chaos_deck(run, what: str, dev, work_dir: str, **kw) -> tuple:
    """One deck, its launches and failpoint trips counted alone:
    (report, launches)."""
    import torch

    from rocksplicator_tpu_torch.ops import _build

    reset_observability()
    root = tempfile.mkdtemp(prefix=f"{what}_", dir=work_dir)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        with _BgFailures() as bg:
            result = run(root, log=lambda *a: None, device=dev, **kw)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(_build.LAUNCHES)
    report = {k: result[k] for k in (
        "schedules", "seed", "writes", "acked", "produced", "kills",
        "consumer_starts", "scenarios", "violations", "failpoint_trips",
        "remote_outcomes", "break_guard", "deck", "move_outcomes",
        "move_ms_median", "passes_used", "write_errors", "window_acked",
        "reads_served", "reads_checked", "read_bounces", "dispatched",
        "resumes", "tick_errors", "schedule_ms", "compactions",
        "replicas_compacted", "k2_compact", "host_path", "split",
        "retain_strays", "out_of_range_on_rebuilt") if k in result}
    report.update(bg.report())
    report["seconds"] = time.perf_counter() - t0
    report["k2"] = launches["fused_resolve"]
    report["k3"] = launches["bloom_build"]
    return report, launches


def _add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _check_tooth(report: dict, phrase, what: str) -> None:
    """``phrase``: None (any violation), a phrase, or a tuple of phrases
    one violation must hold one of."""
    phrases = (phrase,) if isinstance(phrase, str) else phrase
    caught = report["violations"] and (
        phrases is None or any(p in v for v in report["violations"]
                               for p in phrases))
    if not caught:
        raise AssertionError(f"{what}: the tooth was NOT caught "
                             f"(violations {report['violations']})")
    report["caught"] = True
    report["first_violation"] = report["violations"][0]
    report["violations"] = len(report["violations"])


class _PinnedIngestDraws:
    """A schedule RNG for ``IngestFixture.step`` that pins the drawn
    ingest fault to ``fault`` and draws ``compact_db_after_load`` true;
    every other draw is the seeded RNG's."""

    def __init__(self, seed: int, fault, menu):
        import random

        self._rng = random.Random(seed)
        self._fault, self._menu = fault, menu

    def randint(self, a: int, b: int) -> int:
        return self._rng.randint(a, b)

    def choice(self, seq):
        return self._fault if seq is self._menu else self._rng.choice(seq)

    def random(self) -> float:
        return 0.0


def _ingest_compact_run(root: str, log, device, seed: int) -> dict:
    """The ingest fixture's ``compact_db_after_load`` branch, once per
    entry of its fault menu, on ``device``: each load's post-ingest
    compaction goes through the admin plane's BatchCompactor (K2, and K3
    a file), and invariant 3 holds after each (``IngestFixture._check``,
    a clean retry after a fault). The Makefile's seeds draw that branch
    false in every deck, so this is the decks' only way to it."""
    from rocksplicator_tpu_torch.replication import Replicator
    from rocksplicator_tpu_torch.testing import failpoints as fp
    from rocksplicator_tpu_torch.tools.chaos_soak import (_INGEST_FAULTS,
                                                          FLAGS,
                                                          IngestFixture)

    violations: list = []
    fp.clear()
    rep = Replicator(port=0, flags=FLAGS)
    fixture = None
    try:
        fixture = IngestFixture(root, rep, device=device)
        for i, fault in enumerate(_INGEST_FAULTS):
            fixture.step(_PinnedIngestDraws(seed * 1_000_003 + i, fault,
                                            _INGEST_FAULTS),
                         violations, f"ingest_compact {i} ({fault})")
    finally:
        fp.clear()
        if fixture is not None:
            fixture.close()
        rep.stop()
    return {"schedules": len(_INGEST_FAULTS), "seed": seed,
            "violations": violations, "failpoint_trips": fp.trip_counts()}


def chaos_dataplane(dev, work_dir: str, card: str) -> tuple:
    """The data-plane deck on the card: ``run_chaos`` at the reference's
    defaults (80 writes, an ingest every 4 schedules, a remote scenario
    every 3), then the mux deck under RSTPU_PULL_MUX=1, then the four
    data-plane teeth, each of which must be caught, then the ingest
    fixture's post-ingest compactions (``_ingest_compact_run``). Every
    DB, the ingest handler's and the remote worker's merges run on
    ``dev``. Fails on any
    violation of a healthy deck, a tooth not caught, no K2 or no K3
    launch, a remote fixture that never installs or never fences, or a
    tuple-path fallback. The failpoints are cleared and the chaos knobs
    and RSTPU_PULL_MUX restored however it ends."""
    import os

    from rocksplicator_tpu_torch.testing import failpoints as fp
    from rocksplicator_tpu_torch.tools.chaos_soak import run_chaos

    knobs = _chaos_knobs()
    saved_mux = os.environ.get("RSTPU_PULL_MUX")
    launches: dict = {}
    report = {"card": card, "decks": {}}
    t0 = time.perf_counter()
    try:
        os.environ.pop("RSTPU_PULL_MUX", None)
        soak, n = _chaos_deck(run_chaos, "chaos", dev, work_dir,
                              schedules=CHAOS_SCHEDULES, seed=CHAOS_SEED)
        _add_launches(launches, n)
        report["decks"]["soak"] = soak
        os.environ["RSTPU_PULL_MUX"] = "1"
        try:
            mux, n = _chaos_deck(run_chaos, "chaos_mux", dev, work_dir,
                                 schedules=CHAOS_MUX_SCHEDULES,
                                 seed=CHAOS_MUX_SEED)
        finally:
            os.environ.pop("RSTPU_PULL_MUX", None)
        _add_launches(launches, n)
        report["decks"]["mux"] = mux
        for deck in (soak, mux):
            if deck["violations"]:
                raise AssertionError(
                    f"chaos_dataplane: violations in a healthy deck "
                    f"(seed {deck['seed']}): {deck['violations']}")
        outcomes = soak["remote_outcomes"]
        for end in ("installed", "fenced"):
            if not any(k.endswith(":" + end) for k in outcomes):
                raise AssertionError(
                    f"chaos_dataplane: the remote fixture never reached "
                    f"{end} ({outcomes})")
        for guard, kw, phrase in CHAOS_TEETH:
            tooth, n = _chaos_deck(
                run_chaos, f"chaos_{guard}", dev, work_dir,
                schedules=CHAOS_TOOTH_SCHEDULES, seed=CHAOS_TOOTH_SEED,
                break_guard=guard, **kw)
            _add_launches(launches, n)
            _check_tooth(tooth, phrase, f"chaos_dataplane {guard}")
            report["decks"][guard] = tooth
        ingest, n = _chaos_deck(_ingest_compact_run, "chaos_ingest", dev,
                                work_dir, seed=CHAOS_SEED)
        _add_launches(launches, n)
        report["decks"]["ingest_compact"] = ingest
        if ingest["violations"]:
            raise AssertionError(
                f"chaos_dataplane: violations in the post-ingest "
                f"compactions: {ingest['violations']}")
        for name, deck in report["decks"].items():
            if deck["tuple_fallbacks"]:
                raise AssertionError(
                    f"chaos_dataplane {name}: {deck['tuple_fallbacks']} "
                    f"card compactions took the host's tuple path")
        if not launches.get("fused_resolve") or not launches.get(
                "bloom_build"):
            raise AssertionError(
                f"chaos_dataplane: K2 and K3 must both launch ({launches})")
    finally:
        fp.clear()
        leaked = _chaos_knobs() != knobs
        _set_chaos_knobs(knobs)
        if saved_mux is None:
            os.environ.pop("RSTPU_PULL_MUX", None)
        else:
            os.environ["RSTPU_PULL_MUX"] = saved_mux
    if leaked:
        raise AssertionError("chaos_dataplane: a deck left the chaos "
                             "scale set")
    report["seconds"] = time.perf_counter() - t0
    report["card_raises_retried"] = sum(
        d["card_raises_retried"] for d in report["decks"].values())
    return report, launches


def chaos_cdc(dev, work_dir: str, card: str) -> tuple:
    """The CDC deck on the card: ``run_cdc_chaos`` (2 schedules, seed 1)
    with no violation, then its ``cdc_dedup`` tooth (1 schedule, seed 7),
    which must be caught by the applies witness. The three-replica
    group compacts on ``dev``."""
    from rocksplicator_tpu_torch.testing import failpoints as fp
    from rocksplicator_tpu_torch.tools.chaos_soak import run_cdc_chaos

    knobs = _chaos_knobs()
    launches: dict = {}
    report = {"card": card, "decks": {}}
    t0 = time.perf_counter()
    try:
        deck, n = _chaos_deck(run_cdc_chaos, "chaos_cdc", dev, work_dir,
                              schedules=CDC_CHAOS_SCHEDULES,
                              seed=CDC_CHAOS_SEED)
        _add_launches(launches, n)
        report["decks"]["cdc"] = deck
        if deck["violations"]:
            raise AssertionError(
                f"chaos_cdc: violations in the healthy deck: "
                f"{deck['violations']}")
        tooth, n = _chaos_deck(run_cdc_chaos, "chaos_cdc_dedup", dev,
                               work_dir, schedules=CHAOS_TOOTH_SCHEDULES,
                               seed=CDC_TOOTH_SEED, break_guard="cdc_dedup")
        _add_launches(launches, n)
        _check_tooth(tooth, "applies_total", "chaos_cdc cdc_dedup")
        report["decks"]["cdc_dedup"] = tooth
        for name, d in report["decks"].items():
            if d["tuple_fallbacks"]:
                raise AssertionError(
                    f"chaos_cdc {name}: {d['tuple_fallbacks']} card "
                    f"compactions took the host's tuple path")
    finally:
        fp.clear()
        leaked = _chaos_knobs() != knobs
        _set_chaos_knobs(knobs)
    if leaked:
        raise AssertionError("chaos_cdc: a deck left the chaos scale set")
    report["seconds"] = time.perf_counter() - t0
    return report, launches


# ---------------------------------------------------------------------------
# chaos_reshard, chaos_rebalance: the chaos harness's reshard and rebalance
# decks (rocksplicator_tpu_torch/tools/chaos_soak.py) on card nodes: a
# FailoverCluster of 4 nodes, one shard of 3 replicas (2 hash shards for the
# rebalance deck), every node's admin plane compacting on the card. The
# decks keep the reference's shapes (tools/chaos_soak.py:2006-3297: its move
# and policy pacing, 20 ms and 4 ms writers, 1 s sessions); arguments are the
# Makefile's reshard-smoke (:396-401) and rebalance-smoke (:247-252), the
# teeth with a 5 s heal window as the reference's tier-1 cases run them.
# ---------------------------------------------------------------------------

RESHARD_CHAOS_SCHEDULES = 3  # make reshard-smoke
RESHARD_CHAOS_SEED = 1
REBALANCE_CHAOS_SCHEDULES = 3  # make rebalance-smoke
REBALANCE_CHAOS_SEED = 1
RESHAPE_TOOTH_HEAL_S = 5.0
RESHAPE_COMPACT_SEED = 1


def _reshape_compact_run(root: str, log, device, seed: int) -> dict:
    """One move and one split on card nodes, each followed by compact_db
    on every replica it made, built from the decks' own pieces.

    A ``FailoverCluster`` of 4 nodes and 2 hash shards on ``device``, under
    the chaos scale: one ``move_clean_leader`` schedule
    (``_reshard_schedule``: shard 0's leader moves under its background
    writer), the sixth invariant and the reads' (``_check_reshard_
    invariants``, ``_check_read_invariants``), compact_db by admin RPC on
    the moved shard's three replicas, both invariants again; then one
    ``rebalance_split_hot`` schedule (``_rebalance_schedule``: the policy
    splits shard 0, its splitter killed at the cutover and resumed), the
    move's acked writes carried into the parent's ledger so the seventh
    invariant (``_check_rebalance_invariants``) checks them on the child
    that owns each, compact_db on the six child replicas (where a child
    holds a retain range, the trim: ``DB._retain_filter``), and the
    seventh invariant again. The decks write tens of keys a schedule into
    32 KiB memtables and never compact; this is their way to K2 (on the
    tuple path: the chaos keys vary in width). The schedules' tags are
    short (``m1``, ``s1``), so their keys fit K2's 24-byte key lanes
    (``ops/kv_format.py`` ``KEY_BYTES``, as in the JAX package); the
    decks' own tags (``s00-<kind>/seed 1``) make keys of 25-40 bytes,
    which every backend merges on the host.

    Each compaction's K2 launches and host-path merges
    (``NumpyCompactionBackend.merge_runs``, the card backend's fallback)
    are counted; a child replica with a retain range is scanned for keys
    outside it, and one without (rebuilt from a peer, F14) for rows other
    than the decks' own (a deck writes key = value, or ``<tag>-k<i>`` =
    ``<tag>-v<i>``)."""
    import random
    import threading

    from rocksplicator_tpu_torch.cluster.shard_split import list_splits
    from rocksplicator_tpu_torch.gpu import NumpyCompactionBackend
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.testing import failpoints as fp
    from rocksplicator_tpu_torch.tools import chaos_soak as cs
    from rocksplicator_tpu_torch.utils.segment_utils import (
        db_name_to_partition_name, segment_to_db_name)

    violations: list = []
    host_calls: list = []
    real_merge = NumpyCompactionBackend.merge_runs

    def counted_merge(backend, *args, **kwargs):
        host_calls.append(threading.current_thread().name)
        return real_merge(backend, *args, **kwargs)

    def k2() -> int:
        return _build.LAUNCHES.get("fused_resolve", 0)

    def compact(cluster, db: str, hosts: list) -> list:
        out = []
        for n in hosts:
            k0, h0, t0 = k2(), len(host_calls), time.perf_counter()
            cluster.admin.compact_db(
                (n.instance.host, n.instance.admin_port), db)
            out.append({"node": n.name, "db": db, "k2": k2() - k0,
                        "host_path": len(host_calls) - h0,
                        "seconds": time.perf_counter() - t0})
        return out

    compactions: list = []
    strays: dict = {}
    rebuilt: dict = {}
    split_info = None
    timings = {"move_ms": [], "move_outcomes": {}, "write_errors": 0,
               "window_acked": 0, "reads_checked": 0, "reads_served": 0,
               "read_bounces": 0, "tick_errors": 0, "dispatched": {},
               "resumes": 0, "schedule_ms": []}
    passes: list = []
    with cs._chaos_scale():
        fp.clear()
        cluster = cs.FailoverCluster(root, num_nodes=4, num_shards=2,
                                     device=device)
        NumpyCompactionBackend.merge_runs = counted_merge
        try:
            cluster.wait_initial_convergence()
            part, db = cluster.partitions[0], cluster.db_names[0]
            acked: list = []
            tag = f"m{seed}"
            try:
                cs._reshard_schedule("move_clean_leader")(
                    cluster, random.Random(seed * 1_000_003), acked,
                    violations, tag, timings)
            finally:
                fp.clear()
            passes.append(cs._check_reshard_invariants(
                cluster, acked, tag, violations))
            cs._check_read_invariants(cluster, acked, tag, violations,
                                      timings)
            compactions += compact(
                cluster, db, [n for n in cluster.nodes if n.state_of(part)])
            tag += " compacted"
            passes.append(cs._check_reshard_invariants(
                cluster, acked, tag, violations))
            cs._check_read_invariants(cluster, acked, tag, violations,
                                      timings)
            acked_by_shard = {0: list(acked)}
            tag = f"s{seed}"
            try:
                cs._rebalance_schedule("rebalance_split_hot")(
                    cluster, random.Random(seed * 1_000_003 + 1),
                    acked_by_shard, violations, tag, timings)
            finally:
                fp.clear()
            passes.append(cs._check_rebalance_invariants(
                cluster, acked_by_shard, tag, violations))
            split = next((r for r in list_splits(cluster.client,
                                                 cluster.cluster)
                          if r.segment == cluster.segment
                          and r.parent_shard == 0 and r.phase == "active"),
                         None)
            if split is None:
                violations.append(f"{tag}: shard 0 was not split")
            else:
                key = split.split_key_bytes
                split_info = {"low": split.low_shard,
                              "high": split.high_shard,
                              "split_key": key.hex()}
                for child, lo, hi in ((split.low_shard, None, key),
                                      (split.high_shard, key, None)):
                    cdb = segment_to_db_name(cluster.segment, child)
                    cpart = db_name_to_partition_name(cdb)
                    hosts = [n for n in cluster.nodes if n.state_of(cpart)]
                    compactions += compact(cluster, cdb, hosts)
                    for n in hosts:
                        meta = n.handler.get_meta_data(cdb)
                        app = n.handler.db_manager.get_db(cdb)
                        outside = [] if app is None else [
                            (k, v) for k, v in app.db.new_iterator()
                            if not k.startswith(b"\x00")
                            and ((lo is not None and k < lo)
                                 or (hi is not None and k >= hi))]
                        name = f"{n.name}:{child}"
                        if meta.retain_lo or meta.retain_hi:
                            strays[name] = len(outside)
                            if outside:
                                violations.append(
                                    f"{tag}: {name} keeps {len(outside)} "
                                    f"keys outside its retain range after "
                                    f"compact_db")
                        else:
                            rebuilt[name] = len(outside)
                            foreign = [
                                k for k, v in outside
                                if v not in (k, k.replace(b"-k", b"-v"))]
                            if foreign:
                                violations.append(
                                    f"{tag}: rebuilt {name} holds "
                                    f"{len(foreign)} rows no deck wrote "
                                    f"outside its range")
            tag += " compacted"
            passes.append(cs._check_rebalance_invariants(
                cluster, acked_by_shard, tag, violations))
        finally:
            NumpyCompactionBackend.merge_runs = real_merge
            fp.clear()
            cluster.stop()
    return {"schedules": 2, "seed": seed, "violations": violations,
            "failpoint_trips": fp.trip_counts(),
            "acked": sum(len(v) for v in acked_by_shard.values()),
            "move_outcomes": timings["move_outcomes"],
            "dispatched": timings["dispatched"],
            "resumes": timings["resumes"], "passes_used": passes,
            "split": split_info, "compactions": compactions,
            "replicas_compacted": len(compactions),
            "k2_compact": sum(c["k2"] for c in compactions),
            "host_path": len(host_calls),
            "retain_strays": strays, "out_of_range_on_rebuilt": rebuilt}


def chaos_reshard(dev, work_dir: str, card: str) -> tuple:
    """The reshard deck on card nodes: ``run_reshard_chaos`` (3 schedules,
    seed 1) with no violation, every move ending completed, resumed,
    aborted or with nothing to resume (none wedged, none failing its abort
    or resume), every schedule healed within ``RESHARD_PASS_BOUND``
    controller passes; then its ``move_flip`` tooth (1 schedule, seed 7),
    which the lineage probes must catch. The failpoints are cleared and
    the chaos scale restored however it ends."""
    from rocksplicator_tpu_torch.testing import failpoints as fp
    from rocksplicator_tpu_torch.tools.chaos_soak import (
        RESHARD_PASS_BOUND, run_reshard_chaos)

    knobs = _chaos_knobs()
    launches: dict = {}
    report = {"card": card, "decks": {}}
    t0 = time.perf_counter()
    try:
        deck, n = _chaos_deck(run_reshard_chaos, "chaos_reshard", dev,
                              work_dir, schedules=RESHARD_CHAOS_SCHEDULES,
                              seed=RESHARD_CHAOS_SEED)
        _add_launches(launches, n)
        report["decks"]["reshard"] = deck
        if deck["violations"]:
            raise AssertionError(
                f"chaos_reshard: violations in the healthy deck: "
                f"{deck['violations']}")
        bad = set(deck["move_outcomes"]) & {"wedged", "abort_failed",
                                            "resume_failed"}
        if bad or sum(deck["move_outcomes"].values()) != len(deck["deck"]):
            raise AssertionError(
                f"chaos_reshard: move outcomes {deck['move_outcomes']} "
                f"for the deck {deck['deck']}")
        if any(p > RESHARD_PASS_BOUND for p in deck["passes_used"]):
            raise AssertionError(
                f"chaos_reshard: controller passes {deck['passes_used']} "
                f"past the bound {RESHARD_PASS_BOUND}")
        tooth, n = _chaos_deck(
            run_reshard_chaos, "chaos_move_flip", dev, work_dir,
            schedules=CHAOS_TOOTH_SCHEDULES, seed=CHAOS_TOOTH_SEED,
            break_guard="move_flip", heal_timeout=RESHAPE_TOOTH_HEAL_S)
        _add_launches(launches, n)
        _check_tooth(tooth, ("SERVING LINEAGE", "NEW LINEAGE"),
                     "chaos_reshard move_flip")
        report["decks"]["move_flip"] = tooth
        for name, d in report["decks"].items():
            if d["tuple_fallbacks"]:
                raise AssertionError(
                    f"chaos_reshard {name}: {d['tuple_fallbacks']} card "
                    f"compactions took the host's tuple path")
    finally:
        fp.clear()
        leaked = _chaos_knobs() != knobs
        _set_chaos_knobs(knobs)
    if leaked:
        raise AssertionError("chaos_reshard: a deck left the chaos scale "
                             "set")
    report["seconds"] = time.perf_counter() - t0
    return report, launches


def chaos_rebalance(dev, work_dir: str, card: str) -> tuple:
    """The rebalance deck on card nodes: ``run_rebalance_chaos`` (3
    schedules, seed 1) with no violation and at least one move and one
    split dispatched by the policy; its ``split_cutover`` tooth (1
    schedule, seed 7), which must be caught; then ``_reshape_compact_run``,
    which fails on any violation, on a replica's compact_db that saw no
    K2 launch, or on a compaction that took the host's path. Fails on a
    tuple-path fallback in any of them."""
    from rocksplicator_tpu_torch.testing import failpoints as fp
    from rocksplicator_tpu_torch.tools.chaos_soak import run_rebalance_chaos

    knobs = _chaos_knobs()
    launches: dict = {}
    report = {"card": card, "decks": {}}
    t0 = time.perf_counter()
    try:
        deck, n = _chaos_deck(run_rebalance_chaos, "chaos_rebalance", dev,
                              work_dir, schedules=REBALANCE_CHAOS_SCHEDULES,
                              seed=REBALANCE_CHAOS_SEED)
        _add_launches(launches, n)
        report["decks"]["rebalance"] = deck
        if deck["violations"]:
            raise AssertionError(
                f"chaos_rebalance: violations in the healthy deck: "
                f"{deck['violations']}")
        if not (deck["dispatched"].get("move")
                and deck["dispatched"].get("split")):
            raise AssertionError(
                f"chaos_rebalance: the policy dispatched "
                f"{deck['dispatched']}, not a move and a split")
        tooth, n = _chaos_deck(
            run_rebalance_chaos, "chaos_split_cutover", dev, work_dir,
            schedules=CHAOS_TOOTH_SCHEDULES, seed=CHAOS_TOOTH_SEED,
            break_guard="split_cutover", heal_timeout=RESHAPE_TOOTH_HEAL_S)
        _add_launches(launches, n)
        _check_tooth(tooth, None, "chaos_rebalance split_cutover")
        report["decks"]["split_cutover"] = tooth
        run, n = _chaos_deck(_reshape_compact_run, "chaos_reshape_compact",
                             dev, work_dir, seed=RESHAPE_COMPACT_SEED)
        _add_launches(launches, n)
        report["decks"]["reshape_compact"] = run
        if run["violations"]:
            raise AssertionError(
                f"chaos_rebalance: violations around the compactions: "
                f"{run['violations']}")
        if any(c["k2"] < 1 for c in run["compactions"]) \
                or run["replicas_compacted"] < 9:
            raise AssertionError(
                f"chaos_rebalance: a compact_db with no K2 launch, or "
                f"fewer than 9 replicas compacted ({run['compactions']})")
        if run["host_path"]:
            raise AssertionError(
                f"chaos_rebalance: {run['host_path']} card compactions "
                f"took the host's path")
        for name, d in report["decks"].items():
            if d["tuple_fallbacks"]:
                raise AssertionError(
                    f"chaos_rebalance {name}: {d['tuple_fallbacks']} card "
                    f"compactions took the host's tuple path")
    finally:
        fp.clear()
        leaked = _chaos_knobs() != knobs
        _set_chaos_knobs(knobs)
    if leaked:
        raise AssertionError("chaos_rebalance: a deck left the chaos scale "
                             "set")
    report["seconds"] = time.perf_counter() - t0
    return report, launches


def main() -> int:
    import os

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from rocksplicator_tpu_torch.entry import bench_model, entry
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing ({exc})",
              file=sys.stderr)
        return 2
    from rocksplicator_tpu_torch.models.compaction_model import (
        FORWARD_ARGS, CompactionModel, synth_counter_batch,
        synth_mixed_batch)
    from rocksplicator_tpu_torch.ops import _build, bitonic_sort, bloom_kernel
    from rocksplicator_tpu_torch.ops.bitonic_sort import (
        bitonic_sort_lanes, plan_sort, sort_lanes_plain)
    from rocksplicator_tpu_torch.ops.bloom import bloom_build_plain
    from rocksplicator_tpu_torch.ops.bloom_kernel import (
        launch_bloom_build, launch_bloom_build_batched, plan_bloom)
    from rocksplicator_tpu_torch.ops.compaction_kernel import (
        MergeKind, composite_key_lanes, merge_resolve_batched,
        merge_resolve_plain)
    from rocksplicator_tpu_torch.ops.fused_resolve import (
        fused_merge_resolve, plan_fused)
    from rocksplicator_tpu_torch.ops.kv_format import (KEY_WORDS,
                                                       pack_entries,
                                                       unpack_entries)
    from rocksplicator_tpu_torch.ops.lanes import (lanes_from_numpy,
                                                   lanes_to_numpy)
    from rocksplicator_tpu_torch.storage.bloom import num_words_for
    from rocksplicator_tpu_torch.storage.records import OpType

    # a run still going near the 1,200 s limit prints every thread's stack
    # to stderr once, so that a cut run shows where it waited
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False)
    dev = torch.device(DEVICE)
    torch.manual_seed(0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 1. build ----------------------------------------------------
    t0 = time.time()
    reports = _build.build_all()
    build_s = time.time() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln][:12]
             for k, v in reports.items()}
    emit({"phase": "build", "seconds": round(build_s, 2),
          "dir": str(_build.build_dir()), "ptxas": ptxas})
    sources = {
        "bitonic_sort": ("rocksplicator_tpu_torch/ops/csrc/bitonic_sort.cu",
                         "rocksplicator_tpu/ops/pallas_sort.py:190"),
        "fused_resolve": ("rocksplicator_tpu_torch/ops/csrc/fused_resolve.cu",
                          "rocksplicator_tpu/ops/pallas_resolve.py:277"),
        "bloom_build": ("rocksplicator_tpu_torch/ops/csrc/bloom_build.cu",
                        "rocksplicator_tpu/ops/pallas_kernels.py:57"),
    }
    emit({"phase": "kernels", "sources": {k: v[0] for k, v in
                                          sources.items()}})

    def lanes_of(batch):
        t = lanes_from_numpy(batch, dev)
        return tuple(t[k] for k in FORWARD_ARGS)

    def sort_operands(args, uniform_klen, seq32, key_words):
        kw, kl, shi, slo, vt, vw, vl, valid = args
        ops = composite_key_lanes(
            (~valid).to(torch.int32), [kw[:, w] for w in range(key_words)],
            kl, shi, slo, uniform_klen=uniform_klen, seq32=seq32)
        num_keys = len(ops)
        ops += [vt, vl] + [vw[:, w] for w in range(vw.shape[1])]
        return [x.contiguous() for x in ops], num_keys

    def tied_lanes(n, num_keys, lanes, seed):
        """Keys from a 3-value alphabet (high bit set on odd lanes), so
        most rows tie; payload: distinct row numbers, then random words."""
        rng = np.random.default_rng(seed)
        cols = {}
        for i in range(lanes):
            if i < num_keys:
                v = (rng.integers(0, 3, n).astype(np.uint32)
                     | np.uint32(0x80000000) * np.uint32(i % 2))
            elif i == num_keys:
                v = rng.permutation(n).astype(np.uint32)
            else:
                v = rng.integers(0, 1 << 32, n,
                                 dtype=np.uint64).astype(np.uint32)
            cols[str(i)] = v
        t = lanes_from_numpy(cols, dev)
        return [t[str(i)] for i in range(lanes)], num_keys

    def check_calls(kernel: str, want: int, what: str) -> int:
        """The CUDA launches the C entry point counted in its last call
        must be the plan's."""
        got = _build.CUDA_LAUNCHES[kernel]
        if got != want:
            raise AssertionError(f"{what}: {got} CUDA launches in one call, "
                                 f"the plan says {want}")
        return got

    def k1_calls(ops, num_keys, segment=None) -> int:
        return plan_sort(ops[0].shape[0], num_keys,
                         len(ops) - num_keys, segment).launches

    def k2_calls(args, flags, segment=None) -> int:
        return plan_fused(args[5].shape[0], args[5].shape[1],
                          flags.get("key_words", 6),
                          flags.get("uniform_klen", False),
                          flags.get("seq32", False), segment).launches

    def stacked_lanes(batches):
        """(S, C, ...) lanes of S shards on the card, and the same lanes
        flat as S * C rows."""
        t = lanes_from_numpy({k: np.stack([b[k] for b in batches])
                              for k in FORWARD_ARGS}, dev)
        args = tuple(t[k] for k in FORWARD_ARGS)
        flat = tuple(x.reshape((-1,) + tuple(x.shape[2:])) for x in args)
        return args, flat

    def plain_batched(args, flags):
        """The plain version of the shard axis: merge_resolve_plain shard
        by shard, on the card."""
        per = [merge_resolve_plain(*(x[s] for x in args), **flags)
               for s in range(args[0].shape[0])]
        return {k: torch.stack([o[k] for o in per]) for k in per[0]}

    errs = {k: 0 for k in sources}

    def k3_plain(kw_le, key_len, live, num_words):
        """bloom_build_plain of one bitmap (``live`` a bool mask) or of S
        (``live`` the (S,) counts), shard by shard, on the card."""
        if key_len.dim() == 1:
            return bloom_build_plain(kw_le, key_len, live,
                                     num_words=num_words)
        rows = torch.arange(key_len.shape[1], device=dev)
        return torch.stack([bloom_build_plain(
            kw_le[s], key_len[s], rows < live[s], num_words=num_words)
            for s in range(key_len.shape[0])])

    def k3_call(kw_le, key_len, live, num_words):
        """K3 on the card: one bitmap (``live`` a bool mask) or S (the
        (S,) counts)."""
        if key_len.dim() == 1:
            return launch_bloom_build(kw_le, key_len, live,
                                      num_words=num_words)
        return launch_bloom_build_batched(kw_le, key_len, live,
                                          num_words=num_words)

    def k3_plan(key_len, num_words):
        shards, rows = ((1, key_len.shape[0]) if key_len.dim() == 1
                        else tuple(key_len.shape))
        return plan_bloom(shards, rows, num_words)

    def k3_check(what, kw_le, key_len, live, num_words, want) -> int:
        """One K3 call against ``want`` (the plain version's bitmaps), bit
        for bit, with the plan's CUDA launches; returns them."""
        got = k3_call(kw_le, key_len, live, num_words)
        calls = check_calls("bloom_build",
                            k3_plan(key_len, num_words).launches, what)
        err = max_abs_err(got, want)
        errs["bloom_build"] = max(errs["bloom_build"], err)
        if err:
            raise AssertionError(f"{what}: differs from plain ({err})")
        return calls

    def k3_parity(case, kw_le, key_len, live, num_words) -> None:
        """Both K3 routes against the plain version: the plan's, and the
        other one, by setting the plan's shard limit for a call."""
        want = k3_plain(kw_le, key_len, live, num_words)
        planned = k3_plan(key_len, num_words)
        saved = bloom_kernel.ROWWISE_MAX_SHARDS
        try:
            for limit in (0, 1 << 30):  # the global route, then rowwise
                bloom_kernel.ROWWISE_MAX_SHARDS = limit
                route = k3_plan(key_len, num_words).route
                k3_check(f"K3 {case} [{route}]", kw_le, key_len, live,
                         num_words, want)
        finally:
            bloom_kernel.ROWWISE_MAX_SHARDS = saved
        emit({"phase": "parity", "kernel": "bloom_build", "case": case,
              "shape": list(key_len.shape), "num_words": num_words,
              "routes": ["global", "rowwise"], "planned": planned.route,
              "blocks": planned.blocks, "threads": planned.threads,
              "launches_per_call": planned.launches,
              "compared_with": "bloom_build_plain (shard by shard)",
              "max_abs_err": 0})

    # ---- 2. kernel parity on the card --------------------------------
    bench_args = lanes_of(synth_counter_batch(1 << 17, seed=0))
    big_args = lanes_of(synth_counter_batch(
        BIG_N, seed=11, key_bytes=24, start_seq=(1 << 32) - BIG_N // 2))
    k1_bench = sort_operands(bench_args, True, True, 4)
    k1_big = sort_operands(big_args, False, False, 6)
    k1_cases = {
        "bench_10_lanes_6_keys": k1_bench,
        "flags_off_14_lanes_10_keys": sort_operands(
            lanes_of(synth_mixed_batch(1 << 17, seed=1, valid_frac=1.0)),
            False, False, 6),
        "ties_10_lanes_6_keys": tied_lanes(1 << 17, 6, 10, 21),
        "ties_n256_4_lanes_2_keys": tied_lanes(256, 2, 4, 22),
        "ties_n4096_8_lanes_3_keys": tied_lanes(1 << 12, 3, 8, 23),
        "ties_n4096_16_lanes_15_keys": tied_lanes(1 << 12, 15, 16, 24),
        "ties_16_lanes_12_keys": tied_lanes(1 << 17, 12, 16, 25),
        "job_2p22_14_lanes_10_keys": k1_big,
    }
    for case, (ops, num_keys) in k1_cases.items():
        got = bitonic_sort_lanes(ops, num_keys)
        calls = check_calls("bitonic_sort", k1_calls(ops, num_keys),
                            f"K1 {case}")
        want = sort_lanes_plain(ops, num_keys)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        errs["bitonic_sort"] = max(errs["bitonic_sort"], err)
        if err:
            raise AssertionError(f"K1 {case}: differs from plain ({err})")
        emit({"phase": "parity", "kernel": "bitonic_sort", "case": case,
              "lanes": len(ops), "num_keys": num_keys,
              "n": ops[0].shape[0], "launches_per_call": calls,
              "max_abs_err": err})

    k2_cases = 0
    for mk in MergeKind:
        for drop in (True, False):
            for uniform in (True, False):
                for seq32 in (True, False):
                    for key_words in (4, 6):
                        args = lanes_of(synth_mixed_batch(
                            4096, seed=k2_cases, uniform_klen=uniform,
                            seq32=seq32, key_words=key_words))
                        flags = dict(merge_kind=mk, drop_tombstones=drop,
                                     uniform_klen=uniform, seq32=seq32,
                                     key_words=key_words)
                        got = fused_merge_resolve(*args, **flags)
                        check_calls("fused_resolve", k2_calls(args, flags),
                                    f"K2 {flags}")
                        errs["fused_resolve"] = max(
                            errs["fused_resolve"], compare_outputs(
                                got, merge_resolve_plain(*args, **flags),
                                f"K2 {flags}"))
                        k2_cases += 1
    ovf_args = lanes_of(synth_mixed_batch(1 << 17, seed=99,
                                          hot_rows=70000))
    got = fused_merge_resolve(*ovf_args)
    if not bool(got["needs_cpu_fallback"]):
        raise AssertionError("K2 missed the 2^16-operand overflow flag")
    compare_outputs(got, merge_resolve_plain(*ovf_args), "K2 overflow")
    emit({"phase": "parity", "kernel": "fused_resolve", "n": 4096,
          "flag_cases": k2_cases, "overflow_case_n": 1 << 17,
          "max_abs_err": errs["fused_resolve"]})

    k3_n = 1 << 17
    k3_batch = synth_mixed_batch(k3_n, seed=5)
    k3_kw = lanes_from_numpy({"k": k3_batch["key_words_le"]}, dev)["k"]
    k3_kl = lanes_from_numpy({"k": k3_batch["key_len"]}, dev)["k"]
    k3_valid = torch.from_numpy(k3_batch["valid"]).to(dev)
    k3_words = 40960
    k3_parity("2^17 single, 40960 words", k3_kw, k3_kl, k3_valid, k3_words)
    # one output file's bloom of 2^21 rows (the seam's per-file shape)
    file_batch = synth_mixed_batch(K3_FILE_ROWS, seed=6, valid_frac=1.0)
    file_t = lanes_from_numpy({"kw": file_batch["key_words_le"],
                               "kl": file_batch["key_len"]}, dev)
    k3_file = (file_t["kw"], file_t["kl"],
               torch.ones(K3_FILE_ROWS, dtype=torch.bool, device=dev),
               num_words_for(K3_FILE_ROWS, 10))
    k3_parity("one per-file bloom of 2^21 rows", *k3_file)

    # ---- 2b. values of any width (F6): 16-byte keys, W = 16 and 64 -----
    f6_args = {}
    for w in (16, 64):
        args = lanes_of(synth_mixed_batch(
            PARITY_N, seed=600 + w, uniform_klen=True, seq32=True,
            key_words=4, val_words=w))
        f6_args[w] = args
        ops, num_keys = sort_operands(args, True, True, 4)
        got = bitonic_sort_lanes(ops, num_keys)
        k1_launch = check_calls("bitonic_sort", k1_calls(ops, num_keys),
                                f"K1 W={w}")
        err = max(max_abs_err(g, x) for g, x in zip(
            got, sort_lanes_plain(ops, num_keys)))
        if err:
            raise AssertionError(f"K1 W={w}: differs from plain ({err})")
        k2_launch = {}
        for mk in MergeKind:
            flags = dict(merge_kind=mk, uniform_klen=True, seq32=True,
                         key_words=4)
            got = fused_merge_resolve(*args, **flags)
            k2_launch[mk.value] = check_calls(
                "fused_resolve", k2_calls(args, flags), f"K2 W={w} {mk}")
            errs["fused_resolve"] = max(errs["fused_resolve"], compare_outputs(
                got, merge_resolve_plain(*args, **flags), f"K2 W={w} {mk}"))
        emit({"phase": "parity", "case": "F6 wide values", "n": PARITY_N,
              "key_bytes": 16, "val_words": w, "k1_lanes": len(ops),
              "k1_num_keys": num_keys, "k1_launches_per_call": k1_launch,
              "k2_launches_per_call": k2_launch, "max_abs_err": err})

    # ---- 2c. the shard axis: K2, K1 segmented, K3 batched -------------
    # both flag sets; shard 5 holds 2^16+ operands of one key and must be
    # the only shard flagged
    batched = {}
    for label, fast in (("bench_flags", True), ("flags_off", False)):
        kw_n = 4 if fast else 6
        shards_np = [synth_mixed_batch(
            PARITY_N, seed=700 + s, uniform_klen=fast, seq32=fast,
            key_words=kw_n, valid_frac=0.9,
            hot_rows=70000 if s == 5 else 0) for s in range(BENCH_SHARDS)]
        args, flat = stacked_lanes(shards_np)
        flags = dict(uniform_klen=fast, seq32=fast, key_words=kw_n)
        want = plain_batched(args, flags)
        torch.cuda.synchronize()
        _build.reset_launches()
        got = merge_resolve_batched(*args, sort_backend="fused", **flags)
        torch.cuda.synchronize()
        calls = dict(_build.LAUNCHES)
        k2_launch = check_calls("fused_resolve",
                                k2_calls(flat, flags, PARITY_N),
                                f"K2 batched {label}")
        got_b = merge_resolve_batched(*args, sort_backend="bitonic", **flags)
        for backend, out in (("fused", got), ("bitonic", got_b)):
            errs["fused_resolve"] = max(errs["fused_resolve"], compare_outputs(
                out, want, f"batched {backend} {label}"))
        flagged = [i for i, f in enumerate(want["needs_cpu_fallback"].tolist())
                   if f]
        if flagged != [5] or calls["fused_resolve"] != 1:
            raise AssertionError(f"K2 batched {label}: flagged {flagged}, "
                                 f"launches {calls}")
        batched[label] = (args, flat, flags, got)
        emit({"phase": "parity", "kernel": "fused_resolve",
              "case": f"batched {label}", "shards": BENCH_SHARDS,
              "capacity": PARITY_N, "k2_calls": calls["fused_resolve"],
              "launches_per_call": k2_launch, "flagged_shards": flagged,
              "counts": want["count"].tolist(),
              "compared_with": "merge_resolve_plain shard by shard, both "
                               "sort backends", "max_abs_err": 0})
    args, flat, flags, got = batched["flags_off"]
    seg_ops, seg_keys = sort_operands(flat, False, False, 6)
    got_k1 = bitonic_sort_lanes(seg_ops, seg_keys, PARITY_N)
    k1_launch = check_calls("bitonic_sort",
                            k1_calls(seg_ops, seg_keys, PARITY_N),
                            "K1 segmented")
    err = 0
    for s in range(BENCH_SHARDS):
        rows = slice(s * PARITY_N, (s + 1) * PARITY_N)
        want_s = sort_lanes_plain([x[rows] for x in seg_ops], seg_keys)
        err = max(err, max(max_abs_err(g[rows], x)
                           for g, x in zip(got_k1, want_s)))
    errs["bitonic_sort"] = max(errs["bitonic_sort"], err)
    if err:
        raise AssertionError(f"K1 segmented: differs from plain ({err})")
    emit({"phase": "parity", "kernel": "bitonic_sort", "case": "segmented",
          "shards": BENCH_SHARDS, "segment": PARITY_N,
          "lanes": len(seg_ops), "num_keys": seg_keys,
          "launches_per_call": k1_launch,
          "compared_with": "sort_lanes_plain shard by shard",
          "max_abs_err": err})
    k3_parity("batched 8 x 2^17", got["key_words_le"], got["key_len"],
              got["count"], k3_words)
    # shard 0 empty, shard 7 full to its capacity
    edge_count = got["count"].clone()
    edge_count[0], edge_count[BENCH_SHARDS - 1] = 0, PARITY_N
    k3_parity("batched 8 x 2^17, counts 0 and C", got["key_words_le"],
              got["key_len"], edge_count, k3_words)

    # ---- 3. the main path, counted -----------------------------------
    entry_model, entry_args = entry(dev)
    # the bench: its 8 shards as ONE batched forward (jax.vmap(forward) in
    # the JAX package, bench.py:316), and the 8 single-shard forwards it
    # replaces, timed beside it
    bench_batch_model, bench_batch_args = bench_model(dev,
                                                      shards=BENCH_SHARDS)
    shards = [bench_model(dev, seed=s) for s in range(BENCH_SHARDS)]
    bench_cfg = shards[0][0]
    big_model = CompactionModel(capacity=BIG_N, emit_planar=True,
                                row_klen=24, row_vlen=8)
    runs = [("entry", entry_model, entry_args),
            ("bench_8_shards", bench_batch_model, bench_batch_args),
            ("job_2p22", big_model, big_args)]
    results = {}
    per_backend = {}
    for backend in ("fused", "bitonic"):
        torch.cuda.synchronize()
        _build.reset_launches()
        for label, model, args in runs:
            model.sort_backend = backend
            results[(backend, label)] = model(*args)
        torch.cuda.synchronize()
        per_backend[backend] = dict(_build.LAUNCHES)
    launches = {k: sum(c[k] for c in per_backend.values())
                for k in sources}
    emit({"phase": "main_path", "forwards_per_backend": len(runs),
          "launches": per_backend,
          "launches_per_forward": {
              b: {k: c[k] / len(runs) for k in c}
              for b, c in per_backend.items()}})
    for kname, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {kname} was not launched on the "
                                 f"main path")
    counts = {}
    for label, model, args in runs:
        want = model.forward_plain(*args)
        for backend in ("fused", "bitonic"):
            compare_outputs(results[(backend, label)], want,
                            f"{label} [{backend}]")
        counts[label] = want["count"].tolist()
        if bool(want["needs_cpu_fallback"].any()):
            raise AssertionError(f"{label}: unexpected overflow flag")
        lead = tuple(args[1].shape)  # (capacity,) or (shards, capacity)
        for k, v in want.items():
            if k in ("count", "needs_cpu_fallback"):
                if tuple(v.shape) != lead[:-1]:
                    raise AssertionError(f"{label}: {k} has shape "
                                         f"{v.shape}")
            elif tuple(v.shape[:len(lead)]) != lead and k not in (
                    "bloom", "planar_words", "planar_chk"):
                raise AssertionError(f"{label}: {k} has shape {v.shape}")
    for s, (model, args) in enumerate(shards):
        # the batched forward equals each shard's own forward
        compare_outputs({k: v[s] for k, v in results[
            ("fused", "bench_8_shards")].items()}, model.forward_plain(*args),
            f"bench_8_shards shard {s} vs its single-shard forward")
    emit({"phase": "main_path_parity", "counts": counts,
          "compared_with": "forward_plain on the card (shard by shard for "
                           "the batched forward, and each shard's own "
                           "single-shard forward)", "max_abs_err": 0})

    # ---- 4. known answers on a small batch ---------------------------
    pk = struct.Struct("<q").pack
    entries = [
        (b"ctr", 1, OpType.PUT, pk(100)), (b"ctr", 2, OpType.MERGE, pk(5)),
        (b"ctr", 3, OpType.MERGE, pk(7)), (b"del", 1, OpType.PUT, pk(1)),
        (b"del", 2, OpType.DELETE, b""), (b"del", 3, OpType.MERGE, pk(9)),
        (b"gone", 4, OpType.PUT, pk(3)), (b"gone", 5, OpType.DELETE, b""),
        (b"neg", 6, OpType.PUT, pk(-5)), (b"neg", 7, OpType.MERGE, pk(-10)),
        (b"pure", 8, OpType.MERGE, pk(3)), (b"pure", 9, OpType.MERGE, pk(4)),
    ]
    expect = [(b"ctr", OpType.PUT, pk(112)), (b"del", OpType.PUT, pk(9)),
              (b"neg", OpType.PUT, pk(-15)), (b"pure", OpType.PUT, pk(7))]
    batch = pack_entries(entries, capacity=256)
    small = CompactionModel(capacity=256)
    for backend in ("fused", "bitonic"):
        small.sort_backend = backend
        out = lanes_to_numpy(small(*lanes_of(
            {k: getattr(batch, k) for k in FORWARD_ARGS})))
        got = [(k, vt, v) for k, _s, vt, v in unpack_entries(
            out["key_words_be"], out["key_len"], out["seq_hi"],
            out["seq_lo"], out["vtype"], out["val_words"], out["val_len"],
            out["count"])]
        if got != expect:
            raise AssertionError(f"known answers [{backend}]: {got}")
    emit({"phase": "known_answers", "entries": len(entries), "ok": True})

    # ---- 4b. the engine seam, each path counted on its own ------------
    seam = engine_seam_known_answers(dev, entries, expect)
    emit({"phase": "engine_seam_known_answers", "card": card, **seam})
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work_dir = tempfile.mkdtemp(prefix="seam_", dir=str(_build.BUILD_ROOT))
    try:
        # the in-RAM route's phases: the streaming merge stays off there
        _stream_mode("never")
        job, job_launches, sub, sub_launches = engine_seam_job(
            dev, work_dir, card)
        emit({"phase": "engine_seam_job", **job})
        emit({"phase": "engine_seam_subcompact", **sub})
        chunked, chunked_launches = engine_seam_chunked(dev, card)
        emit({"phase": "engine_seam_chunked", **chunked})
        wide, wide_launches = engine_seam_wide(dev, work_dir, card)
        emit({"phase": "engine_seam_wide", **wide})
        # the streaming merge in auto mode, as a deployment runs it
        _stream_mode("auto")
        budget, budget_launches = engine_seam_stream_budget(dev, work_dir,
                                                            card)
        emit({"phase": "engine_seam_stream_budget", **budget})
        stream, stream_launches = engine_seam_stream(dev, work_dir, card)
        emit({"phase": "engine_seam_stream", **stream})
        _stream_mode(None)
        # ---- 4c. the batched service, each path counted on its own ----
        svc_batch, svc_batch_launches = service_batch(dev, card)
        emit({"phase": "service_batch", **svc_batch})
        prepared = stub_db_inputs(work_dir)
        svc_dbs, svc_dbs_launches = service_dbs(dev, prepared, card)
        emit({"phase": "service_dbs", **svc_dbs})
        # ---- 4d. the post-ingest BatchCompactor over the same DBs ------
        compactor, compactor_launches = batch_compactor(dev, prepared, card)
        emit({"phase": "batch_compactor", **compactor})
        # ---- 4f. the port's storage engine, in auto stream mode --------
        traffic = engine_traffic()
        run3 = os.path.join(work_dir, "engine_host_run3")
        eng, eng_launches = engine_db(dev, traffic, work_dir, card, run3)
        emit({"phase": "engine_db", **eng})
        eng_bg, eng_bg_launches = engine_db_background(
            dev, engine_traffic(run_entries=ENGINE_BG_RUN_ENTRIES), work_dir,
            card)
        emit({"phase": "engine_db_background", **eng_bg})
        # ---- 4g. the remote compaction tier, the card as its worker ----
        remote, remote_launches = remote_worker(dev, traffic, run3,
                                                work_dir, card)
        emit({"phase": "remote_worker", **remote})
        del traffic
        eng_in, eng_in_launches = engine_db_ingest(dev, prepared, work_dir,
                                                   card)
        emit({"phase": "engine_db_ingest", **eng_in})
        remote_cli, remote_cli_launches = remote_worker_cli(
            dev, prepared, work_dir, card)
        emit({"phase": "remote_worker_cli", **remote_cli})
        # ---- 4h. the replicated shard and its admin plane --------------
        repl, repl_launches = replicated_counter(
            dev, engine_traffic(run_entries=REPL_RUN_ENTRIES), work_dir, card)
        emit({"phase": "replicated_counter", "elapsed_s":
              time.time() - _STARTED, **repl})
        # ---- 4i. the counter service as the quick start starts it ------
        svc, svc_launches = counter_service(work_dir, card)
        emit({"phase": "counter_service", "elapsed_s":
              time.time() - _STARTED, **svc})
        perf, perf_launches = performance(work_dir, card)
        emit({"phase": "performance", "elapsed_s": time.time() - _STARTED,
              **perf})
        # ---- 4j. the CDC ingestion stack, then its networked broker ----
        cdc, cdc_launches, cdc_net, cdc_net_launches = cdc_ingest(
            dev, work_dir, card)
        emit({"phase": "cdc_ingest", "elapsed_s": time.time() - _STARTED,
              **cdc})
        emit({"phase": "cdc_network", "elapsed_s": time.time() - _STARTED,
              **cdc_net})
        # ---- 4k. the cluster control plane over card nodes -------------
        clus, clus_launches = cluster_failover(dev, work_dir, card)
        emit({"phase": "cluster_failover", "elapsed_s":
              time.time() - _STARTED, **clus})
        emit({"phase": "cluster_failover_summary", "card": card,
              "storm_ops_per_s_excl_crash_window":
                  clus["storm"]["ops_per_s_excl_crash"],
              "storm_ops_per_s_whole_window":
                  clus["storm"]["ops_per_s_whole"],
              "ack_p50_p99_ms": [clus["storm"]["ack_p50_ms"],
                                 clus["storm"]["ack_p99_ms"]],
              "read_p50_p99_ms": [clus["storm"]["read_p50_ms"],
                                  clus["storm"]["read_p99_ms"]],
              "crash_to_all_led_s": clus["crash"]["relead_s"],
              "controller_passes": clus["crash"]["controller_passes"],
              "d_catch_up_s": clus["d_catch_up_s"],
              "compact_db_s": clus["compact_db_s"],
              "k2": clus_launches["fused_resolve"],
              "k3": clus_launches["bloom_build"],
              "participant_rejoins": clus["participant_rejoins"],
              "heartbeats": clus["heartbeats"],
              "seconds": clus["seconds"]})
        # ---- 4l. shard movement: an operator's move and split, then the
        # rebalancer's move, over card nodes ------------------------------
        reshape, reshape_launches = cluster_reshape(dev, work_dir, card)
        emit({"phase": "cluster_reshape", **reshape})
        emit({"phase": "cluster_reshape_summary", "card": card,
              "shards_picked": reshape["shards_picked"],
              "steps": {k: {f: reshape[k][f] for f in (
                  "ops", "seconds", "ops_per_s", "refused", "ack_p50_ms",
                  "ack_p99_ms")} for k in ("base", "hot", "policy")},
              "operator_move": {k: reshape["operator_move"][k] for k in (
                  "seconds", "phase_s", "bytes_ingested", "write_pause")},
              "operator_split": {k: reshape["operator_split"][k] for k in (
                  "seconds", "to_active_s", "phase_s", "cutover_pause",
                  "split_key", "entries_before_trim", "entries_after_trim",
                  "retain_trims")},
              "trims": reshape["operator_split"]["trims"],
              "policy_move": {k: reshape["policy_move"][k] for k in (
                  "scrapes_to_decision", "decision_s_from_start",
                  "decision_to_moved_s")},
              "out_of_range_on_rebuilt": reshape["out_of_range_on_rebuilt"],
              "k2": reshape_launches["fused_resolve"],
              "k3": reshape_launches["bloom_build"],
              "seconds": reshape["seconds"]})
        # ---- 4m. the chaos harness's data-plane and CDC decks ----------
        chaos, chaos_launches = chaos_dataplane(dev, work_dir, card)
        emit({"phase": "chaos_dataplane", **chaos})
        chaos_c, chaos_cdc_launches = chaos_cdc(dev, work_dir, card)
        emit({"phase": "chaos_cdc", **chaos_c})
        emit({"phase": "chaos_summary", "card": card, "decks": {
            f"{p}.{k}": {f: d.get(f) for f in (
                "schedules", "writes", "acked", "produced", "seconds",
                "violations", "failpoint_trips", "remote_outcomes",
                "bg_failures_retried", "card_raises_retried",
                "card_raises_by_site", "k2", "k3")}
            for p, r in (("chaos_dataplane", chaos), ("chaos_cdc", chaos_c))
            for k, d in r["decks"].items()},
            "k2": chaos_launches["fused_resolve"],
            "k3": chaos_launches["bloom_build"],
            "cdc_k2": chaos_cdc_launches["fused_resolve"],
            "cdc_k3": chaos_cdc_launches["bloom_build"],
            "seconds": [chaos["seconds"], chaos_c["seconds"]]})
        # ---- 4n. the chaos harness's reshard and rebalance decks -------
        reshard_r, chaos_reshard_launches = chaos_reshard(dev, work_dir,
                                                          card)
        emit({"phase": "chaos_reshard", "elapsed_s":
              time.time() - _STARTED, **reshard_r})
        rebalance_r, chaos_rebalance_launches = chaos_rebalance(
            dev, work_dir, card)
        emit({"phase": "chaos_rebalance", "elapsed_s":
              time.time() - _STARTED, **rebalance_r})
        emit({"phase": "chaos_reshape_summary", "card": card, "decks": {
            f"{p}.{k}": {f: d.get(f) for f in (
                "schedules", "deck", "acked", "seconds", "violations",
                "failpoint_trips", "move_outcomes", "passes_used",
                "dispatched", "resumes", "replicas_compacted", "k2_compact",
                "host_path", "retain_strays", "out_of_range_on_rebuilt",
                "bg_failures_retried", "k2", "k3")}
            for p, r in (("chaos_reshard", reshard_r),
                         ("chaos_rebalance", rebalance_r))
            for k, d in r["decks"].items()},
            "k2": [chaos_reshard_launches["fused_resolve"],
                   chaos_rebalance_launches["fused_resolve"]],
            "k3": [chaos_reshard_launches["bloom_build"],
                   chaos_rebalance_launches["bloom_build"]],
            "seconds": [reshard_r["seconds"], rebalance_r["seconds"]]})
        cost = instrumentation_cost()
        per_stream = stream["backends"]["fused"]["counters"]
        emit({"phase": "instrumented_seconds", "card": card,
              "engine_seam_stream_fused_s":
                  stream["backends"]["fused"]["seconds"],
              "service_dbs_s": svc_dbs["seconds"],
              "batch_compactor_s": compactor["seconds"], **cost,
              # an fp.hit and a Stats.incr per chunk and per refill
              "instrumentation_us_per_stream": (
                  per_stream["stream_chunks"] + per_stream["stream_refills"])
              * (cost["fp_hit_us"] + cost["stats_incr_us"])
              + cost["child_span_us"]})
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    _sort_flag(None)
    launches_by_path = {
        "main_path": launches,
        "engine_seam_job": {k: sum(c[k] for c in job_launches.values())
                            for k in sources},
        "engine_seam_subcompact": sub_launches,
        "engine_seam_chunked": chunked_launches,
        "engine_seam_wide": wide_launches,
        "engine_seam_stream": {k: sum(c[k] for c in stream_launches.values())
                               for k in sources},
        "engine_seam_stream_budget": budget_launches,
        "service_batch": svc_batch_launches,
        "service_dbs": svc_dbs_launches,
        "batch_compactor": compactor_launches,
        "engine_db": eng_launches,
        "engine_db_background": eng_bg_launches,
        "engine_db_ingest": eng_in_launches,
        "remote_worker": remote_launches,
        "remote_worker_cli": remote_cli_launches,
        "replicated_counter": repl_launches,
        "counter_service": svc_launches,
        "performance": perf_launches,
        "cdc_ingest": cdc_launches,
        "cdc_network": cdc_net_launches,
        "cluster_failover": clus_launches,
        "cluster_reshape": reshape_launches,
        "chaos_dataplane": chaos_launches,
        "chaos_cdc": chaos_cdc_launches,
        "chaos_reshard": chaos_reshard_launches,
        "chaos_rebalance": chaos_rebalance_launches,
    }
    launches_by_path = {p: {k: c[k] for k in sources}
                        for p, c in launches_by_path.items()}

    # ---- 5. timings ----------------------------------------------------
    def mb(*ts) -> float:
        return sum(t.numel() * t.element_size() for t in ts)

    def bound(nbytes: float) -> float:
        return nbytes / HBM_BYTES_PER_S * 1e3

    def k1_row(ops, num_keys, reps, shape, segment=None) -> dict:
        """K1 and its plain version on the same lanes (each segment of
        ``segment`` rows on its own); the bound moves each lane in once
        and out once."""
        row = {"shape": shape, "n": ops[0].shape[0], "lanes": len(ops),
               "num_keys": num_keys, "segment": segment, "reps": reps,
               "tile": plan_sort(ops[0].shape[0], num_keys,
                                 len(ops) - num_keys, segment).tile}
        row["ms"] = time_ms(
            lambda: bitonic_sort_lanes(ops, num_keys, segment), reps)
        row["launches_per_call"] = check_calls(
            "bitonic_sort", k1_calls(ops, num_keys, segment), "K1 timing")
        row["device_ms"] = device_ms(
            lambda: bitonic_sort_lanes(ops, num_keys, segment))
        row["plain_ms"] = time_ms(
            lambda: sort_lanes_plain(ops, num_keys, segment), reps)
        row["bound_ms"] = bound(2 * mb(*ops))
        return row

    def k2_row(args, flags, reps, shape, shards=None) -> dict:
        """K2 and its plain version (shard by shard over ``shards``
        shards of the flat lanes); the bound reads the input lanes the
        flags use and writes every output once."""
        kw, kl, shi, slo, vt, vw, vl, valid = args
        n = vw.shape[0]
        segment = n // shards if shards else None
        key_words = flags.get("key_words", 6)
        out = fused_merge_resolve(*args, segment=segment, **flags)
        used = [kw[:, :key_words], kl, slo, vt, vw, vl, valid]
        if not flags.get("seq32", False):
            used.append(shi)
        row = {"shape": shape, "n": n, "shards": shards or 1,
               "flags": dict(flags), "reps": reps,
               "tile": plan_fused(n, vw.shape[1], key_words,
                                  flags.get("uniform_klen", False),
                                  flags.get("seq32", False),
                                  segment).sort.tile}
        row["ms"] = time_ms(
            lambda: fused_merge_resolve(*args, segment=segment, **flags),
            reps)
        row["launches_per_call"] = check_calls(
            "fused_resolve", k2_calls(args, flags, segment), "K2 timing")
        row["device_ms"] = device_ms(
            lambda: fused_merge_resolve(*args, segment=segment, **flags))
        if shards:
            shaped = tuple(x.view((shards, segment) + tuple(x.shape[1:]))
                           for x in args)
            row["plain_ms"] = time_ms(
                lambda: plain_batched(shaped, flags), reps)
        else:
            row["plain_ms"] = time_ms(
                lambda: merge_resolve_plain(*args, **flags), reps)
        row["bound_ms"] = bound(
            mb(*used) + mb(*[v for v in out.values() if v.dim()]))
        return row

    def k3_bytes(key_len, live, num_words) -> int:
        """What K3 must move: the counts or the valid flags, and the key
        words and length of each live row (the kernel reads no other row),
        read once; the bitmaps written once."""
        live_rows = int((live if key_len.dim() == 1 else live.clamp(
            max=key_len.shape[1])).sum())
        return (mb(live) + live_rows * 4 * (KEY_WORDS + 1)
                + 4 * plan_shards(key_len) * num_words)

    def plan_shards(key_len) -> int:
        return 1 if key_len.dim() == 1 else key_len.shape[0]

    def k3_row(kw_le, key_len, live, num_words, reps, shape) -> dict:
        """K3 by its plan beside its plain version."""
        plan = k3_plan(key_len, num_words)

        def kernel():
            return k3_call(kw_le, key_len, live, num_words)

        return {"shape": shape, "route": plan.route, "blocks": plan.blocks,
                "threads": plan.threads, "shards": plan_shards(key_len),
                "rows": key_len.shape[-1], "num_words": num_words,
                "reps": reps, "ms": time_ms(kernel, reps),
                "launches_per_call": check_calls(
                    "bloom_build", plan.launches, f"K3 {shape}"),
                "device_ms": device_ms(kernel),
                "plain_ms": time_ms(lambda: k3_plain(kw_le, key_len, live,
                                                     num_words), reps),
                "bound_ms": bound(k3_bytes(key_len, live, num_words))}

    # the plan's constants the K3 sweep varies; each variant names the
    # route, the threads of a block and (global) the blocks an SM
    k3_knobs = ("ROWWISE_MAX_SHARDS", "ROWWISE_THREADS", "GLOBAL_THREADS",
                "GLOBAL_BLOCKS_PER_SM")
    k3_variants = (
        [("rowwise", t, None) for t in (128, 256, 512)]
        + [("global", t, b) for t in (256, 512) for b in (1, 2, 4)]
        + [("global", 256, 8)])

    def k3_sweep(cases) -> list:
        """K3 at each of ``cases`` (kw_le, key_len, live, num_words, reps,
        shape) by every route and grid of ``k3_variants``: each variant's
        bitmaps against the plain version, then its times. The plan's
        constants are restored afterwards."""
        saved = {k: getattr(bloom_kernel, k) for k in k3_knobs}
        plans = [k3_plan(case[1], case[3]) for case in cases]
        out = []
        try:
            for (kw_le, key_len, live, num_words, reps, shape), planned in (
                    zip(cases, plans)):
                want = k3_plain(kw_le, key_len, live, num_words)
                for route, threads, per_sm in k3_variants:
                    bloom_kernel.ROWWISE_MAX_SHARDS = (
                        1 << 30 if route == "rowwise" else 0)
                    bloom_kernel.ROWWISE_THREADS = threads
                    bloom_kernel.GLOBAL_THREADS = threads
                    bloom_kernel.GLOBAL_BLOCKS_PER_SM = per_sm or 1
                    plan = k3_plan(key_len, num_words)
                    what = f"K3 sweep {shape} [{route} t{threads} b{per_sm}]"
                    calls = k3_check(what, kw_le, key_len, live, num_words,
                                     want)

                    def kernel():
                        return k3_call(kw_le, key_len, live, num_words)

                    out.append({
                        "shape": shape, "route": route, "threads": threads,
                        "blocks_per_sm": per_sm, "blocks": plan.blocks,
                        "planned": (plan.route, plan.blocks, plan.threads)
                        == (planned.route, planned.blocks,
                            planned.threads),
                        "launches_per_call": calls,
                        "ms": time_ms(kernel, reps),
                        "device_ms": device_ms(kernel)})
        finally:
            for k, v in saved.items():
                setattr(bloom_kernel, k, v)
        return out

    bflags = dict(uniform_klen=True, seq32=True, key_words=4)
    # the main path's shape: the bench's 8 shards of 2^17 as one call
    bb_flat = tuple(x.reshape((-1,) + tuple(x.shape[2:]))
                    for x in bench_batch_args)
    k1_bb = sort_operands(bb_flat, True, True, 4)
    # the service's shape: 8 shards of 2^20 (MAX_BATCHED_DB_ENTRIES)
    svc_args, svc_flat = stacked_lanes([
        synth_counter_batch(SERVICE_ENTRIES, seed=300 + s)
        for s in range(BENCH_SHARDS)])
    k1_svc = sort_operands(svc_flat, True, True, 4)
    k1_wide = sort_operands(f6_args[16], True, True, 4)
    k1_rows = [
        k1_row(*k1_bb, SHORT_REPS, "bench 8 x 2^17, segmented",
               bench_cfg.capacity),
        k1_row(*k1_bench, SHORT_REPS, "2^17, one shard"),
        k1_row(*k1_big, REPS, "2^22, 14 lanes"),
        k1_row(*k1_svc, REPS, "batched 8 x 2^20, segmented",
               SERVICE_ENTRIES),
        k1_row(*k1_wide, SHORT_REPS, "2^17, W = 16 (24 lanes)")]
    k2_rows = [
        k2_row(bb_flat, bflags, SHORT_REPS, "bench 8 x 2^17, batched",
               BENCH_SHARDS),
        k2_row(bench_args, bflags, SHORT_REPS, "2^17, one shard"),
        k2_row(big_args, {}, REPS, "2^22, flags off"),
        k2_row(svc_flat, bflags, REPS, "batched 8 x 2^20", BENCH_SHARDS),
        k2_row(f6_args[16], bflags, SHORT_REPS, "2^17, W = 16")]
    emit({"phase": "k1_k2_timings", "card": card, "k1": k1_rows,
          "k2": k2_rows})

    # the sort tile the plan picks (the largest) against the smaller ones
    # it could pick, which give more blocks but more merge passes: K1 and
    # K2 at 2^17 (host time included), K1 at 2^22 (device-bound)
    sweep = []
    planned_tile = bitonic_sort.MAX_TILE
    ops, num_keys = k1_bench
    big_ops, big_keys = k1_big
    try:
        for tile in (256, 512, 1024, 2048):
            bitonic_sort.MAX_TILE = tile
            sweep.append({
                "tile": tile,
                "k1_ms": time_ms(lambda: bitonic_sort_lanes(ops, num_keys),
                                 SHORT_REPS),
                "k2_ms": time_ms(lambda: fused_merge_resolve(
                    *bench_args, **bflags), SHORT_REPS),
                "k1_ms_2p22": time_ms(
                    lambda: bitonic_sort_lanes(big_ops, big_keys))})
    finally:
        bitonic_sort.MAX_TILE = planned_tile
    emit({"phase": "tile_sweep", "card": card,
          "planned_tile": k1_rows[1]["tile"], "rows": sweep})

    bench_batch_out = results[("fused", "bench_8_shards")]
    bench_out = {k: v[0] for k, v in bench_batch_out.items()}
    b_valid = torch.arange(bench_cfg.capacity, device=dev) < bench_out[
        "count"]
    b_words = bench_cfg.num_bloom_words
    svc_out = merge_resolve_batched(*svc_args, **bflags)
    svc_words = num_words_for(SERVICE_ENTRIES, 10)
    k3_parity("batched 8 x 2^20", svc_out["key_words_le"],
              svc_out["key_len"], svc_out["count"], svc_words)
    k3_cases = [
        (bench_batch_out["key_words_le"], bench_batch_out["key_len"],
         bench_batch_out["count"], b_words, SHORT_REPS,
         "bench 8 x 2^17, batched"),
        (bench_out["key_words_le"], bench_out["key_len"], b_valid, b_words,
         SHORT_REPS, "2^17, one shard"),
        (svc_out["key_words_le"], svc_out["key_len"], svc_out["count"],
         svc_words, REPS, "batched 8 x 2^20"),
        (*k3_file, REPS, "one file of 2^21 rows")]
    k3_rows = [k3_row(*case) for case in k3_cases]
    emit({"phase": "k3_timings", "card": card, "k3": k3_rows})
    emit({"phase": "k3_sweep", "card": card, "rows": k3_sweep(k3_cases)})

    forwards = {}
    for (label, model, args), reps in zip(runs, (SHORT_REPS, SHORT_REPS,
                                                 REPS)):
        row = {"reps": reps}
        for backend in ("fused", "bitonic"):
            model.sort_backend = backend
            row[f"{backend}_ms"] = time_ms(lambda: model(*args), reps)
        row["plain_ms"] = time_ms(lambda: model.forward_plain(*args), reps)
        forwards[label] = row
    # the 8 single-shard forwards the batched forward replaces, one timed
    # region over all 8
    row = {"reps": SHORT_REPS}
    for backend in ("fused", "bitonic"):
        for model, _args in shards:
            model.sort_backend = backend
        row[f"{backend}_ms"] = time_ms(
            lambda: [model(*args) for model, args in shards], SHORT_REPS)
    forwards["bench_8_single_shard_forwards"] = row
    emit({"phase": "timings", "card": card, "forward_ms": forwards})

    bench_batch_model.sort_backend = "fused"
    profile = profile_shards([(bench_batch_model, bench_batch_args)],
                             forwards["bench_8_shards"]["fused_ms"])
    emit({"phase": "profile", "card": card,
          "what": "one batched forward over the bench's 8 shards",
          **profile})
    profile = profile_shards(
        shards, forwards["bench_8_single_shard_forwards"]["fused_ms"]
        / len(shards))
    emit({"phase": "profile_single_shards", "card": card,
          "what": "8 single-shard forwards", **profile})

    def kernel(kname, rows, top=0):
        row = rows[top]
        return {"name": kname, "route": "cuda",
                "source": sources[kname][0], "replaces": sources[kname][1],
                "max_abs_err": errs[kname], "ms": row["ms"],
                "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": "bytes",
                "library_ms": None,
                "launches_per_call": row.get("launches_per_call"),
                "shape": row["shape"], "shapes": rows}

    # each kernel's headline row is the main path's shape (the bench's 8
    # shards in one call); no single PyTorch call computes any of them
    kernels = [kernel("bitonic_sort", k1_rows),
               kernel("fused_resolve", k2_rows),
               kernel("bloom_build", k3_rows)]
    for row in kernels:
        by_path = {p: c[row["name"]] for p, c in launches_by_path.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
