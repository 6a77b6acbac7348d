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
   over 12 stub DBs of 4 planar runs of 2^18 entries (``service_dbs``: a
   group of 8 and a padded group of 4 on the stream path, every file
   byte-identical to the numpy-resolved sink's);
4d. drives the post-ingest caller, ``admin.BatchCompactor``, over the same
   12 stub DBs submitted from 12 threads at once (``batch_compactor``:
   the leader's batches, one K2 call a launch group and one K3 call a
   group and a file, every file byte-identical to the numpy-resolved
   sink's, no DB compacted by the per-DB fallback, no error logged by the
   port's admin logger);
4f. drives the port's storage engine, ``storage.DB``, in the
   environment's stream mode: the counter traffic (4 x 2^20 ops in
   WriteBatches of 1024) through ``DB.write`` into two DBs that compact on
   the card (fused and bitonic) and one on the host
   (``NativeCompactionBackend``), each run's last batch flushing 2^20
   entries and the fourth flush compacting L0 inline, then
   ``compact_range`` (``engine_db``: files byte for byte against the
   host DB's, one K2 (K1) call a compaction and one K3 call a file, every
   key of the fused DB read back through ``multi_get`` and a full scan
   against a numpy oracle, the native library loaded, host-clock seconds
   of each write run, flush and compaction); the same traffic from 4
   writer threads into a DB with background flush and compaction and its
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

Every phase raises on failure and the script then exits non-zero. Without
CUDA, or without the package beside it, it exits non-zero and prints no
result. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
# stub DB of compact_dbs_batched (four fill one such shard)
SERVICE_ENTRIES = 1 << 20
DBS_RUN_ENTRIES = 1 << 18
DBS_SHARDS = 12
WIDE_RUN_ENTRIES = 1 << 18
# K3 on one output file's bloom: the seam's per-file shape
K3_FILE_ROWS = 1 << 21


def emit(obj) -> None:
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
    """12 stub DBs' inputs, each 4 planar SST runs of 2^18 counter entries
    (one shard at MAX_BATCHED_DB_ENTRIES), and the files the numpy-resolved
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
# engine_db: 4 runs of this many counter ops, written through DB.write in
# WriteBatches of ENGINE_BATCH ops, one memtable flush a run; four flushes
# fill one launch (MAX_TPU_ENTRIES)
ENGINE_RUN_ENTRIES = 1 << 20
ENGINE_BATCH = 1024
ENGINE_WRITERS = 4
# multi_get read-back in slices of this many keys
ENGINE_READ_SLICE = 1 << 16


def engine_traffic(seed: int = 700) -> dict:
    """The counter service's traffic of ``counter_runs`` as DB operations:
    per run, 16-byte keys ("counter:" + a big-endian id), the op type
    (3 MERGE, 1 PUT, 2 DELETE) and 8-byte little-endian values, each run
    in a seeded random order; the memtable_bytes at which the engine
    flushes after each run's last batch; and the numpy oracle of every
    touched key's final value."""
    import numpy as np

    key_space = 2 * ENGINE_RUN_ENTRIES
    runs = counter_runs(4, ENGINE_RUN_ENTRIES, key_space, seed)
    rng = np.random.default_rng(seed + 1)
    ops = []
    exists = np.zeros(key_space, dtype=bool)
    touched = np.zeros(key_space, dtype=bool)
    value = np.zeros(key_space, dtype=np.uint64)
    for lanes in runs:
        order = rng.permutation(ENGINE_RUN_ENTRIES)
        kw = lanes["key_words_be"][order]
        ids = ((kw[:, 2].astype(np.uint64) << np.uint64(32))
               | kw[:, 3].astype(np.uint64))
        vtype = lanes["vtype"][order]
        vals = ((lanes["val_words"][order, 1].astype(np.uint64)
                 << np.uint64(32))
                | lanes["val_words"][order, 0].astype(np.uint64))
        key_bytes = np.ascontiguousarray(kw[:, :4].astype(">u4")).tobytes()
        ops.append((ids, vtype, vals, key_bytes))
        # the oracle: keys are distinct within a run
        put, dele, mrg = vtype == 1, vtype == 2, vtype == 3
        value[ids[put]] = vals[put]
        with np.errstate(over="ignore"):
            value[ids[mrg]] = np.where(exists[ids[mrg]], value[ids[mrg]],
                                       np.uint64(0)) + vals[mrg]
        exists[ids[put | mrg]] = True
        exists[ids[dele]] = False
        touched[ids] = True
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
            "touched": np.flatnonzero(touched).astype(np.uint64),
            "exists": exists, "value": value}


def _card_backend(dev):
    """A DB's compaction backend on ``dev``: None (the port's default, the
    card) for a CUDA device; named where the script is rehearsed on the
    CPU."""
    from rocksplicator_tpu_torch.gpu import GpuCompactionBackend

    return None if str(dev).startswith("cuda") else GpuCompactionBackend(
        device=dev)


def _key_of(i) -> bytes:
    return b"counter:" + int(i).to_bytes(8, "big")


def _write_ops(db, ids, vtype, vals, key_bytes, rows, latencies=None):
    """Write ``rows`` of one run through ``db.write`` in WriteBatches of
    ENGINE_BATCH ops; ``latencies`` collects each write()'s seconds."""
    from rocksplicator_tpu_torch.storage import WriteBatch

    vbytes = vals.astype("<u8").tobytes()
    vt = vtype.tolist()
    for s in range(0, len(rows), ENGINE_BATCH):
        batch = WriteBatch()
        for i in rows[s:s + ENGINE_BATCH]:
            key = key_bytes[16 * i:16 * i + 16]
            t = vt[i]
            if t == 3:
                batch.merge(key, vbytes[8 * i:8 * i + 8])
            elif t == 1:
                batch.put(key, vbytes[8 * i:8 * i + 8])
            else:
                batch.delete(key)
        t0 = time.perf_counter()
        db.write(batch)
        if latencies is not None:
            latencies.append(time.perf_counter() - t0)


def check_read_back(db, traffic: dict, what: str, ids=None) -> dict:
    """Every touched key (or those of ``ids``) read back through multi_get
    equals the oracle, and one full iterator scan yields exactly the live
    keys and values, in order. Returns host-clock seconds."""
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


def engine_db(dev, traffic: dict, work_dir: str, card: str) -> tuple:
    """The port's DB at MAX_TPU_ENTRIES: the counter traffic written
    through DB.write into two DBs that compact on the card (under the
    fused and the bitonic sort backends: K2, or K1 and the torch
    resolve) and one that compacts on the host (the port's
    NativeCompactionBackend), DBOptions' defaults otherwise (32 KiB blocks, zlib, 10 bits a key, 64 MiB files),
    UInt64AddOperator, level0_compaction_trigger 4, inline flushes and
    compactions. Each run's last batch flushes 2^20 entries; the fourth
    flush compacts L0 into L1 (2^22 entries), then compact_range()
    compacts everything into the bottom level. ``max_subcompactions`` is
    1 (the host's slices write a file set each, the card's one), and the
    memory budget 1 GiB (the in-RAM route: one K2 call a compaction).
    Each card DB's files must be byte-identical to the host DB's, K2 (K1)
    run once a compaction and K3 once an output file, and every key of
    the fused card DB read back equal to the oracle."""
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
    paths = {}
    for name, backend in (("fused", GpuCompactionBackend(device=dev)),
                          ("bitonic", GpuCompactionBackend(device=dev)),
                          ("host", NativeCompactionBackend())):
        _sort_flag(SEAM_FLAGS.get(name))
        path = paths[name] = os.path.join(work_dir, f"engine_{name}")
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
            for ids, vtype, vals, key_bytes in traffic["ops"]:
                t0 = time.time()
                _write_ops(db, ids, vtype, vals, key_bytes,
                           range(len(ids)))
                write_s.append(time.time() - t0)
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
            if [e["entries"] for e in flushes] != [ENGINE_RUN_ENTRIES] * 4:
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
    """The same traffic from ENGINE_WRITERS threads on disjoint key ranges
    into one DB with background flush and compaction threads, the
    scheduler on and the default backend (the card). Then flush(), wait
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
        background_compaction=True, compaction_scheduler=True))
    threads_of = []
    count_launch = _build.count_launch

    def counted(name, cuda_launches=None):
        threads_of.append((name, threading.current_thread().name))
        count_launch(name, cuda_launches)

    key_space = 2 * ENGINE_RUN_ENTRIES
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
            "ops": 4 * ENGINE_RUN_ENTRIES, "write_s": write_s,
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


def main() -> int:
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
        eng, eng_launches = engine_db(dev, traffic, work_dir, card)
        emit({"phase": "engine_db", **eng})
        eng_bg, eng_bg_launches = engine_db_background(dev, traffic,
                                                       work_dir, card)
        emit({"phase": "engine_db_background", **eng_bg})
        del traffic
        eng_in, eng_in_launches = engine_db_ingest(dev, prepared, work_dir,
                                                   card)
        emit({"phase": "engine_db_ingest", **eng_in})
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
