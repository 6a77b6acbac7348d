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
   against the plain version shard by shard);
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
   operator (``engine_seam_wide``);
4c. drives the batched service, ``gpu.compaction_service``:
   ``compact_shard_batch`` over 8 shards of 2^20 counter entries
   (``service_batch``: one K2 and one K3 call, each shard equal to
   ``numpy_merge_resolve`` and the host bloom) and ``compact_dbs_batched``
   over 12 stub DBs of 4 planar runs of 2^18 entries (``service_dbs``: a
   group of 8 and a padded group of 4 on the stream path, every file
   byte-identical to the numpy-resolved sink's);
5. times each kernel and each forward (median of CUDA-event timed runs
   after warm-up: 10 at the 2^22 and batched 8 x 2^20 shapes, 50 at the
   host-bound small shapes, whose medians move most from call to call)
   beside its plain version and its memory bound, and each kernel's device
   time per call from torch.profiler, K1 and K2 at 2^17 and 2^22, both
   over the sort tiles the plan could choose, the batched shapes and
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
    if "bloom_build" in name:
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
    for name, flag, subcompactions in variants:
        _sort_flag(flag)
        readers = [SSTReader(p) for p in inputs]
        made = []

        def path_factory():
            made.append(os.path.join(work_dir, f"{name}{len(made)}.tsst"))
            return made[-1]

        backend = GpuCompactionBackend(device=dev)
        try:
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.time()
            outs = backend.merge_runs_to_files(
                readers, UInt64AddOperator(), True, path_factory,
                block_bytes, COMPRESSION_ZLIB, bits_per_key, target,
                max_subcompactions=subcompactions)
            torch.cuda.synchronize()
            seconds = time.time() - t0
            launches[name] = dict(_build.LAUNCHES)
        finally:
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
        for path in made:
            os.remove(path)
        report["backends"][name] = {
            "launches": launches[name], "seconds": seconds,
            "entries_per_s": n_in / seconds,
            "stage_seconds": backend.last_stage_seconds,
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
    _build.reset_launches()
    t0 = time.time()
    results = svc.compact_shard_batch(batches, return_arrays=True)
    seconds = time.time() - t0
    launches = dict(_build.LAUNCHES)
    stages = dict(svc.last_stage_seconds)
    if launches["fused_resolve"] != 1 or launches["bloom_build"] != 1:
        raise AssertionError(f"service batch: launches {launches}")
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
            "numpy_reference_s": time.time() - t0, "max_abs_err": 0}, launches


class _StubDB:
    """The four methods compact_dbs_batched calls on a DB (the JAX
    package's storage/engine.py:1784-1950: plan_full_compaction,
    allocate_sst, install_full_compaction, abort_full_compaction) over the
    port's SST reader, for a shard whose runs are planar files on disk."""

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


def service_dbs(dev, work_dir: str, card: str) -> tuple:
    """compact_dbs_batched over 12 stub DBs, each 4 planar SST runs of 2^18
    counter entries (one shard at MAX_BATCHED_DB_ENTRIES): the stream path
    runs a group of 8 and a group of 4 padded to 8, K2 twice. Every output
    file must equal the numpy-resolved sink's byte for byte."""
    import os
    from types import SimpleNamespace

    import torch

    from rocksplicator_tpu_torch.gpu.compaction_service import (
        GpuCompactionService, compact_dbs_batched)
    from rocksplicator_tpu_torch.gpu.format import planar_stride
    from rocksplicator_tpu_torch.ops import _build
    from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
    from rocksplicator_tpu_torch.storage.sst import COMPRESSION_ZLIB

    block_bytes, target = 32 * 1024, SEAM_TARGET_FILE_BYTES
    options = SimpleNamespace(
        merge_operator=UInt64AddOperator(), target_file_bytes=target,
        block_bytes=block_bytes, compression=COMPRESSION_ZLIB,
        bits_per_key=10)
    t0 = time.time()
    dbs, want, counts = [], {}, {}
    for s in range(DBS_SHARDS):
        root = os.path.join(work_dir, f"db{s}")
        os.makedirs(os.path.join(root, "out"))
        runs = counter_runs(4, DBS_RUN_ENTRIES, 4 * DBS_RUN_ENTRIES,
                            seed=500 + s)
        inputs = _write_runs(runs, root, "run",
                             block_bytes // planar_stride(16, 8))
        want[f"db{s}"], counts[f"db{s}"] = _numpy_files(
            _concat_lanes(runs), True, root, "ref", target, block_bytes)
        dbs.append((f"db{s}", _StubDB(os.path.join(root, "out"), inputs,
                                      options)))
    prepare_s = time.time() - t0
    _sort_flag(SEAM_FLAGS["fused"])
    torch.cuda.synchronize()
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
    files = 0
    for name, db in dbs:
        got = [os.path.join(db._root, f) for f in db.files]
        _same_files(got, want[name], f"service dbs {name}")
        files += len(got)
    if launches["fused_resolve"] != 2 or launches["bloom_build"] != 2 + files:
        raise AssertionError(f"service dbs: launches {launches}")
    recomputes = GpuCompactionService.instance(dev).last_host_recomputes
    if recomputes:
        raise AssertionError(f"service dbs: {recomputes} shards recomputed "
                             f"on the host")
    return {"card": card, "dbs": len(dbs), "runs_per_db": 4,
            "entries_per_db": 4 * DBS_RUN_ENTRIES, "groups": [8, 4],
            "entries_out": sum(counts.values()), "files": files,
            "identical_files": files, "launches": launches,
            "seconds": seconds,
            "entries_per_s": len(dbs) * 4 * DBS_RUN_ENTRIES / seconds,
            "prepare_s": prepare_s}, launches


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
    from rocksplicator_tpu_torch.ops import _build, bitonic_sort
    from rocksplicator_tpu_torch.ops.bitonic_sort import (
        bitonic_sort_lanes, plan_sort, sort_lanes_plain)
    from rocksplicator_tpu_torch.ops.bloom import bloom_build_plain
    from rocksplicator_tpu_torch.ops.bloom_kernel import (
        launch_bloom_build, launch_bloom_build_batched)
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
    got = launch_bloom_build(k3_kw, k3_kl, k3_valid, num_words=k3_words)
    want = bloom_build_plain(k3_kw, k3_kl, k3_valid, num_words=k3_words)
    errs["bloom_build"] = max_abs_err(got, want)
    if errs["bloom_build"]:
        raise AssertionError("K3 differs from its plain version")
    emit({"phase": "parity", "kernel": "bloom_build", "n": k3_n,
          "num_words": k3_words, "max_abs_err": errs["bloom_build"]})

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
    k3_rows = torch.arange(PARITY_N, device=dev)
    got_k3 = launch_bloom_build_batched(got["key_words_le"], got["key_len"],
                                        got["count"], num_words=k3_words)
    want_k3 = torch.stack([bloom_build_plain(
        got["key_words_le"][s], got["key_len"][s], k3_rows < got["count"][s],
        num_words=k3_words) for s in range(BENCH_SHARDS)])
    err = max_abs_err(got_k3, want_k3)
    errs["bloom_build"] = max(errs["bloom_build"], err)
    if err:
        raise AssertionError(f"K3 batched: differs from plain ({err})")
    emit({"phase": "parity", "kernel": "bloom_build", "case": "batched",
          "shards": BENCH_SHARDS, "capacity": PARITY_N,
          "num_words": k3_words,
          "compared_with": "bloom_build_plain shard by shard",
          "max_abs_err": err})

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
        job, job_launches, sub, sub_launches = engine_seam_job(
            dev, work_dir, card)
        emit({"phase": "engine_seam_job", **job})
        emit({"phase": "engine_seam_subcompact", **sub})
        chunked, chunked_launches = engine_seam_chunked(dev, card)
        emit({"phase": "engine_seam_chunked", **chunked})
        wide, wide_launches = engine_seam_wide(dev, work_dir, card)
        emit({"phase": "engine_seam_wide", **wide})
        # ---- 4c. the batched service, each path counted on its own ----
        svc_batch, svc_batch_launches = service_batch(dev, card)
        emit({"phase": "service_batch", **svc_batch})
        svc_dbs, svc_dbs_launches = service_dbs(dev, work_dir, card)
        emit({"phase": "service_dbs", **svc_dbs})
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
        "service_batch": svc_batch_launches,
        "service_dbs": svc_dbs_launches,
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

    def k3_row(kw_le, key_len, count, num_words, reps, shape) -> dict:
        """Batched K3 and its plain version (shard by shard); the bound
        reads the counts, and the key words and length of each row below
        its shard's count (the kernel reads no other row), once, and
        writes the bitmaps once."""
        seg_rows = torch.arange(key_len.shape[1], device=dev)
        live = int(count.sum())

        def plain():
            return [bloom_build_plain(kw_le[s], key_len[s],
                                      seg_rows < count[s],
                                      num_words=num_words)
                    for s in range(key_len.shape[0])]

        def kernel():
            return launch_bloom_build_batched(kw_le, key_len, count,
                                              num_words=num_words)

        return {"shape": shape, "shards": key_len.shape[0],
                "capacity": key_len.shape[1], "num_words": num_words,
                "reps": reps, "ms": time_ms(kernel, reps),
                "device_ms": device_ms(kernel),
                "plain_ms": time_ms(plain, reps),
                "bound_ms": bound(mb(count) + live * 4 * (KEY_WORDS + 1)
                                  + 4 * key_len.shape[0] * num_words)}

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
    k3_args = (bench_out["key_words_le"], bench_out["key_len"], b_valid)
    k3_single = {
        "shape": "2^17, one shard", "n": bench_cfg.capacity,
        "num_words": b_words, "reps": SHORT_REPS,
        "ms": time_ms(lambda: launch_bloom_build(*k3_args,
                                                 num_words=b_words),
                      SHORT_REPS),
        "device_ms": device_ms(lambda: launch_bloom_build(
            *k3_args, num_words=b_words)),
        "plain_ms": time_ms(lambda: bloom_build_plain(
            *k3_args, num_words=b_words), SHORT_REPS),
        # the valid flags of every row, the key words and length of the
        # valid rows only
        "bound_ms": bound(mb(b_valid) + int(bench_out["count"]) * 4
                          * (KEY_WORDS + 1) + 4 * b_words)}
    svc_out = merge_resolve_batched(*svc_args, **bflags)
    k3_rows = [
        k3_row(bench_batch_out["key_words_le"], bench_batch_out["key_len"],
               bench_batch_out["count"], b_words, SHORT_REPS,
               "bench 8 x 2^17, batched"),
        k3_single,
        k3_row(svc_out["key_words_le"], svc_out["key_len"],
               svc_out["count"], num_words_for(SERVICE_ENTRIES, 10), REPS,
               "batched 8 x 2^20")]
    emit({"phase": "k3_timings", "card": card, "k3": k3_rows})

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
