"""Multi-device scaling series of the sharded compaction step —
counterpart of ``tools/multichip_scaling.py``.

Runs the SAME sharded step as ``entry.dryrun_multichip`` ((shard x block)
grid, the block gather and the shard-axis sum, the full production
pipeline: merge-resolve + bloom + planar encode/checksums) over a series
of entries-per-block, recording per shape:

- ``first_call_s`` — the first step call of the shape, synchronized. In a
  fresh process the kernels' build and load are in it (PyTorch has no
  trace or compile step of its own); once they are loaded it is one
  more call;
- ``execute_s`` — the median of ``EXECUTE_REPS`` later calls, each
  synchronized (host clock);
- ``merged_entries`` and ``output_sha256``, the reference's content hash
  over every merged row (cross-shape sanity, and equal to the reference's
  for the same inputs).

    python -m rocksplicator_tpu_torch.tools.multichip_scaling \\
        --entries 32768,65536 --device cuda:0 [--out rows.json]

``--device D`` puts every tile of the grid on D (one card, or ``cpu`` for
the plain versions); without it the grid takes one tile per CUDA card.
Without ``--out`` the rows go to stdout.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Optional, Sequence

import torch

from ..entry import content_hash
from ..models.compaction_model import FORWARD_ARGS, CompactionModel
from ..ops.lanes import lanes_to_numpy
from ..parallel.mesh import (make_mesh, make_sharded_inputs,
                             shard_inputs_on_mesh, sharded_compaction_step)

EXECUTE_REPS = 3


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_shape(n_devices: int, backend: str, entries: int,
              devices: Optional[Sequence] = None) -> dict:
    """One shape of the series on an ``n_devices`` grid over ``devices``
    (default: every CUDA card)."""
    mesh = make_mesh(n_devices, devices=devices)
    model = CompactionModel(capacity=entries, emit_planar=True,
                            sort_backend=backend)
    step = sharded_compaction_step(mesh, model)
    arrays = make_sharded_inputs(mesh, shards_per_device=2,
                                 entries_per_block=entries)
    placed = shard_inputs_on_mesh(mesh, arrays)
    args = tuple(placed[k] for k in FORWARD_ARGS)
    first = mesh.devices[0][0]
    _sync(first)
    t0 = time.perf_counter()
    step(*args)
    _sync(first)
    first_call_s = time.perf_counter() - t0
    execute = []
    for _ in range(EXECUTE_REPS):
        t0 = time.perf_counter()
        final, _bloom, counts, global_count, needs_fallback = step(*args)
        _sync(first)
        execute.append(time.perf_counter() - t0)

    counts_np = counts.cpu().numpy().reshape(-1)
    gc = int(global_count.reshape(-1)[0])
    if not (gc > 0 and gc == int(counts_np.sum())):
        raise AssertionError(f"global count {gc}, counts {counts_np}")
    if int(needs_fallback.reshape(-1)[0]):
        raise AssertionError("needs_fallback is set")
    fin = lanes_to_numpy({k: v[:, 0] for k, v in final.items()})
    row = {
        "backend": backend,
        "entries_per_block": entries,
        "devices": n_devices,
        "mesh": dict(mesh.shape),
        "shards": int(counts_np.shape[0]),
        "input_entries": int(counts_np.shape[0]) * entries,
        "merged_entries": gc,
        "first_call_s": first_call_s,
        "execute_s": statistics.median(execute),
        "execute_reps": EXECUTE_REPS,
        "output_sha256": content_hash(fin, counts_np)[:16],
    }
    log(f"  {backend}@{entries}: first call {row['first_call_s']:.3f}s, "
        f"execute {row['execute_s']:.4f}s, merged {gc}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entries", default="2048,8192,32768")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--backends", default="fused")
    ap.add_argument("--device", default=None,
                    help="put every tile of the grid on this device "
                         "(default: one tile per CUDA card)")
    ap.add_argument("--out", default=None,
                    help="write the series here (default: stdout)")
    args = ap.parse_args(argv)

    shapes = [int(s) for s in args.entries.split(",") if s.strip()]
    backends = [b.strip() for b in args.backends.split(",") if b.strip()]
    devices = None if args.device is None else [args.device] * args.devices
    grid = make_mesh(args.devices, devices=devices).devices
    kind = (torch.cuda.get_device_name(grid[0][0])
            if grid[0][0].type == "cuda" else "cpu")
    result = {
        "series": "sharded_step_scaling",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "torch": torch.__version__,
        "device": kind,
        "grid_devices": [str(d) for row in grid for d in row],
        "rows": [],
    }
    for backend in backends:
        for entries in shapes:
            log(f"multichip_scaling: {backend} @ {entries} entries/block")
            result["rows"].append(
                run_shape(args.devices, backend, entries, devices))
    if args.out is None:
        print(json.dumps(result))
        return 0
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps({"execute_s": {
        f"{r['backend']}@{r['entries_per_block']}": r["execute_s"]
        for r in result["rows"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
