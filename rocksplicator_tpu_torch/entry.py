"""Entry points of the port — counterpart of ``__graft_entry__.py``.

``entry(device)``       — the pipeline at the configuration of
                          ``__graft_entry__.entry()`` (capacity 2^12, planar
                          block encoding) and its example inputs on
                          ``device``.
``bench_model(device)`` — the bench configuration (``bench.py``): 2^17
                          entries per shard, 16-byte keys, 32-bit seqs,
                          planar block encoding; ``shards=8`` gives the
                          bench's 8 shards stacked on a leading axis, one
                          batched forward (``jax.vmap(model.forward)``,
                          ``bench.py:316``).
``dryrun_multichip(n)`` — the FULL sharded compaction step on an n-device
                          (shard x block) grid, held against the unsharded
                          pipeline (``__graft_entry__.dryrun_multichip``).

All default to ``cuda`` and raise without it (``device="cpu"``, or a grid
of ``torch.device("cpu")``, runs the plain PyTorch path).
"""

from __future__ import annotations

import hashlib
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

from .device import resolve_device
from .models import CompactionModel
from .models.compaction_model import FORWARD_ARGS
from .ops.lanes import lanes_from_numpy, lanes_to_numpy
from .parallel.mesh import (Mesh, make_mesh, make_sharded_inputs,
                            shard_inputs_on_mesh, sharded_compaction_step)

BENCH_ENTRIES = 131072
BENCH_KEY_BYTES = 16
BENCH_VAL_BYTES = 8
BENCH_SHARDS = 8
# the output lanes the dryrun's content hash covers: every lane
HASH_FIELDS = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
               "val_words", "val_len")


def entry(device=None, seed: int = 0) -> Tuple[CompactionModel, tuple]:
    """(model, example_args) for the ``__graft_entry__.entry()``
    configuration."""
    dev = resolve_device(device)
    model = CompactionModel(capacity=1 << 12, emit_planar=True,
                            planar_block_entries=1024)
    return model, model.example_args(seed=seed, device=dev)


def bench_model(device=None, seed: int = 0, shards: Optional[int] = None
                ) -> Tuple[CompactionModel, tuple]:
    """(model, example_args) for the bench configuration: one shard's
    lanes, or with ``shards`` (the bench runs ``BENCH_SHARDS``) that many
    shards' lanes on a leading axis, shard s from seed ``seed + s``."""
    dev = resolve_device(device)
    model = CompactionModel(
        capacity=BENCH_ENTRIES, uniform_klen=True, seq32=True,
        key_words=BENCH_KEY_BYTES // 4, emit_planar=True,
        row_klen=BENCH_KEY_BYTES, row_vlen=BENCH_VAL_BYTES, val_words=2)
    return model, model.example_args(seed=seed, device=dev, shards=shards)


def dryrun_multichip(n_devices: int, entries_per_block: int = 1 << 17,
                     devices=None, backends=("fused", "bitonic")) -> list:
    """Run the FULL sharded pipeline (merge-resolve + bloom + planar block
    encode/checksums) once per backend on an ``n_devices`` grid
    (``parallel/mesh.py``; ``devices=None`` means every CUDA card, and
    raises without CUDA), and hold each against the unsharded pipeline
    over the same data on the grid's first device: equal per-shard
    counts, a content hash over every merged row, equal bloom bitmaps,
    and equal planar plane words and checksums. Counterpart of
    ``__graft_entry__.dryrun_multichip``, which clamps its fused leg for
    interpret-mode Pallas; both legs here run at ``entries_per_block``.
    Prints the reference's ``dryrun_multichip OK`` line per backend and
    returns its fields."""
    return [dryrun_check(dryrun_case(n_devices, backend, entries_per_block,
                                     devices)) for backend in backends]


def content_hash(arrays: dict, counts) -> str:
    """sha256 over the first ``counts[s]`` rows of every output lane of
    every shard s (numpy u32 lanes), as the reference's dryrun and
    ``tools/multichip_scaling.py`` hash them."""
    h = hashlib.sha256()
    for s, c in enumerate(counts):
        for name in HASH_FIELDS:
            h.update(np.ascontiguousarray(arrays[name][s][:int(c)]).tobytes())
    return h.hexdigest()


class DryrunCase(NamedTuple):
    """One backend's sharded step with its placed lanes, and the same data
    flattened for the unsharded pipeline on the grid's first device."""
    backend: str
    mesh: Mesh
    model: CompactionModel
    host: dict  # the (S, B, N, ...) numpy inputs
    step: Callable
    args: tuple  # the placed tiles, in FORWARD_ARGS order
    flat_args: tuple  # (S, B * N, ...) lanes, in FORWARD_ARGS order


def dryrun_case(n_devices: int, backend: str, entries_per_block: int,
                devices=None) -> DryrunCase:
    """The first half of the reference's ``_dryrun_one_backend``: the
    grid, the model, the inputs placed tile by tile, and the step."""
    mesh = make_mesh(n_devices, devices=devices)
    model = CompactionModel(capacity=entries_per_block, emit_planar=True,
                            sort_backend=backend)
    host = make_sharded_inputs(mesh, shards_per_device=2,
                               entries_per_block=entries_per_block)
    placed = shard_inputs_on_mesh(mesh, host)
    # the unsharded pipeline's input: each shard's blocks concatenated
    s_dim, b_dim, n_dim = host["key_len"].shape
    flat = lanes_from_numpy(
        {k: host[k].reshape((s_dim, b_dim * n_dim) + host[k].shape[3:])
         for k in FORWARD_ARGS}, mesh.devices[0][0])
    return DryrunCase(backend, mesh, model, host,
                      sharded_compaction_step(mesh, model),
                      tuple(placed[k] for k in FORWARD_ARGS),
                      tuple(flat[k] for k in FORWARD_ARGS))


def dryrun_check(case: DryrunCase, out: Optional[tuple] = None) -> dict:
    """The second half of the reference's ``_dryrun_one_backend``: its
    assertions on the step's outputs ``out`` (one step call when None)
    against one batched forward of the unsharded pipeline; prints the
    ``dryrun_multichip OK`` line and returns its fields."""
    backend, mesh, model, host = case.backend, case.mesh, case.model, \
        case.host
    if out is None:
        out = case.step(*case.args)
    final, bloom, counts, global_count, needs_fallback = out
    counts_np = counts.cpu().numpy().reshape(-1)
    gc = int(global_count.reshape(-1)[0])

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"[{backend}] {what}")

    check(gc > 0, "sharded compaction produced no output")
    check(int(needs_fallback.reshape(-1)[0]) == 0, "needs_fallback is set")
    check(gc == int(counts_np.sum()), f"{gc} != {counts_np.sum()}")
    bloom_np = lanes_to_numpy({"b": bloom[:, 0]})["b"]
    check(bloom_np.any(), "bloom bitmaps empty")

    # reference: the SAME data through the unsharded pipeline
    ref = lanes_to_numpy(model(*case.flat_args))
    check(np.array_equal(ref["count"], counts_np),
          f"counts {counts_np} != unsharded {ref['count']}")
    fin = lanes_to_numpy({k: v[:, 0] for k, v in final.items()})
    mesh_hash = content_hash(fin, counts_np)
    ref_hash = content_hash(ref, ref["count"])
    check(mesh_hash == ref_hash, f"sharded result diverges from the "
          f"unsharded pipeline: {mesh_hash} != {ref_hash}")
    check(np.array_equal(bloom_np, ref["bloom"]),
          "mesh bloom diverges from the unsharded bloom")
    check(np.array_equal(fin["planar_words"], ref["planar_words"]),
          "mesh planar plane words diverge from the unsharded pipeline")
    check(np.array_equal(fin["planar_chk"], ref["planar_chk"]),
          "mesh planar checksums diverge from the unsharded pipeline")
    planar_hash = hashlib.sha256(
        np.ascontiguousarray(ref["planar_words"]).tobytes()
        + np.ascontiguousarray(ref["planar_chk"]).tobytes()).hexdigest()
    bloom_hash = hashlib.sha256(
        np.ascontiguousarray(ref["bloom"]).tobytes()).hexdigest()
    s_dim, b_dim, n_dim = host["key_len"].shape
    n_devices = mesh.shape["shard"] * mesh.shape["block"]
    report = {"backend": backend, "mesh": dict(mesh.shape),
              "devices": n_devices, "shards": int(counts_np.shape[0]),
              "entries_per_block": n_dim,
              "input_entries": s_dim * b_dim * n_dim, "merged_entries": gc,
              "parity_sha256": mesh_hash[:16],
              "bloom_sha256": bloom_hash[:16],
              "planar_sha256": planar_hash[:16]}
    print("dryrun_multichip OK: " + " ".join(
        f"{k}={v}" for k, v in report.items()), flush=True)
    return report
