"""Device-grid sharding for batched compaction — counterpart of
``rocksplicator_tpu/parallel/mesh.py``.

Grid axes, as in the reference's mesh:
- ``shard``: independent shards (DP-analog), no communication;
- ``block``: a blockwise split of one shard's entries (SP-analog). Each
  tile merges its block locally, a gather over the block axis assembles
  the shard's blocks for the final merge, and a sum over the shard axis
  gives the job's global count.

One process drives every device of the grid, as the reference's single
controller drives its mesh (``shard_map`` under ``jit``). The devices are
explicit ``torch.device``s and may repeat: the tests run a grid of eight
CPU devices (the reference's eight forced host devices), and one card can
hold every tile of a grid (``[torch.device("cuda:0")] * 8``), so each
tile's K1/K2 and each row's K3 run there. A gather across cards is a peer
copy (``Tensor.to``); a gather on one card copies nothing. The two
collectives are ``all_gather_block`` and ``all_reduce``; a multi-host
grid would replace them with ``torch.distributed`` calls.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.compaction_model import (FORWARD_ARGS, CompactionModel,
                                       synth_counter_batch)
from ..ops.block_encode import encode_planar_words, planar_checksums
from ..ops.bloom import bloom_build_batched
from ..ops.compaction_kernel import merge_resolve_batched
from ..ops.lanes import lanes_from_numpy

# Per-device working-set target for one block of a shard's compaction
# job. The value is the reference's, kept so that both packages derive
# the same grid from the same inputs; no H100 budget for a block has been
# measured.
BLOCK_BYTES_TARGET = 32 << 20

# the (s, 1, N, ...) tiles of one lane, tile (r, c) on mesh.devices[r][c]
Tiles = List[List[torch.Tensor]]


def derive_block_axis(num_devices: int,
                      shard_bytes: Optional[int] = None,
                      block_bytes_target: int = BLOCK_BYTES_TARGET) -> int:
    """Block-axis size (SP-analog) from device count and job size.

    Picks the smallest power-of-2 divisor of ``num_devices`` whose blocks
    fit ``block_bytes_target`` (more block-parallelism only when a
    shard's job exceeds one device's budget — otherwise devices are
    better spent on the no-communication shard axis). Without a
    ``shard_bytes`` hint: 2 when the device count is even (exercises both
    collectives), else 1."""
    if num_devices <= 1:
        return 1
    if shard_bytes is None:
        return 2 if num_devices % 2 == 0 else 1
    block = 1
    while (
        block < num_devices
        and num_devices % (block * 2) == 0
        and shard_bytes / block > block_bytes_target
    ):
        block *= 2
    return block


class Mesh:
    """A (shard, block) grid of devices. ``devices[r][c]`` holds tile
    (r, c); ``shape`` is ``{"shard": S, "block": B}``, as the reference
    mesh's ``shape``."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [list(row) for row in devices]
        self.shape = {"shard": len(self.devices),
                      "block": len(self.devices[0])}


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              block: Optional[int] = None,
              shard_bytes: Optional[int] = None) -> Mesh:
    """A 2D grid over the first ``num_devices`` of ``devices`` (default:
    every CUDA card; raises without CUDA). The block axis is ``block`` if
    given, else derived from the job size (see derive_block_axis)."""
    if devices is None:
        resolve_device(None)  # raises without CUDA
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devices = devices[:n]
    if block is None:
        block = derive_block_axis(n, shard_bytes)
    if n % block != 0:
        raise ValueError(f"block axis {block} does not divide {n} devices")
    return Mesh([devices[r * block:(r + 1) * block]
                 for r in range(n // block)])


def all_gather_block(parts: Sequence[torch.Tensor], device: torch.device,
                     dim: int = 1) -> torch.Tensor:
    """The row's tile outputs, concatenated along ``dim`` on ``device``:
    the reference's ``all_gather`` over ``block``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def all_reduce(parts: Sequence[torch.Tensor], device: torch.device,
               op: Callable = torch.sum) -> torch.Tensor:
    """``op`` over every part's values, on ``device``: the reference's
    ``psum`` (``torch.sum``) and ``pmax`` (``torch.amax``)."""
    return op(torch.stack([p.to(device).reshape(()) for p in parts]))


def sharded_compaction_step(mesh: Mesh,
                            model: Optional[CompactionModel] = None
                            ) -> Callable:
    """Returns a step over the eight placed lanes (``FORWARD_ARGS``, each
    as ``shard_inputs_on_mesh`` gives it): S shards on the ``shard`` axis,
    B blocks on the ``block`` axis. It returns the reference's 5-tuple:
    ``final`` (each (S, 1, B·N, ...), with ``planar_words`` and
    ``planar_chk`` under ``model.emit_planar``), ``bloom`` (S, 1, words),
    ``counts`` (S, 1), ``global_count`` (1, 1) and ``needs_fallback``
    (1, 1), assembled on the grid's first device.

    Per tile: one batched merge-resolve over its s shards, keeping
    tombstones (blocks are partial views). Per row: the gather of its
    B tiles, one batched final merge over the concatenation with rows
    past each block's count invalid, one batched bloom build and the
    planar encode. The reference's ``shard_map`` replicates the final
    merge over the row's B devices; here it runs once per row, on the
    row's first device, which repeats no work and gives the same outputs.

    **Required invariant:** a shard's blocks must partition its entries
    by sequence range — every seq in block b strictly newer than every
    seq in block b-1 (blocks are WAL ranges / LSM runs). Block-local
    resolution folds operands into the block's newest base; that composes
    across blocks ONLY under this ordering. ``make_sharded_inputs``
    generates compliant data.
    """
    model = model or CompactionModel()
    merge = dict(merge_kind=model.merge_kind,
                 sort_backend=model.sort_backend)
    final_keys = ("key_words_be", "key_words_le", "key_len", "seq_hi",
                  "seq_lo", "vtype", "val_words", "val_len")
    grid = mesh.devices
    first = grid[0][0]

    def step(*lanes: Tiles):
        tiles = dict(zip(FORWARD_ARGS, lanes))
        fallbacks = []

        # 1) block-local merge per tile (keep tombstones)
        def local_merge(r: int, c: int) -> dict:
            out = merge_resolve_batched(
                *(tiles[k][r][c][:, 0] for k in FORWARD_ARGS),
                drop_tombstones=False, **merge)
            fallbacks.append(out.pop("needs_cpu_fallback").any())
            # LE lanes are byteswap-derived: not gathered
            out.pop("key_words_le")
            return out

        local = [[local_merge(r, c) for c in range(len(row))]
                 for r, row in enumerate(grid)]

        rows = []
        for r, row in enumerate(grid):
            dev = row[0]
            # 2) assemble the shard's blocks on the row's first device
            gathered = {k: all_gather_block([o[k] for o in local[r]], dev)
                        for k in local[r][0] if k != "count"}
            per_block = all_gather_block(
                [o["count"][:, None] for o in local[r]], dev)  # (s, B)
            nb = per_block.shape[1]
            n = gathered["key_len"].shape[1] // nb
            # rows past each block's count are zero-filled: invalid
            pos = torch.arange(nb * n, device=dev)
            valid2 = (pos % n)[None, :] < per_block[:, pos // n]
            # 3) final merge per shard
            final = merge_resolve_batched(
                *(valid2 if k == "valid" else gathered[k]
                  for k in FORWARD_ARGS),
                drop_tombstones=model.drop_tombstones, **merge)
            fallbacks.append(final.pop("needs_cpu_fallback").any())
            # 4) bloom per shard
            bloom = bloom_build_batched(
                final["key_words_le"], final["key_len"], final["count"],
                num_words=model.num_bloom_words)
            # 5) the production sink format per shard
            if model.emit_planar:
                words = encode_planar_words(
                    final["key_words_be"], final["seq_hi"], final["seq_lo"],
                    final["vtype"], final["val_words"],
                    klen=model.row_klen, vlen=model.row_vlen,
                    seq32=model.seq32,
                    block_entries=model.planar_block_entries)
                final["planar_words"] = words
                final["planar_chk"] = planar_checksums(words)
            final["bloom"] = bloom
            rows.append(final)

        # 6) the shard axis on the grid's first device; psum and pmax
        def shard_axis(k):
            return all_gather_block([f[k][:, None] for f in rows], first,
                                    dim=0)

        keys = final_keys + (("planar_words", "planar_chk")
                             if model.emit_planar else ())
        out_final = {k: shard_axis(k) for k in keys}
        counts = shard_axis("count")
        global_count = all_reduce([f["count"].sum() for f in rows], first)
        needs_fallback = all_reduce(
            [f.to(torch.int32) for f in fallbacks], first, torch.amax)
        return (out_final, shard_axis("bloom"), counts,
                global_count.to(torch.int32).reshape(1, 1),
                needs_fallback.reshape(1, 1))

    return step


def make_sharded_inputs(mesh: Mesh, shards_per_device: int = 1,
                        entries_per_block: int = 256, model=None,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic (S, B, N, ...) inputs laid out for the grid, equal to the
    reference's for the same arguments. ``model`` is read by neither
    package: it is kept only so the signature is the reference's.
    Block b of each shard takes seqs from ``1 + b * N``, so the blocks
    partition the shard by seq range."""
    shard_n = mesh.shape["shard"] * shards_per_device
    block_n = mesh.shape["block"]
    n = entries_per_block
    arrays = None
    for s in range(shard_n):
        for b in range(block_n):
            batch = synth_counter_batch(
                n, seed=seed + s * 131 + b,
                start_seq=1 + b * n,
            )
            if arrays is None:
                arrays = {
                    k: np.zeros((shard_n, block_n) + v.shape, v.dtype)
                    for k, v in batch.items()
                }
            for k, v in batch.items():
                arrays[k][s, b] = v
    return arrays


def shard_inputs_on_mesh(mesh: Mesh, arrays: Dict[str, np.ndarray]
                         ) -> Dict[str, Tiles]:
    """Each (S, B, N, ...) array as tiles: tile (r, c) is the
    (S / shard, 1, N, ...) slice of shard row r and block c, as an int32
    (bool) lane on ``mesh.devices[r][c]``."""
    shards = next(iter(arrays.values())).shape[0]
    if shards % mesh.shape["shard"]:
        raise ValueError(f"{shards} shards do not divide over "
                         f"{mesh.shape['shard']} grid rows")
    s = shards // mesh.shape["shard"]
    return {k: [[lanes_from_numpy({k: v[r * s:(r + 1) * s, c:c + 1]},
                                  dev)[k]
                 for c, dev in enumerate(row)]
                for r, row in enumerate(mesh.devices)]
            for k, v in arrays.items()}
