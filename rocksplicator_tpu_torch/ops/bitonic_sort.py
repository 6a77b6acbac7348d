"""Stable lexicographic sort of u32 lanes, payload riding along —
counterpart of ``rocksplicator_tpu/ops/pallas_sort.py``.

``bitonic_sort_lanes`` is the drop-in for ``lax.sort(operands, num_keys)``
on (N,) int32 lane views: rows order lexicographically over the first
``num_keys`` lanes compared as unsigned, and the other lanes ride along.
The name is the TPU kernel's; on the card the algorithm is a merge sort.
On CUDA tensors it launches kernel K1 (``csrc/bitonic_sort.cu`` over
``csrc/merge_sort.cuh``): a shared-memory tile sort and log2(N / tile)
merge-path passes over the key lanes and a row-index lane, the payload
gathered once through the index: 16 lanes by the last launch, any more in
``gather_lanes`` launches of 16 lanes each. N is a power of two >= 256,
with at most 16 key lanes and any number of payload lanes; any other
shape raises. With ``segment`` (a shard axis) the rows are N / segment
shards sorted each on its own: the merge passes stop at runs of
``segment`` rows. On CPU tensors it runs
``sort_lanes_plain``, the plain PyTorch version: a stable LSD sequence of
``torch.sort`` passes over the widened key lanes.

Both versions are stable, so they agree on every input, tied keys
included. ``plan_sort`` computes the kernel's launch plan; the C entry
point checks it and counts the launches it makes.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .lanes import widen

MAX_LANES = 16         # key lanes of one sort
GROUP = 16             # payload lanes one launch gathers
ITEMS = 8              # rows per thread in the tile sort and merge passes
MIN_TILE = 256
MAX_TILE = 2048
SMEM_LIMIT = 232448    # shared memory one block may use on Hopper
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rs_bitonic_sort": (_P, _I, _I, _I, _I, _I, _I, _I, _I,
                        ctypes.c_int64, _P, _P, ctypes.POINTER(_I), _P),
}


@dataclass(frozen=True)
class SortPlan:
    """Launch plan of the merge sort (``csrc/merge_sort.cuh``)."""
    n: int
    num_keys: int
    num_payload: int
    tile: int           # rows each tile_sort block sorts in shared memory
    chunk: int          # output rows of each merge_pass block
    passes: int         # merge passes: log2(segment / tile)
    segment: int        # rows each run ends at: a shard, or n
    gathers: int        # gather_lanes launches after the last pass
    smem_bytes: int     # dynamic shared memory a launch may take
    scratch_words: int  # ping-pong buffer words, then the index lane
    launches: int       # CUDA launches of one sort


def supported(n: int) -> bool:
    """True when K1 takes N rows: a power of two >= 256."""
    return n >= MIN_TILE and not (n & (n - 1))


def gather_launches(num_payload: int) -> int:
    """``gather_lanes`` launches for ``num_payload`` payload lanes: one
    per group of 16 beyond the first, which the last sort launch
    gathers."""
    return max(0, -(-(num_payload - GROUP) // GROUP))


def plan_sort(n: int, num_keys: int, num_payload: int,
              segment: Optional[int] = None) -> SortPlan:
    """The plan for sorting ``num_keys`` key lanes of N rows with
    ``num_payload`` payload lanes, each aligned run of ``segment`` rows on
    its own (default: all N). The tile is as large as a block takes (2048
    rows, at most the segment): on an H100 it beat the smaller tiles, which
    give one block per SM or more, at N = 2^17 and by far at 2^22
    (chip_smoke.py tile_sweep, PERF.md), as each merge pass it saves
    costs more than the SMs it leaves idle in the tile sort. Each merge
    block owns as many rows as a tile. Raises ``ValueError`` for a shape
    the kernels do not take."""
    if not supported(n):
        raise ValueError(f"the sort needs a power-of-two N >= {MIN_TILE}, "
                         f"got {n}")
    segment = n if segment is None else segment
    if not supported(segment) or segment > n:
        raise ValueError(f"the segment must be a power of two in "
                         f"{MIN_TILE}..N, got {segment} for N={n}")
    if not 1 <= num_keys <= MAX_LANES or num_payload < 0:
        raise ValueError(f"the sort takes 1..{MAX_LANES} key lanes and "
                         f"any number of payload lanes, got {num_keys} "
                         f"keys and {num_payload} payload lanes")
    tile = min(segment, MAX_TILE)
    passes = (segment // tile).bit_length() - 1
    gathers = gather_launches(num_payload)
    return SortPlan(
        n=n, num_keys=num_keys, num_payload=num_payload, tile=tile,
        chunk=tile, passes=passes, segment=segment, gathers=gathers,
        smem_bytes=(num_keys + 2) * tile * 4,
        scratch_words=(min(passes, 2) * (num_keys + 1) * n
                       + (n if gathers else 0)),
        launches=1 + passes + gathers)


def sort_lanes_plain(operands: Sequence[torch.Tensor], num_keys: int,
                     segment: Optional[int] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of K1, on any device: stable LSD passes,
    last key lane first, each an unsigned (widened) ``torch.sort``; with
    ``segment``, the segment number is the first key."""
    n = operands[0].shape[0]
    keys = [widen(x) for x in operands[:num_keys]]
    if segment is not None and segment < n:
        keys.insert(0, torch.arange(n, device=operands[0].device) // segment)
    perm = None
    for key in reversed(keys):
        idx = torch.sort(key if perm is None else key[perm],
                         stable=True).indices
        perm = idx if perm is None else perm[idx]
    return tuple(x[perm] for x in operands)


def _check(operands: Sequence[torch.Tensor], num_keys: int) -> None:
    if not operands:
        raise ValueError("no operands")
    n = operands[0].shape[0]
    dev = operands[0].device
    for i, x in enumerate(operands):
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != n:
            raise TypeError(f"operand {i}: expected an ({n},) int32 lane, "
                            f"got {tuple(x.shape)} {x.dtype}")
        if x.device != dev:
            raise ValueError(f"operand {i} is on {x.device}, not {dev}")
    if not 1 <= num_keys <= len(operands):
        raise ValueError(f"num_keys {num_keys} outside 1..{len(operands)}")


def bitonic_sort_lanes(operands: Sequence[torch.Tensor], num_keys: int,
                       segment: Optional[int] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """Sort (N,) int32 lanes by their first ``num_keys`` lanes (unsigned,
    lexicographic, stable), each aligned run of ``segment`` rows on its own
    when given (rows never leave their segment). CPU tensors: the plain
    version. CUDA tensors: kernel K1, or ``ValueError`` for a shape it
    cannot take."""
    operands = list(operands)
    _check(operands, num_keys)
    dev = operands[0].device
    if dev.type == "cpu":
        return sort_lanes_plain(operands, num_keys, segment)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, lanes = operands[0].shape[0], len(operands)
    plan = plan_sort(n, num_keys, lanes - num_keys, segment)
    ins = [x.contiguous() for x in operands]
    out = torch.empty((lanes, n), dtype=torch.int32, device=dev)
    scratch = torch.empty(max(plan.scratch_words, 1), dtype=torch.int32,
                          device=dev)
    in_ptrs = (_P * lanes)(*[x.data_ptr() for x in ins])
    out_ptrs = (_P * lanes)(*[x.data_ptr() for x in out])
    launches = _I(0)
    lib = _build.load("bitonic_sort", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.rs_bitonic_sort(
            in_ptrs, lanes, num_keys, n, plan.tile, plan.chunk, plan.passes,
            plan.segment, plan.smem_bytes, plan.scratch_words,
            scratch.data_ptr(),
            out_ptrs, ctypes.byref(launches), _build.stream_ptr(dev))
    _build.check(lib, rc, f"bitonic_sort {plan}")
    _build.count_launch("bitonic_sort", launches.value)
    return tuple(out.unbind(0))
