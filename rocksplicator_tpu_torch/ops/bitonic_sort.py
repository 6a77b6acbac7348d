"""Stable lexicographic sort of u32 lanes, payload riding along —
counterpart of ``rocksplicator_tpu/ops/pallas_sort.py``.

``bitonic_sort_lanes`` is the drop-in for ``lax.sort(operands, num_keys)``
on (N,) int32 lane views: rows order lexicographically over the first
``num_keys`` lanes compared as unsigned, and the other lanes ride along.
The name is the TPU kernel's; on the card the algorithm is a merge sort.
On CUDA tensors it launches kernel K1 (``csrc/bitonic_sort.cu`` over
``csrc/merge_sort.cuh``): a shared-memory tile sort and log2(N / tile)
merge-path passes over the key lanes and a row-index lane, the payload
gathered once by the last launch. N is a power of two >= 256, at most 16
lanes; any other shape raises. On CPU tensors it runs
``sort_lanes_plain``, the plain PyTorch version: a stable LSD sequence of
``torch.sort`` passes over the widened key lanes.

Both versions are stable, so they agree on every input, tied keys
included. ``plan_sort`` computes the kernel's launch plan; the C entry
point checks it and counts the launches it makes.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from . import _build
from .lanes import widen

MAX_LANES = 16
ITEMS = 8              # rows per thread in the tile sort and merge passes
MIN_TILE = 256
MAX_TILE = 2048
SMEM_LIMIT = 232448    # shared memory one block may use on Hopper
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rs_bitonic_sort": (_P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_int64, _P,
                        _P, ctypes.POINTER(_I), _P),
}


@dataclass(frozen=True)
class SortPlan:
    """Launch plan of the merge sort (``csrc/merge_sort.cuh``)."""
    n: int
    num_keys: int
    num_payload: int
    tile: int           # rows each tile_sort block sorts in shared memory
    chunk: int          # output rows of each merge_pass block
    passes: int         # merge passes: log2(n / tile)
    smem_bytes: int     # dynamic shared memory a launch may take
    scratch_words: int  # ping-pong buffer words
    launches: int       # CUDA launches of one sort


def supported(n: int) -> bool:
    """True when K1 takes N rows: a power of two >= 256."""
    return n >= MIN_TILE and not (n & (n - 1))


def plan_sort(n: int, num_keys: int, num_payload: int) -> SortPlan:
    """The plan for sorting ``num_keys`` key lanes of N rows with
    ``num_payload`` payload lanes. The tile is as large as a block takes
    (2048 rows, at most N): on an H100 it beat the smaller tiles, which
    give one block per SM or more, at N = 2^17 and by far at 2^22
    (chip_smoke.py tile_sweep, PERF.md), as each merge pass it saves
    costs more than the SMs it leaves idle in the tile sort. Each merge
    block owns as many rows as a tile. Raises ``ValueError`` for a shape
    the kernels do not take."""
    if not supported(n):
        raise ValueError(f"the sort needs a power-of-two N >= {MIN_TILE}, "
                         f"got {n}")
    if not 1 <= num_keys <= MAX_LANES or num_payload < 0 or (
            num_keys + num_payload > MAX_LANES):
        raise ValueError(f"the sort takes 1..{MAX_LANES} key lanes and at "
                         f"most {MAX_LANES} lanes in all, got {num_keys} "
                         f"keys and {num_payload} payload lanes")
    tile = min(n, MAX_TILE)
    passes = (n // tile).bit_length() - 1
    return SortPlan(
        n=n, num_keys=num_keys, num_payload=num_payload, tile=tile,
        chunk=tile, passes=passes, smem_bytes=(num_keys + 2) * tile * 4,
        scratch_words=min(passes, 2) * (num_keys + 1) * n,
        launches=1 + passes)


def sort_lanes_plain(operands: Sequence[torch.Tensor],
                     num_keys: int) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of K1, on any device: stable LSD passes,
    last key lane first, each an unsigned (widened) ``torch.sort``."""
    perm = None
    for lane in reversed(operands[:num_keys]):
        key = widen(lane if perm is None else lane[perm])
        idx = torch.sort(key, stable=True).indices
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


def bitonic_sort_lanes(operands: Sequence[torch.Tensor],
                       num_keys: int) -> Tuple[torch.Tensor, ...]:
    """Sort (N,) int32 lanes by their first ``num_keys`` lanes (unsigned,
    lexicographic, stable). CPU tensors: the plain version. CUDA tensors:
    kernel K1, or ``ValueError`` for a shape it cannot take."""
    operands = list(operands)
    _check(operands, num_keys)
    dev = operands[0].device
    if dev.type == "cpu":
        return sort_lanes_plain(operands, num_keys)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, lanes = operands[0].shape[0], len(operands)
    plan = plan_sort(n, num_keys, lanes - num_keys)
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
            plan.smem_bytes, plan.scratch_words, scratch.data_ptr(),
            out_ptrs, ctypes.byref(launches), _build.stream_ptr(dev))
    _build.check(lib, rc, f"bitonic_sort {plan}")
    _build.count_launch("bitonic_sort", launches.value)
    return tuple(out.unbind(0))
