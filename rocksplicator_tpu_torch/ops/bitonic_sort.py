"""Lexicographic sort of u32 lanes, payload riding along — counterpart of
``rocksplicator_tpu/ops/pallas_sort.py``.

``bitonic_sort_lanes`` is the drop-in for ``lax.sort(operands, num_keys)``
on (N,) int32 lane views: rows order lexicographically over the first
``num_keys`` lanes compared as unsigned, and the other lanes ride along.
On CUDA tensors it launches kernel K1 (``csrc/bitonic_sort.cu``, a bitonic
network over an (L, N) struct-of-arrays copy of the lanes; N a power of
two >= 256, at most 16 lanes) and raises for any other shape. On CPU
tensors it runs ``sort_lanes_plain``, the plain PyTorch version: a stable
LSD sequence of ``torch.sort`` passes over the widened key lanes.

Equal keys may leave their payload in another order in the two versions
(the bitonic network is not stable, like ``lax.sort(is_stable=False)``);
the merge-resolve gives valid rows unique (key, seq), so its order is
total.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build
from .lanes import widen

MAX_LANES = 16
_SIGNATURES = {
    "rs_bitonic_sort": (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p),
}


def supported(n: int) -> bool:
    """True when K1 takes N rows: a power of two >= 256."""
    return n >= 256 and not (n & (n - 1))


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
    lexicographic). CPU tensors: the plain version. CUDA tensors: kernel
    K1, or ``ValueError`` for a shape it cannot take."""
    operands = list(operands)
    _check(operands, num_keys)
    dev = operands[0].device
    if dev.type == "cpu":
        return sort_lanes_plain(operands, num_keys)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = operands[0].shape[0]
    if not supported(n) or len(operands) > MAX_LANES:
        raise ValueError(f"bitonic sort needs power-of-two N >= 256 and at "
                         f"most {MAX_LANES} lanes, got N={n}, "
                         f"{len(operands)} lanes")
    lanes = torch.stack(operands).contiguous()
    lib = _build.load("bitonic_sort", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.rs_bitonic_sort(lanes.data_ptr(), len(operands), num_keys,
                                 n, _build.stream_ptr(dev))
    _build.check(lib, rc, "bitonic_sort")
    _build.count_launch("bitonic_sort")
    return tuple(lanes.unbind(0))
