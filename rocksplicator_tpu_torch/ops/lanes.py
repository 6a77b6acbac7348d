"""u32 lanes carried as ``torch.int32``, and the numpy ↔ torch crossing.

The JAX package works on ``uint32`` arrays. PyTorch's ``uint32`` lacks
shifts, comparisons, ``~``, ``%``, ``flip`` and ``scatter_reduce`` on the
CPU, so the port carries each u32 lane as an ``int32`` tensor holding the
same bits (``arr.view(np.int32)``). The plain torch path widens to int64
and masks with ``& 0xFFFFFFFF`` for arithmetic and unsigned comparison;
CUDA kernels reinterpret the lanes as ``uint32_t``.

``lanes_from_numpy`` takes the exact arrays the JAX ``CompactionModel``
consumes, and ``lanes_to_numpy`` gives an output dict back as numpy
uint32 / bool / int values, so tests feed both packages the same state.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def u32_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy u32 (or bool) array as an int32 (or bool) tensor on
    ``device``, bit for bit."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr.copy()).to(device)
    if arr.dtype != np.uint32:
        raise TypeError(f"expected a uint32 or bool array, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """An int32 lane tensor back as a numpy uint32 array (bool stays
    bool, uint8 stays uint8)."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 lane → int64 holding the unsigned value (0 .. 2^32-1)."""
    return t.to(torch.int64) & MASK32


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 holding a value mod 2^32 → int32 lane with the same low 32
    bits (explicit two's-complement wrap; no reliance on cast overflow)."""
    t = t & MASK32
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


def bswap32(w: torch.Tensor) -> torch.Tensor:
    """Byteswap int32 lanes: the LE word over the same 4 bytes as a BE
    word."""
    x = widen(w)
    return narrow((x >> 24) | ((x >> 8) & 0xFF00)
                  | ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a · b) mod 2^32 for int64 tensors holding u32 values. The full
    product can overflow int64, so ``b`` is split into 16-bit halves."""
    b_lo = b & 0xFFFF
    b_hi = (b >> 16) & 0xFFFF
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & MASK32


def lanes_from_numpy(batch: Mapping[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
    """Every array of ``batch`` (uint32 lanes, bool masks) as a tensor on
    ``device``: uint32 → int32 views, bool → bool."""
    return {k: u32_tensor(np.asarray(v), device) for k, v in batch.items()}


def lanes_to_numpy(out: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """An output dict back on the host: lanes as numpy uint32 (bool and
    uint8 keep their type); 0-dim ``count`` as an int and 0-dim
    ``needs_cpu_fallback`` as a bool; a batched (S,) ``count`` as int32,
    as ``jax.vmap`` gives it."""
    res: Dict[str, object] = {}
    for k, v in out.items():
        if v.dim() == 0:
            res[k] = bool(v.item()) if v.dtype == torch.bool else int(
                v.item())
        elif k == "count":
            res[k] = v.detach().cpu().numpy()
        else:
            res[k] = u32_numpy(v)
    return res
