"""SST block encoding and block checksums in torch ops — counterpart of
``rocksplicator_tpu/ops/block_encode.py``.

These steps are XLA ops in the JAX package, not Pallas kernels, so plain
torch ops are their port; they run on whatever device the lanes are on.
``encode_rows``, ``encode_planar_words`` and ``planar_checksums`` take
lanes with leading axes (a shard axis: (S, N) lanes, (S, N, W) words), as
the JAX functions do under ``jax.vmap``.

Checksum: H = Σ (x_i + 1) · r^(i+1) mod 2^32 (utils/checksum.py). Torch
has no wrapping u32 ``cumprod``, so the power vector comes from numpy's
uint32 ``cumprod``; the product of two u32 values is taken mod 2^32 in
int64 by 16-bit halves (ops/lanes.mul32), and ``w + 1`` wraps
(``0xFFFFFFFF + 1`` is 0).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..storage.sst import ENTRY_FIXED_OVERHEAD
from ..utils.checksum import powers
from .lanes import MASK32, mul32, narrow, widen

__all__ = ["ENTRY_FIXED_OVERHEAD", "encode_rows", "block_checksums",
           "encode_and_checksum", "encode_planar_words", "planar_checksums"]


def _powers(length: int, device) -> torch.Tensor:
    """r^1..r^length (wrapping u32) as int64 on ``device``."""
    return torch.from_numpy(powers(length).astype(np.int64)).to(device)


def encode_rows(key_words_be, seq_hi, seq_lo, vtype, val_words, *,
                klen: int, vlen: int) -> torch.Tensor:
    """(..., N, stride) uint8 entry rows — u32 klen LE, key bytes, u64 seq
    LE, u8 vtype, u32 vlen LE, value bytes — byte-identical to the JAX
    ``encode_rows_tpu``."""
    dev = seq_lo.device

    def const(v: int) -> torch.Tensor:
        return torch.full(seq_lo.shape, v, dtype=torch.uint8, device=dev)

    def byte(x: torch.Tensor, shift: int) -> torch.Tensor:
        return ((widen(x) >> shift) & 0xFF).to(torch.uint8)

    cols = [const((klen >> (8 * b)) & 0xFF) for b in range(4)]
    cols += [byte(key_words_be[..., j // 4], 24 - 8 * (j % 4))
             for j in range(klen)]
    cols += [byte(seq_lo, 8 * b) for b in range(4)]
    cols += [byte(seq_hi, 8 * b) for b in range(4)]
    cols.append(byte(vtype, 0))
    cols += [const((vlen >> (8 * b)) & 0xFF) for b in range(4)]
    cols += [byte(val_words[..., j // 4], 8 * (j % 4)) for j in range(vlen)]
    return torch.stack(cols, dim=-1)


def block_checksums(rows: torch.Tensor, *, block_entries: int
                    ) -> torch.Tensor:
    """Per-block checksums (int32 lane) over the (N, stride) uint8 rows,
    blocks of ``block_entries`` rows; a short tail block covers its
    zero-padded canonical length."""
    n, stride = rows.shape
    nblocks = (n + block_entries - 1) // block_entries
    pad = nblocks * block_entries - n
    padded = torch.nn.functional.pad(rows, (0, 0, 0, pad))
    blocks = padded.reshape(nblocks, block_entries * stride).to(torch.int64)
    pw = _powers(block_entries * stride, rows.device)
    # (byte + 1) <= 256 and r^i < 2^32: the product fits int64
    return narrow(((blocks + 1) * pw[None, :]).sum(dim=1) & MASK32)


def encode_and_checksum(arrays, count: int, klen: int, vlen: int,
                        block_entries: int, device=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Run both ops over output lanes (int32 tensors) and return host
    copies: (count, stride) uint8 rows and per-block uint32 checksums."""
    def first(name):
        t = arrays[name][:count]
        return t if device is None else t.to(device)

    rows = encode_rows(first("key_words_be"), first("seq_hi"),
                       first("seq_lo"), first("vtype"), first("val_words"),
                       klen=klen, vlen=vlen)
    chk = block_checksums(rows, block_entries=block_entries)
    return rows.cpu().numpy(), chk.cpu().numpy().view(np.uint32)


def encode_planar_words(key_words_be, seq_hi, seq_lo, vtype, val_words, *,
                        klen: int, vlen: int, seq32: bool,
                        block_entries: int) -> torch.Tensor:
    """Planar block encoding: (..., nblocks, words_per_block) int32 —
    each row one block's plane words (key lanes, seq_lo, [seq_hi], vtype
    packed 4 per word little-endian, value lanes)."""
    lead = tuple(seq_lo.shape[:-1])
    n = seq_lo.shape[-1]
    pad = (-n) % block_entries
    nblocks = (n + pad) // block_entries
    b = block_entries

    def blocked(lane: torch.Tensor) -> torch.Tensor:
        if pad:
            lane = torch.nn.functional.pad(lane, (0, pad))
        return lane.reshape(lead + (nblocks, b))

    parts = [blocked(key_words_be[..., w]) for w in range((klen + 3) // 4)]
    parts.append(blocked(seq_lo))
    if not seq32:
        parts.append(blocked(seq_hi))
    vt = blocked(widen(vtype) & 0xFF).reshape(lead + (nblocks, b // 4, 4))
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64,
                          device=seq_lo.device)
    parts.append(narrow((vt << shifts).sum(dim=-1)))
    parts += [blocked(val_words[..., w]) for w in range((vlen + 3) // 4)]
    return torch.cat(parts, dim=-1)


def planar_checksums(words: torch.Tensor) -> torch.Tensor:
    """Word-domain checksum per block row (int32 lane, over the last
    axis): H = Σ (w_i + 1) · r^(i+1) mod 2^32."""
    pw = _powers(words.shape[-1], words.device)
    prods = mul32((widen(words) + 1) & MASK32, pw)
    return narrow(prods.sum(dim=-1) & MASK32)
