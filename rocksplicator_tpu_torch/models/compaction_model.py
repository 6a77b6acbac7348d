"""CompactionModel — counterpart of
``rocksplicator_tpu/models/compaction_model.py``.

The "model" is not a neural net: its forward step is one shard's
compaction over a fixed-capacity batch of KV lanes — merge-resolve, bloom
build, and optionally entry rows or planar block words with their
checksums. It has no parameters; its state is the lane batch. Lanes with a
leading shard axis ((S, C) lanes) compact S shards in one call, the
counterpart of ``jax.vmap(model.forward)``: one K2 call (or one segmented
K1 sort) and one K3 call on the card.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.block_encode import (encode_planar_words, encode_rows,
                                planar_checksums)
from ..ops.bloom import bloom_build, bloom_build_batched, bloom_build_plain
from ..ops.compaction_kernel import (SORT_BACKENDS, MergeKind,
                                     merge_resolve_batched,
                                     merge_resolve_kernel,
                                     merge_resolve_plain)
from ..ops.kv_format import KEY_WORDS
from ..ops.lanes import lanes_from_numpy
from ..storage.bloom import num_words_for

_PUT, _DELETE, _MERGE = 1, 2, 3

FORWARD_ARGS = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
                "val_words", "val_len", "valid")


class CompactionModel(nn.Module):
    """Configuration of the pipeline (field names as in the JAX package).

    ``uniform_klen`` / ``seq32`` / ``key_words`` are caller-verified
    promises that drop sort operands; ``emit_rows`` adds the (N, stride)
    entry-row matrix; ``emit_planar`` adds planar block words and their
    checksums. ``sort_backend`` picks the kernel on CUDA: ``"fused"`` (K2)
    or ``"bitonic"`` (K1 + torch resolve)."""

    def __init__(self, capacity: int = 1 << 16, val_words: int = 2,
                 bits_per_key: int = 10,
                 merge_kind: MergeKind = MergeKind.UINT64_ADD,
                 drop_tombstones: bool = True, uniform_klen: bool = False,
                 seq32: bool = False, key_words: int = KEY_WORDS,
                 emit_rows: bool = False, row_klen: int = 16,
                 row_vlen: int = 8, emit_planar: bool = False,
                 planar_block_entries: int = 1024,
                 sort_backend: str = "fused"):
        super().__init__()
        if sort_backend not in SORT_BACKENDS:
            raise ValueError(f"sort_backend {sort_backend!r} is not one of "
                             f"{SORT_BACKENDS}")
        self.capacity = capacity
        self.val_words = val_words
        self.bits_per_key = bits_per_key
        self.merge_kind = merge_kind
        self.drop_tombstones = drop_tombstones
        self.uniform_klen = uniform_klen
        self.seq32 = seq32
        self.key_words = key_words
        self.emit_rows = emit_rows
        self.row_klen = row_klen
        self.row_vlen = row_vlen
        self.emit_planar = emit_planar
        self.planar_block_entries = planar_block_entries
        self.sort_backend = sort_backend

    @property
    def num_bloom_words(self) -> int:
        return num_words_for(self.capacity, self.bits_per_key)

    def forward(self, key_words_be, key_len, seq_hi, seq_lo, vtype,
                val_words, val_len, valid) -> Dict[str, torch.Tensor]:
        """One shard's compaction: merged entries + bloom + count (+ rows /
        planar words); with a leading shard axis, S shards' at once and
        every output with that axis. CUDA lanes go through the kernels,
        CPU lanes through their plain versions."""
        if key_len.dim() == 2:
            merge = functools.partial(merge_resolve_batched,
                                      sort_backend=self.sort_backend)
            bloom = bloom_build_batched
        else:
            merge = functools.partial(merge_resolve_kernel,
                                      sort_backend=self.sort_backend)
            bloom = bloom_build
        return self._pipeline(merge, bloom, key_words_be, key_len, seq_hi,
                              seq_lo, vtype, val_words, val_len, valid)

    def forward_plain(self, *lanes) -> Dict[str, torch.Tensor]:
        """``forward`` through every kernel's plain PyTorch version, on the
        lanes' own device, shard by shard with a leading shard axis: the
        reference the kernels are held against."""
        if lanes[1].dim() == 2:
            per = [self._pipeline(merge_resolve_plain, bloom_build_plain,
                                  *(x[s] for x in lanes))
                   for s in range(lanes[1].shape[0])]
            return {k: torch.stack([o[k] for o in per]) for k in per[0]}
        return self._pipeline(merge_resolve_plain, bloom_build_plain, *lanes)

    def _pipeline(self, merge: Callable, bloom: Callable, key_words_be,
                  key_len, seq_hi, seq_lo, vtype, val_words, val_len,
                  valid) -> Dict[str, torch.Tensor]:
        out = merge(
            key_words_be, key_len, seq_hi, seq_lo, vtype, val_words,
            val_len, valid, merge_kind=self.merge_kind,
            drop_tombstones=self.drop_tombstones,
            uniform_klen=self.uniform_klen, seq32=self.seq32,
            key_words=self.key_words)
        if key_len.dim() == 2:
            # batched K3 reads each shard's count on the device
            live = out["count"]
        else:
            live = torch.arange(key_len.shape[0],
                                device=key_len.device) < out["count"]
        out["bloom"] = bloom(out["key_words_le"], out["key_len"], live,
                             num_words=self.num_bloom_words)
        if self.emit_rows:
            out["rows"] = encode_rows(
                out["key_words_be"], out["seq_hi"], out["seq_lo"],
                out["vtype"], out["val_words"],
                klen=self.row_klen, vlen=self.row_vlen)
        if self.emit_planar:
            words = encode_planar_words(
                out["key_words_be"], out["seq_hi"], out["seq_lo"],
                out["vtype"], out["val_words"],
                klen=self.row_klen, vlen=self.row_vlen, seq32=self.seq32,
                block_entries=self.planar_block_entries)
            out["planar_words"] = words
            out["planar_chk"] = planar_checksums(words)
        return out

    def example_args(self, seed: int = 0, device=None,
                     shards: Optional[int] = None
                     ) -> Tuple[torch.Tensor, ...]:
        """Inputs matching ``forward``'s signature, as lanes on ``device``
        (default ``cuda``): the arrays the JAX ``example_args`` gives for
        the same seed. With ``shards``, S shards' lanes stacked on a
        leading axis, shard s made from seed ``seed + s``."""
        dev = resolve_device(device)
        seeds = [seed] if shards is None else range(seed, seed + shards)
        batches = [synth_counter_batch(self.capacity, seed=s,
                                       val_words=self.val_words)
                   for s in seeds]
        if shards is None:
            batch = batches[0]
        else:
            batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        lanes = lanes_from_numpy(batch, dev)
        return tuple(lanes[k] for k in FORWARD_ARGS)


def synth_counter_batch(
    n: int,
    key_space: int | None = None,
    seed: int = 0,
    merge_frac: float = 0.6,
    delete_frac: float = 0.05,
    val_words: int = 2,
    key_bytes: int = 16,
    start_seq: int = 1,
) -> Dict[str, np.ndarray]:
    """Synthetic counter-workload batch (the bench generator), bit-identical
    to the JAX package's numpy generator for the same arguments.

    Keys: ``key_bytes`` long, first 8 bytes = big-endian key id drawn from
    ``key_space`` ids, remaining bytes zero. Ops: MERGE bumps, PUTs, a few
    DELETEs. Seqs are unique and ascending from ``start_seq``.
    """
    rng = np.random.default_rng(seed)
    key_space = key_space or max(1, n // 8)
    key_ids = rng.integers(0, key_space, size=n, dtype=np.uint64)
    key_buf = np.zeros((n, 24), dtype=np.uint8)
    key_buf[:, :8] = key_ids.astype(">u8").view(np.uint8).reshape(n, 8)
    r = rng.random(n)
    vtype = np.where(
        r < merge_frac, _MERGE,
        np.where(r < merge_frac + delete_frac, _DELETE, _PUT)
    ).astype(np.uint32)
    vals = rng.integers(0, 1000, size=n, dtype=np.uint64)
    vals = np.where(vtype == _DELETE, 0, vals)
    val_buf = np.zeros((n, val_words * 4), dtype=np.uint8)
    val_buf[:, :8] = vals.astype("<u8").view(np.uint8).reshape(n, 8)
    seqs = np.arange(start_seq, start_seq + n, dtype=np.uint64)
    return {
        "key_words_be": key_buf.view(">u4").astype(np.uint32).reshape(n, 6),
        "key_words_le": key_buf.view("<u4").reshape(n, 6).copy(),
        "key_len": np.full(n, key_bytes, dtype=np.uint32),
        "seq_hi": (seqs >> np.uint64(32)).astype(np.uint32),
        "seq_lo": (seqs & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        "vtype": vtype,
        "val_words": val_buf.view("<u4").reshape(n, val_words).copy(),
        "val_len": np.where(vtype == _DELETE, 0, 8).astype(np.uint32),
        "valid": np.ones(n, dtype=bool),
    }


def synth_mixed_batch(
    n: int,
    seed: int = 0,
    *,
    valid_frac: float = 0.85,
    uniform_klen: bool = False,
    seq32: bool = False,
    key_words: int = KEY_WORDS,
    val_words: int = 2,
    hot_rows: int = 0,
) -> Dict[str, np.ndarray]:
    """A batch that exercises every lane of the merge-resolve, within the
    promises ``uniform_klen`` / ``seq32`` / ``key_words`` make about valid
    rows: keys of 1..4·key_words bytes from a small alphabet (shared
    prefixes), unique seqs (above 2^32 unless ``seq32``), u64 values of
    the full range, short (< 8 byte) PUT and MERGE values, PUT / MERGE /
    DELETE mixes that leave operand-only and DELETE-under-operand keys,
    and invalid rows holding random lanes, shuffled among the valid ones.
    ``hot_rows`` valid rows share one key (2^16 of them overflow the
    limb sums)."""
    if val_words < 2:
        raise ValueError("val_words must be >= 2 (8-byte counter values)")
    rng = np.random.default_rng(seed)
    n_valid = max(hot_rows, int(n * valid_frac))
    max_kl = 4 * key_words
    pool = max(1, (n_valid - hot_rows) // 4)
    pool_len = (np.full(pool, max_kl) if uniform_klen
                else rng.integers(1, max_kl + 1, pool))
    pool_bytes = rng.integers(97, 100, (pool, 24), dtype=np.uint8)
    pool_bytes[np.arange(24)[None, :] >= pool_len[:, None]] = 0
    ids = rng.integers(0, pool, n_valid)
    ids[:hot_rows] = 0
    key_buf = pool_bytes[ids]
    r = rng.random(n_valid)
    vtype = np.where(r < 0.5, _MERGE,
                     np.where(r < 0.8, _PUT, _DELETE)).astype(np.uint32)
    vals = rng.integers(0, 1 << 64, n_valid, dtype=np.uint64)
    val_len = np.full(n_valid, 8, dtype=np.uint32)
    short = (rng.random(n_valid) < 0.1) & (vtype != _DELETE)
    val_len[short] = rng.integers(1, 8, int(short.sum()))
    val_len[vtype == _DELETE] = 0
    val_buf = np.zeros((n_valid, 4 * val_words), dtype=np.uint8)
    val_buf[:, :8] = vals.astype("<u8").view(np.uint8).reshape(n_valid, 8)
    val_buf[np.arange(4 * val_words)[None, :] >= val_len[:, None]] = 0
    base = 1 if seq32 else (1 << 33) + 12345
    seqs = rng.permutation(n_valid).astype(np.uint64) + np.uint64(base)

    def garbage(shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(
            np.uint32)

    kw_be = garbage((n, 6))
    kw_be[:n_valid] = key_buf.view(">u4").astype(np.uint32).reshape(
        n_valid, 6)
    out = {
        "key_words_be": kw_be,
        "key_len": garbage(n),
        "seq_hi": garbage(n),
        "seq_lo": garbage(n),
        "vtype": rng.integers(0, 6, n, dtype=np.uint64).astype(np.uint32),
        "val_words": garbage((n, val_words)),
        "val_len": garbage(n),
        "valid": np.arange(n) < n_valid,
    }
    out["key_len"][:n_valid] = pool_len[ids]
    out["seq_hi"][:n_valid] = (seqs >> np.uint64(32)).astype(np.uint32)
    out["seq_lo"][:n_valid] = (seqs & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)
    out["vtype"][:n_valid] = vtype
    out["val_words"][:n_valid] = val_buf.view("<u4").reshape(
        n_valid, val_words)
    out["val_len"][:n_valid] = val_len
    perm = rng.permutation(n)
    out = {k: np.ascontiguousarray(v[perm]) for k, v in out.items()}
    out["key_words_le"] = np.ascontiguousarray(
        out["key_words_be"].astype(">u4").view("<u4").astype(np.uint32))
    return out
