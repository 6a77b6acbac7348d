"""Merge of PRE-SORTED compaction runs — counterpart of
``rocksplicator_tpu/ops/merge_network.py``.

Real compaction inputs are already sorted: SSTs are sorted by
construction and memtable dumps iterate in key order. The JAX module
replaces the full sort of phase 1 with a bitonic merge tree over the R
sorted runs (log R · log L + log R (log R + 1) / 2 compare-exchange stages
of selects, where the full sort takes log M (log M + 1) / 2).

Here the same three functions, with the JAX module's names and
signatures:

- ``merge_sorted_lanes`` merges (.., R, L) int32 lane views. On CPU
  tensors it runs ``merge_lanes_plain``, a torch transcription of the
  JAX tree (the even/odd flip-concatenate and the half-cleaner cascade),
  so it equals the JAX output on every input, ties included. On CUDA
  tensors it launches kernel K1 (``ops/bitonic_sort.py``) entered at run
  length: ``presorted = L`` and ``segment = R · L``, so the merge sort
  skips its tile sort (for L >= its 2048-row tile) and log2(L / tile) of
  its merge passes. That is a STABLE merge: it equals ``sort_lanes_plain``
  on every input whose runs are sorted, and equals the bitonic tree
  wherever the composite order is total, or wherever every lane is a key
  lane (the tree swaps only rows that differ in their keys).
- ``merge_resolve_runs_kernel`` is ``merge_resolve_kernel`` for R sorted
  runs of L entries, with an optional leading shard axis (the counterpart
  of ``jax.vmap`` over it). CPU: ``merge_resolve_runs_plain``, the
  composite key lanes, the plain tree, then ``resolve_sorted_lanes``, as
  the JAX module does. CUDA: kernel K2
  (``ops/fused_resolve.py``) entered at run length. A stable merge of
  sorted runs is the stable sort of their concatenation, so K2 entered at
  L gives, bit for bit, what the full-sort K2 gives on every input whose
  runs are sorted, ties included. A shape the kernels do not take raises;
  there is no fallback.
- ``runs_are_sorted`` is the host check of the precondition (key asc,
  seq desc, valid rows a prefix of each run). Checking stays the caller's,
  as in the JAX package: this module never sorts runs that are not sorted.

R and L must be powers of two on every device (the JAX tree's rule).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .bitonic_sort import bitonic_sort_lanes
from .compaction_kernel import (MergeKind, check_lanes, composite_key_lanes,
                                resolve_sorted_lanes, split_composite_lanes)
from .kv_format import KEY_WORDS
from .lanes import narrow, u32_numpy, widen


def _lex_lt(a: Sequence[torch.Tensor],
            b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Lexicographic a < b over parallel int32 lane lists, unsigned."""
    lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones_like(lt)
    for aw, bw in zip(a, b):
        aw, bw = widen(aw), widen(bw)
        lt = lt | (eq & (aw < bw))
        eq = eq & (aw == bw)
    return lt


def _half_cleaner_cascade(lanes: List[torch.Tensor],
                          num_keys: int) -> List[torch.Tensor]:
    """Sort a bitonic sequence along the last axis: compare-exchange at
    strides M/2, M/4, .., 1. ``lanes[:num_keys]`` form the comparator;
    the rest ride."""
    m = lanes[0].shape[-1]
    step = m // 2
    while step >= 1:
        shp = tuple(lanes[0].shape)
        lead = shp[:-1]
        r = [x.reshape(lead + (m // (2 * step), 2, step)) for x in lanes]
        a = [x[..., 0, :] for x in r]
        b = [x[..., 1, :] for x in r]
        swap = _lex_lt(b[:num_keys], a[:num_keys])
        lanes = [torch.stack([torch.where(swap, y, x),
                              torch.where(swap, x, y)], dim=-2).reshape(shp)
                 for x, y in zip(a, b)]
        step //= 2
    return lanes


def _check_runs(lanes: Sequence[torch.Tensor]) -> tuple:
    r, m = lanes[0].shape[-2], lanes[0].shape[-1]
    # the half-cleaner strides m/2, .., 1 form a bitonic network only for
    # power-of-two lengths, and K1 merges power-of-two runs
    if r & (r - 1) or (m and m & (m - 1)):
        raise ValueError(
            f"merge network needs power-of-two runs/length, got ({r}, {m})")
    return r, m


def merge_lanes_plain(lanes: Sequence[torch.Tensor],
                      num_keys: int) -> List[torch.Tensor]:
    """The plain version, on any device: the JAX bitonic merge tree in
    torch ops, level by level (evens ++ flipped odds, then the half-cleaner
    cascade). Returns flat (.., R * L) lanes."""
    lanes = list(lanes)
    r, _ = _check_runs(lanes)
    while r > 1:
        evens = [x[..., 0::2, :] for x in lanes]
        odds = [torch.flip(x[..., 1::2, :], dims=[-1]) for x in lanes]
        lanes = [torch.cat([e, o], dim=-1) for e, o in zip(evens, odds)]
        lanes = _half_cleaner_cascade(lanes, num_keys)
        r //= 2
    return [x.reshape(tuple(x.shape[:-2]) + (-1,)) for x in lanes]


def merge_sorted_lanes(lanes: Sequence[torch.Tensor],
                       num_keys: int) -> List[torch.Tensor]:
    """Merge runs stacked on axis -2: each (.., R, L) int32 lane holds R
    runs individually sorted ascending along the last axis by the
    composite key ``lanes[:num_keys]`` (compared unsigned). R and L must
    be powers of two. Returns flat (.., R * L) lanes in merged order. CPU
    tensors: the plain tree. CUDA tensors: K1 entered at run length."""
    lanes = list(lanes)
    r, m = _check_runs(lanes)
    dev = lanes[0].device
    if dev.type == "cpu":
        return merge_lanes_plain(lanes, num_keys)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lead = tuple(lanes[0].shape[:-2])
    out = bitonic_sort_lanes([x.reshape(-1) for x in lanes], num_keys,
                             segment=r * m, presorted=m)
    return [x.view(lead + (r * m,)) for x in out]


def _run_lanes(lanes: tuple, key_words: int) -> tuple:
    """(shard_axis, shards, runs, length, flat lanes) of ([S,] R, L) run
    lanes, checked as merge-resolve takes them."""
    key_len = lanes[1]
    if key_len.dim() not in (2, 3):
        raise TypeError(f"key_len: expected ([S,] R, L), got "
                        f"{tuple(key_len.shape)}")
    shard_axis = key_len.dim() == 3
    runs, length = _check_runs([key_len])
    shards = key_len.shape[0] if shard_axis else 1
    n = shards * runs * length
    flat = [x.reshape((n,) + tuple(x.shape[key_len.dim():]))
            for x in lanes]
    check_lanes(*flat, key_words)
    return shard_axis, shards, runs, length, flat


def _shaped(out: Dict[str, torch.Tensor], shard_axis: bool, shards: int,
            segment: int) -> Dict[str, torch.Tensor]:
    if not shard_axis:
        return out
    return {k: v if k in ("count", "needs_cpu_fallback")
            else v.view((shards, segment) + tuple(v.shape[1:]))
            for k, v in out.items()}


def merge_resolve_runs_plain(
        key_words_be, key_len, seq_hi, seq_lo, vtype, val_words, val_len,
        valid, *, merge_kind: MergeKind = MergeKind.UINT64_ADD,
        drop_tombstones: bool = True, uniform_klen: bool = False,
        seq32: bool = False, key_words: int = KEY_WORDS
) -> Dict[str, torch.Tensor]:
    """The plain version of ``merge_resolve_runs_kernel``, on any device:
    the JAX module's body (the composite key lanes, the plain merge tree,
    ``resolve_sorted_lanes``, shard by shard on the flat rows when there
    is a shard axis)."""
    lanes = (key_words_be, key_len, seq_hi, seq_lo, vtype, val_words,
             val_len, valid)
    shard_axis, shards, runs, length, _ = _run_lanes(lanes, key_words)
    n_val_words = val_words.shape[-1]
    klens = torch.where(valid, widen(key_len), 0)
    if shard_axis:
        klen_const = narrow(klens.flatten(1).max(1).values)
    else:
        klen_const = narrow(klens.max())
    keys = composite_key_lanes(
        (~valid).to(torch.int32),
        [key_words_be[..., w] for w in range(key_words)],
        key_len, seq_hi, seq_lo, uniform_klen=uniform_klen, seq32=seq32)
    num_keys = len(keys)
    payload = [vtype, val_len] + [val_words[..., w]
                                  for w in range(n_val_words)]
    merged = [x.reshape(-1) for x in merge_lanes_plain(keys + payload,
                                                       num_keys)]
    key_lanes, klen_s, shi_s, slo_s, valid_s, pos = split_composite_lanes(
        merged, key_words, uniform_klen=uniform_klen, seq32=seq32)
    segment = runs * length
    out = resolve_sorted_lanes(
        key_lanes, klen_s, shi_s, slo_s, valid_s, merged[pos],
        merged[pos + 1], list(merged[pos + 2:]), klen_const,
        merge_kind=merge_kind, drop_tombstones=drop_tombstones,
        uniform_klen=uniform_klen, seq32=seq32, key_words=key_words,
        segment=segment if shard_axis else None)
    return _shaped(out, shard_axis, shards, segment)


def merge_resolve_runs_kernel(
    key_words_be: torch.Tensor,  # ([S,] R, L, 6) int32
    key_len: torch.Tensor,       # ([S,] R, L) int32
    seq_hi: torch.Tensor,
    seq_lo: torch.Tensor,
    vtype: torch.Tensor,
    val_words: torch.Tensor,     # ([S,] R, L, W) int32
    val_len: torch.Tensor,
    valid: torch.Tensor,         # ([S,] R, L) bool, a valid prefix per run
    *,
    merge_kind: MergeKind = MergeKind.UINT64_ADD,
    drop_tombstones: bool = True,
    uniform_klen: bool = False,
    seq32: bool = False,
    key_words: int = KEY_WORDS,
) -> Dict[str, torch.Tensor]:
    """``merge_resolve_kernel`` for R PRE-SORTED runs of L entries each,
    with an optional leading shard axis S (each shard merged and resolved
    on its own). Same outputs, of capacity R · L a shard: without a shard
    axis (R · L, ..) lanes with 0-dim ``count`` and
    ``needs_cpu_fallback``; with one, (S, R · L, ..) lanes and (S,) counts
    and flags, as ``jax.vmap`` gives them. Each run must be sorted by (key
    asc, seq desc) with its valid rows a prefix; R and L powers of two.
    CPU tensors: ``merge_resolve_runs_plain``. CUDA tensors: K2 entered
    at run length, or ``ValueError`` for a shape it does not take."""
    lanes = (key_words_be, key_len, seq_hi, seq_lo, vtype, val_words,
             val_len, valid)
    flags = dict(merge_kind=merge_kind, drop_tombstones=drop_tombstones,
                 uniform_klen=uniform_klen, seq32=seq32, key_words=key_words)
    dev = seq_lo.device
    if dev.type == "cpu":
        return merge_resolve_runs_plain(*lanes, **flags)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .fused_resolve import fused_merge_resolve

    shard_axis, shards, runs, length, flat = _run_lanes(lanes, key_words)
    segment = runs * length
    out = fused_merge_resolve(*flat, segment=segment if shard_axis else None,
                              presorted=length, **flags)
    return _shaped(out, shard_axis, shards, segment)


def _host(x) -> np.ndarray:
    """A lane as numpy: int32 tensors as their uint32 bits."""
    return u32_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def runs_are_sorted(key_words_be, key_len, seq_hi, seq_lo, valid) -> bool:
    """Host-side (numpy) check that every run is sorted by the composite
    (key asc, seq desc) with valid rows a prefix: the precondition of the
    merge network. Takes numpy uint32 / bool arrays or int32 / bool
    tensors, (R, L) runs (any leading axes). O(total entries)."""
    valid = _host(valid)
    length = valid.shape[-1] if valid.ndim else 0
    valid = valid.reshape(-1, length)
    # valid must be a prefix of each run
    if length and not (valid[:, :-1] | ~valid[:, 1:]).all():
        return False
    if length < 2:
        return True
    kw = _host(key_words_be).reshape(valid.shape + (-1,))
    # the full comparator (no fast-path reductions): a run sorted by it is
    # sorted by any reduced variant too, because the dropped lanes are
    # constant under the fast-path promises
    lanes = [np.where(valid, np.uint32(0), np.uint32(1)),
             *(kw[:, :, w] for w in range(kw.shape[2])),
             _host(key_len).reshape(valid.shape),
             ~_host(seq_hi).reshape(valid.shape),
             ~_host(seq_lo).reshape(valid.shape)]
    lt = np.zeros((valid.shape[0], length - 1), dtype=bool)
    eq = np.ones_like(lt)
    for lane in lanes:
        a, b = lane[:, :-1], lane[:, 1:]
        lt |= eq & (a < b)
        eq &= a == b
    return bool((lt | eq).all())
