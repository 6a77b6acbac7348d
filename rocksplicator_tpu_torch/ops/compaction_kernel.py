"""Merge-resolve: k-way merge + LSM resolution — counterpart of
``rocksplicator_tpu/ops/compaction_kernel.py``.

A batch of concatenated runs becomes one merged, resolved run:

1. sort every entry by (invalid-last, key words BE asc, [key_len],
   [~seq_hi], ~seq_lo) — the composite order — with the payload lanes
   riding along;
2. key boundaries by adjacent compare, then per-segment aggregates;
3. LSM resolution per key: the newest PUT/DELETE wins, MERGE operands
   above it fold with the uint64-add operator as 16-bit-limb sums (exact
   below 2^16 operands per key; larger segments raise the
   ``needs_cpu_fallback`` flag);
4. stable stream compaction of the kept rows.

``merge_resolve_kernel`` is the entry point. On CPU tensors it runs the
plain PyTorch path (``merge_resolve_plain``); on CUDA tensors
``sort_backend`` picks the kernel: ``"fused"`` is kernel K2
(ops/fused_resolve.py, every phase on the card), ``"bitonic"`` is kernel
K1 (ops/bitonic_sort.py) for the sort and torch ops for phases 2-4. An
unknown backend or a shape the kernels cannot take raises.
``merge_resolve_batched`` is the counterpart of
``jax.vmap(merge_resolve_kernel)``: S shards in one K2 call, or one
segmented K1 call and a per-shard torch resolve.

u32 lanes are int32 views (ops/lanes.py): equality works on the views,
order and arithmetic on the widened int64 values, masked to 32 bits
wherever the JAX u32 arithmetic wraps.
"""

from __future__ import annotations

import enum
import logging
from typing import Callable, Dict, List, Optional

import torch

from ..utils.flags import FLAGS, define_flag
from .bitonic_sort import bitonic_sort_lanes, sort_lanes_plain
from .kv_format import KEY_WORDS
from .lanes import MASK32, bswap32, narrow, widen

log = logging.getLogger(__name__)

_PUT = 1
_DELETE = 2
_MERGE = 3

SORT_BACKENDS = ("fused", "bitonic")
# The JAX package's ``sort_backend`` flag values → this module's backends.
# Its "lax" (XLA sort + resolve, its default) has no counterpart on the
# card: the plain path never runs on CUDA tensors, so "lax" and any
# unknown value take K2.
_FLAG_TO_BACKEND = {"pallas_fused": "fused", "pallas": "bitonic"}

# The merge-resolve kernel of callers with no per-call choice (the engine
# seam, the batched service): pallas_fused -> K2, pallas -> K1 + torch
# resolve, lax -> K2. Env: RSTPU_FLAG_SORT_BACKEND (read at import);
# at run time: FLAGS.set("sort_backend", ...).
define_flag("sort_backend", "lax")

__all__ = [
    "MergeKind", "SORT_BACKENDS", "bswap32", "composite_key_lanes",
    "split_composite_lanes", "resolve_decisions", "resolve_sorted_lanes",
    "merge_resolve_plain", "merge_resolve_kernel", "merge_resolve_batched",
    "deployment_sort_backend",
]


def deployment_sort_backend() -> str:
    """The deployment-wide ``sort_backend`` for callers with no per-call
    choice (the engine-seam backend, the chunked merge, the batched
    service): the ``sort_backend`` flag's value at this call."""
    value = FLAGS.get("sort_backend")
    if value not in _FLAG_TO_BACKEND and value != "lax":
        log.warning("sort_backend flag %r is not one of lax, pallas, "
                    "pallas_fused: using K2", value)
    return _FLAG_TO_BACKEND.get(value, "fused")


class MergeKind(enum.Enum):
    NONE = "none"              # PUT/DELETE only
    UINT64_ADD = "uint64add"   # the counter operator


def composite_key_lanes(invalid, key_word_lanes, key_len, seq_hi, seq_lo,
                        *, uniform_klen: bool, seq32: bool):
    """The comparator lane order — (invalid-last, key words BE asc,
    [key_len], [~seq_hi], ~seq_lo) — as a lane list. ``~`` on an int32
    view gives the bits of the u32 complement."""
    keys = [invalid, *key_word_lanes]
    if not uniform_klen:
        keys.append(key_len)
    if not seq32:
        keys.append(~seq_hi)
    keys.append(~seq_lo)
    return keys


def split_composite_lanes(lanes, key_words: int, *, uniform_klen: bool,
                          seq32: bool):
    """Inverse of composite_key_lanes over reordered lanes. Returns
    (key_word_lanes, key_len_or_None, seq_hi_or_None, seq_lo, valid,
    next_pos); seq lanes are un-complemented."""
    pos = 1
    key_lanes = list(lanes[pos:pos + key_words])
    pos += key_words
    klen = None
    if not uniform_klen:
        klen = lanes[pos]
        pos += 1
    shi = None
    if not seq32:
        shi = ~lanes[pos]
        pos += 1
    slo = ~lanes[pos]
    pos += 1
    valid = lanes[0] == 0
    return key_lanes, klen, shi, slo, valid, pos


def _shift_prev(x: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i-1]; y[0] = 0/False."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _shift_next(x: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i+1]; y[n-1] = 0/False."""
    return torch.cat([x[1:], torch.zeros_like(x[:1])])


def _limb_combine(lo16_0, lo16_1, hi16_0, hi16_1):
    """Four u32 limb sums (int64) → (lo, hi) 64-bit value with carries;
    every intermediate wraps mod 2^32 as the JAX u32 ops do."""
    l0 = lo16_0 & 0xFFFF
    c0 = lo16_0 >> 16
    s1 = (lo16_1 + c0) & MASK32
    l1 = s1 & 0xFFFF
    c1 = s1 >> 16
    s2 = (hi16_0 + c1) & MASK32
    l2 = s2 & 0xFFFF
    c2 = s2 >> 16
    s3 = (hi16_1 + c2) & MASK32
    l3 = s3 & 0xFFFF
    return l0 | (l1 << 16), l2 | (l3 << 16)


def resolve_decisions(key_lanes, key_len, valid, vtype, val_len, vw_lanes,
                      *, merge_kind: MergeKind, drop_tombstones: bool,
                      uniform_klen: bool, key_words: int,
                      segment: Optional[int] = None):
    """Phases 2-3 on merge-ordered lanes: key boundaries and segmented LSM
    resolution. Returns ``(vtype, val_len, vw_lanes, keep,
    overflow_mask_or_None)``; ``keep`` marks each key's representative
    row, ``overflow_mask`` (UINT64_ADD only) marks valid rows whose segment
    has 2^16 rows or more. With ``segment`` (a shard axis) a key also
    starts at every shard start."""
    n = valid.shape[0]
    dev = valid.device
    iota = torch.arange(n, device=dev)
    vw_lanes = list(vw_lanes)
    segment = segment or n

    prev_equal = torch.ones(n, dtype=torch.bool, device=dev)
    for w in range(key_words):
        prev_equal &= key_lanes[w] == _shift_prev(key_lanes[w])
    if not uniform_klen:
        prev_equal &= key_len == _shift_prev(key_len)
    new_key = ~prev_equal | (iota % segment == 0) | ~valid
    last_key = _shift_next(new_key) | (iota % segment == segment - 1)

    is_put = (vtype == _PUT) & valid
    is_del = (vtype == _DELETE) & valid
    is_merge = (vtype == _MERGE) & valid
    is_base = is_put | is_del
    rep = new_key & valid

    overflow_mask = None
    if merge_kind is MergeKind.UINT64_ADD:
        # segment start / end of every row: a max-scan of the start index
        # forward, a min-scan of the end index backward
        start = torch.cummax(torch.where(new_key, iota, 0), 0).values
        end = torch.flip(torch.cummin(torch.flip(
            torch.where(last_key, iota, n), [0]), 0).values, [0])
        base_i = is_base.long()
        base_excl = torch.cumsum(base_i, 0) - base_i
        base_before = base_excl - base_excl[start]
        operand_mask = is_merge & (base_before == 0)
        first_base_mask = is_base & (base_before == 0)

        # values whose length is not exactly 8 parse as 0
        contrib = (operand_mask | (first_base_mask & is_put)) & (val_len == 8)
        lo = widen(vw_lanes[0])
        hi = widen(vw_lanes[1]) if len(vw_lanes) > 1 else torch.zeros_like(lo)
        zero = torch.zeros_like(lo)
        limbs = [
            torch.where(contrib, lo & 0xFFFF, zero),
            torch.where(contrib, lo >> 16, zero),
            torch.where(contrib, hi & 0xFFFF, zero),
            torch.where(contrib, hi >> 16, zero),
        ]

        def seg_total(x: torch.Tensor) -> torch.Tensor:
            # the row's segment total: prefix at the segment end minus the
            # prefix before the row (exact in int64; the limbs mask to the
            # JAX u32 wraparound below)
            pref = torch.cumsum(x, 0)
            return pref[end] - (pref - x)

        sums = [seg_total(x) & MASK32 for x in limbs]
        seg_has_operands = seg_total(operand_mask.long()) > 0
        seg_base_put = seg_total((first_base_mask & is_put).long()) > 0
        seg_base_del = seg_total((first_base_mask & is_del).long()) > 0
        seg_size = end - start + 1
        sum_lo, sum_hi = _limb_combine(*sums)

        folded = seg_has_operands
        vw_lanes[0] = torch.where(folded, narrow(sum_lo), vw_lanes[0])
        if len(vw_lanes) > 1:
            vw_lanes[1] = torch.where(folded, narrow(sum_hi), vw_lanes[1])
        val_len = torch.where(folded, torch.full_like(val_len, 8), val_len)
        pure_operands = seg_has_operands & ~seg_base_put & ~seg_base_del
        resolved_put = seg_base_put | (seg_has_operands & seg_base_del)
        out_vtype = torch.where(
            resolved_put | (pure_operands & drop_tombstones),
            torch.full_like(vtype, _PUT),
            torch.where(pure_operands, torch.full_like(vtype, _MERGE),
                        vtype))
        vtype = torch.where(rep, out_vtype, vtype)
        dropped = seg_base_del & ~seg_has_operands
        overflow_mask = (seg_size >= (1 << 16)) & valid
    else:
        dropped = is_del

    keep = rep & ~dropped if drop_tombstones else rep
    return vtype, val_len, vw_lanes, keep, overflow_mask


def resolve_sorted_lanes(
    key_lanes: List[torch.Tensor],      # key_words x (N,) int32
    key_len: Optional[torch.Tensor],    # None on the uniform_klen path
    seq_hi: Optional[torch.Tensor],     # None on the seq32 path
    seq_lo: torch.Tensor,
    valid: torch.Tensor,                # (N,) bool
    vtype: torch.Tensor,
    val_len: torch.Tensor,
    vw_lanes: List[torch.Tensor],
    klen_const: torch.Tensor,           # int32, 0-dim or (S,) (uniform_klen)
    *,
    merge_kind: MergeKind,
    drop_tombstones: bool,
    uniform_klen: bool,
    seq32: bool,
    key_words: int,
    segment: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Phases 2-4 on already merge-ordered lanes: boundaries, segmented
    resolution, stable stream compaction. Returns the output dict. With
    ``segment`` the rows are shards of ``segment`` rows, each compacted in
    place (shard s's kept rows at [s * segment, + count[s])); ``count``,
    ``needs_cpu_fallback`` and ``klen_const`` are then (S,)."""
    n = seq_lo.shape[0]
    dev = seq_lo.device
    n_val_words = len(vw_lanes)
    seq_hi = seq_hi if seq_hi is not None else torch.zeros_like(seq_lo)

    vtype, val_len, vw_lanes, keep, overflow_mask = resolve_decisions(
        key_lanes, key_len, valid, vtype, val_len, vw_lanes,
        merge_kind=merge_kind, drop_tombstones=drop_tombstones,
        uniform_klen=uniform_klen, key_words=key_words, segment=segment)
    iota = torch.arange(n, device=dev)
    if segment is None:
        overflow_risk = (overflow_mask.any() if overflow_mask is not None
                         else torch.zeros((), dtype=torch.bool, device=dev))
        # stable stream compaction: kept rows first, in their sorted order
        order = torch.sort((~keep).to(torch.int32), stable=True).indices
        count = keep.sum().to(torch.int32)
        live = iota < count
    else:
        shards = n // segment
        overflow_risk = (
            overflow_mask.view(shards, segment).any(1)
            if overflow_mask is not None
            else torch.zeros(shards, dtype=torch.bool, device=dev))
        # per shard: kept rows first, the shard's rows staying in place
        shard = iota // segment
        order = torch.sort(2 * shard + (~keep).to(torch.int64),
                           stable=True).indices
        count = keep.view(shards, segment).sum(1).to(torch.int32)
        live = iota % segment < count[shard]
        klen_const = klen_const[shard]

    def m1(a: torch.Tensor) -> torch.Tensor:
        return torch.where(live, a[order], torch.zeros_like(a))

    out_key_lanes = [m1(x) for x in key_lanes]
    out_seq_hi = torch.zeros_like(seq_lo) if seq32 else m1(seq_hi)
    if uniform_klen:
        out_key_len = torch.where(live, klen_const, torch.zeros_like(seq_lo))
    else:
        out_key_len = m1(key_len)
    zeros_tail = [torch.zeros_like(seq_lo)] * (KEY_WORDS - key_words)
    return {
        "key_words_be": torch.stack(out_key_lanes + zeros_tail, dim=1),
        "key_words_le": torch.stack(
            [bswap32(w) for w in out_key_lanes] + zeros_tail, dim=1),
        "key_len": out_key_len,
        "seq_hi": out_seq_hi,
        "seq_lo": m1(seq_lo),
        "vtype": m1(vtype),
        "val_words": torch.stack([m1(w) for w in vw_lanes], dim=1)
        if n_val_words else torch.zeros((n, 0), dtype=torch.int32,
                                        device=dev),
        "val_len": m1(val_len),
        "count": count,
        "needs_cpu_fallback": overflow_risk,
    }


def _merge_resolve(key_words_be, key_len, seq_hi, seq_lo, vtype, val_words,
                   val_len, valid, *, sort: Callable, merge_kind: MergeKind,
                   drop_tombstones: bool, uniform_klen: bool, seq32: bool,
                   key_words: int, segment: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """Composite sort with ``sort`` (lanes, num_keys, segment), then the
    torch resolve of phases 2-4, shard by shard with ``segment``."""
    n_val_words = val_words.shape[1]
    # uniform_klen reconstruction constant: the one valid key length (per
    # shard)
    klens = torch.where(valid, widen(key_len), 0)
    if segment is None:
        klen_const = narrow(klens.max())
    else:
        klen_const = narrow(klens.view(-1, segment).max(1).values)
    invalid = (~valid).to(torch.int32)
    operands = composite_key_lanes(
        invalid, [key_words_be[:, w] for w in range(key_words)],
        key_len, seq_hi, seq_lo, uniform_klen=uniform_klen, seq32=seq32)
    num_keys = len(operands)
    operands += [vtype, val_len] + [val_words[:, w]
                                    for w in range(n_val_words)]
    lanes = sort([x.contiguous() for x in operands], num_keys, segment)
    key_lanes, klen_s, shi_s, slo_s, valid_s, pos = split_composite_lanes(
        lanes, key_words, uniform_klen=uniform_klen, seq32=seq32)
    return resolve_sorted_lanes(
        key_lanes, klen_s, shi_s, slo_s, valid_s, lanes[pos],
        lanes[pos + 1], list(lanes[pos + 2:]), klen_const,
        merge_kind=merge_kind, drop_tombstones=drop_tombstones,
        uniform_klen=uniform_klen, seq32=seq32, key_words=key_words,
        segment=segment)


def check_lanes(key_words_be, key_len, seq_hi, seq_lo, vtype, val_words,
                val_len, valid, key_words: int) -> None:
    """Raise on lanes merge-resolve cannot take (dtype, shape, device)."""
    n = seq_lo.shape[0]
    dev = seq_lo.device
    named = {"key_len": key_len, "seq_hi": seq_hi, "seq_lo": seq_lo,
             "vtype": vtype, "val_len": val_len}
    for name, x in named.items():
        if x.dtype != torch.int32 or tuple(x.shape) != (n,):
            raise TypeError(f"{name}: expected ({n},) int32, got "
                            f"{tuple(x.shape)} {x.dtype}")
    if key_words_be.dtype != torch.int32 or tuple(
            key_words_be.shape) != (n, KEY_WORDS):
        raise TypeError(f"key_words_be: expected ({n}, {KEY_WORDS}) int32")
    if (val_words.dtype != torch.int32 or val_words.dim() != 2
            or val_words.shape[0] != n or val_words.shape[1] < 1):
        raise TypeError(f"val_words: expected ({n}, W>=1) int32")
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,):
        raise TypeError(f"valid: expected ({n},) bool")
    if not 1 <= key_words <= KEY_WORDS:
        raise ValueError(f"key_words {key_words} outside 1..{KEY_WORDS}")
    for x in (key_words_be, key_len, seq_hi, vtype, val_words, val_len,
              valid):
        if x.device != dev:
            raise ValueError(f"lanes on {x.device} and {dev}")


def merge_resolve_plain(key_words_be, key_len, seq_hi, seq_lo, vtype,
                        val_words, val_len, valid, *,
                        merge_kind: MergeKind = MergeKind.UINT64_ADD,
                        drop_tombstones: bool = True,
                        uniform_klen: bool = False, seq32: bool = False,
                        key_words: int = KEY_WORDS
                        ) -> Dict[str, torch.Tensor]:
    """The plain PyTorch merge-resolve, on any device: the reference the
    kernels are held against. Stable LSD sort, torch-op resolve, stable
    sort on ``not keep`` for the compaction."""
    check_lanes(key_words_be, key_len, seq_hi, seq_lo, vtype, val_words,
                val_len, valid, key_words)
    return _merge_resolve(
        key_words_be, key_len, seq_hi, seq_lo, vtype, val_words, val_len,
        valid, sort=sort_lanes_plain, merge_kind=merge_kind,
        drop_tombstones=drop_tombstones, uniform_klen=uniform_klen,
        seq32=seq32, key_words=key_words)


def merge_resolve_kernel(key_words_be, key_len, seq_hi, seq_lo, vtype,
                         val_words, val_len, valid, *,
                         merge_kind: MergeKind = MergeKind.UINT64_ADD,
                         drop_tombstones: bool = True,
                         uniform_klen: bool = False, seq32: bool = False,
                         key_words: int = KEY_WORDS,
                         sort_backend: str = "fused"
                         ) -> Dict[str, torch.Tensor]:
    """Merge + resolve a concatenated batch of runs (order-free input).

    Inputs: key_words_be (N, 6), key_len, seq_hi, seq_lo, vtype,
    val_words (N, W), val_len as int32 lane views; valid (N,) bool.
    Returns capacity-N outputs (first ``count`` rows live, the rest zero):
    key_words_be/le, key_len, seq_hi/lo, vtype, val_words, val_len, plus
    0-dim ``count`` (int32) and ``needs_cpu_fallback`` (bool).
    ``uniform_klen``/``seq32``/``key_words`` are caller-verified promises
    (ops/kv_format.fast_flags); results are identical either way.
    """
    if sort_backend not in SORT_BACKENDS:
        raise ValueError(f"sort_backend {sort_backend!r} is not one of "
                         f"{SORT_BACKENDS}")
    check_lanes(key_words_be, key_len, seq_hi, seq_lo, vtype, val_words,
                val_len, valid, key_words)
    flags = dict(merge_kind=merge_kind, drop_tombstones=drop_tombstones,
                 uniform_klen=uniform_klen, seq32=seq32, key_words=key_words)
    dev = seq_lo.device
    if dev.type == "cpu":
        return _merge_resolve(key_words_be, key_len, seq_hi, seq_lo, vtype,
                              val_words, val_len, valid,
                              sort=sort_lanes_plain, **flags)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if sort_backend == "fused":
        from .fused_resolve import fused_merge_resolve

        return fused_merge_resolve(key_words_be, key_len, seq_hi, seq_lo,
                                   vtype, val_words, val_len, valid, **flags)
    return _merge_resolve(key_words_be, key_len, seq_hi, seq_lo, vtype,
                          val_words, val_len, valid,
                          sort=bitonic_sort_lanes, **flags)


def merge_resolve_batched(key_words_be, key_len, seq_hi, seq_lo, vtype,
                          val_words, val_len, valid, *,
                          merge_kind: MergeKind = MergeKind.UINT64_ADD,
                          drop_tombstones: bool = True,
                          uniform_klen: bool = False, seq32: bool = False,
                          key_words: int = KEY_WORDS,
                          sort_backend: str = "fused"
                          ) -> Dict[str, torch.Tensor]:
    """Merge-resolve S shards of capacity C at once — the counterpart of
    ``jax.vmap(merge_resolve_kernel)``. Inputs carry a leading shard axis:
    key_words_be (S, C, 6), val_words (S, C, W), the other lanes (S, C);
    the static flags hold for every shard. Returns (S, C, ...) outputs,
    shard s's first ``count[s]`` rows live, with ``count`` (S,) int32 and
    ``needs_cpu_fallback`` (S,) bool.

    CPU tensors: ``merge_resolve_plain`` shard by shard (the plain
    version). CUDA tensors: ONE K2 call over the S * C rows
    (``"fused"``), or one segmented K1 sort and the torch resolve shard by
    shard in the same ops (``"bitonic"``); no loop over shards."""
    if sort_backend not in SORT_BACKENDS:
        raise ValueError(f"sort_backend {sort_backend!r} is not one of "
                         f"{SORT_BACKENDS}")
    if key_len.dim() != 2:
        raise TypeError(f"key_len: expected (S, C), got "
                        f"{tuple(key_len.shape)}")
    shards, cap = key_len.shape
    if shards < 1:
        raise ValueError("merge_resolve_batched needs at least one shard")
    flat = [x.reshape((shards * cap,) + tuple(x.shape[2:])) for x in (
        key_words_be, key_len, seq_hi, seq_lo, vtype, val_words, val_len,
        valid)]
    check_lanes(*flat, key_words)
    flags = dict(merge_kind=merge_kind, drop_tombstones=drop_tombstones,
                 uniform_klen=uniform_klen, seq32=seq32, key_words=key_words)
    dev = seq_lo.device
    if dev.type == "cpu":
        per = [merge_resolve_plain(*(x[s] for x in (
            key_words_be, key_len, seq_hi, seq_lo, vtype, val_words,
            val_len, valid)), **flags) for s in range(shards)]
        return {k: torch.stack([o[k] for o in per]) for k in per[0]}
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if sort_backend == "fused":
        from .fused_resolve import fused_merge_resolve

        out = fused_merge_resolve(*flat, segment=cap, **flags)
    else:
        out = _merge_resolve(*flat, sort=bitonic_sort_lanes, segment=cap,
                             **flags)
    return {k: v if k in ("count", "needs_cpu_fallback")
            else v.view((shards, cap) + tuple(v.shape[1:]))
            for k, v in out.items()}
