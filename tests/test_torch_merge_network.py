"""The port's merge of pre-sorted runs (``ops/merge_network.py``) against
the JAX package's (``rocksplicator_tpu/ops/merge_network.py``): the same
numpy inputs through both, tolerance 0 (integer lanes). The cases mirror
the JAX package's own (``tests/test_tpu_ops.py``, the merge network
section), then add tied keys with payload lanes, a shard axis against
``jax.vmap``, and the launch plans K1 and K2 take when entered at run
length. On the CPU the port runs its plain tree; the kernels run on the
card (``chip_smoke.py``'s ``merge_network`` phase)."""

import random
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rocksplicator_tpu.ops import merge_network as jmn
from rocksplicator_tpu.ops.compaction_kernel import MergeKind as JMergeKind
from rocksplicator_tpu.ops.kv_format import pack_entries
from rocksplicator_tpu.storage.records import OpType
from rocksplicator_tpu_torch.ops import merge_network as tmn
from rocksplicator_tpu_torch.ops.bitonic_sort import (bitonic_sort_lanes,
                                                      plan_sort,
                                                      sort_lanes_plain)
from rocksplicator_tpu_torch.ops.compaction_kernel import (
    MergeKind, merge_resolve_kernel)
from rocksplicator_tpu_torch.ops.fused_resolve import plan_fused
from rocksplicator_tpu_torch.ops.kv_format import (
    unpack_entries as t_unpack_entries)
from rocksplicator_tpu_torch.ops.lanes import lanes_from_numpy, u32_numpy

from torch_parity import assert_same_outputs, jax_out, torch_out

pack64 = struct.Struct("<q").pack
LANES = ("key_words_be", "key_len", "seq_hi", "seq_lo", "vtype",
         "val_words", "val_len", "valid")


def _pack_runs(runs, run_capacity):
    """Per-run entry lists -> stacked (R, L) numpy lanes + valid matrix."""
    batches = [pack_entries(r, capacity=run_capacity) for r in runs]
    return {f: np.stack([getattr(b, f) for b in batches]) for f in LANES}


def _split_sorted_runs(entries, n_runs, rng):
    """Entries dealt to runs at random; each run sorted (key asc, seq
    desc), the precondition real SST and memtable runs satisfy."""
    runs = [[] for _ in range(n_runs)]
    for e in entries:
        runs[rng.randrange(n_runs)].append(e)
    return [sorted(r, key=lambda e: (e[0], -e[1])) for r in runs]


def _both(lanes, merge_kind="uint64add", jax_fn=None, **flags):
    """The JAX kernel and the port's on the same numpy lanes; both
    packages' verdicts on the precondition first."""
    names = ("key_words_be", "key_len", "seq_hi", "seq_lo", "valid")
    # the JAX check takes (R, L) runs: a shard at a time
    shards = ([lanes] if lanes["valid"].ndim == 2 else
              [{k: lanes[k][s] for k in names}
               for s in range(lanes["valid"].shape[0])])
    assert all(jmn.runs_are_sorted(*(sh[k] for k in names))
               for sh in shards)
    assert tmn.runs_are_sorted(*(lanes[k] for k in names))
    jfn = jax_fn or jmn.merge_resolve_runs_kernel
    want = jax_out(jfn(*(jnp.asarray(lanes[k]) for k in LANES),
                       merge_kind=JMergeKind(merge_kind), **flags))
    t = lanes_from_numpy(lanes, "cpu")
    got = torch_out(tmn.merge_resolve_runs_kernel(
        *(t[k] for k in LANES), merge_kind=MergeKind(merge_kind), **flags))
    return want, got


def _entries_of(out):
    return t_unpack_entries(out["key_words_be"], out["key_len"],
                            out["seq_hi"], out["seq_lo"], out["vtype"],
                            out["val_words"], out["val_len"], out["count"])


def _full_sort(entries, capacity, merge_kind="uint64add", **flags):
    """The port's full-sort merge_resolve_kernel on the concatenation."""
    b = pack_entries(entries, capacity=capacity)
    t = lanes_from_numpy({k: getattr(b, k) for k in LANES}, "cpu")
    return _entries_of(torch_out(merge_resolve_kernel(
        *(t[k] for k in LANES), merge_kind=MergeKind(merge_kind), **flags)))


@pytest.mark.parametrize("merge_kind,drop", [
    ("uint64add", True), ("uint64add", False), ("none", True),
    ("none", False)])
def test_merge_network_matches_jax_and_full_sort(merge_kind, drop):
    rng = random.Random(42)
    entries = []
    for seq in range(1, 501):
        k = f"key{rng.randrange(60):04d}".encode()
        r = rng.random()
        if merge_kind == "none":
            vt = OpType.PUT if r < 0.8 else OpType.DELETE
        else:
            vt = (OpType.MERGE if r < 0.5
                  else OpType.PUT if r < 0.85 else OpType.DELETE)
        v = b"" if vt == OpType.DELETE else pack64(rng.randrange(1000))
        entries.append((k, seq, vt, v))
    full = _full_sort(entries, 1024, merge_kind, drop_tombstones=drop)
    for n_runs in (1, 2, 4, 8):
        runs = _split_sorted_runs(entries, n_runs, random.Random(n_runs))
        cap = 1
        while cap < max(len(r) for r in runs):
            cap *= 2
        want, got = _both(_pack_runs(runs, cap), merge_kind,
                          drop_tombstones=drop)
        assert_same_outputs(want, got, f"n_runs={n_runs}")
        assert _entries_of(got) == full, f"n_runs={n_runs}"


def test_merge_network_fast_flags_match_jax():
    rng = random.Random(7)
    entries = [(f"k{rng.randrange(40):06d}".encode(), i + 1, OpType.MERGE,
                pack64(i)) for i in range(300)]
    flags = dict(uniform_klen=True, seq32=True, key_words=2)
    runs = _split_sorted_runs(entries, 4, rng)
    want, got = _both(_pack_runs(runs, 128), **flags)
    assert_same_outputs(want, got)
    assert _entries_of(got) == _full_sort(entries, 512)


def test_merge_network_uneven_and_empty_runs():
    entries = [(b"a", 3, OpType.PUT, pack64(1)),
               (b"b", 2, OpType.DELETE, b""),
               (b"c", 1, OpType.PUT, pack64(2))]
    runs = [sorted(entries, key=lambda e: (e[0], -e[1])), []]
    want, got = _both(_pack_runs(runs, 4))
    assert_same_outputs(want, got)
    assert _entries_of(got) == _full_sort(entries, 8)


def _violations():
    ok = _pack_runs([[(b"a", 2, OpType.PUT, b"x"),
                      (b"a", 1, OpType.PUT, b"y"),  # same key: seq desc
                      (b"b", 9, OpType.PUT, b"z")]], 4)
    bad_key = _pack_runs([[(b"b", 1, OpType.PUT, b"x"),
                           (b"a", 2, OpType.PUT, b"y")]], 2)
    bad_seq = _pack_runs([[(b"a", 1, OpType.PUT, b"x"),
                           (b"a", 2, OpType.PUT, b"y")]], 2)
    # valid rows must form a prefix (a hole breaks run order)
    hole = _pack_runs([[(b"a", 1, OpType.PUT, b"x")]], 2)
    hole["valid"][0] = np.array([False, True])
    return [(ok, True), (bad_key, False), (bad_seq, False), (hole, False)]


@pytest.mark.parametrize("case", range(4))
def test_runs_are_sorted_detects_violations(case):
    """Both packages' verdicts, on numpy arrays and on the port's lane
    tensors alike."""
    lanes, verdict = _violations()[case]
    names = ("key_words_be", "key_len", "seq_hi", "seq_lo", "valid")
    assert jmn.runs_are_sorted(*(lanes[k] for k in names)) is verdict
    assert tmn.runs_are_sorted(*(lanes[k] for k in names)) is verdict
    t = lanes_from_numpy({k: lanes[k] for k in names}, "cpu")
    assert tmn.runs_are_sorted(*(t[k] for k in names)) is verdict


@pytest.mark.parametrize("shape", [(2, 6), (3, 4)])
def test_merge_network_rejects_non_pow2_shapes(shape):
    with pytest.raises(ValueError):
        jmn.merge_sorted_lanes([jnp.zeros(shape, jnp.uint32)], 1)
    with pytest.raises(ValueError):
        tmn.merge_sorted_lanes([torch.zeros(shape, dtype=torch.int32)], 1)
    r, m = shape
    lanes = {"key_words_be": np.zeros((r, m, 6), np.uint32),
             "val_words": np.zeros((r, m, 2), np.uint32),
             "valid": np.zeros((r, m), bool),
             **{k: np.zeros((r, m), np.uint32) for k in (
                 "key_len", "seq_hi", "seq_lo", "vtype", "val_len")}}
    t = lanes_from_numpy(lanes, "cpu")
    with pytest.raises(ValueError):
        tmn.merge_resolve_runs_kernel(*(t[k] for k in LANES))


def _tied_runs(seed, runs, length, num_keys, payload, lead=()):
    """(lead.., R, L) u32 lanes: keys from a 3-value alphabet with the
    high bit on odd lanes (most rows tie), each run sorted stably by its
    keys; payload lanes of random words ride along."""
    rng = np.random.default_rng(seed)
    shape = lead + (runs, length)
    keys = [(rng.integers(0, 3, shape).astype(np.uint32)
             | np.uint32(0x80000000) * np.uint32(i % 2))
            for i in range(num_keys)]
    pay = [rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
           for _ in range(payload)]
    flat = [x.reshape(-1, length) for x in keys + pay]
    for row in range(flat[0].shape[0]):
        order = np.lexsort([k[row] for k in reversed(flat[:num_keys])])
        for x in flat:
            x[row] = x[row][order]
    return [x.reshape(shape) for x in flat]


@pytest.mark.parametrize("runs,length,num_keys,payload", [
    (8, 64, 2, 3), (4, 32, 3, 0), (2, 128, 1, 5), (16, 16, 2, 2)])
def test_merge_sorted_lanes_matches_jax_on_ties(runs, length, num_keys,
                                                payload):
    """Tied keys and payload lanes: the tree is not stable, and the port's
    plain tree must swap exactly where the JAX tree swaps."""
    lanes = _tied_runs(runs * length, runs, length, num_keys, payload)
    want = [np.asarray(x) for x in jax.jit(
        jmn.merge_sorted_lanes, static_argnums=1)(
            [jnp.asarray(x) for x in lanes], num_keys)]
    t = lanes_from_numpy({str(i): x for i, x in enumerate(lanes)}, "cpu")
    got = tmn.merge_sorted_lanes([t[str(i)] for i in range(len(lanes))],
                                 num_keys)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32_numpy(g), w)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_merge_of_key_lanes_equals_the_stable_sort(lead):
    """Every lane a key lane (the profile's tree_only): the tree's output
    equals the stable sort's, which is what K1 entered at run length
    computes on the card; K1's wrapper on CPU tensors, told the runs are
    sorted, gives the same."""
    runs, length = 8, 32
    lanes = _tied_runs(5, runs, length, 4, 0, lead)
    t = lanes_from_numpy({str(i): x for i, x in enumerate(lanes)}, "cpu")
    ops = [t[str(i)] for i in range(4)]
    got = tmn.merge_sorted_lanes(ops, 4)
    flat = [x.reshape(-1) for x in ops]
    want = sort_lanes_plain(flat, 4, runs * length)
    k1 = bitonic_sort_lanes(flat, 4, runs * length, presorted=length)
    for g, w, k in zip(got, want, k1):
        assert torch.equal(g.reshape(-1), w)
        assert torch.equal(k, w)


def test_shard_axis_matches_jax_vmap():
    """2 shards x 8 runs x 64 entries against jax.vmap of the JAX kernel:
    (S, R * L) lanes, (S,) counts and flags."""
    rng = random.Random(11)
    shards = []
    for s in range(2):
        entries = []
        for seq in range(1, 300 + 50 * s):
            k = f"s{s}k{rng.randrange(50):03d}".encode()
            r = rng.random()
            vt = (OpType.MERGE if r < 0.5
                  else OpType.PUT if r < 0.85 else OpType.DELETE)
            v = b"" if vt == OpType.DELETE else pack64(rng.randrange(1000))
            entries.append((k, seq, vt, v))
        shards.append(_pack_runs(_split_sorted_runs(
            entries, 8, random.Random(s)), 64))
    lanes = {k: np.stack([sh[k] for sh in shards]) for k in LANES}

    def jax_shards(*a, merge_kind, **flags):
        return jax.vmap(lambda *x: jmn.merge_resolve_runs_kernel(
            *x, merge_kind=merge_kind, **flags))(*a)

    for drop in (True, False):
        want, got = _both(lanes, jax_fn=jax_shards, drop_tombstones=drop)
        assert got["count"].shape == (2,)
        assert got["key_len"].shape == (2, 512)
        assert_same_outputs(want, got, f"drop={drop}")


# ---- launch plans: K1 and K2 entered at run length -------------------

# the full sort's plans as the card ran them before (PERF.md kernel
# table): (n, num_keys, payload, segment) -> (K1 launches, K2 launches)
FULL_SORT = {
    (1 << 20, 6, 4, 1 << 17): (7, 10),  # the bench, 8 x 2^17 batched
    (1 << 17, 6, 4, None): (7, 10),     # 2^17, bench flags
    (1 << 22, 10, 4, None): (12, 15),   # 2^22, flags off
    (1 << 23, 6, 4, 1 << 20): (10, 13),  # service 8 x 2^20
    (1 << 17, 6, 18, None): (8, 11),    # W = 16
}


@pytest.mark.parametrize("case", sorted(FULL_SORT))
def test_presorted_none_keeps_the_full_sort_plans(case):
    n, num_keys, payload, segment = case
    k1, k2 = FULL_SORT[case]
    plan = plan_sort(n, num_keys, payload, segment)
    assert plan == plan_sort(n, num_keys, payload, segment, None)
    assert (plan.launches, plan.tile_sorts, plan.presorted) == (k1, 1, 0)
    flags = ((6, False, False) if num_keys == 10 else (4, True, True))
    fused = plan_fused(n, payload - 2, *flags, segment=segment)
    assert fused == plan_fused(n, payload - 2, *flags, segment=segment,
                               presorted=None)
    assert fused.launches == k2
    assert fused.sort == plan


@pytest.mark.parametrize("runs,k1,k2", [(8, 3, 6), (32, 5, 8)])
def test_plans_at_run_length_at_the_bench_shape(runs, k1, k2):
    """8 shards x 2^17, runs of 2^17 / R: no tile_sort, log2(R) passes.
    K1 on the 6-lane tree_only and with 4 payload lanes; K2 memset +
    build + passes + resolve."""
    seg = 1 << 17
    length = seg // runs
    for payload in (0, 4):
        plan = plan_sort(8 * seg, 6, payload, seg, presorted=length)
        assert (plan.tile_sorts, plan.passes, plan.launches) == (
            0, runs.bit_length() - 1, k1)
        assert plan.scratch_words == min(plan.passes - 1, 2) * 7 * 8 * seg
    fused = plan_fused(8 * seg, 2, 4, True, True, segment=seg,
                       presorted=length)
    assert (fused.sort.tile_sorts, fused.launches) == (0, k2)
    assert fused.scratch_words == plan_fused(8 * seg, 2, 4, True, True,
                                             segment=seg).scratch_words


@pytest.mark.parametrize("length", [1, 4, 8, 64, 1024, 2048, 4096])
def test_presorted_plan_arithmetic(length):
    """Runs shorter than the tile take the full sort's plan; runs of a
    tile or more drop the tile_sort launch and start the passes there; a
    run as long as the segment still takes one (copy) pass."""
    n, seg = 1 << 14, 1 << 12
    plan = plan_sort(n, 3, 2, seg, presorted=length)
    full = plan_sort(n, 3, 2, seg)
    if length < full.tile:
        assert plan == full
    else:
        assert (plan.presorted, plan.tile_sorts) == (length, 0)
        assert plan.passes == max(1, (seg // length).bit_length() - 1)
        assert plan.launches == plan.passes
        assert plan.scratch_words == min(plan.passes - 1, 2) * 4 * n
    assert plan_fused(n, 2, segment=seg, presorted=length).launches == (
        3 + plan_sort(n, 10, 4, seg, presorted=length).launches)


@pytest.mark.parametrize("length", [0, 3, 6, 1 << 13])
def test_presorted_plan_refuses(length):
    with pytest.raises(ValueError):
        plan_sort(1 << 14, 3, 2, 1 << 12, presorted=length)
    with pytest.raises(ValueError):
        plan_fused(1 << 14, 2, segment=1 << 12, presorted=length)
