"""The launch plans of the merge sort that kernels K1 and K2 share
(``ops/bitonic_sort.plan_sort``, ``ops/fused_resolve.plan_fused``): at
most 16 key lanes and any number of payload lanes (values of any width,
gathered 16 lanes a launch), segmented plans for a shard axis, and K2's
per-shard status words. And the contract K1 owes: a stable sort, equal to
its plain version and to a stable numpy ``lexsort`` when keys tie. The
kernels themselves run only on the card (``chip_smoke.py``); these tests
reach the arithmetic that surrounds them."""

import itertools

import numpy as np
import pytest

from rocksplicator_tpu_torch.ops.bitonic_sort import (
    GROUP, ITEMS, MAX_LANES, MAX_TILE, MIN_TILE, SMEM_LIMIT,
    bitonic_sort_lanes, gather_launches, plan_sort, sort_lanes_plain)
from rocksplicator_tpu_torch.ops.fused_resolve import (
    META_WORDS, RESOLVE_ROWS, STATUS_HEAD, fused_supported, plan_fused,
    sort_lane_count)
from rocksplicator_tpu_torch.ops.lanes import lanes_from_numpy, u32_numpy

SIZES = [256, 1 << 12, 1 << 17, 1 << 22]


def _looks(plan):
    """Look-back words: two scans, 10 words per tile, to a multiple of 4."""
    return -(-2 * plan.resolve_tiles * 10 // 4) * 4


@pytest.mark.parametrize("sorted_lanes", range(2, 18))
@pytest.mark.parametrize("n", SIZES)
def test_sort_plan(n, sorted_lanes):
    """Key lanes plus the index lane; as many payload lanes as fit."""
    num_keys = sorted_lanes - 1
    plan = plan_sort(n, num_keys, MAX_LANES - num_keys)
    tile = plan.tile
    assert tile & (tile - 1) == 0 and MIN_TILE <= tile <= min(n, MAX_TILE)
    assert plan.chunk & (plan.chunk - 1) == 0
    assert MIN_TILE <= plan.chunk <= tile
    assert plan.smem_bytes == (num_keys + 2) * tile * 4 <= SMEM_LIMIT
    assert 1 << plan.passes == n // tile
    assert plan.scratch_words == min(plan.passes, 2) * sorted_lanes * n
    assert plan.launches == 1 + plan.passes
    assert tile == min(n, MAX_TILE)   # the fewest merge passes
    assert tile // ITEMS <= 256


@pytest.mark.parametrize("n,num_keys,lanes,most", [
    (1 << 17, 6, 10, 12),     # bench shape
    (1 << 22, 10, 14, 16),    # the 2^22 job, every flag off
])
def test_sort_plan_launch_budget(n, num_keys, lanes, most):
    assert plan_sort(n, num_keys, lanes - num_keys).launches <= most


@pytest.mark.parametrize("n,num_keys,num_payload", [
    (300, 2, 1), (128, 2, 1), (1 << 12, 0, 3), (1 << 12, 17, 0),
    (1 << 12, 17, 3), (1 << 12, 2, -1),
])
def test_sort_plan_refuses(n, num_keys, num_payload):
    """17 key lanes still raise; payload lanes have no cap."""
    with pytest.raises(ValueError):
        plan_sort(n, num_keys, num_payload)


@pytest.mark.parametrize("w", [16, 64])
@pytest.mark.parametrize("n", [1 << 12, 1 << 17, 1 << 22])
def test_wide_value_plans(n, w):
    """16-byte keys, 32-bit seqs and W = 16 (64-byte values) or W = 64
    (256-byte values): 6 key lanes and 2 + W payload lanes, the first 16
    gathered by the last sort launch, the rest 16 a launch through the
    index lane the plan adds to the scratch."""
    payload = 2 + w
    sp = plan_sort(n, 6, payload)
    gathers = -(-(payload - GROUP) // GROUP)
    assert sp.gathers == gather_launches(payload) == gathers >= 1
    assert sp.launches == 1 + sp.passes + gathers
    assert sp.scratch_words == min(sp.passes, 2) * 7 * n + n
    plan = plan_fused(n, w, 4, uniform_klen=True, seq32=True)
    assert fused_supported(n, w)
    assert plan.lanes == sort_lane_count(w, 4, True, True) == 8 + w
    assert (plan.sort.num_keys, plan.sort.num_payload) == (6, payload)
    assert plan.launches == 3 + sp.launches
    assert plan.scratch_words == (plan.status_words + _looks(plan)
                                  + plan.lanes * n + 2 * 7 * n + n)


def test_payload_groups():
    assert [gather_launches(p) for p in (0, 1, 16, 17, 32, 33, 66)] == [
        0, 0, 0, 1, 1, 2, 4]


@pytest.mark.parametrize("segment", [256, 1024, 1 << 14, 1 << 17])
@pytest.mark.parametrize("shards", [1, 8])
def test_segmented_plan_stops_passes_at_the_segment(shards, segment):
    """S shards of C rows: the tile is at most C and the passes end at
    runs of C rows, so no run crosses a shard."""
    n = shards * segment
    plan = plan_sort(n, 6, 4, segment)
    assert plan.segment == segment
    assert plan.tile == min(segment, MAX_TILE)
    assert plan.tile << plan.passes == segment
    assert plan.launches == 1 + plan.passes
    assert plan.scratch_words == min(plan.passes, 2) * 7 * n
    if shards == 1:
        assert plan == plan_sort(n, 6, 4)


@pytest.mark.parametrize("n,segment", [
    (1 << 12, 300), (1 << 12, 128), (1 << 12, 1 << 13)])
def test_segmented_plan_refuses(n, segment):
    with pytest.raises(ValueError):
        plan_sort(n, 6, 4, segment)
    with pytest.raises(ValueError):
        plan_fused(n, 2, segment=segment)


@pytest.mark.parametrize("segment", [256, 1024, 2048, 1 << 17])
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_fused_plan_per_shard_status(shards, segment):
    """K2 over S shards: a resolve tile is at most one shard (min(C, 2048)
    rows), the status words hold the tile counter, each shard's meta
    (count, overflow flag, key length) and two flags per tile."""
    n = shards * segment
    if n & (n - 1):
        with pytest.raises(ValueError):
            plan_fused(n, 2, segment=segment)
        return
    plan = plan_fused(n, 2, segment=segment)
    rows = min(segment, RESOLVE_ROWS)
    assert (plan.shards, plan.resolve_rows) == (shards, rows)
    assert plan.resolve_tiles == n // rows
    assert (segment // rows) * shards == plan.resolve_tiles
    assert plan.status_words == -(-(STATUS_HEAD + META_WORDS * shards
                                    + 2 * plan.resolve_tiles) // 4) * 4
    assert plan.sort.segment == segment
    assert plan.launches == 3 + plan.sort.launches


@pytest.mark.parametrize("uniform_klen,seq32,key_words",
                         list(itertools.product((True, False), (True, False),
                                                (4, 6))))
@pytest.mark.parametrize("n", SIZES)
def test_fused_plan(n, uniform_klen, seq32, key_words):
    w = 2
    plan = plan_fused(n, w, key_words, uniform_klen, seq32)
    lanes = sort_lane_count(w, key_words, uniform_klen, seq32)
    num_keys = lanes - 2 - w
    sp = plan.sort
    assert (sp.n, sp.num_keys, sp.num_payload) == (n, num_keys, 2 + w)
    assert plan.lanes == lanes
    assert plan.resolve_tiles == -(-n // RESOLVE_ROWS)
    assert plan.status_words % 4 == 0
    assert plan.status_words >= 8 + 2 * plan.resolve_tiles
    assert plan.scratch_words == (plan.status_words + _looks(plan)
                                  + lanes * n + 2 * (num_keys + 1) * n)
    assert plan.launches == 3 + sp.launches
    if n == 1 << 17:
        assert plan.launches <= 20
    if n == 1 << 22:
        assert plan.launches <= 24


@pytest.mark.parametrize("n,w,key_words,uniform_klen,seq32", [
    (300, 2, 6, False, False),      # not a power of two
    (128, 2, 6, False, False),      # below the smallest tile
    (1 << 12, 0, 6, False, False),  # no value word
])
def test_fused_plan_refuses(n, w, key_words, uniform_klen, seq32):
    with pytest.raises(ValueError):
        plan_fused(n, w, key_words, uniform_klen, seq32)


def _tied_lanes(n, num_keys, seed):
    """Keys from a 3-value alphabet (high bit set on odd lanes), so most
    rows tie; payload lanes are distinct row numbers and random words."""
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 3, n).astype(np.uint32)
            | np.uint32(0x80000000) * np.uint32(i % 2)
            for i in range(num_keys)]
    payload = [rng.permutation(n).astype(np.uint32),
               rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)]
    return keys, payload


@pytest.mark.parametrize("n,num_keys", list(itertools.product(
    (256, 1 << 12), (1, 3, 6))))
def test_sort_is_stable_on_ties(n, num_keys):
    """With tied keys the payload order is fixed by stability:
    ``sort_lanes_plain`` (and so K1, which the card holds equal to it)
    equals a stable numpy lexsort."""
    keys, payload = _tied_lanes(n, num_keys, seed=n + num_keys)
    ops = keys + payload
    order = np.lexsort(keys[::-1])
    t = lanes_from_numpy({str(i): o for i, o in enumerate(ops)}, "cpu")
    lanes = [t[str(i)] for i in range(len(ops))]
    for got in (sort_lanes_plain(lanes, num_keys),
                bitonic_sort_lanes(lanes, num_keys)):
        for o, g in zip(ops, got):
            np.testing.assert_array_equal(o[order], u32_numpy(g))
