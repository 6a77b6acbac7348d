"""The port's numpy lane format and its torch lane views against the JAX
package (``ops/kv_format.py``, ``ops/compaction_kernel.bswap32``)."""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rocksplicator_tpu.ops import kv_format as jkv
from rocksplicator_tpu.ops.compaction_kernel import bswap32 as jax_bswap32
from rocksplicator_tpu.storage.records import OpType as JOpType
from rocksplicator_tpu_torch.ops import kv_format as tkv
from rocksplicator_tpu_torch.ops.lanes import (bswap32, lanes_from_numpy,
                                               lanes_to_numpy, mul32, narrow,
                                               u32_numpy, widen)
from rocksplicator_tpu_torch.storage.records import OpType

pack64 = struct.Struct("<q").pack


def _entries(seed, n=120, max_klen=24, val_bytes=8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = bytes(rng.integers(0, 256, int(rng.integers(0, max_klen + 1)),
                                 dtype=np.uint8))
        vt = [OpType.PUT, OpType.DELETE, OpType.MERGE][int(rng.integers(3))]
        value = b"" if vt == OpType.DELETE else bytes(
            rng.integers(0, 256, int(rng.integers(0, val_bytes + 1)),
                         dtype=np.uint8))
        out.append((key, int(rng.integers(0, 1 << 63)), vt, value))
    return out


@pytest.mark.parametrize("seed,capacity,val_bytes",
                         [(0, None, 8), (1, 256, 8), (2, 128, 16)])
def test_pack_entries_matches_jax(seed, capacity, val_bytes):
    entries = _entries(seed, val_bytes=val_bytes)
    a = tkv.pack_entries(entries, capacity=capacity, val_bytes=val_bytes)
    b = jkv.pack_entries(entries, capacity=capacity, val_bytes=val_bytes)
    for field in tkv.LANE_FIELDS + ("valid",):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
        assert getattr(a, field).dtype == getattr(b, field).dtype
    assert a.capacity == b.capacity and a.val_bytes == b.val_bytes
    assert a.num_valid() == b.num_valid()
    assert a.payload_bytes() == b.payload_bytes()


def test_unpack_entries_matches_jax():
    entries = _entries(3)
    b = jkv.pack_entries(entries, capacity=200)
    args = (b.key_words_be, b.key_len, b.seq_hi, b.seq_lo, b.vtype,
            b.val_words, b.val_len, len(entries))
    got = tkv.unpack_entries(*args)
    want = jkv.unpack_entries(*args)
    assert [(k, s, int(t), v) for k, s, t, v in got] == [
        (k, s, int(t), v) for k, s, t, v in want]
    assert got[0][2] is OpType(int(want[0][2]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_flags_matches_jax(seed):
    rng = np.random.default_rng(seed)
    entries = _entries(seed, max_klen=int(rng.integers(1, 25)))
    if seed == 1:  # uniform keys, 32-bit seqs
        entries = [(b"k%07d" % i, i + 1, t, v)
                   for i, (_k, _s, t, v) in enumerate(entries)]
    b = jkv.pack_entries(entries, capacity=256)
    assert tkv.fast_flags(b.key_len, b.seq_hi, b.valid) == jkv.fast_flags(
        b.key_len, b.seq_hi, b.valid)


def test_pack_rejects_oversize_like_jax():
    for bad in ([(b"x" * 25, 1, OpType.PUT, b"")],
                [(b"x", 1, OpType.PUT, b"v" * 9)]):
        with pytest.raises(tkv.UnsupportedBatch):
            tkv.pack_entries(bad)
        with pytest.raises(jkv.UnsupportedBatch):
            jkv.pack_entries(bad)
    with pytest.raises(tkv.UnsupportedBatch):
        tkv.pack_entries(_entries(4, n=10), capacity=5)


def test_constants_match_jax():
    assert tkv.KEY_BYTES == jkv.KEY_BYTES and tkv.KEY_WORDS == jkv.KEY_WORDS
    assert tkv.LANE_FIELDS == jkv.LANE_FIELDS
    assert tkv.VAL_BYTES_DEFAULT == jkv.VAL_BYTES_DEFAULT
    assert {o.name: int(o) for o in OpType} == {
        o.name: int(o) for o in JOpType}


def test_lanes_roundtrip_keeps_bits():
    arr = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                   dtype=np.uint32)
    batch = {"a": arr, "m": np.array([True, False, True, True, False])}
    lanes = lanes_from_numpy(batch, "cpu")
    assert lanes["a"].dtype == torch.int32 and lanes["m"].dtype == torch.bool
    back = lanes_to_numpy(lanes)
    np.testing.assert_array_equal(back["a"], arr)
    assert back["a"].dtype == np.uint32
    np.testing.assert_array_equal(widen(lanes["a"]).numpy(),
                                  arr.astype(np.int64))
    np.testing.assert_array_equal(u32_numpy(narrow(widen(lanes["a"]))), arr)
    with pytest.raises(TypeError):
        lanes_from_numpy({"x": arr.astype(np.int64)}, "cpu")


def test_bswap32_matches_jax():
    rng = np.random.default_rng(5)
    arr = np.concatenate([
        rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32),
        np.array([0, 0xFFFFFFFF, 0x80000000, 0x000000FF], np.uint32)])
    want = np.asarray(jax_bswap32(jnp.asarray(arr)))
    got = u32_numpy(bswap32(lanes_from_numpy({"a": arr}, "cpu")["a"]))
    np.testing.assert_array_equal(want, got)


def test_mul32_wraps_like_u32():
    rng = np.random.default_rng(6)
    a = np.concatenate([
        rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32),
        np.full(4, 0xFFFFFFFF, np.uint32)])
    b = np.concatenate([
        rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32),
        np.array([0xFFFFFFFF, 1, 0, 0x80000001], np.uint32)])
    with np.errstate(over="ignore"):
        want = a * b
    t = lanes_from_numpy({"a": a, "b": b}, "cpu")
    got = u32_numpy(narrow(mul32(widen(t["a"]), widen(t["b"]))))
    np.testing.assert_array_equal(want, got)
