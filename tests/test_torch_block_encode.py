"""The port's block encoding and checksums (torch ops, on the CPU) against
the JAX package's ``ops/block_encode.py`` and ``utils/checksum.py``,
including words of 0xFFFFFFFF where ``w + 1`` wraps to 0. Tolerance 0."""

import numpy as np
import pytest

import jax.numpy as jnp

from rocksplicator_tpu.ops import block_encode as jbe
from rocksplicator_tpu.storage.sst import ENTRY_FIXED_OVERHEAD
from rocksplicator_tpu.utils import checksum as jchk
from rocksplicator_tpu_torch.ops import block_encode as tbe
from rocksplicator_tpu_torch.ops.lanes import lanes_from_numpy, u32_numpy
from rocksplicator_tpu_torch.utils import checksum as tchk


def _out_lanes(n, seed, saturate=False):
    rng = np.random.default_rng(seed)

    def u32(shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(
            np.uint32)

    lanes = {"key_words_be": u32((n, 6)), "seq_hi": u32(n),
             "seq_lo": u32(n), "vtype": rng.integers(
                 0, 4, n, dtype=np.uint64).astype(np.uint32),
             "val_words": u32((n, 2))}
    if saturate:
        for k in lanes:
            lanes[k][: n // 3] = 0xFFFFFFFF
    return lanes


@pytest.mark.parametrize("seq32,klen,vlen,saturate", [
    (True, 16, 8, False), (False, 24, 8, True), (True, 5, 3, True),
    (False, 1, 8, False)])
def test_planar_words_and_checksums_match_jax(seq32, klen, vlen, saturate):
    n, block = 4096, 1024
    lanes = _out_lanes(n, seed=klen, saturate=saturate)
    args = ("key_words_be", "seq_hi", "seq_lo", "vtype", "val_words")
    want = jbe.encode_planar_words_tpu(
        *[jnp.asarray(lanes[k]) for k in args], klen=klen, vlen=vlen,
        seq32=seq32, block_entries=block)
    want_chk = np.asarray(jbe.planar_checksums_tpu(want))
    t = lanes_from_numpy(lanes, "cpu")
    got = tbe.encode_planar_words(*[t[k] for k in args], klen=klen,
                                  vlen=vlen, seq32=seq32,
                                  block_entries=block)
    np.testing.assert_array_equal(np.asarray(want), u32_numpy(got))
    np.testing.assert_array_equal(want_chk,
                                  u32_numpy(tbe.planar_checksums(got)))


def test_planar_checksum_of_saturated_words():
    words = np.full((3, 777), 0xFFFFFFFF, np.uint32)
    words[1, ::2] = 0xFFFFFFFE
    want = np.asarray(jbe.planar_checksums_tpu(jnp.asarray(words)))
    got = u32_numpy(tbe.planar_checksums(
        lanes_from_numpy({"w": words}, "cpu")["w"]))
    np.testing.assert_array_equal(want, got)
    assert got[0] == 0  # every (w + 1) wraps to 0
    for i in range(3):
        assert int(got[i]) == tchk.poly_checksum_words(words[i])
        assert int(got[i]) == jchk.poly_checksum_words(words[i])


@pytest.mark.parametrize("n,block", [(1000, 256), (512, 512), (300, 128)])
def test_rows_and_block_checksums_match_jax(n, block):
    lanes = _out_lanes(n, seed=n, saturate=True)
    args = ("key_words_be", "seq_hi", "seq_lo", "vtype", "val_words")
    want_rows = jbe.encode_rows_tpu(*[jnp.asarray(lanes[k]) for k in args],
                                    klen=16, vlen=8)
    want_chk = np.asarray(jbe.block_checksums_tpu(want_rows,
                                                  block_entries=block))
    t = lanes_from_numpy(lanes, "cpu")
    rows = tbe.encode_rows(*[t[k] for k in args], klen=16, vlen=8)
    np.testing.assert_array_equal(np.asarray(want_rows), rows.numpy())
    assert rows.shape[1] == ENTRY_FIXED_OVERHEAD + 16 + 8
    np.testing.assert_array_equal(
        want_chk, u32_numpy(tbe.block_checksums(rows, block_entries=block)))


def test_encode_and_checksum_matches_jax():
    n, count = 600, 450
    lanes = _out_lanes(n, seed=9)
    want_rows, want_chk = jbe.encode_and_checksum(lanes, count, 16, 8, 128)
    got_rows, got_chk = tbe.encode_and_checksum(
        lanes_from_numpy(lanes, "cpu"), count, 16, 8, 128)
    np.testing.assert_array_equal(want_rows, got_rows)
    np.testing.assert_array_equal(want_chk, got_chk)
    assert got_chk.dtype == np.uint32


def test_host_checksums_match_jax():
    rng = np.random.default_rng(1)
    data = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    assert tchk.poly_checksum(data) == jchk.poly_checksum(data)
    assert tchk.poly_checksum(data, 4096) == jchk.poly_checksum(data, 4096)
    words = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    assert tchk.poly_checksum_words(words, 512) == \
        jchk.poly_checksum_words(words, 512)
    assert tchk.CHK_R == jchk.CHK_R
    assert ENTRY_FIXED_OVERHEAD == tbe.ENTRY_FIXED_OVERHEAD
