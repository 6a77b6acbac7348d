"""The port's bloom build (plain PyTorch version of kernel K3, on the CPU)
against the JAX package: ``bloom_build_tpu``, the Pallas hash kernel in
interpret mode, and the storage ``BloomFilter``. Tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rocksplicator_tpu.ops import bloom_tpu as jbloom
from rocksplicator_tpu.ops.pallas_kernels import bloom_hash_pallas
from rocksplicator_tpu.storage import bloom as jsbloom
from rocksplicator_tpu_torch.ops import bloom as tbloom
from rocksplicator_tpu_torch.ops.kv_format import pack_entries
from rocksplicator_tpu_torch.ops.lanes import lanes_from_numpy, u32_numpy
from rocksplicator_tpu_torch.storage import bloom as tsbloom
from rocksplicator_tpu_torch.storage.records import OpType


def _lanes(n, seed, valid_frac=0.8):
    rng = np.random.default_rng(seed)
    kw = rng.integers(0, 1 << 32, (n, 6), dtype=np.uint64).astype(np.uint32)
    kl = rng.integers(0, 25, n, dtype=np.uint64).astype(np.uint32)
    kl[:3] = 0xFFFFFFFF
    valid = rng.random(n) < valid_frac
    return kw, kl, valid


@pytest.mark.parametrize("n,num_words", [(256, 1), (1000, 77), (4096, 1280)])
def test_bloom_build_plain_matches_jax(n, num_words):
    kw, kl, valid = _lanes(n, seed=num_words)
    want = np.asarray(jbloom.bloom_build_tpu(
        jnp.asarray(kw), jnp.asarray(kl), jnp.asarray(valid),
        num_words=num_words))
    t = lanes_from_numpy({"kw": kw, "kl": kl, "v": valid}, "cpu")
    got = tbloom.bloom_build_plain(t["kw"], t["kl"], t["v"],
                                   num_words=num_words)
    np.testing.assert_array_equal(want, u32_numpy(got))
    # the dispatcher sends CPU tensors to the plain version
    np.testing.assert_array_equal(want, u32_numpy(tbloom.bloom_build(
        t["kw"], t["kl"], t["v"], num_words=num_words)))


def test_bloom_build_invalid_rows_set_nothing():
    kw, kl, _ = _lanes(512, seed=1)
    t = lanes_from_numpy({"kw": kw, "kl": kl,
                          "v": np.zeros(512, bool)}, "cpu")
    assert not tbloom.bloom_build_plain(t["kw"], t["kl"], t["v"],
                                        num_words=64).any()


def test_bloom_hash_pair_matches_pallas_interpret():
    kw, kl, _ = _lanes(1000, seed=2)
    h1, h2 = bloom_hash_pallas(jnp.asarray(kw), jnp.asarray(kl),
                               interpret=True)
    t = lanes_from_numpy({"kw": kw, "kl": kl}, "cpu")
    g1, g2 = tbloom.bloom_hash_pair(t["kw"], t["kl"])
    np.testing.assert_array_equal(np.asarray(h1), u32_numpy(g1))
    np.testing.assert_array_equal(np.asarray(h2), u32_numpy(g2))


def test_bloom_word_mask_matches_jax():
    kw, kl, _ = _lanes(700, seed=3)
    wi, m = jbloom.bloom_word_mask(jnp.asarray(kw), jnp.asarray(kl), 333)
    t = lanes_from_numpy({"kw": kw, "kl": kl}, "cpu")
    gi, gm = tbloom.bloom_word_mask(t["kw"], t["kl"], 333)
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())
    np.testing.assert_array_equal(np.asarray(m), u32_numpy(gm))


def test_bloom_matches_storage_bloom_filter():
    """Byte-identical to the JAX package's host BloomFilter for the same
    keys (24-byte prefix + length hash)."""
    keys = [f"key-{i}".encode() for i in range(1500)] + [b"", b"x" * 24]
    entries = [(k, i + 1, OpType.PUT, b"") for i, k in enumerate(keys)]
    batch = pack_entries(entries, capacity=2048)
    words = tsbloom.num_words_for(len(keys))
    t = lanes_from_numpy({"kw": batch.key_words_le, "kl": batch.key_len,
                          "v": batch.valid}, "cpu")
    got = u32_numpy(tbloom.bloom_build_plain(t["kw"], t["kl"], t["v"],
                                             num_words=words))
    want = jsbloom.BloomFilter(words)
    for k in keys:
        want.add(k)
    np.testing.assert_array_equal(want.words, got)


def test_bloom_constants_match_jax():
    for name in ("PREFIX_BYTES", "K_BITS", "_FNV_OFFSET", "_FNV_PRIME",
                 "_H2_MUL"):
        assert getattr(tsbloom, name) == getattr(jsbloom, name), name
    for n, b in ((0, 10), (1, 10), (131072, 10), (4096, 7)):
        assert tsbloom.num_words_for(n, b) == jsbloom.num_words_for(n, b)


def test_bloom_build_batched_matches_jax_vmap():
    """S = 3 shards' bitmaps in one call against ``jax.vmap`` of
    ``bloom_build_tpu`` with each shard's rows valid below its count."""
    import jax

    kws, kls = zip(*[_lanes(512, seed=60 + s)[:2] for s in range(3)])
    kw, kl = np.stack(kws), np.stack(kls)
    count = np.array([0, 200, 512], dtype=np.int32)
    valid = np.arange(512)[None, :] < count[:, None]
    want = np.asarray(jax.vmap(lambda a, b, c: jbloom.bloom_build_tpu(
        a, b, c, num_words=77))(jnp.asarray(kw), jnp.asarray(kl),
                                jnp.asarray(valid)))
    t = lanes_from_numpy({"kw": kw, "kl": kl}, "cpu")
    got = tbloom.bloom_build_batched(t["kw"], t["kl"],
                                     torch.from_numpy(count), num_words=77)
    assert got.shape == (3, 77)
    np.testing.assert_array_equal(want, u32_numpy(got))
    assert not want[0].any()
