"""The port's SST sink and source against the JAX package's: the same lanes
written by both give the same file bytes, the port reads the reference's
files back into the same lanes, and the codecs (RLZ1, the bloom bitmap)
give the same bytes. Tolerance 0.

The port's RLZ1 encoder is the reference's pure-Python one. The
reference's native encoder finds matches through a hashed table, so where
two 4-byte grams share a slot it writes other (equally valid) bytes; the
RLZ comparisons pin the reference to its Python codec, and check that
each package decodes the other's output."""

import os
import struct

import numpy as np
import pytest
import torch

from rocksplicator_tpu.storage import DB
from rocksplicator_tpu.storage import bloom as jax_bloom
from rocksplicator_tpu.storage import rlz as jax_rlz
from rocksplicator_tpu.storage.sst import SSTReader as JaxReader
from rocksplicator_tpu.storage.sst import SSTWriter as JaxWriter
from rocksplicator_tpu.tpu import format as jax_format
from rocksplicator_tpu_torch.gpu import format as gpu_format
from rocksplicator_tpu_torch.gpu.chunked import _batch_to_arrays
from rocksplicator_tpu_torch.ops.bloom import bloom_build
from rocksplicator_tpu_torch.ops.kv_format import pack_entries
from rocksplicator_tpu_torch.ops.lanes import lanes_from_numpy, u32_numpy
from rocksplicator_tpu_torch.storage import bloom, rlz
from rocksplicator_tpu_torch.storage.bloom import num_words_for
from rocksplicator_tpu_torch.storage.sst import (COMPRESSION_NONE,
                                                 COMPRESSION_RLZ,
                                                 COMPRESSION_ZLIB, SSTReader)

pack64 = struct.Struct("<q").pack
COMPRESSIONS = {"none": COMPRESSION_NONE, "zlib": COMPRESSION_ZLIB,
                "rlz": COMPRESSION_RLZ}


def _entries(n=2500, seed=0, seq64=False, deletes=True, klen=16):
    """Sorted entries with distinct keys: counter keys, 8-byte values,
    DELETE rows with no value."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(50 * n, n, replace=False))
    base = (1 << 32) + 5 if seq64 else 1
    seqs = base + rng.permutation(4 * n)[:n]
    kinds = rng.choice([1, 2, 3], n, p=[0.4, 0.2 if deletes else 0.0,
                                        0.4 if deletes else 0.6])
    out = []
    for i, s, vt in zip(ids, seqs, kinds):
        key = (b"counter:" + int(i).to_bytes(8, "big"))[:klen]
        value = b"" if vt == 2 else pack64(int(rng.integers(-1 << 40,
                                                            1 << 40)))
        out.append((key, int(s), int(vt), value))
    return out


def _lanes(**kw):
    arrays, n = _batch_to_arrays(pack_entries(_entries(**kw)))
    return arrays, n


def _k3_bitmap(arrays, n):
    """The bloom bitmap as the engine-seam backend builds it: K3's entry
    point on the lanes (its plain version on the CPU)."""
    t = lanes_from_numpy({"kw": arrays["key_words_le"],
                          "kl": arrays["key_len"]}, "cpu")
    return u32_numpy(bloom_build(t["kw"], t["kl"],
                                 torch.ones(n, dtype=torch.bool),
                                 num_words=num_words_for(n, 10)))


@pytest.mark.parametrize("bloom_from", ["host", "lanes"])
@pytest.mark.parametrize("seq64", [False, True])
@pytest.mark.parametrize("compression", sorted(COMPRESSIONS))
@pytest.mark.parametrize("planar", [True, False])
def test_write_sst_from_arrays_matches_reference(planar, compression, seq64,
                                                 bloom_from, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(jax_rlz, "_native", lambda: None)
    arrays, n = _lanes(seed=1, seq64=seq64, deletes=planar)
    kw = dict(block_entries=1024, compression=COMPRESSIONS[compression],
              bits_per_key=10, planar=planar)
    want_props = jax_format.write_sst_from_arrays(
        arrays, n, str(tmp_path / "want.tsst"), **kw)
    words = _k3_bitmap(arrays, n) if bloom_from == "lanes" else None
    got_props = gpu_format.write_sst_from_arrays(
        arrays, n, str(tmp_path / "got.tsst"), bloom_words=words, **kw)
    assert want_props is not None
    assert got_props == want_props
    assert (tmp_path / "got.tsst").read_bytes() == (
        tmp_path / "want.tsst").read_bytes()


def test_sinks_decline_non_uniform_rows(tmp_path):
    arrays, n = _batch_to_arrays(pack_entries(
        [(b"a", 1, 1, pack64(1)), (b"bb", 2, 1, pack64(2))]))
    for planar in (True, False):
        path = str(tmp_path / f"x{planar}.tsst")
        assert jax_format.write_sst_from_arrays(
            arrays, n, path, planar=planar) is None
        assert gpu_format.write_sst_from_arrays(
            arrays, n, path, planar=planar) is None
        assert not os.path.exists(path)


def _flush_written(path, global_seqno=None, entries=None):
    w = JaxWriter(path, block_bytes=4096, compression=COMPRESSION_ZLIB)
    for e in entries or _entries(n=1500, seed=3, deletes=False):
        w.add(*e)
    w.finish(global_seqno=global_seqno)


def _reference_file(kind, tmp_path):
    """A file the JAX package wrote, of one layout."""
    path = str(tmp_path / f"{kind}.tsst")
    if kind in ("planar_sink", "row_sink", "planar_ingested"):
        arrays, n = _lanes(seed=4, deletes=kind != "row_sink")
        assert jax_format.write_sst_from_arrays(
            arrays, n, path, block_entries=300,
            planar=kind != "row_sink") is not None
    if kind == "planar_ingested":
        # ingestion stamps a global seqno into the footer of the adopted
        # file
        db_dir = tmp_path / "db"
        with DB(str(db_dir)) as db:
            db.put(b"zzz", b"v")
            db.ingest_external_file([path])
        for name in os.listdir(db_dir):
            if name.endswith(".tsst"):
                r = JaxReader(str(db_dir / name))
                stamped = r.global_seqno is not None
                r.close()
                if stamped:
                    return str(db_dir / name)
        raise AssertionError("no ingested file carries a global seqno")
    if kind == "flush_written":
        _flush_written(path)
    if kind == "flush_written_global_seqno":
        _flush_written(path, global_seqno=(1 << 33) + 77)
    if kind == "non_uniform":
        _flush_written(path, entries=[(b"a", 2, 1, b"x"),
                                      (b"bbb", 1, 1, b"yy")])
    return path


@pytest.mark.parametrize("kind", [
    "planar_sink", "row_sink", "planar_ingested", "flush_written",
    "flush_written_global_seqno", "non_uniform"])
def test_read_sst_arrays_matches_reference(kind, tmp_path):
    path = _reference_file(kind, tmp_path)
    ref_reader = JaxReader(path)
    port_reader = SSTReader(path)
    try:
        assert port_reader.props == ref_reader.props
        assert port_reader.global_seqno == ref_reader.global_seqno
        assert list(port_reader.iterate()) == list(ref_reader.iterate())
        want = jax_format.read_sst_arrays(ref_reader)
        for reader in (ref_reader, port_reader):
            got = gpu_format.read_sst_arrays(reader)
            if want is None:
                assert got is None
                continue
            assert sorted(got) == sorted(want)
            for f in want:
                assert got[f].dtype == want[f].dtype, f
                np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    finally:
        ref_reader.close()
        port_reader.close()
    assert (want is None) == (kind == "non_uniform")
    if kind.endswith("global_seqno") or kind == "planar_ingested":
        seqs = (want["seq_hi"].astype(np.uint64) << np.uint64(32)) | \
            want["seq_lo"].astype(np.uint64)
        assert (seqs == ref_reader.global_seqno).all()


def _codec_inputs():
    rng = np.random.default_rng(9)
    arrays, n = _lanes(seed=5)
    block = jax_format.encode_uniform_block(arrays, 0, 500, 16, 8)
    return [b"", b"a", b"abcd" * 3, b"hello world, hello world, hello",
            bytes(70000), rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
            rng.integers(0, 3, 5000, dtype=np.uint8).tobytes(), block]


def test_rlz_matches_reference(monkeypatch):
    for data in _codec_inputs():
        comp = rlz.compress(data)
        assert comp == jax_rlz._py_compress(data)
        assert rlz.decompress(comp, len(data)) == data
        # with or without the reference's native codec loaded
        assert jax_rlz.decompress(comp, len(data)) == data
        assert rlz.decompress(jax_rlz.compress(data), len(data)) == data
    monkeypatch.setattr(jax_rlz, "_native", lambda: None)
    for data in _codec_inputs():
        assert rlz.compress(data) == jax_rlz.compress(data)
    with pytest.raises(ValueError):
        rlz.decompress(rlz.compress(b"hello world"), 5)


def test_bloom_filter_bytes_match_reference():
    rng = np.random.default_rng(2)
    keys = [rng.integers(0, 256, int(rng.integers(1, 40)),
                         dtype=np.uint8).tobytes() for _ in range(3000)]
    for bits in (10, 3):
        want = jax_bloom.BloomFilter.build(keys, bits)
        got = bloom.BloomFilter.build(keys, bits)
        assert got.to_bytes() == want.to_bytes()
        back = bloom.BloomFilter.from_bytes(want.to_bytes())
        assert back.num_words == want.num_words
        np.testing.assert_array_equal(back.words, want.words)
    for a, b in zip(bloom.hash_many(keys), jax_bloom.hash_many(keys)):
        np.testing.assert_array_equal(a, b)
    assert bloom.BloomFilter.build([]).to_bytes() == \
        jax_bloom.BloomFilter.build([]).to_bytes()
