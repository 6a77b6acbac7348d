"""The port's native host library (``storage/native``) against the JAX
package's: the same seeded numpy inputs through both bindings give equal
outputs on every call, tolerance 0. And the port's builds are locked:
threads that first use a library together build it once, the native
library and the kernel libraries alike (the compiler stubbed)."""

import os
import shutil
import subprocess
import threading
import time
import types

import numpy as np
import pytest

import rocksplicator_tpu.storage.native.binding as jax_binding
from rocksplicator_tpu.storage import planar as jax_planar
from rocksplicator_tpu.storage import wal as jax_wal
from rocksplicator_tpu.storage.records import WriteBatch
from rocksplicator_tpu_torch.ops import _build
from rocksplicator_tpu_torch.storage.native import binding

RNG_SEED = 11


@pytest.fixture(scope="module")
def libs():
    port, ref = binding.get_native(), jax_binding.get_native()
    assert port is not None and ref is not None
    assert port is not ref
    return port, ref


def _entries(rng, n=200, keys=60):
    keys_ = sorted({b"k%06d" % int(rng.integers(0, keys)) for _ in range(n)})
    out = []
    for k in keys_:
        for s in sorted(rng.choice(10_000, int(rng.integers(1, 4)),
                               replace=False), reverse=True):
            vt = int(rng.choice([1, 2, 3]))
            out.append((k, int(s), vt, b"" if vt == 2 else
                        rng.integers(0, 256, 8, dtype=np.uint8).tobytes()))
    return out


def test_crc_block_codec_and_lookups_match(libs):
    port, ref = libs
    rng = np.random.default_rng(RNG_SEED)
    data = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    assert port.crc32(data) == ref.crc32(data)
    entries = _entries(rng)
    cols = [list(c) for c in zip(*entries)]
    raw = port.encode_block(*cols)
    assert raw == ref.encode_block(*cols)
    assert port.decode_block(raw) == ref.decode_block(raw) == entries
    for key in {e[0] for e in entries} | {b"k", b"zz", b"k000030x"}:
        assert port.get_entries(raw, key) == ref.get_entries(raw, key)
    # a planar block of 16-byte keys and 8-byte values
    n = 300
    kw = np.zeros((n, 6), dtype=np.uint32)
    kw[:, 0], kw[:, 1] = 0x636F756E, 0x7465723A
    kw[:, 3] = np.sort(rng.choice(1 << 20, n, replace=False))
    vtype = rng.choice(np.array([1, 2, 3], dtype=np.uint32), n)
    arrays = {"key_words_be": kw, "key_len": np.full(n, 16, np.uint32),
              "seq_hi": np.zeros(n, np.uint32),
              "seq_lo": rng.integers(1, 1 << 30, n).astype(np.uint32),
              "vtype": vtype,
              "val_words": rng.integers(0, 1 << 32, (n, 2)).astype(
                  np.uint32),
              "val_len": np.where(vtype == 2, 0, 8).astype(np.uint32)}
    block = jax_planar.encode_planar_block(arrays, 0, n, 16, 8, True)
    for i in list(rng.integers(0, n, 20)) + [0, n - 1]:
        key = kw[i].astype(">u4").tobytes()[:16]
        assert port.planar_get_entries(block, key) == \
            ref.planar_get_entries(block, key)
    assert port.planar_get_entries(block, b"counter:") == \
        ref.planar_get_entries(block, b"counter:")


@pytest.mark.parametrize("uint64_add", [True, False])
@pytest.mark.parametrize("drop", [True, False])
def test_merge_resolve_matches(libs, uint64_add, drop):
    port, ref = libs
    rng = np.random.default_rng(RNG_SEED + 1)
    runs = []
    for r in range(3):
        n = 150
        kw = np.zeros((n, 6), dtype=np.uint32)
        kw[:, 1] = np.sort(rng.integers(0, 90, n))
        runs.append((kw, np.full(n, 8, np.uint32),
                     (np.arange(n, dtype=np.uint64) + 1000 * r)[::-1]
                     .copy(), rng.choice(np.array([1, 2, 3], np.uint8), n),
                     rng.integers(0, 1 << 32, (n, 2)).astype(np.uint32),
                     np.full(n, 8, np.uint32)))
    # each run sorted by (key asc, seq desc)
    runs = [tuple(a[np.lexsort((-c[2].astype(np.int64), c[0][:, 1]))]
                  for a in c) for c in runs]
    cat = [np.concatenate([c[i] for c in runs]) for i in range(6)]
    want = ref.merge_resolve(*cat, uint64_add, drop)
    got = port.merge_resolve(*cat, uint64_add, drop)
    offsets = np.array([0, 150, 300, 450], dtype=np.uint64)
    want_runs = ref.merge_resolve_runs(*cat, offsets, uint64_add, drop)
    got_runs = port.merge_resolve_runs(*cat, offsets, uint64_add, drop)
    for w, g in ((want, got), (want_runs, got_runs)):
        count = w[6]
        assert g[6] == count > 0
        for a, b in zip(w[:6], g[:6]):
            np.testing.assert_array_equal(a[:count], b[:count])


def test_rlz_wal_scan_and_bloom_match(libs, tmp_path):
    port, ref = libs
    rng = np.random.default_rng(RNG_SEED + 2)
    for data in (b"", b"abc", bytes(9000),
                 rng.integers(0, 4, 7000, dtype=np.uint8).tobytes(),
                 rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()):
        comp = port.rlz_compress(data)
        assert comp == ref.rlz_compress(data)
        assert port.rlz_decompress(comp, len(data)) == \
            ref.rlz_decompress(comp, len(data))
        assert port.rlz_decompress(comp, len(data) - 1) is \
            ref.rlz_decompress(comp, len(data) - 1)
    writer = jax_wal.WalWriter(str(tmp_path), 1 << 20)
    seq = 1
    for i in range(30):
        batch = WriteBatch().put(b"k%d" % i, b"v" * i).delete(b"x")
        writer.append(seq, batch.encode())
        seq += batch.count()
    writer.close()
    (seg,) = os.listdir(tmp_path)
    raw = (tmp_path / seg).read_bytes()
    assert port.wal_scan(raw) == ref.wal_scan(raw)
    torn = raw[:-9] + b"\x00" * 9
    assert port.wal_scan(torn) == ref.wal_scan(torn)
    keys = [rng.integers(0, 256, int(rng.integers(1, 40)),
                         dtype=np.uint8).tobytes() for _ in range(500)]
    words = {}
    for name, lib in (("port", port), ("ref", ref)):
        words[name] = np.zeros(157, dtype=np.uint32)
        lib.bloom_add_many(words[name], keys)
        buf = np.frombuffer(b"".join(keys[:50]), dtype=np.uint8)
        off = np.zeros(51, dtype=np.uint64)
        np.cumsum([len(k) for k in keys[:50]], out=off[1:])
        lib.bloom_add_concat(words[name], buf, off, 50)
    np.testing.assert_array_equal(words["port"], words["ref"])
    for key in keys[:40] + [b"absent-%d" % i for i in range(40)]:
        assert port.bloom_may_contain(words["port"], key) == \
            ref.bloom_may_contain(words["ref"], key)


def test_native_build_is_locked_and_honours_disable(monkeypatch, tmp_path):
    """8 threads first-use the native library with the compiler stubbed
    (it copies the built library after a pause): it compiles once and
    every thread gets the same library. RSTPU_DISABLE_NATIVE leaves the
    pure-Python paths."""
    built = binding.library_path()
    assert os.path.isfile(built)
    calls = []

    def compile_stub(cmd):
        calls.append(cmd)
        time.sleep(0.2)
        shutil.copyfile(built, cmd[cmd.index("-o") + 1])

    monkeypatch.setattr(binding, "_compile", compile_stub)
    monkeypatch.setattr(binding, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(binding, "_native", binding._UNSET)
    got = []
    start = threading.Barrier(8)

    def first_use():
        start.wait()
        got.append(binding.get_native())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    assert calls[0][1:-3] == ["-O3", "-fPIC", "-shared", "-std=c++17",
                              "-Wall"]
    assert len({id(lib) for lib in got}) == 1 and got[0] is not None
    assert binding.library_path().startswith(str(tmp_path))
    monkeypatch.setattr(binding, "_native", binding._UNSET)
    monkeypatch.setenv("RSTPU_DISABLE_NATIVE", "1")
    assert binding.get_native() is None


def test_kernel_build_is_locked(monkeypatch, tmp_path):
    """8 threads first-use one kernel library with nvcc stubbed: one
    compiler process runs, and one library is loaded for all."""
    procs = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **_kw):
            procs.append(cmd)
            with open(cmd[cmd.index("-o") + 1], "wb") as f:
                f.write(b"\x7fELF")

        def communicate(self):
            time.sleep(0.2)
            return "", None

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.rs_error_string = types.SimpleNamespace()
            self.rs_fused = types.SimpleNamespace()

    fake_ctypes = types.SimpleNamespace(CDLL=FakeLib, c_int=int,
                                        c_char_p=bytes)
    monkeypatch.setenv("NVCC", "nvcc-stub")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "ctypes", fake_ctypes)
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    got = []
    start = threading.Barrier(8)

    def first_use():
        start.wait()
        got.append(_build.load("fused_resolve", {"rs_fused": (int,)}))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(procs) == 1 and procs[0][0] == "nvcc-stub"
    assert len({id(lib) for lib in got}) == 1
    assert got[0].path == str(_build.library_path("fused_resolve"))
    assert got[0].rs_fused.restype is int
