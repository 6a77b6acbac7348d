"""The port imports neither JAX nor the JAX package, and its entry points
do not quietly run on the CPU when CUDA is missing; its engine seam
(``gpu/``, ``storage/``) compacts into a file, and its batched service
compacts shards, on the CPU with both blocked.

The import check runs in a subprocess, because this test process has
imported JAX already (tests/conftest.py)."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "rocksplicator_tpu_torch"

_CHILD = r'''
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "rocksplicator_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.cuda.is_available = lambda: False  # a host without CUDA

import rocksplicator_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "rocksplicator_tpu"))
assert not bad, bad
seam = {"gpu", "gpu.backend", "gpu.chunked", "gpu.format",
        "gpu.compaction_service", "storage.errors", "storage.merge",
        "storage.compaction", "storage.bloom", "storage.rlz",
        "storage.planar", "storage.sst", "storage.native_compaction",
        "utils.flags"}
missing = {m for m in seam if pkg.__name__ + "." + m not in names}
assert not missing, missing
print("IMPORTED", len(names))

from rocksplicator_tpu_torch.entry import bench_model, entry
from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
from rocksplicator_tpu_torch.models import CompactionModel
from rocksplicator_tpu_torch.gpu.compaction_service import (
    GpuCompactionService)
for call in (entry, bench_model, lambda: CompactionModel().example_args(),
             GpuCompactionBackend, GpuCompactionService,
             GpuCompactionService.instance):
    try:
        call()
    except RuntimeError as exc:
        assert "CUDA is not available" in str(exc), exc
    else:
        raise AssertionError("an entry point ran without CUDA")
model, args = entry(device="cpu")
out = model(*args)
assert int(out["count"]) > 0
print("RAISES_WITHOUT_CUDA")

# the engine seam on the CPU: merge two runs into a file and read it back
import struct, tempfile
from rocksplicator_tpu_torch.storage.merge import UInt64AddOperator
from rocksplicator_tpu_torch.storage.sst import SSTReader
pk = struct.Struct("<q").pack
runs = [[(b"k%03d" % i, 10 + i, 3, pk(i)) for i in range(50)],
        [(b"k%03d" % i, 1 + i % 9, 1, pk(100)) for i in range(50)]]
with tempfile.TemporaryDirectory() as d:
    outs = GpuCompactionBackend(device="cpu").merge_runs_to_files(
        runs, UInt64AddOperator(), True, lambda: d + "/out.tsst", 32768, 1,
        10, 1 << 20)
    assert [p for p, _ in outs] == [d + "/out.tsst"], outs
    reader = SSTReader(d + "/out.tsst")
    got = [(k, v) for k, _s, _t, v in reader.iterate()]
    reader.close()
assert got == [(b"k%03d" % i, pk(100 + i)) for i in range(50)], got[:3]
print("SEAM_ON_CPU")

# the batched service on the CPU: two shards in one call
from rocksplicator_tpu_torch.ops.kv_format import pack_entries
shards = [pack_entries(run) for run in runs]
res = GpuCompactionService(device="cpu").compact_shard_batch(shards)
assert [r["count"] for r in res] == [50, 50], res
assert res[1]["entries"][0][3] == pk(100), res[1]["entries"][0]
print("BATCH_ON_CPU")
rc = chip_smoke.main()
assert rc != 0, rc
print("SMOKE_REFUSES", rc)
'''


def _run_child():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", _CHILD], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_without_jax_and_refuses_cpu_fallback():
    res = _run_child()
    assert res.returncode == 0, res.stdout + res.stderr
    n = int(re.search(r"IMPORTED (\d+)", res.stdout).group(1))
    assert n >= 15, res.stdout
    assert "RAISES_WITHOUT_CUDA" in res.stdout
    assert "SEAM_ON_CPU" in res.stdout
    assert "BATCH_ON_CPU" in res.stdout
    assert "SMOKE_REFUSES" in res.stdout
    assert '"ok"' not in res.stdout


def test_port_sources_name_no_jax_module():
    """No import line of the package names jax or the JAX package."""
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|rocksplicator_tpu)(\.|\s|$)",
        re.MULTILINE)
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 15
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, (path, hits)


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory with nothing else of the repo exits
    non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
