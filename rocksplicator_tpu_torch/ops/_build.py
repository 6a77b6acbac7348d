"""Build and load the hand-written CUDA kernels under ``ops/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, no ninja). Libraries go into ``rocksplicator_tpu_torch/_build/
<digest>/``, keyed on a hash of every source and the compiler flags, so an
edited source rebuilds and an unchanged one is loaded as built. Builds
happen on first use, never at import, under a lock (``load``);
``build_all`` starts one ``nvcc`` per source, all at once.

Every C entry point returns a ``cudaError_t`` (0 on success), checked with
``cudaGetLastError`` after each launch inside, or a negative code for an
argument it refuses before launching; ``check`` raises on any value but
0. There is no fallback: a kernel that does not build or does not launch
raises.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it; the
wrappers add one right after a successful launch and nowhere else.
``CUDA_LAUNCHES`` holds, per kernel, the CUDA launches (kernels and
memsets) of its last call, as its C entry point counted them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
KERNELS = ("bitonic_sort", "fused_resolve", "bloom_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
CUDA_LAUNCHES: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# first use happens on the engine's compaction threads and the batch
# compactor's pool at once: one thread builds and loads, the others wait
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str, cuda_launches: Optional[int] = None) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if cuda_launches is not None:
            CUDA_LAUNCHES[name] = cuda_launches


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if not found and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set NVCC or put the CUDA toolkit on PATH)")
    return found


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every kernel of ``names`` (default: all) that is not built
    yet, one ``nvcc`` each, all started together. Returns the compiler's
    ``-Xptxas -v`` report per kernel built now. Raises on any failure."""
    names = list(KERNELS if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if library_path(name).exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be.
    ``signatures`` maps each C function to its ctypes argument types; every
    function returns an int (a ``cudaError_t``). Locked, so threads that
    first use a kernel together build it once."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(library_path(name)))
                lib.rs_error_string.argtypes = [ctypes.c_int]
                lib.rs_error_string.restype = ctypes.c_char_p
                for fn, argtypes in signatures.items():
                    f = getattr(lib, fn)
                    f.argtypes = list(argtypes)
                    f.restype = ctypes.c_int
                _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: object) -> None:
    if rc != 0:
        msg = lib.rs_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
