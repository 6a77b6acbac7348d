"""PyTorch/CUDA port of the compaction pipeline of ``rocksplicator_tpu``.

The package mirrors ``rocksplicator_tpu``'s paths and public names, so each
module's counterpart is found by path. It imports ``torch`` and numpy and
nothing of JAX or of the JAX package: constants and helpers it shares with
that package are kept here as copies.

u32 lanes are carried as ``torch.int32`` tensors that are bit-for-bit views
of numpy ``uint32`` arrays (see ``ops/lanes.py``). Entry points run on the
card unless the caller asks for the CPU (``device="cpu"``), where every
kernel's plain PyTorch version runs instead.
"""

# Arm the lock-order watchdog from the environment before any module of
# the package constructs a lock (module-level locks are built when their
# module is imported, which follows this line), and before torch is
# imported. Nothing is patched when RSTPU_LOCKWATCH is unset. Child
# processes inherit the variable and arm themselves here.
import os as _os

if _os.environ.get("RSTPU_LOCKWATCH"):
    from .testing import lockwatch as _lockwatch

    _lockwatch.maybe_install()

from .device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
