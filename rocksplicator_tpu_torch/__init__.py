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

from .device import resolve_device

__all__ = ["resolve_device"]
