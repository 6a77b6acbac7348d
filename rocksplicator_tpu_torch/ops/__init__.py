"""Ops of the compaction pipeline — counterpart of ``rocksplicator_tpu/ops``.

Three hand-written CUDA kernels for Hopper (``csrc/``) carry the path:
K1 the lane sort (``bitonic_sort.py``, a stable merge sort on the card
under the TPU kernel's name), K2 the fused merge-resolve
(``fused_resolve.py``) and K3 the bloom build (``bloom_kernel.py``). Each
sits beside its plain PyTorch version, which CPU tensors get.
"""

from .bloom import bloom_build
from .compaction_kernel import MergeKind, merge_resolve_kernel
from .kv_format import KEY_WORDS, KVBatch, pack_entries, unpack_entries

__all__ = [
    "KVBatch", "KEY_WORDS", "pack_entries", "unpack_entries",
    "merge_resolve_kernel", "MergeKind", "bloom_build",
]
