"""Entry points of the port — counterpart of ``__graft_entry__.py``.

``entry(device)``       — the pipeline at the configuration of
                          ``__graft_entry__.entry()`` (capacity 2^12, planar
                          block encoding) and its example inputs on
                          ``device``.
``bench_model(device)`` — the bench configuration (``bench.py``): 2^17
                          entries per shard, 16-byte keys, 32-bit seqs,
                          planar block encoding; ``shards=8`` gives the
                          bench's 8 shards stacked on a leading axis, one
                          batched forward (``jax.vmap(model.forward)``,
                          ``bench.py:316``).

Both default to ``cuda`` and raise without it (``device="cpu"`` runs the
plain PyTorch path).
"""

from __future__ import annotations

from typing import Optional, Tuple

from .device import resolve_device
from .models import CompactionModel

BENCH_ENTRIES = 131072
BENCH_KEY_BYTES = 16
BENCH_VAL_BYTES = 8
BENCH_SHARDS = 8


def entry(device=None, seed: int = 0) -> Tuple[CompactionModel, tuple]:
    """(model, example_args) for the ``__graft_entry__.entry()``
    configuration."""
    dev = resolve_device(device)
    model = CompactionModel(capacity=1 << 12, emit_planar=True,
                            planar_block_entries=1024)
    return model, model.example_args(seed=seed, device=dev)


def bench_model(device=None, seed: int = 0, shards: Optional[int] = None
                ) -> Tuple[CompactionModel, tuple]:
    """(model, example_args) for the bench configuration: one shard's
    lanes, or with ``shards`` (the bench runs ``BENCH_SHARDS``) that many
    shards' lanes on a leading axis, shard s from seed ``seed + s``."""
    dev = resolve_device(device)
    model = CompactionModel(
        capacity=BENCH_ENTRIES, uniform_klen=True, seq32=True,
        key_words=BENCH_KEY_BYTES // 4, emit_planar=True,
        row_klen=BENCH_KEY_BYTES, row_vlen=BENCH_VAL_BYTES, val_words=2)
    return model, model.example_args(seed=seed, device=dev, shards=shards)
