"""The port's ``CompactionModel.forward`` (plain PyTorch path, on the CPU)
against the JAX ``CompactionModel.forward``, and end to end against the
JAX package's numpy compaction backend. Tolerance 0."""

import struct

import numpy as np
import pytest
import torch

from rocksplicator_tpu.models.compaction_model import (
    CompactionModel as JaxModel)
from rocksplicator_tpu.models.compaction_model import (
    synth_counter_batch as jax_synth)
from rocksplicator_tpu.ops.compaction_kernel import MergeKind as JMK
from rocksplicator_tpu.storage.merge import UInt64AddOperator
from rocksplicator_tpu.storage.records import OpType as JOpType
from rocksplicator_tpu.tpu.backend import NumpyCompactionBackend
from rocksplicator_tpu_torch.entry import bench_model, entry
from rocksplicator_tpu_torch.models.compaction_model import (
    FORWARD_ARGS, CompactionModel, synth_counter_batch, synth_mixed_batch)
from rocksplicator_tpu_torch.ops.compaction_kernel import MergeKind
from rocksplicator_tpu_torch.ops.kv_format import (pack_entries,
                                                   unpack_entries)
from rocksplicator_tpu_torch.storage.records import OpType

from torch_parity import (assert_same_outputs, jax_args, jax_out,
                          torch_args, torch_out)

pack64 = struct.Struct("<q").pack

ENTRY_CFG = dict(capacity=1 << 12, emit_planar=True,
                 planar_block_entries=1024)
BENCH_CFG = dict(capacity=4096, uniform_klen=True, seq32=True, key_words=4,
                 emit_planar=True, row_klen=16, row_vlen=8, val_words=2)


def _jax_cfg(cfg):
    cfg = dict(cfg)
    if "merge_kind" in cfg:
        cfg["merge_kind"] = JMK(cfg["merge_kind"].value)
    return cfg


@pytest.mark.parametrize("name,cfg,seed", [
    ("entry", ENTRY_CFG, 0),
    ("bench", BENCH_CFG, 1),
    ("rows", dict(capacity=2048, emit_rows=True, emit_planar=True,
                  row_klen=24, row_vlen=8, drop_tombstones=False), 2),
    ("no_merge_op", dict(capacity=1024, merge_kind=MergeKind.NONE), 3),
])
def test_forward_matches_jax(name, cfg, seed):
    batch = synth_counter_batch(cfg["capacity"], seed=seed)
    want = jax_out(JaxModel(**_jax_cfg(cfg)).forward(*jax_args(batch)))
    got = torch_out(CompactionModel(**cfg).forward(*torch_args(batch)))
    assert_same_outputs(want, got, name)


def test_forward_on_mixed_batch_matches_jax():
    batch = synth_mixed_batch(2048, seed=5)
    cfg = dict(capacity=2048, emit_planar=True, row_klen=24)
    want = jax_out(JaxModel(**cfg).forward(*jax_args(batch)))
    got = torch_out(CompactionModel(**cfg).forward(*torch_args(batch)))
    assert_same_outputs(want, got)


def test_forward_plain_and_backends_agree_on_cpu():
    model, args = bench_model(device="cpu")
    a = torch_out(model.forward_plain(*args))
    model.sort_backend = "bitonic"
    b = torch_out(model(*args))
    assert_same_outputs(a, b)
    assert a["count"] > 0 and not a["needs_cpu_fallback"]


@pytest.mark.parametrize("kwargs", [
    dict(n=4096, seed=0), dict(n=1000, seed=3, key_space=7, val_words=3,
                               key_bytes=9, start_seq=(1 << 32) - 5)])
def test_synth_counter_batch_is_bit_identical(kwargs):
    a, b = synth_counter_batch(**kwargs), jax_synth(**kwargs)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_example_args_match_jax():
    model, args = entry(device="cpu")
    want = JaxModel(**ENTRY_CFG).example_args(seed=0)
    assert len(args) == len(want) == len(FORWARD_ARGS)
    for w, g in zip(want, torch_out(dict(zip(FORWARD_ARGS, args))).values()):
        np.testing.assert_array_equal(w, g)
    assert model.num_bloom_words == JaxModel(**ENTRY_CFG).num_bloom_words


def test_bench_model_config():
    model, args = bench_model(device="cpu")
    assert (model.capacity, model.uniform_klen, model.seq32,
            model.key_words, model.emit_planar, model.row_klen,
            model.row_vlen, model.val_words) == (131072, True, True, 4, True,
                                                 16, 8, 2)
    assert model.sort_backend == "fused"
    assert args[0].shape == (131072, 6) and args[0].dtype == torch.int32


def test_model_is_a_module_without_parameters():
    model = CompactionModel(capacity=256)
    assert isinstance(model, torch.nn.Module)
    assert list(model.parameters()) == []
    with pytest.raises(ValueError):
        CompactionModel(sort_backend="pallas_fused")


def test_end_to_end_matches_numpy_backend():
    """Entry tuples → port pack → forward → unpack equals the JAX package's
    NumpyCompactionBackend().merge_runs on the same runs."""
    rng = np.random.default_rng(12)
    keys = [b"user:%04d" % i for i in range(60)]
    entries, seq = [], 1
    for _ in range(700):
        key = keys[int(rng.integers(len(keys)))]
        r = rng.random()
        if r < 0.6:
            entries.append((key, seq, OpType.MERGE,
                            pack64(int(rng.integers(-50, 50)))))
        elif r < 0.85:
            entries.append((key, seq, OpType.PUT,
                            pack64(int(rng.integers(0, 1000)))))
        else:
            entries.append((key, seq, OpType.DELETE, b""))
        seq += 1
    runs = [entries[i::3] for i in range(3)]
    runs = [sorted(r, key=lambda e: (e[0], -e[1])) for r in runs]
    for drop in (True, False):
        batch = pack_entries([e for r in runs for e in r], capacity=1024)
        model = CompactionModel(capacity=1024, drop_tombstones=drop)
        out = torch_out(model(*torch_args(
            {k: getattr(batch, k) for k in FORWARD_ARGS})))
        got = unpack_entries(out["key_words_be"], out["key_len"],
                             out["seq_hi"], out["seq_lo"], out["vtype"],
                             out["val_words"], out["val_len"], out["count"])
        jruns = [[(k, s, JOpType(int(t)), v) for k, s, t, v in r]
                 for r in runs]
        want = list(NumpyCompactionBackend().merge_runs(
            jruns, UInt64AddOperator(), drop))
        assert [(k, s, int(t), v) for k, s, t, v in got] == [
            (k, s, int(t), v) for k, s, t, v in want]


@pytest.mark.parametrize("name,cfg", [
    ("bench", dict(BENCH_CFG, capacity=1024, planar_block_entries=256)),
    ("rows_flags_off", dict(capacity=512, emit_rows=True, emit_planar=True,
                            row_klen=24, row_vlen=8, drop_tombstones=False)),
])
def test_batched_forward_matches_jax_vmap(name, cfg):
    """A leading shard axis: one ``forward`` over S = 3 shards against
    ``jax.vmap(model.forward)`` (``bench.py:316``), every output with the
    shard axis, and ``forward_plain`` (shard by shard) equal to it."""
    import jax

    shards = [synth_counter_batch(cfg["capacity"], seed=70 + s)
              for s in range(3)]
    batch = {k: np.stack([b[k] for b in shards]) for k in shards[0]}
    want = jax_out(jax.vmap(JaxModel(**_jax_cfg(cfg)).forward)(
        *jax_args(batch)))
    model = CompactionModel(**cfg)
    args = torch_args(batch)
    got = torch_out(model.forward(*args))
    assert want["count"].shape == (3,)
    assert_same_outputs(want, got, name)
    assert_same_outputs(want, torch_out(model.forward_plain(*args)), name)


def test_bench_model_gives_the_bench_shards():
    model, args = bench_model(device="cpu", shards=2)
    _, one = bench_model(device="cpu", seed=1)
    assert args[0].shape == (2, 131072, 6)
    for a, b in zip(args, one):
        assert torch.equal(a[1], b)
