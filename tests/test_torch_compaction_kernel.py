"""The port's merge-resolve (plain PyTorch path, on the CPU) against the
JAX package's ``merge_resolve_kernel`` (lax path), its fused Pallas kernel
and its bitonic Pallas sort (interpret mode). Tolerance 0."""

import itertools
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rocksplicator_tpu.ops import compaction_kernel as jck
from rocksplicator_tpu.ops.kv_format import pack_entries as jax_pack
from rocksplicator_tpu.storage.compaction import CpuCompactionBackend
from rocksplicator_tpu.storage.merge import UInt64AddOperator
from rocksplicator_tpu.storage.records import OpType as JOpType
from rocksplicator_tpu_torch.models.compaction_model import (
    FORWARD_ARGS, synth_counter_batch, synth_mixed_batch)
from rocksplicator_tpu_torch.ops import compaction_kernel as tck
from rocksplicator_tpu_torch.ops.bitonic_sort import (bitonic_sort_lanes,
                                                      sort_lanes_plain)
from rocksplicator_tpu_torch.ops.fused_resolve import fused_merge_resolve
from rocksplicator_tpu_torch.ops.kv_format import (pack_entries,
                                                   unpack_entries)
from rocksplicator_tpu_torch.ops.lanes import lanes_from_numpy, u32_numpy
from rocksplicator_tpu_torch.storage.records import OpType

from torch_parity import (assert_same_outputs, jax_args, jax_out,
                          torch_args, torch_out)

pack64 = struct.Struct("<q").pack

FLAG_CASES = list(itertools.product(
    ("none", "uint64add"), (True, False), (True, False), (True, False),
    (2, 6)))


def _both(batch, **flags):
    mk = flags.pop("merge_kind", "uint64add")
    want = jax_out(jck.merge_resolve_kernel(
        *jax_args(batch), merge_kind=jck.MergeKind(mk), **flags))
    got = torch_out(tck.merge_resolve_kernel(
        *torch_args(batch), merge_kind=tck.MergeKind(mk), **flags))
    return want, got


@pytest.mark.parametrize(
    "merge_kind,drop,uniform_klen,seq32,key_words", FLAG_CASES)
def test_merge_resolve_matches_jax_lax(merge_kind, drop, uniform_klen,
                                       seq32, key_words):
    """Every static flag combination on a mixed batch: padding rows with
    random lanes, variable key lengths, seq_hi != 0, u64 values, short
    operands, operand-only and DELETE-under-operand keys."""
    batch = synth_mixed_batch(1024, seed=key_words + 10 * seq32,
                              uniform_klen=uniform_klen, seq32=seq32,
                              key_words=key_words)
    want, got = _both(batch, merge_kind=merge_kind, drop_tombstones=drop,
                      uniform_klen=uniform_klen, seq32=seq32,
                      key_words=key_words)
    assert want["count"] > 0
    assert_same_outputs(want, got)


def test_merge_resolve_overflow_flag_matches_jax():
    """2^16+ rows of one key at N = 2^17 raise needs_cpu_fallback in both
    packages, and every lane still agrees."""
    batch = synth_mixed_batch(1 << 17, seed=3, hot_rows=70000)
    want, got = _both(batch)
    assert want["needs_cpu_fallback"] is True
    assert_same_outputs(want, got)


def test_merge_resolve_bench_batch_matches_jax():
    batch = synth_counter_batch(4096, seed=2)
    want, got = _both(batch, uniform_klen=True, seq32=True, key_words=4)
    assert_same_outputs(want, got)


def test_fused_resolve_matches_pallas_interpret():
    """The JAX fused Pallas kernel in interpret mode (N = 256) against the
    port's merge-resolve with the K2 backend, which CPU tensors send to the
    plain version."""
    from rocksplicator_tpu.ops.pallas_resolve import (
        fused_merge_resolve as jax_fused)

    batch = synth_mixed_batch(256, seed=4)
    want = jax_out(jax_fused(*jax_args(batch), interpret=True))
    got = torch_out(tck.merge_resolve_kernel(*torch_args(batch),
                                             sort_backend="fused"))
    assert_same_outputs(want, got)


def test_bitonic_sort_matches_pallas_interpret():
    """K1's CPU path against the JAX bitonic Pallas sort in interpret mode
    (N = 512); keys have real ties, so payload is a function of the keys
    and any order within ties gives equal lanes."""
    from rocksplicator_tpu.ops.pallas_sort import bitonic_sort_lanes as jbs

    rng = np.random.default_rng(7)
    n, num_keys = 512, 6
    keys = [(rng.integers(0, 7, n, dtype=np.uint32)
             | np.uint32(0x80000000) * np.uint32(i % 2))
            for i in range(num_keys)]
    payload = [np.asarray(sum(keys), dtype=np.uint32) ^ np.uint32(p)
               for p in range(4)]
    ops = keys + payload
    want = jbs(tuple(jnp.asarray(o) for o in ops), num_keys=num_keys,
               interpret=True)
    lanes = lanes_from_numpy({str(i): o for i, o in enumerate(ops)}, "cpu")
    got = bitonic_sort_lanes([lanes[str(i)] for i in range(len(ops))],
                             num_keys)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), u32_numpy(g))


@pytest.mark.parametrize("num_keys", [1, 3, 10])
def test_sort_lanes_plain_matches_lax_sort(num_keys):
    """Unsigned lexicographic order, high-bit words included; the last key
    is unique, so the order is total."""
    rng = np.random.default_rng(num_keys)
    n = 2048
    ops = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
           for _ in range(num_keys - 1)]
    ops = [(o % 5) * np.uint32(0x40000001) for o in ops]
    ops.append(rng.permutation(n).astype(np.uint32) * np.uint32(2654435761))
    ops += [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(3)]
    want = jax.lax.sort(tuple(jnp.asarray(o) for o in ops),
                        num_keys=num_keys, is_stable=False)
    lanes = lanes_from_numpy({str(i): o for i, o in enumerate(ops)}, "cpu")
    got = sort_lanes_plain([lanes[str(i)] for i in range(len(ops))],
                           num_keys)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), u32_numpy(g))


def test_composite_lanes_match_jax():
    batch = synth_mixed_batch(512, seed=8)
    for uniform, seq32 in itertools.product((True, False), repeat=2):
        want = jck.composite_key_lanes(
            (~batch["valid"]).astype(np.uint32),
            [batch["key_words_be"][:, w] for w in range(6)],
            batch["key_len"], batch["seq_hi"], batch["seq_lo"],
            uniform_klen=uniform, seq32=seq32)
        t = lanes_from_numpy(batch, "cpu")
        got = tck.composite_key_lanes(
            (~t["valid"]).int(), [t["key_words_be"][:, w] for w in range(6)],
            t["key_len"], t["seq_hi"], t["seq_lo"], uniform_klen=uniform,
            seq32=seq32)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w, np.uint32),
                                          u32_numpy(g))
        split = tck.split_composite_lanes(got, 6, uniform_klen=uniform,
                                          seq32=seq32)
        np.testing.assert_array_equal(u32_numpy(split[3]), batch["seq_lo"])
        np.testing.assert_array_equal(split[4].numpy(), batch["valid"])


def test_known_answers_match_cpu_reference():
    """Entry tuples → port pack → port merge-resolve → unpack equals the
    JAX package's heap-merge CPU backend."""
    entries = [
        (b"ctr", 1, OpType.PUT, pack64(100)),
        (b"ctr", 2, OpType.MERGE, pack64(5)),
        (b"ctr", 3, OpType.MERGE, pack64(7)),
        (b"del", 1, OpType.PUT, pack64(1)),
        (b"del", 2, OpType.DELETE, b""),
        (b"del", 3, OpType.MERGE, pack64(9)),
        (b"n", 4, OpType.PUT, pack64(-5)),
        (b"n", 5, OpType.MERGE, pack64(-10)),
        (b"pure", 6, OpType.MERGE, pack64(3)),
        (b"pure", 7, OpType.MERGE, pack64(4)),
        (b"z", 8, OpType.PUT, pack64(1)),
        (b"z", 9, OpType.DELETE, b""),
    ]
    for drop in (True, False):
        batch = pack_entries(entries[::-1], capacity=64)
        out = torch_out(tck.merge_resolve_kernel(
            *torch_args({k: getattr(batch, k) for k in FORWARD_ARGS}),
            drop_tombstones=drop))
        got = unpack_entries(
            out["key_words_be"], out["key_len"], out["seq_hi"],
            out["seq_lo"], out["vtype"], out["val_words"], out["val_len"],
            out["count"])
        jentries = [(k, s, JOpType(int(t)), v) for k, s, t, v in entries]
        want = list(CpuCompactionBackend().merge_runs(
            [sorted(jentries, key=lambda e: (e[0], -e[1]))],
            UInt64AddOperator(), drop))
        assert [(k, s, int(t), v) for k, s, t, v in got] == [
            (k, s, int(t), v) for k, s, t, v in want]


def test_port_pack_matches_jax_pack_for_kernel_inputs():
    entries = [(b"k%d" % (i % 9), i + 1, OpType.MERGE, pack64(i))
               for i in range(40)]
    a, b = pack_entries(entries, capacity=64), jax_pack(entries, capacity=64)
    for k in FORWARD_ARGS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_unknown_sort_backend_raises():
    args = torch_args(synth_counter_batch(256, seed=0))
    for bad in ("lax", "pallas", "pallas_fused", "triton"):
        with pytest.raises(ValueError):
            tck.merge_resolve_kernel(*args, sort_backend=bad)


@pytest.mark.parametrize("flag,backend", [
    ("pallas_fused", "fused"), ("pallas", "bitonic"), ("lax", "fused"),
    ("triton", "fused")])
def test_deployment_sort_backend_reads_the_flag(flag, backend, monkeypatch):
    """The port's ``sort_backend`` flag, set at run time or from the
    environment when the flag is defined, keeps the JAX package's
    mapping: lax and unknown values take K2."""
    from rocksplicator_tpu_torch.utils.flags import FLAGS, FlagRegistry

    old = FLAGS.get("sort_backend")
    FLAGS.set("sort_backend", flag)
    try:
        assert tck.deployment_sort_backend() == backend
    finally:
        FLAGS.set("sort_backend", old)
    monkeypatch.setenv("RSTPU_FLAG_SORT_BACKEND", flag)
    fresh = FlagRegistry()
    fresh.define("sort_backend", "lax")
    assert fresh.get("sort_backend") == flag
    fresh.reset("sort_backend")
    assert fresh.get("sort_backend") == "lax"


def test_sort_backends_agree_on_cpu():
    """On CPU tensors both backends run the plain path."""
    args = torch_args(synth_mixed_batch(512, seed=9))
    a = torch_out(tck.merge_resolve_kernel(*args, sort_backend="fused"))
    b = torch_out(tck.merge_resolve_kernel(*args, sort_backend="bitonic"))
    assert_same_outputs(a, b)


def test_wrong_lane_dtype_raises():
    args = list(torch_args(synth_counter_batch(256, seed=0)))
    args[1] = args[1].long()
    with pytest.raises(TypeError):
        tck.merge_resolve_kernel(*args)


def test_fused_launcher_refuses_cpu_tensors():
    """K2's launcher has no plain fallback: CPU tensors raise."""
    args = torch_args(synth_counter_batch(256, seed=0))
    with pytest.raises(ValueError):
        fused_merge_resolve(*args)


def _stacked(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


@pytest.mark.parametrize("merge_kind,drop,uniform_klen,seq32", [
    ("uint64add", True, False, False), ("uint64add", False, True, True),
    ("none", True, True, False), ("none", False, False, True)])
def test_merge_resolve_batched_matches_jax_vmap(merge_kind, drop,
                                                uniform_klen, seq32):
    """S = 3 shards of C = 512 through ``merge_resolve_batched`` against
    ``jax.vmap(merge_resolve_kernel)``: (S, C) lanes, (S,) count and
    needs_cpu_fallback."""
    batch = _stacked([synth_mixed_batch(
        512, seed=40 + s, uniform_klen=uniform_klen, seq32=seq32,
        valid_frac=0.5 + 0.2 * s) for s in range(3)])
    flags = dict(drop_tombstones=drop, uniform_klen=uniform_klen,
                 seq32=seq32, key_words=6)
    fn = jax.vmap(lambda *a: jck.merge_resolve_kernel(
        *a, merge_kind=jck.MergeKind(merge_kind), **flags))
    want = jax_out(fn(*jax_args(batch)))
    got = torch_out(tck.merge_resolve_batched(
        *torch_args(batch), merge_kind=tck.MergeKind(merge_kind), **flags))
    assert want["count"].shape == (3,)
    assert_same_outputs(want, got)


@pytest.mark.parametrize("merge_kind", ["uint64add", "none"])
def test_segmented_resolve_matches_shard_by_shard(merge_kind):
    """The bitonic route of ``merge_resolve_batched`` on the card — one
    segmented sort and the torch resolve with a key boundary at every
    shard start and a per-shard compaction — equals the plain version
    shard by shard (here with the plain segmented sort)."""
    batch = _stacked([synth_mixed_batch(256, seed=50 + s) for s in range(4)])
    args = torch_args(batch)
    flags = dict(merge_kind=tck.MergeKind(merge_kind), drop_tombstones=True,
                 uniform_klen=False, seq32=False, key_words=6)
    want = tck.merge_resolve_batched(*args, **flags)
    flat = [x.reshape((1024,) + tuple(x.shape[2:])) for x in args]
    got = tck._merge_resolve(*flat, sort=sort_lanes_plain, segment=256,
                             **flags)
    for k, w in want.items():
        g = got[k] if w.dim() == 1 and k in ("count",
                                            "needs_cpu_fallback") else (
            got[k].view(w.shape))
        assert torch.equal(g, w), k


def test_sort_lanes_plain_segments_sort_each_segment():
    rng = np.random.default_rng(9)
    ops = [rng.integers(0, 5, 1024).astype(np.uint32) for _ in range(2)]
    ops.append(np.arange(1024, dtype=np.uint32))
    t = lanes_from_numpy({str(i): o for i, o in enumerate(ops)}, "cpu")
    lanes = [t[str(i)] for i in range(3)]
    got = sort_lanes_plain(lanes, 2, segment=256)
    for s in range(4):
        part = [x[s * 256:(s + 1) * 256] for x in lanes]
        want = sort_lanes_plain(part, 2)
        for w, g in zip(want, got):
            assert torch.equal(g[s * 256:(s + 1) * 256], w)
