"""The port's grid-sharded compaction step (``parallel/mesh.py``), its
dryrun (``entry.dryrun_multichip``) and its scaling tool
(``tools/multichip_scaling.py``) against the JAX package's mesh on its
8 virtual CPU devices (tests/conftest.py), with the port on a grid of 8
CPU devices. Tolerance 0. The JAX side is pinned to the ``lax`` backend:
interpret-mode Pallas takes minutes on a mesh."""

import json
import re

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from rocksplicator_tpu.models.compaction_model import (
    CompactionModel as JaxModel)
from rocksplicator_tpu.parallel import mesh as jax_mesh
from rocksplicator_tpu_torch.entry import (dryrun_case, dryrun_check,
                                           dryrun_multichip)
from rocksplicator_tpu_torch.models.compaction_model import (
    FORWARD_ARGS, CompactionModel)
from rocksplicator_tpu_torch.ops.lanes import lanes_from_numpy
from rocksplicator_tpu_torch.parallel import make_mesh as exported_make_mesh
from rocksplicator_tpu_torch.parallel import mesh
from rocksplicator_tpu_torch.tools import multichip_scaling
from tools import multichip_scaling as jax_scaling

CPU8 = [torch.device("cpu")] * 8
N = 128  # entries per block
HASHES = ("parity_sha256", "bloom_sha256", "planar_sha256")


def _cfg(planar: bool) -> dict:
    return dict(capacity=N, emit_planar=planar)


def _port_step(block: int, planar: bool):
    grid = mesh.make_mesh(8, devices=CPU8, block=block)
    arrays = mesh.make_sharded_inputs(grid, entries_per_block=N)
    placed = mesh.shard_inputs_on_mesh(grid, arrays)
    step = mesh.sharded_compaction_step(
        grid, CompactionModel(**_cfg(planar)))
    return arrays, step(*(placed[k] for k in FORWARD_ARGS))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step's outputs as numpy, one compile per (block, planar),
    shared by the tests of the module."""
    cache = {}

    def get(block: int, planar: bool):
        if (block, planar) not in cache:
            grid = jax_mesh.make_mesh(8, block=block)
            arrays = jax_mesh.make_sharded_inputs(grid, entries_per_block=N)
            step = jax_mesh.sharded_compaction_step(
                grid, JaxModel(sort_backend="lax", **_cfg(planar)))
            final, *rest = step(*(arrays[k] for k in FORWARD_ARGS))
            cache[block, planar] = (
                {k: np.asarray(v) for k, v in final.items()},
                *(np.asarray(x) for x in rest))
        return cache[block, planar]

    return get


def _as_numpy(x: torch.Tensor) -> np.ndarray:
    """The tensor's own dtype (int32 lanes are viewed as u32 where the
    JAX array is u32, in _assert_same)."""
    return x.detach().cpu().numpy()


def _assert_same(want: np.ndarray, got: np.ndarray, what: str) -> None:
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert want.dtype == got.dtype, (what, want.dtype, got.dtype)
    np.testing.assert_array_equal(want, got, err_msg=what)


@pytest.mark.parametrize("shard_bytes", [None, 1 << 20, 1 << 27, 1 << 33])
def test_derive_block_axis_matches_jax(shard_bytes):
    assert mesh.BLOCK_BYTES_TARGET == jax_mesh.BLOCK_BYTES_TARGET
    for target in (mesh.BLOCK_BYTES_TARGET, 1 << 20):
        for n in range(1, 17):
            assert mesh.derive_block_axis(n, shard_bytes, target) == \
                jax_mesh.derive_block_axis(n, shard_bytes, target), (
                    n, shard_bytes, target)


@pytest.mark.parametrize("block", [1, 2, 4, 8])
def test_make_mesh_shapes(block):
    devices = [torch.device("cpu", i) for i in range(8)]
    grid = mesh.make_mesh(devices=devices, block=block)
    assert grid.shape == dict(jax_mesh.make_mesh(8, block=block).shape)
    assert grid.shape == {"shard": 8 // block, "block": block}
    # row-major, as the reference reshapes its device list
    assert [d for row in grid.devices for d in row] == devices
    assert exported_make_mesh is mesh.make_mesh


def test_make_mesh_raises_on_bad_grids():
    with pytest.raises(ValueError, match="does not divide"):
        mesh.make_mesh(8, devices=CPU8, block=3)
    with pytest.raises(ValueError, match="need 9 devices"):
        mesh.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="unsupported device"):
        mesh.make_mesh(devices=[torch.device("meta")] * 2)
    # four of the eight devices: derive_block_axis(4) == 2
    assert mesh.make_mesh(4, devices=CPU8).shape == {"shard": 2, "block": 2}


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh(devices=["cuda:0"] * 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multichip_scaling.main(["--entries", "256"])


@pytest.mark.parametrize("shards_per_device", [1, 2])
def test_sharded_inputs_match_jax_and_tile_placement(shards_per_device):
    grid = mesh.make_mesh(8, devices=CPU8)
    jgrid = jax_mesh.make_mesh(8)
    got = mesh.make_sharded_inputs(grid, shards_per_device, 64, seed=3)
    want = jax_mesh.make_sharded_inputs(jgrid, shards_per_device, 64,
                                        seed=3)
    assert set(got) == set(want)
    for k in want:
        _assert_same(want[k], got[k], k)
    placed = mesh.shard_inputs_on_mesh(grid, got)
    s = shards_per_device
    for k, tiles in placed.items():
        assert len(tiles) == 4 and all(len(row) == 2 for row in tiles)
        for r, row in enumerate(tiles):
            for c, t in enumerate(row):
                assert t.device == grid.devices[r][c]
                want_t = got[k][r * s:(r + 1) * s, c:c + 1]
                _assert_same(want_t, _as_numpy(t), f"{k} tile {r},{c}")
    with pytest.raises(ValueError, match="do not divide"):
        mesh.shard_inputs_on_mesh(grid, {k: v[:3] for k, v in got.items()})


@pytest.mark.parametrize("block,planar", [(1, False), (2, False),
                                          (4, False), (2, True)])
def test_sharded_step_matches_jax(jax_step, block, planar):
    want_final, *want_rest = jax_step(block, planar)
    _, (final, *rest) = _port_step(block, planar)
    assert set(final) == set(want_final)
    for k, w in want_final.items():
        _assert_same(w, _as_numpy(final[k]), k)
    for name, w, g in zip(("bloom", "counts", "global_count",
                           "needs_fallback"), want_rest, rest):
        _assert_same(w, _as_numpy(g), name)
    assert int(rest[2]) > 0 and int(rest[3]) == 0


@pytest.mark.parametrize("block", [1, 2, 4])
def test_sharded_step_matches_unsharded_pipeline(block):
    """Blockwise-split merge equals the unsharded batched pipeline over
    each shard's concatenated blocks, at every block-axis size the 8
    devices support. (On CPU tensors both sort backends run the plain
    version; only the card's ``mesh_step`` compares the two.)"""
    arrays, (final, bloom, counts, gc, fb) = _port_step(block, True)
    s_dim, b_dim, n_dim = arrays["key_len"].shape
    flat = lanes_from_numpy(
        {k: arrays[k].reshape((s_dim, b_dim * n_dim) + arrays[k].shape[3:])
         for k in FORWARD_ARGS}, "cpu")
    ref = CompactionModel(**_cfg(True))(*(flat[k] for k in FORWARD_ARGS))
    assert torch.equal(counts[:, 0], ref["count"])
    assert int(gc) == int(ref["count"].sum()) and int(fb) == 0
    assert torch.equal(bloom[:, 0], ref["bloom"])
    for k, v in final.items():
        assert torch.equal(v[:, 0], ref[k]), k


def _fields(line: str) -> dict:
    return dict(re.findall(r"(\w+)=([0-9a-f]+)\b", line))


def test_dryrun_hashes_match_jax(monkeypatch, capsys):
    monkeypatch.setenv("RSTPU_DRYRUN_BACKEND", "lax")
    graft.dryrun_multichip(8, 256)
    want = _fields(capsys.readouterr().out.strip().splitlines()[-1])
    # one leg: on CPU tensors both backends run the same plain version
    reports = dryrun_multichip(8, 256, devices=CPU8, backends=("fused",))
    lines = capsys.readouterr().out.strip().splitlines()
    assert [r["backend"] for r in reports] == ["fused"]
    assert len(lines) == 1
    for report, line in zip(reports, lines):
        assert line.startswith("dryrun_multichip OK: backend=")
        got = _fields(line)
        for k in HASHES + ("input_entries", "merged_entries",
                           "entries_per_block", "devices", "shards"):
            assert got[k] == want[k] == str(report[k]), k
        assert report["mesh"] == {"shard": 4, "block": 2}


@pytest.mark.parametrize("corrupt", ["counts", "bloom", "planar_chk",
                                     "val_words", "needs_fallback"])
def test_dryrun_check_refuses_a_wrong_step(corrupt, capsys):
    """The dryrun's assertions hold the step's outputs against the
    unsharded pipeline: a step output with one value changed fails them."""
    case = dryrun_case(8, "fused", N, CPU8)
    final, bloom, counts, gc, fb = case.step(*case.args)
    assert dryrun_check(case, (final, bloom, counts, gc, fb))[
        "merged_entries"] == int(gc)
    if corrupt == "counts":
        counts = counts.clone()
        counts[0, 0] -= 1
    elif corrupt == "bloom":
        bloom = bloom.clone()
        bloom[1, 0, 0] ^= 1 << 5
    elif corrupt == "needs_fallback":
        fb = torch.ones_like(fb)
    else:
        final = dict(final)
        final[corrupt] = final[corrupt].clone()
        final[corrupt][2, 0, 0] += 1
    with pytest.raises(AssertionError, match=r"\[fused\]"):
        dryrun_check(case, (final, bloom, counts, gc, fb))
    capsys.readouterr()


def test_run_shape_hash_matches_jax(tmp_path, capsys):
    want = jax_scaling.run_shape(8, "lax", 256)
    got = multichip_scaling.run_shape(8, "fused", 256, devices=CPU8)
    for k in ("output_sha256", "merged_entries", "input_entries", "shards",
              "mesh", "devices", "entries_per_block"):
        assert got[k] == want[k], k
    assert got["first_call_s"] > 0 and got["execute_s"] > 0
    assert got["execute_reps"] == multichip_scaling.EXECUTE_REPS
    capsys.readouterr()
    # the CLI: rows on stdout, or into --out and a summary on stdout
    assert multichip_scaling.main(["--entries", "256", "--device",
                                   "cpu"]) == 0
    rows = json.loads(capsys.readouterr().out)["rows"]
    assert [r["output_sha256"] for r in rows] == [want["output_sha256"]]
    out = tmp_path / "rows.json"
    assert multichip_scaling.main(["--entries", "256,512", "--device", "cpu",
                                   "--backends", "bitonic",
                                   "--out", str(out)]) == 0
    series = json.loads(out.read_text())
    assert series["device"] == "cpu" and len(series["rows"]) == 2
    assert series["rows"][0]["output_sha256"] == want["output_sha256"]
    assert set(json.loads(capsys.readouterr().out)["execute_s"]) == {
        "bitonic@256", "bitonic@512"}
