"""The chaos harness's data-plane and CDC decks: the port's
``rocksplicator_tpu_torch/tools/chaos_soak.py`` against the reference's
``tools/chaos_soak.py``.

- The schedule draws are equal, exactly: the fault menu for eight seeds,
  the ingest, remote-compaction and CDC menus and the CDC produce
  history; every site they arm is a registered port failpoint.
- ``check_wal_contiguous`` gives the same verdict in both packages,
  crossed both ways, on a WAL written by each engine: clean, after a
  torn append (``tests/test_failpoints.py``'s case), and with a hole made
  under that package's ``wal_hole`` guard.
- ``tests/test_failpoints.py``'s three ``run_chaos`` cases on the port
  (its DBs, ingest handler and remote worker on the plain PyTorch path,
  ``device="cpu"``), with the reference's arguments and asserts; the
  ``remote_install`` and ``mux_misroute`` teeth with the Makefile's
  arguments; and the ``wal_hole`` tooth through the module's CLI.
- The chaos scale (subcompaction slices of 256 entries, the streaming
  merge always on in 512-entry chunks) is the decks' own: importing the
  port's module leaves the three module-wide knobs alone, and
  ``run_chaos`` restores them however it ends. With no device the decks
  run on the card, and raise where there is none.
"""

import importlib
import os
import random
import subprocess
import sys

import pytest
import torch

from torch_parity import ReplPackage, reset_both

PKGS = [ReplPackage("ref"), ReplPackage("port")]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chaos(key: str):
    return importlib.import_module(
        "tools.chaos_soak" if key == "ref"
        else "rocksplicator_tpu_torch.tools.chaos_soak")


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield
    reset_both()


def _knobs():
    from rocksplicator_tpu_torch.storage import native_compaction, stream_merge

    return (native_compaction.MIN_SLICE_ENTRIES,
            stream_merge.STREAM_MODE_OVERRIDE,
            stream_merge.CHUNK_ENTRIES_OVERRIDE)


def _set_knobs(knobs) -> None:
    from rocksplicator_tpu_torch.storage import native_compaction, stream_merge

    (native_compaction.MIN_SLICE_ENTRIES, stream_merge.STREAM_MODE_OVERRIDE,
     stream_merge.CHUNK_ENTRIES_OVERRIDE) = knobs


@pytest.fixture
def sentinel_knobs():
    """The three knobs at values no deck sets, restored after the test."""
    saved = _knobs()
    sentinel = (12345, "never", 777)
    _set_knobs(sentinel)
    try:
        yield sentinel
    finally:
        _set_knobs(saved)


# -- the schedule draws ------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_fault_menu_draws_equal(seed):
    from rocksplicator_tpu_torch.testing import failpoints as fp

    ref, port = chaos("ref"), chaos("port")
    got = port._fault_menu(random.Random(seed))
    assert got == ref._fault_menu(random.Random(seed))
    # the schedule's own draw from the menu, as run_chaos makes it
    picks = []
    for mod in (ref, port):
        rng = random.Random(seed * 1_000_003)
        picks.append(rng.sample(mod._fault_menu(rng), k=rng.randint(1, 3)))
    assert picks[0] == picks[1]
    for site, _spec in got:
        assert site in fp.SITES, site


def test_fixture_menus_and_cdc_history_equal():
    from rocksplicator_tpu_torch.testing import failpoints as fp

    ref, port = chaos("ref"), chaos("port")
    assert port._INGEST_FAULTS == ref._INGEST_FAULTS
    assert port._REMOTE_COMPACT_FAULTS == ref._REMOTE_COMPACT_FAULTS
    assert port._CDC_DECK == ref._CDC_DECK
    assert port.CDC_TOPIC == ref.CDC_TOPIC
    assert (port.DB_NAME, port.DB2_NAME, port.DB_OPTS) == (
        ref.DB_NAME, ref.DB2_NAME, ref.DB_OPTS)
    for n in (0, 1, 29, 150, 300):
        assert port._cdc_deck_msgs(n) == ref._cdc_deck_msgs(n)
    sites = [f[0] for f in port._INGEST_FAULTS if f is not None]
    sites += [site for site, _spec in port._REMOTE_COMPACT_FAULTS]
    sites += [s.split(":", 1)[1] for s in port._CDC_DECK
              if s.startswith("seam:")]
    for site in sites:
        assert site in fp.SITES, site


# -- check_wal_contiguous, crossed ------------------------------------------


def _write_wal(pkg, path, scenario: str):
    """A DB of ``pkg`` written with 12 puts: clean, across one torn append
    (that write raises), or under ``pkg``'s ``wal_hole`` guard."""
    db = pkg.open_db(path)
    undo = None
    try:
        for i in range(12):
            if scenario == "torn" and i == 6:
                pkg.fp.activate("wal.append", "torn:1.0,one_shot")
                with pytest.raises(OSError):
                    db.put(b"torn", b"x" * 256)
            if scenario == "hole" and i == 2:
                undo = chaos(pkg.key)._break_guard("wal_hole")
            db.put(b"k%03d" % i, b"v%03d" % i)
    finally:
        if undo:
            undo()
        pkg.fp.clear()
    return db


@pytest.mark.parametrize("scenario", ["clean", "torn", "hole"])
@pytest.mark.parametrize("writer", PKGS, ids=repr)
def test_check_wal_contiguous_crossed(tmp_path, writer, scenario):
    db = _write_wal(writer, tmp_path / "db", scenario)
    try:
        verdicts = [chaos(k).check_wal_contiguous(db) for k in ("ref", "port")]
    finally:
        db.close()
    assert verdicts[0] == verdicts[1]
    if scenario == "hole":
        assert verdicts[1] is not None and verdicts[1].startswith("WAL hole")
    else:
        assert verdicts[1] is None


# -- run_chaos on the port ---------------------------------------------------


def test_chaos_schedules_hold_invariants(tmp_path, sentinel_knobs):
    from rocksplicator_tpu_torch.tools.chaos_soak import run_chaos

    result = run_chaos(
        str(tmp_path / "chaos"), schedules=3, seed=1234, writes=40,
        ingest_every=2, conv_timeout=25.0, log=lambda *a: None,
        device="cpu")
    assert result["violations"] == []
    assert result["acked"] > 0
    assert _knobs() == sentinel_knobs


def test_chaos_catches_broken_wal_durability_guard(tmp_path):
    """Teeth: a WAL that claims durability tokens without writing the
    record (the ack-before-durability bug class) must be caught."""
    from rocksplicator_tpu_torch.tools.chaos_soak import run_chaos

    result = run_chaos(
        str(tmp_path / "chaos"), schedules=1, seed=7, writes=30,
        ingest_every=0, break_guard="wal_hole", conv_timeout=2.0,
        log=lambda *a: None, device="cpu")
    assert any("WAL hole" in v for v in result["violations"]), \
        result["violations"]


def test_chaos_catches_meta_before_ingest_guard(tmp_path):
    """Teeth: writing DBMetaData before the engine ingest must be caught
    as partial meta."""
    from rocksplicator_tpu_torch.tools.chaos_soak import run_chaos

    result = run_chaos(
        str(tmp_path / "chaos"), schedules=1, seed=7, writes=10,
        ingest_every=1, break_guard="meta_first", conv_timeout=10.0,
        log=lambda *a: None, device="cpu")
    assert any("partial meta" in v or "meta" in v
               for v in result["violations"]), result["violations"]


def test_chaos_catches_remote_install_without_epoch_gate(tmp_path):
    """The remote_install tooth at the Makefile's arguments: a deposed
    leader's job installing must be caught by the deposition probe."""
    from rocksplicator_tpu_torch.tools.chaos_soak import run_chaos

    result = run_chaos(
        str(tmp_path / "chaos"), schedules=1, seed=7, remote_every=1,
        break_guard="remote_install", conv_timeout=3.0,
        log=lambda *a: None, device="cpu")
    assert any("DEPOSED LEADER'S JOB INSTALLED" in v
               for v in result["violations"]), result["violations"]
    assert result["remote_outcomes"].get("deposed:installed", 0) >= 1


def test_chaos_catches_mux_misroute(tmp_path):
    """The mux_misroute tooth at the Makefile's arguments: one shard's
    updates filed under its sibling's section must be caught, and the
    guard's RSTPU_PULL_MUX is restored after the run."""
    from rocksplicator_tpu_torch.tools.chaos_soak import run_chaos

    before = os.environ.get("RSTPU_PULL_MUX")
    result = run_chaos(
        str(tmp_path / "chaos"), schedules=1, seed=7,
        break_guard="mux_misroute", conv_timeout=3.0,
        log=lambda *a: None, device="cpu")
    assert result["violations"], "mux_misroute tooth NOT caught"
    assert os.environ.get("RSTPU_PULL_MUX") == before


# -- the chaos scale and the device ------------------------------------------


def test_import_leaves_the_chaos_knobs(sentinel_knobs):
    importlib.reload(chaos("port"))
    assert _knobs() == sentinel_knobs


def test_run_chaos_scopes_the_knobs_even_on_raise(tmp_path, sentinel_knobs,
                                                 monkeypatch):
    mod = chaos("port")
    seen = []

    def failing_cluster(root, device=None):
        seen.append(_knobs())
        raise RuntimeError("cluster failed to start")

    monkeypatch.setattr(mod, "ChaosCluster", failing_cluster)
    with pytest.raises(RuntimeError, match="failed to start"):
        mod.run_chaos(str(tmp_path / "chaos"), schedules=1,
                      log=lambda *a: None, device="cpu")
    assert seen == [(mod.CHAOS_MIN_SLICE_ENTRIES, mod.CHAOS_STREAM_MODE,
                     mod.CHAOS_CHUNK_ENTRIES)] == [(256, "always", 512)]
    assert _knobs() == sentinel_knobs
    with pytest.raises(ValueError, match="unknown break-guard"):
        mod.run_chaos(str(tmp_path / "chaos2"), schedules=1,
                      break_guard="nope", log=lambda *a: None, device="cpu")
    assert _knobs() == sentinel_knobs


@pytest.mark.parametrize("runner", ["run_chaos", "run_cdc_chaos"])
def test_decks_run_on_the_card_by_default(tmp_path, runner, sentinel_knobs):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the decks run on the card here")
    env = {k: os.environ.get(k) for k in (
        "RSTPU_RETRY_SEED", "RSTPU_PULL_RETRY_SEED", "RSTPU_TRANSPORT")}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(chaos("port"), runner)(str(tmp_path / "chaos"),
                                       schedules=1, log=lambda *a: None)
    assert _knobs() == sentinel_knobs
    assert {k: os.environ.get(k) for k in env} == env
    assert not os.path.exists(tmp_path / "chaos")


def test_cli_catches_wal_hole_on_the_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "rocksplicator_tpu_torch.tools.chaos_soak",
         "--device", "cpu", "--break-guard", "wal_hole",
         "--expect-violation", "--schedules", "1", "--seed", "7",
         "--conv-timeout", "3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "VIOLATION: " in proc.stdout and "WAL hole" in proc.stdout
