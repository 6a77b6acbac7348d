"""The chaos harness's reshard and rebalance decks: the port's
``rocksplicator_tpu_torch/tools/chaos_soak.py`` against the reference's
``tools/chaos_soak.py``.

- The reference's five chaos cases of ``tests/test_shard_move.py`` and
  ``tests/test_rebalancer.py`` on the port, with their seeds, bounds and
  asserts, every node's admin plane on the plain PyTorch path
  (``device="cpu"``): the fault sites are registered, two reshard
  schedules at seed 1234 hold the sixth invariant, two rebalance
  schedules hold the seventh, and the ``move_flip`` and
  ``split_cutover`` teeth are caught.
- The deck tables, the decks drawn for seeds 1, 7 and 1234 at every
  length up to 15 with and without a tooth, and the chaos-sized move and
  rebalancer flags equal the reference's exactly; every deck function is
  the reference's, AST for AST, once docstrings are dropped and the
  package name is mapped (the run functions' bodies hold the device,
  their only difference).
- With no device both decks run on the card, and raise where there is
  none before they create anything; the chaos scale is theirs alone.
- ``main``'s argument errors for the two modes exit as the reference's.
"""

import ast
import dataclasses
import importlib
import inspect
import os
import random
import textwrap

import pytest
import torch

from torch_parity import reset_both


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


@pytest.fixture
def sentinel_knobs():
    """The three knobs at values no deck sets, restored after the test."""
    from rocksplicator_tpu_torch.storage import native_compaction, stream_merge

    def put(knobs):
        (native_compaction.MIN_SLICE_ENTRIES,
         stream_merge.STREAM_MODE_OVERRIDE,
         stream_merge.CHUNK_ENTRIES_OVERRIDE) = knobs

    saved = _knobs()
    sentinel = (12345, "never", 777)
    put(sentinel)
    try:
        yield sentinel
    finally:
        put(saved)


# -- the reference's chaos cases on the port ---------------------------------


def test_move_failpoint_sites_registered():
    from rocksplicator_tpu_torch.testing.failpoints import SITES
    from rocksplicator_tpu_torch.tools.chaos_soak import _RESHARD_FAULT_SITES

    for site in _RESHARD_FAULT_SITES:
        assert site in SITES, f"unregistered fault site {site}"
    for site in ("move.record", "move.snapshot", "move.restore",
                 "move.catchup", "move.flip", "move.retire"):
        assert site in SITES


def test_reshard_chaos_schedules_hold_invariants(tmp_path, sentinel_knobs):
    from rocksplicator_tpu_torch.tools.chaos_soak import run_reshard_chaos

    result = run_reshard_chaos(
        str(tmp_path / "chaos"), schedules=2, seed=1234,
        log=lambda *a: None, device="cpu")
    assert result["violations"] == [], result["violations"]
    assert result["acked"] > 0
    # every schedule drove its move to a terminal state
    assert sum(result["move_outcomes"].values()) >= 1
    assert not set(result["move_outcomes"]) & {
        "wedged", "abort_failed", "resume_failed"}
    assert _knobs() == sentinel_knobs


def test_reshard_chaos_catches_naive_flip(tmp_path):
    """The tooth: a cutover patched to force-promote the target without
    drain/pause/two-phase-demote must be CAUGHT by the lineage probes."""
    from rocksplicator_tpu_torch.cluster.shard_move import ShardMove
    from rocksplicator_tpu_torch.tools.chaos_soak import run_reshard_chaos

    before = ShardMove._phase_cutover
    result = run_reshard_chaos(
        str(tmp_path / "chaos"), schedules=1, seed=7,
        break_guard="move_flip", heal_timeout=5.0, log=lambda *a: None,
        device="cpu")
    assert result["violations"], "move_flip tooth NOT caught"
    assert any("SERVING LINEAGE" in v or "NEW LINEAGE" in v
               for v in result["violations"]), result["violations"]
    assert ShardMove._phase_cutover is before


def test_rebalance_chaos_policy_initiates_and_invariants_hold(
        tmp_path, sentinel_knobs):
    """Two schedules (hot move + hot split), the policy loop sensing a
    seeded skewed workload and dispatching on its own; the seventh
    standing invariant is checked after each."""
    from rocksplicator_tpu_torch.tools.chaos_soak import run_rebalance_chaos

    result = run_rebalance_chaos(
        str(tmp_path / "chaos"), schedules=2, seed=1234,
        log=lambda *a: None, device="cpu")
    assert result["violations"] == [], result["violations"]
    assert result["acked"] > 0
    assert result["dispatched"].get("move", 0) >= 1
    assert result["dispatched"].get("split", 0) >= 1
    # the seams fired under the schedules; which one trips depends on
    # tick timing against the seeded fault windows, so the family is
    # asserted, as the reference's case does
    trips = result["failpoint_trips"]
    seams = {"rebalance.decide", "rebalance.plan", "rebalance.dispatch",
             "split.cutover"}
    assert any(trips.get(name, 0) >= 1 for name in seams), trips
    assert _knobs() == sentinel_knobs


def test_rebalance_chaos_catches_naive_split_cutover(tmp_path):
    """The tooth: a splitter patched to sever the observer tail and
    skip the cutover drain (flip without the write pause) must be
    CAUGHT by the acked-write probes."""
    from rocksplicator_tpu_torch.cluster.shard_split import ShardSplit
    from rocksplicator_tpu_torch.tools.chaos_soak import run_rebalance_chaos

    before = (ShardSplit._phase_catchup, ShardSplit._cutover_drain)
    result = run_rebalance_chaos(
        str(tmp_path / "chaos"), schedules=1, seed=7,
        break_guard="split_cutover", heal_timeout=5.0,
        log=lambda *a: None, device="cpu")
    assert result["violations"], "split_cutover tooth NOT caught"
    assert (ShardSplit._phase_catchup, ShardSplit._cutover_drain) == before


# -- parity with the reference -----------------------------------------------


@pytest.mark.parametrize("name", ["_RESHARD_FAULT_SITES", "_RESHARD_KINDS",
                                  "_REBALANCE_KINDS", "RESHARD_PASS_BOUND",
                                  "FAILOVER_SESSION_TTL"])
def test_deck_tables_equal(name):
    assert getattr(chaos("port"), name) == getattr(chaos("ref"), name)


@pytest.mark.parametrize("tooth", [None, "tooth"])
@pytest.mark.parametrize("seed", [1, 7, 1234])
@pytest.mark.parametrize("deck", ["_reshard_deck", "_rebalance_deck"])
def test_decks_equal(deck, seed, tooth):
    guard = tooth and {"_reshard_deck": "move_flip",
                       "_rebalance_deck": "split_cutover"}[deck]
    ref, port = getattr(chaos("ref"), deck), getattr(chaos("port"), deck)
    for length in range(1, 16):
        want = ref(random.Random(seed), length, guard)
        assert port(random.Random(seed), length, guard) == want
        assert len(want) == length


@pytest.mark.parametrize("call", ["_move_flags()", "_rebalance_flags(True)",
                                  "_rebalance_flags(False)"])
def test_flags_equal(call):
    name, arg = call[:-1].split("(")
    args = (arg == "True",) if arg else ()
    got = getattr(chaos("port"), name)(*args)
    want = getattr(chaos("ref"), name)(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _dump(node) -> str:
    """``node`` without docstrings, with the package names mapped."""
    for n in ast.walk(node):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            body = n.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                n.body = body[1:] or [ast.Pass()]
    return ast.dump(node).replace("rocksplicator_tpu_torch",
                                  "rocksplicator_tpu")


def _tree(obj):
    return ast.parse(textwrap.dedent(inspect.getsource(obj))).body[0]


_SETTLE = ("        _wait_settled(cluster)\n", "")
# The port's deliberate differences from the reference's deck functions,
# as (the port's text, the reference's text) in the dedented source; each
# port text must occur once, and with the reference's text in its place
# the two functions must be AST-equal. F22 (ROADMAP Queue 3): a schedule
# waits for the cluster to settle before its first write, and the
# rebalance preload counts a write_async that raises (the leader's DB
# closed) as not acked, as FailoverCluster.write_some does.
DELIBERATE = {
    "_reshard_schedule": [_SETTLE],
    "_rebalance_schedule": [_SETTLE, (
        "                    try:\n"
        "                        waiters.append((key, app.write_async(\n"
        "                            WriteBatch().put(key, key))))\n"
        "                    except Exception:\n"
        "                        # the leader's DB closed under the "
        "preload (a\n"
        "                        # leadership change): not acked, as "
        "write_some\n"
        "                        # counts a raise (F22)\n"
        "                        continue\n",
        "                    waiters.append((key, app.write_async(\n"
        "                        WriteBatch().put(key, key))))\n")],
}


@pytest.mark.parametrize("name", [
    "_move_flags", "_BgWriter", "_start_move_bg", "_start_drain_bg",
    "_wait_move_phase", "_finish_move", "_probe_serving_lineages",
    "_probe_new_lineage", "_reshard_schedule", "_reshard_deck",
    "_check_reshard_invariants", "_rebalance_flags", "_SeqRateLoad",
    "_ShardWriter", "_split_leaves", "_owning_leaf", "_tick_rebalancer",
    "_join_rebalance_workers", "_rebalance_schedule",
    "_check_rebalance_invariants", "_rebalance_deck"])
def test_deck_functions_ast_equal(name):
    ref, port = chaos("ref"), chaos("port")
    src = textwrap.dedent(inspect.getsource(getattr(port, name)))
    for port_text, ref_text in DELIBERATE.get(name, []):
        assert src.count(port_text) == 1, (name, port_text)
        src = src.replace(port_text, ref_text)
    assert _dump(ast.parse(src).body[0]) == _dump(
        _tree(getattr(ref, name)))


@pytest.mark.parametrize("runner,body", [
    ("run_reshard_chaos", "_run_reshard_deck"),
    ("run_rebalance_chaos", "_run_rebalance_deck")])
def test_run_bodies_equal_but_for_the_device(runner, body):
    """The port's ``run_*`` resolves the device and enters the chaos
    scale; its body is the reference's ``run_*`` body with the cluster
    built on the device."""
    want = _tree(getattr(chaos("ref"), runner))
    got = _tree(getattr(chaos("port"), body))
    for call in ast.walk(got):
        if (isinstance(call, ast.Call)
                and getattr(call.func, "id", None) == "FailoverCluster"):
            assert [k.arg for k in call.keywords][-1] == "device"
            call.keywords = call.keywords[:-1]
    assert _dump(got).split("body=", 1)[1] == _dump(want).split(
        "body=", 1)[1]
    wrapper = _tree(getattr(chaos("port"), runner))
    assert [a.arg for a in wrapper.args.args] == [
        a.arg for a in want.args.args] + ["device"]


@pytest.mark.parametrize("guard", ["move_flip", "split_cutover"])
def test_teeth_ast_equal(guard):
    def block(mod):
        for node in ast.walk(_tree(mod._break_guard)):
            if (isinstance(node, ast.If)
                    and isinstance(node.test, ast.Compare)
                    and getattr(node.test.comparators[0], "value",
                                None) == guard):
                return node
        raise AssertionError(f"no {guard} branch")

    assert _dump(block(chaos("port"))) == _dump(block(chaos("ref")))


# -- the device and the chaos scale ------------------------------------------


@pytest.mark.parametrize("runner", ["run_reshard_chaos",
                                    "run_rebalance_chaos"])
def test_decks_run_on_the_card_by_default(tmp_path, runner, sentinel_knobs):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the decks run on the card here")
    env = {k: os.environ.get(k) for k in (
        "RSTPU_RETRY_SEED", "RSTPU_PULL_RETRY_SEED")}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(chaos("port"), runner)(str(tmp_path / "chaos"),
                                       schedules=1, log=lambda *a: None)
    assert _knobs() == sentinel_knobs
    assert {k: os.environ.get(k) for k in env} == env
    assert not os.path.exists(tmp_path / "chaos")


@pytest.mark.parametrize("runner", ["run_reshard_chaos",
                                    "run_rebalance_chaos"])
def test_decks_scope_the_chaos_knobs_even_on_raise(tmp_path, runner,
                                                   sentinel_knobs,
                                                   monkeypatch):
    mod = chaos("port")
    seen = []

    def failing_cluster(root, **kw):
        seen.append((_knobs(), kw))
        raise RuntimeError("cluster failed to start")

    monkeypatch.setattr(mod, "FailoverCluster", failing_cluster)
    with pytest.raises(RuntimeError, match="failed to start"):
        getattr(mod, runner)(str(tmp_path / "chaos"), schedules=1,
                             log=lambda *a: None, device="cpu")
    assert [k for k, _kw in seen] == [(256, "always", 512)]
    assert seen[0][1]["device"] == "cpu"
    assert seen[0][1]["num_nodes"] == 4
    assert _knobs() == sentinel_knobs


# -- main's argument errors --------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--break-guard", "move_flip"],
    ["--failover", "--break-guard", "move_flip"],
    ["--break-guard", "split_cutover"],
    ["--reshard", "--break-guard", "split_cutover"],
    ["--reshard", "--rebalance"],
    ["--failover", "--reshard"],
    ["--rebalance", "--cdc"],
    ["--reshard", "--break-guard", "mux_misroute"],
    ["--rebalance", "--break-guard", "mux_misroute"],
    ["--reshard", "--break-guard", "remote_install"],
], ids=lambda a: " ".join(a))
def test_main_argument_errors_equal(argv, capsys):
    errors = []
    for key in ("ref", "port"):
        with pytest.raises(SystemExit) as exc:
            chaos(key).main(list(argv))
        err = capsys.readouterr().err.strip().splitlines()[-1]
        errors.append((exc.value.code, err.split("error: ", 1)[1]))
    assert errors[0] == errors[1]
    assert errors[1][0] == 2


# -- F22: the rebalance preload under a leader whose DB closes ---------------


class _PastPreload(Exception):
    """Raised where the schedule goes on past its preload."""


class _ClosingApp:
    """A leader's ApplicationDB whose DB closes after ``acked`` writes:
    each later write_async raises the engine's "db is closed", as a
    leader demoted mid-preload does."""

    def __init__(self, error_cls, acked: int):
        self.error_cls = error_cls
        self.left = acked

    def write_async(self, batch):
        import types
        from concurrent.futures import Future

        if self.left <= 0:
            raise self.error_cls("db is closed")
        self.left -= 1
        fut = Future()
        fut.set_result(None)
        return types.SimpleNamespace(future=fut, acked=True)


class _PreloadCluster:
    """Just what ``_rebalance_schedule`` reads up to the end of its
    preload; its coordinator client is where the schedule goes on."""

    segment = "seg"

    def __init__(self, app):
        import types

        manager = types.SimpleNamespace(get_db=lambda name: app)
        self.node = types.SimpleNamespace(
            handler=types.SimpleNamespace(db_manager=manager))

    def leader_node(self, partition, exclude=()):
        return self.node

    @property
    def client(self):
        raise _PastPreload()


@pytest.mark.parametrize("key", ["ref", "port"])
def test_rebalance_preload_counts_a_closed_leader_db_as_unacked(
        key, monkeypatch):
    """The split schedule's preload writes 240 keys through the hot
    shard's leader. When that leader's DB closes under it, the reference's
    schedule body raises StorageError out of the deck (F22, twice on the
    card); the port's records the writes before the close as acked and
    the rest as not acked, and goes on."""
    mod = chaos(key)
    errors = importlib.import_module(
        ("rocksplicator_tpu" if key == "ref" else "rocksplicator_tpu_torch")
        + ".storage.errors")
    monkeypatch.setattr(mod, "_split_leaves", lambda cluster: [0, 1])
    if key == "port":
        monkeypatch.setattr(mod, "_wait_settled", lambda cluster: True)
    acked_by_shard, violations = {}, []
    run = mod._rebalance_schedule("rebalance_split_hot")
    cluster = _PreloadCluster(_ClosingApp(errors.StorageError, 100))
    if key == "ref":
        with pytest.raises(errors.StorageError, match="db is closed"):
            run(cluster, random.Random(1), acked_by_shard, violations,
                "s1", {})
        return
    with pytest.raises(_PastPreload):
        run(cluster, random.Random(1), acked_by_shard, violations, "s1", {})
    assert violations == []
    assert len(acked_by_shard[0]) == 100
    assert acked_by_shard[0][:2] == [(b"a00000", b"a00000"),
                                     (b"z00000", b"z00000")]
