"""A leader whose session lapsed must not wedge its shard (ROADMAP F20).

The first of the three ways the reshard deck's ``move_kill_target``
schedule reached the wedge: a
leader T stops heartbeating (wedged, not dead) and its session lapses;
the controller mints a new epoch for a follower X, whose
Follower->Leader transition is still in flight when T's session is
re-established. T comes back claiming LEADER, so X's no-live-leader
check refuses the promotion (``T is still LEADER``), and the controller
keeps T sticky under yet another fresh epoch E. The followers repoint to
T at E and can pull before T adopts E: T, still at its old epoch, sees
E and fences itself. Adopting E then cannot clear the fence (only an
epoch strictly above the fencing one does), and the shard has one
claimer in the control plane and no serving leader in the data plane.

Both packages are driven through that exact order, deterministically:
X's promotion waits until T is back, and T's adoption of E waits until
its data plane is fenced. The JAX package stays wedged; the port
re-promotes T at E (``reanoint_fenced``) and the sixth invariant holds
within the reshard deck's 30 s heal window.

The other two ways are held on both packages' LeaderFollower model over
a recording context: the ledger's own leader, demoted by a two-phase
handoff while a stale claimer is back, keeps its data where the
reference clears it; and a deposed leader's demotion checkpoints no seq
where the reference checkpoints its un-acked suffix for the
3-node-failure guard. One ``move_kill_target``-only reshard deck on the
port, at a seed that failed on the reference (2 schedules, seed 2),
then holds every invariant.

The re-promotion keeps the promotion's 3-node-failure guard and lowers
no checkpointed seq. Both promotions wait for the seq of every live
replica that holds the lineage's data (ROADMAP F21): a follower whose db
is reopening for a repoint answers DB_NOT_FOUND, and the reference's
election promotes behind it.
"""

import importlib
import json
import random
import threading

import pytest

from torch_parity import reset_both

HEAL_TIMEOUT = 30.0  # the reshard deck's heal_timeout


def chaos(key: str):
    return importlib.import_module(
        "tools.chaos_soak" if key == "ref"
        else "rocksplicator_tpu_torch.tools.chaos_soak")


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield
    reset_both()


def _ledger(cluster, partition):
    raw = cluster.client.get_or_none(
        f"/clusters/{cluster.cluster}/epochs/{partition}")
    return json.loads(bytes(raw).decode()) if raw else {}


def _lapse_and_return(key: str, root, timeout: float) -> dict:
    """Drive ``key``'s 3-node cluster through the sequence and report what
    the sixth invariant saw within ``timeout``."""
    mod = chaos(key)
    fp = mod.fp
    kw = {} if key == "ref" else {"device": "cpu"}
    cluster = mod.FailoverCluster(str(root), num_nodes=3, **kw)
    gate = threading.Event()
    try:
        cluster.wait_initial_convergence()
        part, db = cluster.partitions[0], cluster.db_names[0]
        acked = []
        cluster.write_some(random.Random(7), "pre", 6, acked)
        assert acked, "no write acked before the fault"
        t = cluster.leader_node(part)
        t_iid = t.instance.instance_id
        others = [n for n in cluster.nodes if n is not t]

        # X's promotion (whichever follower the controller picks) waits
        # until T is back and claiming
        for n in others:
            model = n.participant.factory.get(part)
            real = model.on_become_leader_from_follower

            def held(real=real):
                gate.wait(20.0)
                return real()

            model.on_become_leader_from_follower = held

        # T adopts the epoch it is re-anointed at only once a follower
        # pulling at that epoch has fenced it
        admin = t.participant.ctx.admin
        real_set = admin.set_db_epoch

        def late_set(addr, db_name, epoch):
            cluster.wait(lambda: t.rdb(db) is not None and t.rdb(db).fenced,
                         10.0)
            return real_set(addr, db_name, epoch)

        admin.set_db_epoch = late_set

        # no replica pulls while T is away: nothing carries the epoch
        # minted for X to T's data plane (in the deck, T's followers
        # were busy with the move's pause and repoints)
        fp.activate("repl.pull", "fail_prob:1.0")
        t.participant.coord.suspend_heartbeats()
        assert cluster.wait(
            lambda: _ledger(cluster, part).get("leader") not in (None, t_iid),
            20.0), "the controller never minted for another node"
        deposed_at = _ledger(cluster, part)["epoch"]
        t.participant.coord.resume_heartbeats()
        assert cluster.wait(
            lambda: _ledger(cluster, part).get("leader") == t_iid
            and _ledger(cluster, part)["epoch"] > deposed_at, 20.0), \
            "the controller never re-anointed the returning leader"
        anointed_at = _ledger(cluster, part)["epoch"]
        fp.deactivate("repl.pull")
        assert cluster.wait(lambda: t.rdb(db).fenced, 10.0), \
            "the returning leader was never fenced at its own epoch"
        fenced_by = t.rdb(db)._fenced_by
        gate.set()  # X's promotion now meets T's claim

        violations = []
        passes = mod._check_reshard_invariants(
            cluster, acked, f"{key}-lapse", violations,
            timeout=timeout)
        rdb = t.rdb(db)
        return {"violations": violations, "passes": passes,
                "anointed_at": anointed_at, "fenced_by": fenced_by,
                "t_state": t.participant.current_states.get(part),
                "t_fenced": rdb is not None and rdb.fenced,
                "ledger": _ledger(cluster, part), "t_iid": t_iid}
    finally:
        fp.clear()
        gate.set()
        cluster.stop()


def test_returning_leader_fenced_at_its_own_epoch(tmp_path):
    # the wedge is permanent (nothing in it moves again): half the heal
    # window shows it
    ref = _lapse_and_return("ref", tmp_path / "ref", HEAL_TIMEOUT / 2)
    port = _lapse_and_return("port", tmp_path / "port", HEAL_TIMEOUT)
    for got in (ref, port):
        # the sequence was the one described: fenced by exactly the
        # epoch the ledger re-anointed it at
        assert got["fenced_by"] == got["anointed_at"], got
    # the reference: one claimer, fenced for good, no serving lineage
    assert ref["violations"] and "NO HEAL" in ref["violations"][0], ref
    assert ref["t_state"] == "LEADER" and ref["t_fenced"], ref
    # the port: one unfenced leader in the current states, the map and
    # the data plane, every acked write on every host, within the bound
    assert port["violations"] == [], port
    assert not port["t_fenced"], port
    assert port["passes"] <= chaos("port").RESHARD_PASS_BOUND


def test_move_kill_target_deck_heals(tmp_path, monkeypatch):
    mod = chaos("port")
    monkeypatch.setattr(mod, "_reshard_deck",
                        lambda rng, schedules, guard:
                        ["move_kill_target"] * schedules)
    result = mod.run_reshard_chaos(
        str(tmp_path / "chaos"), schedules=2, seed=2,
        log=lambda *a: None, device="cpu")
    assert result["deck"] == ["move_kill_target"] * 2
    assert result["violations"] == [], result["violations"]
    assert not set(result["move_outcomes"]) & {
        "wedged", "abort_failed", "resume_failed"}
    assert all(p <= mod.RESHARD_PASS_BOUND for p in result["passes_used"])


# -- the demotion beside a stale claimer, on a recording context -------------


class _Admin:
    """The admin RPCs a LeaderFollower demotion makes, recorded."""

    def __init__(self, calls):
        self.calls = calls

    def get_sequence_number(self, addr, db_name):
        return 57

    def clear_db(self, addr, db_name, reopen=False):
        self.calls.append("clear_db")

    def change_db_role_and_upstream(self, addr, db_name, role,
                                    upstream=None, epoch=0):
        self.calls.append(f"role {role}")


class _Ctx:
    """The ``ClusterContext`` surface a demotion reads: this node ``me``
    and a live peer ``peer`` that claims LEADER, the ledger naming
    ``ledger_leader``."""

    def __init__(self, key, ledger_leader):
        model = importlib.import_module(
            ("rocksplicator_tpu" if key == "ref"
             else "rocksplicator_tpu_torch") + ".cluster.model")
        self.calls = []
        self.admin = _Admin(self.calls)
        self.instance = model.InstanceInfo("me", "127.0.0.1", 1, 2, "az")
        self._peer = model.InstanceInfo("peer", "127.0.0.1", 3, 4, "az")
        self._ledger_leader = ledger_leader
        self.local_admin_addr = ("127.0.0.1", 2)
        self.local_repl_addr = ("127.0.0.1", 1)

    def log_event(self, *args):
        pass

    def external_view(self, partition):
        return {"me": "LEADER", "peer": "LEADER"}

    def live_instances(self):
        return {"me": self.instance, "peer": self._peer}

    def partition_epoch(self, partition):
        return 7

    def epoch_ledger(self, partition):
        return 7, self._ledger_leader

    def set_partition_seq(self, partition, seq):
        self.calls.append(f"checkpoint {seq}")


def _demote(key, ledger_leader):
    mod = importlib.import_module(
        ("rocksplicator_tpu" if key == "ref" else "rocksplicator_tpu_torch")
        + ".cluster.state_models.leader_follower")
    ctx = _Ctx(key, ledger_leader)
    model = mod.LeaderFollowerStateModel("seg_0", ctx)
    model.on_become_follower_from_offline = \
        lambda: ctx.calls.append("offline->follower")
    model.on_become_follower_from_leader()
    return ctx.calls


@pytest.mark.parametrize("ledger_leader,ref_calls,port_calls", [
    # the ledger's own leader beside a stale claimer: the reference takes
    # itself for deposed and clears the lineage's data; the port demotes
    # in place and checkpoints its seq
    ("me", ["checkpoint 57", "clear_db", "offline->follower"],
     ["checkpoint 57", "role FOLLOWER"]),
    # deposed for real: both resync from scratch; the port checkpoints no
    # seq of its un-acked suffix
    ("peer", ["checkpoint 57", "clear_db", "offline->follower"],
     ["clear_db", "offline->follower"]),
], ids=["ledger_leader", "deposed"])
def test_demotion_beside_a_second_claimer(ledger_leader, ref_calls,
                                          port_calls):
    assert _demote("ref", ledger_leader) == ref_calls
    assert _demote("port", ledger_leader) == port_calls


@pytest.mark.parametrize("ledger_leader,checkpoints", [
    (None, True), ("me", True), ("peer", False)])
def test_seq_loop_checkpoints_only_the_ledgers_leader(ledger_leader,
                                                      checkpoints):
    """The participant's seq loop checkpoints a LEADER's seq only where the
    ledger names no one else: a leader deposed while its session lapsed
    still claims LEADER and may take writes no follower acks."""
    from rocksplicator_tpu_torch.cluster.participant import Participant

    p = Participant.__new__(Participant)
    p.ctx = _Ctx("port", ledger_leader)
    p.instance = p.ctx.instance
    assert p._leads_in_ledger("seg_0") is checkpoints


# -- the re-promotion keeps the 3-node-failure guard -------------------------


class _FencedAdmin(_Admin):
    """A fenced LEADER at seq 57 and a live peer at ``peer_seq``."""

    def __init__(self, calls, peer_seq):
        super().__init__(calls)
        self.peer_seq = peer_seq

    def get_sequence_number(self, addr, db_name):
        return 57 if addr == ("127.0.0.1", 2) else self.peer_seq

    def check_db(self, addr, db_name):
        return {"role": "LEADER", "fenced": True}


class _FencedCtx(_Ctx):
    """The ledger re-anointed ``me`` at epoch 7, the epoch that fenced it;
    the coordinator holds ``persisted`` as the lineage's last leader
    seq; the live peer is in ``peer_state``."""

    promotion_seq_slack = 8
    catch_up_timeout = 1.0

    def __init__(self, persisted, peer_seq, key="port",
                 peer_state="FOLLOWER"):
        super().__init__(key, "me")
        self.admin = _FencedAdmin(self.calls, peer_seq)
        self._persisted = persisted
        self._peer_state = peer_state

    def external_view(self, partition):
        return {"me": "LEADER", "peer": self._peer_state}

    def get_partition_seq(self, partition):
        return self._persisted

    def partition_lock(self, partition):
        return "lock"

    def release_partition_lock(self, node):
        self.calls.append("unlock")


@pytest.mark.parametrize("persisted,peer_seq,calls", [
    # no record, or one the local seq reaches: re-promoted, the local seq
    # checkpointed
    (None, 50, ["role LEADER", "checkpoint 57", "unlock"]),
    (57, 57, ["role LEADER", "checkpoint 57", "unlock"]),
    # behind the record within the slack: re-promoted, the record kept
    (65, 50, ["role LEADER", "checkpoint 65", "unlock"]),
    # the record is past every live replica's seq by more than the slack
    # (a dead peer held acked writes): refused, as the promotion refuses
    (66, 57, ["unlock"]),
    (200, 50, ["unlock"]),
], ids=["no_record", "at_record", "within_slack", "past_slack",
        "far_past"])
def test_reanointment_keeps_the_three_node_failure_guard(persisted,
                                                         peer_seq, calls):
    from rocksplicator_tpu_torch.cluster.state_models.base import (
        TransitionError)
    from rocksplicator_tpu_torch.cluster.state_models.leader_follower \
        import LeaderFollowerStateModel

    ctx = _FencedCtx(persisted, peer_seq)
    model = LeaderFollowerStateModel("seg_0", ctx)
    if "role LEADER" in calls:
        assert model.reanoint_fenced(7) is True
    else:
        with pytest.raises(TransitionError, match="refusing promotion"):
            model.reanoint_fenced(7)
    assert ctx.calls == calls


def test_refused_reanointment_leaves_the_replica_in_error():
    """A refused re-promotion hands the replica to the controller's
    ERROR -> OFFLINE replan, like any failed promotion."""
    from rocksplicator_tpu_torch.cluster.participant import Participant
    from rocksplicator_tpu_torch.cluster.state_models.base import (
        TransitionError)
    from rocksplicator_tpu_torch.cluster.state_models.leader_follower \
        import LeaderFollowerStateModel

    model = LeaderFollowerStateModel("seg_0", _FencedCtx(200, 50))
    p = Participant.__new__(Participant)
    p.factory = type("F", (), {"get": staticmethod(lambda part: model)})()
    seen = []
    p._set_current = lambda part, state: seen.append((part, state))
    with pytest.raises(TransitionError):
        p._reanoint_if_fenced("seg_0", 7)
    assert seen == [("seg_0", "ERROR")]


# -- F21: no promotion past a serving replica whose seq is unreadable -------


@pytest.mark.parametrize("peer_state,peer_seq,ref_promotes,port_promotes", [
    # a live follower whose db is reopening for a repoint answers
    # DB_NOT_FOUND: the reference elects without it and promotes at 57
    # (behind it, if it held more); the port refuses and retries
    ("FOLLOWER", None, True, False),
    # read, and behind us: both promote
    ("FOLLOWER", 50, True, True),
    # a replica holding no lineage data yet: both promote without it
    ("OFFLINE", None, True, True),
], ids=["follower_unread", "follower_behind", "offline_unread"])
def test_promotion_waits_for_every_serving_replicas_seq(
        peer_state, peer_seq, ref_promotes, port_promotes):
    for key, promotes in (("ref", ref_promotes), ("port", port_promotes)):
        mod = importlib.import_module(
            ("rocksplicator_tpu" if key == "ref"
             else "rocksplicator_tpu_torch")
            + ".cluster.state_models.leader_follower")
        base = importlib.import_module(
            ("rocksplicator_tpu" if key == "ref"
             else "rocksplicator_tpu_torch")
            + ".cluster.state_models.base")
        ctx = _FencedCtx(None, peer_seq, key=key, peer_state=peer_state)
        model = mod.LeaderFollowerStateModel("seg_0", ctx)
        if promotes:
            model.on_become_leader_from_follower()
            assert ctx.calls == ["role LEADER", "checkpoint 57", "unlock"]
        else:
            with pytest.raises(base.TransitionError,
                               match="seq of peer unreadable"):
                model.on_become_leader_from_follower()
            assert ctx.calls == ["unlock"]


# -- F23: no promotion from a superseded assignment --------------------------


@pytest.mark.parametrize("ledger_leader,port_promotes", [
    # the ledger names this replica, or holds no record: both promote
    ("me", True), (None, True),
    # the controller minted another replica's epoch while this promotion
    # was in flight (its assignment is stale): the reference promotes a
    # second leader, whose acked writes the ledger's leader never holds;
    # the port refuses and replans
    ("peer", False),
], ids=["ledger_names_me", "no_record", "superseded"])
def test_promotion_refuses_a_superseded_assignment(ledger_leader,
                                                   port_promotes):
    for key, promotes in (("ref", True), ("port", port_promotes)):
        mod = importlib.import_module(
            ("rocksplicator_tpu" if key == "ref"
             else "rocksplicator_tpu_torch")
            + ".cluster.state_models.leader_follower")
        base = importlib.import_module(
            ("rocksplicator_tpu" if key == "ref"
             else "rocksplicator_tpu_torch")
            + ".cluster.state_models.base")
        ctx = _FencedCtx(None, 50, key=key)
        ctx._ledger_leader = ledger_leader
        model = mod.LeaderFollowerStateModel("seg_0", ctx)
        if promotes:
            model.on_become_leader_from_follower()
            assert ctx.calls == ["role LEADER", "checkpoint 57", "unlock"]
        else:
            with pytest.raises(base.TransitionError,
                               match="epoch ledger names peer"):
                model.on_become_leader_from_follower()
            assert ctx.calls == ["unlock"]
