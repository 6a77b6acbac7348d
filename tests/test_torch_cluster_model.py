"""The port's control-plane logic held against the JAX package's, on the
same seeded inputs, tolerance 0: the controller's pure assignment
(``assign_resource``: rendezvous placement, sticky and highest-ranked
leader choice, the two-phase handoff, fencing epochs, pins and split
records), the spectator's shard map (``generate_shard_map``), the data
model's encodings, every state model's transition plans and the
leader-handoff event history.
"""

import copy
import importlib
import json
import random

import pytest

from tests.torch_parity import PACKAGES, reset_both

STATE_MODELS = ("LeaderFollower", "MasterSlave", "OnlineOffline", "Cache",
                "Bootstrap", "CdcLeaderStandby")
STATES = ("LEADER", "FOLLOWER", "MASTER", "SLAVE", "OFFLINE", "ONLINE",
          "STANDBY", "DROPPED", "ERROR")


@pytest.fixture(autouse=True)
def _fresh_both():
    reset_both()
    yield
    reset_both()


def _mod(key, name):
    return importlib.import_module(f"{PACKAGES[key]}.cluster.{name}")


# ---------------------------------------------------------------------------
# seeded inputs, described once and built with each package's classes
# ---------------------------------------------------------------------------


def _scenario(seed: int) -> dict:
    """A resource, a live set, current states, an epoch ledger, pins and
    split records, drawn from ``seed`` as plain data."""
    rng = random.Random(seed)
    all_iids = [f"10.0.0.{i}_{9090 + i}" for i in range(7)]
    live = sorted(rng.sample(all_iids, rng.randint(1, len(all_iids))))
    num_shards = rng.randint(1, 8)
    resource = {"segment": rng.choice(["seg", "counter", "ro"]),
                "num_shards": num_shards,
                "replicas": rng.randint(1, 3),
                "state_model": rng.choice(STATE_MODELS)}
    seg = resource["segment"]
    partitions = [f"{seg}_{s}" for s in range(num_shards + 4)]
    current = {}
    for iid in rng.sample(all_iids, rng.randint(0, len(all_iids))):
        current[iid] = {p: rng.choice(STATES)
                        for p in rng.sample(partitions,
                                            rng.randint(0, len(partitions)))}
    epochs = {p: {"epoch": rng.randint(0, 9),
                  "leader": rng.choice(all_iids + [None])}
              for p in rng.sample(partitions, rng.randint(0, num_shards))}
    pins = {}
    for p in rng.sample(partitions[:num_shards],
                        rng.randint(0, num_shards)):
        reps = rng.sample(all_iids, rng.randint(1, 3))
        pins[p] = {"replicas": reps,
                   "preferred_leader": rng.choice(reps + [None, "gone"]),
                   "move_id": f"m{rng.randrange(100)}"}
    splits = []
    next_child = num_shards
    for parent in rng.sample(range(num_shards), rng.randint(0, 2)):
        splits.append({
            "segment": seg, "parent_shard": parent,
            "split_key": rng.randbytes(4).hex(),
            "low_shard": next_child, "high_shard": next_child + 1,
            "phase": rng.choice(["active", "active", "catchup"]),
            "split_id": f"s{parent}", "epoch": rng.randint(1, 5)})
        next_child += 2
    return {"resource": resource, "live": live, "current": current,
            "epochs": epochs, "pins": pins, "splits": splits}


def _assign(key: str, sc: dict, **kw):
    model = _mod(key, "model")
    ctrl = _mod(key, "controller")
    instances = {iid: model.InstanceInfo(iid, iid.split("_")[0],
                                         int(iid.split("_")[1]),
                                         int(iid.split("_")[1]) + 1000,
                                         "az-" + iid[-1])
                 for iid in sc["live"]}
    per_instance = {iid: {} for iid in instances}
    epochs = copy.deepcopy(sc["epochs"])
    changed = ctrl.assign_resource(
        model.ResourceDef(**sc["resource"]), instances,
        copy.deepcopy(sc["current"]), per_instance, epochs,
        pins={p: model.PlacementPin(**d) for p, d in sc["pins"].items()},
        splits=[model.SplitRecord(**d) for d in sc["splits"]], **kw)
    shards = ctrl.effective_shards(
        model.ResourceDef(**sc["resource"]),
        [model.SplitRecord(**d) for d in sc["splits"]])
    return ({iid: {p: a.to_json() for p, a in sorted(asg.items())}
             for iid, asg in per_instance.items()},
            sorted(changed), epochs, shards)


@pytest.mark.parametrize("seed", range(40))
def test_assign_resource_equals_reference(seed):
    sc = _scenario(seed)
    assert _assign("port", sc) == _assign("ref", sc)


def _in_flight_scenario():
    """The ledger names a placed replica whose promotion is in flight (it
    reports FOLLOWER, no replica claims yet) while a better-ranked
    replica already serves."""
    live = [f"10.0.0.{i}_{9090 + i}" for i in range(3)]
    sc = {"resource": {"segment": "seg", "num_shards": 1, "replicas": 3,
                       "state_model": "LeaderFollower"},
          "live": live, "pins": {}, "splits": [], "epochs": {},
          "current": {}}
    ranked = sorted(live, key=lambda iid: _mod("ref", "controller")
                    ._rendezvous("seg_0", iid), reverse=True)
    sc["epochs"] = {"seg_0": {"epoch": 1, "leader": ranked[1]}}
    sc["current"] = {iid: {"seg_0": "FOLLOWER"} for iid in live}
    return sc, ranked


def _leaders(key, sc, **kw):
    per, changed, epochs, _ = _assign(key, sc, **kw)
    return ([iid for iid, asg in per.items()
             if asg["seg_0"]["state"] == "LEADER"], changed,
            epochs["seg_0"])


def test_assign_resource_keeps_an_in_flight_ledger_leader():
    """F23: within the grace (``promoting``) the port keeps the ledger's
    leader and mints nothing; the reference, and the port past the
    grace, mint a new epoch for the best-ranked serving replica."""
    sc, ranked = _in_flight_scenario()
    minted = ([ranked[0]], ["seg_0"], {"epoch": 2, "leader": ranked[0]})
    assert _leaders("ref", sc) == minted
    assert _leaders("port", sc) == minted
    assert _leaders("port", sc, promoting=set()) == minted
    assert _leaders("port", sc, promoting={"seg_0"}) == (
        [ranked[1]], [], {"epoch": 1, "leader": ranked[1]})
    # a ledger leader in ERROR has failed its promotion: no grace
    sc["current"][ranked[1]]["seg_0"] = "ERROR"
    assert _leaders("port", sc, promoting={"seg_0"}) == minted


def test_in_grace_drops_old_and_superseded_records():
    ctrl = _mod("port", "controller")
    grace = ctrl.PROMOTION_GRACE
    minted = {"a": (3, 100.0), "b": (1, 100.0), "c": (2, 90.0)}
    epochs = {"a": {"epoch": 3, "leader": "x"},
              "b": {"epoch": 2, "leader": "y"},  # superseded
              "c": {"epoch": 2, "leader": "z"}}
    assert ctrl.in_grace(minted, epochs, 100.0 + grace / 2) == {"a"}
    assert minted == {"a": (3, 100.0)}
    assert ctrl.in_grace(minted, epochs, 100.0 + grace) == set()
    assert minted == {}


def test_a_ledger_leader_that_never_promotes_is_replaced_within_grace():
    """The controller's passes as ``Controller.reconcile`` runs them, on a
    clock: the leader minted at t = 0 never reports LEADER. Each pass
    before the grace keeps it and mints nothing; the first pass past it
    mints the best-ranked serving replica, and once that one claims, the
    partition has one leader and the ledger stays."""
    ctrl = _mod("port", "controller")
    grace = ctrl.PROMOTION_GRACE
    sc, ranked = _in_flight_scenario()
    sc["epochs"], minted, history = {}, {}, []
    sc["current"] = {iid: {"seg_0": "OFFLINE"} for iid in sc["live"]}
    for t in [0.0, 1.0, grace / 2, grace - 0.5, grace, grace + 1.0]:
        promoting = ctrl.in_grace(minted, sc["epochs"], t)
        per, changed, epochs, _ = _assign("port", sc, promoting=promoting)
        for partition in changed:
            minted[partition] = (epochs[partition]["epoch"], t)
        sc["epochs"] = epochs
        leader = [iid for iid, asg in per.items()
                  if asg["seg_0"]["state"] == "LEADER"]
        history.append((t, leader, epochs["seg_0"]["epoch"]))
        # every replica but the one the first pass minted serves; that
        # one never gets past its promotion, and the second one does
        for iid in sc["live"]:
            if iid != history[0][1][0]:
                sc["current"][iid]["seg_0"] = (
                    "LEADER" if leader == [iid] else "FOLLOWER")
    first = history[0][1]
    assert first == [ranked[0]]
    assert [h for h in history if h[0] < grace] == [
        (t, first, 1) for t in [0.0, 1.0, grace / 2, grace - 0.5]]
    assert history[-2] == (grace, [ranked[1]], 2)
    assert history[-1] == (grace + 1.0, [ranked[1]], 2)


def test_assign_resource_sequence_equals_reference():
    """A failover sequence fed back through both controllers: each pass's
    assignments become the next pass's current states, an instance
    dies and one joins, and the epoch ledger carries across passes."""
    sc = _scenario(11)
    sc["resource"].update(state_model="LeaderFollower", replicas=3,
                          num_shards=6)
    sc["pins"], sc["splits"], sc["epochs"], sc["current"] = {}, [], {}, {}
    sc["live"] = [f"10.0.0.{i}_{9090 + i}" for i in range(4)]
    got = {"port": [], "ref": []}
    for key in got:
        s = copy.deepcopy(sc)
        for step in range(6):
            per, _changed, s["epochs"], _ = _assign(key, s)
            got[key].append((per, copy.deepcopy(s["epochs"])))
            s["current"] = {iid: {p: a["state"] for p, a in asg.items()}
                            for iid, asg in per.items()}
            if step == 2:  # the leader of most shards dies
                lead = max(per, key=lambda i: sum(
                    a["state"] == "LEADER" for a in per[i].values()))
                s["live"].remove(lead)
            if step == 4:  # a replacement joins
                s["live"].append("10.0.0.9_9099")
    assert got["port"] == got["ref"]


def _fake_coord(sc: dict, model) -> "_DictCoord":
    """An in-memory coordinator view of ``sc`` (instances, resources,
    current states, split records) for ``generate_shard_map``."""
    seg = sc["resource"]["segment"]
    tree = {}
    base = "/clusters/c"
    for iid in sc["live"]:
        tree[f"{base}/instances/{iid}"] = model.InstanceInfo(
            iid, iid.split("_")[0], int(iid.split("_")[1]),
            int(iid.split("_")[1]) + 1000, "az-" + iid[-1]).encode()
    tree[f"{base}/resources/{seg}"] = model.ResourceDef(
        **sc["resource"]).encode()
    tree[f"{base}/resources/other"] = model.ResourceDef(
        "other", 2).encode()
    for iid, states in sc["current"].items():
        tree[f"{base}/currentstates/{iid}"] = model.encode_states(states)
    for d in sc["splits"]:
        tree[f"{base}/splits/{seg}_{d['parent_shard']}"] = \
            model.SplitRecord(**d).encode()
    return _DictCoord(tree)


class _DictCoord:
    def __init__(self, tree):
        self.tree = tree

    def list(self, path):
        pre = path.rstrip("/") + "/"
        return sorted({k[len(pre):].split("/")[0] for k in self.tree
                       if k.startswith(pre)})

    def get_or_none(self, path):
        return self.tree.get(path)


@pytest.mark.parametrize("seed", range(12))
def test_generate_shard_map_equals_reference(seed):
    sc = _scenario(seed)
    maps = {}
    for key in PACKAGES:
        model = _mod(key, "model")
        cfg = _mod(key, "config_generator")
        maps[key] = json.dumps(
            cfg.generate_shard_map(_fake_coord(sc, model), "c"),
            sort_keys=True)
    assert maps["port"] == maps["ref"]


@pytest.mark.parametrize("seed", range(6))
def test_model_encodings_equal_reference(seed):
    sc = _scenario(seed)
    out = {}
    for key in PACKAGES:
        m = _mod(key, "model")
        iid = sc["live"][0]
        blobs = [
            m.InstanceInfo(iid, "10.0.0.1", 9090, 10090, "az-a").encode(),
            m.ResourceDef(**sc["resource"]).encode(),
            m.encode_states(sc["current"].get(iid, {"x_0": "LEADER"})),
            m.encode_assignments({
                p: m.PartitionAssignment(st, "10.0.0.1:10090", i)
                for i, (p, st) in enumerate(sorted(
                    next(iter(sc["current"].values()), {}).items()))}),
            m.cluster_path("c", "a", "b").encode(),
        ]
        blobs += [m.PlacementPin(**d).encode() for d in sc["pins"].values()]
        blobs += [m.SplitRecord(**d).encode() for d in sc["splits"]]
        # decode(encode(x)) re-encodes to the same bytes in each package
        round_trip = [
            m.InstanceInfo.decode(blobs[0]).encode(),
            m.ResourceDef.decode(blobs[1]).encode(),
            m.encode_states(m.decode_states(blobs[2])),
            m.encode_assignments(m.decode_assignments(blobs[3])),
        ]
        round_trip += [m.PlacementPin.decode(
            m.PlacementPin(**d).encode()).encode()
            for d in sc["pins"].values()]
        round_trip += [m.SplitRecord.decode(
            m.SplitRecord(**d).encode()).encode() for d in sc["splits"]]
        out[key] = (blobs, round_trip,
                    m.PlacementPin.decode(b"not json"),
                    m.SplitRecord.decode(b'{"bogus": 1}'))
    assert out["port"] == out["ref"]


def _plans(key: str) -> dict:
    sm = importlib.import_module(f"{PACKAGES[key]}.cluster.state_models")
    base = importlib.import_module(
        f"{PACKAGES[key]}.cluster.state_models.base")
    table = {}
    for name, factory in sorted(sm.FACTORIES.items()):
        model = factory(ctx=None).get(f"{name}_0")
        states = sorted({s for e in model.edges for s in e})
        table[name] = {"edges": list(model.edges),
                       "initial": model.initial_state}
        for a in states:
            for b in states:
                try:
                    table[name][f"{a}->{b}"] = model.plan(a, b)
                except base.TransitionError as e:
                    table[name][f"{a}->{b}"] = f"error: {e}"
    return table


def test_state_model_plans_equal_reference():
    got, want = _plans("port"), _plans("ref")
    assert sorted(got) == sorted(want) == sorted(STATE_MODELS)
    assert got == want


def test_event_history_equals_reference(tmp_path):
    """The same scripted transition events, logged through each package's
    ClusterContext into one coordinator, read back to the same history
    (wall-clock stamps masked) and the same leader analysis."""
    from rocksplicator_tpu_torch.cluster.coordinator import (
        CoordinatorClient, CoordinatorServer)

    server = CoordinatorServer(port=0, session_ttl=5.0)
    script = [("seg_0", "offline_to_follower_init", ""),
              ("seg_0", "offline_to_follower_success", ""),
              ("seg_1", "offline_to_follower_init", ""),
              ("seg_1", "offline_to_follower_failure", "no peer"),
              ("seg_0", "follower_to_leader_init", ""),
              ("seg_0", "catch_up_via_peer", "10.0.0.2_9091"),
              ("seg_0", "follower_to_leader_success", ""),
              ("seg_0", "leader_to_follower_init", ""),
              ("seg_0", "deposed_resync_init", "epoch 3"),
              ("seg_0", "deposed_resync_success", ""),
              ("seg_0", "leader_to_follower_success", "")]
    script += [("seg_2", f"follower_to_leader_{o}", str(i))
               for i in range(40) for o in ("init", "success")]
    got = {}
    try:
        for key in PACKAGES:
            cluster = f"ev-{key}"
            client = importlib.import_module(
                f"{PACKAGES[key]}.cluster.coordinator").CoordinatorClient(
                    "127.0.0.1", server.port)
            model = _mod(key, "model")
            base = importlib.import_module(
                f"{PACKAGES[key]}.cluster.state_models.base")
            ctx = base.ClusterContext(
                client, None, cluster,
                model.InstanceInfo("10.0.0.1_9090", "10.0.0.1", 9090,
                                   10090))
            for partition, event, detail in script:
                ctx.log_event(partition, event, detail)
            es = _mod(key, "eventstore")
            hist = {}
            for p in ("seg_0", "seg_1", "seg_2", "seg_9"):
                h = es.analyze_leader_history(client, cluster, p)
                for e in h["events"]:
                    e.pop("ts_ms")
                hist[p] = h
            got[key] = hist
            client.close()
        reader = CoordinatorClient("127.0.0.1", server.port)
        assert reader.list("/clusters/ev-port/events") == \
            reader.list("/clusters/ev-ref/events")
        reader.close()
    finally:
        server.stop()
    assert got["port"]["seg_2"]["num_events"] == 64  # capped
    assert got["port"] == got["ref"]
