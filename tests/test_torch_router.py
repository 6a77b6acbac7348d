"""The port's shard-map router (``rpc/router.py``) against the JAX
package's: the thrift_router_test scenarios (role, AZ locality,
quantities, rotation, the shard-map file watcher) on each package's
router; ``ClusterLayout.parse`` and ``get_hosts_for`` equal across the
packages for every (segment, shard, role, quantity, local AZ) of seeded
shard maps; bounded-staleness read policies, the bounce to the leader and
routed writes; hedged reads (the loser cancelled, a late reply dropped,
the budget, the ``router.hedge.fire`` seam, the killswitch, multi_get);
and a port router over reference servers, and the other way round.
Tolerance 0: host lists, replies and counters are compared exactly.
"""

import asyncio
import importlib
import itertools
import json
import random
import time

import pytest

PKGS = {"ref": "rocksplicator_tpu", "port": "rocksplicator_tpu_torch"}
# (router's package, servers' package)
MIXED = [("port", "port"), ("port", "ref"), ("ref", "port")]
MIXED_IDS = [f"router_{r}-servers_{s}" for r, s in MIXED]


def mod(key: str, name: str):
    return importlib.import_module(f"{PKGS[key]}.{name}")


class Pkg:
    """One package's router-facing names."""

    def __init__(self, key: str):
        self.key = key
        rpc = mod(key, "rpc")
        router = mod(key, "rpc.router")
        self.IoLoop, self.RpcServer = rpc.IoLoop, rpc.RpcServer
        self.RpcRouter, self.ClusterLayout = router.RpcRouter, \
            router.ClusterLayout
        self.Role, self.Quantity = router.Role, router.Quantity
        self.ReadPolicy = router.ReadPolicy
        self.Stats = mod(key, "utils.stats").Stats
        self.tagged = mod(key, "utils.stats").tagged
        self.fp = mod(key, "testing.failpoints")
        self.FileWatcher = mod(key, "utils.file_watcher").FileWatcher
        self.RpcClient = mod(key, "rpc.client").RpcClient

    def router(self, shard_map: dict, local_az="az1", **kw):
        router = self.RpcRouter(local_az=local_az, **kw)
        router.update_layout(self.ClusterLayout.parse(
            json.dumps(shard_map).encode()))
        return router

    def counter(self, name: str) -> float:
        s = self.Stats.get()
        s.flush()
        return s.get_counter(name)


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' Stats, spans, failpoints, admission and file
    watchers start empty (tests/conftest.py resets only the
    reference's Stats and spans)."""
    from torch_parity import reset_observability

    import rocksplicator_tpu
    import rocksplicator_tpu_torch

    reset_observability(rocksplicator_tpu, rocksplicator_tpu_torch,
                        sample_rate=0.0)
    for key in PKGS:
        mod(key, "rpc.admission").TenantAdmission.reset_for_test()
        mod(key, "utils.file_watcher").FileWatcher.reset_for_test()
    yield
    for key in PKGS:
        mod(key, "testing.failpoints").reset_for_test()
        mod(key, "utils.file_watcher").FileWatcher.reset_for_test()


# ---------------------------------------------------------------------------
# thrift_router_test parity, on each package's router
# ---------------------------------------------------------------------------

SHARD_MAP = {
    "seg": {
        "num_shards": 3,
        "10.0.0.1:9090:az1": ["00000:M", "00001:S"],
        "10.0.0.2:9090:az2": ["00000:S", "00001:M", "00002:S"],
        "10.0.0.3:9090:az1": ["00000:S", "00002:M"],
    }
}


def _static_cases(p: Pkg):
    R, Q = p.Role, p.Quantity
    router = p.router(SHARD_MAP)
    out = {"counts": (router.num_shards("seg"), router.num_shards("missing"),
                      router.get_hosts_for("missing", 0))}
    out["leaders"] = [[h.ip for h in router.get_hosts_for(
        "seg", s, R.LEADER, Q.ALL)] for s in range(3)]
    hosts = router.get_hosts_for("seg", 0, R.FOLLOWER, Q.ALL)
    out["followers"] = [h.ip for h in hosts]
    out["any"] = [h.ip for h in router.get_hosts_for("seg", 0, R.ANY, Q.ALL)]
    out["any_az2"] = [h.ip for h in p.router(SHARD_MAP, "az2").get_hosts_for(
        "seg", 2, R.ANY, Q.ALL)]
    out["quantities"] = [len(router.get_hosts_for("seg", 0, R.ANY, q))
                         for q in (Q.ONE, Q.TWO, Q.ALL)]
    rot = p.router(SHARD_MAP, "")
    out["rotation"] = (rot.get_hosts_for("seg", 0, R.FOLLOWER, Q.ALL)
                       == rot.get_hosts_for("seg", 0, R.FOLLOWER, Q.ALL))
    prefix_map = {"seg": {"num_shards": 1,
                          "10.0.0.1:1:us-east-1a": ["00000:S"],
                          "10.0.0.2:1:us-east-1b": ["00000:S"],
                          "10.0.0.3:1:eu-west-1a": ["00000:S"]}}
    out["group_prefix"] = [h.ip for h in p.router(
        prefix_map, "us-east-1a", local_group_prefix_len=9).get_hosts_for(
        "seg", 0, R.FOLLOWER, Q.ALL)]
    return out


@pytest.mark.parametrize("key", list(PKGS))
def test_router_static_scenarios(key):
    """Each of the reference's thrift_router_test cases on one package's
    router, then the same answers from the other package's."""
    got = _static_cases(Pkg(key))
    assert got["counts"] == (3, 0, [])
    assert got["leaders"] == [["10.0.0.1"], ["10.0.0.2"], ["10.0.0.3"]]
    # the az1-local follower sorts before the az2 one
    assert got["followers"] == ["10.0.0.3", "10.0.0.2"]
    # the local leader first, then the local follower, then the remote
    assert got["any"] == ["10.0.0.1", "10.0.0.3", "10.0.0.2"]
    assert got["any_az2"] == ["10.0.0.2", "10.0.0.3"]
    assert got["quantities"] == [1, 2, 3]
    assert got["rotation"] is True
    assert got["group_prefix"] == ["10.0.0.1", "10.0.0.2", "10.0.0.3"]
    other = "port" if key == "ref" else "ref"
    assert _static_cases(Pkg(other)) == got


@pytest.mark.parametrize("key", list(PKGS))
def test_router_hot_reload_and_close(key, tmp_path):
    """The shard-map file is watched: a rewrite reloads it, a malformed
    rewrite keeps the previous layout, and close() stops watching."""
    p = Pkg(key)
    watcher = p.FileWatcher.instance()
    path = tmp_path / "shard_map.json"
    path.write_text(json.dumps(SHARD_MAP))
    router = p.RpcRouter(local_az="az1", shard_map_path=str(path))
    assert router.num_shards("seg") == 3
    path.write_text(json.dumps(
        {"seg": {"num_shards": 1, "10.9.9.9:1:az9": ["00000:M"]}}))
    watcher.poll_now()
    assert router.num_shards("seg") == 1
    assert router.get_hosts_for("seg", 0, p.Role.LEADER)[0].ip == "10.9.9.9"
    path.write_text("not json")
    watcher.poll_now()
    assert router.num_shards("seg") == 1
    router.close()
    path.write_text(json.dumps(
        {"seg": {"num_shards": 9, "1.2.3.4:1:az": ["00000:M"]}}))
    watcher.poll_now()
    assert router.num_shards("seg") == 1


def seeded_shard_map(seed: int) -> dict:
    """Segments of 1-6 shards over 2-6 hosts in 1-3 AZs, each host key
    with or without the 4th (replication port) field; every shard has
    one leader and the rest followers, some hosts hold nothing."""
    rng = random.Random(seed)
    out = {}
    for s in range(rng.randint(1, 3)):
        shards = rng.randint(1, 6)
        hosts = [f"10.{seed}.{s}.{h}:{9000 + h}:az{rng.randint(1, 3)}"
                 + (f":{9500 + h}" if rng.random() < 0.5 else "")
                 for h in range(rng.randint(2, 6))]
        seg = {"num_shards": shards}
        for h in hosts:
            seg[h] = []
        for shard in range(shards):
            replicas = rng.sample(hosts, rng.randint(1, len(hosts)))
            for i, h in enumerate(replicas):
                seg[h].append(f"{shard:05d}:{'M' if i == 0 else 'S'}")
        out[f"seg{s}"] = seg
    return out


@pytest.mark.parametrize("seed", range(4))
def test_layout_and_hosts_equal_reference(seed):
    """ClusterLayout.parse and get_hosts_for answer alike in both
    packages for every segment, shard (and one past the last), role,
    quantity and local AZ of a seeded shard map."""
    shard_map = seeded_shard_map(seed)
    raw = json.dumps(shard_map).encode()
    ref, port = Pkg("ref"), Pkg("port")

    def layout(p):
        lay = p.ClusterLayout.parse(raw)
        return {name: (seg.num_shards, {
            shard: [((h.ip, h.port, h.az, h.repl_addr), r.name)
                    for h, r in hosts]
            for shard, hosts in seg.shard_to_hosts.items()})
            for name, seg in lay.segments.items()}

    assert layout(port) == layout(ref)
    compared = 0
    for az in ("az1", "az2", "az3", ""):
        routers = {p.key: p.router(shard_map, az) for p in (ref, port)}
        for name, seg in shard_map.items():
            for shard in range(seg["num_shards"] + 1):
                for role in ("LEADER", "FOLLOWER", "ANY"):
                    for q in ("ONE", "TWO", "ALL"):
                        got = {k: [(h.ip, h.port, h.az, h.repl_addr)
                                   for h in r.get_hosts_for(
                                       name, shard,
                                       getattr(Pkg(k).Role, role),
                                       getattr(Pkg(k).Quantity, q))]
                               for k, r in routers.items()}
                        assert got["port"] == got["ref"], (
                            name, shard, role, q, az)
                        compared += 1
    assert compared == 4 * 9 * sum(seg["num_shards"] + 1
                                   for seg in shard_map.values())


# ---------------------------------------------------------------------------
# routing over live servers, mixed packages
# ---------------------------------------------------------------------------


class EchoHandler:
    async def handle_echo(self, text=""):
        return {"text": text}


@pytest.mark.parametrize("router_key,server_key", MIXED, ids=MIXED_IDS)
def test_get_clients_skips_bad_hosts(router_key, server_key):
    """A dead leader is skipped: the one live replica's client comes
    back, and the call through it answers."""
    rp, sp = Pkg(router_key), Pkg(server_key)
    server = sp.RpcServer(port=0, ioloop=sp.IoLoop.default())
    server.add_handler(EchoHandler())
    server.start()
    try:
        router = rp.router({"seg": {
            "num_shards": 1,
            f"127.0.0.1:{server.port}:az1": ["00000:S"],
            "127.0.0.1:1:az1": ["00000:M"]}})

        async def go():
            clients = await router.get_clients_for(
                "seg", 0, rp.Role.ANY, rp.Quantity.ONE)
            assert [c.port for c in clients] == [server.port]
            out = await clients[0].call("echo", {"text": "hi"})
            await router.pool.close()
            return out

        assert rp.IoLoop.default().run_sync(go()) == {"text": "hi"}
    finally:
        server.stop()


def _flags(p: Pkg):
    return mod(p.key, "replication").ReplicationFlags(
        server_long_poll_ms=200, pull_error_delay_min_ms=30,
        pull_error_delay_max_ms=80, ack_timeout_ms=2000,
        consecutive_timeouts_to_degrade=1000,
        empty_pulls_before_reset=1 << 30, read_info_ttl_ms=100,
        read_probe_timeout_ms=1000)


class Pair:
    """A leader and a follower of one package over TCP loopback, mode 1
    (the reference's test_follower_reads harness)."""

    def __init__(self, p: Pkg, tmp_path):
        repl = mod(p.key, "replication")
        storage = mod(p.key, "storage")
        self.p = p
        flags = _flags(p)
        self.leader = repl.Replicator(port=0, flags=flags)
        self.follower = repl.Replicator(port=0, flags=flags)
        kw = {}
        if p.key == "port":
            kw["compaction_backend"] = mod(
                "port", "storage.native_compaction").NativeCompactionBackend()
        self.ldb = storage.DB(str(tmp_path / "l"), storage.DBOptions(
            wal_ttl_seconds=3600.0, **kw))
        self.fdb = storage.DB(str(tmp_path / "f"), storage.DBOptions(
            wal_ttl_seconds=3600.0, **kw))
        self.WriteBatch = storage.WriteBatch
        self.lrdb = self.leader.add_db(
            "seg00000", repl.StorageDbWrapper(self.ldb),
            repl.ReplicaRole.LEADER, replication_mode=1)
        self.frdb = self.follower.add_db(
            "seg00000", repl.StorageDbWrapper(self.fdb),
            repl.ReplicaRole.FOLLOWER,
            upstream_addr=("127.0.0.1", self.leader.port),
            replication_mode=1)

    def write(self, n, tag=b"k"):
        for i in range(n):
            self.lrdb.write(self.WriteBatch().put(
                b"%s%04d" % (tag, i), b"v%04d" % i))

    def converged(self):
        return (self.fdb.latest_sequence_number_relaxed()
                == self.ldb.latest_sequence_number_relaxed())

    def block_pulls(self):
        self.p.fp.activate("repl.pull", "fail_prob:1.0@seed1")
        time.sleep(0.2 + 0.3)

    def layout(self, rp: Pkg):
        lp, fpn = self.leader.port, self.follower.port
        return rp.ClusterLayout.parse(json.dumps({"seg": {
            "num_shards": 1,
            f"127.0.0.1:{lp}:az-a:{lp}": ["00000:M"],
            f"127.0.0.1:{fpn}:az-b:{fpn}": ["00000:S"]}}).encode())

    def stop(self):
        self.leader.stop()
        self.follower.stop()
        self.ldb.close()
        self.fdb.close()


def wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


@pytest.fixture()
def mixed_pair(request, tmp_path):
    router_key, server_key = request.param
    pair = Pair(Pkg(server_key), tmp_path)
    yield Pkg(router_key), pair
    pair.stop()


@pytest.mark.parametrize("mixed_pair", MIXED, ids=MIXED_IDS, indirect=True)
def test_router_policies_and_bounce(mixed_pair):
    """leader_only reads the leader; follower_ok rotates over both
    replicas; nearest prefers the local follower; a follower frozen past
    the bound bounces every read to the leader, counted in the router's
    package."""
    rp, pair = mixed_pair
    pair.write(8)
    assert wait_until(pair.converged)
    router = rp.RpcRouter(local_az="az-b")
    router.update_layout(pair.layout(rp))
    ioloop = rp.IoLoop.default()

    def read(policy):
        async def go():
            return await router.read("seg", 0, op="get", keys=[b"k0003"],
                                     policy=policy)
        return ioloop.run_sync(go(), timeout=10)

    try:
        r = read(rp.ReadPolicy.leader_only())
        assert r["source_role"] == "LEADER"
        assert bytes(r["values"][0]) == b"v0003"
        roles = {read(rp.ReadPolicy.follower_ok(64))["source_role"]
                 for _ in range(6)}
        assert roles == {"LEADER", "FOLLOWER"}
        assert read(rp.ReadPolicy.nearest(64))["source_role"] == "FOLLOWER"
        pair.block_pulls()
        pair.write(4, tag=b"y")
        for _ in range(4):
            assert read(rp.ReadPolicy.follower_ok(0))["source_role"] \
                == "LEADER"
        assert rp.counter("router.read_bounces code=stale_read") >= 1
    finally:
        ioloop.run_sync(router.pool.close(), timeout=10)


@pytest.mark.parametrize("mixed_pair", MIXED, ids=MIXED_IDS, indirect=True)
def test_read_pick_and_routed_write(mixed_pair):
    """read_pick's chains (the leader alone; a rotated group that always
    holds the leader), a bogus policy refused, and a routed write that
    lands on the leader and is acked."""
    rp, pair = mixed_pair
    router = rp.RpcRouter(local_az="az-a")
    router.update_layout(pair.layout(rp))
    ioloop = rp.IoLoop.default()
    try:
        picks = router.read_pick("seg", 0, rp.ReadPolicy.leader_only())
        assert [h.port for h in picks] == [pair.leader.port]
        firsts = {router.read_pick("seg", 0, rp.ReadPolicy.follower_ok(8))
                  [0].port for _ in range(8)}
        assert firsts == {pair.leader.port, pair.follower.port}
        for _ in range(4):
            chain = router.read_pick("seg", 0, rp.ReadPolicy.follower_ok(8))
            assert pair.leader.port in [h.port for h in chain]
        with pytest.raises(ValueError):
            router.read_pick("seg", 0, rp.ReadPolicy("bogus"))

        async def go():
            return await router.write(
                "seg", 0, pair.WriteBatch().put(b"routed", b"w").encode())

        assert ioloop.run_sync(go(), timeout=10)["acked"] is True
        assert pair.ldb.get(b"routed") == b"w"
    finally:
        ioloop.run_sync(router.pool.close(), timeout=10)


# ---------------------------------------------------------------------------
# hedged reads
# ---------------------------------------------------------------------------


class ReadHandler:
    """A replica whose ``read`` (wire-cancellable) sleeps ``delay_s`` and
    answers who it is, with a value derived from each key."""

    def __init__(self, who: str, delay_s: float = 0.0):
        self.who, self.delay_s = who, delay_s

    async def handle_read(self, op="get", keys=None, **_kw):
        try:
            await asyncio.sleep(self.delay_s)
        except asyncio.CancelledError:
            self.saw_cancel = True
            raise
        self.answered = True
        return {"who": self.who,
                "values": [b"v:" + bytes(k) for k in (keys or [])]}


class Hedge:
    """A follower_ok layout whose follower is slow and leader fast, the
    rotation pinned so the chain starts at the follower."""

    def __init__(self, rp: Pkg, sp: Pkg, slow_delay: float):
        self.rp, self.sp = rp, sp
        self.slow = ReadHandler("slow", slow_delay)
        self.fast = ReadHandler("fast")
        self.servers = []
        for h in (self.slow, self.fast):
            srv = sp.RpcServer(port=0, ioloop=sp.IoLoop.default())
            srv.add_handler(h)
            srv.start()
            self.servers.append(srv)
        self.router = rp.router({"seg": {
            "num_shards": 1,
            f"127.0.0.1:1:az1:{self.servers[0].port}": ["00000:S"],
            f"127.0.0.1:2:az1:{self.servers[1].port}": ["00000:M"]}})
        self.router._read_seq = itertools.count()
        self.ioloop = rp.IoLoop.default()

    def read(self, op="get", keys=(b"k",)):
        async def go():
            return await self.router.read(
                "seg", 0, op=op, keys=list(keys),
                policy=self.rp.ReadPolicy.follower_ok(max_lag=5),
                timeout=10.0)
        return self.ioloop.run_sync(go(), timeout=20)

    def wait_for(self, handler, attr):
        deadline = time.monotonic() + 3
        while not getattr(handler, attr, False) \
                and time.monotonic() < deadline:
            self.ioloop.run_sync(asyncio.sleep(0.02))
        return getattr(handler, attr, False)

    def close(self):
        self.ioloop.run_sync(self.router.pool.close(), timeout=10)
        for srv in self.servers:
            srv.stop()


@pytest.fixture()
def hedge(request):
    made = []

    def make(slow_delay=0.25):
        router_key, server_key = request.param
        h = Hedge(Pkg(router_key), Pkg(server_key), slow_delay)
        made.append(h)
        return h

    yield make
    for h in made:
        h.close()


@pytest.mark.parametrize("hedge", MIXED, ids=MIXED_IDS, indirect=True)
@pytest.mark.parametrize("op", ["get", "multi_get"])
def test_hedged_read_loser_cancelled(hedge, op, monkeypatch):
    """The hedge covers the slow follower: the fast leader's one answer
    surfaces with every key's value in order, the hedge and its win are
    counted in the router's package, and the loser's wire cancel lands
    on the slow server (counted in the servers' package)."""
    monkeypatch.setenv("RSTPU_HEDGE_FLOOR_MS", "10")
    h = hedge()
    h.router._hedge_credit = 1.0
    keys = [b"k2", b"k0", b"k1"] if op == "multi_get" else [b"k"]
    out = h.read(op, keys)
    assert out["who"] == "fast"
    assert [bytes(v) for v in out["values"]] == [b"v:" + k for k in keys]
    assert h.rp.counter(h.rp.tagged("router.hedges", op=op)) == 1
    assert h.rp.counter(h.rp.tagged("router.hedge_wins", op=op)) == 1
    assert h.wait_for(h.slow, "saw_cancel")
    if op == "get":
        assert h.sp.counter(h.sp.tagged("rpc.cancelled", method="read")) == 1


@pytest.mark.parametrize("hedge", MIXED, ids=MIXED_IDS, indirect=True)
def test_hedged_read_late_reply_discarded(hedge, monkeypatch):
    """With the loser's cancel frame suppressed both replicas answer:
    one result surfaces and the late reply is dropped."""
    monkeypatch.setenv("RSTPU_HEDGE_FLOOR_MS", "10")

    async def no_cancel(self, req_id):
        return None

    h = hedge(slow_delay=0.1)
    monkeypatch.setattr(h.rp.RpcClient, "_send_cancel", no_cancel)
    h.router._hedge_credit = 1.0
    assert h.read()["who"] == "fast"
    assert h.rp.counter(h.rp.tagged("router.hedges", op="get")) == 1
    assert h.rp.counter(h.rp.tagged("router.hedge_wins", op="get")) == 1
    assert h.wait_for(h.slow, "answered")
    assert getattr(h.fast, "answered", False)
    assert not getattr(h.slow, "saw_cancel", False)
    assert h.sp.counter(h.sp.tagged("rpc.cancelled", method="read")) == 0


@pytest.mark.parametrize("hedge", MIXED, ids=MIXED_IDS, indirect=True)
@pytest.mark.parametrize("case", ["budget_denied", "fire_failpoint",
                                  "killswitch"])
def test_hedge_degrades_to_plain_chain(hedge, case, monkeypatch):
    """No credit (RSTPU_HEDGE_PCT=0), the ``router.hedge.fire`` seam
    armed, or hedging switched off (RSTPU_HEDGE=0): the plain chain runs
    and the slow follower's answer surfaces, no hedge counted."""
    monkeypatch.setenv("RSTPU_HEDGE_FLOOR_MS", "5")
    if case == "budget_denied":
        monkeypatch.setenv("RSTPU_HEDGE_PCT", "0.0")
    if case == "killswitch":
        monkeypatch.setenv("RSTPU_HEDGE", "0")
    h = hedge(slow_delay=0.05)
    h.router._hedge_credit = {"budget_denied": 0.0, "fire_failpoint": 1.0,
                              "killswitch": 5.0}[case]
    if case == "fire_failpoint":
        with h.rp.fp.failpoint("router.hedge.fire", "fail_first:1"):
            out = h.read()
    else:
        out = h.read()
    assert out["who"] == "slow"
    assert h.rp.counter(h.rp.tagged("router.hedges", op="get")) == 0
    assert h.rp.counter(h.rp.tagged("router.hedge_wins", op="get")) == 0
    assert h.rp.counter(h.rp.tagged("router.hedge_budget_denied",
                                    op="get")) == (
        1 if case == "budget_denied" else 0)
