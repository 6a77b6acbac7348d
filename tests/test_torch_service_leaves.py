"""The port's service leaves against the JAX package's: the status server
(``utils/status_server.py``: every endpoint, the bodies equal with
timestamps masked), the hot-key detector (``utils/hot_key_detector.py``:
``top()``, ``total()`` and ``is_above`` on one seeded stream under a fake
clock), graceful shutdown (``utils/graceful_shutdown.py``: the order of
hooks and server stops) and the hedging combinator
(``utils/future_util.py``). Tolerance 0.
"""

import asyncio
import importlib
import json
import random
import re
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

PKGS = {"ref": "rocksplicator_tpu", "port": "rocksplicator_tpu_torch"}


def mod(key: str, name: str):
    return importlib.import_module(f"{PKGS[key]}.{name}")


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' Stats, spans and status servers start empty (the
    status server is a singleton in each package; tests/conftest.py
    resets only the reference's Stats and spans)."""
    from torch_parity import reset_observability

    import rocksplicator_tpu
    import rocksplicator_tpu_torch

    reset_observability(rocksplicator_tpu, rocksplicator_tpu_torch,
                        sample_rate=0.0)
    for key in PKGS:
        mod(key, "utils.status_server").StatusServer.reset_for_test()
    yield
    for key in PKGS:
        mod(key, "utils.status_server").StatusServer.reset_for_test()


# ---------------------------------------------------------------------------
# status server
# ---------------------------------------------------------------------------


def _get(base: str, path: str) -> str:
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return r.read().decode()


def _masked(text: str) -> str:
    """Host-clock values (times, rates, ages) and the per-process identity
    replaced by a mark."""
    text = re.sub(r'"process": "[^"]*"', '"process": <p>', text)
    return re.sub(r"\d+\.\d+(e[-+]?\d+)?", "<t>", text)


def _serve(key: str):
    """One package's status server with the counter service's extra
    endpoints and the same counters, timers and gauge fed."""
    st = mod(key, "utils.stats")
    stats = st.Stats.get()
    stats.incr("served")
    stats.incr(st.tagged("compaction.sched_picks", kind="l0"), 2)
    stats.add_metric("admin.compact_ms", 12.5)
    stats.add_gauge("storage.level_files db=seg00000", lambda: 3.0)
    return mod(key, "utils.status_server").StatusServer.start_status_server(
        port=0, extra_endpoints={
            "/storage_info.txt": lambda: "dbs=0\n",
            "/hotkeys.txt": lambda: "counter-1 count=2.0 share=1.000\n"})


def test_status_server_endpoints_equal_reference():
    """Every endpoint of each package's server answers; the index,
    /stats.txt, /metrics, /stats.json, /traces, /traces.txt and the extra
    endpoints carry the same bodies (host-clock values masked); the
    flags both packages define have the same values; /threads.txt and
    the two-phase /dump_heap work; an unknown path is a 404."""
    import tracemalloc

    bodies = {}
    for key in PKGS:
        mod(key, "admin.handler")  # defines the admin plane's flags
        srv = _serve(key)
        base = f"http://127.0.0.1:{srv.port}"
        got = {p: _get(base, p) for p in (
            "/", "/stats.txt", "/metrics", "/stats.json", "/traces",
            "/traces.txt", "/storage_info.txt", "/hotkeys.txt",
            "/flags.txt", "/gflags.txt")}
        assert "counter served total=1" in got["/stats.txt"]
        assert "thread" in _get(base, "/threads.txt")
        assert "started" in _get(base, "/dump_heap")
        _garbage = [bytearray(4096) for _ in range(64)]
        assert "allocation sites by size" in _get(base, "/dump_heap")
        assert not tracemalloc.is_tracing()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base, "/nope")
        assert ei.value.code == 404
        json.loads(got["/stats.json"])
        assert json.loads(got["/traces"])["traces"] == []
        bodies[key] = got
        mod(key, "utils.status_server").StatusServer.reset_for_test()
    for path in ("/", "/stats.txt", "/metrics", "/stats.json",
                 "/traces.txt", "/storage_info.txt", "/hotkeys.txt"):
        assert _masked(bodies["port"][path]) == _masked(bodies["ref"][path]), \
            path
    traces = {k: json.loads(b["/traces"]) for k, b in bodies.items()}
    for doc in traces.values():
        doc.pop("process", None)
    assert traces["port"] == traces["ref"]
    flags = {k: dict(line.split("=", 1) for line in
                     b["/flags.txt"].splitlines()
                     if line.startswith("--") and "=" in line)
             for k, b in bodies.items()}
    assert bodies["port"]["/gflags.txt"] == bodies["port"]["/flags.txt"]
    shared = set(flags["port"]) & set(flags["ref"])
    assert "--s3_direct_io" in shared
    assert {f: flags["port"][f] for f in shared} == {
        f: flags["ref"][f] for f in shared}


def test_status_server_singleton_and_register():
    """start_status_server hands back the one running server; endpoints
    registered later are served; reset_for_test stops it."""
    M = mod("port", "utils.status_server").StatusServer
    a = M.start_status_server(port=0)
    assert M.start_status_server(port=0) is a
    a.register_endpoint("/late.txt", lambda: "late\n")
    assert _get(f"http://127.0.0.1:{a.port}", "/late.txt") == "late\n"
    M.reset_for_test()
    assert M._instance is None


# ---------------------------------------------------------------------------
# hot-key detector
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _seeded_stream(seed: int, n: int):
    """Zipf-like counter names with time steps between accesses."""
    rng = random.Random(seed)
    names = [f"counter-{i}" for i in range(400)]
    weights = [1.0 / (i + 1) ** 1.1 for i in range(len(names))]
    return [(rng.choices(names, weights)[0], rng.choice((0.0, 0.01, 0.5,
                                                          2.5)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hot_key_detector_equal_reference(seed, monkeypatch):
    """Both packages' detectors fed one seeded stream under one fake
    clock (decay included): every probe of top(), total() and is_above
    answers alike."""
    probes = {}
    for key in PKGS:
        hk = mod(key, "utils.hot_key_detector")
        clock = FakeClock()
        monkeypatch.setattr(hk, "time", SimpleNamespace(monotonic=clock))
        det = hk.HotKeyDetector(num_buckets=20, decay_half_life_sec=30.0)
        out = []
        for i, (name, step) in enumerate(_seeded_stream(seed, 3000)):
            clock.now += step
            det.record(name)
            if i % 250 == 249:
                out.append((det.top(10), det.total(),
                            det.is_above("counter-0", 0.05),
                            det.is_above("counter-399", 0.05)))
        probes[key] = out
        monkeypatch.undo()
    assert probes["port"] == probes["ref"]
    assert probes["port"][-1][0][0][0] == "counter-0"


@pytest.mark.parametrize("key", list(PKGS))
def test_hot_key_detector_finds_hot_key_under_threads(key):
    """The reference's hot_key_detector_test: the hot key tops the list
    and passes the share threshold; four threads record at once."""
    det = mod(key, "utils.hot_key_detector").HotKeyDetector(num_buckets=10)
    for i in range(1000):
        det.record("hot")
        det.record(f"cold{i % 100}")
    assert det.is_above("hot", 0.3)
    assert not det.is_above("cold1", 0.3)
    assert det.top(1)[0][0] == "hot"
    det = mod(key, "utils.hot_key_detector").HotKeyDetector(num_buckets=50)

    def worker(tid):
        for i in range(2000):
            det.record((tid, i % 20))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(det.top(100)) <= 50
    assert round(det.total()) == 8000


# ---------------------------------------------------------------------------
# graceful shutdown
# ---------------------------------------------------------------------------


def _shutdown_order(key: str) -> list:
    gs = mod(key, "utils.graceful_shutdown")
    order = []

    class Draining:
        def stop(self, drain_timeout=None):
            order.append(("drain", drain_timeout))

    class Plain:
        def stop(self):
            order.append(("plain",))

    class Broken:
        def stop(self):
            order.append(("broken",))
            raise RuntimeError("stop failed")

    h = gs.GracefulShutdownHandler(drain_timeout=7.5)
    h.register_pre_shutdown_hook(lambda: order.append(("pre", 1)))
    h.register_pre_shutdown_hook(lambda: order.append(("pre", 2)))
    for server in (Draining(), Broken(), Plain(), object()):
        h.add_server(server)
    h.register_post_shutdown_hook(lambda: order.append(("post", 1)))
    h.register_post_shutdown_hook(
        lambda: (order.append(("post", 2)), 1 / 0))
    h.register_post_shutdown_hook(lambda: order.append(("post", 3)))
    assert not h.wait(0.01)
    h.shutdown()
    h.shutdown()  # a second signal: nothing runs twice
    assert h.wait(1.0)
    return order


def test_graceful_shutdown_hook_order_equal_reference():
    """Pre-hooks, then each server's stop (the drain window to a stop
    that takes one), then post-hooks, each once, a failing one logged
    and passed over; the same order in both packages."""
    got = _shutdown_order("port")
    assert got == [("pre", 1), ("pre", 2), ("drain", 7.5), ("broken",),
                   ("plain",), ("post", 1), ("post", 2), ("post", 3)]
    assert _shutdown_order("ref") == got


# ---------------------------------------------------------------------------
# future_util
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", list(PKGS))
def test_speculate(key):
    """The primary wins when fast; the backup wins over a stuck primary
    and after a failed one."""
    speculate = mod(key, "utils.future_util").speculate

    async def fast():
        return "primary"

    async def slow():
        await asyncio.sleep(5)
        return "slow"

    async def quick():
        return "backup"

    async def failing():
        raise RuntimeError("boom")

    async def run(primary, backup, delay):
        return await asyncio.wait_for(speculate(primary, backup, delay), 2)

    assert asyncio.run(run(fast, slow, 0.05)) == "primary"
    assert asyncio.run(run(slow, quick, 0.01)) == "backup"
    assert asyncio.run(run(failing, quick, 0.5)) == "backup"
    assert asyncio.run(mod(key, "utils.future_util").delayed(7, 0.0)) == 7
