"""F10: the port's lock-order watchdog (``testing/lockwatch.py``) and its
generated table (``testing/lock_order.py``).

The JAX package arms its watchdog at import when ``RSTPU_LOCKWATCH`` is
set; the port had no watchdog, so the variable armed nothing there. These
are the reference's lockwatch cases (``tests/test_rstpu_check.py``) on the
port's copy, the arming at import in a fresh process, the table's
freshness against ``tools.rstpu_check`` run on the port, and a process
holding both packages armed: each lock is wrapped once, whichever package
arms first."""

import ast
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from tools.rstpu_check import emit_lock_order, run_checks

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "rocksplicator_tpu_torch"


@pytest.fixture()
def lockwatch():
    from rocksplicator_tpu_torch.testing import lockwatch as lw

    lw.reset_for_test()
    yield lw
    lw.uninstall()
    lw.reset_for_test()


def test_lockwatch_zero_cost_when_unarmed(lockwatch):
    assert not lockwatch.installed()
    assert threading.Lock is lockwatch._ORIG_LOCK
    assert type(threading.Lock()) is type(lockwatch._ORIG_LOCK())
    assert type(threading.RLock()) is lockwatch._ORIG_RLOCK


def test_lockwatch_order_violation_raises(lockwatch):
    lockwatch.install()
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with pytest.raises(lockwatch.LockOrderViolation):
        with b:
            with a:
                pass
    assert not lockwatch._held()
    assert not a._inner.locked() and not b._inner.locked()


def test_lockwatch_static_order_violation(lockwatch):
    lockwatch.install()
    a = threading.Lock()
    b = threading.Lock()
    lockwatch._ranks = {"f.py:1": ("Lo", 0), "f.py:2": ("Hi", 1)}
    lockwatch._static_order = {("f.py:1", "f.py:2")}
    try:
        a._site, b._site = "f.py:1", "f.py:2"
        with a:
            with b:
                pass
        with pytest.raises(lockwatch.LockOrderViolation,
                           match="static-order"):
            with b:
                with a:
                    pass
    finally:
        lockwatch._ranks = {}
        lockwatch._static_order = set()


def test_lockwatch_held_set_cleared_and_reentrant(lockwatch):
    lockwatch.install()
    r = threading.RLock()
    with r:
        with r:
            assert len(lockwatch._held()) == 1
            assert lockwatch._held()[0].count == 2
            assert r._recursion_count() == 2
        assert lockwatch._held()[0].count == 1
    assert not lockwatch._held()


def test_lockwatch_condition_wait_exempt(lockwatch):
    lockwatch.install()
    other = threading.Lock()
    cond = threading.Condition()
    hit = []

    def waiter():
        with cond:
            cond.wait(5)
            hit.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with other:
        with cond:
            cond.notify_all()
    t.join(5)
    assert not t.is_alive()
    assert hit == [1]
    assert not lockwatch._held()


def test_lockwatch_warn_mode_counts_instead_of_raising(lockwatch):
    from rocksplicator_tpu_torch.utils.stats import Stats

    Stats.reset_for_test()
    lockwatch.install(mode="warn")
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert Stats.get().get_counter(
        "lockwatch.violations kind=dynamic-cycle") >= 1.0
    Stats.reset_for_test()


def test_lockwatch_engine_write_path_clean(lockwatch, tmp_path):
    """Armed for real against the port's table: the port's engine, on the
    host's and on the card's backend (its plain versions here), runs
    write, flush, compact and close in the canonical order."""
    lockwatch.install()
    assert lockwatch._ranks, "the port's lock_order table did not load"
    from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
    from rocksplicator_tpu_torch.storage.engine import DB, DBOptions
    from rocksplicator_tpu_torch.storage.native_compaction import (
        NativeCompactionBackend)

    for i, backend in enumerate((NativeCompactionBackend(),
                                 GpuCompactionBackend(device="cpu"))):
        db = DB(str(tmp_path / f"db{i}"), DBOptions(
            compaction_backend=backend, background_compaction=True,
            memtable_bytes=4096))
        try:
            for j in range(200):
                db.put(f"k{j:04d}".encode(), b"v" * 64)
            db.flush()
            db.compact_range()
            assert db.get(b"k0001") == b"v" * 64
        finally:
            db.close()
    assert lockwatch.edges()


def _child(code, **env):
    base = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "RSTPU_LOCKWATCH")}
    base.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=base, capture_output=True, text=True,
                          timeout=180)


_ARMING = r'''
import threading, _thread
import rocksplicator_tpu_torch
from rocksplicator_tpu_torch.testing import lockwatch
print("ARMED" if lockwatch.installed() else "STOCK",
      threading.Lock is _thread.allocate_lock, len(lockwatch._ranks))
'''


@pytest.mark.parametrize("value,want", [
    ("1", "ARMED False"), ("warn", "ARMED False"), (None, "STOCK True")])
def test_port_import_arms_from_the_environment(value, want):
    """``RSTPU_LOCKWATCH=1`` (or ``warn``) arms the port's watchdog when
    the package is imported, with the port's table, and the import and
    the interpreter's exit raise nothing; unset, ``threading.Lock`` stays
    the stock primitive."""
    env = {} if value is None else {"RSTPU_LOCKWATCH": value}
    res = _child(_ARMING, **env)
    assert res.returncode == 0, res.stderr
    assert res.stderr == "", res.stderr
    word, stock, ranks = res.stdout.split()
    assert f"{word} {stock}" == want
    assert int(ranks) == (0 if value is None else _port_ranks_count())


def _port_ranks_count():
    from rocksplicator_tpu_torch.testing.lock_order import RANKS

    return len(RANKS)


_MIXED = r'''
import gc, importlib, sys, tempfile, _thread
for name in sys.argv[1:]:
    importlib.import_module(name)
from rocksplicator_tpu.storage.engine import DB as RefDB
from rocksplicator_tpu_torch.storage import DB, DBOptions
from rocksplicator_tpu_torch.storage.native_compaction import (
    NativeCompactionBackend)
from rocksplicator_tpu_torch.kafka.broker import MockKafkaCluster
import rocksplicator_tpu_torch.admin.cdc, rocksplicator_tpu.admin.cdc
with tempfile.TemporaryDirectory() as d:
    dbs = [RefDB(d + "/r"), DB(d + "/p", DBOptions(
        compaction_backend=NativeCompactionBackend()))]
    for db in dbs:
        for i in range(100):
            db.put(b"k%d" % i, b"v")
        db.flush()
        db.compact_range()
    cluster = MockKafkaCluster()
    cluster.create_topic("t", 1)
    locks = [o for o in gc.get_objects()
             if type(o).__name__ in ("_WatchedLock", "_WatchedRLock")]
    twice = [repr(o) for o in locks
             if type(o._inner) not in (_thread.LockType, _thread.RLock)]
    owners = sorted({type(o).__module__ for o in locks})
    for db in dbs:
        db.close()
print("LOCKS", len(locks), "TWICE", len(twice), *owners)
'''


@pytest.mark.parametrize("first", ["rocksplicator_tpu",
                                   "rocksplicator_tpu_torch"])
def test_mixed_process_wraps_each_lock_once(first):
    """Both packages armed in one process, in either order: every watched
    lock, built by either package's modules, wraps a stock primitive."""
    other = ({"rocksplicator_tpu", "rocksplicator_tpu_torch"}
             - {first}).pop()
    code = _MIXED.replace("sys.argv[1:]", repr([first, other]))
    res = _child(code, RSTPU_LOCKWATCH="1")
    assert res.returncode == 0, res.stderr
    words = res.stdout.split()
    assert words[0] == "LOCKS" and int(words[1]) > 20, res.stdout
    assert words[2:4] == ["TWICE", "0"], res.stdout


def test_lock_order_table_is_fresh():
    """``testing/lock_order.py`` holds the ranks and the static order that
    ``tools.rstpu_check --package rocksplicator_tpu_torch
    --emit-lock-order`` emits for the port's own lock sites, the kafka and
    CDC locks among them."""
    from rocksplicator_tpu_torch.testing import lock_order

    _kept, _suppressed, lock_pass = run_checks(str(PACKAGE),
                                               root=str(REPO))
    emitted = ast.parse(emit_lock_order(lock_pass))
    tables = {}
    for node in emitted.body:
        if isinstance(node, ast.Assign):
            tables[node.targets[0].id] = ast.literal_eval(node.value)
    assert tables["RANKS"] == lock_order.RANKS
    assert tables["ORDER"] == lock_order.ORDER
    sites = set(lock_order.RANKS)
    assert all(s.startswith("rocksplicator_tpu_torch/") for s in sites)
    assert any(s.startswith("rocksplicator_tpu_torch/kafka/") for s in sites)
    assert any(s.startswith("rocksplicator_tpu_torch/admin/cdc.py")
               for s in sites)
    doc = lock_order.__doc__
    assert "--package rocksplicator_tpu_torch" in doc
