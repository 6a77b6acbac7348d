"""The port's remote compaction tier against the JAX package's.

The reference's scenarios (``tests/test_compaction_remote.py``) run on
each package's own coordinator, object store, leader and worker: the
ledger protocol, end to end, remote equal to local byte for byte, no
worker → local, the size floor, a stale epoch fenced, a checksum
mismatch swept, heartbeat expiry republished to a live worker, leader
restart recovery, a ghost ledger entry, every leader- and worker-side
failpoint seam, the engine's background loop, the S3 stub and the env
wiring. The port's leaders compact on the host
(``NativeCompactionBackend``) and its workers run the card's backend on
the CPU (``GpuCompactionBackend(device="cpu")``: the kernels' plain
versions). Then mixed fleets — a reference leader with a port worker, a
port leader with a reference worker — install generations sha256-equal
to an all-reference run; the codecs are byte-equal; counters and
failpoint trips equal the reference's; the port's worker never hides the
card (``_build_backend``, a failed direct sink on a CUDA device); and
the port's worker CLI completes a job in a subprocess. Tolerance 0.

Claim and deadline windows are wide (60 s and more) except in the tests
of the no-worker path, and no test bounds how fast a job completes.
"""

import hashlib
import importlib
import json
import os
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import rocksplicator_tpu_torch
from torch_parity import reset_observability, span_shape

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"ref": "rocksplicator_tpu", "port": "rocksplicator_tpu_torch"}
pack_u64 = struct.Struct(">Q").pack


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def wait_until(pred, timeout=120.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class Package:
    """One package's side of the tier: its DB, coordinator, ledger,
    worker and failpoints, with the backends each role takes."""

    def __init__(self, key: str, worker_backend=None):
        self.key = key
        self.name = PACKAGES[key]
        self.cr = mod(self.name, "compaction_remote")
        self.install = mod(self.name, "compaction_remote.install")
        self.dispatch = mod(self.name, "compaction_remote.dispatch")
        self.coordinator = mod(self.name, "cluster.coordinator")
        self.storage = mod(self.name, "storage.engine")
        self.records = mod(self.name, "storage.records")
        self.fp = mod(self.name, "testing.failpoints")
        self.stats = mod(self.name, "utils.stats")
        self._worker_backend = worker_backend

    def options(self, **over):
        opts = dict(memtable_bytes=16 * 1024, level0_compaction_trigger=100,
                    background_compaction=False, target_file_bytes=1 << 20)
        if self.key == "port":
            # the port's DB compacts on the card unless told otherwise
            native = mod(self.name, "storage.native_compaction")
            opts["compaction_backend"] = native.NativeCompactionBackend()
        opts.update(over)
        return self.storage.DBOptions(**opts)

    def open_db(self, path, **over):
        return self.storage.DB(str(path), self.options(**over))

    def worker_backend(self):
        if self._worker_backend is not None:
            return self._worker_backend()
        if self.key == "port":
            from rocksplicator_tpu_torch.gpu import GpuCompactionBackend

            return GpuCompactionBackend(device="cpu")
        return None  # the reference's default: its native CPU merge

    def worker(self, coord, workdir, worker_id="wk-1", **kw):
        return self.cr.CompactionWorker(
            coord, str(workdir), worker_id=worker_id,
            backend=self.worker_backend(), poll_interval=0.05, **kw)

    def policy(self, **over):
        kw = dict(enabled=True, size_floor_bytes=0, deadline_s=120.0,
                  claim_wait_s=60.0, heartbeat_timeout_s=60.0)
        kw.update(over)
        return self.cr.RemoteDispatchPolicy(**kw)

    def write_batch(self):
        return self.records.WriteBatch()


def load_db(pkg, db, n=300, prefix=b"k", deletes=True):
    for i in range(n):
        b = pkg.write_batch()
        b.put(prefix + b"%06d" % i, pack_u64(i) * 4)
        db.write(b)
        if i % 60 == 0:
            db.flush()
    if deletes:
        for i in range(0, n, 7):
            b = pkg.write_batch()
            b.delete(prefix + b"%06d" % i)
            db.write(b)
    db.flush()


def expected_view(db, n=300, prefix=b"k"):
    return {prefix + b"%06d" % i: db.get(prefix + b"%06d" % i)
            for i in range(n)}


def generation(db):
    """sha256 of every live file, in level order."""
    return [hashlib.sha256(open(os.path.join(db.path, n), "rb").read())
            .hexdigest() for level in db._levels for n in level]


class FakePick:
    kind = "l0"
    level = 0
    score = 2.0
    reason = "test"


@pytest.fixture(autouse=True)
def _fresh_observability():
    reset_observability(rocksplicator_tpu_torch)
    mod(PACKAGES["ref"], "testing.failpoints").reset_for_test()
    yield
    for name in PACKAGES.values():
        mod(name, "testing.failpoints").reset_for_test()
        store = mod(name, "utils.objectstore")
        with store._store_cache_lock:
            store._store_cache.clear()


@pytest.fixture
def fleet(tmp_path):
    """``fleet(server_pkg)`` starts a coordinator of that package;
    ``fleet.client(pkg)`` opens clients of either; ``fleet.serve(worker)``
    runs a worker thread; all stop at teardown."""
    made = SimpleNamespace(servers=[], clients=[], stops=[])

    def start(pkg):
        made.server = pkg.coordinator.CoordinatorServer(port=0,
                                                         session_ttl=10.0)
        made.servers.append(made.server)
        return made.server

    def client(pkg):
        c = pkg.coordinator.CoordinatorClient("127.0.0.1", made.server.port)
        made.clients.append(c)
        return c

    def serve(worker):
        stop = threading.Event()
        t = threading.Thread(target=worker.serve_forever, args=(stop,),
                             daemon=True)
        t.start()
        made.stops.append((stop, t))
        return stop

    start.client, start.serve = client, serve
    try:
        yield start
    finally:
        for stop, t in made.stops:
            stop.set()
            t.join(timeout=30)
        for c in made.clients:
            try:
                c.close()
            except Exception:
                pass
        for s in made.servers:
            s.stop()


def make_tier(pkg, tmp_path, fleet, db, db_name="db0", epoch=lambda: 1,
              policy=None, start_worker=True, store_uri=None):
    """A leader-side manager of ``pkg`` and, optionally, a live worker of
    the same package serving in a thread."""
    store_uri = store_uri or f"local://{tmp_path}/store"
    mgr = pkg.cr.RemoteCompactionManager(
        db_name, db, fleet.client(pkg), store_uri,
        policy=policy or pkg.policy(), epoch_provider=epoch)
    worker = None
    if start_worker:
        worker = pkg.worker(fleet.client(pkg), tmp_path / "wk")
        fleet.serve(worker)
    return mgr, worker


@pytest.fixture(params=["ref", "port"])
def pkg(request, fleet):
    p = Package(request.param)
    fleet(p)
    return p


# ---------------------------------------------------------------------------
# codecs and the ledger
# ---------------------------------------------------------------------------


def test_codecs_byte_equal_reference(tmp_path):
    ref, port = Package("ref"), Package("port")
    kw = dict(job_id="j1", db_name="db0", epoch=7, store_uri="local:///s",
              inputs=[{"name": "a.sst", "key": "k/a", "checksum": "c" * 64,
                       "bytes": 123}],
              bottom=3, drop_tombstones=False, merge_operator="uint64add",
              memory_budget_bytes=1 << 20, deadline_ms=5000,
              published_ms=99)
    raw = ref.cr.CompactionJob(**kw).encode()
    assert port.cr.CompactionJob(**kw).encode() == raw
    back = port.cr.CompactionJob.decode(raw)
    assert back == port.cr.CompactionJob(**kw) and back.input_bytes == 123
    data = json.loads(raw)
    data["future_field"] = True
    assert port.cr.CompactionJob.decode(json.dumps(data).encode()) == back
    rkw = dict(job_id="j1", db_name="db0", epoch=7, worker_id="w",
               status="failed", error="boom",
               outputs=[{"name": "o.sst", "key": "k/o",
                         "checksum": "d" * 64, "bytes": 5}],
               finished_ms=3)
    raw = ref.cr.JobResult(**rkw).encode()
    assert port.cr.JobResult(**rkw).encode() == raw
    assert ref.cr.JobResult.decode(port.cr.JobResult(**rkw).encode()) \
        == ref.cr.JobResult(**rkw)
    p = tmp_path / "f"
    p.write_bytes(b"hello world" * 1000)
    assert port.cr.file_checksum(str(p)) == ref.cr.file_checksum(str(p)) \
        == hashlib.sha256(p.read_bytes()).hexdigest()
    assert port.install.OFFLOADABLE_KINDS == ref.install.OFFLOADABLE_KINDS
    for a, b in ((5, 5), (5, 4), (5, 6)):
        assert port.install._epoch_is_current(a, b) \
            == ref.install._epoch_is_current(a, b)


def test_ledger_protocol(pkg, fleet):
    q = pkg.cr.CompactionJobQueue(fleet.client(pkg))
    job = pkg.cr.CompactionJob(job_id="j1", db_name="db0", epoch=4,
                               store_uri="local:///x",
                               inputs=[{"name": "a", "key": "k",
                                        "checksum": "c", "bytes": 10}])
    q.publish(job)
    with pytest.raises(pkg.cr.JobInFlightError):
        q.publish(job)
    assert q.list_open_jobs() == ["db0"]
    active = q.active_jobs()["db0"]
    assert (active["phase"], active["epoch"], active["input_bytes"]) \
        == ("published", 4, 10)
    won = q.claim("db0", "worker-A")
    assert won is not None and won.job_id == "j1"
    assert q.claim("db0", "worker-B") is None  # a duplicate claim loses
    assert q.claim_holder("db0") == "worker-A"
    assert q.active_jobs()["db0"]["phase"] == "claimed"
    assert q.list_open_jobs() == []
    assert q.heartbeat_age_ms("db0") is not None
    q.reap_claim("db0")  # the job node survives: republished
    assert q.list_open_jobs() == ["db0"]
    assert q.claim("db0", "live-worker").job_id == "j1"
    q.remove("db0")
    assert q.get_job("db0") is None
    summary = q.read_summary()
    assert summary["published"] == 1 and summary["claimed"] == 2
    assert summary["reaped"] == 1
    # the claim seam holds nothing: the job stays open for the next scan
    q.publish(job)
    pkg.fp.activate("compact.remote.claim", "fail_nth:1")
    try:
        with pytest.raises(OSError):
            q.claim("db0", "w1")
    finally:
        pkg.fp.deactivate("compact.remote.claim")
    assert q.list_open_jobs() == ["db0"]
    assert q.claim("db0", "w1") is not None


@pytest.mark.parametrize("leader,worker", [("ref", "port"), ("port", "ref")])
def test_ledger_carries_across(leader, worker, fleet):
    """A job one package's leader published is claimed, heartbeated and
    answered through the other package's queue, and read back."""
    lp, wp = Package(leader), Package(worker)
    fleet(lp)
    lq = lp.cr.CompactionJobQueue(fleet.client(lp))
    wq = wp.cr.CompactionJobQueue(fleet.client(wp))
    lq.publish(lp.cr.CompactionJob(job_id="jx", db_name="db9", epoch=2,
                                   store_uri="local:///x"))
    assert wq.list_open_jobs() == ["db9"]
    got = wq.claim("db9", "w")
    assert got.encode() == lq.get_job("db9").encode()
    wq.post_result(wp.cr.JobResult(job_id="jx", db_name="db9", epoch=2,
                                   worker_id="w", outputs=[]))
    res = lq.get_result("db9")
    assert (res.job_id, res.status, lq.claim_holder("db9")) \
        == ("jx", "done", "w")
    assert lq.read_summary() == wq.read_summary()


# ---------------------------------------------------------------------------
# end to end: offload → worker merge → verified fenced install
# ---------------------------------------------------------------------------


def test_end_to_end_and_equal_to_local(pkg, fleet, tmp_path):
    db = pkg.open_db(tmp_path / "db")
    local = pkg.open_db(tmp_path / "local")
    for d in (db, local):
        load_db(pkg, d)
    want = expected_view(db)
    assert sum(db.metrics_snapshot(max_age=0)["level_files"]) > 1
    mgr, worker = make_tier(pkg, tmp_path, fleet, db)
    assert mgr.maybe_offload(FakePick()) == "installed"
    snap = db.metrics_snapshot(max_age=0)
    assert snap["remote_offloaded_bytes_total"] > 0
    assert snap["bytes_compacted_local_total"] == 0
    assert expected_view(db) == want
    local.compact_range()
    assert generation(db) == generation(local)
    db.close()
    local.close()
    db2 = pkg.open_db(tmp_path / "db")
    try:
        assert expected_view(db2) == want
    finally:
        db2.close()
    assert worker.jobs_done == 1 and worker.jobs_failed == 0
    assert mgr.installed == 1 and mgr.counters()["failed_over"] == 0
    assert mgr._queue.get_job("db0") is None
    assert mgr._store.list_objects("compactions/db0/") == []


def test_no_worker_falls_back_local(pkg, fleet, tmp_path):
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db, n=120)
    want = expected_view(db, n=120)
    policy = pkg.policy(deadline_s=30.0, claim_wait_s=0.3)
    mgr, _w = make_tier(pkg, tmp_path, fleet, db, policy=policy,
                        start_worker=False)
    assert mgr.maybe_offload(FakePick()) == "declined"
    assert mgr.failed_over == 1
    assert mgr._queue.get_job("db0") is None
    db.compact_range()
    assert expected_view(db, n=120) == want
    snap = db.metrics_snapshot(max_age=0)
    assert snap["remote_offloaded_bytes_total"] == 0
    assert snap["bytes_compacted_local_total"] > 0
    db.close()


def test_size_floor_declines_without_publishing(pkg, fleet, tmp_path):
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db, n=50)
    policy = pkg.policy(size_floor_bytes=1 << 40, claim_wait_s=0.2)
    mgr, _w = make_tier(pkg, tmp_path, fleet, db, policy=policy,
                        start_worker=False)
    assert mgr.maybe_offload(FakePick()) == "declined"
    assert mgr.failed_over == 0
    assert mgr._queue.read_summary().get("published", 0) == 0
    db.compact_range()
    db.close()


def test_stale_epoch_result_is_fenced(pkg, fleet, tmp_path):
    epoch = {"cur": 1}
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    files_before = [list(level) for level in db._levels]
    mgr, _w = make_tier(pkg, tmp_path, fleet, db,
                        epoch=lambda: epoch["cur"])
    orig_publish = mgr._queue.publish

    def publish_then_depose(job):
        orig_publish(job)
        epoch["cur"] = 2

    mgr._queue.publish = publish_then_depose
    assert mgr.maybe_offload(FakePick()) == "fenced"
    assert mgr.fenced == 1
    assert [list(level) for level in db._levels] == files_before
    assert db.metrics_snapshot(max_age=0)["bytes_compacted_total"] == 0
    assert mgr._queue.get_job("db0") is None
    assert mgr._store.list_objects("compactions/db0/") == []
    db.compact_range()
    db.close()


def test_checksum_mismatch_rejects_sweeps_and_falls_back(pkg, fleet,
                                                         tmp_path):
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    want = expected_view(db)
    mgr, _w = make_tier(pkg, tmp_path, fleet, db)
    orig_get_result = mgr._queue.get_result

    def corrupt_then_return(name):
        res = orig_get_result(name)
        if res is not None and res.status == "done":
            for out in res.outputs:
                raw = bytearray(mgr._store.get_object_bytes(out["key"]))
                raw[0] ^= 0xFF
                mgr._store.put_object_bytes(out["key"], bytes(raw))
        return res

    mgr._queue.get_result = corrupt_then_return
    files_before = len(os.listdir(db.path))
    assert mgr.maybe_offload(FakePick()) == "declined"
    assert mgr.failed_over == 1
    assert len(os.listdir(db.path)) <= files_before
    db.compact_range()
    assert expected_view(db) == want
    assert db.metrics_snapshot(max_age=0)["remote_offloaded_bytes_total"] \
        == 0
    db.close()


def test_heartbeat_expiry_republishes_to_live_worker(pkg, fleet, tmp_path):
    """A worker that claims and then dies (no heartbeats) is reaped on
    expiry; the job republishes and a live worker completes it."""
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    want = expected_view(db)
    policy = pkg.policy(heartbeat_timeout_s=0.4)
    mgr, _w = make_tier(pkg, tmp_path, fleet, db, policy=policy,
                        start_worker=False)
    dead_q = pkg.cr.CompactionJobQueue(fleet.client(pkg))
    claimed = threading.Event()

    def dead_claimer():
        if wait_until(lambda: dead_q.list_open_jobs(), interval=0.01):
            dead_q.claim(dead_q.list_open_jobs()[0], "dead-worker")
            claimed.set()

    threading.Thread(target=dead_claimer, daemon=True).start()
    live = pkg.worker(fleet.client(pkg), tmp_path / "wk2",
                      worker_id="live-worker", heartbeat_interval=0.05)
    def start_live_after_dead_claim():
        claimed.wait(120)
        fleet.serve(live)

    threading.Thread(target=start_live_after_dead_claim, daemon=True).start()
    assert mgr.maybe_offload(FakePick()) == "installed"
    assert mgr.republished >= 1
    assert live.jobs_done == 1
    assert expected_view(db) == want
    db.close()


def test_leader_restart_recovery_is_idempotent(pkg, fleet, tmp_path):
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    want = expected_view(db)
    q = pkg.cr.CompactionJobQueue(fleet.client(pkg))
    mgr, _w = make_tier(pkg, tmp_path, fleet, db, start_worker=False)
    plan = db.plan_full_compaction()
    assert plan is not None
    mgr._publish(plan, "deadjob0000beef", 1)
    db.abort_full_compaction(plan)  # the mutex dies with the process
    db.close()
    assert q.get_job("db0") is not None
    db2 = pkg.open_db(tmp_path / "db")
    mgr2, _w = make_tier(pkg, tmp_path, fleet, db2, start_worker=False)
    mgr2.recover()
    assert q.get_job("db0") is None
    assert mgr2._store.list_objects("compactions/db0/") == []
    assert expected_view(db2) == want
    mgr2.recover()
    fleet.serve(pkg.worker(fleet.client(pkg), tmp_path / "wk2", "wk-2"))
    assert mgr2.maybe_offload(FakePick()) == "installed"
    assert expected_view(db2) == want
    assert q.read_summary()["recovered"] == 1
    db2.close()


def test_ghost_ledger_entry_swept_then_fallback(pkg, fleet, tmp_path):
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    pkg.cr.CompactionJobQueue(fleet.client(pkg)).publish(
        pkg.cr.CompactionJob(job_id="ghost", db_name="db0", epoch=0,
                             store_uri="local:///x"))
    mgr, _w = make_tier(pkg, tmp_path, fleet, db, start_worker=False)
    assert mgr.maybe_offload(FakePick()) == "declined"
    fleet.serve(pkg.worker(fleet.client(pkg), tmp_path / "wk"))
    assert mgr.maybe_offload(FakePick()) == "installed"
    db.close()


# ---------------------------------------------------------------------------
# failpoint seams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seam", ["compact.remote.publish",
                                  "compact.remote.install"])
def test_leader_side_seams_fall_back_local(pkg, fleet, tmp_path, seam):
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db, n=120)
    want = expected_view(db, n=120)
    mgr, _w = make_tier(pkg, tmp_path, fleet, db)
    pkg.fp.activate(seam, "fail_nth:1")
    try:
        assert mgr.maybe_offload(FakePick()) == "declined"
        assert pkg.fp.trip_counts()[seam] == 1
    finally:
        pkg.fp.deactivate(seam)
    assert mgr.failed_over == 1
    db.compact_range()
    assert expected_view(db, n=120) == want
    db.close()


@pytest.mark.parametrize("seam", ["compact.remote.fetch",
                                  "compact.remote.upload"])
def test_worker_side_seams_fail_job_then_retry_clean(pkg, fleet, tmp_path,
                                                     seam):
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    want = expected_view(db)
    mgr, worker = make_tier(pkg, tmp_path, fleet, db)
    pkg.fp.activate(seam, "fail_nth:1")
    try:
        assert mgr.maybe_offload(FakePick()) == "declined"
        assert worker.jobs_failed == 1
        pkg.fp.deactivate(seam)
        assert mgr.maybe_offload(FakePick()) == "installed"
    finally:
        pkg.fp.deactivate(seam)
    assert expected_view(db) == want
    db.close()


def test_heartbeat_seam_is_absorbed(pkg, fleet, tmp_path):
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    want = expected_view(db)
    mgr, _w = make_tier(pkg, tmp_path, fleet, db)
    pkg.fp.activate("compact.remote.heartbeat", "fail_prob:0.5@seed7")
    try:
        assert mgr.maybe_offload(FakePick()) == "installed"
    finally:
        pkg.fp.deactivate("compact.remote.heartbeat")
    assert expected_view(db) == want
    db.close()


def test_background_loop_offloads_its_own_pick(pkg, fleet, tmp_path):
    """The engine's own L0 pick at the trigger reaches ``maybe_offload``
    from the compaction thread and installs remotely. Each round of
    writes ends in a flush, so L0 reaches the trigger however the
    background flush batches its memtables under load."""
    db = pkg.open_db(tmp_path / "db", background_compaction=True,
                     level0_compaction_trigger=3, memtable_bytes=8 * 1024)
    mgr, worker = make_tier(pkg, tmp_path, fleet, db)
    db.set_remote_compactor(mgr)
    try:
        for i in range(400):
            b = pkg.write_batch()
            b.put(b"bg%06d" % i, pack_u64(i) * 8)
            db.write(b)
            if i % 100 == 99:
                db.flush()
        assert wait_until(lambda: db.metrics_snapshot(max_age=0)[
            "remote_offloaded_bytes_total"] > 0), (
            mgr.counters(), worker.jobs_done, worker.jobs_failed,
            [len(level) for level in db._levels], db._bg_compaction_error)
        assert db.metrics_snapshot(max_age=0)[
            "bytes_compacted_local_total"] == 0
        for i in range(0, 400, 37):
            assert db.get(b"bg%06d" % i) == pack_u64(i) * 8
    finally:
        db.set_remote_compactor(None)
        db.close()
    assert mgr.installed >= 1 and mgr.failed_over == 0


# ---------------------------------------------------------------------------
# the S3 stub and the serving-node env wiring
# ---------------------------------------------------------------------------


def test_end_to_end_over_s3_stub(pkg, fleet, tmp_path, monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-access")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret")
    monkeypatch.setenv("RSTPU_RETRY_SEED", "9")
    srv = mod(pkg.name, "utils.s3_stub").S3StubServer(
        access_key="test-access", secret_key="test-secret")
    monkeypatch.setenv("RSTPU_S3_ENDPOINT", srv.start())
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    want = expected_view(db)
    mgr, _w = make_tier(pkg, tmp_path, fleet, db,
                        store_uri="s3://test-bucket")
    pkg.fp.activate("s3.request", "fail_first:2")
    try:
        assert mgr.maybe_offload(FakePick()) == "installed"
        assert expected_view(db) == want
        assert pkg.fp.trip_counts()["s3.request"] == 2
        pkg.stats.Stats.get().flush()
        assert pkg.stats.Stats.get().get_counter(
            "retry.attempts op=s3.request") >= 2.0
        assert db.metrics_snapshot(max_age=0)[
            "remote_offloaded_bytes_total"] > 0
        assert list(srv.data["test-bucket"]) == []
    finally:
        pkg.fp.deactivate("s3.request")
        db.close()
        srv.stop()


def test_attach_from_env(pkg, fleet, tmp_path, monkeypatch):
    for var in ("RSTPU_COMPACT_REMOTE", "RSTPU_COMPACT_COORD",
                "RSTPU_COMPACT_REMOTE_STORE"):
        monkeypatch.delenv(var, raising=False)
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    assert pkg.dispatch.attach_from_env("x", db, lambda: 1) is None
    monkeypatch.setenv("RSTPU_COMPACT_REMOTE", "1")
    assert pkg.dispatch.attach_from_env("x", db, lambda: 1) is None
    assert db._remote_compactor is None
    monkeypatch.setenv("RSTPU_COMPACT_COORD",
                       f"127.0.0.1:{fleet(pkg).port}")
    monkeypatch.setenv("RSTPU_COMPACT_REMOTE_STORE",
                       f"local://{tmp_path}/store")
    monkeypatch.setenv("RSTPU_COMPACT_REMOTE_FLOOR", "0")
    monkeypatch.setenv("RSTPU_COMPACT_REMOTE_CLAIM_WAIT", "60")
    fleet.serve(pkg.worker(fleet.client(pkg), tmp_path / "wk", "envwk"))
    try:
        mgr = pkg.dispatch.attach_from_env("envdb@1234", db, lambda: 1)
        assert mgr is not None and db._remote_compactor is mgr
        assert mgr.policy.size_floor_bytes == 0
        assert mgr.policy.claim_wait_s == 60.0
        assert mgr.maybe_offload(FakePick()) == "installed"
        pkg.dispatch.detach(db, mgr)
        assert db._remote_compactor is None
        pkg.dispatch.detach(db, None)
    finally:
        db.close()


# ---------------------------------------------------------------------------
# mixed fleets: installed generations equal an all-reference run's
# ---------------------------------------------------------------------------


def _port_gpu(flag):
    def make():
        from rocksplicator_tpu_torch.gpu import GpuCompactionBackend
        from rocksplicator_tpu_torch.utils.flags import FLAGS

        FLAGS.set("sort_backend", flag)
        return GpuCompactionBackend(device="cpu")
    return make


def _port_native():
    from rocksplicator_tpu_torch.storage.native_compaction import \
        NativeCompactionBackend

    return NativeCompactionBackend()


def _offload_once(leader, worker, tmp_path, store_uri=None):
    """One offload with a fresh coordinator of the leader's package; the
    installed generation's sha256 list and the leader's view."""
    made = []
    server = leader.coordinator.CoordinatorServer(port=0, session_ttl=10.0)
    lc = leader.coordinator.CoordinatorClient("127.0.0.1", server.port)
    wc = worker.coordinator.CoordinatorClient("127.0.0.1", server.port)
    db = leader.open_db(tmp_path / f"db-{leader.key}")
    stop = threading.Event()
    try:
        load_db(leader, db, n=400)
        mgr = leader.cr.RemoteCompactionManager(
            "db0", db, lc, store_uri or f"local://{tmp_path}/store",
            policy=leader.policy(), epoch_provider=lambda: 1)
        wk = worker.worker(wc, tmp_path / "wk")
        t = threading.Thread(target=wk.serve_forever, args=(stop,),
                             daemon=True)
        t.start()
        made.append(t)
        assert mgr.maybe_offload(FakePick()) == "installed"
        assert wk.jobs_done == 1 and wk.jobs_failed == 0
        if worker.key == "port":
            # the port's worker merged through its backend's direct sink
            # (the card's routes: source decode, merge, K3 blooms, ...)
            stages = wk.last_job["backend_stages"]
            assert ("merge" in stages) == hasattr(wk._backend, "device"), \
                stages
        assert db.metrics_snapshot(max_age=0)[
            "bytes_compacted_local_total"] == 0
        return generation(db), expected_view(db, n=400)
    finally:
        stop.set()
        for t in made:
            t.join(timeout=30)
        db.close()
        for c in (lc, wc):
            c.close()
        server.stop()


@pytest.mark.parametrize("leader,worker,backend", [
    ("ref", "port", "fused"), ("ref", "port", "bitonic"),
    ("ref", "port", "native"), ("port", "ref", None)],
    ids=["ref-leader-port-worker-fused", "ref-leader-port-worker-bitonic",
         "ref-leader-port-worker-native", "port-leader-ref-worker"])
def test_mixed_fleet_installs_reference_generation(leader, worker, backend,
                                                   tmp_path):
    from rocksplicator_tpu_torch.utils.flags import FLAGS

    want = _offload_once(Package("ref"), Package("ref"), tmp_path / "all")
    make = {"fused": _port_gpu("pallas_fused"),
            "bitonic": _port_gpu("pallas"), "native": _port_native,
            None: None}[backend]
    try:
        got = _offload_once(Package(leader), Package(worker, make),
                            tmp_path / "mixed")
    finally:
        FLAGS.set("sort_backend", "pallas_fused")
    assert got == want
    assert len(want[0]) >= 1


def test_mixed_fleet_over_s3_stub(tmp_path, monkeypatch):
    """A reference leader and a port worker exchange a job through the
    port's S3 stub."""
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-access")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret")
    from rocksplicator_tpu_torch.utils.s3_stub import S3StubServer

    srv = S3StubServer(access_key="test-access", secret_key="test-secret")
    monkeypatch.setenv("RSTPU_S3_ENDPOINT", srv.start())
    try:
        want = _offload_once(Package("ref"), Package("ref"), tmp_path / "a",
                             store_uri="s3://b")
        got = _offload_once(Package("ref"), Package("port"), tmp_path / "b",
                            store_uri="s3://b")
        assert got == want
        assert list(srv.data["b"]) == []
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# observability against the reference's
# ---------------------------------------------------------------------------


REMOTE_COUNTERS = ("published", "claimed", "installed", "failed_over",
                   "worker_done")


def test_observability_equal_reference(tmp_path):
    """The same scenario (a failed fetch, then a clean job; the port's
    worker on its host backend, as the reference's default) counts the
    same ``compaction.remote.*`` counters, ledger summary and failpoint
    trips, and traces the same spans, in each package's own singletons
    (the RPC spans by name and parent: their number follows the leader's
    polling)."""
    import rocksplicator_tpu

    out = []
    for key, top in (("ref", rocksplicator_tpu),
                     ("port", rocksplicator_tpu_torch)):
        pkg = Package(key, _port_native if key == "port" else None)
        reset_observability(top)
        server = pkg.coordinator.CoordinatorServer(port=0, session_ttl=10.0)
        clients = [pkg.coordinator.CoordinatorClient("127.0.0.1", server.port)
                   for _ in range(2)]
        db = pkg.open_db(tmp_path / key / "db")
        stop = threading.Event()
        try:
            load_db(pkg, db)
            mgr = pkg.cr.RemoteCompactionManager(
                "db0", db, clients[0], f"local://{tmp_path}/{key}/store",
                policy=pkg.policy(), epoch_provider=lambda: 1)
            wk = pkg.worker(clients[1], tmp_path / key / "wk", "w1")
            t = threading.Thread(target=wk.serve_forever, args=(stop,),
                                 daemon=True)
            t.start()
            pkg.fp.activate("compact.remote.fetch", "fail_nth:1")
            outcomes = [mgr.maybe_offload(FakePick())]
            pkg.fp.deactivate("compact.remote.fetch")
            outcomes.append(mgr.maybe_offload(FakePick()))
            stats = pkg.stats.Stats.get()
            stats.flush()
            counters = {
                name: stats.get_counter(pkg.stats.tagged(
                    f"compaction.remote.{name}",
                    **({"worker": "w1"} if name == "worker_done"
                       else {"db": "db0"})))
                for name in REMOTE_COUNTERS}
            trips = {k: v for k, v in pkg.fp.trip_counts().items() if v}
            spans = span_shape(mod(pkg.name, "observability.collector"),
                               timed=("peer", "port", "queue_wait_ms",
                                      "remote"))
            out.append((outcomes, counters, mgr.counters(),
                        mgr._queue.read_summary(), trips,
                        {k: n for k, n in spans.items()
                         if not k[0].startswith("rpc.")},
                        sorted({k[:2] for k in spans
                                if k[0].startswith("rpc.")})))
        finally:
            stop.set()
            t.join(timeout=30)
            db.close()
            for c in clients:
                c.close()
            server.stop()
    assert out[1] == out[0]
    assert out[0][0] == ["declined", "installed"]
    assert ("compact.resolve", None) in {k[:2] for k in out[0][5]}
    assert ("rpc.rtt", None) in out[0][6]
    assert out[0][1]["installed"] == 1 and out[0][1]["failed_over"] == 1


# ---------------------------------------------------------------------------
# the port's worker never hides the card
# ---------------------------------------------------------------------------


def test_build_backend_refuses_to_hide_the_card(monkeypatch):
    from rocksplicator_tpu_torch.compaction_remote.worker import \
        _build_backend
    from rocksplicator_tpu_torch.storage.native_compaction import \
        NativeCompactionBackend

    monkeypatch.delenv("RSTPU_COMPACT_WORKER_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in (None, "gpu", "GPU"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _build_backend(name)
    monkeypatch.setenv("RSTPU_COMPACT_WORKER_BACKEND", "gpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build_backend(None)
    monkeypatch.setenv("RSTPU_COMPACT_WORKER_BACKEND", "cpu")
    assert isinstance(_build_backend(None), NativeCompactionBackend)
    assert isinstance(_build_backend("cpu"), NativeCompactionBackend)
    for bad in ("tpu", "cuda", "native"):
        with pytest.raises(ValueError):
            _build_backend(bad)


class _FailingSink:
    """A backend whose direct file sink raises, on a device of choice;
    its tuple path is the host's native merge, and counts its calls."""

    supports_subcompactions = True
    supports_memory_budget = True

    def __init__(self, device: str):
        from rocksplicator_tpu_torch.storage.native_compaction import \
            NativeCompactionBackend

        self.device = torch.device(device)
        self.tuple_calls = 0
        self._host = NativeCompactionBackend()

    def merge_runs_to_files(self, *args, **kwargs):
        raise RuntimeError("kernel launch failed")

    def merge_runs(self, *args):
        self.tuple_calls += 1
        return self._host.merge_runs(*args)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_failed_direct_sink_on_the_card_fails_the_job(device, fleet,
                                                      tmp_path):
    """On a CUDA device the failed sink fails the job (posted ``failed``,
    the leader declines) with no tuple-path retry; on the host the worker
    retries on the tuple path, as the reference's does, and installs."""
    pkg = Package("port")
    fleet(pkg)
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    want = expected_view(db)
    backend = _FailingSink(device)
    mgr = pkg.cr.RemoteCompactionManager(
        "db0", db, fleet.client(pkg), f"local://{tmp_path}/store",
        policy=pkg.policy(), epoch_provider=lambda: 1)
    worker = pkg.cr.CompactionWorker(fleet.client(pkg), str(tmp_path / "wk"),
                                     backend=backend, poll_interval=0.05)
    fleet.serve(worker)
    outcome = mgr.maybe_offload(FakePick())
    if device == "cuda":
        assert outcome == "declined"
        assert (worker.jobs_failed, worker.jobs_done) == (1, 0)
        assert backend.tuple_calls == 0
        assert mgr.failed_over == 1
    else:
        assert outcome == "installed"
        assert (worker.jobs_failed, worker.jobs_done) == (0, 1)
        assert backend.tuple_calls == 1
    assert expected_view(db) == want
    db.close()


def test_worker_cli_once_completes_a_job(fleet, tmp_path):
    """``python -m rocksplicator_tpu_torch.tools.compaction_worker --once
    --backend cpu`` claims a port leader's job and the leader installs
    it."""
    pkg = Package("port")
    server = fleet(pkg)
    db = pkg.open_db(tmp_path / "db")
    load_db(pkg, db)
    want = expected_view(db)
    mgr = pkg.cr.RemoteCompactionManager(
        "db0", db, fleet.client(pkg), f"local://{tmp_path}/store",
        policy=pkg.policy(), epoch_provider=lambda: 1)
    result = {}
    t = threading.Thread(
        target=lambda: result.setdefault("o", mgr.maybe_offload(FakePick())),
        daemon=True)
    t.start()
    q = pkg.cr.CompactionJobQueue(fleet.client(pkg))
    assert wait_until(lambda: q.list_open_jobs() == ["db0"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "rocksplicator_tpu_torch.tools."
         "compaction_worker", "--coord", f"127.0.0.1:{server.port}",
         "--backend", "cpu", "--once", "--workdir", str(tmp_path / "cli"),
         "--worker-id", "cli-1"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    t.join(timeout=120)
    assert result["o"] == "installed"
    assert "1 jobs, 0 failed" in proc.stderr
    assert expected_view(db) == want
    db.close()
