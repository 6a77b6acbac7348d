"""The port's replication throughput harness
(``rocksplicator_tpu_torch/replication/performance.py``, the reference's
``performance.cpp``) as separate processes at a tiny size, paired with the
JAX package's harness: a port leader with a reference follower and a
reference leader with a port follower, in ack mode 1 so every write is
acknowledged by the other package's follower, which then holds it; and
the port's colocated ``--role cluster``. The port's processes run with
``--device cpu`` (without CUDA the harness refuses to start otherwise).
"""

import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
MODS = {"ref": "rocksplicator_tpu.replication.performance",
        "port": "rocksplicator_tpu_torch.replication.performance"}
SIZE = ("--num_shards", "3", "--num_write_threads", "2",
        "--num_keys_per_shard_thread", "40", "--value_size", "64")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return env


def _args(key):
    return ("--device", "cpu") if key == "port" else ()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for(path: Path, pattern: str, proc, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if re.search(pattern, path.read_text(), re.MULTILINE):
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.1)
    return False


@pytest.mark.parametrize("leader,follower", [("port", "ref"),
                                             ("ref", "port")],
                         ids=["port_leader-ref_follower",
                              "ref_leader-port_follower"])
def test_harness_across_packages(tmp_path, leader, follower):
    """The follower first, then the leader in mode 1: every write acked,
    the throughput line printed, the follower holding every write, and
    both exiting 0 (the follower on SIGINT)."""
    lp, fpt = _free_port(), _free_port()
    log = tmp_path / "follower.log"
    with open(log, "w") as out:
        fproc = subprocess.Popen(
            [sys.executable, "-m", MODS[follower], "--role", "follower",
             "--port", str(fpt), "--upstream_port", str(lp), "--db_dir",
             str(tmp_path / "f"), *SIZE, *_args(follower)],
            cwd=str(REPO), env=_env(), stdout=out, stderr=subprocess.STDOUT)
    try:
        assert _wait_for(log, r"^follower: 3 shards on :", fproc, 120), \
            log.read_text()
        lead = subprocess.run(
            [sys.executable, "-m", MODS[leader], "--role", "leader",
             "--port", str(lp), "--db_dir", str(tmp_path / "l"), *SIZE,
             "--replication_mode", "1", "--warmup_wait_sec", "60",
             "--linger_sec", "1", *_args(leader)],
            cwd=str(REPO), env=_env(), capture_output=True, text=True,
            timeout=240)
        assert lead.returncode == 0, lead.stdout[-3000:] + lead.stderr[-3000:]
        out = lead.stdout
        assert "leader warmup: 3/3 shards have live pullers" in out, out
        assert "leader acked 120/120 writes window=64 mode=1" in out, out
        assert re.search(r"^leader wrote ~0\.0 MB in \d+\.\d{3}s = "
                         r"\d+\.\d\d MB/s$", out, re.MULTILINE), out
        assert _wait_for(log, r"^follower total seq: 120$", fproc, 60), \
            log.read_text()
        fproc.send_signal(signal.SIGINT)
        assert fproc.wait(60) == 0, log.read_text()
    finally:
        if fproc.poll() is None:
            fproc.kill()
            fproc.wait()


def test_port_cluster_role_converges(tmp_path):
    """``--role cluster``: the leader and two colocated followers in one
    process converge on every write."""
    res = subprocess.run(
        [sys.executable, "-m", MODS["port"], "--role", "cluster", "--port",
         str(_free_port()), "--db_dir", str(tmp_path), *SIZE,
         "--linger_sec", "60", "--device", "cpu"],
        cwd=str(REPO), env=_env(), capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "leader acked 120/120 writes window=64 mode=0" in res.stdout
    assert "cluster converged" in res.stdout, res.stdout[-3000:]
