"""The port's operator tools for live RPC traffic: ``tools/rpcgrep.py``
(its proxy and its passive sniff) and ``tools/latency_proxy.py``, the
reference's cases (``tests/test_kafka.py``'s rpcgrep cases,
``tests/test_latency_proxy.py``) run on the port's copies against port
nodes."""

import asyncio
import os
import re
import socket
import subprocess
import sys
import threading
import time

import pytest

from torch_parity import AdminNode, ReplPackage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_rpcgrep_decodes_proxied_traffic(tmp_path, capsys):
    from rocksplicator_tpu_torch.rpc import IoLoop, RpcClientPool
    from rocksplicator_tpu_torch.tools import rpcgrep

    node = AdminNode(ReplPackage("port"), tmp_path, "a")
    proxy_port = _free_port()
    stop_loop = {}

    def run_proxy():
        loop = asyncio.new_event_loop()
        stop_loop["loop"] = loop
        asyncio.set_event_loop(loop)
        task = loop.create_task(rpcgrep.serve(
            proxy_port, "127.0.0.1", node.admin_port, re.compile("ping"),
            False))
        stop_loop["task"] = task
        try:
            loop.run_until_complete(task)
        except (Exception, asyncio.CancelledError):
            pass

    t = threading.Thread(target=run_proxy, daemon=True)
    t.start()
    time.sleep(0.5)
    ioloop = IoLoop.default()
    pool = RpcClientPool()

    async def go():
        return await pool.call("127.0.0.1", proxy_port, "ping", {})

    try:
        r = ioloop.run_sync(go())
        assert r["ok"] is True  # proxied call works end to end
        out = capsys.readouterr().out
        assert "method=ping" in out
        assert "reply id=" in out
    finally:
        ioloop.run_sync(pool.close())
        # cancel the serve task (not loop.stop) so the coroutine finishes
        stop_loop["loop"].call_soon_threadsafe(stop_loop["task"].cancel)
        t.join(timeout=5)
        node.stop()


def test_rpcgrep_passive_sniff_decodes_live_traffic(tmp_path):
    """The AF_PACKET passive mode decodes request and reply frames off
    live loopback traffic with no proxy in the path. Skipped where
    CAP_NET_RAW is unavailable, as the reference's case is."""
    try:
        probe = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                              socket.htons(0x0003))
        probe.close()
    except (PermissionError, AttributeError, OSError):
        pytest.skip("CAP_NET_RAW unavailable")

    from rocksplicator_tpu_torch.rpc import IoLoop, RpcClientPool

    node = AdminNode(ReplPackage("port"), tmp_path, "dbs")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    sniffer = subprocess.Popen(
        [sys.executable, "-m", "rocksplicator_tpu_torch.tools.rpcgrep",
         "--sniff", str(node.admin_port), "--iface", "lo", "--show-args"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env)
    try:
        banner = sniffer.stdout.readline()
        assert "sniffing" in banner, banner
        time.sleep(0.5)
        ioloop, pool = IoLoop.default(), RpcClientPool()

        def call(method, **a):
            async def go():
                return await pool.call("127.0.0.1", node.admin_port, method,
                                       a, timeout=30)

            return ioloop.run_sync(go())

        call("add_db", db_name="seg00042", role="LEADER")
        call("get_sequence_number", db_name="seg00042")
        time.sleep(1.5)
        ioloop.run_sync(pool.close())
    finally:
        sniffer.terminate()
        out, _ = sniffer.communicate(timeout=15)
        node.stop()
    assert "method=add_db" in out, out[-2000:]
    assert "method=get_sequence_number" in out
    assert "ok=True" in out
    assert "seg00042" in out  # --show-args decoded the payload


def test_latency_proxy_forwards_and_delays():
    from rocksplicator_tpu_torch.tools.latency_proxy import serve

    async def go():
        echoed = {}

        async def echo(reader, writer):
            data = await reader.read(1024)
            echoed["got"] = data
            writer.write(b"pong:" + data)
            await writer.drain()
            writer.close()

        backend = await asyncio.start_server(echo, "127.0.0.1", 0)
        bport = backend.sockets[0].getsockname()[1]
        pport = _free_port()
        ready = asyncio.Event()
        proxy_task = asyncio.create_task(
            serve(pport, "127.0.0.1", bport, delay_ms=20.0,
                  ready_event=ready))
        await asyncio.wait_for(ready.wait(), 5.0)
        t0 = time.monotonic()
        reader, writer = await asyncio.open_connection("127.0.0.1", pport)
        writer.write(b"ping")
        await writer.drain()
        resp = await asyncio.wait_for(reader.read(1024), 5.0)
        rtt = time.monotonic() - t0
        assert resp == b"pong:ping"
        assert echoed["got"] == b"ping"
        # one-way 20 ms each direction => RTT must exceed ~40 ms
        assert rtt >= 0.04, rtt
        writer.close()
        proxy_task.cancel()
        backend.close()

    asyncio.run(go())
