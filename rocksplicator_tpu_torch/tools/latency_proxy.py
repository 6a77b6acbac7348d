"""TCP latency proxy — DCN-shaped links for single-host benches; the
port's copy of ``tools/latency_proxy.py``.

The replication/cluster benches run leader and followers on loopback
(~50 us RTT); real deployments replicate across hosts (DCN, ~0.5-2 ms
RTT). This proxy forwards a TCP port with a configurable one-way delay
so the same single-host harnesses produce cross-host-shaped evidence
(nothing in the framework assumes localhost — this measures it).

    python -m rocksplicator_tpu_torch.tools.latency_proxy --listen 19400 \
        --target 127.0.0.1:9400 --delay-ms 1.0

Each direction delays every segment by --delay-ms before forwarding
(i.e. RTT ≈ 2 × delay). Asyncio, one process, many connections.
"""

from __future__ import annotations

import argparse
import asyncio
import sys


async def _pump(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                delay: float) -> None:
    """Latency WITHOUT a bandwidth cap: reads never stall on the delay.
    Each chunk is timestamped into a queue; a drainer task sleeps only
    until each chunk's delivery time (an inline sleep-per-chunk would
    cap throughput at chunk_size/delay, conflating latency with an
    artificial bandwidth ceiling real DCN links don't have)."""
    loop = asyncio.get_running_loop()
    q: asyncio.Queue = asyncio.Queue()

    async def drain():
        try:
            while True:
                item = await q.get()
                if item is None:
                    break
                deliver_at, data = item
                now = loop.time()
                if deliver_at > now:
                    await asyncio.sleep(deliver_at - now)
                writer.write(data)
                await writer.drain()
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    drainer = asyncio.ensure_future(drain())
    try:
        while True:
            data = await reader.read(64 * 1024)
            if not data:
                break
            await q.put((loop.time() + delay, data))
    except (ConnectionError, asyncio.IncompleteReadError, OSError):
        pass
    finally:
        await q.put(None)
        await drainer


async def serve(listen_port: int, target_host: str, target_port: int,
                delay_ms: float, ready_event=None) -> None:
    delay = delay_ms / 1000.0

    async def on_conn(creader, cwriter):
        try:
            treader, twriter = await asyncio.open_connection(
                target_host, target_port)
        except OSError:
            cwriter.close()
            return
        await asyncio.gather(
            _pump(creader, twriter, delay),
            _pump(treader, cwriter, delay),
        )

    server = await asyncio.start_server(on_conn, "127.0.0.1", listen_port)
    if ready_event is not None:
        ready_event.set()
    print(f"READY proxy :{listen_port} -> {target_host}:{target_port} "
          f"one-way {delay_ms} ms", flush=True)
    async with server:
        await server.serve_forever()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--listen", type=int, required=True)
    ap.add_argument("--target", required=True, help="host:port")
    ap.add_argument("--delay-ms", type=float, default=1.0)
    args = ap.parse_args()
    host, _, port = args.target.partition(":")
    try:
        asyncio.run(serve(args.listen, host, int(port), args.delay_ms))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
