#!/usr/bin/env python
"""rpcgrep — live RPC traffic inspection (the tgrep equivalent); the
port's copy of ``tools/rpcgrep.py``, decoding frames with the port's own
``rpc/framing`` and ``rpc/serde``.

Reference: tgrep/ (1.2k LoC) — a thrift-aware packet sniffer (libpcap →
flow reassembly → thrift frame decode) for debugging live traffic. Two
modes here:

- **proxy** (works unprivileged): point a client at the proxy port,
  traffic forwards to the real server while every frame's header
  (method, id, ok/error, payload size) prints.
- **sniff** (``--sniff PORT``, needs CAP_NET_RAW/root — the same
  requirement as tgrep's libpcap): PASSIVE capture via an AF_PACKET
  socket. No re-pointing of clients: TCP segments to/from the port are
  reassembled per flow (seq-ordered, out-of-order buffered, retransmit
  trimmed) and each direction's byte stream is frame-decoded exactly
  like the proxy path.

Usage:
    python -m rocksplicator_tpu_torch.tools.rpcgrep --listen 9190 \
        --target 127.0.0.1:9090 [--method 'replicate|add_db'] [--show-args]
    python -m rocksplicator_tpu_torch.tools.rpcgrep --sniff 9090 \
        [--iface lo] [--method ...]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import sys
import time

from rocksplicator_tpu_torch.rpc.framing import FrameReader, write_frame
from rocksplicator_tpu_torch.rpc.serde import decode_message


def _summarize(direction: str, header: memoryview, payload: memoryview,
               method_re, show_args: bool, conn_id: int) -> None:
    try:
        msg = decode_message(header, payload)
    except Exception as e:
        print(f"[{conn_id}] {direction} <undecodable: {e}>")
        return
    method = msg.get("method")
    # sampled trace context rides the frame header (rpc/client.py): print
    # the trace id so wire captures join in-process /traces on one id.
    # Sanitized before printing — ids are peer-supplied bytes and this
    # line is an operator-terminal/log sink (same rule as
    # observability/context.valid_wire_context).
    tctx = msg.get("trace")
    tid = tctx.get("trace_id") if isinstance(tctx, dict) else None
    trace = (f" trace={tid[:64]}"
             if isinstance(tid, str) and tid and tid[:64].isalnum() else "")
    if method is not None:  # request
        if method_re and not method_re.search(method):
            return
        line = (f"[{conn_id}] {direction} call id={msg.get('id')} "
                f"method={method}{trace} payload={len(payload)}B")
        if show_args:
            args = {
                k: (f"<{len(v)}B>" if isinstance(v, (bytes, memoryview)) else v)
                for k, v in (msg.get("args") or {}).items()
            }
            line += f" args={json.dumps(args, default=str)[:200]}"
    else:  # reply
        ok = msg.get("ok")
        err = (msg.get("error") or {}).get("code") if not ok else None
        line = (f"[{conn_id}] {direction} reply id={msg.get('id')} "
                f"ok={ok}{f' error={err}' if err else ''} "
                f"payload={len(payload)}B")
    ts = time.strftime("%H:%M:%S")
    print(f"{ts} {line}", flush=True)


async def _pump(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                direction: str, method_re, show_args: bool,
                conn_id: int) -> None:
    frames = FrameReader(reader)
    try:
        while True:
            header, payload = await frames.read_frame()
            _summarize(direction, header, payload, method_re, show_args, conn_id)
            await write_frame(writer, bytes(header), [bytes(payload)])
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        pass
    finally:
        writer.close()


async def serve(listen_port: int, target_host: str, target_port: int,
                method_re, show_args: bool) -> None:
    conn_counter = [0]

    async def on_conn(cr: asyncio.StreamReader, cw: asyncio.StreamWriter):
        conn_counter[0] += 1
        cid = conn_counter[0]
        peer = cw.get_extra_info("peername")
        print(f"# conn {cid} from {peer}", flush=True)
        try:
            tr, tw = await asyncio.open_connection(target_host, target_port)
        except OSError as e:
            print(f"# conn {cid}: target unreachable: {e}", flush=True)
            cw.close()
            return
        await asyncio.gather(
            _pump(cr, tw, "->", method_re, show_args, cid),
            _pump(tr, cw, "<-", method_re, show_args, cid),
        )

    server = await asyncio.start_server(on_conn, "0.0.0.0", listen_port)
    addr = server.sockets[0].getsockname()
    print(f"# rpcgrep proxy on {addr} -> {target_host}:{target_port}",
          flush=True)
    async with server:
        await server.serve_forever()


class _FlowAssembler:
    """Seq-ordered TCP payload reassembly for ONE direction of one flow,
    feeding a frame parser. Out-of-order segments are buffered by seq;
    retransmitted bytes (seq below the cursor) are trimmed. The frame
    parser mirrors FrameReader over a byte buffer."""

    # must exceed framing.MAX_FRAME_BYTES or a legitimate near-cap frame
    # would trip the guard and kill the flow mid-assembly
    MAX_BUFFER = (256 << 20) + (8 << 20)

    def __init__(self, label: str, on_frame):
        self.label = label
        self._on_frame = on_frame
        self._next_seq = None  # established on first segment seen
        self._buf = bytearray()
        self._pending: dict = {}  # seq -> payload (out-of-order)
        self.dead = False

    def segment(self, seq: int, payload: bytes, syn: bool) -> None:
        if self.dead:
            return
        if syn:
            self._next_seq = (seq + 1) & 0xFFFFFFFF
            return
        if not payload:
            return
        if self._next_seq is None:
            # joined mid-flow: lock onto the first segment seen (frame
            # sync below recovers alignment via the magic scan)
            self._next_seq = seq
        self._pending[seq] = payload
        progressed = True
        while progressed:
            progressed = False
            for s in list(self._pending):
                data = self._pending[s]
                end = (s + len(data)) & 0xFFFFFFFF
                # distance math mod 2^32 handles seq wrap
                dist = (s - self._next_seq) & 0xFFFFFFFF
                if dist == 0:
                    self._buf += data
                    self._next_seq = end
                    del self._pending[s]
                    progressed = True
                elif dist > 0x7FFFFFFF:
                    # starts below the cursor: retransmit — keep any new tail
                    overlap = (self._next_seq - s) & 0xFFFFFFFF
                    del self._pending[s]
                    if overlap < len(data):
                        self._pending[(s + overlap) & 0xFFFFFFFF] = \
                            data[overlap:]
                        progressed = True
        if (len(self._buf) + sum(map(len, self._pending.values()))
                > self.MAX_BUFFER):
            print(f"# {self.label}: buffer cap exceeded — dropping flow",
                  flush=True)
            self.dead = True
            self._buf = bytearray()
            self._pending.clear()
            return
        self._drain_frames()

    def _drain_frames(self) -> None:
        import struct
        import zlib

        from rocksplicator_tpu_torch.rpc import framing as fr

        while True:
            if len(self._buf) < fr._HEADER.size:
                return
            magic, flags, hlen, plen = fr._HEADER.unpack_from(self._buf, 0)
            if magic != fr.MAGIC:
                # joined mid-stream: scan forward for the (LE u16) magic
                idx = bytes(self._buf).find(
                    struct.pack("<H", fr.MAGIC), 1)
                if idx < 0:
                    del self._buf[:max(0, len(self._buf) - 1)]
                    return
                del self._buf[:idx]
                continue
            total = fr._HEADER.size + hlen + plen
            if hlen + plen > fr.MAX_FRAME_BYTES:
                del self._buf[:2]  # false magic sync point: rescan
                continue
            if len(self._buf) < total:
                return
            header = bytes(self._buf[fr._HEADER.size:fr._HEADER.size + hlen])
            payload = bytes(self._buf[fr._HEADER.size + hlen:total])
            del self._buf[:total]
            if flags & fr.FLAG_PAYLOAD_ZLIB:
                try:
                    d = zlib.decompressobj()
                    raw = d.decompress(payload, fr.MAX_FRAME_BYTES + 1)
                    if len(raw) > fr.MAX_FRAME_BYTES:
                        continue
                    payload = raw
                except zlib.error:
                    continue
            self._on_frame(memoryview(header), memoryview(payload))


def sniff(port: int, iface: str, method_re, show_args: bool) -> int:
    """Passive capture loop: AF_PACKET → IPv4/TCP parse → per-flow
    reassembly → frame decode. Requires CAP_NET_RAW (same as tgrep)."""
    import socket
    import struct

    try:
        sock = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                             socket.htons(0x0003))  # ETH_P_ALL
    except (PermissionError, AttributeError) as e:
        print(f"# sniff mode needs CAP_NET_RAW (linux): {e}",
              file=sys.stderr)
        return 2
    if iface:
        sock.bind((iface, 0))
    print(f"# rpcgrep sniffing port {port} on "
          f"{iface or 'all interfaces'}", flush=True)
    flows = {}
    flow_seen = {}
    conn_ids = {}
    next_cid = [0]
    pkt_count = [0]
    IDLE_EVICT_SEC = 300.0

    def _sweep(now: float) -> None:
        # a FIN/RST can be dropped by the kernel ring: evict idle flows
        # (and their display ids) instead of holding buffers forever
        for k in [k for k, t in flow_seen.items()
                  if now - t > IDLE_EVICT_SEC]:
            flows.pop(k, None)
            flow_seen.pop(k, None)
        live = {(min((k[0], k[1]), (k[2], k[3])),
                 max((k[0], k[1]), (k[2], k[3]))) for k in flows}
        for ck in [ck for ck in conn_ids if ck not in live]:
            conn_ids.pop(ck, None)

    def handle(pkt: bytes) -> None:
        if len(pkt) < 34 or pkt[12:14] != b"\x08\x00":
            return  # not IPv4
        ihl = (pkt[14] & 0x0F) * 4
        if pkt[23] != 6:  # not TCP
            return
        ip_total = struct.unpack_from(">H", pkt, 16)[0]
        tcp_off = 14 + ihl
        if len(pkt) < tcp_off + 20:
            return
        sport, dport = struct.unpack_from(">HH", pkt, tcp_off)
        if sport != port and dport != port:
            return
        seq = struct.unpack_from(">I", pkt, tcp_off + 4)[0]
        doff = (pkt[tcp_off + 12] >> 4) * 4
        tcp_flags = pkt[tcp_off + 13]
        payload_start = tcp_off + doff
        payload_end = 14 + ip_total
        payload = pkt[payload_start:payload_end]
        src = socket.inet_ntoa(pkt[26:30])
        dst = socket.inet_ntoa(pkt[30:34])
        conn_key = tuple(sorted(((src, sport), (dst, dport))))
        if conn_key not in conn_ids:
            next_cid[0] += 1
            conn_ids[conn_key] = next_cid[0]
        cid = conn_ids[conn_key]
        direction = "->" if dport == port else "<-"
        fkey = (src, sport, dst, dport)
        if tcp_flags & 0x04:  # RST: drop both directions
            flows.pop(fkey, None)
            flows.pop((dst, dport, src, sport), None)
            return
        flow = flows.get(fkey)
        if flow is None:
            flow = _FlowAssembler(
                f"{cid}{direction}",
                lambda h, p, _d=direction, _c=cid: _summarize(
                    _d, h, p, method_re, show_args, _c))
            flows[fkey] = flow
        flow.segment(seq, payload, syn=bool(tcp_flags & 0x02))
        flow_seen[fkey] = time.time()
        if tcp_flags & 0x01:  # FIN
            flows.pop(fkey, None)
            flow_seen.pop(fkey, None)
        pkt_count[0] += 1
        if pkt_count[0] % 1000 == 0:
            _sweep(time.time())

    try:
        while True:
            # 65535B IP total + 14B ethernet: 1<<16 would truncate a
            # maximum-size loopback segment and wedge the flow
            handle(sock.recv((1 << 16) + 128))
    except KeyboardInterrupt:
        return 0
    finally:
        sock.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--listen", type=int, default=0)
    p.add_argument("--target", default=None, help="host:port")
    p.add_argument("--sniff", type=int, default=0,
                   help="PASSIVE mode: capture this server port via "
                        "AF_PACKET (CAP_NET_RAW) — no client re-pointing")
    p.add_argument("--iface", default="",
                   help="sniff interface (default: all; use 'lo' for "
                        "localhost traffic)")
    p.add_argument("--method", default=None, help="regex filter")
    p.add_argument("--show-args", action="store_true")
    args = p.parse_args(argv)
    method_re = re.compile(args.method) if args.method else None
    if args.sniff:
        return sniff(args.sniff, args.iface, method_re, args.show_args)
    if not args.listen or not args.target:
        p.error("either --sniff PORT, or both --listen and --target")
    host, port = args.target.split(":")
    try:
        asyncio.run(serve(args.listen, host, int(port), method_re,
                          args.show_args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
