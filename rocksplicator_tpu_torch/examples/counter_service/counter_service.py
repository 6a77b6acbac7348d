"""CounterHandler + service main.
(The port's copy of ``examples/counter_service/counter_service.py``.)

Reference: examples/counter_service/counter_handler.cpp:31-107 (handler
extending AdminHandler; get/set/bump with ``need_routing`` server-side
forwarding) and counter.cpp:57-104 (main wiring: Stats, shard-map router,
DBs created from static config, RPC server, StatusServer, cluster join).

Where the port differs: ``CounterHandler`` extends the port's
``AdminHandler``, so every counter DB compacts on the card (``device=None``
meaning ``cuda``); ``main`` takes the reference's flags plus ``--device``
(default ``cuda``, ``cpu`` for the plain PyTorch path) and resolves it
before it opens anything, so without CUDA it raises unless asked for the
CPU.

    python -m rocksplicator_tpu_torch.examples.counter_service.counter_service \
        --rocksdb_dir /data/a --port 9090 --status_port 9999 \
        --shard_map_path shard_map.json [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import struct
import sys
from typing import Optional

from rocksplicator_tpu_torch.admin import AdminHandler
from rocksplicator_tpu_torch.device import resolve_device
from rocksplicator_tpu_torch.admin.db_manager import ApplicationDBManager
from rocksplicator_tpu_torch.replication import ReplicaRole, ReplicationFlags, Replicator
from rocksplicator_tpu_torch.rpc import RpcApplicationError, RpcServer
from rocksplicator_tpu_torch.rpc.router import Quantity, Role, RpcRouter
from rocksplicator_tpu_torch.storage.records import WriteBatch
from rocksplicator_tpu_torch.utils.graceful_shutdown import GracefulShutdownHandler
from rocksplicator_tpu_torch.utils.hot_key_detector import HotKeyDetector
from rocksplicator_tpu_torch.utils.misc import availability_zone, local_ip
from rocksplicator_tpu_torch.utils.segment_utils import segment_to_db_name
from rocksplicator_tpu_torch.utils.stats import Stats
from rocksplicator_tpu_torch.utils.status_server import StatusServer

from .counter_router import SEGMENT, CounterRouter
from .options import counter_options_generator

_I64 = struct.Struct("<q")


class CounterHandler(AdminHandler):
    """``service Counter extends Admin`` — the handler stacks counter RPCs
    on top of every Admin RPC (counter_handler.cpp:31-107)."""

    def __init__(self, *args, router: Optional[RpcRouter] = None, **kw):
        super().__init__(*args, **kw)
        self.router = CounterRouter(router) if router else None
        # hot-key detection on the access path (reference HotKeyDetector
        # integration: find runaway counters before they melt a shard)
        self.hot_keys = HotKeyDetector(num_buckets=100)

    def hot_keys_text(self) -> str:
        """/hotkeys.txt status-server endpoint body: decayed access count
        plus the share of total traffic (the quantity is_above compares)."""
        total = max(1e-9, self.hot_keys.total())
        lines = [
            f"{name} count={count:.1f} share={count / total:.3f}"
            for name, count in self.hot_keys.top(20)
        ]
        return "\n".join(lines) + "\n"

    # -- helpers -----------------------------------------------------------

    async def _write_replicated(self, app_db, batch) -> int:
        """Pipelined replicated write: the WAL commit runs in the admin
        executor (it can block on flow control / storage admission), but
        the semi-sync ACK wait is awaited on the loop via the write's ack
        future — an executor thread is no longer parked for the whole
        follower round-trip, so in-flight counter writes are bounded by
        the per-shard write window instead of the executor size."""
        waiter = await self._run(app_db.write_async, batch)
        await asyncio.wrap_future(waiter.future)
        return waiter.seq

    def _local_db_for(self, counter_name: str):
        if self.router is None or self.router.num_shards == 0:
            raise RpcApplicationError("NO_SHARD_MAP", "router not configured")
        db_name = self.router.db_name_for(counter_name)
        return db_name, self.db_manager.get_db(db_name)

    async def _forward(self, method: str, counter_name: str, **extra):
        """Server-side routing (need_routing flag): forward to the shard's
        leader elsewhere in the cluster."""
        clients = await self.router.clients_for(counter_name, Role.LEADER)
        if not clients:
            raise RpcApplicationError("NO_LEADER", counter_name)
        return await clients[0].call(
            method, {"counter_name": counter_name, "need_routing": False, **extra}
        )

    # -- counter RPCs -------------------------------------------------------

    async def handle_get_counter(
        self, counter_name: str = "", need_routing: bool = False
    ) -> dict:
        self.hot_keys.record(counter_name)
        db_name, app_db = self._local_db_for(counter_name)
        if app_db is None:
            if need_routing:
                return await self._forward("get_counter", counter_name)
            raise RpcApplicationError("DB_NOT_FOUND", db_name)
        raw = await self._run(app_db.get, counter_name.encode("utf-8"))
        return {"counter_value": _I64.unpack(raw)[0] if raw else 0}

    async def handle_set_counter(
        self, counter_name: str = "", counter_value: int = 0,
        need_routing: bool = False,
    ) -> dict:
        self.hot_keys.record(counter_name)
        db_name, app_db = self._local_db_for(counter_name)
        if app_db is None or (
            app_db.role is not ReplicaRole.LEADER
            and app_db.role is not ReplicaRole.NOOP
        ):
            if need_routing:
                return await self._forward(
                    "set_counter", counter_name, counter_value=counter_value
                )
            raise RpcApplicationError("NOT_LEADER", db_name)
        batch = WriteBatch().put(
            counter_name.encode("utf-8"), _I64.pack(counter_value)
        )
        await self._write_replicated(app_db, batch)
        return {}

    async def handle_bump_counter(
        self, counter_name: str = "", delta: int = 1, need_routing: bool = False
    ) -> dict:
        self.hot_keys.record(counter_name)
        db_name, app_db = self._local_db_for(counter_name)
        if app_db is None or (
            app_db.role is not ReplicaRole.LEADER
            and app_db.role is not ReplicaRole.NOOP
        ):
            if need_routing:
                return await self._forward(
                    "bump_counter", counter_name, delta=delta
                )
            raise RpcApplicationError("NOT_LEADER", db_name)
        batch = WriteBatch().merge(counter_name.encode("utf-8"), _I64.pack(delta))
        await self._write_replicated(app_db, batch)
        return {}


def create_dbs_from_shard_map(
    handler: CounterHandler, router: RpcRouter, my_addr, segment: str = SEGMENT
) -> int:
    """CreateDBBasedOnConfig parity (admin_handler.cpp:246-323): open every
    shard this host owns per the static shard map, in the mapped role.
    ``my_addr`` is this host's (ip, service_port); follower upstreams use
    the leader's replication-plane address (Host.repl_addr)."""
    layout = router.layout.segments.get(segment)
    if layout is None:
        return 0
    created = 0
    for shard, host_roles in sorted(layout.shard_to_hosts.items()):
        my_role = None
        leader_repl_addr = None
        for host, role in host_roles:
            if role is Role.LEADER:
                leader_repl_addr = host.repl_addr
            if (host.ip, host.port) == tuple(my_addr):
                my_role = role
        if my_role is None:
            continue
        db_name = segment_to_db_name(segment, shard)
        if my_role is Role.LEADER:
            handler._open_app_db(db_name, ReplicaRole.LEADER, None)
        else:
            if leader_repl_addr is None:
                continue
            handler._open_app_db(db_name, ReplicaRole.FOLLOWER, leader_repl_addr)
        created += 1
    return created


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="counter service")
    p.add_argument("--rocksdb_dir", required=True)
    p.add_argument("--port", type=int, default=9090)
    p.add_argument("--replicator_port", type=int, default=0,
                   help="default: service port + 1 (shard-map convention)")
    p.add_argument("--status_port", type=int, default=9999)
    p.add_argument("--status_host", default="127.0.0.1",
                   help="status server bind address; pass 0.0.0.0 to allow "
                        "remote scraping (reference parity)")
    p.add_argument("--shard_map_path", default=None)
    p.add_argument("--az", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the DBs compact: cuda (the card, the "
                        "default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)

    # the card first: without CUDA nothing is opened
    device = resolve_device(args.device)
    Stats.get()
    az = args.az or availability_zone()
    router = RpcRouter(local_az=az, shard_map_path=args.shard_map_path)
    replicator = Replicator(port=args.replicator_port or args.port + 1)
    handler = CounterHandler(
        args.rocksdb_dir, replicator,
        db_manager=ApplicationDBManager(),
        options_generator=counter_options_generator,
        router=router,
        device=device,
    )
    # Shard maps carry the SERVICE port; peers reach replication at the
    # leader's repl_addr (4th host-key field or service port + 1).
    my_addr = (local_ip(), args.port)
    n = create_dbs_from_shard_map(handler, router, my_addr)
    server = RpcServer(port=args.port, ioloop=replicator.ioloop)
    server.add_handler(handler)
    server.start()
    status = StatusServer.start_status_server(
        args.status_port,
        extra_endpoints={
            "/storage_info.txt": handler.storage_info_text,
            "/hotkeys.txt": handler.hot_keys_text,
        },
        host=args.status_host,
    )
    shutdown = GracefulShutdownHandler()
    shutdown.add_server(server)
    shutdown.register_post_shutdown_hook(handler.close)
    shutdown.register_post_shutdown_hook(replicator.stop)
    shutdown.install()
    print(
        f"counter_service up: port={server.port} replicator={replicator.port} "
        f"status={status.port} dbs={n}",
        flush=True,
    )
    shutdown.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
