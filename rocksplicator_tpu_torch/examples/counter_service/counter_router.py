"""CounterRouter: counter name → (db, shard, hosts).
(The port's copy of ``examples/counter_service/counter_router.py``.)

Reference: examples/counter_service/counter_router.h:19-36 — thin wrapper
over ThriftRouter mapping a counter name to its segment shard and clients.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

from rocksplicator_tpu_torch.rpc.router import Host, Quantity, Role, RpcRouter
from rocksplicator_tpu_torch.utils.segment_utils import segment_to_db_name

SEGMENT = "counter"


def shard_for(counter_name: str, num_shards: int) -> int:
    return zlib.crc32(counter_name.encode("utf-8")) % max(1, num_shards)


def db_name_for(counter_name: str, num_shards: int) -> str:
    return segment_to_db_name(SEGMENT, shard_for(counter_name, num_shards))


class CounterRouter:
    def __init__(self, router: RpcRouter, segment: str = SEGMENT):
        self._router = router
        self._segment = segment

    @property
    def num_shards(self) -> int:
        return self._router.num_shards(self._segment)

    def shard_for(self, counter_name: str) -> int:
        return shard_for(counter_name, self.num_shards)

    def db_name_for(self, counter_name: str) -> str:
        return segment_to_db_name(self._segment, self.shard_for(counter_name))

    def hosts_for(
        self, counter_name: str, role: Role = Role.LEADER,
        quantity: Quantity = Quantity.ONE,
    ) -> List[Host]:
        return self._router.get_hosts_for(
            self._segment, self.shard_for(counter_name), role, quantity
        )

    async def clients_for(self, counter_name: str, role: Role = Role.LEADER,
                          quantity: Quantity = Quantity.ONE):
        return await self._router.get_clients_for(
            self._segment, self.shard_for(counter_name), role, quantity
        )
