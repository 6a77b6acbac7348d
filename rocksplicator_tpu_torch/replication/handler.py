"""ReplicatorHandler: the replicate RPC service handler.
(The port's copy of ``rocksplicator_tpu/replication/handler.py``.)

Reference: rocksdb_replicator/replicator_handler.cpp:24-41 — db-name lookup
in the FastReadMap, delegate to ReplicatedDB::handleReplicateRequest,
SOURCE_NOT_FOUND otherwise.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..observability.context import current_span
from ..rpc.errors import RpcApplicationError
from ..utils.concurrent_map import FastReadMap
from ..utils.stats import Stats
from .wire import ReplicaRole, ReplicateErrorCode


class ReplicatorHandler:
    def __init__(self, db_map: FastReadMap, mux_state=None):
        self._dbs = db_map
        if mux_state is None:
            from .pull_mux import MuxServerState

            mux_state = MuxServerState()
        self._mux_state = mux_state

    async def handle_replicate(
        self,
        db_name: str = "",
        seq_no: int = 0,
        max_wait_ms: Optional[int] = None,
        max_updates: Optional[int] = None,
        role: str = ReplicaRole.FOLLOWER.value,
        applied_seq: Optional[int] = None,
        epoch: Optional[int] = None,
    ) -> dict:
        span = current_span()
        if span is not None and span.sampled:
            # tag the enclosing rpc.server span: /traces readers filter
            # replicate traffic by shard without opening child spans
            span.annotate(db=db_name, from_seq=seq_no,
                          max_updates=max_updates)
        db = self._dbs.get(db_name)
        if db is None or db.removed:
            raise RpcApplicationError(
                ReplicateErrorCode.SOURCE_NOT_FOUND.value, db_name
            )
        # Response carries latest_seq (CDC "start from now" probes, catch-up
        # progress) and source_role (puller's stale-leader detection).
        return await db.handle_replicate_request(
            seq_no=seq_no, max_wait_ms=max_wait_ms,
            max_updates=max_updates, role=role, applied_seq=applied_seq,
            epoch=epoch,
        )

    async def handle_replicate_mux(
        self,
        sections: Optional[dict] = None,
        max_wait_ms: Optional[int] = None,
        budget: Optional[int] = None,
    ) -> dict:
        """Multiplexed pull: ONE long-poll carrying the cursor
        set for every shard the peer pulls from this node; per-shard
        sections come back in one response, each with the exact
        semantics (fencing, acks, WAL typing, commit point) of a
        per-shard ``replicate`` — see replication/pull_mux.py."""
        span = current_span()
        if span is not None and span.sampled:
            span.annotate(mux_sections=len(sections or ()))
        return await self._mux_state.serve(
            self._dbs, sections or {}, max_wait_ms=max_wait_ms,
            budget=budget)

    async def handle_replicate_ack(
        self,
        db_name: str = "",
        applied_seq: int = 0,
        role: str = ReplicaRole.FOLLOWER.value,
        epoch: Optional[int] = None,
    ) -> dict:
        """Lightweight applied-position push from a pipelined puller whose
        next pull is a parked long-poll: lets mode-2 ack waiters resolve
        at the follower's apply time instead of the next pull."""
        db = self._dbs.get(db_name)
        if db is None or db.removed:
            raise RpcApplicationError(
                ReplicateErrorCode.SOURCE_NOT_FOUND.value, db_name
            )
        db.post_applied(applied_seq, role, epoch=epoch)
        return {"acked_seq": db._acked.value, "epoch": db.epoch}

    async def handle_read(
        self,
        db_name: str = "",
        op: str = "get",
        keys=None,
        start=None,
        count: Optional[int] = None,
        max_lag: Optional[int] = None,
        epoch: Optional[int] = None,
    ) -> dict:
        """Bounded-staleness read: any replica — LEADER or
        FOLLOWER within ``max_lag`` of the leader's committed sequence —
        serves get/multi_get/scan; a follower on a deposed lineage
        rejects exactly as it rejects stale-epoch pulls."""
        span = current_span()
        if span is not None and span.sampled:
            span.annotate(db=db_name, op=op)
        db = self._dbs.get(db_name)
        if db is None or db.removed:
            raise RpcApplicationError(
                ReplicateErrorCode.SOURCE_NOT_FOUND.value, db_name
            )
        return await db.handle_read_request(
            op=op, keys=keys, start=start, count=count, max_lag=max_lag,
            epoch=epoch,
        )

    async def handle_stats(self) -> dict:
        """Process stats export for the spectator's scrape loop:
        every counter/gauge plus the exact all-time histogram
        states (``Stats.export_state``), tagged with this node's shard
        roles so the aggregator can attribute per-shard series without
        a second control-plane lookup. Runs in the executor — the
        export drains thread buffers under locks and evaluates engine
        gauges, none of which belongs on the event loop."""
        roles = {name: rdb.role.value for name, rdb in self._dbs.items()
                 if not rdb.removed}
        loop = asyncio.get_running_loop()
        # cached dump: at fleet shape the export's gauge
        # sweep is O(shards); the short-TTL cache makes concurrent
        # scrapers (spectator + /metrics pollers) share one pass. The
        # cached dict is shared — copy the top level before annotating.
        state = dict(await loop.run_in_executor(
            None, Stats.get().export_state_cached))
        state["shard_roles"] = roles
        return state

    async def handle_write(
        self,
        db_name: str = "",
        raw_batch=None,
        epoch: Optional[int] = None,
    ) -> dict:
        """Remote leader write (the macro-bench's full-stack put path):
        one encoded WriteBatch in, {seq, acked} out once the replication
        ack condition resolves. Non-leaders raise NOT_LEADER; a deposed
        leader raises STALE_EPOCH."""
        db = self._dbs.get(db_name)
        if db is None or db.removed:
            raise RpcApplicationError(
                ReplicateErrorCode.SOURCE_NOT_FOUND.value, db_name
            )
        if raw_batch is None:
            raise RpcApplicationError("BAD_WRITE", "raw_batch required")
        return await db.handle_write_request(raw_batch, epoch=epoch)
