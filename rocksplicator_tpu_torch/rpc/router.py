"""Shard-map-driven request router.
(The port's copy of ``rocksplicator_tpu/rpc/router.py``.)

Reference: common/thrift_router.h:86-534 — parses a JSON shard map
(format per thrift_router.h:536-566 / ConfigGenerator.java:
``{segment: {num_shards: N, "ip:port:az": ["00042:M", "00043:S", ...]}}``)
into a ``ClusterLayout``; ``getClientsFor(segment, role, quantity, shard)``
applies role filtering, master preference, AZ-locality sort, and a
deterministic rotation hash (thrift_router.h:384-455) so equally-good
replicas share load. The map file is hot-reloaded via the file watcher.
"""

from __future__ import annotations

import asyncio
import enum
import itertools
import json
import logging
import os
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..testing import failpoints as fp
from ..utils.file_watcher import FileWatcher
from ..utils.stats import Stats, tagged
from ..utils.timer import Timer
from .client_pool import RpcClientPool
from .deadline import armor_enabled
from .errors import RpcApplicationError, RpcConnectionError, RpcTimeout

log = logging.getLogger(__name__)

# read-RPC application errors that mean "try the next candidate" rather
# than "the request is bad": a follower too stale for the bound, a
# replica on a deposed lineage, a non-leader asked a leader-only
# question, a replica that hasn't registered the db yet (mid-repoint),
# or one whose wrapper doesn't persist locally (CDC observer)
_READ_BOUNCE_CODES = frozenset(
    ("STALE_READ", "STALE_EPOCH", "NOT_LEADER", "SOURCE_NOT_FOUND",
     "READS_UNSUPPORTED"))
# write-RPC errors that mean "try the next mapped leader": the stale
# shard-map cases during a handoff — the old leader either demoted
# already (NOT_LEADER), is fenced by the new epoch (STALE_EPOCH), or
# dropped the db mid-repoint (SOURCE_NOT_FOUND)
_WRITE_BOUNCE_CODES = frozenset(
    ("NOT_LEADER", "STALE_EPOCH", "SOURCE_NOT_FOUND"))

# ops eligible for the tail-shaving backup request. scan is
# deliberately excluded: a hedged scan doubles an UNBOUNDED amount of
# engine work for one credit, and split-parent scans already fan out
_HEDGEABLE_OPS = frozenset(("get", "multi_get"))


def _retrieve_exception(task: "asyncio.Task") -> None:
    """Done-callback for hedge arms: a loser that errors after the
    winner returned must not log "exception was never retrieved"."""
    if not task.cancelled():
        task.exception()


class Role(enum.Enum):
    LEADER = "LEADER"       # reference: MASTER
    FOLLOWER = "FOLLOWER"   # reference: SLAVE
    ANY = "ANY"


class Quantity(enum.Enum):
    ONE = 1
    TWO = 2
    ALL = -1


@dataclass(frozen=True)
class ReadPolicy:
    """Read preference for routed reads.

    Reference mapping: ThriftRouter's role filter + AZ-locality sort
    (thrift_router.h:384-455) — the reference serves reads from SLAVE
    replicas in the local AZ by asking ``getClientsFor(..., SLAVE)``;
    here the policy also carries the staleness bound the serving replica
    must prove (``max_lag``, in sequence numbers).

    - ``leader_only()``      — only the LEADER serves (the implicit
      default: read throughput caps at leader capacity);
    - ``follower_ok(lag)``   — followers are ACCEPTABLE: every replica
      (followers AND the leader) joins one per-request-rotated group,
      so read throughput scales with replica count; a FOLLOWER serves
      only when its applied position is within ``lag`` seqs of the
      leader's committed sequence, and a stale/deposed replica bounces
      the read down the chain — which always contains the leader;
    - ``nearest(lag)``       — AZ-locality first regardless of role
      (the reference's local-replica preference), same bound semantics.
    """

    kind: str = "leader_only"
    max_lag: Optional[int] = None

    @classmethod
    def leader_only(cls) -> "ReadPolicy":
        return cls("leader_only", None)

    @classmethod
    def follower_ok(cls, max_lag: int) -> "ReadPolicy":
        return cls("follower_ok", int(max_lag))

    @classmethod
    def nearest(cls, max_lag: Optional[int] = None) -> "ReadPolicy":
        return cls("nearest", None if max_lag is None else int(max_lag))


@dataclass(frozen=True)
class Host:
    ip: str
    port: int
    az: str
    # Replication-plane port. The reference runs its replicator on a fixed
    # port (9091) next to the service port (9090); here the convention is
    # service port + 1 unless the shard map's 4th host-key field overrides.
    repl_port: int = 0

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.ip, self.port)

    @property
    def repl_addr(self) -> Tuple[str, int]:
        return (self.ip, self.repl_port or self.port + 1)


@dataclass
class _Segment:
    num_shards: int = 0
    # shard -> [(host, role)]
    shard_to_hosts: Dict[int, List[Tuple[Host, Role]]] = field(default_factory=dict)
    # hot-shard range splits: parent shard -> (split_key,
    # low child, high child). num_shards stays the HASH width — keys
    # still hash to the parent slot; resolve_shard chases these records
    # (transitively: children can split again) to the serving child.
    splits: Dict[int, Tuple[bytes, int, int]] = field(default_factory=dict)


class ClusterLayout:
    def __init__(self) -> None:
        self.segments: Dict[str, _Segment] = {}

    @classmethod
    def parse(cls, content: bytes) -> "ClusterLayout":
        """Parse the shard-map JSON (reference thrift_router.h:536-566)."""
        layout = cls()
        raw = json.loads(content.decode("utf-8")) if content.strip() else {}
        if not isinstance(raw, dict):
            raise ValueError("shard map must be a JSON object")
        for segment, body in raw.items():
            if not isinstance(body, dict):
                raise ValueError(f"segment {segment}: body must be an object")
            seg = _Segment()
            for key, value in body.items():
                if key in ("num_shards", "num_leaf_segments"):
                    seg.num_shards = int(value)
                    continue
                if key == "__splits__":
                    # {"<parent>": {"split_key": hex, "low": n, "high": n}}
                    for parent, rec in dict(value).items():
                        seg.splits[int(parent)] = (
                            bytes.fromhex(str(rec["split_key"])),
                            int(rec["low"]), int(rec["high"]))
                    continue
                parts = key.split(":")
                if len(parts) < 2:
                    raise ValueError(f"bad host key: {key!r}")
                ip, port = parts[0], int(parts[1])
                az = parts[2] if len(parts) > 2 else ""
                repl_port = int(parts[3]) if len(parts) > 3 else 0
                host = Host(ip, port, az, repl_port)
                for shard_spec in value:
                    shard_str, _, role_str = str(shard_spec).partition(":")
                    shard = int(shard_str)
                    role = {
                        "M": Role.LEADER,
                        "S": Role.FOLLOWER,
                        "": Role.ANY,
                    }.get(role_str, Role.ANY)
                    seg.shard_to_hosts.setdefault(shard, []).append((host, role))
            layout.segments[segment] = seg
        return layout


class RpcRouter:
    """Routes requests by (segment, shard, role)."""

    def __init__(
        self,
        local_az: str = "",
        shard_map_path: Optional[str] = None,
        pool: Optional[RpcClientPool] = None,
        local_group_prefix_len: int = 0,
    ):
        self._local_az = local_az
        self._layout = ClusterLayout()
        self._pool = pool or RpcClientPool()
        # Locality tier between same-AZ and remote: hosts whose AZ shares
        # the first N chars with ours (e.g. "us-east-1a"/"us-east-1b" share
        # 9) — the reference's local-group-prefix sort.
        self._local_group_prefix_len = local_group_prefix_len
        self._shard_map_path = shard_map_path
        # per-request rotation for read spreading across equally-good
        # followers (itertools.count is GIL-atomic enough for a counter)
        self._read_seq = itertools.count()
        self._stats = Stats.get()
        # Hedge budget: every eligible follower_ok read
        # earns RSTPU_HEDGE_PCT credit; firing one hedge spends 1.0 —
        # a hard ≤PCT extra-read cap so hedging cannot amplify the very
        # overload it defends against. The small cap bounds bursts
        # after an idle stretch. Loop-thread only, no lock needed.
        self._hedge_credit = 0.0
        self._hedge_credit_cap = 5.0
        if shard_map_path is not None:
            FileWatcher.instance().add_file(shard_map_path, self._on_map_content)

    def close(self) -> None:
        """Unregister the shard-map watcher (must be called for routers
        constructed with ``shard_map_path``)."""
        if self._shard_map_path is not None:
            FileWatcher.instance().remove_file(
                self._shard_map_path, self._on_map_content
            )
            self._shard_map_path = None

    # -- config -----------------------------------------------------------

    def _on_map_content(self, content: bytes) -> None:
        try:
            self._layout = ClusterLayout.parse(content)
        except (ValueError, KeyError) as e:
            log.error("invalid shard map, keeping previous: %s", e)

    def update_layout(self, layout: ClusterLayout) -> None:
        self._layout = layout

    @property
    def layout(self) -> ClusterLayout:
        return self._layout

    def num_shards(self, segment: str) -> int:
        seg = self._layout.segments.get(segment)
        return seg.num_shards if seg else 0

    # -- host selection ---------------------------------------------------

    def get_hosts_for(
        self,
        segment: str,
        shard: int,
        role: Role = Role.ANY,
        quantity: Quantity = Quantity.ONE,
    ) -> List[Host]:
        """Ordered candidate hosts for a shard.

        Selection mirrors thrift_router.h:384-455: filter by role (ANY
        prefers the leader first), sort by AZ locality, then rotate
        equally-local groups deterministically by shard hash.
        """
        seg = self._layout.segments.get(segment)
        if seg is None:
            return []
        entries = seg.shard_to_hosts.get(shard, [])
        if role is Role.ANY:
            candidates = sorted(
                entries, key=lambda hr: 0 if hr[1] is Role.LEADER else 1
            )
        else:
            candidates = [hr for hr in entries if hr[1] is role]

        def locality(hr: Tuple[Host, Role]) -> int:
            host = hr[0]
            if self._local_az and host.az == self._local_az:
                return 0
            n = self._local_group_prefix_len
            if (
                n > 0
                and self._local_az
                and host.az[:n] == self._local_az[:n]
            ):
                return 1
            return 2

        # Stable sort keeps the leader-first ordering within locality tiers;
        # rotation spreads load across equally-good candidates.
        rot = zlib.crc32(f"{segment}:{shard}".encode()) if candidates else 0
        groups: Dict[Tuple[int, int], List[Host]] = {}
        for hr in candidates:
            key = (locality(hr), 0 if hr[1] is Role.LEADER and role is Role.ANY else 1)
            groups.setdefault(key, []).append(hr[0])
        ordered: List[Host] = []
        for key in sorted(groups):
            group = groups[key]
            r = rot % len(group)
            ordered.extend(group[r:] + group[:r])

        if quantity is Quantity.ALL:
            return ordered
        return ordered[: quantity.value]

    async def get_clients_for(
        self,
        segment: str,
        shard: int,
        role: Role = Role.ANY,
        quantity: Quantity = Quantity.ONE,
    ):
        """Connected clients for the chosen hosts; skips bad hosts
        (reference: filterBadHosts)."""
        clients = []
        want = None if quantity is Quantity.ALL else quantity.value
        for host in self.get_hosts_for(segment, shard, role, Quantity.ALL):
            try:
                clients.append(await self._pool.get_client(host.ip, host.port))
            except RpcConnectionError:
                continue
            if want is not None and len(clients) >= want:
                break
        return clients

    # -- hot-shard range splits --------------------------------

    def resolve_shard(self, segment: str, shard: int,
                      key: Optional[bytes]) -> int:
        """Slot → serving shard: chase the segment's split records by
        range (keys < split_key → low child, >= → high) transitively
        until an unsplit shard answers. A no-split segment returns the
        input shard unchanged — the pre-split hot path costs one dict
        miss."""
        seg = self._layout.segments.get(segment)
        if seg is None or not seg.splits or key is None:
            return shard
        k = bytes(key)
        while True:
            sp = seg.splits.get(shard)
            if sp is None:
                return shard
            split_key, low, high = sp
            shard = low if k < split_key else high

    async def _split_multi_get(self, segment: str, shard: int, keys,
                               policy, epoch, timeout: float):
        """multi_get across a split parent: partition keys by serving
        child, fan the per-child multi_gets out concurrently, stitch
        values back in the caller's key order. Response metadata (lag,
        epoch, role) is per-replica and meaningless across a fan-out —
        the stitched response carries one child's, values are exact."""
        groups: Dict[int, List[Tuple[int, bytes]]] = {}
        for i, k in enumerate(keys):
            child = self.resolve_shard(segment, shard, bytes(k))
            groups.setdefault(child, []).append((i, bytes(k)))
        ordered = sorted(groups.items())
        results = await asyncio.gather(*[
            self.read(segment, child, op="multi_get",
                      keys=[k for _i, k in items], policy=policy,
                      epoch=epoch, timeout=timeout)
            for child, items in ordered])
        values: List = [None] * len(keys)
        for (child, items), r in zip(ordered, results):
            got = (r or {}).get("values") or []
            for (i, _k), v in zip(items, got):
                values[i] = v
        resp = dict(results[-1] or {}) if results else {}
        resp["values"] = values
        return resp

    async def _split_scan(self, segment: str,
                          sp: Tuple[bytes, int, int], start, count,
                          policy, epoch, timeout: float):
        """Ordered scan across a split parent: low child first (rows
        truncated at the boundary — everything a full-copy child holds
        at or past its split key is pre-split garbage the range owns to
        the OTHER child), then continue into the high child from
        max(start, split_key). Nested splits recurse through read()."""
        split_key, low, high = sp
        want = 10 if count is None else max(1, int(count))
        out: List = []
        meta = None
        s = bytes(start) if start is not None else b""
        if s < split_key:
            r = await self.read(segment, low, op="scan",
                                start=(s or None), count=want,
                                policy=policy, epoch=epoch,
                                timeout=timeout)
            meta = r
            for row in (r or {}).get("values") or []:
                if bytes(row[0]) >= split_key:
                    break  # ordered: the rest is out-of-range garbage
                out.append(row)
        if len(out) < want:
            r = await self.read(segment, high, op="scan",
                                start=max(s, split_key),
                                count=want - len(out), policy=policy,
                                epoch=epoch, timeout=timeout)
            if meta is None:
                meta = r
            out.extend((r or {}).get("values") or [])
        resp = dict(meta or {})
        resp["values"] = out[:want]
        return resp

    # -- bounded-staleness reads -------------------------------

    def read_pick(self, segment: str, shard: int,
                  policy: ReadPolicy) -> List[Host]:
        """Ordered read candidates for a shard under a read policy. The
        last entries are the bounce targets a stale/deposed replica
        falls back to (always ending at the leader when one is mapped)."""
        if policy.kind == "leader_only":
            return self.get_hosts_for(segment, shard, Role.LEADER,
                                      Quantity.ALL)
        if policy.kind == "nearest":
            # locality-ordered ANY (leader-first within each tier —
            # the reference's local-replica preference)
            return self.get_hosts_for(segment, shard, Role.ANY,
                                      Quantity.ALL)
        if policy.kind != "follower_ok":
            raise ValueError(f"unknown read policy: {policy.kind!r}")
        # follower_ok: followers are ACCEPTABLE, not exclusive — every
        # replica (followers AND leader) joins one rotated group so read
        # throughput scales with replica count, not follower count. The
        # rotation is per-REQUEST: get_hosts_for's shard-hash rotation
        # is deterministic per shard, which would pin every read for a
        # shard to one replica — the opposite of read scaling. A
        # replica that bounces (stale lag / deposed lineage) falls
        # through to the rest of the chain, which always contains the
        # leader (lag 0 by definition).
        followers = self.get_hosts_for(segment, shard, Role.FOLLOWER,
                                       Quantity.ALL)
        leaders = self.get_hosts_for(segment, shard, Role.LEADER,
                                     Quantity.ALL)
        group = followers + [h for h in leaders if h not in followers]
        if group:
            r = next(self._read_seq) % len(group)
            group = group[r:] + group[:r]
        return group

    async def read(
        self,
        segment: str,
        shard: int,
        op: str = "get",
        keys=None,
        start=None,
        count: Optional[int] = None,
        policy: Optional[ReadPolicy] = None,
        epoch: Optional[int] = None,
        timeout: float = 10.0,
    ):
        """Routed bounded-staleness read: try the policy's candidates in
        order over the replication plane's ``read`` RPC, bouncing on
        STALE_READ (lag bound exceeded/unverifiable) and STALE_EPOCH
        (deposed lineage) toward the leader. Connection errors AND
        timeouts skip to the next candidate (reference: filterBadHosts;
        reads are idempotent, so retrying a wedged replica's read on
        another host is safe — unlike the write path, which must not
        re-commit on a timeout)."""
        policy = policy or ReadPolicy.leader_only()
        seg = self._layout.segments.get(segment)
        if seg is not None and seg.splits:
            # slot → serving child before any host is picked: the
            # parent db no longer exists once a split activates
            if op == "get":
                k = (keys[0] if keys else None) \
                    if isinstance(keys, (list, tuple)) else keys
                if k is not None:
                    shard = self.resolve_shard(segment, shard, bytes(k))
            elif op == "multi_get" and keys:
                targets = {self.resolve_shard(segment, shard, bytes(k))
                           for k in keys}
                if len(targets) == 1:
                    shard = targets.pop()
                else:
                    return await self._split_multi_get(
                        segment, shard, keys, policy, epoch, timeout)
            elif op == "scan":
                sp = seg.splits.get(shard)
                if sp is not None:
                    return await self._split_scan(
                        segment, sp, start, count, policy, epoch,
                        timeout)
        await fp.async_hit("router.read_pick")
        hosts = self.read_pick(segment, shard, policy)
        if not hosts:
            raise RpcConnectionError(
                f"no read candidates for {segment}:{shard} "
                f"under {policy.kind}")
        args = {
            "db_name": self._db_name(segment, shard),
            "op": op,
            "keys": keys,
            "start": start,
            "count": count,
            "max_lag": policy.max_lag,
            "epoch": epoch,
        }
        with Timer(tagged("router.read_ms", op=op, policy=policy.kind)):
            if (policy.kind == "follower_ok" and len(hosts) >= 2
                    and op in _HEDGEABLE_OPS and self._hedging_on()):
                return await self._hedged_read(
                    hosts, op, policy, args, timeout,
                    what=f"read {segment}:{shard}")
            return await self._failover_call(
                hosts, "read", args, _READ_BOUNCE_CODES, timeout,
                retry_timeouts=True, count_bounces=True,
                what=f"read {segment}:{shard}")

    async def write(
        self,
        segment: str,
        shard: int,
        raw_batch: bytes,
        epoch: Optional[int] = None,
        timeout: float = 30.0,
        key: Optional[bytes] = None,
    ):
        """Routed leader write over the replication plane's ``write``
        RPC (one encoded WriteBatch). NOT_LEADER / STALE_EPOCH (a
        fenced ex-leader still in the map) / SOURCE_NOT_FOUND /
        connection errors fall through to the next mapped leader
        candidate — the stale shard-map cases during a handoff.

        ``key`` opts the write into split resolution: under an active
        range split the hash slot's db is gone and the serving child
        depends on the key, which the encoded batch doesn't expose to
        the router. Callers writing to possibly-split segments pass the
        batch's key (single-key batches — a multi-key batch spanning a
        split boundary must be split by the CALLER)."""
        shard = self.resolve_shard(segment, shard, key)
        hosts = self.get_hosts_for(segment, shard, Role.LEADER,
                                   Quantity.ALL)
        if not hosts:
            raise RpcConnectionError(f"no leader for {segment}:{shard}")
        args = {
            "db_name": self._db_name(segment, shard),
            "raw_batch": raw_batch,
            "epoch": epoch,
        }
        return await self._failover_call(
            hosts, "write", args, _WRITE_BOUNCE_CODES, timeout,
            retry_timeouts=False, count_bounces=False,
            what=f"write {segment}:{shard}")

    # -- hedged bounded-staleness reads ------------------------

    @staticmethod
    def _hedging_on() -> bool:
        """Hedging rides the RSTPU_TAIL_ARMOR killswitch with its own
        finer-grained switch (``RSTPU_HEDGE=0``): the overload bench
        A/Bs the layers independently."""
        return armor_enabled() and os.environ.get(
            "RSTPU_HEDGE", "1").strip().lower() not in ("0", "false",
                                                        "off", "no")

    def _hedge_delay_s(self, op: str, policy: ReadPolicy) -> float:
        """Backup-request delay: the streaming p95 of THIS op class's
        routed read latency (the ``router.read_ms`` log-bucket
        histogram — hedge only the slowest ~5%), floored so a cold or
        microsecond-fast histogram can't make hedging fire on every
        read. Floor via ``RSTPU_HEDGE_FLOOR_MS`` (default 5ms)."""
        try:
            floor_ms = float(
                os.environ.get("RSTPU_HEDGE_FLOOR_MS", "") or 5.0)
        except ValueError:
            floor_ms = 5.0
        p95 = self._stats.metric_percentile(
            tagged("router.read_ms", op=op, policy=policy.kind), 95)
        return max(floor_ms, p95 or 0.0) / 1e3

    def _spend_hedge_credit(self) -> bool:
        if self._hedge_credit < 1.0:
            return False
        self._hedge_credit -= 1.0
        return True

    async def _hedged_read(self, hosts: List[Host], op: str,
                           policy: ReadPolicy, args: dict,
                           timeout: float, what: str):
        """Tail-shaving backup request: if the primary failover chain
        hasn't answered within the p95-derived delay, fire the SAME
        bounded-staleness read down a rotated chain starting at the
        next replica and surface the first SUCCESS (reads are
        idempotent by construction — both arms may execute fully). The
        loser is cancelled, which rides RpcClient's cancellation path
        into a best-effort wire ``cancel`` frame; a late answer is
        discarded by the client's pending-future pop."""
        try:
            pct = float(os.environ.get("RSTPU_HEDGE_PCT", "") or 0.05)
        except ValueError:
            pct = 0.05
        self._hedge_credit = min(self._hedge_credit_cap,
                                 self._hedge_credit + pct)
        primary = asyncio.ensure_future(self._failover_call(
            hosts, "read", args, _READ_BOUNCE_CODES, timeout,
            retry_timeouts=True, count_bounces=True, what=what))
        primary.add_done_callback(_retrieve_exception)
        done, _pending = await asyncio.wait(
            {primary}, timeout=self._hedge_delay_s(op, policy))
        if done:
            # rstpu-check: allow(loop-blocking) primary is in `done` from asyncio.wait — result() on a finished task returns immediately
            return primary.result()
        if not self._spend_hedge_credit():
            # over the extra-read budget: degrade to the plain chain
            self._stats.incr(tagged("router.hedge_budget_denied", op=op))
            return await primary
        try:
            await fp.async_hit("router.hedge.fire")
        except fp.FailpointError:
            # chaos seam: the hedge failed to launch — the primary arm
            # must still win on its own (hedging is an optimization,
            # never a correctness dependency)
            return await primary
        self._stats.incr(tagged("router.hedges", op=op))
        backup = asyncio.ensure_future(self._failover_call(
            hosts[1:] + hosts[:1], "read", args, _READ_BOUNCE_CODES,
            timeout, retry_timeouts=True, count_bounces=False,
            what=what + " (hedge)"))
        backup.add_done_callback(_retrieve_exception)
        arms = {primary, backup}
        last_err: Optional[BaseException] = None
        try:
            while arms:
                done, arms = await asyncio.wait(
                    arms, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    if t.cancelled():
                        continue
                    err = t.exception()
                    if err is None:
                        if t is backup:
                            self._stats.incr(
                                tagged("router.hedge_wins", op=op))
                        # rstpu-check: allow(loop-blocking) t is in `done` from asyncio.wait — result() on a finished task returns immediately
                        return t.result()
                    # an errored arm is not the verdict while the other
                    # is still running: remember it and keep waiting
                    last_err = err
            raise last_err if last_err is not None \
                else RpcConnectionError(f"{what}: no candidate answered")
        finally:
            for t in (primary, backup):
                if not t.done():
                    t.cancel()

    async def _failover_call(
        self,
        hosts: List[Host],
        method: str,
        args: dict,
        bounce_codes,
        timeout: float,
        retry_timeouts: bool,
        count_bounces: bool,
        what: str,
    ):
        """The one sequential try-candidates loop behind routed
        reads/writes: bounce on the caller's application-error codes,
        skip dead hosts, remember the last error. Timeouts retry only
        when the caller says the call is idempotent (reads yes, writes
        no — a timed-out write may have committed)."""
        last_err: Optional[Exception] = None
        for host in hosts:
            ip, port = host.repl_addr
            try:
                return await self._pool.call(
                    ip, port, method, args, timeout=timeout)
            except RpcApplicationError as e:
                if e.code not in bounce_codes:
                    raise
                if count_bounces:
                    self._stats.incr(
                        tagged("router.read_bounces", code=e.code.lower()))
                last_err = e
            except RpcTimeout as e:
                if not retry_timeouts:
                    raise
                last_err = e
            except RpcConnectionError as e:
                last_err = e
        raise last_err if last_err is not None else RpcConnectionError(
            f"{what}: no candidate answered")

    @staticmethod
    def _db_name(segment: str, shard: int) -> str:
        from ..utils.segment_utils import segment_to_db_name

        return segment_to_db_name(segment, shard)

    async def hedged_call(
        self,
        segment: str,
        shard: int,
        method: str,
        args: Optional[dict] = None,
        role: Role = Role.ANY,
        backup_delay_sec: float = 0.05,
        timeout: float = 30.0,
    ):
        """Hedged request (reference: future_util speculative futures at the
        router level): fire at the best replica; if it hasn't answered
        within ``backup_delay_sec``, also fire at the next replica and take
        the first success."""
        from ..utils.future_util import speculate

        hosts = self.get_hosts_for(segment, shard, role, Quantity.TWO)
        if not hosts:
            raise RpcConnectionError(f"no hosts for {segment}:{shard}")
        if len(hosts) == 1:
            return await self._pool.call(
                hosts[0].ip, hosts[0].port, method, args, timeout=timeout
            )

        def make(host: Host):
            async def call():
                return await self._pool.call(
                    host.ip, host.port, method, args, timeout=timeout
                )

            return call

        return await speculate(make(hosts[0]), make(hosts[1]), backup_delay_sec)

    @property
    def pool(self) -> RpcClientPool:
        return self._pool
