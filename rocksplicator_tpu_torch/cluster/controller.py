"""Controller: leader-elected assignment computation.
(The port's copy of ``rocksplicator_tpu/cluster/controller.py``.)

Reference: the Helix controller (external to the reference repo but the
brain of its control plane). Responsibilities reproduced:
- watch live instances / resources / current states;
- compute stable partition placement (rendezvous hashing keeps most
  placements unchanged when membership changes);
- leader handoff in two phases (demote-then-promote) so participants'
  no-live-leader guard holds;
- write per-instance assignments the participants converge on;
- reconcile periodically to self-heal.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..testing import failpoints as fp
from ..utils.segment_utils import segment_to_db_name, db_name_to_partition_name
from .coordinator import CoordinatorClient
from .model import (
    ERROR,
    FOLLOWER,
    LEADER,
    InstanceInfo,
    PartitionAssignment,
    PlacementPin,
    ResourceDef,
    SplitRecord,
    cluster_path,
    decode_states,
    encode_assignments,
)

log = logging.getLogger(__name__)

_LEADERLIKE = {"LEADER", "MASTER"}
_FOLLOWERLIKE = {"FOLLOWER", "SLAVE"}
# seconds a leader this controller minted keeps the target while no
# replica claims the partition: its promotion may be in flight (ROADMAP
# F23). Past it, the pass re-targets the best-ranked serving replica, and
# the late promotion, if it comes, finds another leader in the epoch
# ledger and refuses.
PROMOTION_GRACE = 10.0


def _rendezvous(partition: str, instance_id: str) -> int:
    h = hashlib.blake2b(
        f"{partition}|{instance_id}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big")


def _state_names(state_model: str) -> Tuple[str, str]:
    if state_model == "MasterSlave":
        return "MASTER", "SLAVE"
    if state_model in ("OnlineOffline", "Cache", "Bootstrap"):
        return "ONLINE", "ONLINE"
    if state_model == "CdcLeaderStandby":
        return "LEADER", "STANDBY"
    return LEADER, FOLLOWER


def effective_shards(resource: ResourceDef,
                     splits: Optional[List[SplitRecord]] = None
                     ) -> List[int]:
    """The shard ids this resource actually SERVES: the hash range
    ``range(num_shards)`` with every ACTIVE-split parent replaced —
    transitively, since children can split again — by its range
    children. The hash map is untouched by splits (keys still hash to
    the parent slot; routers chase the split records by range), so this
    is purely the controller's enumeration of which partitions need
    replicas and leaders."""
    by_parent = {r.parent_shard: r for r in (splits or [])
                 if r.segment == resource.segment and r.phase == "active"}
    out: List[int] = []
    for s in range(resource.num_shards):
        frontier = [s]
        while frontier:
            cur = frontier.pop()
            rec = by_parent.get(cur)
            if rec is None:
                out.append(cur)
            else:
                frontier.extend((rec.low_shard, rec.high_shard))
    return sorted(out)


def assign_resource(
    resource: ResourceDef,
    instances: Dict[str, InstanceInfo],
    current: Dict[str, Dict[str, str]],
    per_instance: Dict[str, Dict[str, PartitionAssignment]],
    epochs: Dict[str, Dict],
    pins: Optional[Dict[str, PlacementPin]] = None,
    splits: Optional[List[SplitRecord]] = None,
    promoting: Optional[Set[str]] = None,
) -> Set[str]:
    """Compute one resource's target assignments (pure — no coordinator
    I/O, so the two-phase handoff edges are directly unit-testable).

    ``epochs`` is the fencing-epoch ledger: partition -> {"epoch": int,
    "leader": iid}. An epoch bumps EXACTLY when a promotion is issued to
    a different leader than the ledger records — i.e. at the moment a
    new leader may start acking — never during the demote phase of a
    two-phase handoff (the old leader is still the only legitimate
    acker until it reports non-leader). Mutated in place; returns the
    set of partitions whose ledger record changed (the caller persists
    those BEFORE publishing the stamped assignments).

    ``pins`` (live shard moves) overrides rendezvous placement
    per partition: a pinned partition's replica set is the pin's live
    instances verbatim, and a live ``preferred_leader`` steers the
    two-phase handoff toward it — the flip a shard move requests rides
    the SAME demote → no-live-leader → epoch-mint → promote machinery as
    a failover, so a pinned cutover is epoch-stamped end to end. A pin
    whose instances are all dead is ignored (a pin can never un-serve a
    partition).

    ``splits`` (hot-shard range splits) swaps ACTIVE-split
    parents out of the enumeration for their range children
    (:func:`effective_shards`): the parent gets NO assignment — its
    stale replicas retire through Offline→Dropped exactly like a
    removed resource's — while each child is assigned like any
    partition. The split cutover pre-seeded the children's epoch ledger
    and pins, so the first child pass finds a recorded leader matching
    the pinned preferred leader and mints nothing.

    ``promoting`` holds the partitions whose ledger leader was minted
    less than ``PROMOTION_GRACE`` ago: while no replica claims such a
    partition, its ledger leader stays the target if placed and not in
    ERROR, as its promotion may be in flight (ROADMAP F23). None is the
    reference's rule."""
    leader_state, follower_state = _state_names(resource.state_model)
    changed: Set[str] = set()
    iids = sorted(instances)
    if not iids:
        return changed
    for shard in effective_shards(resource, splits):
        partition = db_name_to_partition_name(
            segment_to_db_name(resource.segment, shard)
        )
        pin = (pins or {}).get(partition)
        pinned_live = (
            [iid for iid in pin.replicas if iid in instances]
            if pin is not None else []
        )
        ranked = sorted(
            iids, key=lambda iid: _rendezvous(partition, iid),
            reverse=True,
        )
        if pinned_live:
            # pinned placement, TOPPED UP from the rendezvous ranking
            # when pinned replicas died: a moved partition must keep
            # self-healing to full replication like an unpinned one (a
            # frozen pin would serve under-replicated forever after one
            # permanent failure)
            replicas = pinned_live + [
                iid for iid in ranked if iid not in pinned_live
            ][: max(0, resource.replicas - len(pinned_live))]
        else:
            replicas = ranked[: resource.replicas]
        preferred = (
            pin.preferred_leader
            if pinned_live and pin.preferred_leader in pinned_live
            else None
        )
        if not replicas:
            continue
        # who currently leads? A node that rejoins after being deposed
        # still CLAIMS leaderlike in its (persistent) current state until
        # it demotes — with two live claimers the epoch ledger's recorded
        # leader is the truth, and trusting the stale claim instead would
        # flap leadership straight back to the deposed node (observed in
        # the failover chaos harness before this guard existed).
        claimers = [
            iid for iid in iids
            if current.get(iid, {}).get(partition) in _LEADERLIKE
        ]
        recorded_leader = (epochs.get(partition) or {}).get("leader")
        if not claimers:
            live_leader = None
        elif recorded_leader in claimers:
            live_leader = recorded_leader
        else:
            live_leader = claimers[0]
        # target leader: a pinned preferred leader wins (the move's
        # flip request — two-phase rules below still gate the actual
        # promotion); else sticky to the live leader if still placed;
        # else the best-ranked replica that's already serving; else rank-0
        if preferred is not None:
            target_leader = preferred
        elif live_leader in replicas:
            target_leader = live_leader
        elif (live_leader is None and partition in (promoting or ())
              and recorded_leader in replicas
              and current.get(recorded_leader, {}).get(partition)
              != ERROR):
            # the ledger's leader was minted within the grace, is placed
            # and has not failed, so its promotion may still be in
            # flight: minting another leader now flaps leadership
            # (ROADMAP F23; the port's repair, the reference re-targets
            # the best-ranked serving replica). A failed promotion
            # reports ERROR, and the next pass moves on.
            target_leader = recorded_leader
        else:
            serving = [
                iid for iid in replicas
                if current.get(iid, {}).get(partition) in
                (_FOLLOWERLIKE | _LEADERLIKE)
            ]
            target_leader = serving[0] if serving else replicas[0]
        # two-phase handoff: demote first, promote when no live leader
        promote_ok = live_leader is None or live_leader == target_leader
        rec = epochs.setdefault(partition, {"epoch": 0, "leader": None})
        if promote_ok and rec.get("leader") != target_leader:
            # leadership is moving NOW: mint the new leader's epoch so
            # every assignment written this pass already carries it
            rec["epoch"] = int(rec.get("epoch", 0)) + 1
            rec["leader"] = target_leader
            changed.add(partition)
        epoch = int(rec.get("epoch", 0))
        # followers need the upstream (the acting leader while handoff
        # is in flight, else the target leader)
        upstream_iid = live_leader or target_leader
        upstream_info = instances.get(upstream_iid)
        upstream = (
            f"{upstream_info.host}:{upstream_info.repl_port}"
            if upstream_info else None
        )
        for iid in replicas:
            if iid == target_leader and promote_ok:
                state: str = leader_state
                up = None
            else:
                # includes a demote-in-flight target leader: it stays a
                # follower of the acting leader until promote_ok
                state = follower_state
                up = upstream if upstream_iid != iid else None
            per_instance[iid][partition] = PartitionAssignment(
                state, up, epoch)
    return changed


def in_grace(minted: Dict[str, Tuple[int, float]],
             epochs: Dict[str, Dict], now: float) -> Set[str]:
    """The partitions whose ledger record is still the one minted (epoch,
    time) in ``minted`` less than ``PROMOTION_GRACE`` before ``now``;
    drops every other entry of ``minted``."""
    out: Set[str] = set()
    for partition, (epoch, at) in list(minted.items()):
        rec = epochs.get(partition) or {}
        if now - at < PROMOTION_GRACE and int(rec.get("epoch", 0)) == epoch:
            out.add(partition)
        else:
            del minted[partition]
    return out


class Controller:
    def __init__(
        self,
        coord_host: str,
        coord_port: int,
        cluster: str,
        controller_id: str,
        reconcile_interval: float = 2.0,
        coord_fallbacks: Optional[List[Tuple[str, int]]] = None,
    ):
        self.cluster = cluster
        self.controller_id = controller_id
        self.coord = CoordinatorClient(coord_host, coord_port,
                                       fallbacks=coord_fallbacks)
        self._path = lambda *p: cluster_path(cluster, *p)
        self._interval = reconcile_interval
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._is_leader = False
        # reconcile passes completed while leader — the chaos harness's
        # "shard-map convergence within a bounded number of controller
        # passes" invariant reads this
        self.passes = 0
        # partition -> (epoch, monotonic time) of the ledger records this
        # controller minted, for ``promoting``
        self._minted: Dict[str, Tuple[int, float]] = {}
        self._thread = threading.Thread(
            target=self._run, name=f"controller-{controller_id}", daemon=True
        )
        self._thread.start()
        # wake on membership / state / resource changes
        self._watches = [
            self.coord.watch(self._path("instances"), self._on_change),
            self.coord.watch(self._path("currentstates"), self._on_change),
            self.coord.watch(self._path("resources"), self._on_change),
            # a shard move's pin write must wake the reconcile loop
            # immediately — the cutover window is the interval between
            # the pin landing and the flip completing
            self.coord.watch(self._path("placements"), self._on_change),
            # a split's activation re-enumerates the segment's shards:
            # the children need assignments (and the parent needs to
            # retire) on the next pass, not an interval later
            self.coord.watch(self._path("splits"), self._on_change),
        ]

    def _on_change(self, _snap) -> None:
        self._kick.set()

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    # ------------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                # Re-validate leadership EVERY pass: a session expiry hands
                # leadership to a peer, and a stale latched flag would leave
                # two controllers writing conflicting assignments.
                current = self.coord.current_leader(self._path("controller"))
                if current is None:
                    self.coord.elect_leader(
                        self._path("controller"), self.controller_id
                    )
                    current = self.coord.current_leader(
                        self._path("controller")
                    )
                self._is_leader = current == self.controller_id
                if self._is_leader:
                    self.reconcile()
            except Exception:
                log.exception("controller loop error")
            self._kick.wait(self._interval)
            self._kick.clear()

    # ------------------------------------------------------------------

    def reconcile(self) -> None:
        """One pass: recompute and publish assignments for every resource.

        Ordering matters for fencing: epoch-ledger records changed by
        this pass are persisted BEFORE the stamped assignments are
        published — a controller crash between the two steps leaves a
        minted-but-unpublished epoch, which the next pass (any
        controller) re-reads and re-publishes without a double bump."""
        instances = self._live_instances()
        current = self._current_states()
        epochs = self._load_epochs()
        pins = self._load_pins()
        splits = self._load_splits()
        per_instance: Dict[str, Dict[str, PartitionAssignment]] = {
            iid: {} for iid in instances
        }
        changed: Set[str] = set()
        promoting = in_grace(self._minted, epochs, time.monotonic())
        for seg in self.coord.list(self._path("resources")):
            raw = self.coord.get_or_none(self._path("resources", seg))
            if raw is None:
                continue
            resource = ResourceDef.decode(raw)
            changed |= assign_resource(
                resource, instances, current, per_instance, epochs,
                pins=pins, splits=splits, promoting=promoting)
        for partition in sorted(changed):
            mine = epochs[partition]
            merged = self._persist_epoch(partition, mine)
            if merged is None:
                # our record landed
                self._minted[partition] = (int(mine["epoch"]),
                                           time.monotonic())
                continue
            # A peer controller outran us on the ledger. If it minted the
            # SAME record we did, the race was harmless — publish. If it
            # recorded a DIFFERENT leader (or a further epoch), publishing
            # our assignments would promote a second leader under (or
            # hand the winning fencing token to) the wrong node — the
            # split brain the ledger exists to prevent. Abort the pass;
            # the next one recomputes from the merged record, and the
            # recorded-leader preference converges both controllers.
            if (int(merged.get("epoch", 0)) == int(mine["epoch"])
                    and merged.get("leader") == mine.get("leader")):
                continue
            log.warning(
                "epoch ledger conflict on %s: ours %s vs persisted %s — "
                "deferring this reconcile pass", partition, mine, merged)
            return
        for iid, assignments in per_instance.items():
            path = self._path("assignments", iid)
            encoded = encode_assignments(assignments)
            existing = self.coord.get_or_none(path)
            if existing != encoded:
                # the control plane touching durable state: a tripped
                # fault aborts this pass mid-publish — the next pass
                # must converge from the partial write
                fp.hit("controller.assign")
                self.coord.put(path, encoded)
        self.passes += 1

    # -- fencing-epoch ledger ---------------------------------------------

    def _load_pins(self) -> Dict[str, PlacementPin]:
        """Placement pins written by live shard moves — the rendezvous
        override assign_resource honors."""
        out: Dict[str, PlacementPin] = {}
        for p in self.coord.list(self._path("placements")):
            pin = PlacementPin.decode(
                self.coord.get_or_none(self._path("placements", p)))
            if pin is not None and pin.replicas:
                out[p] = pin
        return out

    def _load_splits(self) -> List[SplitRecord]:
        """ACTIVE shard-split records — the routing truth that swaps
        split parents for their range children in assignment."""
        out: List[SplitRecord] = []
        for p in self.coord.list(self._path("splits")):
            rec = SplitRecord.decode(
                self.coord.get_or_none(self._path("splits", p)))
            if rec is not None and rec.phase == "active":
                out.append(rec)
        return out

    def _load_epochs(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for p in self.coord.list(self._path("epochs")):
            raw = self.coord.get_or_none(self._path("epochs", p))
            if not raw:
                continue
            try:
                rec = json.loads(bytes(raw).decode())
            except (ValueError, UnicodeDecodeError):
                continue
            out[p] = {"epoch": int(rec.get("epoch", 0)),
                      "leader": rec.get("leader")}
        return out

    def _persist_epoch(self, partition: str,
                       rec: Dict) -> Optional[Dict]:
        """Version-CAS the ledger record in, max-merging against
        concurrent writers (a deposed-but-racing peer controller must
        never regress an epoch — last-write-wins here would undo the
        very fencing the ledger exists for). Returns the winning record
        when a peer's beats ours, None when OUR record landed; RAISES
        when the write could not land at all, so the caller never
        publishes assignments stamped with a minted-but-unpersisted
        epoch."""
        from ..rpc.errors import RpcApplicationError

        path = self._path("epochs", partition)
        payload = json.dumps(rec).encode()
        last_exc: Optional[Exception] = None
        for _ in range(4):
            try:
                try:
                    existing_raw, version = self.coord.get(path)
                except RpcApplicationError as e:
                    if e.code != "NO_NODE":
                        raise
                    existing_raw, version = None, None
                if existing_raw is not None:
                    try:
                        existing = json.loads(bytes(existing_raw).decode())
                    except (ValueError, UnicodeDecodeError):
                        existing = {"epoch": 0, "leader": None}
                    if int(existing.get("epoch", 0)) >= int(rec["epoch"]):
                        return {"epoch": int(existing.get("epoch", 0)),
                                "leader": existing.get("leader")}
                    self.coord.set(path, payload,
                                   expected_version=version)
                else:
                    self.coord.create(path, payload)
                return None
            except RpcApplicationError as e:
                if e.code in ("BAD_VERSION", "NODE_EXISTS", "NO_NODE"):
                    last_exc = e
                    continue  # lost the CAS race: re-read and max-merge
                last_exc = e
                time.sleep(0.05)
            except Exception as e:
                last_exc = e
                time.sleep(0.05)
        raise RuntimeError(
            f"epoch ledger write for {partition} failed: {last_exc!r}")

    # ------------------------------------------------------------------

    def _live_instances(self) -> Dict[str, InstanceInfo]:
        out = {}
        for iid in self.coord.list(self._path("instances")):
            raw = self.coord.get_or_none(self._path("instances", iid))
            if raw:
                out[iid] = InstanceInfo.decode(raw)
        return out

    def _current_states(self) -> Dict[str, Dict[str, str]]:
        out = {}
        for iid in self.coord.list(self._path("currentstates")):
            out[iid] = decode_states(
                self.coord.get_or_none(self._path("currentstates", iid))
            )
        return out

    # -- admin API -------------------------------------------------------

    def add_resource(self, resource: ResourceDef) -> None:
        self.coord.put(
            self._path("resources", resource.segment), resource.encode()
        )
        self._kick.set()

    def remove_resource(self, segment: str) -> None:
        self.coord.delete_if_exists(self._path("resources", segment))
        self._kick.set()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        for w in self._watches:
            w.set()
        self._thread.join(timeout=5.0)
        self.coord.close()
