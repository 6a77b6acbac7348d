"""Participant: joins the cluster and drives state transitions.
(The port's copy of ``rocksplicator_tpu/cluster/participant.py``.)

Reference: Participant.java:67-512 — started in the embedded JVM by
``common::JoinCluster`` (helix_client.cpp:216-227); registers the state
-model factory by type, executes controller-issued transitions against the
local Admin service, reports current states. Rebuilt natively: the
participant is a plain object the service process constructs — no JVM.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ..testing import failpoints as fp
from ..utils.stats import Stats
from .coordinator import CoordinatorClient
from .helix_utils import AdminClient
from .model import (
    DROPPED,
    ERROR,
    InstanceInfo,
    OFFLINE,
    cluster_path,
    decode_assignments,
    encode_states,
)
from .state_models import FACTORIES
from .state_models.base import ClusterContext, TransitionError

log = logging.getLogger(__name__)


class Participant:
    def __init__(
        self,
        coord_host: str,
        coord_port: int,
        cluster: str,
        instance: InstanceInfo,
        state_model: str = "LeaderFollower",
        backup_store_uri: Optional[str] = None,
        transition_workers: int = 4,
        catch_up_timeout: float = 30.0,
        error_retry_backoff: float = 1.0,
        view_cluster: Optional[str] = None,
        coord_fallbacks: Optional[List[Tuple[str, int]]] = None,
        promotion_seq_slack: Optional[int] = None,
    ):
        self.error_retry_backoff = error_retry_backoff
        self.cluster = cluster
        self.instance = instance
        self.coord = CoordinatorClient(coord_host, coord_port,
                                       fallbacks=coord_fallbacks)
        self.admin = AdminClient()
        self.ctx = ClusterContext(
            self.coord, self.admin, cluster, instance,
            backup_store_uri=backup_store_uri,
            catch_up_timeout=catch_up_timeout,
            view_cluster=view_cluster,
            promotion_seq_slack=promotion_seq_slack,
        )
        factory_cls = FACTORIES[state_model]
        self.factory = factory_cls(self.ctx)
        self._current: Dict[str, str] = {}
        self._applied_upstream: Dict[str, str] = {}
        self._applied_epoch: Dict[str, int] = {}
        # set when a rejoin attempt failed mid-way: the periodic seq
        # loop retries it (heartbeats succeed on the fresh session, so
        # NO_SESSION never fires again to re-trigger the callback)
        self._rejoin_pending = False
        self._state_lock = threading.Lock()
        self._publish_lock = threading.Lock()
        self._executor = ThreadPoolExecutor(
            max_workers=transition_workers, thread_name_prefix="transition"
        )
        self._inflight: Dict[str, bool] = {}
        self._path = lambda *p: cluster_path(cluster, *p)
        self._stopped = False
        # register (ephemeral) + publish empty current state + watch
        self.coord.ensure(self._path("instances"))
        self.coord.create(
            self._path("instances", instance.instance_id),
            instance.encode(), ephemeral=True,
        )
        self.coord.put(
            self._path("currentstates", instance.instance_id),
            encode_states({}),
        )
        # session-expiry recovery (the ZK session-re-establishment
        # analog): a reaped participant re-registers its ephemeral
        # instance node, republishes current state, and re-evaluates
        # assignments — serving resumes WITHOUT a process restart
        self.coord.on_session_reestablished = self._rejoin
        self._watch_stop = self.coord.watch(
            self._path("assignments", instance.instance_id),
            self._on_assignments,
        )
        # PartitionStateUpdater (reference utils/PartitionStateUpdater.java):
        # periodically checkpoint led partitions' seqs so the 3-node-failure
        # guard compares against fresh numbers, not just promotion-time ones.
        self._seq_updater = threading.Thread(
            target=self._partition_seq_loop, name="partition-seq-updater",
            daemon=True,
        )
        self._seq_updater.start()

    def _partition_seq_loop(self, interval: float = 5.0) -> None:
        from ..utils.segment_utils import partition_name_to_db_name

        while not self._stopped:
            time.sleep(interval)
            if self._rejoin_pending and not self._stopped:
                self._rejoin()
            try:
                for partition, state in self.current_states.items():
                    db_name = partition_name_to_db_name(partition)
                    if state in ("LEADER", "MASTER") \
                            and self._leads_in_ledger(partition):
                        seq = self.admin.get_sequence_number(
                            self.ctx.local_admin_addr, db_name)
                        if seq is not None:
                            self.ctx.set_partition_seq(partition, seq)
                    elif state in ("FOLLOWER", "SLAVE"):
                        self._heal_pull_stall(partition, db_name)
            except Exception:
                if not self._stopped:
                    log.exception("partition seq updater failed")

    def _leads_in_ledger(self, partition: str) -> bool:
        """Whether the fencing-epoch ledger names this node the leader of
        ``partition`` (True where it names no one). A leader deposed
        while its session lapsed still claims LEADER here and may take
        writes no follower acks; checkpointing its seq would hold the
        lineage's replicas below the 3-node-failure guard (the port's
        repair; the reference checkpoints every claimer's seq)."""
        _epoch, leader = self.ctx.epoch_ledger(partition)
        return leader in (None, self.instance.instance_id)

    def _heal_pull_stall(self, partition: str, db_name: str) -> None:
        """Self-heal a steady follower whose pull loop can NEVER
        converge (it gets no state transition on its own — both states
        were found wedged by the reshard chaos harness):

        - ``pull_stalled_wal_gap``: the upstream purged its WAL past
          our position. Force the ERROR→replan path: the
          Offline→Follower transition re-runs with the needRebuildDB
          WAL-availability check and rebuilds from a peer snapshot
          (local data kept until the rebuild lands).
        - ``pull_diverged``: we are persistently AHEAD of the leader's
          commit point — a deposed-leader window write poisoned our
          suffix. Clear + rejoin through OFFLINE (the follower analog
          of the deposed-leader resync; the lineage's copies live
          on the leader and its other followers).

        Discipline: the COMMON path (no stall) probes WITHOUT touching
        the partition's inflight slot — claiming it even briefly races
        assignment delivery (an update arriving while claimed is
        skipped by _on_assignments and, since the controller never
        rewrites identical assignments, would be lost for good — the
        exact lost-update class _run_transition's finally re-evaluation
        exists for). Only a CONFIRMED stall claims the slot, re-probes
        under it (the destructive clear must not race a transition that
        just promoted this node), acts, releases, and then ALWAYS
        re-evaluates assignments to recover any update that arrived
        while claimed. The probe is the flags-only check_pull_stall
        RPC (no disk I/O), cheap enough per follower shard per tick."""
        info = self.admin.check_pull_stall(
            self.ctx.local_admin_addr, db_name)
        if not info or not (info.get("pull_diverged")
                            or info.get("pull_stalled_wal_gap")):
            return
        with self._state_lock:
            if self._inflight.get(partition):
                return
            if self._current.get(partition) not in ("FOLLOWER", "SLAVE"):
                return
            self._inflight[partition] = True
        try:
            # re-probe under the claim: the stall (and this node's
            # follower role) must still hold with transitions excluded
            info = self.admin.check_pull_stall(
                self.ctx.local_admin_addr, db_name)
            if not info or info.get("role") not in ("FOLLOWER",
                                                    "OBSERVER"):
                return
            if info.get("pull_diverged"):
                log.warning(
                    "%s: follower DIVERGED from the lineage (applied "
                    "ahead of the leader's commit point) — clearing "
                    "and rejoining", partition)
                Stats.get().incr("participant.diverged_resyncs")
                try:
                    self.admin.clear_db(self.ctx.local_admin_addr,
                                        db_name, reopen=False)
                except Exception:
                    log.exception("%s: diverged-resync clear failed "
                                  "(will retry)", partition)
                    return
                self._set_current(partition, OFFLINE)
            elif info.get("pull_stalled_wal_gap"):
                log.warning(
                    "%s: follower stalled on a WAL gap (upstream "
                    "purged past our position) — forcing snapshot "
                    "rebuild via ERROR replan", partition)
                Stats.get().incr("participant.wal_gap_rebuilds")
                self._set_current(partition, ERROR)
        finally:
            with self._state_lock:
                self._inflight.pop(partition, None)
            # recover any assignment update delivered while claimed
            try:
                raw = self.coord.get_or_none(
                    self._path("assignments",
                               self.instance.instance_id))
                if raw is not None:
                    self._on_assignments({"value": raw})
            except Exception:
                log.exception("%s: post-heal re-evaluation failed",
                              partition)

    # ------------------------------------------------------------------

    def _on_assignments(self, snap: dict) -> None:
        if self._stopped:
            return
        targets = decode_assignments(bytes(snap.get("value") or b""))
        for partition, target in targets.items():
            # epochs flow to the state models through the context; noted
            # BEFORE any transition below reads them
            self.ctx.note_partition_epoch(partition, target.epoch)
        with self._state_lock:
            partitions = set(targets) | set(self._current)
            for partition in partitions:
                target = targets.get(partition)
                target_state = target.state if target else DROPPED
                cur = self._current.get(partition, OFFLINE)
                if self._inflight.get(partition):
                    continue
                if cur == ERROR and target is None:
                    continue  # nothing to recover toward
                if cur == target_state:
                    # State already right — but the upstream may have moved
                    # (leader handoff): repoint without a state transition
                    # (reference "repoint all others",
                    # LeaderFollowerStateModelFactory.java promote step).
                    if (
                        target is not None
                        and target.upstream
                        and self._applied_upstream.get(partition)
                        != target.upstream
                        and target_state in ("FOLLOWER", "SLAVE")
                    ):
                        self._inflight[partition] = True
                        self._executor.submit(
                            self._run_repoint, partition, target_state,
                            target.upstream, target.epoch,
                        )
                    elif (
                        target is not None
                        and target_state in ("LEADER", "MASTER",
                                             "FOLLOWER", "SLAVE")
                        and target.epoch
                        > self._applied_epoch.get(partition, 0)
                    ):
                        # state AND upstream already right but the epoch
                        # moved (sticky leader across a ledger re-mint, or
                        # a follower whose upstream survived a chained
                        # handoff): adopt in place — followers carrying
                        # the new epoch would otherwise fence this node
                        self._inflight[partition] = True
                        self._executor.submit(
                            self._run_adopt_epoch, partition, target.epoch
                        )
                    continue
                self._inflight[partition] = True
                self._executor.submit(
                    self._run_transition, partition, cur, target_state
                )

    def _run_transition(self, partition: str, from_state: str,
                        to_state: str) -> None:
        epoch = self.ctx.partition_epoch(partition)
        try:
            # the control-plane seam where a transition touches durable
            # state: a trip lands in the ERROR + paced-retry path below,
            # exactly like a real failed transition
            fp.hit("participant.transition")
            model = self.factory.get(partition)
            # ERROR recovers via OFFLINE (Helix resets ERROR->OFFLINE)
            plan_from = OFFLINE if from_state == ERROR else from_state
            try:
                steps = model.plan(plan_from, to_state)
            except TransitionError:
                steps = None
            if steps is None:
                log.error("%s: no path %s->%s", partition, from_state, to_state)
                self._set_current(partition, ERROR)
                time.sleep(self.error_retry_backoff)
                return
            state = plan_from
            for a, b in steps:
                log.info("%s: %s: %s -> %s", self.instance.instance_id,
                         partition, a, b)
                model.transition(a, b)
                state = b
                self._set_current(partition, state)
            with self._state_lock:
                # the epoch captured BEFORE the transition ran: a bump
                # landing mid-flight stays > applied, so the re-evaluation
                # below schedules the adoption
                if epoch > self._applied_epoch.get(partition, 0):
                    self._applied_epoch[partition] = epoch
        except Exception:
            log.exception("%s: transition %s->%s failed", partition,
                          from_state, to_state)
            self._set_current(partition, ERROR)
            # paced retry, not a hot loop: the finally-block re-evaluation
            # will plan again from OFFLINE after the backoff
            time.sleep(self.error_retry_backoff)
        finally:
            with self._state_lock:
                self._inflight.pop(partition, None)
            # re-evaluate: the target may have moved meanwhile. Guarded:
            # an exception escaping here dies silently in the executor
            # future and the missed update would never be re-applied.
            if not self._stopped:
                try:
                    raw = self.coord.get_or_none(
                        self._path("assignments", self.instance.instance_id)
                    )
                    if raw is not None:
                        self._on_assignments({"value": raw})
                except Exception:
                    log.exception(
                        "%s: post-transition re-evaluation failed", partition)

    def _run_repoint(self, partition: str, state: str, upstream: str,
                     epoch: int = 0) -> None:
        from ..utils.segment_utils import partition_name_to_db_name

        try:
            host, _, port = upstream.partition(":")
            db_name = partition_name_to_db_name(partition)
            log.info("%s: repointing upstream -> %s (epoch %d)",
                     partition, upstream, epoch)
            self.ctx.admin.change_db_role_and_upstream(
                self.ctx.local_admin_addr, db_name, state, (host, int(port)),
                epoch=epoch,
            )
            with self._state_lock:
                self._applied_upstream[partition] = upstream
                if epoch > self._applied_epoch.get(partition, 0):
                    self._applied_epoch[partition] = epoch
        except Exception:
            log.exception("%s: repoint failed", partition)
            # paced like _run_transition: the finally-block re-evaluation
            # below would otherwise resubmit a fast-failing repoint in a
            # tight submit/fail loop
            time.sleep(self.error_retry_backoff)
        finally:
            with self._state_lock:
                self._inflight.pop(partition, None)
            # Re-evaluate like _run_transition does: an assignment update
            # that arrived while this repoint was in flight was skipped by
            # _on_assignments (inflight guard) — without this re-check a
            # final controller write landing in that window would never be
            # applied (observed: soak failover followers stuck on a stale
            # upstream, replicas_converged=false). Guarded: an exception
            # escaping here dies silently in the executor future.
            if not self._stopped:
                try:
                    raw = self.coord.get_or_none(
                        self._path("assignments", self.instance.instance_id)
                    )
                    if raw is not None:
                        self._on_assignments({"value": raw})
                except Exception:
                    log.exception(
                        "%s: post-repoint re-evaluation failed", partition)

    def _run_adopt_epoch(self, partition: str, epoch: int) -> None:
        """In-place fencing-epoch adoption: state and upstream already
        match the assignment, only the epoch moved. No reopen — the
        ReplicatedDB just raises its epoch (monotonic)."""
        from ..utils.segment_utils import partition_name_to_db_name

        try:
            self.ctx.admin.set_db_epoch(
                self.ctx.local_admin_addr,
                partition_name_to_db_name(partition), epoch,
            )
            if self.current_states.get(partition) in ("LEADER", "MASTER"):
                self._reanoint_if_fenced(partition, epoch)
            with self._state_lock:
                if epoch > self._applied_epoch.get(partition, 0):
                    self._applied_epoch[partition] = epoch
        except Exception:
            log.exception("%s: epoch adoption failed", partition)
            time.sleep(self.error_retry_backoff)
        finally:
            with self._state_lock:
                self._inflight.pop(partition, None)
            if not self._stopped:
                try:
                    raw = self.coord.get_or_none(
                        self._path("assignments", self.instance.instance_id)
                    )
                    if raw is not None:
                        self._on_assignments({"value": raw})
                except Exception:
                    log.exception(
                        "%s: post-adopt re-evaluation failed", partition)

    def _reanoint_if_fenced(self, partition: str, epoch: int) -> None:
        """A sticky leader whose followers carried ``epoch`` to it before
        it adopted it is fenced at its own epoch, which the adoption
        cannot clear: re-promote it through the state model (the port's
        repair; the reference stays fenced, with no serving leader)."""
        reanoint = getattr(self.factory.get(partition), "reanoint_fenced",
                           None)
        if reanoint is None:
            return
        try:
            if not reanoint(epoch):
                return
        except Exception:
            # the data plane may have left its leader role mid-way: ERROR,
            # so the controller replans it through OFFLINE like any failed
            # promotion
            self._set_current(partition, ERROR)
            raise
        Stats.get().incr("participant.fenced_reanointments")
        log.warning("%s: fenced at its own epoch %d — re-promoted",
                    partition, epoch)

    def _rejoin(self) -> None:
        """Called by the coordinator client after it re-established an
        expired session: the old session's ephemerals (our instance
        registration) were reaped — re-register, republish current
        state, and re-evaluate assignments so serving resumes without a
        restart (reference: ZK session re-establishment → Helix
        re-registers the live-instance znode)."""
        if self._stopped:
            return
        self._rejoin_pending = False
        try:
            self.coord.ensure(self._path("instances"))
            path = self._path("instances", self.instance.instance_id)
            try:
                self.coord.create(path, self.instance.encode(),
                                  ephemeral=True)
            except Exception:
                # a stale node from the dead session the reaper hasn't
                # collected yet — replace it under OUR session
                self.coord.delete_if_exists(path)
                self.coord.create(path, self.instance.encode(),
                                  ephemeral=True)
            with self._publish_lock:
                with self._state_lock:
                    snapshot = dict(self._current)
                self.coord.put(
                    self._path("currentstates", self.instance.instance_id),
                    encode_states(snapshot),
                )
            Stats.get().incr("participant.rejoins")
            log.warning(
                "%s: session expired — re-registered and resumed",
                self.instance.instance_id)
            raw = self.coord.get_or_none(
                self._path("assignments", self.instance.instance_id))
            if raw is not None:
                self._on_assignments({"value": raw})
        except Exception:
            # a transient failure here (e.g. the coordinator itself
            # failing over) must not strand the node unregistered
            # forever: the periodic seq loop retries
            self._rejoin_pending = True
            log.exception("%s: rejoin after session expiry failed "
                          "(will retry)", self.instance.instance_id)

    def _set_current(self, partition: str, state: str) -> None:
        # _publish_lock serializes snapshot+put as one unit so concurrent
        # transition threads cannot publish snapshots out of order (an older
        # snapshot overwriting a newer one would hide partitions from the
        # spectator until the next unrelated update).
        with self._publish_lock:
            with self._state_lock:
                if state == DROPPED:
                    self._current.pop(partition, None)
                else:
                    self._current[partition] = state
                snapshot = dict(self._current)
            self.coord.put(
                self._path("currentstates", self.instance.instance_id),
                encode_states(snapshot),
            )

    @property
    def current_states(self) -> Dict[str, str]:
        with self._state_lock:
            return dict(self._current)

    def make_leader_resolver(self):
        """db_name -> (host, repl_port) of the partition's current leader,
        from the coordinator's external view. Wire into the AdminHandler
        (set_leader_resolver) so a steady follower whose leader died can
        repoint itself from the pull loop's forced-reset path even if the
        controller's assignment write raced its inflight repoint —
        the data-plane half of the reference's GetLeaderInstanceId
        (replicated_db.cpp:278-312)."""
        from ..utils.segment_utils import db_name_to_partition_name

        def resolve(db_name: str) -> Optional[Tuple[str, int]]:
            try:
                partition = db_name_to_partition_name(db_name)
                view = self.ctx.external_view(partition)
                instances = self.ctx.live_instances()
                for iid, state in view.items():
                    if state not in ("LEADER", "MASTER"):
                        continue
                    if iid == self.instance.instance_id:
                        continue
                    info = instances.get(iid)
                    if info is not None:
                        return (info.host, info.repl_port)
            except Exception:
                log.exception("leader resolver failed for %s", db_name)
            return None

        return resolve

    def stop(self) -> None:
        """shutDownParticipant (Participant.java) — drop membership."""
        self._stopped = True
        self._watch_stop.set()
        self._executor.shutdown(wait=True)
        try:
            self.coord.delete_if_exists(
                self._path("instances", self.instance.instance_id)
            )
        except Exception:
            pass
        self.coord.close()
        self.admin.close()
