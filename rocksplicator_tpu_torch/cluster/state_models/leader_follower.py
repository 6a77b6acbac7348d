"""LeaderFollower — the core orchestration state machine.
(The port's copy of ``rocksplicator_tpu/cluster/state_models/leader_follower.py``.)

Reference: LeaderFollowerStateModelFactory.java:51-96 (state diagram) and
per-transition algorithms:

- Offline→Follower (:434-568): per-partition lock → addDB FOLLOWER →
  needRebuildDB (WAL-age / seq-gap heuristic vs live replicas) → if stale,
  backup-from-peer + restore → catch-up loop → repoint to the true leader
  → apply resource configs from the coordinator.
- Follower→Leader (:230-303): lock → verify no live leader in the external
  view → find the replica with the highest seq; if someone is ahead, catch
  up via a temporary upstream → 3-node-failure guard vs the persisted last
  leader seq → promote self → checkpoint the leader seq.
- Leader→Follower, Follower→Offline, Offline→Dropped: demote / closeDB /
  clearDB.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

from ...rpc.errors import RpcApplicationError
from ...utils.segment_utils import (
    db_name_to_segment,
    partition_name_to_db_name,
)
from ..model import DROPPED, FOLLOWER, LEADER, OFFLINE
from .base import StateModel, StateModelFactory, TransitionError

log = logging.getLogger(__name__)

# if a replica is this many seqs behind the best peer, rebuild from a
# snapshot rather than WAL catch-up (needRebuildDB analog)
REBUILD_SEQ_GAP = 100_000
CATCH_UP_MARGIN = 10

# current-state values that mean "is the leader" — the MasterSlave subclass
# publishes MASTER, so every external-view comparison must accept both
LEADERLIKE = {"LEADER", "MASTER"}
# current-state values of a replica that holds the lineage's data: a
# promotion must read each live one's seq
SERVING = LEADERLIKE | {"FOLLOWER", "SLAVE"}


class LeaderFollowerStateModel(StateModel):
    edges = [
        (OFFLINE, FOLLOWER),
        (FOLLOWER, LEADER),
        (LEADER, FOLLOWER),
        (FOLLOWER, OFFLINE),
        (OFFLINE, DROPPED),
    ]

    # -- helpers -----------------------------------------------------------

    @property
    def db_name(self) -> str:
        return partition_name_to_db_name(self.partition)

    def _live_replicas(self) -> Dict[str, Tuple]:
        """instance_id -> (info, state, seq) for live hosts of my partition."""
        ctx = self.ctx
        out = {}
        view = ctx.external_view(self.partition)
        instances = ctx.live_instances()
        for iid, state in view.items():
            info = instances.get(iid)
            if info is None:
                continue
            seq = ctx.admin.get_sequence_number(
                (info.host, info.admin_port), self.db_name
            )
            out[iid] = (info, state, seq)
        return out

    def _current_leader_addr(self) -> Optional[Tuple[str, int]]:
        for iid, (info, state, _seq) in self._live_replicas().items():
            if state in LEADERLIKE and iid != self.ctx.instance.instance_id:
                return (info.host, info.repl_port)
        return None

    def _catch_up(self, target_addr: Tuple[str, int], deadline: float,
                  margin: int = CATCH_UP_MARGIN) -> bool:
        """Wait until local seq is within ``margin`` of the target's
        (catch-up loop, LeaderFollowerStateModelFactory.java:570-599).
        margin=0 demands exact catch-up — right for promotion, where the
        peer has no leader and its seq is static."""
        ctx = self.ctx
        admin_target = target_addr
        while time.monotonic() < deadline:
            local = ctx.admin.get_sequence_number(
                ctx.local_admin_addr, self.db_name
            )
            remote = ctx.admin.get_sequence_number(admin_target, self.db_name)
            if local is None or remote is None:
                return False
            if local + margin >= remote:
                return True
            time.sleep(0.1)
        return False

    def _apply_resource_configs(self) -> None:
        """reference :500-525 — reapply per-resource db options from the
        coordinator after (re)adding the db."""
        segment = db_name_to_segment(self.db_name)
        cfg = self.ctx.resource_config(segment)
        options = cfg.get("db_options")
        if options:
            try:
                self.ctx.admin.set_db_options(
                    self.ctx.local_admin_addr, self.db_name, options
                )
            except Exception:
                log.warning("%s: applying resource configs failed", self.db_name)

    # -- transitions -------------------------------------------------------

    def on_become_follower_from_offline(self) -> None:
        ctx = self.ctx
        ctx.log_event(self.partition, "offline_to_follower_init")
        lock = ctx.partition_lock(self.partition)
        if lock is None:
            raise TransitionError(f"{self.partition}: partition lock timeout")
        try:
            replicas = self._live_replicas()
            leader = None
            best_seq = -1
            best_addr = None
            for iid, (info, state, seq) in replicas.items():
                if iid == ctx.instance.instance_id:
                    continue
                if state in LEADERLIKE:
                    leader = info
                if seq is not None and seq > best_seq:
                    best_seq = seq
                    best_addr = info
            upstream = (
                (leader.host, leader.repl_port) if leader
                else (best_addr.host, best_addr.repl_port) if best_addr
                else ctx.local_repl_addr  # bootstrap: self-upstream, no-op
            )
            epoch = ctx.partition_epoch(self.partition)
            try:
                ctx.admin.add_db(
                    ctx.local_admin_addr, self.db_name, "FOLLOWER", upstream,
                    epoch=epoch,
                )
            except RpcApplicationError as e:
                if e.code != "DB_ALREADY_EXISTS":
                    raise
                # ERROR-recovery replan lands here with the db still open
                # (e.g. a failed promotion retries via OFFLINE): converge
                # role/upstream instead of failing the whole transition
                ctx.admin.change_db_role_and_upstream(
                    ctx.local_admin_addr, self.db_name, "FOLLOWER", upstream,
                    epoch=epoch,
                )
            # needRebuildDB: far behind the best replica -> snapshot
            # rebuild; ALSO rebuild when the donor's WAL no longer
            # reaches back to our seq — the serve path would raise
            # "WAL gap … puller must rebuild" forever and plain
            # catch-up can never terminate (the reference checks WAL
            # availability, not just the seq gap; found by the reshard
            # chaos harness: a deposed-resync'd replica rejoining from
            # seq 0 wedged behind a donor whose WAL was purged)
            local = ctx.admin.get_sequence_number(
                ctx.local_admin_addr, self.db_name
            ) or 0
            need_rebuild = best_seq - local > REBUILD_SEQ_GAP
            # probe the node the puller will ACTUALLY pull from — the
            # leader when one exists, not the max-seq replica: a
            # tie-broken probe of a sibling whose WAL reaches back
            # fine passes the check while the real upstream's WAL is
            # purged past us, and the follower wedges at its old seq
            # through every heal replan (found by the rebalance chaos
            # harness: a split-child follower stuck at 0 behind a
            # child leader whose WAL began at the cutover snapshot)
            probe = leader if leader is not None else best_addr
            if (not need_rebuild and probe is not None
                    and best_seq > local):
                donor = ctx.admin.check_db(
                    (probe.host, probe.admin_port), self.db_name)
                if donor is not None:
                    oldest = donor.get("oldest_wal_seq")
                    # an empty donor WAL (oldest None) serves NO
                    # history: with the donor ahead of us that is a
                    # gap too, not a pass
                    if oldest is None or local + 1 < int(oldest):
                        need_rebuild = True
            if (
                need_rebuild
                and ctx.backup_store_uri
                and best_addr is not None
            ):
                ctx.log_event(self.partition, "rebuild_from_peer_init")
                peer = (best_addr.host, best_addr.admin_port)
                backup_path = f"rebuilds/{self.db_name}"
                ctx.admin.backup_db_to_store(
                    peer, self.db_name, ctx.backup_store_uri, backup_path
                )
                ctx.admin.restore_db_from_store(
                    ctx.local_admin_addr, self.db_name,
                    ctx.backup_store_uri, backup_path, upstream,
                )
                ctx.log_event(self.partition, "rebuild_from_peer_success")
            if best_addr is not None:
                self._catch_up(
                    (best_addr.host, best_addr.admin_port),
                    time.monotonic() + ctx.catch_up_timeout,
                )
            self._apply_resource_configs()
            ctx.log_event(self.partition, "offline_to_follower_success")
        except Exception:
            ctx.log_event(self.partition, "offline_to_follower_failure")
            raise
        finally:
            ctx.release_partition_lock(lock)

    def on_become_leader_from_follower(self) -> None:
        ctx = self.ctx
        ctx.log_event(self.partition, "follower_to_leader_init")
        lock = ctx.partition_lock(self.partition)
        if lock is None:
            raise TransitionError(f"{self.partition}: partition lock timeout")
        try:
            replicas = self._live_replicas()
            # no-live-leader check (reference :230-260)
            for iid, (info, state, _seq) in replicas.items():
                if state in LEADERLIKE and iid != ctx.instance.instance_id:
                    raise TransitionError(
                        f"{self.partition}: {iid} is still {state}"
                    )
            self._promote_local(replicas, "retrying promotion")
            ctx.log_event(self.partition, "follower_to_leader_success")
        except Exception:
            ctx.log_event(self.partition, "follower_to_leader_failure")
            raise
        finally:
            ctx.release_partition_lock(lock)

    def _promote_local(self, replicas: Dict[str, Tuple], retry: str,
                       epoch: Optional[int] = None) -> None:
        """The promotion's data steps, under the partition lock: read
        every live serving replica's seq, catch up from the highest,
        apply the 3-node-failure guard, check that the epoch ledger still
        names this replica, reopen as LEADER and checkpoint the seq.
        ``epoch`` None stamps the controller-minted epoch as each step
        reads it and checkpoints the local seq, as the reference's
        promotion does; an explicit ``epoch`` (a re-promotion) stamps
        that one and never lowers the checkpointed seq."""
        ctx = self.ctx

        def stamp() -> int:
            return (ctx.partition_epoch(self.partition) if epoch is None
                    else epoch)

        # a live replica with the lineage's data whose seq could not be
        # read (a db reopening for a repoint answers DB_NOT_FOUND) may be
        # ahead of us: promoting past it strands its suffix, and it then
        # clears itself as diverged. Refuse and retry (ROADMAP F21; the
        # port's repair, the reference elects without it)
        unread = sorted(iid for iid, (_info, state, seq) in replicas.items()
                        if iid != ctx.instance.instance_id
                        and state in SERVING and seq is None)
        if unread:
            raise TransitionError(
                f"{self.partition}: seq of {', '.join(unread)} "
                f"unreadable; {retry}"
            )
        local = ctx.admin.get_sequence_number(
            ctx.local_admin_addr, self.db_name
        ) or 0
        # highest-seq election: catch up from any replica ahead of us
        best_iid, best_seq, best_info = None, local, None
        for iid, (info, _state, seq) in replicas.items():
            if iid == ctx.instance.instance_id or seq is None:
                continue
            if seq > best_seq:
                best_iid, best_seq, best_info = iid, seq, info
        if best_info is not None:
            ctx.log_event(self.partition, "catch_up_via_peer",
                          f"peer={best_iid} seq={best_seq}")
            ctx.admin.change_db_role_and_upstream(
                ctx.local_admin_addr, self.db_name, "FOLLOWER",
                (best_info.host, best_info.repl_port), epoch=stamp(),
            )
            # margin=0: the peer has no leader feeding it, so its seq
            # is static and exact catch-up terminates. Promoting even
            # a few seqs short would strand writes that exist only on
            # the peer (it can never hand them to the new leader) and
            # leave the replica set divergent until enough fresh
            # writes paper over the seq gap — with none, forever
            # (reference :230-303 promotes the caught-up candidate).
            if not self._catch_up(
                (best_info.host, best_info.admin_port),
                time.monotonic() + ctx.catch_up_timeout,
                margin=0,
            ):
                raise TransitionError(
                    f"{self.partition}: catch-up from {best_iid} "
                    f"(seq {best_seq}) incomplete; {retry}"
                )
        # 3-node-failure guard (reference :291-303): refuse promotion if
        # we're far behind the last known leader seq in the coordinator.
        # Slack is ctx.promotion_seq_slack (default = REBUILD_SEQ_GAP):
        # chaos-sized clusters tighten it so a data-poor candidate can
        # never be promoted past a checkpointed lineage it hasn't
        # caught up to.
        persisted = ctx.get_partition_seq(self.partition)
        local = ctx.admin.get_sequence_number(
            ctx.local_admin_addr, self.db_name
        ) or 0
        if persisted is not None and \
                local + ctx.promotion_seq_slack < persisted:
            raise TransitionError(
                f"{self.partition}: local seq {local} too far behind "
                f"last leader seq {persisted}; refusing promotion"
            )
        # a promotion from a superseded assignment: the controller
        # minted another replica's epoch after it issued this one (the
        # leadership flapped while this promotion was in flight).
        # Promoting anyway makes a second leader whose acked writes the
        # ledger's leader never holds, and which its followers then
        # clear as a diverged suffix. Refuse and replan (ROADMAP F23;
        # the port's repair, the reference promotes)
        _ledger_epoch, ledger_leader = ctx.epoch_ledger(self.partition)
        if ledger_leader not in (None, ctx.instance.instance_id):
            raise TransitionError(
                f"{self.partition}: the epoch ledger names "
                f"{ledger_leader}; {retry}"
            )
        # the promotion carries the controller-minted epoch: every
        # ack this leader hands out is stamped with it, and any
        # deposed predecessor seeing it on a follower frame fences
        ctx.admin.change_db_role_and_upstream(
            ctx.local_admin_addr, self.db_name, "LEADER", epoch=stamp(),
        )
        if epoch is not None and persisted is not None:
            local = max(local, persisted)
        ctx.set_partition_seq(self.partition, local)

    def reanoint_fenced(self, epoch: int) -> bool:
        """Re-promote this replica when the controller re-anointed it at
        the very epoch that fenced it, and return True; change nothing
        and return False in every other case.

        The controller mints a fresh epoch when it keeps leadership with
        a node that claims LEADER but is not the ledger's leader (a node
        whose session lapsed and that came back still claiming). Its
        followers learn the epoch from their repoints and can pull
        before the leader adopts it: the leader, still at its old epoch,
        sees a newer one and fences itself. ``adopt_epoch`` clears a
        fence only strictly above the fencing epoch, so the adoption
        leaves the leader fenced at its own epoch: one claimer in the
        control plane, and a data plane that refuses every write and
        serve for good.

        When the local replica is a fenced LEADER and the epoch ledger
        records THIS node as the leader at exactly ``epoch``, the fence
        came from its own lineage, and the promotion's data steps run
        again at ``epoch`` (``_promote_local``): exact catch-up from any
        live replica ahead of us (writes a concurrently promoted peer
        acked must survive; pulling at ``epoch`` fences that peer
        first), the 3-node-failure guard, then a reopen as LEADER: a
        fresh replicated db, no fence, a fresh ack window. Where the
        guard refuses (the checkpointed seq is ahead of every live
        replica: a dead peer held acked writes) it raises
        TransitionError, as the promotion does. A replica fenced by
        another leader's epoch stays fenced, and the Follower->Leader
        transition keeps its no-live-leader check."""
        ctx = self.ctx
        info = ctx.admin.check_db(ctx.local_admin_addr, self.db_name)
        if (not info or not info.get("fenced")
                or info.get("role") != "LEADER"):
            return False
        me = ctx.instance.instance_id
        if ctx.epoch_ledger(self.partition) != (int(epoch), me):
            return False
        ctx.log_event(self.partition, "reanoint_fenced_init",
                      f"epoch={epoch}")
        lock = ctx.partition_lock(self.partition)
        if lock is None:
            raise TransitionError(f"{self.partition}: partition lock timeout")
        try:
            self._promote_local(self._live_replicas(),
                                "re-anointment abandoned", epoch=int(epoch))
            ctx.log_event(self.partition, "reanoint_fenced_success")
        except Exception:
            ctx.log_event(self.partition, "reanoint_fenced_failure")
            raise
        finally:
            ctx.release_partition_lock(lock)
        return True

    def on_become_follower_from_leader(self) -> None:
        ctx = self.ctx
        ctx.log_event(self.partition, "leader_to_follower_init")
        seq = ctx.admin.get_sequence_number(ctx.local_admin_addr, self.db_name)
        other_leader = self._current_leader_addr()
        if (other_leader is not None and ctx.epoch_ledger(
                self.partition)[1] == ctx.instance.instance_id):
            # the ledger's own leader, demoted by a two-phase handoff
            # (a move's pin prefers another node) while a stale claimer
            # it outlived is back and still claims: the other claim is
            # the deposed one, and this replica's data is the lineage's.
            # A deposed resync here would clear both copies of the
            # lineage head (the port's repair; the reference clears)
            ctx.log_event(self.partition, "stale_claimer_ignored",
                          f"local_seq={seq}")
            other_leader = None
        # checkpoint the final leader seq before demotion — not a deposed
        # leader's: its suffix past the lineage is un-acked, and a seq
        # checkpointed from it would hold every replica of the lineage
        # below the 3-node-failure guard for good (the port's repair; the
        # reference checkpoints it)
        if seq is not None and other_leader is None:
            ctx.set_partition_seq(self.partition, seq)
        if other_leader is not None:
            # DEPOSED demote: another leader is already serving, so this
            # is not the demote phase of a two-phase handoff (which runs
            # with no live leader) — we were deposed while unreachable.
            # Any locally-committed un-acked suffix may diverge from the
            # new lineage, and sequence arithmetic cannot prove it safe
            # (the new leader's seq can overtake ours while histories
            # differ). Resync from scratch: clear the storage and rejoin
            # through the Offline→Follower path, which rebuilds from a
            # peer snapshot or WAL catch-up.
            ctx.log_event(self.partition, "deposed_resync_init",
                          f"local_seq={seq}")
            try:
                ctx.admin.clear_db(ctx.local_admin_addr, self.db_name,
                                   reopen=False)
            except RpcApplicationError as e:
                if e.code != "DB_NOT_FOUND":
                    raise
            self.on_become_follower_from_offline()
            ctx.log_event(self.partition, "deposed_resync_success")
            return
        upstream = ctx.local_repl_addr
        try:
            ctx.admin.change_db_role_and_upstream(
                ctx.local_admin_addr, self.db_name, "FOLLOWER", upstream,
                epoch=ctx.partition_epoch(self.partition),
            )
        except RpcApplicationError as e:
            if e.code != "DB_NOT_FOUND":
                raise
            # the db vanished under us — a split cutover renamed it to a
            # child lineage. The demote's goal (this replica no longer
            # acks as leader) is already met more strongly than a role
            # flip could: there is nothing here to ack.
            ctx.log_event(self.partition, "leader_to_follower_db_gone")
        ctx.log_event(self.partition, "leader_to_follower_success")

    def on_become_offline_from_follower(self) -> None:
        try:
            self.ctx.admin.close_db(self.ctx.local_admin_addr, self.db_name)
        except RpcApplicationError as e:
            if e.code != "DB_NOT_FOUND":
                raise
            # renamed away by a split cutover: already as offline as it gets

    def on_become_dropped_from_offline(self) -> None:
        # destroy local data (reference: Offline→Dropped removes the db)
        try:
            self.ctx.admin.add_db(
                self.ctx.local_admin_addr, self.db_name, "NOOP"
            )
        except Exception:
            pass
        self.ctx.admin.clear_db(
            self.ctx.local_admin_addr, self.db_name, reopen=False
        )


class LeaderFollowerStateModelFactory(StateModelFactory):
    model_class = LeaderFollowerStateModel
    name = "LeaderFollower"
