"""State-model plumbing.
(The port's copy of ``rocksplicator_tpu/cluster/state_models/base.py``.)

Reference: Helix state models — a per-partition object whose
``on_become_X_from_Y`` callbacks execute the transition work; a factory
creates one per partition (Participant.java:348-396 registers factories by
state-model name).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

from ..model import DROPPED, ERROR, OFFLINE

log = logging.getLogger(__name__)


class TransitionError(Exception):
    pass


class StateModel:
    """Per-partition transition executor. Subclasses define
    ``transition_paths`` (state graph edges) and ``on_become_X_from_Y``
    methods."""

    # edges: (from, to) pairs the model supports directly
    edges: List[Tuple[str, str]] = []
    initial_state = OFFLINE

    def __init__(self, partition: str, ctx: "ClusterContext"):
        self.partition = partition
        self.ctx = ctx

    def transition(self, from_state: str, to_state: str) -> None:
        method = getattr(
            self,
            f"on_become_{to_state.lower()}_from_{from_state.lower()}",
            None,
        )
        if method is None:
            raise TransitionError(
                f"{type(self).__name__}: no transition {from_state}->{to_state}"
            )
        method()

    def plan(self, from_state: str, to_state: str) -> List[Tuple[str, str]]:
        """Shortest edge path from→to (BFS over the model's edges)."""
        if from_state == to_state:
            return []
        frontier = [(from_state, [])]
        seen = {from_state}
        while frontier:
            state, path = frontier.pop(0)
            for a, b in self.edges:
                if a == state and b not in seen:
                    new_path = path + [(a, b)]
                    if b == to_state:
                        return new_path
                    seen.add(b)
                    frontier.append((b, new_path))
        raise TransitionError(
            f"{type(self).__name__}: no path {from_state}->{to_state}"
        )


class StateModelFactory:
    model_class = StateModel
    name = "Base"

    def __init__(self, ctx: "ClusterContext"):
        self.ctx = ctx
        self._models: Dict[str, StateModel] = {}

    def get(self, partition: str) -> StateModel:
        model = self._models.get(partition)
        if model is None:
            model = self.model_class(partition, self.ctx)
            self._models[partition] = model
        return model


class ClusterContext:
    """Everything a transition needs: coordinator, admin client, identity,
    and cluster views (reference: the Helix manager + Utils)."""

    def __init__(self, coord, admin, cluster: str, instance,
                 backup_store_uri: Optional[str] = None,
                 catch_up_timeout: float = 60.0,
                 view_cluster: Optional[str] = None,
                 promotion_seq_slack: Optional[int] = None):
        from ..model import cluster_path

        self.coord = coord            # CoordinatorClient
        self.admin = admin            # AdminClient
        self.cluster = cluster
        # 3-node-failure promotion guard slack: refuse promotion when
        # the candidate is more than this many seqs behind the last
        # checkpointed leader seq. Defaults to the rebuild gap
        # (reference behavior); chaos-sized clusters tighten it so an
        # empty replica can never be promoted over a transiently-
        # invisible data-rich peer (found by the reshard harness: an
        # absolute 100k slack is scale-blind at small workloads).
        from .leader_follower import REBUILD_SEQ_GAP as _GAP

        self.promotion_seq_slack = (
            int(promotion_seq_slack) if promotion_seq_slack is not None
            else _GAP)
        # The cluster whose topology (instances / current states) the
        # state models observe. Differs from ``cluster`` for CDC
        # participants, which join their own cluster but watch the DATA
        # cluster's leaders (reference: CdcUtils reads the data cluster's
        # external view).
        self.view_cluster = view_cluster or cluster
        self.instance = instance      # InstanceInfo (me)
        self.backup_store_uri = backup_store_uri
        self.catch_up_timeout = catch_up_timeout
        self._path = lambda *p: cluster_path(cluster, *p)
        self._view_path = lambda *p: cluster_path(self.view_cluster, *p)
        # controller-stamped fencing epochs, noted by the participant on
        # every assignment update; state models thread them into the
        # data plane (add_db / change_db_role_and_upstream)
        self._partition_epochs: Dict[str, int] = {}

    # -- fencing epochs ----------------------------------------------------

    def note_partition_epoch(self, partition: str, epoch: int) -> None:
        """Epochs are monotonic: never regress a noted value."""
        epoch = int(epoch or 0)
        if epoch > self._partition_epochs.get(partition, 0):
            self._partition_epochs[partition] = epoch

    def partition_epoch(self, partition: str) -> int:
        return self._partition_epochs.get(partition, 0)

    # -- identity ----------------------------------------------------------

    @property
    def local_admin_addr(self) -> Tuple[str, int]:
        return (self.instance.host, self.instance.admin_port)

    @property
    def local_repl_addr(self) -> Tuple[str, int]:
        return (self.instance.host, self.instance.repl_port)

    # -- cluster views -----------------------------------------------------

    def live_instances(self) -> Dict[str, "InstanceInfo"]:
        from ..model import InstanceInfo

        out = {}
        for iid in self.coord.list(self._view_path("instances")):
            raw = self.coord.get_or_none(self._view_path("instances", iid))
            if raw:
                out[iid] = InstanceInfo.decode(raw)
        return out

    def external_view(self, partition: str) -> Dict[str, str]:
        """instance_id -> state for one partition, from currentstates."""
        from ..model import decode_states

        out = {}
        for iid in self.coord.list(self._view_path("currentstates")):
            states = decode_states(
                self.coord.get_or_none(self._view_path("currentstates", iid))
            )
            if partition in states:
                out[iid] = states[partition]
        return out

    def instance_info(self, instance_id: str):
        from ..model import InstanceInfo

        raw = self.coord.get_or_none(self._view_path("instances", instance_id))
        return InstanceInfo.decode(raw) if raw else None

    # -- per-partition lock (reference: zk InterProcessMutex) -------------

    def partition_lock(self, partition: str, timeout: float = 60.0):
        return self.coord.acquire_lock(
            self._path("locks", "partitions", partition), timeout
        )

    def release_partition_lock(self, node: str) -> None:
        self.coord.release_lock(node)

    # -- partition state checkpoints (3-node-failure guard) ---------------

    def get_partition_seq(self, partition: str) -> Optional[int]:
        import json

        raw = self.coord.get_or_none(self._path("partitionstate", partition))
        if raw is None:
            return None
        return int(json.loads(bytes(raw).decode()).get("last_leader_seq", 0))

    def epoch_ledger(self, partition: str) -> Tuple[int, Optional[str]]:
        """(epoch, leader) of the partition's fencing-epoch ledger record,
        which the controller writes as it mints each epoch for exactly
        one leader; (0, None) where there is none."""
        import json

        raw = self.coord.get_or_none(self._path("epochs", partition))
        try:
            rec = json.loads(bytes(raw).decode()) if raw else {}
            return int(rec.get("epoch", 0)), rec.get("leader")
        except (ValueError, UnicodeDecodeError, AttributeError):
            return 0, None

    def set_partition_seq(self, partition: str, seq: int) -> None:
        import json
        import time as _time

        self.coord.put(
            self._path("partitionstate", partition),
            json.dumps(
                {"last_leader_seq": seq, "updated_ms": int(_time.time() * 1000)}
            ).encode(),
        )

    # -- resource configs applied on transitions --------------------------

    def resource_config(self, segment: str) -> Dict:
        import json

        raw = self.coord.get_or_none(self._path("config", segment))
        return json.loads(bytes(raw).decode()) if raw else {}

    # -- event history (reference eventstore/) ----------------------------

    def log_event(self, partition: str, event_type: str, detail: str = "") -> None:
        from ..eventstore import append_event

        try:
            append_event(self.coord, self.cluster, partition, event_type,
                         self.instance.instance_id, detail)
        except Exception:
            log.exception("event log failed (non-fatal)")
