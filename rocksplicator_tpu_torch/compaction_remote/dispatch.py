"""Remote dispatch policy — which picks offload, and the patience knobs.
(The port's copy of ``rocksplicator_tpu/compaction_remote/dispatch.py``.)

All env-tunable (README Tuning table), defaults chosen so the tier is
strictly opt-in and never blocks serving:

- ``RSTPU_COMPACT_REMOTE``            enable ("1"/"true"/"on")
- ``RSTPU_COMPACT_REMOTE_FLOOR``      min input bytes to offload (8 MiB);
  below the floor the local merge is cheaper than two object-store trips
- ``RSTPU_COMPACT_REMOTE_DEADLINE``   whole-job deadline seconds (120)
- ``RSTPU_COMPACT_REMOTE_CLAIM_WAIT`` seconds to wait for any worker to
  claim before falling back locally (5)
- ``RSTPU_COMPACT_REMOTE_HB_TIMEOUT`` heartbeat staleness that declares
  a claiming worker dead → claim reaped, job republished (10)
- ``RSTPU_COMPACT_COORD``             coordinator endpoint host:port the
  worker CLI connects to
- ``RSTPU_COMPACT_REMOTE_STORE``      object store URI for job transfer
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

_TRUTHY = ("1", "true", "on", "yes")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass
class RemoteDispatchPolicy:
    enabled: bool = False
    size_floor_bytes: int = 8 << 20
    deadline_s: float = 120.0
    claim_wait_s: float = 5.0
    heartbeat_timeout_s: float = 10.0
    poll_interval_s: float = 0.05

    @classmethod
    def from_env(cls) -> "RemoteDispatchPolicy":
        return cls(
            enabled=os.environ.get(
                "RSTPU_COMPACT_REMOTE", "").lower() in _TRUTHY,
            size_floor_bytes=_env_int("RSTPU_COMPACT_REMOTE_FLOOR", 8 << 20),
            deadline_s=_env_float("RSTPU_COMPACT_REMOTE_DEADLINE", 120.0),
            claim_wait_s=_env_float("RSTPU_COMPACT_REMOTE_CLAIM_WAIT", 5.0),
            heartbeat_timeout_s=_env_float(
                "RSTPU_COMPACT_REMOTE_HB_TIMEOUT", 10.0),
        )


def coord_endpoint_from_env() -> Optional[Tuple[str, int]]:
    """Parse ``RSTPU_COMPACT_COORD`` ("host:port") for the worker CLI."""
    raw = os.environ.get("RSTPU_COMPACT_COORD", "").strip()
    if not raw or ":" not in raw:
        return None
    host, _, port = raw.rpartition(":")
    try:
        return host, int(port)
    except ValueError:
        return None


def store_uri_from_env() -> Optional[str]:
    return os.environ.get("RSTPU_COMPACT_REMOTE_STORE") or None


def attach_from_env(ledger_name: str, engine, epoch_provider):
    """Serving-node wiring (Replicator.add_db): attach a
    :class:`RemoteCompactionManager` to a shard's engine when the
    environment opts in — ``RSTPU_COMPACT_REMOTE`` truthy AND both
    ``RSTPU_COMPACT_COORD`` and ``RSTPU_COMPACT_REMOTE_STORE`` set.
    Returns the manager (orphan jobs already recovered, hook installed)
    or None. ``ledger_name`` must be unique per REPLICA, not per shard
    — every replica runs its own background compaction, and two
    replicas sharing a ledger key would fight over the one-job lock and
    sweep each other's live jobs. The manager owns the coordinator
    client it opens here; ``detach`` closes it."""
    import logging

    policy = RemoteDispatchPolicy.from_env()
    if not policy.enabled:
        return None
    endpoint = coord_endpoint_from_env()
    store_uri = store_uri_from_env()
    if endpoint is None or store_uri is None:
        logging.getLogger(__name__).warning(
            "RSTPU_COMPACT_REMOTE set but RSTPU_COMPACT_COORD / "
            "RSTPU_COMPACT_REMOTE_STORE missing; remote compaction "
            "stays off for %s", ledger_name)
        return None
    from ..cluster.coordinator import CoordinatorClient
    from .install import RemoteCompactionManager

    client = CoordinatorClient(*endpoint)
    try:
        mgr = RemoteCompactionManager(
            ledger_name, engine, client, store_uri, policy=policy,
            epoch_provider=epoch_provider)
        # recover-then-serve: sweep any orphaned job a crashed
        # predecessor of this replica left in the ledger
        mgr.recover()
    except Exception:
        client.close()
        raise
    mgr.owned_coord = client
    engine.set_remote_compactor(mgr)
    return mgr


def detach(engine, mgr) -> None:
    """Undo :func:`attach_from_env`: unhook the engine and close the
    coordinator client the attach opened. Safe on a None manager."""
    if mgr is None:
        return
    try:
        engine.set_remote_compactor(None)
    except Exception:
        pass
    client = getattr(mgr, "owned_coord", None)
    if client is not None:
        try:
            client.close()
        except Exception:
            pass
