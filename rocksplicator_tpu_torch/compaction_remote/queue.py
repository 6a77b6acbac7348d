"""The durable compaction job ledger, coordinator-backed.
(The port's copy of ``rocksplicator_tpu/compaction_remote/queue.py``.)

Layout (all under one base, default ``/compactions``)::

    /compactions/<db>            job node — value: CompactionJob JSON
    /compactions/<db>/claim      ephemeral — value: worker_id
    /compactions/<db>/heartbeat  worker-stamped ms wall clock
    /compactions/<db>/result     JobResult JSON
    /compactions_summary         cluster-lifetime counters (best-effort)

The job node doubles as the one-job-per-db lock: ``create`` is the
atomic publish, and a second publish while one is in flight hits
NODE_EXISTS → :class:`JobInFlightError` (the same create-as-lock the
shard-move ledger uses for one-mover-per-partition). The claim node is
ephemeral and created with ``create`` too, so exactly one worker wins a
job — the loser's create raises NODE_EXISTS — and a killed worker's
claim evaporates with its session. Reaping a dead worker's claim
(leader-side, on heartbeat expiry) deletes only the claim/heartbeat/
result children and leaves the job node, which IS the republish: the
job reappears in every worker's ``list_open_jobs`` scan.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional, Tuple

from ..rpc.errors import RpcApplicationError
from ..testing import failpoints as fp
from ..utils.stats import Stats, tagged
from .jobs import CompactionJob, JobResult

log = logging.getLogger(__name__)

NO_NODE = "NO_NODE"
NODE_EXISTS = "NODE_EXISTS"
BAD_VERSION = "BAD_VERSION"

BASE_PATH = "/compactions"
SUMMARY_PATH = "/compactions_summary"


class JobInFlightError(Exception):
    """A job for this db is already published (one-job-per-db lock)."""


def _now_ms() -> int:
    return int(time.time() * 1000)


class CompactionJobQueue:
    """Leader- and worker-side operations on the job ledger. Thin and
    stateless by design: every method round-trips the coordinator, so a
    queue object can be rebuilt from nothing after any crash."""

    def __init__(self, coord, base: str = BASE_PATH,
                 summary: str = SUMMARY_PATH):
        self._coord = coord
        self._base = base.rstrip("/") or BASE_PATH
        self._summary = summary

    # -- paths ---------------------------------------------------------

    def _job(self, db: str) -> str:
        return f"{self._base}/{db}"

    # -- leader side ---------------------------------------------------

    def publish(self, job: CompactionJob) -> None:
        """Atomically publish ``job``; raises :class:`JobInFlightError`
        when one is already open for the db."""
        # control plane: leader hands the pick to the tier. A fault here
        # is absorbed by maybe_offload's local fallback.
        fp.hit("compact.remote.publish")
        self._coord.ensure(self._base)
        for attempt in (0, 1):
            try:
                self._coord.create(self._job(job.db_name), job.encode())
                break
            except RpcApplicationError as e:
                if e.code != NODE_EXISTS:
                    raise
                # the coordinator auto-creates missing parents, so a
                # dead worker's late heartbeat/result put can resurrect
                # the job path as an EMPTY husk after a sweep. A husk
                # (no decodable job value) is garbage, not a lock —
                # reclaim it and retry once; a real job stays a lock.
                if attempt == 0 and self.get_job(job.db_name) is None:
                    self._coord.delete_if_exists(
                        self._job(job.db_name), recursive=True)
                    continue
                raise JobInFlightError(job.db_name) from e
        self.bump_summary("published")
        Stats.get().incr(
            tagged("compaction.remote.published", db=job.db_name))

    def get_job(self, db: str) -> Optional[CompactionJob]:
        raw = self._coord.get_or_none(self._job(db))
        if raw is None:
            return None
        try:
            return CompactionJob.decode(raw)
        except (ValueError, TypeError, UnicodeDecodeError):
            log.warning("undecodable job node for %s", db)
            return None

    def get_result(self, db: str) -> Optional[JobResult]:
        raw = self._coord.get_or_none(f"{self._job(db)}/result")
        if raw is None:
            return None
        try:
            return JobResult.decode(raw)
        except (ValueError, TypeError, UnicodeDecodeError):
            log.warning("undecodable result node for %s", db)
            return None

    def claim_holder(self, db: str) -> Optional[str]:
        raw = self._coord.get_or_none(f"{self._job(db)}/claim")
        return bytes(raw).decode("utf-8", "replace") if raw is not None \
            else None

    def heartbeat_age_ms(self, db: str) -> Optional[int]:
        """ms since the claiming worker's last heartbeat; None when no
        heartbeat has landed yet."""
        raw = self._coord.get_or_none(f"{self._job(db)}/heartbeat")
        if raw is None:
            return None
        try:
            return max(0, _now_ms() - int(bytes(raw).decode()))
        except ValueError:
            return None

    def reap_claim(self, db: str) -> None:
        """Leader-side: evict a dead worker's claim. The job node stays,
        so the very next worker scan re-offers the job — this IS the
        republish after heartbeat expiry."""
        for child in ("claim", "heartbeat", "result"):
            self._coord.delete_if_exists(f"{self._job(db)}/{child}")
        self.bump_summary("reaped")
        Stats.get().incr(tagged("compaction.remote.reaped", db=db))

    def remove(self, db: str) -> None:
        """Retire the ledger entry (install done, fenced, or fallback)."""
        self._coord.delete_if_exists(self._job(db), recursive=True)

    # -- worker side ---------------------------------------------------

    def list_open_jobs(self) -> List[str]:
        """db names with a published, unclaimed job."""
        open_jobs = []
        for db in self._coord.list(self._base):
            if self._coord.get_or_none(f"{self._base}/{db}/claim") is None:
                open_jobs.append(db)
        return open_jobs

    def claim(self, db: str, worker_id: str) -> Optional[CompactionJob]:
        """Atomically claim the job for ``db``; None when another worker
        won (duplicate claim loses on NODE_EXISTS) or the job vanished."""
        # data plane handoff: a duplicate claim must lose, never corrupt
        fp.hit("compact.remote.claim")
        job = self.get_job(db)
        if job is None:
            return None
        try:
            self._coord.create(
                f"{self._job(db)}/claim", worker_id.encode("utf-8"),
                ephemeral=True)
        except RpcApplicationError as e:
            if e.code in (NODE_EXISTS, NO_NODE):
                return None  # lost the race, or job retired under us
            raise
        try:
            self.heartbeat(db)
        except Exception:
            # the claim is already held — abandoning it here would wedge
            # the job until the leader reaps. The worker's heartbeat
            # loop stamps liveness momentarily; a worker that dies first
            # is reaped on the no-heartbeat timeout.
            log.debug("claim-time heartbeat failed for %s", db,
                      exc_info=True)
        self.bump_summary("claimed")
        Stats.get().incr(tagged("compaction.remote.claimed", db=db))
        return job

    def heartbeat(self, db: str) -> None:
        """Stamp worker liveness; the leader reaps the claim when this
        goes stale (worker died mid-job)."""
        fp.hit("compact.remote.heartbeat")
        self._coord.put(f"{self._job(db)}/heartbeat",
                        str(_now_ms()).encode())

    def post_result(self, result: JobResult) -> None:
        self._coord.put(f"{self._job(result.db_name)}/result",
                        result.encode())

    # -- observability -------------------------------------------------

    def bump_summary(self, key: str) -> None:
        """Best-effort read-modify-write on the cluster-lifetime
        counters — same lost-update tolerance as the move ledger's
        moves_summary: the counters are operator telemetry, not
        correctness state."""
        try:
            raw = self._coord.get_or_none(self._summary)
            counters: Dict[str, int] = {}
            if raw:
                try:
                    counters = json.loads(bytes(raw).decode())
                except (ValueError, UnicodeDecodeError):
                    counters = {}
            counters[key] = int(counters.get(key, 0)) + 1
            self._coord.put(self._summary,
                            json.dumps(counters, sort_keys=True).encode())
        except Exception:
            log.debug("compactions_summary bump failed", exc_info=True)

    def read_summary(self) -> Dict[str, int]:
        raw = self._coord.get_or_none(self._summary)
        if not raw:
            return {}
        try:
            return {k: int(v)
                    for k, v in json.loads(bytes(raw).decode()).items()}
        except (ValueError, UnicodeDecodeError, AttributeError):
            return {}

    def active_jobs(self) -> Dict[str, dict]:
        """Per-db live job state for /cluster_stats: phase, worker,
        heartbeat age, epoch. One ledger scan, read-only."""
        out: Dict[str, dict] = {}
        for db in self._coord.list(self._base):
            job = self.get_job(db)
            if job is None:
                continue
            holder = self.claim_holder(db)
            result = self.get_result(db)
            if result is not None:
                phase = "done" if result.status == "done" else "failed"
            elif holder is not None:
                phase = "claimed"
            else:
                phase = "published"
            out[db] = {
                "job_id": job.job_id,
                "epoch": job.epoch,
                "phase": phase,
                "worker": holder,
                "heartbeat_age_ms": self.heartbeat_age_ms(db),
                "input_bytes": job.input_bytes,
            }
        return out
