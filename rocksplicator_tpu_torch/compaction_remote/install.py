"""Leader-side remote dispatch: publish → await → verify → fenced install.
(The port's copy of ``rocksplicator_tpu/compaction_remote/install.py``.)

``RemoteCompactionManager.maybe_offload`` is the engine's hook point
(``DB.set_remote_compactor``). It runs INSIDE the background compaction
thread, between the scheduler's pick and the local compaction dispatch,
and returns a tri-state the loop acts on:

- ``"installed"`` — the worker's generation installed atomically; the
  pick is satisfied, local compaction must not run.
- ``"declined"``  — the tier didn't handle it (disabled, below the size
  floor, nothing to compact, no claim, worker death past the deadline,
  checksum mismatch, any publish/transfer fault). The plan's mutex is
  released and the UNCHANGED local path runs — this is the automatic
  fallback, so serving correctness never depends on the tier.
- ``"fenced"``    — the job's epoch went stale while in flight: this
  leader was deposed. The result is discarded AND no local fallback
  runs — a deposed leader must not compact either; the loop surfaces
  the fencing error to manual waiters and re-picks (by which point the
  deposed node has resynced or stopped serving).

The epoch gate is the replication fencing rule extended to compaction.
Jobs are stamped with the leader's epoch at publish; at install time
the CURRENT epoch is re-read and compared by :func:`_epoch_is_current`
— a module-level function precisely so the chaos harness's
``--break-guard remote_install`` tooth can patch it out and prove the
deposed-leader install is otherwise caught.

Locking: the remote round trip runs off a
MUTEX-FREE snapshot (``engine.snapshot_full_compaction``) — the
shard's compaction mutex is won only for the final verify+install
(``engine.begin_full_install``, which revalidates the snapshot's
inputs are still live), so local picks never wait behind a slow
worker. Crash safety: a leader killed mid-job leaves only a ledger
entry plus garbage objects — ``recover()`` (called on reopen, before
serving) sweeps both; nothing can install because the install-time
mutex+revalidation gate is process-local state. Re-install after a
leader restart is therefore idempotent by construction: the restarted
leader sweeps the old job and re-plans from its reopened manifest.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import List, Optional

from ..testing import failpoints as fp
from ..utils.objectstore import build_object_store
from ..utils.stats import Stats, tagged
from .dispatch import RemoteDispatchPolicy
from .jobs import CompactionJob, file_checksum
from .queue import CompactionJobQueue, JobInFlightError

log = logging.getLogger(__name__)

# the scheduler's pressure-driven background picks; manual full
# compactions keep the local compact_range path (they carry futures and
# want synchronous completion semantics)
OFFLOADABLE_KINDS = ("l0", "level")


class FencedInstallError(Exception):
    """The publishing leader's epoch went stale mid-job; the result was
    discarded and no compaction (remote or local) ran for this pick."""


def _epoch_is_current(job_epoch: int, current_epoch: int) -> bool:
    """The fencing gate: a result may install only when no higher epoch
    has been minted since the job was published. Module-level and
    patchable on purpose — the ``remote_install`` chaos tooth breaks
    exactly this predicate to prove the harness catches a deposed
    leader's install."""
    return int(current_epoch) <= int(job_epoch)


class RemoteCompactionManager:
    """One per served DB on the leader. Thread-compat with the engine's
    single background compaction thread: maybe_offload is only ever
    called from there, one pick at a time."""

    def __init__(self, db_name: str, db, coord, store_uri: str,
                 policy: Optional[RemoteDispatchPolicy] = None,
                 epoch_provider=None):
        self.db_name = db_name
        self._db = db
        self._queue = CompactionJobQueue(coord)
        self._store_uri = store_uri
        self._store = build_object_store(store_uri)
        self.policy = policy or RemoteDispatchPolicy.from_env()
        self._epoch = epoch_provider or (lambda: 0)
        # in-process counters mirrored to Stats; cluster-lifetime ones
        # live in the ledger's summary node
        self.installed = 0
        self.failed_over = 0
        self.fenced = 0
        self.republished = 0

    # -- the engine hook ----------------------------------------------

    def maybe_offload(self, pick) -> str:
        if not self.policy.enabled:
            return "declined"
        if getattr(pick, "kind", None) not in OFFLOADABLE_KINDS:
            return "declined"
        # Snapshot WITHOUT the compaction mutex: the leader
        # holds the shard's mutex only for the final verify+install, so
        # local L0 picks and manual compact_range are never serialized
        # behind a slow worker's whole publish→claim→merge→download
        # round trip. The snapshot is revalidated under the mutex at
        # install time (engine.begin_full_install); a concurrent local
        # compaction that consumed an input makes the remote result
        # STALE — it is discarded, the local outcome stands. A GC'd
        # input mid-upload surfaces as an IO error here and falls back
        # locally; correctness never depends on the race.
        plan = self._db.snapshot_full_compaction()
        if plan is None:
            return "declined"
        job_id = uuid.uuid4().hex[:16]
        # install_full_compaction consumes the mutex won by
        # begin_full_install even when it raises; ``consumed`` tracks
        # whether the install phase owns it (no mutex is held anywhere
        # else anymore)
        consumed = {"plan": False}
        try:
            input_bytes = sum(r.file_size for r in plan["runs"])
            if input_bytes < self.policy.size_floor_bytes:
                return "declined"
            job = self._publish(plan, job_id, input_bytes)
            outcome = self._await_and_install(plan, job, consumed)
        except FencedInstallError as e:
            log.warning("%s: %s", self.db_name, e)
            self._sweep_job(job_id)
            self.fenced += 1
            self._queue.bump_summary("fenced")
            Stats.get().incr(
                tagged("compaction.remote.fenced", db=self.db_name))
            return "fenced"
        except Exception:
            log.exception("%s: remote compaction failed over to local",
                          self.db_name)
            self._sweep_job(job_id)
            if not consumed["plan"]:
                self._note_failover()
                return "declined"
            # the swap died inside install_full_compaction itself — the
            # pick was half-applied territory; surface to the bg loop
            raise
        if outcome != "installed":
            self._sweep_job(job_id)
            self._note_failover()
            return "declined"
        return "installed"

    # -- phases --------------------------------------------------------

    def _publish(self, plan: dict, job_id: str,
                 input_bytes: int) -> CompactionJob:
        opts = self._db.options
        inputs = []
        for name, reader in zip(plan["inputs"], plan["runs"]):
            path = f"{self._db.path}/{name}"
            key = f"compactions/{self.db_name}/{job_id}/in/{name}"
            self._store.put_object(path, key)
            inputs.append({
                "name": name, "key": key,
                "checksum": file_checksum(path),
                "bytes": reader.file_size,
            })
        merge_op = opts.merge_operator
        job = CompactionJob(
            job_id=job_id, db_name=self.db_name, epoch=int(self._epoch()),
            store_uri=self._store_uri, inputs=inputs,
            bottom=plan["bottom"], drop_tombstones=plan["drop_tombstones"],
            merge_operator=getattr(merge_op, "name", None),
            block_bytes=opts.block_bytes, compression=opts.compression,
            bits_per_key=opts.bits_per_key,
            target_file_bytes=opts.target_file_bytes,
            memory_budget_bytes=opts.compaction_memory_budget_bytes,
            deadline_ms=int(self.policy.deadline_s * 1000),
            published_ms=int(time.time() * 1000),
        )
        try:
            self._queue.publish(job)
        except JobInFlightError:
            # a ghost entry from a crashed predecessor on this db —
            # sweep it (nothing can install it: no plan is held) and
            # fall back locally this round
            log.warning("%s: stale job ledger entry; sweeping", self.db_name)
            self.recover()
            raise
        return job

    def _await_and_install(self, plan: dict, job: CompactionJob,
                           consumed: dict) -> str:
        deadline = time.monotonic() + self.policy.deadline_s
        claim_deadline = time.monotonic() + self.policy.claim_wait_s
        claim_seen_at = None
        while True:
            result = self._queue.get_result(job.db_name)
            if result is not None and result.job_id == job.job_id:
                if result.status != "done":
                    log.warning("%s: worker %s failed job %s: %s",
                                self.db_name, result.worker_id,
                                result.job_id, result.error)
                    return "failed"
                return self._install(plan, job, result, consumed)
            now = time.monotonic()
            if now >= deadline:
                return "deadline"
            holder = self._queue.claim_holder(job.db_name)
            if holder is None:
                claim_seen_at = None
                if now >= claim_deadline:
                    return "unclaimed"
            else:
                if claim_seen_at is None:
                    claim_seen_at = now
                age = self._queue.heartbeat_age_ms(job.db_name)
                if age is None:
                    # claimed but no heartbeat node ever landed — count
                    # staleness from when we first saw the claim, else a
                    # worker killed pre-first-heartbeat never gets reaped
                    age = (now - claim_seen_at) * 1000
                if age > self.policy.heartbeat_timeout_s * 1000:
                    # worker died mid-job: evict the claim; the job node
                    # stays published = republished for the next worker
                    log.warning("%s: reaping dead worker %s (hb %dms)",
                                self.db_name, holder, age)
                    self._queue.reap_claim(job.db_name)
                    self.republished += 1
                    self._queue.bump_summary("republished")
                    claim_deadline = now + self.policy.claim_wait_s
            time.sleep(self.policy.poll_interval_s)

    def _install(self, plan: dict, job: CompactionJob, result,
                 consumed: dict) -> str:
        # fencing FIRST: a deposed leader must not even download, let
        # alone install — and must not run the local fallback either
        if not _epoch_is_current(job.epoch, int(self._epoch())):
            raise FencedInstallError(
                f"job epoch {job.epoch} stale "
                f"(current {int(self._epoch())}) — result discarded")
        local_names: List[str] = []
        try:
            for out in result.outputs:
                name, path = self._db.allocate_sst()
                # track before verifying so a mismatching download is
                # itself swept by the except below
                local_names.append(name)
                self._store.get_object(out["key"], path)
                got = file_checksum(path)
                if got != out["checksum"]:
                    raise IOError(
                        f"{out['name']}: downloaded {got[:12]} != "
                        f"result manifest {out['checksum'][:12]}")
            # the last handoff: everything verified, generation swaps in
            fp.hit("compact.remote.install")
        except Exception:
            # outputs never joined the manifest — sweep them and let the
            # caller fall back locally (no mutex held yet)
            self._db._discard_outputs(local_names)
            raise
        # verified generation on disk: only NOW win the compaction
        # mutex, revalidating the snapshot's inputs are still live —
        # the whole remote round trip above ran mutex-free
        if not self._db.begin_full_install(plan):
            log.info("%s: snapshot went stale during remote merge "
                     "(local compaction won); discarding job %s",
                     self.db_name, job.job_id)
            self._db._discard_outputs(local_names)
            Stats.get().incr(
                tagged("compaction.remote.stale", db=self.db_name))
            return "stale"
        consumed["plan"] = True
        self._db.install_full_compaction(
            plan, files=local_names, remote=True)
        self.installed += 1
        self._queue.bump_summary("installed")
        Stats.get().incr(
            tagged("compaction.remote.installed", db=self.db_name))
        self._sweep_job(job.job_id)
        return "installed"

    # -- hygiene -------------------------------------------------------

    def _note_failover(self) -> None:
        self.failed_over += 1
        self._queue.bump_summary("failed_over")
        Stats.get().incr(
            tagged("compaction.remote.failed_over", db=self.db_name))

    def _sweep_job(self, job_id: str) -> None:
        """Retire the ledger entry and every transfer object for this
        job. Idempotent; safe on partially-published jobs."""
        for attempt in (0, 1):
            try:
                self._queue.remove(self.db_name)
                break
            except Exception:
                # a worker racing us can create a claim/result child
                # between the delete's enumerate and apply — one retry
                # wins because the parent job node is already doomed
                log.debug("ledger sweep attempt %d failed", attempt,
                          exc_info=True)
                time.sleep(0.05)
        try:
            prefix = f"compactions/{self.db_name}/{job_id}/"
            for key in self._store.list_objects(prefix):
                self._store.delete_object(key)
        except Exception:
            log.debug("object sweep failed", exc_info=True)

    def recover(self) -> None:
        """Leader (re)start: sweep any in-flight job this db published
        before a crash. No plan survives a process death (the compaction
        mutex is process-local), so the entry can never install — it
        only blocks the next publish. Reopen state is exactly
        pre-compaction; the next pick re-plans from scratch."""
        job = self._queue.get_job(self.db_name)
        if job is not None:
            log.info("%s: sweeping orphaned compaction job %s",
                     self.db_name, job.job_id)
            self._sweep_job(job.job_id)
            self._queue.bump_summary("recovered")

    # -- observability -------------------------------------------------

    def counters(self) -> dict:
        return {
            "installed": self.installed,
            "failed_over": self.failed_over,
            "fenced": self.fenced,
            "republished": self.republished,
        }
