"""The stateless compaction worker — the port's copy of
``rocksplicator_tpu/compaction_remote/worker.py``.

A worker owns no shard state: it scans the job ledger, claims one job,
downloads the immutable input SSTs from the object store (verifying
each sha256 against the job manifest), runs the same merge pipeline the
engine would have run locally — the backend's ``merge_runs_to_files``,
which routes large inputs through the bounded-memory streaming merge
under ``RSTPU_COMPACT_MEM_BUDGET`` and small ones through the in-RAM
path — uploads the outputs with fresh checksums, and posts a result
manifest. Byte-identical to the local path by construction: both sides
call the identical merge code with the identical parameters from the
job record.

Liveness is a heartbeat node the worker re-stamps while merging; the
publishing leader reaps the claim when the heartbeat goes stale, which
republishes the job for the next worker (or times out into local
fallback). A worker crash therefore leaks nothing but garbage objects,
which the leader's cleanup sweeps by job-id prefix.

The merge backend defaults to the card: ``GpuCompactionBackend`` runs
K2 (or K1, under the ``bitonic`` sort backend) and, on the in-RAM route,
K3 for every output file's bloom — one accelerator worker host serves
many shards' compactions while the serving hosts stay on their CPUs.
``RSTPU_COMPACT_WORKER_BACKEND=cpu`` (or ``--backend cpu``) selects the
host's ``NativeCompactionBackend``. Where the reference's worker
degrades to the CPU merge when its accelerator backend does not build,
takes the CPU for any unknown backend name, and retries a failed direct
sink on the host's tuple path, the port's raises: the default backend
needs CUDA, an unknown name is a ``ValueError``, and a direct-sink
failure on a CUDA backend fails the job (posted ``failed``; the leader
then compacts locally), so a failed kernel is never hidden.

``rocksplicator_tpu_torch/tools/compaction_worker.py`` is the CLI shell
around this module.
"""

from __future__ import annotations

import logging
import os
import shutil
import socket
import threading
import time
import uuid
from typing import List, Optional, Tuple

from ..storage.engine import _on_card
from ..storage.merge import MERGE_OPERATORS
from ..storage.sst import SSTReader, SSTWriter
from ..testing import failpoints as fp
from ..utils.objectstore import build_object_store
from ..utils.stats import Stats, tagged
from .jobs import CompactionJob, JobResult, file_checksum
from .queue import CompactionJobQueue

log = logging.getLogger(__name__)


class ChecksumMismatch(Exception):
    pass


def _build_backend(name: Optional[str]):
    """Resolve the merge backend: ``name``, else
    ``RSTPU_COMPACT_WORKER_BACKEND``, else "gpu". "gpu" is the card's
    ``GpuCompactionBackend`` (cuda; raises without CUDA), "cpu" the
    host's ``NativeCompactionBackend``; any other name raises."""
    name = (name or os.environ.get("RSTPU_COMPACT_WORKER_BACKEND")
            or "gpu").lower()
    if name == "gpu":
        from ..gpu.backend import GpuCompactionBackend

        return GpuCompactionBackend()
    if name == "cpu":
        from ..storage.native_compaction import NativeCompactionBackend

        return NativeCompactionBackend()
    raise ValueError(f"unknown compaction worker backend {name!r}: "
                     "use 'gpu' or 'cpu'")


def merge_job_to_files(job: CompactionJob, input_paths: List[str],
                       out_dir: str, backend=None
                       ) -> List[Tuple[str, str]]:
    """Run the job's merge over already-fetched local input SSTs.
    Returns [(local_path, sha256)] in output order. Engine-free twin of
    ``DB._write_merged``: same direct pipeline, same tuple-path
    fallback (on a host backend only, as the port's engine), parameters
    from the job record instead of DBOptions."""
    backend = backend if backend is not None else _build_backend(None)
    merge_op = None
    if job.merge_operator:
        op_cls = MERGE_OPERATORS.get(job.merge_operator)
        if op_cls is None:
            raise ValueError(f"unknown merge operator {job.merge_operator}")
        merge_op = op_cls()
    readers = [SSTReader(p) for p in input_paths]
    allocated: List[str] = []

    def path_factory() -> str:
        path = os.path.join(out_dir,
                            f"{job.job_id}-{len(allocated):06d}.sst")
        allocated.append(path)
        return path

    outputs = None
    direct = getattr(backend, "merge_runs_to_files", None)
    if direct is not None:
        kwargs = {}
        if getattr(backend, "supports_subcompactions", False):
            kwargs["max_subcompactions"] = 1
            kwargs["io_budget"] = None
        if getattr(backend, "supports_memory_budget", False):
            kwargs["memory_budget_bytes"] = job.memory_budget_bytes
        try:
            outputs = direct(
                readers, merge_op, job.drop_tombstones, path_factory,
                job.block_bytes, job.compression, job.bits_per_key,
                job.target_file_bytes, **kwargs)
        except Exception:
            if _on_card(backend):
                # the tuple path would build blooms on the host and
                # hide a failed kernel: a card's failure is the job's
                raise
            log.exception("worker direct merge failed; using tuple path")
            outputs = None
    if outputs is None:
        stream = backend.merge_runs(
            [r.iterate() for r in readers], merge_op, job.drop_tombstones)
        paths: List[str] = []
        writer: Optional[SSTWriter] = None
        written = 0
        for key, seq, vtype, value in stream:
            if writer is None:
                path = path_factory()
                paths.append(path)
                writer = SSTWriter(path, job.block_bytes, job.compression,
                                   job.bits_per_key)
                written = 0
            writer.add(key, seq, vtype, value)
            written += len(key) + len(value)
            if written >= job.target_file_bytes:
                writer.finish()
                writer = None
        if writer is not None:
            writer.finish()
        outputs = [(p, {}) for p in paths]
    return [(path, file_checksum(path)) for path, _props in outputs]


class CompactionWorker:
    """Claim → fetch → merge → upload → result, one job at a time."""

    def __init__(self, coord, workdir: str, worker_id: Optional[str] = None,
                 backend=None, poll_interval: float = 0.2,
                 heartbeat_interval: float = 1.0):
        self._coord = coord
        self._queue = CompactionJobQueue(coord)
        self._workdir = workdir
        self.worker_id = worker_id or \
            f"{socket.gethostname()}-{uuid.uuid4().hex[:8]}"
        self._backend = backend
        self._poll_interval = poll_interval
        self._heartbeat_interval = heartbeat_interval
        self.jobs_done = 0
        self.jobs_failed = 0
        # the last job's host-clock stage seconds (claim_after_publish,
        # fetch, merge, upload), the bytes it moved and the backend's
        # own stage seconds of its merge
        self.last_job: dict = {}

    # -- loop ----------------------------------------------------------

    def run_once(self) -> bool:
        """Claim and process at most one job; True when one was taken."""
        for db in self._queue.list_open_jobs():
            try:
                job = self._queue.claim(db, self.worker_id)
            except Exception:
                log.exception("claim failed for %s", db)
                continue
            if job is None:
                continue  # duplicate claim loses; scan on
            self._process(job)
            return True
        return False

    def serve_forever(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                if not self.run_once():
                    stop.wait(self._poll_interval)
            except Exception:
                log.exception("worker loop error")
                stop.wait(self._poll_interval)

    # -- one job -------------------------------------------------------

    def _process(self, job: CompactionJob) -> None:
        db = job.db_name
        stop_hb = threading.Event()
        hb = threading.Thread(
            target=self._heartbeat_loop, args=(db, stop_hb),
            name=f"compact-hb-{db}", daemon=True)
        hb.start()
        job_dir = os.path.join(self._workdir, job.job_id)
        t0 = time.time()
        timing = self.last_job = {
            "job_id": job.job_id,
            "claim_after_publish": t0 - job.published_ms / 1000.0,
            "bytes_fetched": 0, "bytes_uploaded": 0}
        try:
            os.makedirs(job_dir, exist_ok=True)
            store = build_object_store(job.store_uri)
            input_paths = []
            for inp in job.inputs:
                # data plane: bytes enter the worker. A checksum
                # mismatch here means the store lied — fail the job,
                # the leader falls back to the local merge.
                fp.hit("compact.remote.fetch")
                local = os.path.join(job_dir, inp["name"])
                store.get_object(inp["key"], local)
                got = file_checksum(local)
                if got != inp["checksum"]:
                    raise ChecksumMismatch(
                        f"{inp['name']}: fetched {got[:12]} != "
                        f"manifest {inp['checksum'][:12]}")
                input_paths.append(local)
                timing["bytes_fetched"] += os.path.getsize(local)
            t1 = time.time()
            timing["fetch"] = t1 - t0
            out_dir = os.path.join(job_dir, "out")
            os.makedirs(out_dir, exist_ok=True)
            merged = merge_job_to_files(
                job, input_paths, out_dir, backend=self._backend)
            t2 = time.time()
            timing["merge"] = t2 - t1
            timing["backend_stages"] = dict(getattr(
                self._backend, "last_stage_seconds", None) or {})
            outputs = []
            for path, checksum in merged:
                # data plane: bytes leave the worker whole-file; the
                # leader re-verifies this sha256 before install
                fp.hit("compact.remote.upload")
                name = os.path.basename(path)
                key = f"compactions/{db}/{job.job_id}/out/{name}"
                store.put_object(path, key)
                outputs.append({
                    "name": name, "key": key, "checksum": checksum,
                    "bytes": os.path.getsize(path),
                })
                timing["bytes_uploaded"] += os.path.getsize(path)
            timing["upload"] = time.time() - t2
            self._queue.post_result(JobResult(
                job_id=job.job_id, db_name=db, epoch=job.epoch,
                worker_id=self.worker_id, status="done", outputs=outputs,
                finished_ms=int(time.time() * 1000)))
            self.jobs_done += 1
            Stats.get().incr(tagged("compaction.remote.worker_done",
                                    worker=self.worker_id))
        except Exception as e:
            self.jobs_failed += 1
            log.exception("job %s failed on %s", job.job_id, self.worker_id)
            try:
                self._queue.post_result(JobResult(
                    job_id=job.job_id, db_name=db, epoch=job.epoch,
                    worker_id=self.worker_id, status="failed",
                    error=f"{type(e).__name__}: {e}",
                    finished_ms=int(time.time() * 1000)))
            except Exception:
                # can't even post: the heartbeat stops below, so the
                # leader reaps on expiry — same terminal state as a kill
                log.debug("failed-result post failed", exc_info=True)
        finally:
            stop_hb.set()
            hb.join(timeout=5.0)
            shutil.rmtree(job_dir, ignore_errors=True)

    def _heartbeat_loop(self, db: str, stop: threading.Event) -> None:
        while not stop.wait(self._heartbeat_interval):
            try:
                self._queue.heartbeat(db)
            except Exception:
                # a wedged coordinator just makes us look dead; the
                # leader reaps and republishes — safe, merely wasteful
                log.debug("heartbeat failed for %s", db, exc_info=True)
