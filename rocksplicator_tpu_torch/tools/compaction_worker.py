#!/usr/bin/env python
"""Stateless compaction worker CLI — the serve-forever shell around
rocksplicator_tpu_torch.compaction_remote.worker.CompactionWorker, the
port's counterpart of ``tools/compaction_worker.py``.

    python -m rocksplicator_tpu_torch.tools.compaction_worker \
        --coord host:port [--workdir DIR] [--worker-id ID] \
        [--backend gpu|cpu] [--once] [--poll-interval S]

The worker owns no shard state: point any number of these at the
cluster coordinator and they drain the compaction job ledger. Kill one
mid-job and the leader reaps its claim on heartbeat expiry — the job
republishes or falls back to the leader's local merge. Environment:
RSTPU_COMPACT_COORD supplies --coord, RSTPU_COMPACT_WORKER_BACKEND
supplies --backend (default gpu: the card, which the worker needs;
cpu: the host's native merge), RSTPU_COMPACT_MEM_BUDGET bounds the
streaming merge exactly as it does in-engine.
"""

import argparse
import logging
import signal
import sys
import tempfile
import threading


def main(argv=None) -> int:
    from rocksplicator_tpu_torch.cluster.coordinator import CoordinatorClient
    from rocksplicator_tpu_torch.compaction_remote.dispatch import \
        coord_endpoint_from_env
    from rocksplicator_tpu_torch.compaction_remote.worker import (
        CompactionWorker, _build_backend)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coord", default=None,
                    help="coordinator endpoint host:port "
                         "(default: $RSTPU_COMPACT_COORD)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir for fetched inputs / merged outputs")
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--backend", default=None, choices=["gpu", "cpu"],
                    help="merge backend (default: "
                         "$RSTPU_COMPACT_WORKER_BACKEND or gpu)")
    ap.add_argument("--once", action="store_true",
                    help="process at most one job, then exit")
    ap.add_argument("--poll-interval", type=float, default=0.5)
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    if args.coord:
        host, _, port_s = args.coord.rpartition(":")
        endpoint = (host, int(port_s))
    else:
        endpoint = coord_endpoint_from_env()
    if endpoint is None:
        ap.error("--coord host:port (or RSTPU_COMPACT_COORD) required")

    workdir = args.workdir or tempfile.mkdtemp(prefix="rstpu-compact-")
    # built before the worker serves, so a card that is missing stops
    # the CLI instead of failing every job it claims
    backend = _build_backend(args.backend)
    coord = CoordinatorClient(endpoint[0], endpoint[1])
    worker = CompactionWorker(
        coord, workdir, worker_id=args.worker_id, backend=backend,
        poll_interval=args.poll_interval)
    logging.info("compaction worker %s serving (coord %s:%d, workdir %s)",
                 worker.worker_id, endpoint[0], endpoint[1], workdir)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        if args.once:
            worker.run_once()
        else:
            worker.serve_forever(stop)
    finally:
        coord.close()
        logging.info("worker %s done: %d jobs, %d failed",
                     worker.worker_id, worker.jobs_done, worker.jobs_failed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
