"""Load generator for counter_service.
(The port's copy of ``examples/counter_service/stress_test.py``.)

Reference: examples/counter_service/stress_test.cpp — N client threads
bumping/reading counters against a running service; reports achieved QPS.
"""

from __future__ import annotations

import argparse
import random
import sys
import threading
import time

from rocksplicator_tpu_torch.rpc import IoLoop, RpcClientPool


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9090)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--requests", type=int, default=5000)
    p.add_argument("--counters", type=int, default=100)
    p.add_argument("--read_ratio", type=float, default=0.5)
    args = p.parse_args(argv)

    ioloop = IoLoop.default()
    pool = RpcClientPool()
    errors = [0]
    done = [0]
    lock = threading.Lock()

    def worker(tid: int) -> None:
        rng = random.Random(tid)
        for i in range(args.requests):
            name = f"counter-{rng.randrange(args.counters)}"
            try:
                if rng.random() < args.read_ratio:
                    fut = pool.call(args.host, args.port, "get_counter",
                                    {"counter_name": name, "need_routing": True})
                else:
                    fut = pool.call(args.host, args.port, "bump_counter",
                                    {"counter_name": name, "delta": 1,
                                     "need_routing": True})
                ioloop.run_coro(fut).result(30)
            except Exception:
                with lock:
                    errors[0] += 1
            with lock:
                done[0] += 1

    start = time.monotonic()
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(args.threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - start
    total = args.threads * args.requests
    print(
        f"stress: {total} requests in {elapsed:.2f}s = {total / elapsed:.0f} qps, "
        f"errors={errors[0]}"
    )
    ioloop.run_sync(pool.close())
    return 1 if errors[0] else 0


if __name__ == "__main__":
    sys.exit(main())
