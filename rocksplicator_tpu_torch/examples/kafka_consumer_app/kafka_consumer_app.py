"""Example queue-consumer binary.
(The port's copy of ``examples/kafka_consumer_app/kafka_consumer_app.py``.)

Reference: examples/kafka_consumer_app/kafka_consumer_app.cpp (177 LoC) —
a standalone KafkaWatcher consumer printing messages from a topic.
"""

from __future__ import annotations

import argparse
import sys
import time

from rocksplicator_tpu_torch.kafka.broker import MockConsumer, get_cluster
from rocksplicator_tpu_torch.kafka.watcher import KafkaWatcher


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cluster", default="default",
                   help="embedded cluster name (ignored with --broker)")
    p.add_argument("--broker", default=None,
                   help="host:port of a networked BrokerServer "
                        "(kafka/network.py) — tails across processes")
    p.add_argument("--topic", required=True)
    p.add_argument("--partitions", default="0",
                   help="comma-separated partition ids")
    p.add_argument("--replay_timestamp_ms", type=int, default=0)
    p.add_argument("--max_messages", type=int, default=0,
                   help="exit after N messages (0 = run forever)")
    args = p.parse_args(argv)

    partitions = [int(x) for x in args.partitions.split(",")]
    count = [0]

    def on_message(msg, is_replay):
        phase = "replay" if is_replay else "live"
        print(f"[{phase}] {msg.topic}/{msg.partition}@{msg.offset} "
              f"ts={msg.timestamp_ms} key={msg.key!r} value={msg.value!r}",
              flush=True)
        count[0] += 1

    if args.broker:
        from rocksplicator_tpu_torch.kafka.network import NetworkConsumer

        host, _, port = args.broker.rpartition(":")
        if not host or not port.isdigit():
            p.error(f"--broker must be host:port, got {args.broker!r}")
        consumer = NetworkConsumer(host, int(port), "consumer-app")
    else:
        consumer = MockConsumer(get_cluster(args.cluster), "consumer-app")
    watcher = KafkaWatcher(
        "consumer-app", consumer,
        args.topic, partitions, args.replay_timestamp_ms,
        on_message=on_message,
    ).start()
    try:
        while args.max_messages == 0 or count[0] < args.max_messages:
            time.sleep(0.1)
    except KeyboardInterrupt:
        pass
    finally:
        watcher.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
