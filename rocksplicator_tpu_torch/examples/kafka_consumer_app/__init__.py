"""The queue-consumer example: ``python -m
rocksplicator_tpu_torch.examples.kafka_consumer_app.kafka_consumer_app``."""
