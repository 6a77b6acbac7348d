"""The port's example applications: the counter service and the queue
consumer (``examples/counter_service`` and ``examples/kafka_consumer_app``
in the JAX package's repository)."""
