"""The port's example applications: the counter service
(``examples/counter_service`` in the JAX package's repository)."""
